"""Interactive drag impulse on the selected particle (ApplyDragForce,
SimulateParticles.compute:311-324)."""

from __future__ import annotations

import jax.numpy as jnp

from sphsim.core.types import SimParams, SimState


def apply_drag_force(state: SimState, params: SimParams, dt=None) -> SimState:
    d = state.drag_input
    dt = params.dt if dt is None else dt
    sel = d.selected_slot
    valid = (sel >= 0) & (sel < state.capacity)
    idx = jnp.clip(sel, 0, state.capacity - 1)
    to_target = d.target - state.pos[idx]
    impulse = to_target * d.strength * dt / state.mass[idx]
    vel = state.vel.at[idx].add(jnp.where(valid, impulse, 0.0))
    return state.replace_fields(vel=vel)
