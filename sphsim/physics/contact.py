"""Soft-sphere contact forces + rolling-friction torque.

Deterministic gather re-specification of the reference's ApplySPHForces kernel
(SimulateParticles.compute:211-309) — see DESIGN.md §2. All pair math reads the
pre-pass snapshot; the partner-torque atomic scatter is replaced by the
algebraically-identical self-torque sum, accumulated into `torque_accum`
(drained by the rotation pass, compute:385-389).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from sphsim.core.types import SimParams, SimState


def pair_contact(
    pos_i, vel_i, omega_i, r_i,
    pos_j, vel_j, omega_j, r_j,
    valid, params: SimParams,
):
    """Per-pair repulsion force and rolling torque on particle i.

    Broadcasts over any leading shape; `valid` masks self-pairs / dead slots.
    Returns (force_i, torque_i), zero where invalid or not in contact.
    """
    eff_i = r_i * 0.5  # contact radius is half the visual radius (compute:225)
    eff_j = r_j * 0.5
    delta = pos_i - pos_j
    dist = jnp.linalg.norm(delta, axis=-1)
    safe_dist = jnp.maximum(dist, 1e-12)
    overlap = (eff_i + eff_j) - dist
    in_contact = valid & (overlap > params.contact_epsilon)  # compute:253

    dirv = delta / safe_dist[..., None]
    # overlap/(ri+rj) and 1-dist/(ri+rj) are the same quantity (compute:258-259).
    sum_r = eff_i + eff_j
    overlap_falloff = jnp.clip(overlap / sum_r, 0.0, 1.0)
    falloff = jnp.clip(1.0 - dist / sum_r, 0.0, 1.0)
    repulsion = dirv * (
        falloff * params.repulsion_strength * overlap_falloff
    )[..., None]

    # Rolling contact friction (compute:263-289).
    contact_arm_i = -dirv * eff_i[..., None]
    contact_arm_j = dirv * eff_j[..., None]
    surf_vel_i = vel_i + jnp.cross(omega_i, contact_arm_i)
    surf_vel_j = vel_j + jnp.cross(omega_j, contact_arm_j)
    rel_surf = surf_vel_i - surf_vel_j
    tangent = rel_surf - dirv * jnp.sum(rel_surf * dirv, axis=-1, keepdims=True)
    slip = jnp.linalg.norm(tangent, axis=-1)
    slipping = in_contact & (slip > params.slip_epsilon)
    friction_dir = tangent / jnp.maximum(slip, 1e-20)[..., None]

    torque_input = jnp.abs(slip * params.torque_factor)
    # x^1.25 as x·sqrt(sqrt(x)) — matches contact_dense.contact_pair_terms
    # exactly in form (lax.pow's exp/log lowering costs 2 transcendentals
    # per lane; the sqrt chain agrees to ≤2 ulp and is exact at 0).
    friction_mag = jnp.minimum(
        torque_input * jnp.sqrt(jnp.sqrt(torque_input)), 10.0
    )

    torque_r_scale = overlap_falloff ** 2
    eff_torque_i = (
        torque_r_scale * eff_i * params.rolling_contact_radius_multiplier
    )
    # cross(-dir·r, -f̂·m) == cross(dir·r, f̂·m) (compute:286).
    torque_i = jnp.cross(
        dirv * eff_torque_i[..., None], friction_dir * friction_mag[..., None]
    )

    force = jnp.where(in_contact[..., None], repulsion, 0.0)
    torque = jnp.where(slipping[..., None], torque_i, 0.0)
    return force, torque


def contact_forces_bruteforce(
    state: SimState, params: SimParams, row_block: int = 512
):
    """O(N²) all-pairs contact sums, tiled over row blocks to bound memory.

    This is the executable-spec path (BASELINE config[0]); the grid path in
    sphsim.ops.grid must match it exactly on identical inputs.
    """
    N = state.capacity
    alive = jnp.arange(N) < state.active_count
    nb = max(1, -(-N // row_block))

    def block(b):
        i0 = b * row_block
        idx_i = i0 + jnp.arange(row_block)
        idx_i = jnp.minimum(idx_i, N - 1)
        pos_i = state.pos[idx_i][:, None, :]
        vel_i = state.vel[idx_i][:, None, :]
        om_i = state.ang_vel[idx_i][:, None, :]
        r_i = state.radius[idx_i][:, None]
        alive_i = alive[idx_i][:, None]
        valid = (
            alive_i
            & alive[None, :]
            & (idx_i[:, None] != jnp.arange(N)[None, :])
        )
        f, t = pair_contact(
            pos_i, vel_i, om_i, r_i,
            state.pos[None, :, :], state.vel[None, :, :],
            state.ang_vel[None, :, :], state.radius[None, :],
            valid, params,
        )
        return f.sum(axis=1), t.sum(axis=1)

    if nb == 1:
        force, torque = block(jnp.int32(0))
        force, torque = force[:N], torque[:N]
    else:
        force_b, torque_b = jax.lax.map(block, jnp.arange(nb, dtype=jnp.int32))
        force = force_b.reshape(-1, 3)[:N]
        torque = torque_b.reshape(-1, 3)[:N]
    return force, torque


def apply_contact(state: SimState, params: SimParams, force, torque,
                  dt=None) -> SimState:
    """Integrate contact results (compute:302-306) and fill the torque
    accumulator with the partner-scatter-equivalent T·dt (DESIGN.md §2)."""
    alive = (jnp.arange(state.capacity) < state.active_count)[:, None]
    dt = params.dt if dt is None else dt
    vel = state.vel + jnp.where(alive, force / state.mass[:, None] * dt, 0.0)
    ang = state.ang_vel + jnp.where(
        alive, torque / state.inertia[:, None] * dt, 0.0
    )
    accum = jnp.where(alive, torque * dt, 0.0)
    return state.replace_fields(vel=vel, ang_vel=ang, torque_accum=accum)
