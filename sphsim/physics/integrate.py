"""Motion + rotation integration passes (UpdateMotion / UpdateRotation,
SimulateParticles.compute:326-357, :379-408).

The math lives in mask-parameterized core functions (tracing inlines them,
so the split is bitwise-invisible).
"""

from __future__ import annotations

import jax.numpy as jnp

from sphsim.core import quat
from sphsim.core.types import SimParams, SimState


def motion_core(pos, vel, ang, radius, inertia, dragc, mask,
                params: SimParams, dt):
    """UpdateMotion on [..., 3] component arrays with an explicit update
    mask: exponential damping, position integration, spherical boundary
    with reflection + boundary-friction torque (compute:326-357). Rows with
    mask=False keep their inputs bit-for-bit. Returns (pos, vel, ang)."""
    m = mask[..., None]

    lin_damp = jnp.exp(-dragc * params.global_drag_multiplier * dt)
    ang_damp = jnp.exp(-params.torque_damping * dt)

    vel_n = vel * lin_damp[..., None]
    ang_n = ang * ang_damp
    pos_n = pos + vel_n * dt

    dist = jnp.linalg.norm(pos_n, axis=-1)
    outside = dist > params.spawn_radius
    norm = pos_n / jnp.maximum(dist, 1e-12)[..., None]

    pos_b = norm * params.spawn_radius
    # reflect(v, n) = v − 2(v·n)n (compute:345)
    v_dot_n = jnp.sum(vel_n * norm, axis=-1, keepdims=True)
    vel_b = vel_n - 2.0 * v_dot_n * norm

    tangential = vel_b - jnp.sum(vel_b * norm, axis=-1, keepdims=True) * norm
    # The reference adds the scalar 1e-6 to every component before
    # normalizing (compute:348).
    fr = tangential + 1e-6
    friction_dir = fr / jnp.maximum(
        jnp.linalg.norm(fr, axis=-1, keepdims=True), 1e-20
    )
    friction_mag = (
        jnp.linalg.norm(tangential, axis=-1) * params.boundary_friction
    )
    eff_r = radius * params.rolling_contact_radius_multiplier
    # cross(-n·r, -f̂·m) == cross(n·r, f̂·m) (compute:352)
    torque = jnp.cross(
        norm * eff_r[..., None], friction_dir * friction_mag[..., None]
    )
    ang_b = ang_n + torque / inertia[..., None] * dt

    out = outside[..., None]
    pos = jnp.where(m & out, pos_b, jnp.where(m, pos_n, pos))
    vel = jnp.where(m & out, vel_b, jnp.where(m, vel_n, vel))
    ang = jnp.where(m & out, ang_b, jnp.where(m, ang_n, ang))
    return pos, vel, ang


def rotation_core(rot, ang, torque_accum, inertia, mask,
                  params: SimParams, dt):
    """UpdateRotation core: drain the torque accumulator (already ×dt at
    accumulation time, compute:291), damp ω again, integrate the quaternion
    by axis-angle (compute:379-408). Masked rows keep their inputs.
    Returns (rot, ang)."""
    ang_n = ang + torque_accum / inertia[..., None]
    ang_n = ang_n * jnp.exp(-params.torque_damping * dt)
    rot_n = quat.integrate_angular(rot, ang_n, dt)

    m = mask[..., None]
    return jnp.where(m, rot_n, rot), jnp.where(m, ang_n, ang)


def update_motion(state: SimState, params: SimParams, dt=None) -> SimState:
    """Exponential damping, position integration, spherical boundary with
    reflection + boundary-friction torque (compute:326-357). `dt` may be a
    traced scalar (variable-dt compat, ParticleSystemController.cs:246)."""
    alive = jnp.arange(state.capacity) < state.active_count
    dt = params.dt if dt is None else dt
    pos, vel, ang = motion_core(
        state.pos, state.vel, state.ang_vel, state.radius, state.inertia,
        state.drag, alive, params, dt,
    )
    return state.replace_fields(pos=pos, vel=vel, ang_vel=ang)


def update_rotation(state: SimState, params: SimParams, dt=None) -> SimState:
    """Drain the torque accumulator (already ×dt at accumulation time,
    compute:291), damp ω again, integrate the quaternion by axis-angle, and
    zero the accumulator (compute:379-408)."""
    alive = jnp.arange(state.capacity) < state.active_count
    dt = params.dt if dt is None else dt
    rot, ang = rotation_core(
        state.rot, state.ang_vel, state.torque_accum, state.inertia,
        alive, params, dt,
    )
    return state.replace_fields(
        ang_vel=ang, rot=rot,
        torque_accum=jnp.zeros_like(state.torque_accum),
    )
