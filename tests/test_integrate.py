"""Motion/rotation integration tests (UpdateMotion/UpdateRotation parity)."""

import jax.numpy as jnp
import numpy as np

from sphsim.core import quat
from sphsim.core.types import SimParams, SimState
from sphsim.physics.integrate import update_motion, update_rotation


def one_particle(params, **kw):
    st = SimState.zeros(4, params)
    st = st.replace_fields(active_count=jnp.int32(1))
    for k, v in kw.items():
        arr = getattr(st, k)
        st = st.replace_fields(**{k: arr.at[0].set(jnp.asarray(v, arr.dtype))})
    return st


def test_exponential_damping_and_integration():
    params = SimParams(dt=0.1, global_drag_multiplier=10.0, torque_damping=0.5)
    st = one_particle(params, vel=(1.0, 0.0, 0.0), ang_vel=(0.0, 2.0, 0.0),
                      drag=0.7)
    st2 = update_motion(st, params)
    lin = np.exp(-0.7 * 10.0 * 0.1)
    ang = np.exp(-0.5 * 0.1)
    np.testing.assert_allclose(st2.vel[0], [lin, 0, 0], rtol=1e-6)
    np.testing.assert_allclose(st2.ang_vel[0], [0, 2 * ang, 0], rtol=1e-6)
    np.testing.assert_allclose(st2.pos[0], [lin * 0.1, 0, 0], rtol=1e-6)


def test_boundary_projection_and_reflection():
    params = SimParams(dt=0.0, spawn_radius=15.0, global_drag_multiplier=0.0,
                       torque_damping=0.0, boundary_friction=0.0)
    st = one_particle(params, pos=(16.0, 0.0, 0.0), vel=(1.0, 0.0, 0.0))
    st2 = update_motion(st, params)
    np.testing.assert_allclose(st2.pos[0], [15.0, 0, 0], rtol=1e-6)
    # reflect((1,0,0), x̂) = (−1,0,0)
    np.testing.assert_allclose(st2.vel[0], [-1.0, 0, 0], rtol=1e-6)


def test_boundary_invariant_many_steps():
    params = SimParams(dt=0.05, spawn_radius=15.0)
    st = one_particle(params, pos=(14.0, 0.0, 0.0), vel=(30.0, 11.0, -7.0))
    for _ in range(50):
        st = update_motion(st, params)
    assert float(jnp.linalg.norm(st.pos[0])) <= 15.0 + 1e-4


def test_boundary_friction_torque():
    # Tangential velocity +y at the +x pole: torque = cross(n·r, f̂·m).
    params = SimParams(dt=0.1, spawn_radius=15.0, global_drag_multiplier=0.0,
                       torque_damping=0.0, boundary_friction=0.8,
                       rolling_contact_radius_multiplier=5.0)
    # Start at y=−0.2 so the position integrates to exactly (15.5, 0, 0)
    # before the boundary test ⇒ the outward normal is exactly x̂.
    st = one_particle(params, pos=(15.5, -0.2, 0.0), vel=(0.0, 2.0, 0.0),
                      radius=2.0, inertia=1.0)
    st2 = update_motion(st, params)
    # After damping(=1) & reflect (v·n=0 ⇒ unchanged): tangential = (0,2,0),
    # mag = 2·0.8 = 1.6, r_eff = 2·5 = 10, τ = (10,0,0)×(0,1.6,0) = (0,0,16).
    # atol covers the reference's +1e-6 friction-dir bias (compute:348).
    np.testing.assert_allclose(st2.ang_vel[0], [0, 0, 16 * 0.1], atol=1e-5)


def test_update_rotation_drains_accumulator():
    params = SimParams(dt=0.1, torque_damping=0.0)
    st = one_particle(params, torque_accum=(0.0, 0.0, 0.5), inertia=2.0)
    st2 = update_rotation(st, params)
    # ω += accum/I (dt already applied at accumulation, compute:385-389).
    np.testing.assert_allclose(st2.ang_vel[0], [0, 0, 0.25], rtol=1e-6)
    np.testing.assert_allclose(st2.torque_accum, 0.0)
    # Quaternion advanced by axis-angle ω·dt.
    expected = quat.from_axis_angle(jnp.array([0.0, 0.0, 1.0]), 0.25 * 0.1)
    np.testing.assert_allclose(st2.rot[0], expected, atol=1e-6)


def test_update_rotation_double_damping_semantics():
    # ω is damped in BOTH UpdateMotion and UpdateRotation (compute:333, :392).
    params = SimParams(dt=0.1, torque_damping=0.5, global_drag_multiplier=0.0)
    st = one_particle(params, ang_vel=(1.0, 0.0, 0.0))
    st = update_motion(st, params)
    st = update_rotation(st, params)
    np.testing.assert_allclose(
        st.ang_vel[0], [np.exp(-0.05) ** 2, 0, 0], rtol=1e-5
    )


def test_dead_slots_untouched():
    params = SimParams(dt=0.1)
    st = one_particle(params, vel=(1.0, 0.0, 0.0))
    st = st.replace_fields(
        pos=st.pos.at[2].set(jnp.array([99.0, 0, 0])),
        vel=st.vel.at[2].set(jnp.array([5.0, 0, 0])),
    )
    st2 = update_motion(st, params)
    np.testing.assert_array_equal(st2.pos[2], st.pos[2])
    np.testing.assert_array_equal(st2.vel[2], st.vel[2])
