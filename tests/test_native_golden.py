"""JAX engine vs the native C++ golden core: three independent
implementations of the executable spec must agree (SURVEY §4 item 1)."""

import jax
import jax.numpy as jnp
import numpy as np

from sphsim.core.types import Genome, GenomeMode, SimParams, SimState
from sphsim.native import (
    adhesion_deltas_native,
    contact_forces_native,
    ensure_built,
    sph_density_accel_native,
    update_motion_native,
    update_rotation_native,
)
from sphsim.physics.adhesion import bond_deltas
from sphsim.physics.contact import contact_forces_bruteforce
from sphsim.physics.integrate import update_motion, update_rotation


def test_builds():
    assert ensure_built().endswith(".so")


def random_state(n=48, seed=0, spread=6.0):
    k = jax.random.split(jax.random.PRNGKey(seed), 6)
    st = SimState.zeros(n, SimParams())
    from sphsim.core import quat

    q = jax.random.normal(k[4], (n, 4))
    return st.replace_fields(
        pos=jax.random.uniform(k[0], (n, 3), minval=-spread, maxval=spread),
        vel=jax.random.normal(k[1], (n, 3)),
        ang_vel=jax.random.normal(k[2], (n, 3)) * 0.5,
        radius=jax.random.uniform(k[3], (n,), minval=1.5, maxval=2.5),
        rot=quat.normalize(q),
        mass=jax.random.uniform(k[5], (n,), minval=0.5, maxval=2.0),
        inertia=jnp.full(n, 1.3),
        drag=jnp.full(n, 0.7),
        torque_accum=jax.random.normal(k[2], (n, 3)) * 0.1,
        active_count=jnp.int32(n - 4),
    )


PARAMS = SimParams(dt=0.02, repulsion_strength=200.0, torque_factor=1.3,
                   rolling_contact_radius_multiplier=5.0, spawn_radius=8.0,
                   boundary_friction=0.8, torque_damping=0.5,
                   global_drag_multiplier=3.0)


def test_contact_forces_match():
    st = random_state()
    f_j, t_j = contact_forces_bruteforce(st, PARAMS)
    f_c, t_c, accum_c = contact_forces_native(st, PARAMS)
    scale = max(np.abs(np.asarray(f_j)).max(), 1e-6)
    assert np.abs(np.asarray(f_j) - f_c).max() / scale < 2e-5
    t_scale = max(np.abs(np.asarray(t_j)).max(), 1e-6)
    assert np.abs(np.asarray(t_j) - t_c).max() / t_scale < 2e-5
    np.testing.assert_allclose(accum_c, np.asarray(t_j) * PARAMS.dt,
                               atol=t_scale * 2e-5)


def test_update_motion_matches():
    st = random_state(seed=3)
    out = update_motion(st, PARAMS)
    pos_c, vel_c, ang_c = update_motion_native(st, PARAMS)
    n = int(st.active_count)
    np.testing.assert_allclose(np.asarray(out.pos)[:n], pos_c[:n], atol=1e-4)
    np.testing.assert_allclose(np.asarray(out.vel)[:n], vel_c[:n], atol=1e-4)
    np.testing.assert_allclose(np.asarray(out.ang_vel)[:n], ang_c[:n],
                               atol=1e-3)


def test_update_rotation_matches():
    st = random_state(seed=4)
    out = update_rotation(st, PARAMS)
    ang_c, rot_c = update_rotation_native(st, PARAMS)
    n = int(st.active_count)
    np.testing.assert_allclose(np.asarray(out.ang_vel)[:n], ang_c[:n],
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(out.rot)[:n], rot_c[:n], atol=1e-5)


def test_adhesion_deltas_match():
    st = random_state(seed=5)
    genome = Genome((
        GenomeMode(is_initial=True, adhesion_rest_length=3.0,
                   adhesion_spring_stiffness=150.0, adhesion_spring_damping=4.0,
                   orientation_constraint_strength=0.6),
        GenomeMode(adhesion_rest_length=2.0, adhesion_spring_stiffness=50.0,
                   adhesion_spring_damping=1.0,
                   orientation_constraint_strength=0.2),
    )).validate_for_simulation()
    gd = genome.to_device()
    # Wire a handful of bonds with anchors + captured rel orientations.
    b = st.bonds
    rng = np.random.default_rng(0)
    for i, (a_, b_) in enumerate([(0, 1), (2, 3), (1, 4), (5, 9)]):
        from sphsim.core import quat

        rel = quat.mul(quat.conjugate(st.rot[a_]), st.rot[b_])
        b = b.replace_fields(
            active=b.active.at[i].set(True),
            uid_a=b.uid_a.at[i].set(a_ * 7 + 1),
            uid_b=b.uid_b.at[i].set(b_ * 7 + 2),
            slot_a=b.slot_a.at[i].set(a_),
            slot_b=b.slot_b.at[i].set(b_),
            rel_orientation=b.rel_orientation.at[i].set(rel),
            anchor_a=b.anchor_a.at[i].set(
                jnp.asarray(rng.normal(0, 0.5, 3), jnp.float32)),
            anchor_b=b.anchor_b.at[i].set(
                jnp.asarray(rng.normal(0, 0.5, 3), jnp.float32)),
            anchors_set=b.anchors_set.at[i].set(True),
        )
    st = st.replace_fields(bonds=b)
    dv_j, dq_j = bond_deltas(st, PARAMS, gd)
    dv_c, dq_c = adhesion_deltas_native(st, PARAMS, gd)
    np.testing.assert_allclose(np.asarray(dv_j), dv_c, atol=1e-4)
    np.testing.assert_allclose(np.asarray(dq_j), dq_c, atol=1e-5)


def test_sph_density_accel_match():
    from sphsim.sph.model import (
        SPHState,
        compute_accel_bruteforce,
        compute_density_bruteforce,
        eos_pressure,
    )
    from sphsim.sph.scenes import dam_break_2d

    state, params = dam_break_2d(n_target=200)
    state = state.replace_fields(vel=jnp.sin(state.pos * 4.0))
    rho_j = compute_density_bruteforce(state, params)
    st = state.replace_fields(density=rho_j,
                              pressure=eos_pressure(rho_j, params))
    a_j = np.asarray(compute_accel_bruteforce(st, params)).copy()
    a_j[:, 1] += params.gravity  # native oracle excludes gravity

    rho_c, a_c = sph_density_accel_native(
        np.asarray(state.pos), np.asarray(state.vel), params
    )
    np.testing.assert_allclose(np.asarray(rho_j), rho_c, rtol=1e-5)
    scale = max(np.abs(a_j).max(), 1e-6)
    assert np.abs(a_j - a_c).max() / scale < 1e-4
