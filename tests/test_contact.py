"""Golden-model unit tests for the contact pass (DESIGN.md §2 vs hand-derived
values from SimulateParticles.compute:211-309)."""

import jax.numpy as jnp
import numpy as np
import pytest

from sphsim.core.types import SimParams, SimState
from sphsim.physics.contact import (
    apply_contact,
    contact_forces_bruteforce,
    pair_contact,
)


def two_particle_state(params, pos_b, vel_b=(0, 0, 0), omega_b=(0, 0, 0),
                       radius=2.0):
    st = SimState.zeros(4, params)
    st = st.replace_fields(
        pos=st.pos.at[1].set(jnp.asarray(pos_b, jnp.float32)),
        vel=st.vel.at[1].set(jnp.asarray(vel_b, jnp.float32)),
        ang_vel=st.ang_vel.at[1].set(jnp.asarray(omega_b, jnp.float32)),
        radius=jnp.full(4, radius, jnp.float32),
        mass=jnp.ones(4, jnp.float32),
        inertia=jnp.ones(4, jnp.float32),
        active_count=jnp.int32(2),
    )
    return st


def test_repulsion_hand_computed():
    # r=2 ⇒ eff=1 each, sum=2. dist=1.5 ⇒ overlap=0.5, falloff=0.25.
    # |F| = falloff · 200 · overlap_falloff = 0.25·200·0.25 = 12.5 away from B.
    params = SimParams(repulsion_strength=200.0)
    st = two_particle_state(params, (1.5, 0.0, 0.0))
    f, t = contact_forces_bruteforce(st, params)
    np.testing.assert_allclose(f[0], [-12.5, 0, 0], atol=1e-5)
    np.testing.assert_allclose(f[1], [12.5, 0, 0], atol=1e-5)
    np.testing.assert_allclose(t[:2], 0.0, atol=1e-7)  # no slip, no torque


def test_no_contact_beyond_effective_radius():
    # Visual radii overlap (dist 3 < 4) but effective radii (half) don't.
    params = SimParams()
    st = two_particle_state(params, (3.0, 0.0, 0.0))
    f, _ = contact_forces_bruteforce(st, params)
    np.testing.assert_allclose(f, 0.0, atol=1e-7)


def test_contact_epsilon_gate():
    # overlap = 0.0005 < 0.001 ⇒ no force (compute:253).
    params = SimParams()
    st = two_particle_state(params, (1.9995, 0.0, 0.0))
    f, _ = contact_forces_bruteforce(st, params)
    np.testing.assert_allclose(f, 0.0, atol=1e-7)


def test_rolling_torque_hand_computed():
    # B slides +y at speed 1: slip=1, mag=min(1^1.25,10)=1,
    # scale=overlap_falloff²=0.0625, rT_A=0.0625·1·5=0.3125,
    # τ_A = cross(dir·rT_A, f̂) with dir=(−1,0,0), f̂=(0,−1,0) ⇒ (0,0,0.3125).
    params = SimParams(torque_factor=1.0, rolling_contact_radius_multiplier=5.0)
    st = two_particle_state(params, (1.5, 0.0, 0.0), vel_b=(0.0, 1.0, 0.0))
    _, t = contact_forces_bruteforce(st, params)
    np.testing.assert_allclose(t[0], [0, 0, 0.3125], atol=1e-5)
    # Partner torque is parallel (same direction; DESIGN.md §2 symmetry).
    np.testing.assert_allclose(t[1], [0, 0, 0.3125], atol=1e-5)


def test_friction_mag_clamp():
    # Huge slip ⇒ friction magnitude clamps at 10 (compute:280).
    params = SimParams(torque_factor=100.0)
    st = two_particle_state(params, (1.5, 0.0, 0.0), vel_b=(0.0, 50.0, 0.0))
    _, t = contact_forces_bruteforce(st, params)
    expected = 0.0625 * 1.0 * 5.0 * 10.0
    np.testing.assert_allclose(t[0], [0, 0, expected], rtol=1e-5)


def test_apply_contact_integration_and_accumulator():
    params = SimParams(dt=0.01)
    st = two_particle_state(params, (1.5, 0.0, 0.0), vel_b=(0.0, 1.0, 0.0))
    f, t = contact_forces_bruteforce(st, params)
    st2 = apply_contact(st, params, f, t)
    np.testing.assert_allclose(st2.vel[0], st.vel[0] + f[0] * 0.01, atol=1e-6)
    np.testing.assert_allclose(st2.ang_vel[0], t[0] * 0.01, atol=1e-6)
    # Accumulator carries T·dt for the rotation pass (compute:291).
    np.testing.assert_allclose(st2.torque_accum[0], t[0] * 0.01, atol=1e-6)
    # Dead slots untouched.
    np.testing.assert_allclose(st2.torque_accum[2:], 0.0)


def test_momentum_conservation_bruteforce():
    # Pair forces are antisymmetric ⇒ contact conserves linear momentum.
    import jax

    params = SimParams(repulsion_strength=200.0)
    key = jax.random.PRNGKey(1)
    N = 32
    st = SimState.zeros(N, params)
    st = st.replace_fields(
        pos=jax.random.uniform(key, (N, 3), minval=-3, maxval=3),
        vel=jax.random.normal(jax.random.PRNGKey(2), (N, 3)),
        radius=jnp.full(N, 2.0),
        mass=jnp.ones(N),
        inertia=jnp.ones(N),
        active_count=jnp.int32(N),
    )
    f, _ = contact_forces_bruteforce(st, params)
    np.testing.assert_allclose(jnp.sum(f, axis=0), 0.0, atol=1e-3)


def test_pair_contact_matches_bruteforce_rowsum():
    import jax

    params = SimParams()
    N = 16
    st = SimState.zeros(N, params)
    st = st.replace_fields(
        pos=jax.random.uniform(jax.random.PRNGKey(3), (N, 3), minval=-2, maxval=2),
        radius=jnp.full(N, 2.0),
        active_count=jnp.int32(N),
    )
    f, t = contact_forces_bruteforce(st, params)
    # Manual reference with explicit [N,N] pair math.
    valid = ~jnp.eye(N, dtype=bool)
    fp, tp = pair_contact(
        st.pos[:, None], st.vel[:, None], st.ang_vel[:, None],
        st.radius[:, None],
        st.pos[None], st.vel[None], st.ang_vel[None], st.radius[None],
        valid, params,
    )
    np.testing.assert_allclose(f, fp.sum(1), atol=1e-4)
    np.testing.assert_allclose(t, tp.sum(1), atol=1e-4)


def _random_colony(n=400, seed=0, radius_spread=True):
    """Crowded ball with real contacts (dense_k=4: the sweep's variant
    count scales with K)."""
    import jax

    params = SimParams(
        capacity=n, spawn_radius=12.0, neighbor_mode="dense",
        dense_k=4, max_bonds=8, max_splits_per_step=4, use_pallas=False,
    )
    k1, k2, k3, k4 = jax.random.split(jax.random.PRNGKey(seed), 4)
    u = jax.random.normal(k1, (n, 3))
    u = u / jnp.linalg.norm(u, axis=-1, keepdims=True)
    r = 10.5 * jax.random.uniform(k2, (n, 1)) ** (1 / 3)
    st = SimState.zeros(n, params)
    st = st.replace_fields(
        pos=u * r,
        vel=jax.random.normal(k3, (n, 3)) * 0.5,
        ang_vel=jax.random.normal(k4, (n, 3)) * 0.5,
        radius=(
            jnp.linspace(1.5, 2.0, n) if radius_spread else jnp.full(n, 2.0)
        ),
        active_count=jnp.int32(n),
    )
    return st, params


def test_dense_contact_matches_bruteforce():
    """The dense fused-sweep contact path (physics/contact_dense.py) must
    reproduce the brute-force executable spec to float re-association
    tolerance — including the ASYMMETRIC partner torque (each side's own
    contact arm, compute:282-294), which exercises the full-stencil
    own-only sweep machinery."""
    import jax

    from sphsim.physics.contact_dense import contact_forces_dense

    st, params = _random_colony()
    fb, tb = contact_forces_bruteforce(st, params)
    fd, td, ovf = jax.jit(
        lambda s: contact_forces_dense(s, params)
    )(st)
    assert int(ovf) == 0
    f_scale = float(jnp.abs(fb).max())
    t_scale = float(jnp.abs(tb).max())
    assert f_scale > 0 and t_scale > 0  # the colony really interacts
    np.testing.assert_allclose(
        np.asarray(fd), np.asarray(fb), atol=2e-4 * f_scale, rtol=2e-4
    )
    np.testing.assert_allclose(
        np.asarray(td), np.asarray(tb), atol=2e-4 * t_scale, rtol=2e-4
    )


def test_dense_contact_pallas_matches_xla_twin():
    """Triton contact sweep (Pallas interpreter) == XLA twin: both walk
    contact_variants in the same order, so only FMA contraction may
    differ."""
    import jax

    from sphsim.physics.contact_dense import contact_forces_dense

    st, params = _random_colony(n=200, seed=1)
    fx, tx, ox = jax.jit(
        lambda s: contact_forces_dense(s, params.replace(use_pallas=False))
    )(st)
    fp, tp, op = jax.jit(
        lambda s: contact_forces_dense(
            s, params.replace(use_pallas="interpret"))
    )(st)
    assert int(ox) == int(op) == 0
    scale = float(jnp.abs(fx).max())
    np.testing.assert_allclose(
        np.asarray(fp), np.asarray(fx), rtol=1e-5, atol=1e-6 * scale
    )
    np.testing.assert_allclose(
        np.asarray(tp), np.asarray(tx), rtol=1e-5,
        atol=1e-6 * float(jnp.abs(tx).max()),
    )


def test_dense_contact_overflow_counted():
    """More than dense_k particles piled into one cell: the surplus exerts
    no force but is COUNTED, never silent."""
    import jax

    from sphsim.physics.contact_dense import contact_forces_dense

    n = 12
    params = SimParams(capacity=n, spawn_radius=12.0, dense_k=4,
                       use_pallas=False)
    st = SimState.zeros(n, params)
    st = st.replace_fields(
        pos=jax.random.normal(jax.random.PRNGKey(0), (n, 3)) * 0.05,
        radius=jnp.full(n, 2.0),
        active_count=jnp.int32(n),
    )
    _, _, ovf = contact_forces_dense(st, params)
    assert int(ovf) == n - 4


def test_simulation_runs_with_dense_neighbor_mode():
    """The full cell-sim frame (division + adhesion + drag + rotation) runs
    on the dense contact path and matches the grid path's trajectory."""
    from sphsim import Simulation
    from sphsim.engine.config import reference_genome, reference_scene_params

    base = reference_scene_params(capacity=16).replace(
        dt=0.5, max_splits_per_step=8, max_bonds=64, dense_k=4,
        use_pallas=False,
    )
    sims = {}
    for mode in ("grid", "dense"):
        p = base.replace(
            neighbor_mode=mode,
            grid_dim=16, grid_cell_size=4.0, cell_capacity=16,
        )
        s = Simulation(reference_genome(), p, seed=5)
        s.step(25)
        sims[mode] = s
    a, b = sims["grid"], sims["dense"]
    assert int(a.state.active_count) == int(b.state.active_count) >= 2
    n = int(a.state.active_count)
    np.testing.assert_allclose(
        np.asarray(a.state.pos[:n]), np.asarray(b.state.pos[:n]),
        rtol=1e-3, atol=1e-3,
    )
    assert int(b.state.overflow) == 0


@pytest.mark.parametrize("k", [1, 2, 8])
def test_dense_contact_matches_bruteforce_k_ladder(k):
    """The dense sweep must agree with the brute-force spec across the k
    ladder — catching k-dependent layout/padding bugs (the class the
    round-2 advisor flagged in the fluid spec's lane_mult). k=1 runs a
    random crowded ball where one-slot cells MUST overflow (loud count,
    finite outputs); k=2 (the colony-specced production config, ≤2
    centers per contact-range cell by scene design) runs its own state
    class: sparse touching PAIRS — contacts fire in every pair, and a
    pair sharing one cell fills exactly its 2 slots; k=8 (the
    fluid-shared config) runs the random ball overflow-free."""
    import jax

    from sphsim.physics.contact_dense import contact_forces_dense

    if k == 2:
        n = 128
        params = SimParams(
            capacity=n, spawn_radius=40.0, neighbor_mode="dense",
            dense_k=2, use_pallas=False,
        )
        # 64 pair centers on a coarse lattice (spacing 9 ≫ 2 cells), each
        # pair 1.9 apart along a random direction (< contact reach 2.0).
        g = jnp.arange(-3, 4, dtype=jnp.float32) * 9.0
        centers = jnp.stack(
            jnp.meshgrid(g, g, g, indexing="ij"), axis=-1
        ).reshape(-1, 3)
        centers = centers[
            jax.random.permutation(jax.random.PRNGKey(5), centers.shape[0])
        ][: n // 2]
        u = jax.random.normal(jax.random.PRNGKey(6), (n // 2, 3))
        u = u / jnp.linalg.norm(u, axis=-1, keepdims=True)
        pos = jnp.concatenate(
            [centers + 0.95 * u, centers - 0.95 * u]
        )
        st = SimState.zeros(n, params).replace_fields(
            pos=pos,
            vel=jax.random.normal(jax.random.PRNGKey(7), (n, 3)) * 0.5,
            ang_vel=jax.random.normal(jax.random.PRNGKey(8), (n, 3)) * 0.5,
            radius=jnp.full(n, 2.0),
            active_count=jnp.int32(n),
        )
    else:
        st, params = _random_colony(n=200, seed=k)
        params = params.replace(dense_k=k)
    fb, tb = contact_forces_bruteforce(st, params)
    fd, td, ovf = jax.jit(
        lambda s: contact_forces_dense(s, params)
    )(st)
    if k == 1:
        # One-slot cells on a crowded ball: the surplus is COUNTED, never
        # silent, and the resident subset still produces finite outputs.
        assert int(ovf) > 0
        assert bool(jnp.all(jnp.isfinite(fd))) and bool(
            jnp.all(jnp.isfinite(td))
        )
        return
    assert int(ovf) == 0
    f_scale = float(jnp.abs(fb).max())
    t_scale = float(jnp.abs(tb).max())
    assert f_scale > 0 and t_scale > 0
    np.testing.assert_allclose(
        np.asarray(fd), np.asarray(fb), atol=2e-4 * f_scale, rtol=2e-4
    )
    np.testing.assert_allclose(
        np.asarray(td), np.asarray(tb), atol=2e-4 * t_scale, rtol=2e-4
    )


def test_out_of_domain_particles_bin_interior_all_engines_agree():
    """Particles OUTSIDE the spawn sphere (division children are placed at
    parent ± offset BEFORE update_motion's boundary clamp runs, cs:753-754)
    must bin into interior edge cells, never the sentinel margin ring.
    Regression: margin-binned particles made plane 0 partner ITSELF in a
    kernel with clamped dz blocks, double-counting every same-plane pair
    there — diverging from the XLA twin and both sharded rings."""
    import jax

    from sphsim.physics.contact_dense import contact_forces_dense

    n = 4
    params = SimParams(
        capacity=n, spawn_radius=10.0, neighbor_mode="dense", dense_k=4,
    )
    # A touching pair BELOW the sphere (z < -spawn_radius lands in the
    # margin plane pre-fix) plus a touching pair above the top.
    st = SimState.zeros(n, params).replace_fields(
        pos=jnp.array([
            [0.0, 0.0, -11.0], [0.3, 0.0, -10.2],
            [0.0, -11.0, 10.8], [0.0, -10.1, 10.3],
        ], jnp.float32),
        vel=jnp.array([
            [0.0, 1.0, 0.0], [0.0, 0.0, 0.0],
            [1.0, 0.0, 0.0], [0.0, 0.0, 0.0],
        ], jnp.float32),
        radius=jnp.full(n, 2.0),
        active_count=jnp.int32(n),
    )
    fb, tb = contact_forces_bruteforce(st, params)
    assert float(jnp.abs(fb).max()) > 0      # the pairs really touch
    for use_pallas in (False, "interpret"):
        fd, td, ovf = jax.jit(
            lambda s, p=params.replace(use_pallas=use_pallas):
            contact_forces_dense(s, p)
        )(st)
        assert int(ovf) == 0
        np.testing.assert_allclose(
            np.asarray(fd), np.asarray(fb), rtol=2e-4,
            atol=2e-4 * float(jnp.abs(fb).max()),
            err_msg=f"force use_pallas={use_pallas}",
        )
        np.testing.assert_allclose(
            np.asarray(td), np.asarray(tb), rtol=2e-4,
            atol=2e-4 * float(jnp.abs(tb).max()),
            err_msg=f"torque use_pallas={use_pallas}",
        )


def test_dense_contact_settled_screen_skips_to_zero():
    """A settled colony (every pair farther apart than the contact reach —
    the adhesion-rest-length steady state, engine/colony.py) must produce
    exactly zero forces through the Triton path, where the block-level
    contact screen (ops/pallas/sweep.py) skips every pair sweep, AND
    through the XLA twin, which computes the full sweep — the screen's
    'skipped variants contribute exact ±0' argument, asserted end to end."""
    import jax

    from sphsim.physics.contact_dense import contact_forces_dense

    n = 64
    params = SimParams(capacity=n, spawn_radius=14.0, dense_k=2)
    # 4x4x4 lattice at spacing 3.0 > reach 2.0 (radius 2.0, eff 1.0+1.0).
    ax = (jnp.arange(4, dtype=jnp.float32) - 1.5) * 3.0
    gx, gy, gz = jnp.meshgrid(ax, ax, ax, indexing="ij")
    pos = jnp.stack([gx, gy, gz], -1).reshape(-1, 3)
    st = SimState.zeros(n, params)
    st = st.replace_fields(
        pos=pos,
        vel=jnp.ones((n, 3)) * 0.3,          # motion, but no contact
        ang_vel=jnp.ones((n, 3)) * 0.2,
        radius=jnp.full(n, 2.0),
        active_count=jnp.int32(n),
    )
    for use_pallas in (False, "interpret"):
        f, t, ovf = jax.jit(
            lambda s, p=params.replace(use_pallas=use_pallas):
            contact_forces_dense(s, p)
        )(st)
        assert int(ovf) == 0
        np.testing.assert_array_equal(np.asarray(f), 0.0)
        np.testing.assert_array_equal(np.asarray(t), 0.0)
