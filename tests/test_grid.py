"""Grid neighbor search: binning correctness + brute-force equivalence
(SURVEY §4 item 2; BASELINE config[1])."""

import jax
import jax.numpy as jnp
import numpy as np

from sphsim.core.types import SimParams, SimState
from sphsim.ops.grid import (
    GridSpec,
    build_bins,
    cell_coords,
    cell_ids,
    contact_forces_grid,
    stencil_candidates,
)
from sphsim.physics.contact import contact_forces_bruteforce


def spec(dim=8, cell=4.0, K=8):
    r = dim * cell / 2
    return GridSpec(dim=(dim, dim, dim), cell_size=cell, origin=(-r, -r, -r),
                    cell_capacity=K)


def test_cell_coords_clamping():
    s = spec()
    # The reference clamps out-of-range positions into edge cells
    # (compute:104).
    pos = jnp.array([[-100.0, 0.0, 0.0], [100.0, 100.0, 100.0], [0.0, 0.0, 0.0]])
    c = cell_coords(pos, s)
    np.testing.assert_array_equal(c[0], [0, 4, 4])
    np.testing.assert_array_equal(c[1], [7, 7, 7])
    np.testing.assert_array_equal(c[2], [4, 4, 4])


def test_linear_hash():
    s = spec(dim=8)
    c = jnp.array([[1, 2, 3]])
    assert int(cell_ids(c, s)[0]) == 1 + 2 * 8 + 3 * 64


def test_build_bins_exact_membership():
    s = spec(K=4)
    key = jax.random.PRNGKey(0)
    N = 64
    pos = jax.random.uniform(key, (N, 3), minval=-15, maxval=15)
    alive = jnp.arange(N) < 50
    bins = build_bins(pos, alive, s)
    cid = np.asarray(cell_ids(cell_coords(pos, s), s))
    idx = np.asarray(bins.idx)
    counts = np.asarray(bins.counts)
    # Every alive particle appears exactly once (unless its cell overflowed).
    flat = idx[idx >= 0]
    assert len(flat) == len(set(flat.tolist()))
    for i in range(50):
        in_bin = i in idx[cid[i]]
        overflowed = counts[cid[i]] > s.cell_capacity
        assert in_bin or overflowed
    # Dead particles never appear.
    for i in range(50, N):
        assert i not in flat
    # Counts are the true per-cell occupancy of alive particles.
    for c in np.unique(cid[:50]):
        assert counts[c] == int(np.sum(cid[:50] == c))


def test_build_bins_overflow_counted():
    s = spec(K=2)
    pos = jnp.zeros((5, 3))  # all in one cell, K=2 ⇒ 3 overflow
    bins = build_bins(pos, jnp.ones(5, bool), s)
    assert int(bins.overflow) == 3
    assert int(bins.counts[int(cell_ids(cell_coords(pos[:1], s), s)[0])]) == 5


def test_stencil_includes_neighbors_only():
    s = spec(dim=4, cell=4.0, K=4)
    # particles in adjacent cells and one far away
    pos = jnp.array([
        [-6.0, -6.0, -6.0],   # cell (0,0,0)
        [-2.0, -6.0, -6.0],   # cell (1,0,0) — neighbor
        [6.0, 6.0, 6.0],      # far corner
    ])
    bins = build_bins(pos, jnp.ones(3, bool), s)
    cand = np.asarray(stencil_candidates(cell_coords(pos, s), bins, s))
    c0 = set(cand[0][cand[0] >= 0].tolist())
    assert c0 == {0, 1}


def random_state(n, params, seed=0, spread=15.0):
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    st = SimState.zeros(n, params)
    return st.replace_fields(
        pos=jax.random.uniform(k1, (n, 3), minval=-spread, maxval=spread),
        vel=jax.random.normal(k2, (n, 3)),
        ang_vel=jax.random.normal(k3, (n, 3)) * 0.5,
        radius=jnp.full(n, 2.0),
        mass=jnp.ones(n),
        inertia=jnp.ones(n),
        active_count=jnp.int32(n - 4),  # a few dead slots
    )


def test_grid_matches_bruteforce():
    # Contact reach = r_eff_i + r_eff_j = 2 ≤ cell 4.0 ⇒ grid is exact.
    params = SimParams(capacity=256, grid_dim=8, grid_cell_size=4.0,
                       cell_capacity=32, spawn_radius=16.0)
    st = random_state(256, params)
    f_b, t_b = contact_forces_bruteforce(st, params)
    f_g, t_g, ovf = contact_forces_grid(st, params)
    assert int(ovf) == 0
    np.testing.assert_allclose(f_g, f_b, atol=1e-4)
    np.testing.assert_allclose(t_g, t_b, atol=1e-4)


def test_grid_matches_bruteforce_dense_clump():
    # Everything piled into a few cells: stresses K and the stencil mask.
    params = SimParams(capacity=128, grid_dim=8, grid_cell_size=4.0,
                       cell_capacity=128, spawn_radius=16.0)
    st = random_state(128, params, seed=3, spread=3.0)
    f_b, t_b = contact_forces_bruteforce(st, params)
    f_g, t_g, _ = contact_forces_grid(st, params)
    np.testing.assert_allclose(f_g, f_b, atol=1e-4)
    np.testing.assert_allclose(t_g, t_b, atol=1e-4)


def test_grid_row_blocking_consistent():
    params = SimParams(capacity=100, grid_dim=8, grid_cell_size=4.0,
                       cell_capacity=32, spawn_radius=16.0)
    st = random_state(100, params, seed=5)
    f1, t1, _ = contact_forces_grid(st, params, row_block=100)
    f2, t2, _ = contact_forces_grid(st, params, row_block=32)
    np.testing.assert_allclose(f1, f2, atol=1e-6)
    np.testing.assert_allclose(t1, t2, atol=1e-6)


def test_grid_overflow_surfaced_in_sim_state():
    """Mirror of test_contact.py's dense-overflow test for the grid path:
    a deliberately tiny cell_capacity must surface a non-zero count in
    SimState.overflow after a step (the grid path once computed
    bins.overflow and then discarded it)."""
    from sphsim.engine.step import make_step_fn
    from sphsim.engine.config import reference_genome, reference_scene_params
    from sphsim.core.init import init_particles

    genome = reference_genome()
    params = reference_scene_params(capacity=32).replace(
        neighbor_mode="grid", cell_capacity=1, max_splits_per_step=4,
        max_bonds=16,
    )
    gd = genome.to_device()
    st = init_particles(params, gd, n_modes=1, initial_mode=0, capacity=32,
                        active_count=32)
    # Pile everyone into one cell so K=1 must overflow.
    st = st.replace_fields(pos=st.pos * 0.01)
    st = make_step_fn(params, donate=False)(st, gd)
    assert int(st.overflow) >= 31


def test_full_step_grid_vs_bruteforce():
    # The whole engine (division + adhesion + integration) must agree
    # between neighbor modes on a scenario that stays within grid reach.
    from sphsim.engine.config import reference_genome, reference_scene_params
    from sphsim.engine.step import make_step_fn
    from sphsim.core.init import init_particles

    genome = reference_genome()
    base = reference_scene_params(capacity=16).replace(
        dt=0.5, max_splits_per_step=8, max_bonds=64,
    )
    gd = genome.to_device()
    results = []
    for mode in ("bruteforce", "grid"):
        params = base.replace(neighbor_mode=mode)
        st = init_particles(params, gd, n_modes=1, initial_mode=0, capacity=16)
        f = make_step_fn(params, donate=False)
        for _ in range(24):  # divisions at steps 11 and 21 (interval 5, dt .5)
            st = f(st, gd)
        results.append(st)
    a, b = results
    assert int(a.active_count) == int(b.active_count) >= 4
    np.testing.assert_allclose(a.pos, b.pos, atol=1e-4)
    np.testing.assert_allclose(a.rot, b.rot, atol=1e-4)
    np.testing.assert_array_equal(a.bonds.active, b.bonds.active)
