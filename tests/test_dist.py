"""Multi-device domain decomposition: sharded == single-device on the
virtual CPU mesh (SURVEY §4 item 4). Occupancy (data movement) is compared
bitwise; float fields at last-ulp tolerance — XLA's FMA contraction is
graph-shape-dependent, so the sharded and single-device programs can differ
by ~1 ulp per accumulation even with identical op order (the XLA twin
differs from ITSELF jit-vs-eager; see tests/test_dense.py).

One shared configuration for every test (the XLA-twin compile is expensive
on CPU): k=4, cell_factor=1.3, rebin_every=3, random fluid with real
interactions and cross-shard migration.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec

from sphsim.parallel.dist import (
    exchange_halo,
    make_sharded_dense_step,
    shard_dense_state,
)
from sphsim.sph.dense import make_dense_spec, pack, make_dense_step

N_DEV = 4
SUBSTEPS = 12


def mesh_1d(n=N_DEV):
    return Mesh(np.array(jax.devices()[:n]), ("x",))


def random_fluid(n=400, seed=0):
    """Random positions, ~0.35 particles per cell at cell_factor 1 (so k=4
    never overflows even at cell_factor 1.3), real interactions, and random
    velocities that push particles across shard boundaries."""
    from sphsim.sph.model import SPHParams, SPHState

    rng = np.random.default_rng(seed)
    box = (1.0, 1.0, 1.0)
    pos = rng.uniform(0.05, 0.95, (n, 3)).astype(np.float32) * np.asarray(box)
    h = float((0.15 * 0.729 * np.prod(box) / n) ** (1 / 3))
    params = SPHParams(
        ndim=3, h=h, particle_mass=1000.0 * np.prod(box) / n,
        bounds_min=(0.0, 0.0, 0.0), bounds_max=box,
        dt=0.25 * h / 60.0, sound_speed=60.0, viscosity=0.05,
        dense_k=4, cell_factor=1.3, use_pallas=False, rebin_every=3,
    )
    state = SPHState.from_positions(jnp.asarray(pos), params)
    vel = jnp.asarray(rng.normal(0, 2.0, (n, 3)).astype(np.float32))
    return state.replace_fields(vel=vel), params


@pytest.fixture(scope="module")
def runs():
    import dataclasses

    state, params = random_fluid(400)
    spec = make_dense_spec(params, k=4, cell_factor=1.3)
    spec = dataclasses.replace(spec, n0=-(-spec.n0 // N_DEV) * N_DEV)
    d0 = pack(state, params, spec)
    ref = make_dense_step(params, spec, substeps=SUBSTEPS, donate=False)(d0)
    mesh = mesh_1d()
    out = make_sharded_dense_step(
        params, spec, mesh, substeps=SUBSTEPS, donate=False
    )(shard_dense_state(d0, mesh))
    return d0, ref, out


def test_exchange_halo_ring():
    mesh = mesh_1d(4)
    arr = jnp.arange(8 * 2 * 4, dtype=jnp.float32).reshape(8, 2, 4)

    def f(a):
        return exchange_halo(a, "x")

    out = jax.jit(
        jax.shard_map(
            f, mesh=mesh,
            in_specs=(PartitionSpec("x", None, None),),
            out_specs=PartitionSpec("x", None, None),
            check_vma=False,
        )
    )(arr)
    out = np.asarray(out).reshape(4, 4, 2, 4)  # [dev, P+2, ...]
    base = np.asarray(arr).reshape(4, 2, 2, 4)
    for i in range(4):
        np.testing.assert_array_equal(out[i, 1:-1], base[i])
        np.testing.assert_array_equal(out[i, 0], base[(i - 1) % 4, -1])
        np.testing.assert_array_equal(out[i, -1], base[(i + 1) % 4, 0])


def _assert_state_matches(ref, out):
    """Occupancy bitwise; floats at last-ulp contraction tolerance."""
    np.testing.assert_array_equal(np.asarray(ref.occ), np.asarray(out.occ))
    np.testing.assert_allclose(np.asarray(ref.px), np.asarray(out.px),
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(ref.vy), np.asarray(out.vy),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(ref.rho), np.asarray(out.rho),
                               rtol=1e-6)


def test_sharded_matches_single_device(runs):
    _, ref, out = runs
    _assert_state_matches(ref, out)


def test_population_conserved_across_shards(runs):
    d0, ref, out = runs
    n0 = int(jnp.sum(d0.occ))
    assert int(jnp.sum(out.occ)) == n0
    assert int(out.dropped) == 0
    assert int(ref.dropped) == 0


def test_particles_actually_migrated(runs):
    """The scenario must exercise cross-shard migration, or the equality
    test proves nothing."""
    d0, ref, _ = runs
    occ0 = np.asarray(d0.occ).reshape(d0.occ.shape[0], -1).sum(1)
    occ1 = np.asarray(ref.occ).reshape(ref.occ.shape[0], -1).sum(1)
    assert (occ0 != occ1).any()


def test_make_mesh_2d_keeps_device_order():
    """Cards of one host are joined all to all: the 2D mesh is the first
    pz·py devices in id order, row-major."""
    from sphsim.parallel.dist import make_mesh_2d

    devs = jax.devices()[:8]
    m = make_mesh_2d((2, 4), devs, axis_names=("z", "y"))
    assert m.axis_names == ("z", "y") and m.devices.shape == (2, 4)
    assert [d.id for d in m.devices.flat] == [d.id for d in devs]
    assert make_mesh_2d((2, 2)).devices.shape == (2, 2)


def test_autopad_8dev_matches_single_device(runs):
    """Full 8-device mesh with an n0 NOT divisible by the device count:
    make_sharded_dense_step must pad internally and still match the
    single-device run (uses the cached 4-dev reference's d0/ref —
    spec.n0 is a multiple of 4 but not of 8)."""
    d0, ref, _ = runs
    state, params = random_fluid(400)
    spec = make_dense_spec(params, k=4, cell_factor=1.3)
    import dataclasses

    spec = dataclasses.replace(spec, n0=-(-spec.n0 // N_DEV) * N_DEV)
    if spec.n0 % 8 == 0:  # make it uneven on purpose
        spec = dataclasses.replace(spec, n0=spec.n0 + N_DEV)
        d0 = pack(state, params, spec)
        ref = make_dense_step(params, spec, substeps=SUBSTEPS,
                              donate=False)(d0)
    mesh = mesh_1d(8)
    out = make_sharded_dense_step(
        params, spec, mesh, substeps=SUBSTEPS, donate=False
    )(shard_dense_state(d0, mesh))
    assert out.px.shape == ref.px.shape
    np.testing.assert_array_equal(np.asarray(ref.occ), np.asarray(out.occ))
    np.testing.assert_allclose(np.asarray(ref.px), np.asarray(out.px),
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(ref.vy), np.asarray(out.vy),
                               rtol=1e-5, atol=1e-6)


def test_sharded_contact_forces_bit_equal():
    """The contact regime's sharded sweep (make_sharded_contact_forces,
    z-slab halo ring over the [Z, Y, X·K] layout) is BITWISE equal to the
    single-device dense contact path — slab interiors see identical
    3-plane inputs, and global-edge clip vs wrapped-sentinel halos both
    contribute exact zeros."""
    from sphsim.core.types import SimParams, SimState
    from sphsim.parallel.dist import make_sharded_contact_forces
    from sphsim.physics.contact_dense import contact_forces_dense

    n = 300
    params = SimParams(
        capacity=n, spawn_radius=10.0, neighbor_mode="dense",
        dense_k=4, use_pallas="interpret",   # k=4: random ball, not lattice
    )
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(7), 3)
    u = jax.random.normal(k1, (n, 3))
    u = u / jnp.linalg.norm(u, axis=-1, keepdims=True)
    r = 9.0 * jax.random.uniform(k2, (n, 1)) ** (1 / 3)
    st = SimState.zeros(n, params).replace_fields(
        pos=u * r,
        vel=jax.random.normal(k3, (n, 3)) * 0.5,
        radius=jnp.full(n, 2.0),
        active_count=jnp.int32(n),
    )
    f1, t1, o1 = jax.jit(lambda s: contact_forces_dense(s, params))(st)
    mesh = mesh_1d(8)
    f8, t8, o8 = make_sharded_contact_forces(params, mesh)(st)
    assert int(o1) == int(o8) == 0
    assert float(jnp.abs(f1).max()) > 0  # colony really interacts
    np.testing.assert_array_equal(np.asarray(f1), np.asarray(f8))
    np.testing.assert_array_equal(np.asarray(t1), np.asarray(t8))


def test_2d_decomposition_matches_single_device():
    """2D (plane-slab × row-block) decomposition over a 2×4 mesh matches
    the single-device run across rebins, with cross-shard migration on
    BOTH mesh axes. Row halos ride the fused axis inside a 7-sentinel-row
    pad; corner cells arrive transitively (y pad first, then z)."""
    import dataclasses

    from sphsim.parallel.dist import make_mesh_2d, make_sharded_dense_step_2d

    state, params = random_fluid(400, seed=3)
    spec = make_dense_spec(params, k=4, cell_factor=1.3)
    d0 = pack(state, params, spec)
    ref = make_dense_step(params, spec, substeps=SUBSTEPS, donate=False)(d0)

    mesh = make_mesh_2d((2, 4), jax.devices()[:8])
    out = make_sharded_dense_step_2d(
        params, spec, mesh, substeps=SUBSTEPS, donate=False
    )(d0)
    assert out.px.shape == ref.px.shape
    _assert_state_matches(ref, out)
    assert int(out.dropped) == 0

    # Migration across ROW blocks (the y axis this test is really about):
    X = spec.X
    occ0 = np.asarray(d0.occ).reshape(d0.occ.shape[0], d0.occ.shape[1],
                                      -1, X).sum(axis=(0, 1, 3))
    occ1 = np.asarray(ref.occ).reshape(*occ0.shape[:0], d0.occ.shape[0],
                                       d0.occ.shape[1], -1, X
                                       ).sum(axis=(0, 1, 3))
    assert (occ0 != occ1).any()


def test_2d_decomposition_pallas_path():
    """Same 2×4 decomposition through the Triton kernels (Pallas
    interpreter): the derived local spec (rows_local + 16 rows) must keep
    the fused axis a multiple of the kernels' lane block and match the
    XLA-twin sharded run (the kernel sums in another order: float32
    reassociation tolerance)."""
    import dataclasses

    from sphsim.parallel.dist import make_mesh_2d, make_sharded_dense_step_2d

    state, params = random_fluid(400, seed=5)
    spec = make_dense_spec(params, k=4, cell_factor=1.3)
    d0 = pack(state, params, spec)
    mesh = make_mesh_2d((2, 4), jax.devices()[:8])
    sub = 3
    out_x = make_sharded_dense_step_2d(
        params, spec, mesh, substeps=sub, donate=False
    )(d0)
    out_p = make_sharded_dense_step_2d(
        params.replace(use_pallas="interpret"), spec, mesh,
        substeps=sub, donate=False,
    )(d0)
    np.testing.assert_array_equal(np.asarray(out_x.occ),
                                  np.asarray(out_p.occ))
    np.testing.assert_allclose(np.asarray(out_x.px), np.asarray(out_p.px),
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(out_x.vy), np.asarray(out_p.vy),
                               rtol=1e-5, atol=1e-6)


def test_sharded_contact_forces_2d_bit_equal():
    """Contact sweep over a 2D (z-slab × y-block) 2×4 mesh is bitwise
    equal to the single-device path: y halos are plain ±1-row ppermutes,
    corners arrive transitively."""
    from sphsim.core.types import SimParams, SimState
    from sphsim.parallel.dist import (
        make_mesh_2d,
        make_sharded_contact_forces_2d,
    )
    from sphsim.physics.contact_dense import contact_forces_dense

    n = 300
    params = SimParams(
        capacity=n, spawn_radius=10.0, neighbor_mode="dense",
        dense_k=4, use_pallas="interpret",
    )
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(11), 3)
    u = jax.random.normal(k1, (n, 3))
    u = u / jnp.linalg.norm(u, axis=-1, keepdims=True)
    r = 9.0 * jax.random.uniform(k2, (n, 1)) ** (1 / 3)
    st = SimState.zeros(n, params).replace_fields(
        pos=u * r,
        vel=jax.random.normal(k3, (n, 3)) * 0.5,
        radius=jnp.full(n, 2.0),
        active_count=jnp.int32(n),
    )
    f1, t1, o1 = jax.jit(lambda s: contact_forces_dense(s, params))(st)
    mesh = make_mesh_2d((2, 4), jax.devices()[:8], axis_names=("z", "y"))
    f8, t8, o8 = make_sharded_contact_forces_2d(params, mesh)(st)
    assert int(o1) == int(o8) == 0
    assert float(jnp.abs(f1).max()) > 0
    np.testing.assert_array_equal(np.asarray(f1), np.asarray(f8))
    np.testing.assert_array_equal(np.asarray(t1), np.asarray(t8))


def test_2d_decomposition_autopad_uneven_dims():
    """2D mesh where NEITHER dim divides evenly: n0=14 over pz=4 (pad 2
    planes) and n1 forced to 40 over py=2 (pad 8 rows) — the internal
    sentinel padding must keep results equal to single-device and shapes
    round-tripped."""
    import dataclasses

    from sphsim.parallel.dist import make_mesh_2d, make_sharded_dense_step_2d

    state, params = random_fluid(400, seed=7)
    spec = make_dense_spec(params, k=4, cell_factor=1.3)
    spec = dataclasses.replace(spec, n1=40)   # mult of 8, not of 16*py
    d0 = pack(state, params, spec)
    sub = 6
    ref = make_dense_step(params, spec, substeps=sub, donate=False)(d0)

    mesh = make_mesh_2d((4, 2), jax.devices()[:8])
    assert spec.n0 % 4 != 0 and spec.n1 % (8 * 2 * 2) != 0
    out = make_sharded_dense_step_2d(
        params, spec, mesh, substeps=sub, donate=False
    )(d0)
    assert out.px.shape == ref.px.shape
    np.testing.assert_array_equal(np.asarray(ref.occ), np.asarray(out.occ))
    np.testing.assert_allclose(np.asarray(ref.px), np.asarray(out.px),
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(ref.vy), np.asarray(out.vy),
                               rtol=1e-5, atol=1e-6)
    assert int(out.dropped) == 0


def test_sharded_full_colony_step_bit_equal():
    """The FULL biology step (division + contact + adhesion + integration +
    bond rewrite) with the contact sweep decomposed over a mesh
    (Simulation(mesh=...)) is BITWISE equal to the single-device run —
    across a real division window (16 armed timers split mid-run, bonds
    are inherited and pruned), on both the 1D z-slab ring and the 2×4
    (z-slab × y-block) mesh."""
    from sphsim.engine.colony import bonded_colony
    from sphsim.parallel.dist import make_mesh_2d

    from sphsim import Simulation

    def final_state(mesh):
        state, params, genome = bonded_colony(
            256, neighbor_mode="dense", dense_k=2, use_pallas="interpret",
            max_splits_per_step=32,
        )
        sim = Simulation(genome, params, auto_grow=False, donate=False,
                         scan_chunk=4, mesh=mesh)
        sim.state = state
        sim.resize(320)   # headroom so the armed splits actually apply
        interval = genome.modes[0].split_interval
        timer = sim.state.split_timer.at[:16].set(
            jnp.float32(interval - 2 * params.dt)
        )
        sim.state = sim.state.replace_fields(split_timer=timer)
        sim.step(8)
        return sim.state

    ref = final_state(None)
    assert int(ref.active_count) == 256 + 16   # the splits really fired
    for mesh in (mesh_1d(8), make_mesh_2d((4, 2), jax.devices()[:8],
                                          axis_names=("z", "y"))):
        out = final_state(mesh)
        assert int(out.active_count) == int(ref.active_count)
        for f in ("pos", "vel", "rot", "ang_vel", "split_timer", "uid"):
            np.testing.assert_array_equal(
                np.asarray(getattr(ref, f)), np.asarray(getattr(out, f)),
                err_msg=f,
            )
        for f in ("active", "slot_a", "slot_b", "zone_a", "zone_b"):
            np.testing.assert_array_equal(
                np.asarray(getattr(ref.bonds, f)),
                np.asarray(getattr(out.bonds, f)), err_msg=f"bonds.{f}",
            )
        assert int(out.overflow) == 0


def test_checkpoint_restore_into_mesh_sim(tmp_path):
    """save() on a single-device sim, load(mesh=...) into a mesh-sharded
    one: stepping both produces bitwise-equal states (the sharded sweep
    contract survives the checkpoint boundary)."""
    from sphsim.engine.colony import bonded_colony

    from sphsim import Simulation

    state, params, genome = bonded_colony(
        128, neighbor_mode="dense", dense_k=2, use_pallas=False,
    )
    sim = Simulation(genome, params, donate=False, scan_chunk=4)
    sim.state = state
    sim.step(4)
    path = str(tmp_path / "colony.npz")
    sim.save(path)

    plain = Simulation.load(path)
    sharded = Simulation.load(path, mesh=mesh_1d(8))
    assert sharded.contact_fn is not None and plain.contact_fn is None
    plain.donate = sharded.donate = False
    plain.step(4)
    sharded.step(4)
    np.testing.assert_array_equal(
        np.asarray(plain.state.pos), np.asarray(sharded.state.pos)
    )
    np.testing.assert_array_equal(
        np.asarray(plain.state.rot), np.asarray(sharded.state.rot)
    )


def test_sharded_fluid_pallas_matches_single_device():
    """1D-sharded fluid through the Triton kernels (Pallas interpreter) on
    the halo-padded slab vs the single-device kernel step: occupancy and
    `dropped` bitwise, positions at the last-ulp pair tolerance. The halo
    planes hold real particles, so the kernel's masked edge reads are
    exercised."""
    import dataclasses

    state, params = random_fluid(400, seed=3)
    params = params.replace(use_pallas="interpret", rebin_every=2)
    spec = make_dense_spec(params, k=4, cell_factor=1.3)
    spec = dataclasses.replace(spec, n0=-(-spec.n0 // 8) * 8)
    d0 = pack(state, params, spec)
    sub = 6
    ref = make_dense_step(params, spec, substeps=sub, donate=False)(d0)
    out = make_sharded_dense_step(
        params, spec, mesh_1d(8), substeps=sub, donate=False
    )(shard_dense_state(d0, mesh_1d(8)))
    np.testing.assert_array_equal(np.asarray(ref.occ), np.asarray(out.occ))
    assert int(ref.dropped) == int(out.dropped) == 0
    np.testing.assert_allclose(np.asarray(ref.px), np.asarray(out.px),
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(ref.vy), np.asarray(out.vy),
                               rtol=1e-5, atol=1e-6)
