"""Dense cell-grid engine tests: parity with the brute-force executable spec,
Triton-kernel-vs-XLA agreement (Pallas interpreter), rebin conservation,
stepping."""

import jax
import jax.numpy as jnp
import numpy as np

from sphsim.sph.dense import (
    make_dense_spec,
    pack,
    unpack,
    density_pass,
    accel_pass,
    rebin,
    make_dense_step,
)
from sphsim.sph.model import (
    SPHState,
    compute_accel_bruteforce,
    compute_density_bruteforce,
    eos_pressure,
)
from sphsim.sph.scenes import dam_break_2d, dam_break_3d


def small_2d(n=300, k=4, cf=1.2):
    state, params = dam_break_2d(n_target=n)
    params = params.replace(dense_k=k, cell_factor=cf, use_pallas=False)
    spec = make_dense_spec(params, k=k, cell_factor=cf)
    return state, params, spec


def test_pack_unpack_roundtrip():
    state, params, spec = small_2d()
    d = pack(state, params, spec)
    pos, vel, _, _, mask = unpack(d)
    pos = np.asarray(pos)[np.asarray(mask)]
    assert pos.shape[0] == state.pos.shape[0]
    # Same multiset of positions.
    a = np.sort(pos.view([('x', 'f4'), ('y', 'f4'), ('z', 'f4')]), axis=0)
    b = np.sort(
        np.asarray(state.pos).copy().view(
            [('x', 'f4'), ('y', 'f4'), ('z', 'f4')]
        ),
        axis=0,
    )
    assert (a == b).all()


def test_density_matches_bruteforce_2d():
    state, params, spec = small_2d()
    d = pack(state, params, spec)
    rho = jax.jit(lambda d: density_pass(d, params, spec))(d)
    mask = np.asarray(unpack(d)[4])
    pos = np.asarray(unpack(d)[0])[mask]
    st = SPHState.from_positions(jnp.asarray(pos), params)
    rho_b = np.asarray(compute_density_bruteforce(st, params))
    np.testing.assert_allclose(
        np.asarray(rho).ravel()[mask], rho_b, rtol=1e-5
    )


def test_density_matches_bruteforce_3d():
    state, params = dam_break_3d(n_target=250)
    # 3D at cell_factor 1.2 ⇒ ~3.8 particles/cell: k=8 needed.
    params = params.replace(dense_k=8, cell_factor=1.2, use_pallas=False)
    spec = make_dense_spec(params, k=8, cell_factor=1.2)
    d = pack(state, params, spec)
    rho = jax.jit(lambda d: density_pass(d, params, spec))(d)
    mask = np.asarray(unpack(d)[4])
    pos = np.asarray(unpack(d)[0])[mask]
    st = SPHState.from_positions(jnp.asarray(pos), params)
    rho_b = np.asarray(compute_density_bruteforce(st, params))
    np.testing.assert_allclose(np.asarray(rho).ravel()[mask], rho_b, rtol=1e-5)


def test_accel_matches_bruteforce():
    state, params, spec = small_2d()
    d = pack(state, params, spec)
    rho = jax.jit(lambda d: density_pass(d, params, spec))(d)
    mask = np.asarray(unpack(d)[4])
    pos = np.asarray(unpack(d)[0])[mask]
    vel = np.sin(pos * 5.0).astype(np.float32)

    st = SPHState.from_positions(jnp.asarray(pos), params).replace_fields(
        vel=jnp.asarray(vel)
    )
    rho_b = compute_density_bruteforce(st, params)
    st = st.replace_fields(density=rho_b, pressure=eos_pressure(rho_b, params))
    a_b = np.asarray(compute_accel_bruteforce(st, params)).copy()
    a_b[:, 1] += params.gravity  # dense pair pass excludes gravity

    vx = np.zeros(d.vx.shape, np.float32)
    vy = np.zeros_like(vx)
    vz = np.zeros_like(vx)
    vx.ravel()[mask] = vel[:, 0]
    vy.ravel()[mask] = vel[:, 1]
    vz.ravel()[mask] = vel[:, 2]
    prs = jnp.where(d.occ > 0.5, eos_pressure(rho, params), 0.0)
    d2 = d.replace_fields(
        vx=jnp.asarray(vx), vy=jnp.asarray(vy), vz=jnp.asarray(vz),
        rho=rho, prs=prs,
    )
    ax, ay, az = jax.jit(lambda d: accel_pass(d, params, spec))(d2)
    a_d = np.stack(
        [np.asarray(ax).ravel()[mask], np.asarray(ay).ravel()[mask],
         np.asarray(az).ravel()[mask]], -1,
    )
    scale = np.abs(a_b).max()
    assert np.abs(a_b - a_d).max() / scale < 1e-4


def test_pallas_matches_xla_bit_exact():
    """Triton sweeps (Pallas interpreter) vs the XLA twin on the 2D dam
    break. The kernel sweeps the full stencil own-only while the twin is
    Newton-halved, so the same pair terms are summed in another order: the
    bound is float32 reassociation (~1e-7 relative), four orders of
    magnitude below a missed or doubled pair."""
    from sphsim.ops.pallas.sweep import accel_pallas, density_pallas

    state, params, spec = small_2d()
    d = pack(state, params, spec)
    rho_x = jax.jit(lambda d: density_pass(d, params, spec))(d)
    rho_p = jax.jit(
        lambda d: density_pallas(d.px, d.py, d.pz, params, spec,
                                 interpret=True)
    )(d)
    rho_p = jnp.where(
        d.occ > 0.5, jnp.maximum(rho_p, 1e-6), params.rest_density
    )
    np.testing.assert_allclose(
        np.asarray(rho_x), np.asarray(rho_p), rtol=1e-6
    )

    prs = jnp.where(d.occ > 0.5, eos_pressure(rho_x, params), 0.0)
    d2 = d.replace_fields(
        rho=rho_x, prs=prs,
        vx=jnp.sin(d.px * 3) * d.occ, vy=jnp.cos(d.py * 3) * d.occ,
    )
    a_x = jax.jit(lambda d: accel_pass(d, params, spec))(d2)
    a_p = jax.jit(
        lambda d: accel_pallas(d, d.prs / (d.rho * d.rho), params, spec,
                               interpret=True)
    )(d2)
    m = np.asarray(d.occ.reshape(-1)) > 0.5
    for x, p in zip(a_x, a_p):
        x = np.asarray(x).reshape(-1)[m]
        p = np.asarray(p).reshape(-1)[m]
        scale = np.abs(x).max()
        np.testing.assert_allclose(x, p, rtol=1e-5, atol=1e-6 * scale)


def test_rebin_conserves_and_relocates():
    state, params, spec = small_2d(k=8)  # headroom for the random crush
    d = pack(state, params, spec)
    n0 = int(jnp.sum(d.occ))
    key = jax.random.PRNGKey(0)
    delta = jax.random.uniform(
        key, (2, *d.px.shape), minval=-0.9 * spec.cell, maxval=0.9 * spec.cell
    )
    px = jnp.where(d.occ > 0.5, d.px + delta[0], d.px)
    py = jnp.where(d.occ > 0.5, d.py + delta[1], d.py)
    d2 = jax.jit(
        lambda d, px, py: rebin(d, px, py, d.pz, d.vx, d.vy, d.vz, params, spec)
    )(d, px, py)
    assert int(jnp.sum(d2.occ)) + int(d2.dropped) - int(d.dropped) == n0
    # Every surviving particle sits in the cell matching its position.
    pos, _, _, _, m = unpack(d2)
    pos = np.asarray(pos)
    m = np.asarray(m)
    flat = np.arange(d2.px.size)                 # [Z, K, C] flat order
    c = flat % spec.C
    i1 = c // spec.X                             # layout dim 1 (= world y, 2D)
    i2 = c % spec.X                              # layout dim 2 (= world x)
    org = np.asarray(spec.origin)
    wc = np.array(spec.world_cells())
    # Interior clip [1, wc-2] — margins stay sentinel (see dense.pack);
    # out-of-bounds jittered particles bin to the nearest interior cell.
    lo = np.minimum(1, wc - 1)
    hi = np.maximum(wc - 2, lo)
    cc = np.clip(((pos - org) / spec.cell).astype(int), lo, hi)
    assert (cc[m, spec.axis_map[2]] == i2[m]).all()
    assert (cc[m, spec.axis_map[1]] == i1[m]).all()


def test_dense_step_conserves_particles():
    state, params, spec = small_2d()
    d = pack(state, params, spec)
    n0 = int(jnp.sum(d.occ))
    f = make_dense_step(params, spec, substeps=150, donate=False)
    d = f(d)
    assert int(jnp.sum(d.occ)) == n0
    assert int(d.dropped) == 0
    pos, _, _, _, m = unpack(d)
    p = np.asarray(pos)[np.asarray(m)]
    assert np.isfinite(p).all()
    lo = np.asarray(params.bounds_min)
    hi = np.asarray(params.bounds_max)
    assert (p[:, :2] >= lo[None, :2] - 1e-5).all()
    assert (p[:, :2] <= hi[None, :2] + 1e-5).all()


def test_dense_matches_sorted_solver_trajectory():
    """Dense engine vs the sorted-pipeline reference on a short 2D run:
    same physics ⇒ same density statistics (orderings differ)."""
    from sphsim.sph.model import make_sph_step

    state, params, spec = small_2d(n=200)
    n_sub = 60
    f_ref = make_sph_step(params, donate=False, substeps=n_sub)
    ref = f_ref(state)

    fd = make_dense_step(params, spec, substeps=n_sub, donate=False)
    d = fd(pack(state, params, spec))
    pos_d, _, rho_d, _, m = unpack(d)
    pos_d = np.asarray(pos_d)[np.asarray(m)]
    pos_r = np.asarray(ref.pos)
    # Centroid and spread agree to float tolerance drift.
    np.testing.assert_allclose(
        pos_d.mean(axis=0), pos_r.mean(axis=0), atol=5e-3
    )
    np.testing.assert_allclose(
        pos_d.std(axis=0), pos_r.std(axis=0), atol=5e-3
    )


def test_rebin_every_with_velocity_clamp():
    state, params, spec = small_2d(k=8)
    params = params.replace(rebin_every=3)
    d = pack(state, params, spec)
    n0 = int(jnp.sum(d.occ))
    f = make_dense_step(params, spec, substeps=90, donate=False)
    d = f(d)
    assert int(jnp.sum(d.occ)) == n0
    assert int(d.dropped) == 0


def test_vmax_clamp_counted():
    """The rebin_vmax speed limit alters physics when it fires; hits must be
    counted as loudly as `dropped` (DenseFluidState.clamped)."""
    state, params, spec = small_2d(n=100)
    params = params.replace(rebin_every=3, cell_factor=1.2)
    d = pack(state, params, spec)
    # Calm fluid: no clamps.
    d1 = make_dense_step(params, spec, donate=False)(d)
    assert int(d1.clamped) == 0
    # Absurd velocities: every occupied lane must clamp (and be counted).
    fast = d.replace_fields(
        vx=jnp.where(d.occ > 0.5, 1e6, 0.0),
        vy=jnp.where(d.occ > 0.5, -1e6, 0.0),
    )
    d2 = make_dense_step(params, spec, donate=False)(fast)
    assert int(d2.clamped) == int(jnp.sum(d.occ))


def test_wall_clamped_particle_never_bins_into_margin():
    """With the domain extent an f32-EXACT multiple of the cell (h=0.125,
    cell_factor=2.0, bounds (0,1) → cell=0.25), a wall-clamped particle at
    exactly bounds_max used to bin into the top margin plane, where the
    Pallas kernel's clamped dz fetch paired the plane with ITSELF and
    double-counted the self density term (repro: 2079.7 vs the twin's
    1277.6). Margins must stay sentinel: pack/rebin now clip bins to the
    interior, and the Triton kernel must agree with the twin at the wall."""
    import jax

    from sphsim.ops.pallas.sweep import density_pallas
    from sphsim.sph.dense import density_pass
    from sphsim.sph.model import SPHParams, SPHState

    params = SPHParams(
        ndim=3, h=0.125, particle_mass=1.0,
        bounds_min=(0.0, 0.0, 0.0), bounds_max=(1.0, 1.0, 1.0),
        dt=1e-4, sound_speed=60.0, dense_k=4, cell_factor=2.0,
        use_pallas="interpret",
    )
    spec = make_dense_spec(params, k=4, cell_factor=2.0)
    assert float(spec.cell) == 0.25          # the f32-exact corner case
    pos = jnp.array([
        [1.0, 1.0, 1.0],                     # exactly at bounds_max
        [0.95, 1.0, 0.9],                    # a neighbor at the wall
        [0.0, 0.0, 0.0],                     # exactly at bounds_min
        [0.5, 0.5, 0.5],
    ], jnp.float32)
    d = pack(SPHState.from_positions(pos, params), params, spec)
    # No particle may occupy a margin cell: every occupied column must be
    # an interior cell on every axis.
    occ = np.asarray(d.occ)
    assert occ.sum() == 4
    wc = spec.world_cells()
    zpl, _, col = np.nonzero(occ)
    assert (zpl > 0).all() and (zpl < spec.n0 - 1).all()
    rows, cells = col // spec.X, col % spec.X
    assert (rows > 0).all() and (rows < wc[spec.axis_map[1]] - 1).all()
    assert (cells > 0).all() and (cells < wc[spec.axis_map[2]] - 1).all()

    rho_x = jax.jit(
        lambda d: density_pass(d, params.replace(use_pallas=False), spec)
    )(d)
    rho_p = jax.jit(
        lambda d: density_pallas(d.px, d.py, d.pz, params, spec,
                                 interpret=True)
    )(d)
    m = np.asarray(d.occ) > 0.5
    np.testing.assert_allclose(
        np.asarray(rho_p)[m], np.asarray(rho_x)[m], rtol=1e-6
    )
