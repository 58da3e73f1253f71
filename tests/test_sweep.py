"""Triton-route stencil sweeps (ops/pallas/sweep.py) in the Pallas
interpreter: against the brute-force executable spec (sph/model.py,
physics/contact.py), across k, density and 2D/3D; the wrapper's block
choice, edge masking and empty-block path; and the use_pallas rule."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sphsim.core.types import SimParams
from sphsim.ops.pallas import sweep
from sphsim.sph.dense import make_dense_spec, pack, unpack
from sphsim.sph.model import (
    SPHParams,
    SPHState,
    compute_accel_bruteforce,
    compute_density_bruteforce,
    eos_pressure,
)


def _fluid(ndim, k, n, seed=0, fill=0.15):
    """Random fluid at a controllable density (fill = particles per h³
    scale); 2D lives on one z plane."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.05, 0.95, (n, 3)).astype(np.float32)
    if ndim == 2:
        pos[:, 2] = 0.0
        h = float(np.sqrt(fill * 4.0 / n))
    else:
        h = float((fill * 0.729 / n) ** (1 / 3))
    params = SPHParams(
        ndim=ndim, h=h, particle_mass=1000.0 / n,
        bounds_min=(0.0, 0.0, 0.0),
        bounds_max=(1.0, 1.0, 1.0 if ndim == 3 else 0.0),
        dt=0.25 * h / 60.0, sound_speed=60.0, viscosity=0.05,
        dense_k=k, cell_factor=1.3, use_pallas="interpret",
    )
    state = SPHState.from_positions(jnp.asarray(pos), params)
    vel = rng.normal(0, 1.0, (n, 3)).astype(np.float32)
    if ndim == 2:
        vel[:, 2] = 0.0
    return state.replace_fields(vel=jnp.asarray(vel)), params


# (ndim, k, n, fill): sparse and dense fills per layout.
CASES = [(2, 4, 300, 0.05), (2, 8, 600, 0.2), (3, 4, 300, 0.15),
         (3, 8, 500, 0.6)]


@pytest.mark.parametrize("ndim,k,n,fill", CASES,
                         ids=[f"{d}d-k{k}-fill{f}" for d, k, _, f in CASES])
def test_triton_fluid_sweeps_match_bruteforce(ndim, k, n, fill):
    """Density and acceleration from the Triton sweeps equal the O(N²)
    brute force on every particle (float32 reassociation tolerance)."""
    state, params = _fluid(ndim, k, n, seed=ndim * 10 + k, fill=fill)
    spec = make_dense_spec(params, k=k, cell_factor=params.cell_factor)
    d = pack(state, params, spec)
    m = np.asarray(unpack(d)[4])
    pos = np.asarray(unpack(d)[0])[m]
    vel = np.stack([np.asarray(getattr(d, f)).reshape(-1)[m]
                    for f in ("vx", "vy", "vz")], -1)

    rho = jax.jit(lambda d: sweep.density_pallas(
        d.px, d.py, d.pz, params, spec, interpret=True))(d)
    ref = SPHState.from_positions(jnp.asarray(pos), params).replace_fields(
        vel=jnp.asarray(vel))
    rho_b = np.asarray(compute_density_bruteforce(ref, params))
    np.testing.assert_allclose(np.asarray(rho).reshape(-1)[m], rho_b,
                               rtol=1e-5)

    rho_d = jnp.where(d.occ > 0.5, rho, params.rest_density)
    prs = jnp.where(d.occ > 0.5, eos_pressure(rho_d, params), 0.0)
    d2 = d.replace_fields(rho=rho_d, prs=prs)
    acc = jax.jit(lambda d: sweep.accel_pallas(
        d, d.prs / (d.rho * d.rho), params, spec, interpret=True))(d2)
    a_k = np.stack([np.asarray(a).reshape(-1)[m] for a in acc], -1)
    ref = ref.replace_fields(density=jnp.asarray(rho_b),
                             pressure=eos_pressure(jnp.asarray(rho_b),
                                                   params))
    a_b = np.asarray(compute_accel_bruteforce(ref, params)).copy()
    a_b[:, 1] += params.gravity   # the pair sweep excludes gravity
    scale = np.abs(a_b).max()
    assert scale > 0
    assert np.abs(a_k - a_b).max() / scale < 1e-4


def test_empty_blocks_store_zeros():
    """A block with no particle does no pair work and stores exact zeros
    (its lanes are rest-density-fixed / never integrated downstream)."""
    state, params = _fluid(3, 4, 60, fill=0.02)
    spec = make_dense_spec(params, k=4, cell_factor=params.cell_factor)
    d = pack(state, params, spec)
    rho = np.asarray(jax.jit(lambda d: sweep.density_pallas(
        d.px, d.py, d.pz, params, spec, interpret=True))(d))
    bc = sweep.block_lanes(spec.C, spec.k)
    occ = np.asarray(d.occ).reshape(spec.n0, spec.k, spec.C // bc, bc)
    blocks = rho.reshape(occ.shape)
    empty = occ.max(axis=(1, 3)) == 0
    assert empty.any() and (~empty).any()
    assert (blocks.transpose(0, 2, 1, 3)[empty] == 0).all()
    assert (rho[np.asarray(d.occ) > 0.5] > 0).all()


def test_partner_lanes_outside_array_are_masked():
    """Own lanes at the array edge (plane 0 and the first fused lanes, as
    on a sharded slab's halo plane) read sentinel fills, not wrapped or
    clamped neighbors: a lone pair in plane 0 sees only itself and its
    partner."""
    params = SPHParams(ndim=3, h=0.1, particle_mass=1.0,
                       bounds_min=(0.0, 0.0, 0.0),
                       bounds_max=(1.0, 1.0, 1.0), use_pallas="interpret")
    spec = make_dense_spec(params, k=2, cell_factor=1.3)
    shape = (spec.n0, spec.k, spec.C)
    px = np.full(shape, sweep.SENTINEL, np.float32)
    py, pz = px.copy(), px.copy()
    # Two particles 0.05 apart in plane 0, lanes 0 and 1; a third in the
    # LAST plane at the same lane (a wrapping roll would pair it).
    for (z, c, x) in ((0, 0, 0.0), (0, 1, 0.05), (spec.n0 - 1, 0, 0.0)):
        px[z, 0, c], py[z, 0, c], pz[z, 0, c] = x, 0.0, 0.0
    rho = np.asarray(sweep.density_pallas(
        jnp.asarray(px), jnp.asarray(py), jnp.asarray(pz), params, spec,
        interpret=True))
    h2 = params.h ** 2
    from sphsim.sph import kernels as KN

    coef = params.particle_mass * KN.poly6_coeff(params.h, 3)
    lone = coef * h2 ** 3
    pair = coef * (h2 ** 3 + (h2 - 0.05 ** 2) ** 3)
    np.testing.assert_allclose(rho[0, 0, 0], pair, rtol=1e-5)
    np.testing.assert_allclose(rho[-1, 0, 0], lone, rtol=1e-5)


@pytest.mark.parametrize("k", [2, 4])
def test_triton_contact_sweep_matches_bruteforce(k):
    """Dense contact through the Triton sweep (with its contact screen)
    equals the brute-force spec on a crowded random ball."""
    from sphsim.core.types import SimState
    from sphsim.physics.contact import contact_forces_bruteforce
    from sphsim.physics.contact_dense import contact_forces_dense

    n = 160
    params = SimParams(capacity=n, spawn_radius=12.0, neighbor_mode="dense",
                       dense_k=k, use_pallas="interpret")
    k1, k2, k3, k4 = jax.random.split(jax.random.PRNGKey(k), 4)
    u = jax.random.normal(k1, (n, 3))
    u = u / jnp.linalg.norm(u, axis=-1, keepdims=True)
    st = SimState.zeros(n, params).replace_fields(
        pos=u * (11.0 * jax.random.uniform(k2, (n, 1)) ** (1 / 3)),
        vel=jax.random.normal(k3, (n, 3)) * 0.5,
        ang_vel=jax.random.normal(k4, (n, 3)) * 0.5,
        radius=jnp.full(n, 2.0),
        active_count=jnp.int32(n),
    )
    fd, td, ovf = jax.jit(lambda s: contact_forces_dense(s, params))(st)
    assert int(ovf) == 0
    fb, tb = contact_forces_bruteforce(st, params)
    for got, ref in ((fd, fb), (td, tb)):
        scale = float(jnp.abs(ref).max())
        assert scale > 0
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                   atol=2e-4 * scale, rtol=2e-4)


@pytest.mark.parametrize("C,S,want", [
    (128, 8, 128), (384, 8, 128), (1024, 8, 128), (1024, 4, 256),
    (1024, 1, 1024), (3 * 256, 1, 256), (4096, 2, 512),
])
def test_block_lanes_choice(C, S, want):
    bc = sweep.block_lanes(C, S)
    assert bc == want and C % bc == 0 and bc & (bc - 1) == 0


@pytest.mark.parametrize("C,S", [(200, 8), (256, 6)])
def test_block_lanes_rejects_bad_shapes(C, S):
    with pytest.raises(ValueError):
        sweep.block_lanes(C, S)


def test_fluid_variants_cover_the_stencil():
    params = SPHParams(ndim=3, h=0.1, bounds_max=(1.0, 1.0, 1.0))
    spec3 = make_dense_spec(params, k=4, cell_factor=1.3)
    v3 = sweep.fluid_variants(spec3)
    assert len(v3) == 27 and len(set(v3)) == 27 and (0, 0) in v3
    assert max(o for _, o in v3) == spec3.X + 1
    spec2 = make_dense_spec(params.replace(ndim=2, bounds_max=(1.0, 1.0, 0.0)),
                            k=4, cell_factor=1.3)
    v2 = sweep.fluid_variants(spec2)
    assert len(v2) == 9 and all(dz == 0 for dz, _ in v2)


def test_kernel_mode_rule():
    """True (the default) raises with no compiled route; "interpret" and
    False are explicit; anything else, None included, is an error: no
    route is chosen by backend."""
    assert jax.default_backend() == "cpu"
    assert SPHParams().use_pallas is True
    assert SimParams().use_pallas is True
    assert sweep.kernel_mode(False) is None
    assert sweep.kernel_mode("interpret") == "interpret"
    with pytest.raises(RuntimeError, match="GPU"):
        sweep.kernel_mode(True)
    for bad in (None, "triton"):
        with pytest.raises(ValueError):
            sweep.kernel_mode(bad)


def test_use_pallas_true_raises_through_the_step():
    """The step never falls back silently: use_pallas=True on the CPU
    raises at trace time."""
    from sphsim.sph.dense import make_dense_step

    state, params = _fluid(2, 4, 100)
    params = params.replace(use_pallas=True)
    spec = make_dense_spec(params, k=4, cell_factor=params.cell_factor)
    d = pack(state, params, spec)
    with pytest.raises(RuntimeError, match="GPU"):
        make_dense_step(params, spec, donate=False)(d)


@pytest.mark.gpu
def test_compiled_sweeps_match_twin_on_gpu():
    """On the card: the compiled Triton sweeps vs the XLA twin (the CPU
    runs reach the same code only through the interpreter)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU backend (compiled Triton kernels)")
    from sphsim.sph.dense import accel_pass, density_pass

    state, params = _fluid(3, 4, 2000)
    spec = make_dense_spec(params, k=4, cell_factor=params.cell_factor)
    d = pack(state, params, spec)
    m = np.asarray(d.occ) > 0.5
    rho_x = np.asarray(density_pass(d, params, spec))
    rho_k = np.asarray(sweep.density_pallas(d.px, d.py, d.pz, params, spec))
    np.testing.assert_allclose(rho_k[m], rho_x[m], rtol=2e-5)
    prs = jnp.where(d.occ > 0.5, eos_pressure(jnp.asarray(rho_x), params),
                    0.0)
    d2 = d.replace_fields(rho=jnp.asarray(rho_x), prs=prs)
    a_x = accel_pass(d2, params, spec)
    a_k = sweep.accel_pallas(d2, d2.prs / (d2.rho * d2.rho), params, spec)
    for x, k_ in zip(a_x, a_k):
        x, k_ = np.asarray(x)[m], np.asarray(k_)[m]
        assert np.abs(x - k_).max() <= 1e-4 * np.abs(x).max()
