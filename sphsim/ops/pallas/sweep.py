"""Stencil pair sweeps as Pallas kernels on the Triton route (GPU).

One builder serves the fluid density and acceleration passes
(sph.dense, fused [N0, K(slots), C=Y·X] layout) and the colony contact
sweep (physics.contact_dense, [Z, Y, X·K] layout seen as [Z, 1, Y·X·K]).
Both are OWN-ONLY full-stencil sweeps: every lane accumulates its own
terms and nothing is written outside the program's own block.

- Grid: one program per (plane, block of BC fused lanes). The own tile is
  [S, BC] (S = slots per cell: K for the fluid, 1 for the colony layout,
  whose slots ride the lanes).
- Each program first tests its own positions: a block that holds no
  particle (all lanes sentinel) stores zeros and does no pair work. Most of
  a dam-break tank is empty, so most blocks end here.
- A loop over the stencil variants (dz, lane offset o) loads, for every
  partner slot j, one [BC] row of each field straight from device memory
  at plane z+dz, slot j, lanes c+o (masked outside the array: masked lanes
  read the field's sentinel fill, which makes every pair term zero). The
  row broadcasts against the own tile, so a variant costs S partner rows
  per field, not S² tiles. Accumulators stay in registers.
- Optional screen (colony): a cheap first loop max-accumulates a contact
  margin over every variant; a block with no possible contact stores
  zeros without running the pair sweep.

Accumulation order: the colony sweep walks contact_variants in the XLA
twin's order (physics.contact_dense._sweep_xla), so the two differ only by
FMA contraction. The fluid sweep visits the full 27-cell stencil own-only,
while the XLA twin (sph.dense._sweep_xla) is Newton-halved with mirror
folding; the sums are the same terms in another order (tolerances in
tests/test_dense.py and chip_smoke.py).

A kernel runs in the Pallas interpreter only when the caller asks for it
(use_pallas="interpret"): that is how the CPU tests reach this code.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from sphsim.sph.dense import SENTINEL

NUM_WARPS = 4
# Own-tile size target (elements of [S, BC]): 1024 f32 over 4 warps is 8
# registers per field and thread.
TILE_ELEMS = 1024


def kernel_mode(use_pallas) -> str | None:
    """Resolve a use_pallas setting to "compiled", "interpret" or None
    (the XLA sweep).

    True (the default) demands the compiled kernel and raises on a backend
    that has none; False is the XLA sweep; "interpret" runs the kernel in
    the Pallas interpreter (CPU tests). Nothing is chosen by backend."""
    if use_pallas == "interpret":
        return "interpret"
    if use_pallas is True:
        backend = jax.default_backend()
        if backend != "gpu":
            raise RuntimeError(
                f"use_pallas=True needs a GPU backend (found {backend!r}): "
                "the sweeps are Triton kernels. Pass use_pallas=False for "
                "the XLA sweep or use_pallas='interpret' for the Pallas "
                "interpreter."
            )
        return "compiled"
    if use_pallas is False:
        return None
    raise ValueError(f"use_pallas must be True, False or 'interpret', "
                     f"got {use_pallas!r}")


def block_lanes(C: int, S: int) -> int:
    """Fused-lane block BC: a power of two ≥ 128 dividing C, with
    S·BC ≤ TILE_ELEMS where possible."""
    if C % 128:
        raise ValueError(f"fused axis {C} is not a multiple of 128")
    if S & (S - 1):
        raise ValueError(f"slot count {S} must be a power of two")
    bc = 128
    while bc * 2 * S <= TILE_ELEMS and C % (bc * 2) == 0:
        bc *= 2
    return bc


def _sweep_kernel(table, *refs, nf, ncomp, S, C, N0, bc, nv, fills,
                  pair_fn, screen_fn, screen_fields):
    fields = refs[:nf]
    outs = refs[nf:]
    z = pl.program_id(0)
    c0 = pl.program_id(1) * bc
    slot = jax.lax.broadcasted_iota(jnp.int32, (S, bc), 0)
    lane = jax.lax.broadcasted_iota(jnp.int32, (S, bc), 1)
    own_idx = (z * S + slot) * C + c0 + lane
    row = jax.lax.broadcasted_iota(jnp.int32, (1, bc), 1)
    zero = jnp.zeros((S, bc), jnp.float32)

    def partner(v, j, which):
        zz = z + table[2 * v]
        c = c0 + table[2 * v + 1] + row
        ok = (zz >= 0) & (zz < N0) & (c >= 0) & (c < C)
        idx = (zz * S + j) * C + c
        return [
            plt.load(fields[f].at[idx], mask=ok, other=fills[f])
            for f in which
        ]

    def store(vals):
        for o, v in zip(outs, vals):
            o[...] = v

    def sweep(own):
        def body(v, accs):
            accs = list(accs)
            for j in range(S):
                ts = pair_fn(*own, *partner(v, j, range(nf)))
                accs = [a + t for a, t in zip(accs, ts)]
            return tuple(accs)

        store(jax.lax.fori_loop(0, nv, body, (zero,) * ncomp))

    first = fields[0][own_idx]
    occupied = jnp.min(first) < 0.5 * SENTINEL

    @pl.when(occupied)
    def _():
        own = [first] + [f[own_idx] for f in fields[1:]]
        if screen_fn is None:
            sweep(own)
            return

        def screen_body(v, margin):
            q = partner(v, 0, screen_fields)
            c = [own[f] for f in screen_fields]
            return jnp.maximum(margin, screen_fn(*c, *q))

        margin = jax.lax.fori_loop(
            0, nv, screen_body, jnp.full((S, bc), -1.0, jnp.float32)
        )
        touching = jnp.max(margin) > 0.0

        @pl.when(touching)
        def _():
            sweep(own)

        @pl.when(jnp.logical_not(touching))
        def _():
            store([zero] * ncomp)

    @pl.when(jnp.logical_not(occupied))
    def _():
        store([zero] * ncomp)


def stencil_sweep(fields, variants, pair_fn, ncomp: int, fills, *,
                  screen_fn=None, screen_fields=(), interpret: bool = False):
    """Own-only stencil sweep over [N0, S, C] fields.

    variants: static (dz, o) pairs — partner of lane (z, i, c) is every
    slot j of lane (z+dz, j, c+o). pair_fn(*own, *partner) returns ncomp
    terms. fills: per-field value read outside the array (must make the
    pair term zero). The first field must hold SENTINEL in empty slots (it
    decides which blocks are empty).
    Returns ncomp [N0, S, C] arrays; empty blocks hold zeros."""
    N0, S, C = fields[0].shape
    nf = len(fields)
    bc = block_lanes(C, S)
    kernel = functools.partial(
        _sweep_kernel, nf=nf, ncomp=ncomp, S=S, C=C, N0=N0, bc=bc,
        nv=len(variants), fills=tuple(float(f) for f in fills),
        pair_fn=pair_fn, screen_fn=screen_fn,
        screen_fields=tuple(screen_fields),
    )
    out_spec = pl.BlockSpec((None, S, bc), lambda z, b: (z, 0, b))
    outs = pl.pallas_call(
        kernel,
        grid=(N0, C // bc),
        out_specs=[out_spec] * ncomp,
        out_shape=[jax.ShapeDtypeStruct((N0, S, C), jnp.float32)] * ncomp,
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS),
        interpret=interpret,
        name="stencil_sweep",
    )(jnp.asarray(variants, jnp.int32).reshape(-1),
      *[f.reshape(-1) for f in fields])
    return list(outs)


# ---------------------------------------------------------------------------
# Fluid passes (sph.dense layout)
# ---------------------------------------------------------------------------


def fluid_variants(spec) -> list:
    """Full own-only stencil: (dz, dy·X + dx) over the layout's stencil
    axes. Every partner slot j is visited, so the (0, 0) variant includes
    the self pair (density: the (h²)³ self term; accel: gated by r² > ε)."""
    dzs = (-1, 0, 1) if spec.stencil0 else (0,)
    dys = (-1, 0, 1) if spec.stencil1 else (0,)
    return [(dz, dy * spec.X + dx)
            for dz in dzs for dy in dys for dx in (-1, 0, 1)]


def density_pallas(px, py, pz, params, spec, interpret: bool = False):
    """Scaled raw ρ over all lanes (the caller applies the occupancy
    fixup)."""
    from sphsim.sph import kernels as KN
    from sphsim.sph.dense import density_pair_term

    h2 = params.h * params.h
    (acc,) = stencil_sweep(
        (px, py, pz), fluid_variants(spec),
        lambda *a: density_pair_term(h2, *a), ncomp=1,
        fills=(SENTINEL,) * 3, interpret=interpret,
    )
    return params.particle_mass * KN.poly6_coeff(params.h, params.ndim) * acc


def accel_pallas(d, pr2, params, spec, interpret: bool = False):
    """Pressure + viscosity acceleration over all lanes (no gravity or
    obstacles); zeros in empty blocks."""
    from sphsim.sph import kernels as KN
    from sphsim.sph.dense import accel_pair_terms

    m = params.particle_mass
    pair = functools.partial(
        accel_pair_terms,
        params.h,
        float(-m * KN.spiky_grad_coeff(params.h, params.ndim)),
        float(params.viscosity * m
              * KN.viscosity_lap_coeff(params.h, params.ndim)),
    )
    fields = (d.px, d.py, d.pz, d.vx, d.vy, d.vz, 1.0 / d.rho, pr2)
    return tuple(stencil_sweep(
        fields, fluid_variants(spec), pair, ncomp=3,
        fills=(SENTINEL,) * 3 + (0.0,) * 5, interpret=interpret,
    ))


# ---------------------------------------------------------------------------
# Colony contact sweep (physics.contact_dense layout)
# ---------------------------------------------------------------------------


def contact_sweep_pallas(fields, spec, pair_fn, fills, ncomp: int = 6,
                         screen_fn=None, interpret: bool = False):
    """Full-stencil own-only contact sweep over [NZ, NY, L] fields, in
    contact_variants order; returns ncomp [NZ, NY, L] accumulators.

    screen_fn(cx, cy, cz, crad, qx, qy, qz, qrad) -> margin gates each
    block's pair sweep (physics.contact_dense.contact_screen)."""
    from sphsim.physics.contact_dense import contact_variants

    NZ, NY, L = fields[0].shape
    flat = [f.reshape(NZ, 1, NY * L) for f in fields]
    variants = [(dz, dy * L + o) for dz, dy, o in contact_variants(spec)]
    outs = stencil_sweep(
        flat, variants, pair_fn, ncomp, fills,
        screen_fn=screen_fn, screen_fields=(0, 1, 2, 9),
        interpret=interpret,
    )
    return [o.reshape(NZ, NY, L) for o in outs]
