"""Dense cell-grid SPH engine — the fluid's performance path.

Particles live in a dense cell-major layout and neighbor pairs are
enumerated by stencil offsets — no neighbor list, no gathers, scatters or
sorts in the hot loop:

- Layout: per-component arrays of shape [Z, K(slots), C] (f32) where
  C = Y·X is the FUSED (row, cell) index: cell (z, y, x) owns column
  c = y·X + x with its K slots on dim 1. C is always a multiple of 128
  (n1 is a multiple of 8, n2 of 16). One margin cell rings the domain in
  every axis, which makes the fused-axis wraparound between consecutive
  rows inert (the wrapped-in cells are sentinel margins).
- Empty lanes hold a SENTINEL position (1e9) so every pair test
  (relu(h² − r²) etc.) rejects them arithmetically — no occupancy masks in
  the pair loop.
- Pair enumeration: the stencil offset (dy, dx) becomes ONE fused-axis
  shift dy·X + dx; dz shifts planes; the slot offset m ∈ [0, K) shifts
  dim 1. The XLA twin below realizes the shifts as whole-array rolls and
  is Newton-halved: each swept variant also emits the partner-side
  contribution (see the sweep-group comment below). The Triton kernels
  (ops/pallas/sweep.py) sweep the full stencil own-only. Shifts wrap into
  the margin ring, which is sentinel, so wraps are inert. cell_size ≥ h is
  required so ±1-cell stencils cover the kernel support.
- Rebinning: particles move ≤ 1 cell per rebin (the `rebin_vmax` clamp
  enforces it), so migration decomposes into one masked ≤3K→K compaction per
  axis (shift-major deterministic order). Cell overflow and unreachable
  targets are counted in `dropped`, never silent.

This replaces the reference's atomic linked-list grid + per-thread neighbor
walk (SimulateParticles.compute:196-300) with a formulation XLA can stream.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from sphsim.core.types import pytree_dataclass
from sphsim.sph import kernels as KN
from sphsim.sph.model import SPHParams, SPHState, eos_pressure, obstacle_accel

SENTINEL = 1.0e9


@dataclass(frozen=True)
class DenseSpec:
    """Static dense-grid geometry.

    Storage is [n0, k, n1·n2]: `axis_map` names the WORLD axis stored in
    each layout dim (dim 0 = planes, dim 1 = rows inside the fused axis,
    dim 2 = cells inside a row). 3D uses (x, y, z) so the fluid's sparse
    footprint (its x–y projection) lands on the axes the Triton kernels can
    skip; 2D uses (z=1, y, x).
    """

    n0: int            # layout dim 0 cells (incl. margins)
    n1: int            # layout dim 1 cells
    n2: int            # layout dim 2 cells (row length X)
    k: int             # slots per cell
    cell: float        # cell edge ≥ h
    origin: tuple[float, float, float]  # WORLD corner of cell (0,0,0)
    ndim: int
    axis_map: tuple[int, int, int] = (0, 1, 2)  # world axis per layout dim
    # Whether the stencil needs ±1 offsets along layout dims 0/1 (False when
    # the mapped world axis has a single real cell, e.g. z in 2D).
    stencil0: bool = True
    stencil1: bool = True

    @property
    def X(self) -> int:
        """Row length: fused-axis stride of one layout-dim-1 step."""
        return self.n2

    @property
    def C(self) -> int:
        """Fused minor-axis length (always a multiple of 128)."""
        return self.n1 * self.n2

    @property
    def lanes(self) -> int:
        return self.n2 * self.k

    @property
    def slots(self) -> int:
        return self.n0 * self.n1 * self.lanes

    def world_cells(self) -> tuple[int, int, int]:
        """Cell counts indexed by WORLD axis (x, y, z)."""
        dims = (self.n0, self.n1, self.n2)
        out = [1, 1, 1]
        for li, wa in enumerate(self.axis_map):
            out[wa] = dims[li]
        return tuple(out)


def make_dense_spec(params: SPHParams, k: int = 8,
                    cell_factor: float = 1.5) -> DenseSpec:
    cell = params.h * cell_factor
    lo, hi = params.bounds_min, params.bounds_max

    def ncells(a):
        extent = hi[a] - lo[a]
        return max(1, int(-(-extent // cell))) + 2  # +2 margin ring

    if params.ndim == 3:
        axis_map = (0, 1, 2)          # [X, Y, Z·K]
        wc = [ncells(0), ncells(1), ncells(2)]
        origin = (lo[0] - cell, lo[1] - cell, lo[2] - cell)
    else:
        # 2D: [Z(=1), Y, X·K] — a single plane; the y stencil rides the
        # row-blocked layout dim 1 and x·K rides lanes. (The earlier
        # [Y, Z(pad8), X·K] layout spent 7/8 of every plane on sentinel
        # rows — the row-blocked kernels made this shape viable.)
        axis_map = (2, 1, 0)
        wc = [ncells(0), ncells(1), 1]
        origin = (lo[0] - cell, lo[1] - cell, 0.0)

    n0 = wc[axis_map[0]]
    # n1 a multiple of 8 and n2 of 16 ⇒ the fused minor axis C = n1·n2 is
    # always a multiple of 128 (the kernels' lane block) — independent of k
    # (an earlier 128//k lane_mult only guaranteed this for k = 8).
    w1 = wc[axis_map[1]]
    n1 = -(-w1 // 8) * 8 if w1 <= 8 else -(-w1 // 32) * 32
    n2 = -(-wc[axis_map[2]] // 16) * 16
    spec = DenseSpec(
        n0=n0, n1=n1, n2=n2, k=k, cell=cell, origin=origin,
        ndim=params.ndim, axis_map=axis_map,
        stencil0=wc[axis_map[0]] > 1, stencil1=wc[axis_map[1]] > 1,
    )
    assert spec.C % 128 == 0, (spec.n1, spec.n2)
    return spec


@pytree_dataclass
class DenseFluidState:
    """SoA component arrays, each [Z, K, C=Y·X] f32."""

    px: jnp.ndarray
    py: jnp.ndarray
    pz: jnp.ndarray
    vx: jnp.ndarray
    vy: jnp.ndarray
    vz: jnp.ndarray
    occ: jnp.ndarray       # 1.0 where a particle lives
    rho: jnp.ndarray
    prs: jnp.ndarray
    dropped: jnp.ndarray   # i32: rebin overflow casualties (counted loudly)
    # i32: cumulative lane-count of rebin_vmax velocity-clamp hits. The clamp
    # keeps inter-rebin drift inside the stencil margin; a hit means the
    # physics was altered (the particle was speed-limited), so it is counted
    # as loudly as `dropped` — at the default cf=1.25/rebin=6, vmax ≈
    # 0.083·sound_speed, below the ~0.1c WCSPH envelope, and a persistent
    # non-zero count says to raise cell_factor or lower rebin_every.
    clamped: jnp.ndarray
    step_count: jnp.ndarray


def pack(state: SPHState, params: SPHParams, spec: DenseSpec) -> DenseFluidState:
    """Host-side packing of a flat particle state into the dense layout."""
    pos = np.asarray(state.pos)
    vel = np.asarray(state.vel)
    n = pos.shape[0]
    org = np.asarray(spec.origin, np.float32)
    wc = np.array(spec.world_cells())
    # Clip into the INTERIOR [1, wc-2] (margin cells must stay sentinel):
    # a wall-clamped particle at exactly bounds_max bins to wc-1 whenever
    # the domain extent is an f32-exact multiple of the cell, and a real
    # particle in a margin plane breaks the clamped-edge-fetch inertness
    # every kernel relies on (a clamped dz=±1 fetch would pair the margin
    # plane with itself, double-counting the self term — verified repro).
    lo = np.minimum(1, wc - 1)
    hi = np.maximum(wc - 2, lo)
    cc = np.clip(((pos - org) / spec.cell).astype(np.int64), lo, hi)
    # Layout coordinates per axis_map.
    i0 = cc[:, spec.axis_map[0]]
    i1 = cc[:, spec.axis_map[1]]
    i2 = cc[:, spec.axis_map[2]]
    shape = (spec.n0, spec.k, spec.C)
    px = np.full(shape, SENTINEL, np.float32)
    py = np.full(shape, SENTINEL, np.float32)
    pz = np.full(shape, SENTINEL, np.float32)
    vx = np.zeros(shape, np.float32)
    vy = np.zeros(shape, np.float32)
    vz = np.zeros(shape, np.float32)
    occ = np.zeros(shape, np.float32)

    # Vectorized fill: sort by cell id, rank within cell → slot.
    cid = (i0 * spec.n1 + i1) * spec.n2 + i2
    order = np.argsort(cid, kind="stable")
    cid_s = cid[order]
    starts = np.searchsorted(cid_s, cid_s)  # first index of own cell run
    rank = np.arange(n) - starts
    if (rank >= spec.k).any():
        raise ValueError(
            f"pack overflow: {(rank >= spec.k).sum()} particles exceeded "
            f"k={spec.k}; raise dense_k or cell_factor"
        )
    z = i0[order]
    c = i1[order] * spec.n2 + i2[order]
    ps, vs = pos[order], vel[order]
    px[z, rank, c], py[z, rank, c], pz[z, rank, c] = ps[:, 0], ps[:, 1], ps[:, 2]
    vx[z, rank, c], vy[z, rank, c], vz[z, rank, c] = vs[:, 0], vs[:, 1], vs[:, 2]
    occ[z, rank, c] = 1.0
    J = jnp.asarray
    return DenseFluidState(
        px=J(px), py=J(py), pz=J(pz), vx=J(vx), vy=J(vy), vz=J(vz),
        occ=J(occ),
        rho=jnp.full(shape, params.rest_density, jnp.float32),
        prs=jnp.zeros(shape, jnp.float32),
        dropped=jnp.int32(0),
        clamped=jnp.int32(0),
        step_count=jnp.int32(0),
    )


def unpack(dstate: DenseFluidState):
    """Flat (pos, vel, rho, prs, mask) views for tests / rendering / IO."""
    flat = lambda a: a.reshape(-1)  # noqa: E731
    mask = flat(dstate.occ) > 0.5
    pos = jnp.stack([flat(dstate.px), flat(dstate.py), flat(dstate.pz)], -1)
    vel = jnp.stack([flat(dstate.vx), flat(dstate.vy), flat(dstate.vz)], -1)
    return pos, vel, flat(dstate.rho), flat(dstate.prs), mask


# ---------------------------------------------------------------------------
# Newton-symmetric pair sweep on the FUSED [Z, K(slots), C=Y·X] layout
# (the XLA twin; the pair arithmetic below is shared with the Triton
# kernels in ops/pallas/sweep.py).
#
# The pair space factorizes into (dz planes, dy·X+dx fused-axis shift, m
# slot-offset); each shift is ONE whole-array roll.
#
# Newton halving (mirror of (dz,dy,dx,m) is (−dz,−dy,−dx,(K−m)%K)):
#   group A: (0,0,0), m ∈ [1, K/2]   — m=K/2 is its own mirror (own-only);
#            the m=0 self pair is peeled (density adds a constant).
#   group B: (0,0,+1), m ∈ [0,K)     — mirrors cover dx=−1; mirror targets
#            stay in-row, so they fold into the accumulator.
#   group C: (0,+1,dx∈{−1,0,+1})     — mirrors cover dy=−1 → m_row part.
#   group D: (+1,dy∈dysC,dx)         — mirrors cover dz=−1 → m_c[dy] parts.
# Mirror slot/in-row alignment is one slot roll and one fused-axis roll by
# dx per group (wrap-safe: the wrapped cells are sentinel margin columns);
# row/plane alignment happens in
# `combine_mirror_parts` (one whole-array roll per part: +X on the fused
# axis for rows, +1 on dim 0 for planes). Mirror sign: density +1
# (symmetric), accel −1 (Newton's third law).
# ---------------------------------------------------------------------------


def dys_c(spec: DenseSpec) -> tuple:
    """Group-D dy offsets (±1 only when layout dim 1 has a stencil)."""
    return (-1, 0, 1) if spec.stencil1 else (0,)


def density_self_term(params: SPHParams) -> float:
    """poly6 accumulator self term (h² − 0)³, evaluated in f32 with the same
    op order as the pair term t·t·t."""
    h2 = np.float32(params.h * params.h)
    return float(np.float32(np.float32(h2 * h2) * h2))


def density_pair_term(h2, cx, cy, cz, qx, qy, qz):
    """poly6 accumulator contribution of one candidate pair (pre-coeff)."""
    r2 = (cx - qx) ** 2 + (cy - qy) ** 2 + (cz - qz) ** 2
    t = jnp.maximum(h2 - r2, 0.0)
    return (t * t * t,)


def accel_pair_terms(h, neg_m_spiky, visc_mc,
                     cx, cy, cz, cvx, cvy, cvz, cirho, cpr2,
                     qx, qy, qz, qvx, qvy, qvz, qirho, qpr2):
    """Pressure + viscosity contribution of one candidate pair on the own
    side; the mirror (force on the partner) is the exact negation.

    Same symmetric p/ρ² spiky-gradient + viscosity-Laplacian model as the
    sorted/brute-force paths (model.py), with 1/ρ carried as a field so the
    inner loop is division-free except the 1/r of the unit direction."""
    dx = cx - qx
    dy = cy - qy
    dz = cz - qz
    r2 = dx * dx + dy * dy + dz * dz
    # One rsqrt replaces sqrt + divide (~1 ulp vs 1/sqrt). relu(h − r) rejects out-of-support and sentinel pairs;
    # r² > ε removes the self pair.
    rinv = jax.lax.rsqrt(jnp.maximum(r2, 1e-18))
    r = r2 * rinv
    not_self = (r2 > 1e-16).astype(jnp.float32)
    hr = jnp.maximum(h - r, 0.0)
    hrm = hr * not_self
    cp = (neg_m_spiky * hrm) * hr * rinv * (cpr2 + qpr2)
    cv = (visc_mc * hrm) * (cirho * qirho)
    tx = cp * dx + cv * (qvx - cvx)
    ty = cp * dy + cv * (qvy - cvy)
    tz = cp * dz + cv * (qvz - cvz)
    return tx, ty, tz


def combine_mirror_parts(own, m_row, m_cs, spec: DenseSpec, sign: int):
    """Fold the mirror part arrays into the own-side accumulator (fused
    [Z, K, C] layout).

    m_row holds group-C mirrors at OWN positions (destination = row+1, same
    plane → roll +X on the fused axis); m_cs[i] holds group-D mirrors for
    dy = dys_c(spec)[i] (destination = plane+1, row+dy → roll +1 on dim 0
    and +dy·X on the fused axis). Fused-axis wraps land on sentinel margin
    rows, whose mirror contributions are zero."""
    out = own
    X = spec.X

    def fold(acc, part):
        return acc + part if sign > 0 else acc - part

    if spec.stencil1:
        out = fold(out, jnp.roll(m_row, X, axis=2))
    if spec.stencil0:
        for dy, m in zip(dys_c(spec), m_cs):
            shifts = (1, dy * X) if dy else (1,)
            axes = (0, 2) if dy else (0,)
            out = fold(out, jnp.roll(m, shifts, axes))
    return out


def sweep_groups(spec: DenseSpec):
    """The Newton-halved variant groups: (dz, dy, dxs, ms, mirror_ms, dest)
    where dest is 'acc' (mirrors fold into the accumulator), 'row' (m_row
    part) or dy (m_c part index)."""
    K = spec.k
    assert K % 2 == 0, "dense_k must be even for the Newton slot split"
    allm = range(K)
    groups = [
        (0, 0, (0,), range(1, K // 2 + 1), range(1, K // 2), "acc"),
        (0, 0, (1,), allm, allm, "acc"),
    ]
    if spec.stencil1:
        groups.append((0, 1, (-1, 0, 1), allm, allm, "row"))
    if spec.stencil0:
        for dy in dys_c(spec):
            groups.append((1, dy, (-1, 0, 1), allm, allm, dy))
    return groups


def _sweep_xla(fields, pair_fn, ncomp, self_init, spec: DenseSpec,
               sign: int):
    """XLA twin of the Newton-symmetric fused sweep. Whole-array rolls
    ([Z, K, C]: plane, slot, fused dy·X+dx); per (group, dx) one mirror
    lump accumulated in slot order then slot+lane-derolled."""
    shape = fields[0].shape
    X = spec.X
    zeros = jnp.zeros(shape, jnp.float32)
    accs = [
        jnp.full(shape, self_init, jnp.float32)
        if (i == 0 and self_init is not None) else zeros
        for i in range(ncomp)
    ]

    m_row = [zeros] * ncomp if spec.stencil1 else None
    m_cs = [[zeros] * ncomp for _ in dys_c(spec)] if spec.stencil0 else []
    dy_index = {dy: i for i, dy in enumerate(dys_c(spec))}

    for dz, dy, dxs, ms, mirror_ms, dest in sweep_groups(spec):
        for dx in dxs:
            o = dy * X + dx
            lumps = [zeros] * ncomp
            for m in ms:
                qs = [
                    jnp.roll(f, (-dz, -m, -o), (0, 1, 2))
                    for f in fields
                ]
                ts = pair_fn(*fields, *qs)
                accs = [a + t for a, t in zip(accs, ts)]
                if m in mirror_ms:
                    lumps = [
                        lm + jnp.roll(t, (m, dx), (1, 2))
                        for lm, t in zip(lumps, ts)
                    ]
            if dest == "acc":
                accs = [
                    a + lm if sign > 0 else a - lm
                    for a, lm in zip(accs, lumps)
                ]
            elif dest == "row":
                m_row = [p + lm for p, lm in zip(m_row, lumps)]
            else:
                i = dy_index[dest]
                m_cs[i] = [p + lm for p, lm in zip(m_cs[i], lumps)]
    return accs, m_row, m_cs


def density_pass(d: DenseFluidState, params: SPHParams,
                 spec: DenseSpec) -> jnp.ndarray:
    """ρ over all lanes; empty lanes forced to rest density (keeps the EOS
    and force math NaN-free without masks)."""
    h2 = params.h * params.h
    accs, m_row, m_cs = _sweep_xla(
        (d.px, d.py, d.pz),
        lambda *a: density_pair_term(h2, *a),
        ncomp=1, self_init=density_self_term(params), spec=spec, sign=1,
    )
    acc = combine_mirror_parts(
        accs[0], m_row[0] if m_row else None,
        [m[0] for m in m_cs], spec, sign=1,
    )
    rho = params.particle_mass * KN.poly6_coeff(params.h, params.ndim) * acc
    return jnp.where(d.occ > 0.5, jnp.maximum(rho, 1e-6), params.rest_density)


def accel_pass(d: DenseFluidState, params: SPHParams, spec: DenseSpec):
    """Pressure + viscosity acceleration over all lanes (garbage in empty
    lanes; they are never integrated into real particles)."""
    m = params.particle_mass
    pr2 = d.prs / (d.rho * d.rho)     # empty lanes: 0 / rest² = 0
    irho = 1.0 / d.rho
    pair = lambda *a: accel_pair_terms(  # noqa: E731
        params.h,
        float(-m * KN.spiky_grad_coeff(params.h, params.ndim)),
        float(params.viscosity * m
              * KN.viscosity_lap_coeff(params.h, params.ndim)),
        *a,
    )
    fields = (d.px, d.py, d.pz, d.vx, d.vy, d.vz, irho, pr2)
    accs, m_row, m_cs = _sweep_xla(
        fields, pair, ncomp=3, self_init=None, spec=spec, sign=-1,
    )
    return tuple(
        combine_mirror_parts(
            accs[c], m_row[c] if m_row else None,
            [ms[c] for ms in m_cs], spec, sign=-1,
        )
        for c in range(3)
    )


def rebin_vmax(params: SPHParams, spec: DenseSpec) -> float:
    """Hard speed limit keeping every particle reachable by the staged rebin
    and covered by the stencil between rebins: with cadence R, drift must
    stay within min(1 cell reachability, (cell − h)/2 stencil margin)."""
    if params.rebin_every == 1:
        return spec.cell / params.dt
    return (spec.cell - params.h) * 0.5 / (params.rebin_every * params.dt)


def _integrate(d: DenseFluidState, ax, ay, az, params: SPHParams,
               vmax: float, drag=None):
    """Gravity/obstacles + optional interactive drag + symplectic Euler
    (velocity clamped to the rebin reachability budget BEFORE the position
    update) + box walls.

    Returns (px, py, pz, vx, vy, vz, n_clamped): n_clamped counts the lanes
    the vmax clamp actually limited — a loud fidelity diagnostic (the clamp
    alters physics when it fires; see DenseFluidState.clamped)."""
    dt = params.dt
    ay = ay - params.gravity
    if params.obstacles:
        pos = jnp.stack([d.px, d.py, d.pz], axis=-1)
        oa = obstacle_accel(pos, params)
        ax = ax + oa[..., 0]
        ay = ay + oa[..., 1]
        az = az + oa[..., 2]
    if drag is not None:
        # Space-anchored drag sphere (sph.model.FluidDrag): the reference's
        # per-particle impulse form (target − pos)·strength·dt/mass
        # (compute:311-324) applied to every lane inside the sphere.
        ddx = d.px - drag.center[0]
        ddy = d.py - drag.center[1]
        ddz = d.pz - drag.center[2]
        in_r = (
            (ddx * ddx + ddy * ddy + ddz * ddz < drag.radius * drag.radius)
            & (drag.strength > 0.0)
        ).astype(jnp.float32)
        g = in_r * (drag.strength / params.particle_mass)
        ax = ax + (drag.target[0] - d.px) * g
        ay = ay + (drag.target[1] - d.py) * g
        az = az + (drag.target[2] - d.pz) * g
    occ = d.occ > 0.5
    vx = jnp.where(occ, d.vx + ax * dt, 0.0)
    vy = jnp.where(occ, d.vy + ay * dt, 0.0)
    vz = jnp.where(occ, d.vz + az * dt, 0.0) if params.ndim == 3 else d.vz * 0
    speed = jnp.sqrt(vx * vx + vy * vy + vz * vz)
    scale = jnp.minimum(1.0, vmax / jnp.maximum(speed, 1e-12))
    n_clamped = jnp.sum(occ & (speed > vmax)).astype(jnp.int32)
    vx, vy, vz = vx * scale, vy * scale, vz * scale
    px = jnp.where(occ, d.px + vx * dt, d.px)
    py = jnp.where(occ, d.py + vy * dt, d.py)
    pz = jnp.where(occ, d.pz + vz * dt, d.pz)

    lo = params.bounds_min
    hi = params.bounds_max
    for axis, (p, v, lo_a, hi_a) in enumerate(
        [(px, vx, lo[0], hi[0]), (py, vy, lo[1], hi[1]), (pz, vz, lo[2], hi[2])]
    ):
        if axis == 2 and params.ndim == 2:
            continue
        hit = occ & ((p < lo_a) | (p > hi_a))
        p_new = jnp.clip(p, lo_a, hi_a)
        v_new = jnp.where(hit, -params.boundary_damping * v, v)
        if axis == 0:
            px, vx = jnp.where(occ, p_new, px), v_new
        elif axis == 1:
            py, vy = jnp.where(occ, p_new, py), v_new
        else:
            pz, vz = jnp.where(occ, p_new, pz), v_new
    return px, py, pz, vx, vy, vz, n_clamped


def _compact_stage(fields, occ, own_coord, target_fn, axis_roll,
                   spec: DenseSpec):
    """One axis pass of the staged rebin: candidates are the own cell plus
    its two axis-neighbors; a candidate wants this cell when its target
    coordinate along the axis equals the cell's. Compacts the ≤3K wanting
    candidates into K slots (deterministic shift-major order).

    fields: [Z, K, C, F]; axis_roll(a, step) rolls array `a` by `step`
    cells along the stage axis (±1 plane, ±X fused rows, ±1 fused cells);
    target_fn(rolled_fields, rolled_occ) recomputes the stage-axis target
    cell from the rolled positions. Returns (fields, occ, dropped).
    """
    Z, K, C = occ.shape

    cand_blocks, want_blocks = [], []
    for step in (-1, 0, 1):
        sf = axis_roll(fields, step)
        so = axis_roll(occ, step)
        st = target_fn(sf, so)
        wants = (st == own_coord) & (so > 0.5)
        cand_blocks.append(sf)
        want_blocks.append(wants)
    cand = jnp.concatenate(cand_blocks, axis=1)      # [Z, 3K, C, F]
    wants = jnp.concatenate(want_blocks, axis=1)     # [Z, 3K, C]

    rank = jnp.cumsum(wants.astype(jnp.int32), axis=1) - 1
    keep = wants & (rank < K)
    dropped = jnp.sum(wants & ~keep)
    # A particle whose target is > 1 cell away along this axis is claimed by
    # no cell in the sweep and would vanish silently: count it. (The
    # rebin_vmax clamp makes this impossible in normal operation.)
    tgt = target_fn(fields, occ)
    unreachable = (occ > 0.5) & (jnp.abs(tgt - own_coord) > 1)
    dropped = dropped + jnp.sum(unreachable)

    # Masked-sum compaction (K fused reductions — avoids the tiny batched
    # matmul the one-hot einsum lowers to).
    outs = []
    occ_outs = []
    for k in range(K):
        mk = (keep & (rank == k)).astype(jnp.float32)  # [Z, 3K, C]
        outs.append(jnp.sum(mk[..., None] * cand, axis=1))
        occ_outs.append(jnp.sum(mk, axis=1))
    packed = jnp.stack(outs, axis=1)                 # [Z, K, C, F]
    occ_new = jnp.stack(occ_outs, axis=1)
    return packed, occ_new, dropped


def rebin(d: DenseFluidState, px, py, pz, vx, vy, vz, params: SPHParams,
          spec: DenseSpec, dim0_offset=0, dim1_offset=0) -> DenseFluidState:
    """Move particles to their new home cells, one axis at a time (x, y, z).

    Per-step drift is ≤ 1 cell (the velocity clamp in dense_step enforces
    the rebin-cadence budget), so each axis stage moves a particle by at
    most one cell and the stages compose to the full move. Every stage is a
    ≤3K→K masked compaction — 9× less candidate traffic than a monolithic
    27-cell compaction. Overflow is counted, never silent.
    """
    Z, K, C = px.shape
    X = spec.X
    org = spec.origin
    wc = spec.world_cells()

    def coord_fn(world_axis):
        """Stage target: world cell coordinate of that axis, recomputed from
        the rolled positions (dead lanes → impossible cell)."""
        o = org[world_axis]
        n_cells = wc[world_axis]

        def fn(sf, so):
            if spec.ndim == 2 and world_axis == 2:
                c = jnp.zeros(so.shape, jnp.int32)
            else:
                p = sf[..., world_axis]
                # Interior clip [1, n-2]: margins stay sentinel (see pack).
                lo = min(1, n_cells - 1)
                hi = max(n_cells - 2, lo)
                c = jnp.clip(
                    ((p - o) / spec.cell).astype(jnp.int32), lo, hi
                )
            return jnp.where(so > 0.5, c, -9)

        return fn

    fields = jnp.stack([px, py, pz, vx, vy, vz], axis=-1)
    occ = d.occ
    iota_c = jax.lax.broadcasted_iota(jnp.int32, (1, 1, C), 2)
    own_2 = iota_c % X
    # dim0/dim1 indices are GLOBAL: sharded callers pass their slab/row-block
    # offsets so migration targets (world cell coords) compare correctly.
    own_1 = dim1_offset + iota_c // X
    own_0 = dim0_offset + jax.lax.broadcasted_iota(jnp.int32, (Z, 1, 1), 0)

    def roll_c(step_cells):
        def f(a, s):
            return jnp.roll(a, -s * step_cells, axis=2) if s else a
        return f

    dropped = jnp.int32(0)
    stages = [
        (own_2, coord_fn(spec.axis_map[2]), roll_c(1)),    # in-row cells
    ]
    if spec.stencil1:
        stages.append((own_1, coord_fn(spec.axis_map[1]), roll_c(X)))
    if spec.stencil0:
        stages.append((
            own_0, coord_fn(spec.axis_map[0]),
            lambda a, s: jnp.roll(a, -s, axis=0) if s else a,  # planes
        ))
    for own_coord, target_fn, axis_roll in stages:
        fields, occ, drp = _compact_stage(
            fields, occ, own_coord, target_fn, axis_roll, spec
        )
        dropped = dropped + drp

    empty = occ < 0.5

    def comp(i, sentinel):
        return jnp.where(empty, sentinel, fields[..., i])

    return DenseFluidState(
        px=comp(0, SENTINEL), py=comp(1, SENTINEL), pz=comp(2, SENTINEL),
        vx=comp(3, 0.0), vy=comp(4, 0.0), vz=comp(5, 0.0),
        occ=jnp.where(empty, 0.0, 1.0),
        rho=d.rho, prs=d.prs,
        dropped=d.dropped + dropped.astype(jnp.int32),
        clamped=d.clamped,
        step_count=d.step_count,
    )


def pair_density(d: DenseFluidState, params: SPHParams,
                 spec: DenseSpec) -> jnp.ndarray:
    """ρ over all lanes (empty lanes at rest density) through the Triton
    kernel or the XLA twin, as params.use_pallas resolves
    (ops.pallas.sweep.kernel_mode)."""
    from sphsim.ops.pallas.sweep import density_pallas, kernel_mode

    mode = kernel_mode(params.use_pallas)
    if mode is None:
        return density_pass(d, params, spec)
    rho = density_pallas(d.px, d.py, d.pz, params, spec,
                         interpret=mode == "interpret")
    return jnp.where(d.occ > 0.5, jnp.maximum(rho, 1e-6),
                     params.rest_density)


def pair_accel(d: DenseFluidState, params: SPHParams, spec: DenseSpec):
    """Pressure + viscosity acceleration (kernel or twin, as
    pair_density)."""
    from sphsim.ops.pallas.sweep import accel_pallas, kernel_mode

    mode = kernel_mode(params.use_pallas)
    if mode is None:
        return accel_pass(d, params, spec)
    return accel_pallas(d, d.prs / (d.rho * d.rho), params, spec,
                        interpret=mode == "interpret")


def dense_step(d: DenseFluidState, params: SPHParams,
               spec: DenseSpec, drag=None):
    """One WCSPH step on the dense layout: density → EOS → forces →
    integrate (incl. optional interactive drag) → rebin (every
    `rebin_every` steps, with a velocity clamp keeping inter-rebin drift
    inside the stencil margin)."""
    rho = pair_density(d, params, spec)
    prs = jnp.where(d.occ > 0.5, eos_pressure(rho, params), 0.0)
    d = d.replace_fields(rho=rho, prs=prs)
    ax, ay, az = pair_accel(d, params, spec)

    px, py, pz, vx, vy, vz, n_clamped = _integrate(
        d, ax, ay, az, params, rebin_vmax(params, spec), drag=drag
    )

    def do_rebin(args):
        return rebin(d, *args, params, spec)

    def no_rebin(args):
        px, py, pz, vx, vy, vz = args
        return d.replace_fields(px=px, py=py, pz=pz, vx=vx, vy=vy, vz=vz)

    if params.rebin_every == 1:
        d = do_rebin((px, py, pz, vx, vy, vz))
    else:
        d = jax.lax.cond(
            d.step_count % params.rebin_every == params.rebin_every - 1,
            do_rebin, no_rebin, (px, py, pz, vx, vy, vz),
        )
    return d.replace_fields(
        step_count=d.step_count + 1, clamped=d.clamped + n_clamped
    )


_DENSE_CACHE: dict = {}


def _check_rebin_cadence(params: SPHParams, spec: DenseSpec):
    if params.rebin_every > 1 and spec.cell <= params.h * 1.01:
        raise ValueError(
            "rebin_every > 1 needs cell_factor > 1 (stencil drift margin is "
            f"(cell - h)/2 = {(spec.cell - params.h) / 2:.2e})"
        )


def make_dense_step(params: SPHParams, spec: DenseSpec, substeps: int = 1,
                    donate: bool = True, with_drag: bool = False):
    """Jitted (state[, drag]) -> state. with_drag=True adds a traced
    FluidDrag argument (interactive viewer path) — pass FluidDrag.none()
    when idle; the strength gate makes it inert."""
    _check_rebin_cadence(params, spec)
    key = (params, spec, substeps, donate, with_drag)
    if key not in _DENSE_CACHE:
        def f(st, drag=None):
            if substeps == 1:
                return dense_step(st, params, spec, drag=drag)
            return jax.lax.scan(
                lambda s, _: (dense_step(s, params, spec, drag=drag), None),
                st, None, length=substeps,
            )[0]
        if with_drag:
            fn = jax.jit(f, donate_argnums=(0,) if donate else ())
        else:
            fn = jax.jit(
                lambda st: f(st), donate_argnums=(0,) if donate else ()
            )
        _DENSE_CACHE[key] = fn
    return _DENSE_CACHE[key]
