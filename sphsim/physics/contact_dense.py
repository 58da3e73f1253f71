"""Contact forces on the colony-specced dense [Z, Y, X·K] layout — the
colony's fast contact path (neighbor_mode="dense").

- Layout [Z(cells), Y(cells), X·K(lanes)]: a cell's K slots sit next to
  each other on the minor axis, so ANY k keeps the minor axis dense; the
  y stencil is a row offset, the z stencil a plane offset, and (dx, slot)
  collapse into one lane offset o = dx·K + dm.
- FULL-stencil own-only sweep (no Newton halving): every lane accumulates
  its own force AND its own torque (own contact arm, compute:282-294)
  directly — 6 outputs, no mirror folding.
- Lane offsets o ∈ ±[1, 2K−1] cover every (dx ∈ {−1,0,1}, dm) partner;
  offsets that spill into dx = ±2 cells self-reject arithmetically
  (cell ≥ contact reach ⇒ their distance ≥ reach ⇒ overlap ≤ 0 < ε).
  Sentinel margins make every wrap (lane, row, plane) inert.

The flat SimState stays the source of truth — division, adhesion and
rendering index slots — and packing happens PER CALL, all inside jit: cell
id → sort → rank → one scatter in, one gather out. The sweep is the Triton
kernel (ops/pallas/sweep.py) or the XLA twin below (params.use_pallas).
Pair math: same model as physics.contact.pair_contact (re-specification of
SimulateParticles.compute:211-309).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp

from sphsim.core.types import SimParams, SimState
from sphsim.sph.dense import SENTINEL


@dataclass(frozen=True)
class ContactSpec:
    """Static colony-grid geometry for the [Z, Y, X·K] layout.

    nz/ny/nx count cells INCLUDING the one-cell sentinel margin ring;
    ny is padded to a multiple of 8 and nx to make
    L = nx·k a multiple of 128 (full lanes) — pad cells are sentinel.
    """

    nz: int
    ny: int
    nx: int            # real cells along x (incl. margins)
    nx_pad: int        # padded row length in cells
    k: int             # slots per cell
    cell: float        # cell edge ≥ contact reach (max_radius)
    origin: tuple[float, float, float]  # world corner of cell (0,0,0)

    @property
    def L(self) -> int:
        """Lane-axis length: nx_pad cells × k slots."""
        return self.nx_pad * self.k

    @property
    def slots(self) -> int:
        return self.nz * self.ny * self.L

    def shape(self) -> tuple[int, int, int]:
        return (self.nz, self.ny, self.L)


def make_contact_spec(params: SimParams, k: int = 2,
                      cell_factor: float = 1.05) -> ContactSpec:
    """Colony-grid geometry. Interaction reach is eff_i + eff_j ≤
    max_radius (contact radii are half the visual radius, compute:225), so
    cell ≥ max_radius makes the ±1 stencil complete. Domain: the spawn
    sphere [-R, R]³ plus the margin ring (reference grid precedent:
    SimulateParticles.compute:16-18, 102-105)."""
    cell = float(params.max_radius) * cell_factor
    r = float(params.spawn_radius)
    n = max(1, int(-(-2.0 * r // cell))) + 2    # + margin ring
    origin = (-r - cell, -r - cell, -r - cell)

    ny = -(-n // 8) * 8
    lane_q = 128 // _gcd(k, 128)        # nx_pad multiple ⇒ L % 128 == 0
    nx_pad = -(-n // lane_q) * lane_q
    return ContactSpec(nz=n, ny=ny, nx=n, nx_pad=nx_pad, k=k, cell=cell,
                       origin=origin)


def _gcd(a: int, b: int) -> int:
    import math

    return math.gcd(a, b)


def contact_variants(spec: ContactSpec):
    """The full-stencil variant list [(dz, dy, o)]: lane offsets
    o ∈ ±[1, 2K−1] plus o = 0 for off-cell (dz, dy); the (0,0,0) self pair
    is excluded. Shared by the XLA twin and the Triton kernel — SAME ORDER,
    so the per-lane accumulation order is identical by construction."""
    K = spec.k
    out = []
    for o in range(-(2 * K - 1), 2 * K):
        for dz in (-1, 0, 1):
            for dy in (-1, 0, 1):
                if o == 0 and dz == 0 and dy == 0:
                    continue
                out.append((dz, dy, o))
    return out


def contact_pair_terms(params: SimParams,
                       cx, cy, cz, cvx, cvy, cvz, cox, coy, coz, crad,
                       qx, qy, qz, qvx, qvy, qvz, qox, qoy, qoz, qrad):
    """One candidate pair's own-side (force[3], torque[3]) — 6 components.

    Same model as physics.contact.pair_contact (compute:211-309): overlap
    repulsion with falloff², rolling-friction torque from relative surface
    velocity, own contact arm eff_i (compute:282-284 uses each side's OWN
    radius — the full-stencil sweep computes each side independently, so no
    explicit partner-torque mirror is needed). Sentinel partners self-reject
    via the overlap test."""
    eff_i = crad * 0.5
    eff_j = qrad * 0.5
    dx = cx - qx
    dy = cy - qy
    dz = cz - qz
    r2 = dx * dx + dy * dy + dz * dz
    rinv = jax.lax.rsqrt(jnp.maximum(r2, 1e-24))
    dist = r2 * rinv
    sum_r = eff_i + eff_j
    overlap = sum_r - dist
    in_contact = (overlap > params.contact_epsilon).astype(jnp.float32)

    ux, uy, uz = dx * rinv, dy * rinv, dz * rinv
    inv_sum = 1.0 / jnp.maximum(sum_r, 1e-12)
    overlap_falloff = jnp.clip(overlap * inv_sum, 0.0, 1.0)
    falloff = jnp.clip(1.0 - dist * inv_sum, 0.0, 1.0)
    fmag = falloff * params.repulsion_strength * overlap_falloff * in_contact
    fx, fy, fz = ux * fmag, uy * fmag, uz * fmag

    # Relative surface velocity incl. ω×arm terms (compute:263-273).
    # arm_i = -u·eff_i (own side), arm_j = +u·eff_j.
    sivx = cvx + (coy * (-uz * eff_i) - coz * (-uy * eff_i))
    sivy = cvy + (coz * (-ux * eff_i) - cox * (-uz * eff_i))
    sivz = cvz + (cox * (-uy * eff_i) - coy * (-ux * eff_i))
    sjvx = qvx + (qoy * (uz * eff_j) - qoz * (uy * eff_j))
    sjvy = qvy + (qoz * (ux * eff_j) - qox * (uz * eff_j))
    sjvz = qvz + (qox * (uy * eff_j) - qoy * (ux * eff_j))
    rvx, rvy, rvz = sivx - sjvx, sivy - sjvy, sivz - sjvz
    rn = rvx * ux + rvy * uy + rvz * uz
    tx, ty, tz = rvx - ux * rn, rvy - uy * rn, rvz - uz * rn
    slip2 = tx * tx + ty * ty + tz * tz
    # Guard must be a NORMAL f32: a device that flushes denormals would
    # turn a 1e-40 floor into rsqrt(0)=inf and no-slip lanes into
    # 0·inf = NaN (CPU never flushes).
    slip_inv = jax.lax.rsqrt(jnp.maximum(slip2, 1e-30))
    slip = slip2 * slip_inv
    slipping = in_contact * (slip > params.slip_epsilon).astype(jnp.float32)

    torque_input = jnp.abs(slip * params.torque_factor)
    # x^1.25 as x·sqrt(sqrt(x)): lax.pow lowers to exp(1.25·log x) — two
    # transcendentals per lane per swept variant. The sqrt chain is exact at 0 and agrees to
    # ≤2 ulp. physics/contact.py uses the SAME form (twin contract).
    friction_mag = jnp.minimum(
        torque_input * jnp.sqrt(jnp.sqrt(torque_input)), 10.0
    )

    # τ_own = cross(u, f̂·mag)·falloff²·mult·eff_i (compute:282-294).
    scale = (
        overlap_falloff * overlap_falloff
        * params.rolling_contact_radius_multiplier
        * friction_mag * slip_inv * slipping * eff_i
    )
    bx = (uy * tz - uz * ty) * scale
    by = (uz * tx - ux * tz) * scale
    bz = (ux * ty - uy * tx) * scale
    return fx, fy, fz, bx, by, bz


# Fill value per packed field (px, py, pz, vx, vy, vz, ox, oy, oz, rad).
# Empty/pad slots hold these so pair terms
# self-reject arithmetically. parallel/dist.py pads its halo/alignment
# planes with the SAME values — they must stay byte-identical to the
# scatter fills below or pad planes stop being inert.
#
# The sentinel RADIUS is large-negative (not 1.0): two sentinel lanes sit
# at the same position (dist 0), so a positive fill radius would give them
# overlap > ε — harmless for the outputs (their pair direction is 0, every
# term an exact ±0) but it would defeat the Triton kernel's per-variant
# contact prescreen (contact_screen below), which must see NO possible
# contact in a settled block. The kernel also reads these values for
# partner lanes outside the array. −1e3 dominates any real effective radius, so
# every sentinel pairing screens (and gates) negative.
FIELD_FILLS = (SENTINEL, SENTINEL, SENTINEL,
               0.0, 0.0, 0.0, 0.0, 0.0, 0.0, -1.0e3)


def contact_screen(params: SimParams, cx, cy, cz, crad, qx, qy, qz, qrad):
    """Variant prescreen: per-lane contact MARGIN (overlap −
    contact_epsilon, same overlap arithmetic as contact_pair_terms) for one
    stencil offset. The Triton kernel max-accumulates this over all
    variants (~13 ops/lane/variant, no branches) and gates the ENTIRE full
    pair sweep of a block on one scalar `max > 0` test.

    A settled colony sits at the adhesion rest length (2.96 > contact reach
    2.0 in the reference genome, config.py), so almost no tile has a
    touching pair at any offset — the sweep then costs only this screen.
    Skipping is bitwise-invisible: every pair term of a no-contact pair is
    an exact ±0 (fmag and the torque scale both carry the
    in_contact/slipping zero factor), and the accumulators never hold −0.0
    (they start at +0.0 and (+x)+(−x) rounds to +0.0), so skipping the adds
    keeps the twin's bits. Sentinel lanes screen negative via the −1e3
    radius fill (FIELD_FILLS above)."""
    dx = cx - qx
    dy = cy - qy
    dz = cz - qz
    r2 = dx * dx + dy * dy + dz * dz
    rinv = jax.lax.rsqrt(jnp.maximum(r2, 1e-24))
    dist = r2 * rinv
    overlap = crad * 0.5 + qrad * 0.5 - dist
    return overlap - params.contact_epsilon


def gather_back(comps_flat, slot_of, overflow):
    """ONE row-gather of the stacked per-slot sweep components back to
    particle order (one [slots, 6] table instead of 6 gathers). Shared by the single-device path and both sharded builders
    (parallel/dist.py). Returns (force [N,3], torque [N,3], overflow)."""
    table = jnp.stack(comps_flat, axis=-1)        # [slots, 6]
    idx = jnp.minimum(slot_of, table.shape[0] - 1)
    valid = (slot_of < table.shape[0])[:, None].astype(jnp.float32)
    ft = table[idx] * valid                       # [N, 6]
    return ft[:, :3], ft[:, 3:], overflow


def _cell_ids(state: SimState, spec: ContactSpec):
    """Per-particle cell id (dead rows get the past-the-end sentinel
    nz·ny·nx_pad, so `cid < sentinel` ⟺ alive after any reorder).

    Cell coords are clipped into the INTERIOR [1, dim-2]: the margin ring
    must stay sentinel-only. Out-of-domain particles (e.g. division
    children placed past the spawn sphere before update_motion's boundary
    clamp runs, cs:753-754 offset + compute:339-354 clamp ordering) bin
    into the nearest interior edge cell — the reference precedent is the
    edge-cell clamp at compute:104. A real particle in a margin plane
    would break every engine's edge handling differently: the Triton
    kernel masks planes outside the array, the XLA twin rolls to the far
    margin, and the sharded rings wrap to a neighbor's sentinel halo."""
    N = state.capacity
    alive = jnp.arange(N) < state.active_count
    org = jnp.asarray(spec.origin, jnp.float32)
    dims = jnp.asarray((spec.nx, spec.ny, spec.nz), jnp.int32)
    cc = jnp.clip(((state.pos - org) / spec.cell).astype(jnp.int32),
                  1, dims - 2)
    ix, iy, iz = cc[:, 0], cc[:, 1], cc[:, 2]
    cid = (iz * spec.ny + iy) * spec.nx_pad + ix
    return jnp.where(alive, cid,
                     jnp.int32(spec.nz * spec.ny * spec.nx_pad))


def _rank_and_slots(cid_s, order, spec: ContactSpec):
    """Post-sort bookkeeping on the SORTED cell ids: within-cell rank (via
    cummax of run starts, no binary-search gathers), fits mask, counted
    overflow, flat slot targets (drop bucket = spec.slots) and the
    particle-order slot_of."""
    N = cid_s.shape[0]
    K = spec.k
    slots = spec.slots
    alive_s = cid_s < jnp.int32(spec.nz * spec.ny * spec.nx_pad)
    i = jnp.arange(N)
    is_start = jnp.concatenate(
        [jnp.ones(1, bool), cid_s[1:] != cid_s[:-1]]
    )
    starts = jax.lax.cummax(jnp.where(is_start, i, 0))
    rank = i - starts
    fits = alive_s & (rank < K)
    overflow = jnp.sum(alive_s & ~fits)

    flat = cid_s * K + rank                       # == (z·ny+y)·L + x·K + m
    flat = jnp.where(fits, flat, slots)

    # slot_of_particle: flat dense slot per original index (slots = dropped).
    slot_of = jnp.full(N, slots, jnp.int32).at[order].set(
        flat.astype(jnp.int32)
    )
    return flat, fits, overflow, slot_of


def _sort_with_payload(state: SimState, spec: ContactSpec):
    """The pack sort CARRYING the 10 field columns through the sort network
    (one stable lax.sort keyed on the cell id) instead of an argsort
    followed by a wide row gather. Returns (cols 10×[N] in SORTED order,
    flat, fits, overflow, slot_of)."""
    N = state.capacity
    cid = _cell_ids(state, spec)
    out = jax.lax.sort(
        [cid, jnp.arange(N, dtype=jnp.int32),
         state.pos[:, 0], state.pos[:, 1], state.pos[:, 2],
         state.vel[:, 0], state.vel[:, 1], state.vel[:, 2],
         state.ang_vel[:, 0], state.ang_vel[:, 1], state.ang_vel[:, 2],
         state.radius],
        num_keys=1, is_stable=True,
    )
    cid_s, order = out[0], out[1]
    flat, fits, overflow, slot_of = _rank_and_slots(cid_s, order, spec)
    return list(out[2:]), flat, fits, overflow, slot_of


def _scatter_sorted(cols, fills, flat, fits, spec: ContactSpec):
    """Column scatters of ALREADY-SORTED columns into planar [Z, Y, L]
    arrays. The targets are unique and ascending."""
    slots = spec.slots

    def scatter(c):
        fill = fills[c]
        out = jnp.full(slots + 1, fill, jnp.float32).at[flat].set(
            jnp.where(fits, cols[c], fill)
        )
        return out[:slots].reshape(spec.shape())

    return [scatter(c) for c in range(len(cols))]


def _pack_args(state: SimState, spec: ContactSpec):
    """In-jit pack: (fields [10][Z,Y,L], slot_of_particle, overflow)."""
    cols, flat, fits, overflow, slot_of = _sort_with_payload(state, spec)
    fields = tuple(_scatter_sorted(cols, FIELD_FILLS, flat, fits, spec))
    return fields, slot_of, overflow


def _sweep_xla(fields, pair_fn, ncomp: int, spec: ContactSpec):
    """XLA twin of the full-stencil own-only sweep: a lax.scan over the
    contact_variants list (one variant per iteration, traced shifts), in
    exactly the Triton kernel's (o → dz → dy) order so the per-lane
    accumulation order is identical by construction.

    The scan (rather than an unrolled loop) is deliberate: the unrolled
    ~60-variant roll graph took XLA:CPU 18 MINUTES to compile; the
    one-variant body compiles in seconds."""
    shape = fields[0].shape
    F = jnp.stack(fields)                                 # [nf, Z, Y, L]
    variants = jnp.asarray(contact_variants(spec), jnp.int32)
    zeros = [jnp.zeros(shape, jnp.float32) for _ in range(ncomp)]

    def body(accs, v):
        q = jnp.roll(F, (-v[0], -v[1], -v[2]), (1, 2, 3))
        ts = pair_fn(*fields, *[q[i] for i in range(len(fields))])
        return [a + t for a, t in zip(accs, ts)], None

    accs, _ = jax.lax.scan(body, zeros, variants)
    return accs


def contact_forces_dense(state: SimState, params: SimParams,
                         spec: ContactSpec | None = None):
    """Drop-in alternative to ops.grid.contact_forces_grid: per-particle
    (force [N,3], torque [N,3], overflow) via the dense full-stencil sweep.

    Same physics as contact_forces_bruteforce to float re-association
    tolerance (the dense sweep's pair order differs). Particles that
    overflow their cell's K slots exert/receive no contact force this step;
    the count is returned loudly (policy matches the grid path's counted
    bin overflow)."""
    if spec is None:
        spec = make_contact_spec(
            params, k=params.dense_k, cell_factor=params.dense_cell_factor
        )
    fields, slot_of, overflow = _pack_args(state, spec)
    comps = contact_sweep(fields, params, spec)
    return gather_back(
        [c.reshape(-1) for c in comps], slot_of, overflow
    )


def contact_sweep(fields, params: SimParams, spec: ContactSpec):
    """The 6-component (force, torque) sweep over packed [Z, Y, L] fields:
    the Triton kernel or the XLA twin, as params.use_pallas resolves
    (ops.pallas.sweep.kernel_mode). Shared by the single-device path and
    the sharded builders (parallel/dist.py)."""
    from sphsim.ops.pallas.sweep import contact_sweep_pallas, kernel_mode

    pair = lambda *a: contact_pair_terms(params, *a)  # noqa: E731
    mode = kernel_mode(params.use_pallas)
    if mode is None:
        return _sweep_xla(fields, pair, ncomp=6, spec=spec)
    screen = lambda *a: contact_screen(params, *a)  # noqa: E731
    return contact_sweep_pallas(
        fields, spec, pair, FIELD_FILLS, ncomp=6, screen_fn=screen,
        interpret=mode == "interpret",
    )
