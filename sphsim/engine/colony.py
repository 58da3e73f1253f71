"""Prebuilt bonded-colony scenes for the biology regime.

A grown reference colony is cells packed at the genome's adhesion rest
length, every cell bonded to its neighbors (each division creates an A↔B
bond, CellAdhesionManager.cs:504-509, and inheritance keeps the colony
connected). Growing one by running divisions takes minutes at bench scale,
so this builds the equivalent steady state directly: a jittered
simple-cubic lattice at the rest length, carved to a ball, with a bond per
lattice-neighbor pair — honest zone classification (so FilterBonds prunes
exactly as it would in a grown colony) and anchors at the surface point
along the bond (radius 1.0, CAM:377-402).

Used by bench.py's colony rungs and the biology-regime tests.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from sphsim.core.types import (
    BondTable,
    Genome,
    SimParams,
    SimState,
)
from sphsim.engine.config import reference_genome, reference_scene_params

ZONE_A, ZONE_B, ZONE_C = 0, 1, 2


def _lattice_ball(n: int, spacing: float, jitter: float, rng: np.random.Generator):
    """n points of a jittered simple-cubic lattice, nearest-to-center first.

    jitter < (spacing − cell)/2 of the contact grid keeps per-axis neighbor
    separation ≥ spacing − 2·jitter, which bounds cell occupancy (see
    bench.py's colony rung for the k=2 argument)."""
    m = int(np.ceil((3 * n / (4 * np.pi)) ** (1 / 3))) + 2
    ax = np.arange(-m, m + 1)
    gx, gy, gz = np.meshgrid(ax, ax, ax, indexing="ij")
    pts = np.stack([gx, gy, gz], -1).reshape(-1, 3).astype(np.float64)
    d2 = np.sum(pts * pts, -1)
    order = np.argsort(d2, kind="stable")
    pts = pts[order[:n]] * spacing
    pts = pts + rng.uniform(-jitter, jitter, pts.shape)
    return pts.astype(np.float32)


def _neighbor_bonds(pos: np.ndarray, spacing: float):
    """Index pairs (i, j) for +axis lattice neighbors (≤ 3 per cell), in
    (axis, i) order."""
    key = np.round(pos / spacing).astype(np.int64)
    key -= key.min(axis=0) - 1
    m = int(key.max()) + 2
    code = (key[:, 0] * m + key[:, 1]) * m + key[:, 2]
    order = np.argsort(code, kind="stable")
    sorted_code = code[order]
    idx = np.arange(len(pos))
    pairs = []
    for step in (m * m, m, 1):           # +x, +y, +z neighbor codes
        want = code + step
        at = np.minimum(np.searchsorted(sorted_code, want), len(pos) - 1)
        hit = sorted_code[at] == want
        pairs.append(np.stack([idx[hit], order[at[hit]]], axis=-1))
    return np.concatenate(pairs).astype(np.int32).reshape(-1, 2)


def _steady_state_prune(pairs, pos, zone_a, zone_b):
    """Host-side FilterBonds fixed point (CAM:184-243 semantics): among
    same-zone bonds sharing an endpoint, only the shortest survives (bonds
    spanning ZoneC↔ZoneA/B are exempt). Seeding the pruned set directly
    keeps the device bond table at its grown-colony steady-state size
    instead of 2× oversized for one step of on-device pruning — the
    adhesion and pruning passes are gather-bound, so table CAPACITY is
    what they cost."""
    B = len(pairs)
    if B == 0:
        return pairs
    ia, ib = pairs[:, 0], pairs[:, 1]
    # f32 like the device (tie structure must match filter_bonds).
    dist = np.linalg.norm(
        (pos[ib] - pos[ia]).astype(np.float32), axis=-1
    ).astype(np.float32)
    mixed = (zone_a == ZONE_C) != (zone_b == ZONE_C)
    # Per-SIDE key spaces, as the reference groups (CAM:192 by (cellA,
    # zoneA) over A-ends; CAM:216 by (cellB, zoneB) over B-ends,
    # independently) — exactly filter_bonds' disjoint key_a/key_b ranges.
    off = 3 * np.int64(len(pos))
    keys = np.concatenate(
        [ia.astype(np.int64) * 3 + zone_a,
         off + ib.astype(np.int64) * 3 + zone_b]
    )
    d2 = np.concatenate([dist, dist])
    idx2 = np.concatenate([np.arange(B), np.arange(B)])
    m2 = np.concatenate([mixed, mixed])
    gmix = np.zeros(int(keys.max()) + 1, bool)
    np.logical_or.at(gmix, keys, m2)
    order = np.lexsort((idx2, d2, keys))   # key, then dist, ties lowest idx
    ks = keys[order]
    first = np.r_[True, ks[1:] != ks[:-1]]
    rm2 = np.zeros(2 * B, bool)
    rm2[order] = ~first & ~gmix[ks]
    rm = rm2[:B] | rm2[B:]
    return pairs[~rm]


def _classify(dirs: np.ndarray, angle_deg: float = 10.0) -> np.ndarray:
    """Zone per bond END given the bond direction in the cell's local frame
    (identity rotations; the reference genome's split dir is +z):
    ClassifyBondDirection, CAM:320-336."""
    dot = np.clip(dirs[:, 2], -1.0, 1.0)
    ang = np.degrees(np.arccos(dot))
    zone = np.where(dot > 0, ZONE_B, ZONE_A)
    return np.where(np.abs(ang - 90.0) <= angle_deg, ZONE_C, zone).astype(
        np.int32
    )


def bonded_colony(
    n: int,
    genome: Genome | None = None,
    jitter: float = 0.35,
    seed: int = 0,
    **param_overrides,
) -> tuple[SimState, SimParams, Genome]:
    """A settled n-cell bonded colony + its scene params.

    Cells sit on a jittered lattice at the genome's adhesion rest length
    (so springs are loaded but contacts only fire transiently — exactly the
    reference's steady state, where rest length 2.96 > contact reach 2.0).
    Roughly 3n bonds are seeded; FilterBonds prunes same-zone duplicates to
    the grown-colony steady state within a step or two.
    """
    genome = genome or reference_genome()
    mode0 = genome.modes[0]
    spacing = float(mode0.adhesion_rest_length)
    rng = np.random.default_rng(seed)

    # The lattice + neighbor-pair + prune-fixed-point construction is pure
    # host numpy/Python (the dict walk in _neighbor_bonds is ~minutes at
    # 1M), so memoize (pos, pairs) on disk keyed by its exact inputs. On a
    # hit the rng is burned identically to the miss path so every later
    # draw (drag) matches bit-for-bit.
    import pathlib

    cache = (pathlib.Path(__file__).resolve().parents[2] / ".cache"
             / f"colony_v1_n{n}_s{spacing!r}_j{jitter!r}_seed{seed}.npz")
    if cache.exists():
        with np.load(cache) as z:
            pos, pairs = z["pos"], z["pairs"]
        rng.uniform(-jitter, jitter, (n, 3))     # burn the jitter draw
    else:
        pos = _lattice_ball(n, spacing, jitter, rng)
        pairs = _neighbor_bonds(pos, spacing)
        # Iterate to FilterBonds' fixed point (removals can cascade:
        # pruning a group's min from its other endpoint exposes a new min
        # next pass) so the device table is seeded at its true steady-state
        # size — the adhesion/pruning passes cost table CAPACITY.
        while True:
            ia, ib = pairs[:, 0], pairs[:, 1]
            d0 = pos[ib] - pos[ia]
            d0 = d0 / np.maximum(
                np.linalg.norm(d0, axis=-1, keepdims=True), 1e-12
            )
            kept = _steady_state_prune(
                pairs, pos, _classify(d0), _classify(-d0)
            )
            if len(kept) == len(pairs):
                break
            pairs = kept
        try:
            cache.parent.mkdir(exist_ok=True)
            np.savez_compressed(cache, pos=pos, pairs=pairs)
        except OSError:
            pass
    R = float(np.linalg.norm(pos, axis=-1).max())
    nb = len(pairs)
    max_bonds = param_overrides.pop("max_bonds", None)
    if max_bonds is None:
        # Snug capacity (next multiple of 8192, ≥ 5% headroom): the adhesion
        # and pruning passes are gather-bound, so table CAPACITY is what
        # they cost — a power-of-two round-up can nearly double it.
        max_bonds = -(-int(nb * 1.05 + 64) // 8192) * 8192
    param_overrides.setdefault("neighbor_mode", "dense")
    params = reference_scene_params(
        capacity=n,
        spawn_radius=R + 2.0 * spacing,
        max_bonds=max_bonds,
        **param_overrides,
    )

    state = SimState.zeros(n, params, seed=seed)
    radius = np.full(n, params.max_radius, np.float32)
    volume = (4.0 / 3.0) * np.pi * radius ** 3
    mass = params.density * volume
    inertia = 0.4 * mass * radius ** 2

    ia, ib = pairs[:, 0], pairs[:, 1]
    delta = pos[ib] - pos[ia]
    dirs = delta / np.maximum(
        np.linalg.norm(delta, axis=-1, keepdims=True), 1e-12
    )
    B = max_bonds
    pad = lambda a, fill, dt: np.concatenate(  # noqa: E731
        [a.astype(dt), np.full((B - nb, *a.shape[1:]), fill, dt)]
    )
    ident = np.zeros((nb, 4), np.float32)
    ident[:, 3] = 1.0
    bonds = BondTable(
        active=jnp.asarray(pad(np.ones(nb, bool), False, np.bool_)),
        uid_a=jnp.asarray(pad(ia, -1, np.int32)),
        uid_b=jnp.asarray(pad(ib, -1, np.int32)),
        slot_a=jnp.asarray(pad(ia, -1, np.int32)),
        slot_b=jnp.asarray(pad(ib, -1, np.int32)),
        zone_a=jnp.asarray(pad(_classify(dirs), 0, np.int32)),
        zone_b=jnp.asarray(pad(_classify(-dirs), 0, np.int32)),
        child_to_child=jnp.asarray(pad(np.zeros(nb, bool), False, np.bool_)),
        # Old enough that zones/anchors are final (update_bond_zones skips)
        # and FilterBonds treats every bond as eligible.
        created_step=jnp.asarray(pad(np.full(nb, -10), -10, np.int32)),
        rel_orientation=jnp.asarray(pad(ident, 0.0, np.float32)),
        # Surface point along the bond, hardcoded radius 1.0 (CAM:377-402);
        # body frame == world frame at identity rotation.
        anchor_a=jnp.asarray(pad(dirs, 0.0, np.float32)),
        anchor_b=jnp.asarray(pad(-dirs, 0.0, np.float32)),
        anchors_set=jnp.asarray(pad(np.ones(nb, bool), False, np.bool_)),
    )

    state = state.replace_fields(
        pos=jnp.asarray(pos),
        radius=jnp.asarray(radius),
        mass=jnp.asarray(mass.astype(np.float32)),
        inertia=jnp.asarray(inertia.astype(np.float32)),
        drag=jnp.asarray(
            rng.uniform(0.5, 1.0, n).astype(np.float32)
        ),
        mode=jnp.zeros(n, jnp.int32),
        uid=jnp.arange(n, dtype=jnp.int32),
        parent_uid=jnp.full(n, -1, jnp.int32),
        active_count=jnp.int32(n),
        next_uid=jnp.int32(n),
        bonds=bonds,
    )
    return state, params, genome
