"""Adhesion bond graph: zone classification, anchors, inheritance, pruning.

Device-side fixed-capacity masked-edge-table re-implementation of
CellAdhesionManager.cs. Zones: 0 = ZoneA, 1 = ZoneB, 2 = ZoneC.

Bonds carry uids (stable identity) and slots (compute index). Because child
uids are freshly allocated at every split, inherited bonds can never collide
with existing (uidA, uidB) pairs, so AddBond's duplicate check
(CellAdhesionManager.cs:90) is vacuous on every reference call path; we rely
on that invariant instead of re-checking.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from sphsim.core import quat
from sphsim.core.types import BondTable, GenomeDevice, SimParams, SimState

ZONE_A = 0
ZONE_B = 1
ZONE_C = 2


def classify_zone(
    cell_pos, cell_rot, other_pos, split_yaw, split_pitch,
    inheritance_angle_deg: float = 10.0,
):
    """ClassifyBondDirection (CellAdhesionManager.cs:320-336).

    Angle between the bond direction in the cell's local frame and the mode's
    split direction; within ±inheritance_angle of the 90° equator ⇒ ZoneC;
    dot > 0 ⇒ ZoneB; else ZoneA. Broadcasts over leading axes.
    """
    bond_dir = other_pos - cell_pos
    bond_dir = bond_dir / jnp.maximum(
        jnp.linalg.norm(bond_dir, axis=-1, keepdims=True), 1e-12
    )
    bond_local = quat.rotate(quat.conjugate(cell_rot), bond_dir)
    split_local = quat.euler_direction(split_yaw, split_pitch)
    dot = jnp.clip(jnp.sum(bond_local * split_local, axis=-1), -1.0, 1.0)
    angle_deg = jnp.rad2deg(jnp.arccos(dot))
    zone = jnp.where(dot > 0, ZONE_B, ZONE_A)
    return jnp.where(
        jnp.abs(angle_deg - 90.0) <= inheritance_angle_deg, ZONE_C, zone
    )


def update_bond_zones(
    state: SimState, params: SimParams, genome: GenomeDevice
) -> BondTable:
    """UpdateBondZones (CAM:338-423): bonds are only (re)classified within one
    step of creation; anchors are set exactly one step after creation as the
    surface point along the bond with hardcoded radius 1.0, stored body-frame
    (CAM:377-402)."""
    b = state.bonds
    young = b.active & (state.step_count <= b.created_step + 1)
    # Settled steps have no young bonds — skip the endpoint gathers and
    # quaternion math entirely (this pass only ever writes young rows).
    return jax.lax.cond(
        jnp.any(young),
        lambda: _update_young_bond_zones(state, params, genome, young),
        lambda: b,
    )


def _update_young_bond_zones(
    state: SimState, params: SimParams, genome: GenomeDevice, young
) -> BondTable:
    b = state.bonds
    N = state.capacity
    idx_a = jnp.clip(b.slot_a, 0, N - 1)
    idx_b = jnp.clip(b.slot_b, 0, N - 1)

    # One wide-row gather per endpoint (descriptor-bound path, see
    # filter_bonds).
    tbl = jnp.concatenate(
        [state.pos, state.rot,
         state.mode.astype(jnp.float32)[:, None]], axis=1,
    )                                                     # [N, 8]
    ga, gb = tbl[idx_a], tbl[idx_b]
    pos_a, rot_a = ga[:, 0:3], ga[:, 3:7]
    pos_b, rot_b = gb[:, 0:3], gb[:, 3:7]
    mode_a_raw = ga[:, 7].astype(jnp.int32)
    mode_b_raw = gb[:, 7].astype(jnp.int32)

    # Anchors at creation_step + 1 (CAM:377-402), radius hardcoded to 1.0.
    set_anchors = young & (state.step_count == b.created_step + 1) & ~b.anchors_set
    bond_dir = pos_b - pos_a
    bond_dir = bond_dir / jnp.maximum(
        jnp.linalg.norm(bond_dir, axis=-1, keepdims=True), 1e-12
    )
    anchor_a_new = quat.rotate(quat.conjugate(rot_a), bond_dir)
    anchor_b_new = quat.rotate(quat.conjugate(rot_b), -bond_dir)
    anchor_a = jnp.where(set_anchors[:, None], anchor_a_new, b.anchor_a)
    anchor_b = jnp.where(set_anchors[:, None], anchor_b_new, b.anchor_b)
    anchors_set = b.anchors_set | set_anchors

    # Zone reclassification from each endpoint's mode split direction.
    n_modes = jnp.maximum(genome.n_modes, 1)
    mode_a = jnp.clip(mode_a_raw, 0, n_modes - 1)
    mode_b = jnp.clip(mode_b_raw, 0, n_modes - 1)
    zone_a_new = classify_zone(
        pos_a, rot_a, pos_b,
        genome.parent_split_yaw[mode_a], genome.parent_split_pitch[mode_a],
        params.inheritance_angle_deg,
    )
    zone_b_new = classify_zone(
        pos_b, rot_b, pos_a,
        genome.parent_split_yaw[mode_b], genome.parent_split_pitch[mode_b],
        params.inheritance_angle_deg,
    )
    zone_a = jnp.where(young, zone_a_new, b.zone_a)
    zone_b = jnp.where(young, zone_b_new, b.zone_b)

    return b.replace_fields(
        anchor_a=anchor_a, anchor_b=anchor_b, anchors_set=anchors_set,
        zone_a=zone_a, zone_b=zone_b,
    )


def filter_bonds(state: SimState) -> BondTable:
    """FilterBonds (CAM:184-243): eligible bonds are grouped per SIDE —
    (cellA, zoneA) over A-ends, independently (cellB, zoneB) over B-ends —
    and within each group everything but the geometrically shortest is
    removed (union of the A-end and B-end verdicts); groups containing any
    C↔(A|B) bond are exempt; bonds created this step are exempt; ties keep
    the lowest bond index. This tie-break is a DOCUMENTED divergence
    (DESIGN.md §7.4): the reference's stable OrderBy keeps list = creation
    order, and slot reuse by handle_cell_split's free-slot allocator means
    a low index is not always the older bond — identical whenever
    distances differ (bit-equal f32 distance ties are the only case).

    The reference runs this every frame, but the pass is a FIXED POINT two
    steps after the last bond creation/rewrite: removal is permanent, zones
    freeze one step after creation (update_bond_zones), and every rewrite
    path (division inheritance, inserts) stamps created_step = the current
    step. So once a prune has run on a settled table, every group is a
    singleton or mixed-exempt and the verdict is a no-op REGARDLESS of how
    positions move. Settled steps (the vast majority) skip straight
    through a lax.cond; the
    equivalence is asserted step-by-step in
    tests/test_biology.py::test_filter_bonds_settled_gate_is_exact.

    The active pass keeps random access coarse: both endpoints ride one
    [2B] key vector, per-group stats are segment-mins, and the per-bond
    lookbacks are two 8-wide row gathers instead of eight column
    gathers."""
    b = state.bonds
    # No `active` mask: a division that only DROPS bonds (no child keeps
    # adhesion) stamps the deactivated rows, and must reopen the gate —
    # removing a mixed bond can strip a group's exemption, so the prune
    # the reference would run that frame has to fire (CAM:72-75 runs it
    # every frame). Rows deactivated by the prune itself keep their old
    # stamp, so they never hold the gate open.
    dirty = jnp.any(b.created_step >= state.step_count - 2)
    return jax.lax.cond(
        dirty, lambda: _filter_bonds_active(state), lambda: b
    )


def _filter_bonds_active(state: SimState) -> BondTable:
    b = state.bonds
    N = state.capacity
    B = b.capacity
    idx_a = jnp.clip(b.slot_a, 0, N - 1)
    idx_b = jnp.clip(b.slot_b, 0, N - 1)
    eligible = b.active & (b.created_step < state.step_count)

    ptbl = jnp.concatenate(
        [state.pos, jnp.zeros((N, 5), jnp.float32)], axis=1
    )                                                     # [N, 8] wide rows
    dist = jnp.linalg.norm(
        ptbl[idx_b][:, :3] - ptbl[idx_a][:, :3], axis=-1
    )
    mixed = ((b.zone_a == ZONE_C) & (b.zone_b != ZONE_C)) | (
        (b.zone_a != ZONE_C) & (b.zone_b == ZONE_C)
    )

    # The reference's A-end and B-end groupings are INDEPENDENT (CAM:192
    # groups by (cellA, zoneA) over A-ends only, CAM:216 by (cellB, zoneB)
    # over B-ends only) — a cell's A-side and B-side bonds never share a
    # group. Side B gets a disjoint key range so one segment pass computes
    # both groupings.
    ns = N * 3
    n_keys = 2 * ns + 1
    key_a = jnp.where(eligible, idx_a * 3 + b.zone_a, n_keys - 1)
    key_b = jnp.where(eligible, ns + idx_b * 3 + b.zone_b, n_keys - 1)
    keys = jnp.concatenate([key_a, key_b])                # [2B]
    elig2 = jnp.concatenate([eligible, eligible])
    mixed2 = jnp.concatenate([mixed, mixed])
    d2 = jnp.where(elig2, jnp.concatenate([dist, dist]), jnp.inf)
    idx2 = jnp.concatenate([jnp.arange(B), jnp.arange(B)])

    # A singleton group's min is the bond itself, so the idx≠min test
    # already spares it — no count column needed. Mixed presence folds into
    # a segment_min too (0 if any mixed, via 1−mixed), so the per-group
    # stats are two mins + one masked idx-min, folded into ONE 8-wide table
    # the per-entry lookback reads with a single row gather.
    min_dist = jax.ops.segment_min(d2, keys, num_segments=n_keys)
    no_mixed = jax.ops.segment_min(
        jnp.where(elig2 & mixed2, 0.0, 1.0), keys, num_segments=n_keys
    )
    stats = jnp.concatenate(
        [min_dist[:, None], no_mixed[:, None],
         jnp.zeros((n_keys, 6), jnp.float32)], axis=1,
    )                                                     # [K, 8]
    g = stats[keys]                                       # [2B, 8] row gather
    min_d_k, no_mixed_k = g[:, 0], g[:, 1]

    is_min = elig2 & (d2 <= min_d_k)
    min_idx = jax.ops.segment_min(
        jnp.where(is_min, idx2, B), keys, num_segments=n_keys
    )
    # f32 carries bond indices exactly up to 2^24 — far above any max_bonds.
    itbl = jnp.concatenate(
        [min_idx[:, None].astype(jnp.float32),
         jnp.zeros((n_keys, 7), jnp.float32)], axis=1,
    )
    min_idx_k = itbl[keys][:, 0]
    rm2 = (
        elig2 & (no_mixed_k > 0.5)
        & (idx2.astype(jnp.float32) != min_idx_k)
    )
    rm = rm2[:B] | rm2[B:]
    return b.replace_fields(active=b.active & ~rm)


def handle_cell_split(
    bonds: BondTable,
    rot: jnp.ndarray,          # [N,4] current rotations (children already written)
    parent_uid, uid_a, uid_b, slot_a, slot_b,
    keep_a, keep_b, make_adhesion,
    step_count,
):
    """Bond inheritance for ONE split (HandleCellSplit, CAM:425-509).

    Every bond touching the parent is rewritten in place to its inheriting
    child (or deactivated); the ZoneC-both-children case duplicates the bond
    into a free slot; `parentMakeAdhesion` adds a fresh child-A↔child-B bond.

    Replicated quirk: in the ZoneC branch the reference passes
    `parentBond.zoneA` as the child's zone regardless of which end the parent
    occupied (CAM:477-488).

    Returns (bonds, n_dropped) where n_dropped counts inserts lost to
    capacity.
    """
    B = bonds.capacity
    N = rot.shape[0]

    touches = bonds.active & (
        (bonds.uid_a == parent_uid) | (bonds.uid_b == parent_uid)
    )
    a_is_parent = bonds.uid_a == parent_uid
    neighbor_uid = jnp.where(a_is_parent, bonds.uid_b, bonds.uid_a)
    neighbor_slot = jnp.where(a_is_parent, bonds.slot_b, bonds.slot_a)
    neighbor_zone = jnp.where(a_is_parent, bonds.zone_b, bonds.zone_a)
    parent_zone = jnp.where(a_is_parent, bonds.zone_a, bonds.zone_b)

    # Zone the child end receives (CAM:477, :494, :500).
    pass_zone = jnp.where(parent_zone == ZONE_C, bonds.zone_a, parent_zone)

    # Which child inherits in place: ZoneC → A if keep_a else B if keep_b;
    # ZoneB → A if keep_a; ZoneA → B if keep_b. 0 = none, 1 = A, 2 = B.
    inherit = jnp.where(
        parent_zone == ZONE_C,
        jnp.where(keep_a, 1, jnp.where(keep_b, 2, 0)),
        jnp.where(
            parent_zone == ZONE_B,
            jnp.where(keep_a, 1, 0),
            jnp.where(keep_b, 2, 0),
        ),
    )
    inherit = jnp.where(touches, inherit, 0)
    rewrite = inherit > 0
    child_uid = jnp.where(inherit == 1, uid_a, uid_b)
    child_slot = jnp.where(inherit == 1, slot_a, slot_b)

    q_child = rot[jnp.clip(child_slot, 0, N - 1)]
    q_neighbor = rot[jnp.clip(neighbor_slot, 0, N - 1)]
    rel = quat.mul(quat.conjugate(q_child), q_neighbor)

    def w(old, new, mask):
        m = mask if old.ndim == 1 else mask[:, None]
        return jnp.where(m, new, old)

    b = bonds.replace_fields(
        active=w(bonds.active, rewrite, touches),
        uid_a=w(bonds.uid_a, child_uid, rewrite),
        uid_b=w(bonds.uid_b, neighbor_uid, rewrite),
        slot_a=w(bonds.slot_a, child_slot, rewrite),
        slot_b=w(bonds.slot_b, neighbor_slot, rewrite),
        zone_a=w(bonds.zone_a, pass_zone, rewrite),
        zone_b=w(bonds.zone_b, neighbor_zone, rewrite),
        child_to_child=w(bonds.child_to_child, jnp.zeros(B, jnp.bool_), rewrite),
        # Stamp EVERY touched bond, including pure drops (inherit == 0):
        # dropping a mixed C↔(A|B) bond can strip its groups' prune
        # exemption, so the filter_bonds settled-gate must reopen — the
        # stamp is the gate's signal. Consumers other than the gate mask
        # by `active`, so stamping a deactivated row is otherwise inert.
        created_step=w(bonds.created_step, jnp.full(B, 1, jnp.int32) * step_count, touches),
        rel_orientation=w(bonds.rel_orientation, rel, rewrite),
        anchor_a=w(bonds.anchor_a, jnp.zeros((B, 3), jnp.float32), rewrite),
        anchor_b=w(bonds.anchor_b, jnp.zeros((B, 3), jnp.float32), rewrite),
        anchors_set=w(bonds.anchors_set, jnp.zeros(B, jnp.bool_), rewrite),
    )

    # --- Inserts: ZoneC duplicates (both children keep) + optional A↔B bond.
    dup = touches & (parent_zone == ZONE_C) & keep_a & keep_b
    # Free-slot allocation: stable argsort puts inactive slots first, ascending.
    perm = jnp.argsort(b.active.astype(jnp.int32), stable=True)
    n_free = jnp.sum(~b.active)

    dup_rank = jnp.cumsum(dup.astype(jnp.int32)) - 1
    dup_ok = dup & (dup_rank < n_free)
    n_dup = jnp.sum(dup_ok)
    target = jnp.where(dup_ok, perm[jnp.clip(dup_rank, 0, B - 1)], B)

    q_b = rot[jnp.clip(slot_b, 0, N - 1)]
    rel_dup = quat.mul(quat.conjugate(q_b), q_neighbor)

    def scatter(arr, values):
        """Scatter `values[i]` to `target[i]`; index B is a trash row, so
        invalid inserts never collide with valid ones."""
        padded = jnp.concatenate([arr, arr[:1]], axis=0)
        return padded.at[target].set(values)[:B]

    i32 = lambda v: jnp.broadcast_to(jnp.int32(v), (B,))  # noqa: E731

    b = b.replace_fields(
        active=scatter(b.active, jnp.ones(B, jnp.bool_)),
        uid_a=scatter(b.uid_a, i32(uid_b)),
        uid_b=scatter(b.uid_b, neighbor_uid),
        slot_a=scatter(b.slot_a, i32(slot_b)),
        slot_b=scatter(b.slot_b, neighbor_slot),
        zone_a=scatter(b.zone_a, pass_zone),
        zone_b=scatter(b.zone_b, neighbor_zone),
        child_to_child=scatter(b.child_to_child, jnp.zeros(B, jnp.bool_)),
        created_step=scatter(b.created_step, i32(step_count)),
        rel_orientation=scatter(b.rel_orientation, rel_dup),
        anchor_a=scatter(b.anchor_a, jnp.zeros((B, 3), jnp.float32)),
        anchor_b=scatter(b.anchor_b, jnp.zeros((B, 3), jnp.float32)),
        anchors_set=scatter(b.anchors_set, jnp.zeros(B, jnp.bool_)),
    )
    dropped = jnp.sum(dup & ~dup_ok)

    # Child-A↔child-B bond (CAM:504-509), ZoneC/ZoneC, child_to_child.
    ab_slot = perm[jnp.clip(n_dup, 0, B - 1)]
    ab_ok = make_adhesion & (n_dup < n_free)
    ab_idx = jnp.where(ab_ok, ab_slot, B)
    q_a_new = rot[jnp.clip(slot_a, 0, N - 1)]
    q_b_new = rot[jnp.clip(slot_b, 0, N - 1)]
    rel_ab = quat.mul(quat.conjugate(q_a_new), q_b_new)

    def set1(arr, value):
        padded = jnp.concatenate([arr, arr[:1]], axis=0)
        return padded.at[ab_idx].set(value)[:B]

    b = b.replace_fields(
        active=set1(b.active, True),
        uid_a=set1(b.uid_a, uid_a),
        uid_b=set1(b.uid_b, uid_b),
        slot_a=set1(b.slot_a, slot_a),
        slot_b=set1(b.slot_b, slot_b),
        zone_a=set1(b.zone_a, ZONE_C),
        zone_b=set1(b.zone_b, ZONE_C),
        child_to_child=set1(b.child_to_child, True),
        created_step=set1(b.created_step, step_count),
        rel_orientation=set1(b.rel_orientation, rel_ab),
        anchor_a=set1(b.anchor_a, jnp.zeros(3, jnp.float32)),
        anchor_b=set1(b.anchor_b, jnp.zeros(3, jnp.float32)),
        anchors_set=set1(b.anchors_set, False),
    )
    dropped = dropped + jnp.where(make_adhesion & ~ab_ok, 1, 0)
    return b, dropped
