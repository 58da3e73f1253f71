"""Adhesion constraints: spring + anchor-swing + relative-orientation.

Deterministic re-specification of ApplyAdhesionConstraints /
ApplyAdhesionDeltas (SimulateParticles.compute:424-607): per-bond deltas are
computed from one snapshot and accumulated per particle with `segment_sum`
instead of fixed-point int atomics, then applied as `v += Δv`,
`q = normalize(q + Δq)` (compute:599-601).

Replicated quirks (DESIGN.md §4): spring params come from genome mode
`uid_A % n_modes` (CellAdhesionManager.cs:537); anchor stiffness =
orientation_constraint_strength × 10 (CAM:559); the orientation constraint is
gated on the same enable flag as the anchor constraint (compute:457-583).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from sphsim.core import quat
from sphsim.core.types import (
    GenomeDevice,
    SimParams,
    SimState,
    pytree_dataclass,
)


def _axis_angle_delta(axis, angle, q):
    """quat_mul(axis_angle(axis, angle), q) − q (compute:505-506)."""
    rq = quat.from_axis_angle(axis, angle)
    return quat.mul(rq, q) - q


def bond_spring_params(bonds, genome: GenomeDevice):
    """Per-bond spring params from mode uid_A % n_modes (CAM:537) — the
    reference quirk: NOT the cell's actual mode. Returns (rest, stiff,
    damp, anchor_stiff), each [B]."""
    n_modes = jnp.maximum(genome.n_modes, 1)
    mode = jnp.clip(bonds.uid_a % n_modes, 0, n_modes - 1)
    rest = genome.adhesion_rest_length[mode]
    stiff = genome.adhesion_spring_stiffness[mode]
    damp = genome.adhesion_spring_damping[mode]
    anchor_stiff = genome.orientation_constraint_strength[mode] * 10.0  # CAM:559
    return rest, stiff, damp, anchor_stiff


def bond_pair_deltas(b, valid, rest, stiff, damp, anchor_stiff,
                     pos_a, vel_a, q_a, m_a, pos_b, vel_b, q_b, m_b,
                     params: SimParams, dt):
    """Per-bond constraint math (compute:436-583) on pre-gathered endpoint
    rows. Returns (dv_a, dq_a, dv_b, dq_b), zero where not valid/enabled."""
    # --- Spring (distance) constraint (compute:436-456) ---
    delta = pos_b - pos_a
    dist = jnp.linalg.norm(delta, axis=-1)
    spring_ok = valid & (dist > 1e-6)
    dirv = delta / jnp.maximum(dist, 1e-20)[:, None]
    force = dirv * ((dist - rest) * stiff)[:, None]
    rel_vel = vel_b - vel_a
    force = force + dirv * (jnp.sum(rel_vel * dirv, axis=-1) * damp)[:, None]
    dv_a = jnp.where(spring_ok[:, None], force / m_a[:, None] * dt, 0.0)
    dv_b = jnp.where(spring_ok[:, None], -force / m_b[:, None] * dt, 0.0)

    # --- Anchor + orientation constraints (compute:457-583) ---
    enabled = valid & params.enable_anchor_constraints
    strength = anchor_stiff * dt  # compute:460

    anchor_world_a = pos_a + quat.rotate(q_a, b.anchor_a)
    anchor_world_b = pos_b + quat.rotate(q_b, b.anchor_b)
    a_delta = anchor_world_b - anchor_world_a
    a_dist = jnp.linalg.norm(a_delta, axis=-1)
    anchor_ok = enabled & (a_dist > 1e-6)
    a_dir = a_delta / jnp.maximum(a_dist, 1e-20)[:, None]

    def swing(qx, anchor_local, desired):
        """Rotation delta swinging the body-frame anchor toward `desired`
        (compute:474-539)."""
        r_world = quat.rotate(qx, anchor_local)
        axis = jnp.cross(r_world, desired)
        axis_len = jnp.linalg.norm(axis, axis=-1)
        axis_n = axis / jnp.maximum(axis_len, 1e-20)[:, None]
        effectiveness = jnp.abs(
            jnp.sum(jnp.cross(axis_n, r_world) * desired, axis=-1)
        )
        ok = anchor_ok & (axis_len > 1e-6) & (effectiveness > 1e-6)
        angle = strength * effectiveness * 5.0  # compute:504
        dq = _axis_angle_delta(axis_n, angle, qx)
        return jnp.where(ok[:, None], dq, 0.0)

    dq_a = swing(q_a, b.anchor_a, a_dir)
    dq_b = swing(q_b, b.anchor_b, -a_dir)

    # Relative-orientation constraint (compute:541-583).
    cur_rel = quat.mul(quat.conjugate(q_a), q_b)
    corr = quat.mul(b.rel_orientation, quat.conjugate(cur_rel))
    corr_v = corr[:, :3]
    corr_angle = 2.0 * jnp.arctan2(
        jnp.linalg.norm(corr_v, axis=-1), jnp.abs(corr[:, 3])
    )
    orient_ok = enabled & (corr_angle > 1e-6)
    corr_axis = corr_v / jnp.maximum(
        jnp.linalg.norm(corr_v, axis=-1), 1e-20
    )[:, None]
    o_strength = strength * 2.0  # compute:557
    angle_a = -o_strength * corr_angle * 0.5
    angle_b = o_strength * corr_angle * 0.5
    dq_a = dq_a + jnp.where(
        orient_ok[:, None], _axis_angle_delta(corr_axis, angle_a, q_a), 0.0
    )
    dq_b = dq_b + jnp.where(
        orient_ok[:, None], _axis_angle_delta(corr_axis, angle_b, q_b), 0.0
    )
    return dv_a, dq_a, dv_b, dq_b


def accumulate_bond_deltas(dv_a, dq_a, dv_b, dq_b, seg_a, seg_b, n_rows):
    """Scatter-free accumulation: ONE row segment-sum of the [Δv|Δq] rows
    by endpoint row id (two 3/4-wide scatters pay the descriptor cost
    twice). Row ids ≥ n_rows are the drop bucket. Returns (Δv [n,3],
    Δq [n,4])."""
    idx_all = jnp.concatenate([seg_a, seg_b])
    rows = jnp.concatenate([
        jnp.concatenate([dv_a, dq_a], axis=1),
        jnp.concatenate([dv_b, dq_b], axis=1),
    ])                                                    # [2B, 7]
    acc = jax.ops.segment_sum(rows, idx_all, num_segments=n_rows + 1)[:n_rows]
    return acc[:, :3], acc[:, 3:]


# --- Planned (settled-window) accumulation -------------------------------
#
# segment_sum's scatter-add is a random read-modify-write per endpoint row,
# which was slow on the hardware this was first tuned for (not yet measured
# on the card). The planned path removes the RMW entirely: the endpoint rows are
# permuted into particle-sorted order ONCE per bond-table change (the
# argsort is frozen while the table is settled — the same fixed-point
# window as biology.bonds.filter_bonds), then each step is one row
# permute-gather + a segmented Hillis-Steele scan (pad/shift/select only)
# + one boundary gather. The plan rebuild is paid only on division steps
# and chunk starts.
#
# A stale-validity plan stays CORRECT: bond_pair_deltas zeroes every
# component of invalid bonds, so a bond pruned after the plan was built
# contributes exact zeros to its (stale) run. Only slot rewrites and new
# bonds invalidate a plan — both happen exclusively inside
# process_pending_splits, so `pending.count == 0` at step start proves the
# plan valid for the whole step (engine/step.run_steps gates on exactly
# that and rebuilds after division steps).

_SEG_W = 512


# Static capacity of the hybrid side-accumulate: bonds whose endpoints
# changed since the plan snapshot ride a compact segment_sum of 2·_SIDE_CAP
# rows instead of invalidating the whole plan. A division step
# touches ≤ max_splits·(parent bond count) bonds, comfortably under this;
# when the changed set outgrows it the step falls back to the full
# segment_sum (lax.cond — correct, slow, loud via plan_changed_count).
_SIDE_CAP = 2048


@pytree_dataclass
class BondPlan:
    """Frozen accumulation order for one bond-table topology.

    perm [Mp]: endpoint-row order sorted by particle id (Mp = 2B padded to
    a multiple of _SEG_W; padding and invalid rows sort into the drop run).
    flags [Mp]: run starts in sorted order. last [n] / has [n]: per
    particle, the sorted-row index holding its run total (clipped; has
    masks particles with no bonds).

    snap_a / snap_b / snap_active [B]: the bond-table snapshot the plan
    was built from. A bond whose (slot endpoints, activation) still match
    the snapshot accumulates through the frozen order; a bond that changed
    (division rewrote its endpoints, or it was newly created) is zeroed in
    the planned stream and accumulated through the compact side path —
    so a STALE plan is valid on every step, including division steps
    (accumulate_bond_deltas_hybrid)."""

    perm: jnp.ndarray
    flags: jnp.ndarray
    last: jnp.ndarray
    has: jnp.ndarray
    snap_a: jnp.ndarray
    snap_b: jnp.ndarray
    snap_active: jnp.ndarray


def build_bond_plan(bonds, n_rows: int) -> BondPlan:
    """argsort the 2B endpoint rows by particle id (stable: A-side rows of
    a particle stay before its B-side rows, each in bond order — the same
    relative order segment_sum accumulates in)."""
    B = bonds.capacity
    M = 2 * B
    Mp = -(-M // _SEG_W) * _SEG_W
    idx_a = jnp.clip(bonds.slot_a, 0, n_rows - 1)
    idx_b = jnp.clip(bonds.slot_b, 0, n_rows - 1)
    valid = bonds.active & (bonds.slot_a >= 0) & (bonds.slot_b >= 0)
    seg = jnp.concatenate([
        jnp.where(valid, idx_a, n_rows),
        jnp.where(valid, idx_b, n_rows),
        jnp.full((Mp - M,), n_rows, jnp.int32),
    ])
    perm = jnp.argsort(seg)                       # stable by default
    seg_s = seg[perm]
    flags = jnp.concatenate(
        [jnp.ones(1, bool), seg_s[1:] != seg_s[:-1]])
    is_last = jnp.concatenate(
        [seg_s[1:] != seg_s[:-1], jnp.ones(1, bool)])
    tgt = jnp.where(is_last & (seg_s < n_rows), seg_s, n_rows)
    last = jnp.full(n_rows + 1, -1, jnp.int32).at[tgt].set(
        jnp.arange(Mp, dtype=jnp.int32))[:n_rows]
    return BondPlan(perm=perm.astype(jnp.int32), flags=flags,
                    last=jnp.clip(last, 0, Mp - 1), has=last >= 0,
                    snap_a=bonds.slot_a, snap_b=bonds.slot_b,
                    snap_active=bonds.active)


def plan_changed(bonds, plan: BondPlan):
    """Per-bond: does this ACTIVE bond differ from the plan snapshot?
    (Deactivated bonds need no handling: bond_pair_deltas zeroes invalid
    bonds, and exact zeros are harmless anywhere in the frozen stream.)"""
    return bonds.active & (
        (bonds.slot_a != plan.snap_a)
        | (bonds.slot_b != plan.snap_b)
        | ~plan.snap_active
    )


def plan_changed_count(bonds, plan: BondPlan):
    """How many active bonds drifted from the plan snapshot — the rebuild
    trigger (run_steps rebuilds once this nears _SIDE_CAP)."""
    return jnp.sum(plan_changed(bonds, plan).astype(jnp.int32))


def _blocked_segscan(rs, flags):
    """Inclusive SEGMENTED prefix over [Mp, 7] rows with run-start flags:
    a two-level Hillis-Steele of pad/slice/select ops only — no scatters
    (the point) and no lax.associative_scan (compiles pathologically at
    ~10⁶ rows). Identity element is (flag=False, value=0)."""
    M = rs.shape[0]
    W = _SEG_W
    Mb = M // W
    v = rs.reshape(Mb, W, 7)
    f = flags.reshape(Mb, W)
    d = 1
    while d < W:
        vs = jnp.pad(v, ((0, 0), (d, 0), (0, 0)))[:, :W]
        fs = jnp.pad(f, ((0, 0), (d, 0)), constant_values=False)[:, :W]
        v = jnp.where(f[..., None], v, v + vs)
        f = f | fs
        d *= 2
    bt_v, bt_f = v[:, -1], f[:, -1]
    d = 1
    while d < Mb:
        vs = jnp.pad(bt_v, ((d, 0), (0, 0)))[:Mb]
        fs = jnp.pad(bt_f, ((d, 0),), constant_values=False)[:Mb]
        bt_v = jnp.where(bt_f[:, None], bt_v, bt_v + vs)
        bt_f = bt_f | fs
        d *= 2
    pre_v = jnp.pad(bt_v, ((1, 0), (0, 0)))[:Mb]
    # Rows before their block's first run start continue the open run.
    v = jnp.where(f[..., None], v, v + pre_v[:, None, :])
    return v.reshape(M, 7)


def accumulate_bond_deltas_planned(dv_a, dq_a, dv_b, dq_b, plan: BondPlan,
                                   zero_bond=None):
    """Planned twin of accumulate_bond_deltas (same [2B, 7] row stream,
    same per-particle value multiset in the same relative order; the scan
    tree reassociates the sum — last-ulp vs segment_sum).

    zero_bond [B] (optional): bonds whose rows are zeroed in the frozen
    stream (they changed since the plan snapshot and accumulate through
    the side path instead — exact zeros into a stale run are harmless)."""
    if zero_bond is not None:
        z = zero_bond[:, None]
        dv_a = jnp.where(z, 0.0, dv_a)
        dq_a = jnp.where(z, 0.0, dq_a)
        dv_b = jnp.where(z, 0.0, dv_b)
        dq_b = jnp.where(z, 0.0, dq_b)
    rows = jnp.concatenate([
        jnp.concatenate([dv_a, dq_a], axis=1),
        jnp.concatenate([dv_b, dq_b], axis=1),
    ])
    Mp = plan.perm.shape[0]
    rows = jnp.pad(rows, ((0, Mp - rows.shape[0]), (0, 0)))
    cs = _blocked_segscan(rows[plan.perm], plan.flags)
    acc = jnp.where(plan.has[:, None], cs[plan.last], 0.0)
    return acc[:, :3], acc[:, 3:]


def accumulate_bond_deltas_hybrid(dv_a, dq_a, dv_b, dq_b, bonds,
                                  n_rows: int, plan: BondPlan):
    """Planned accumulate that tolerates a STALE plan: bonds matching the
    plan snapshot ride the frozen scatter-free order; bonds that changed
    since (division endpoint rewrites, new bonds) are compacted —
    gather-form, searchsorted over the changed-flag cumsum, no scatter —
    into a ≤ _SIDE_CAP table and accumulated with one small segment_sum.
    Falls back to the full segment_sum when the changed set outgrows
    _SIDE_CAP (rare; run_steps rebuilds the plan well before that).

    This is what makes division steps cost about a quiet step instead of
    a full segment_sum."""
    changed = plan_changed(bonds, plan)
    n_changed = jnp.sum(changed.astype(jnp.int32))
    valid = bonds.active & (bonds.slot_a >= 0) & (bonds.slot_b >= 0)
    idx_a = jnp.clip(bonds.slot_a, 0, n_rows - 1)
    idx_b = jnp.clip(bonds.slot_b, 0, n_rows - 1)

    def quiet(_):
        return accumulate_bond_deltas_planned(dv_a, dq_a, dv_b, dq_b, plan)

    def hybrid(_):
        dvp, dqp = accumulate_bond_deltas_planned(
            dv_a, dq_a, dv_b, dq_b, plan, zero_bond=changed)
        r = jnp.cumsum(changed.astype(jnp.int32))
        sel = jnp.searchsorted(
            r, 1 + jnp.arange(_SIDE_CAP, dtype=jnp.int32))
        sel = jnp.clip(sel, 0, changed.shape[0] - 1).astype(jnp.int32)
        live = (jnp.arange(_SIDE_CAP) < n_changed) & valid[sel]
        seg_a = jnp.where(live, idx_a[sel], n_rows)
        seg_b = jnp.where(live, idx_b[sel], n_rows)
        dv_s, dq_s = accumulate_bond_deltas(
            dv_a[sel], dq_a[sel], dv_b[sel], dq_b[sel],
            seg_a, seg_b, n_rows)
        return dvp + dv_s, dqp + dq_s

    def full(_):
        seg_a = jnp.where(valid, idx_a, n_rows)
        seg_b = jnp.where(valid, idx_b, n_rows)
        return accumulate_bond_deltas(
            dv_a, dq_a, dv_b, dq_b, seg_a, seg_b, n_rows)

    return jax.lax.cond(
        n_changed == 0, quiet,
        lambda a: jax.lax.cond(n_changed <= _SIDE_CAP, hybrid, full, a),
        None,
    )


def bond_deltas(state: SimState, params: SimParams, genome: GenomeDevice,
                dt=None, plan: BondPlan | None = None):
    """Per-bond velocity/rotation deltas → per-particle sums [N,3], [N,4].

    `plan` (optional): a BondPlan valid for this step's bond topology —
    accumulation then runs scatter-free (see the planned section above)."""
    b = state.bonds
    N = state.capacity
    dt = params.dt if dt is None else dt

    idx_a = jnp.clip(b.slot_a, 0, N - 1)
    idx_b = jnp.clip(b.slot_b, 0, N - 1)
    valid = b.active & (b.slot_a >= 0) & (b.slot_b >= 0)

    rest, stiff, damp, anchor_stiff = bond_spring_params(b, genome)

    # ONE wide-row gather per endpoint instead of a gather per field.
    tbl = jnp.concatenate(
        [state.pos, state.vel, state.rot,
         state.mass[:, None], jnp.zeros((N, 1), jnp.float32)], axis=1,
    )                                                     # [N, 12]
    ga, gb = tbl[idx_a], tbl[idx_b]
    pos_a, vel_a, q_a, m_a = ga[:, 0:3], ga[:, 3:6], ga[:, 6:10], ga[:, 10]
    pos_b, vel_b, q_b, m_b = gb[:, 0:3], gb[:, 3:6], gb[:, 6:10], gb[:, 10]

    dv_a, dq_a, dv_b, dq_b = bond_pair_deltas(
        b, valid, rest, stiff, damp, anchor_stiff,
        pos_a, vel_a, q_a, m_a, pos_b, vel_b, q_b, m_b, params, dt,
    )
    if plan is not None:
        return accumulate_bond_deltas_hybrid(
            dv_a, dq_a, dv_b, dq_b, b, N, plan)
    seg_a = jnp.where(valid, idx_a, N)  # N = drop bucket
    seg_b = jnp.where(valid, idx_b, N)
    return accumulate_bond_deltas(dv_a, dq_a, dv_b, dq_b, seg_a, seg_b, N)


def apply_adhesion(
    state: SimState, params: SimParams, genome: GenomeDevice, dt=None,
    plan: BondPlan | None = None,
) -> SimState:
    """K10 + K11: compute per-bond deltas and apply them
    (compute:586-607)."""
    dv, dq = bond_deltas(state, params, genome, dt=dt, plan=plan)
    alive = (jnp.arange(state.capacity) < state.active_count)[:, None]
    vel = jnp.where(alive, state.vel + dv, state.vel)
    rot = jnp.where(alive, quat.normalize(state.rot + dq), state.rot)
    return state.replace_fields(vel=vel, rot=rot)
