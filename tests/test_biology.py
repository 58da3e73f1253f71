"""Topology tests: zone classification, division slot policy, uid
monotonicity, bond inheritance truth table, pruning (SURVEY §4 item 3)."""

import jax.numpy as jnp
import numpy as np
import pytest

from sphsim.biology.bonds import (
    ZONE_A,
    ZONE_B,
    ZONE_C,
    classify_zone,
    filter_bonds,
)
from sphsim.core import quat
from sphsim.core.types import Genome, GenomeMode, SimParams, SimState


@pytest.mark.parametrize(
    "other,expected",
    [
        ((0.0, 0.0, 5.0), ZONE_B),    # toward split pole
        ((0.0, 0.0, -5.0), ZONE_A),   # away
        ((5.0, 0.0, 0.0), ZONE_C),    # equator
        ((0.0, 5.0, 0.0), ZONE_C),
        ((0.0, 1.0, 5.0), ZONE_B),    # ~11° off pole
    ],
)
def test_classify_zone_identity_rot(other, expected):
    z = classify_zone(
        jnp.zeros(3), quat.IDENTITY, jnp.asarray(other, jnp.float32), 0.0, 0.0
    )
    assert int(z) == expected


def test_classify_zone_equator_band_width():
    # 10° half-width: 80.5° from pole ⇒ C; 79° ⇒ B.
    for deg, expected in [(80.5, ZONE_C), (79.0, ZONE_B), (100.5, ZONE_A)]:
        rad = np.deg2rad(deg)
        other = jnp.array([np.sin(rad), 0.0, np.cos(rad)], jnp.float32) * 5
        z = classify_zone(jnp.zeros(3), quat.IDENTITY, other, 0.0, 0.0)
        assert int(z) == expected, deg


def test_classify_zone_respects_cell_rotation():
    # Rotate the cell 180° about x: +z world becomes −z local ⇒ ZoneA.
    rot = quat.from_axis_angle(jnp.array([1.0, 0.0, 0.0]), jnp.pi)
    z = classify_zone(jnp.zeros(3), rot, jnp.array([0.0, 0.0, 5.0]), 0.0, 0.0)
    assert int(z) == ZONE_A


def simple_genome(**kw):
    defaults = dict(
        is_initial=True, split_interval=1.0, parent_make_adhesion=True,
        child_a_mode_index=0, child_b_mode_index=0,
        child_a_keep_adhesion=True, child_b_keep_adhesion=True,
    )
    defaults.update(kw)
    return Genome((GenomeMode(**defaults),)).validate_for_simulation()


def run_sim(genome, params, n_steps, capacity=16):
    from sphsim.core.init import init_particles
    from sphsim.engine.step import make_step_fn

    st = init_particles(
        params, None, n_modes=len(genome.modes),
        initial_mode=0, capacity=capacity,
    )
    gd = genome.to_device()
    f = make_step_fn(params, donate=False)
    for _ in range(n_steps):
        st = f(st, gd)
    return st


def test_division_slot_policy_and_uids():
    # dt=0.5, interval=1 ⇒ ready at step 2, applied at step 3.
    genome = simple_genome()
    params = SimParams(dt=0.5, capacity=16, max_splits_per_step=8, max_bonds=64)
    st = run_sim(genome, params, 3)
    assert int(st.active_count) == 2
    # Child A overwrites slot 0, child B appends at slot 1 (cs:846-848).
    assert int(st.child_type[0]) == 0 and int(st.child_type[1]) == 1
    # uids: A then B from the global counter (cs:850-851).
    assert int(st.uid[0]) == 1 and int(st.uid[1]) == 2
    assert int(st.parent_uid[0]) == 0 and int(st.parent_uid[1]) == 0
    assert int(st.next_uid) == 3
    # parentMakeAdhesion ⇒ one child-to-child ZoneC/ZoneC bond (CAM:504-509).
    assert int(jnp.sum(st.bonds.active)) == 1
    i = int(jnp.argmax(st.bonds.active))
    assert bool(st.bonds.child_to_child[i])
    assert int(st.bonds.uid_a[i]) == 1 and int(st.bonds.uid_b[i]) == 2


def test_population_doubles_and_uid_monotone():
    genome = simple_genome()
    params = SimParams(dt=0.5, capacity=32, max_splits_per_step=16, max_bonds=64)
    # Splits are processed at step 3, then every 2 steps (timers advance in
    # the same step as processing, like the reference's Update order):
    # step 3 → 2, 5 → 4, 7 → 8, 9 → 16.
    st = run_sim(genome, params, 9, capacity=32)
    assert int(st.active_count) == 16
    uids = np.asarray(st.uid[:16])
    assert len(set(uids.tolist())) == 16
    assert uids.max() == int(st.next_uid) - 1


def test_split_geometry():
    # parent at origin, identity rotation, split yaw=90 ⇒ dir = +x̂ world.
    genome = simple_genome(parent_split_yaw=90.0)
    params = SimParams(dt=0.5, capacity=8, max_splits_per_step=4,
                       spawn_overlap_offset=0.5, split_velocity_magnitude=0.5,
                       repulsion_strength=0.0, global_drag_multiplier=0.0,
                       max_bonds=64)
    from sphsim.core.init import init_particles
    from sphsim.engine.step import make_step_fn

    st = init_particles(params, None, n_modes=1, initial_mode=0, capacity=8)
    gd = genome.to_device()
    f = make_step_fn(params, donate=False)
    st = f(st, gd)   # timer 0.5
    st = f(st, gd)   # timer 1.0 ⇒ queued
    pend = st.pending
    assert int(pend.count) == 1
    np.testing.assert_allclose(pend.pos_a[0], [0.5, 0, 0], atol=1e-5)
    np.testing.assert_allclose(pend.pos_b[0], [-0.5, 0, 0], atol=1e-5)
    np.testing.assert_allclose(pend.vel_a[0], [0.5, 0, 0], atol=1e-5)
    np.testing.assert_allclose(pend.vel_b[0], [-0.5, 0, 0], atol=1e-5)


def test_capacity_cap_stops_division():
    # The reference stops splitting when active == capacity (cs:648-649).
    genome = simple_genome()
    params = SimParams(dt=0.5, capacity=4, max_splits_per_step=4, max_bonds=64)
    st = run_sim(genome, params, 20, capacity=4)
    assert int(st.active_count) == 4


def test_timer_resets_even_when_deferred():
    # With SOME headroom but more ready cells than allowed slots, every
    # ready cell resets its timer whether it was queued or not (cs:682:
    # 'Reset timer regardless of whether we can actually split now').
    from sphsim.biology.division import queue_splits

    genome = simple_genome()
    gd = genome.to_device()
    params = SimParams(dt=0.5, capacity=6, max_splits_per_step=4,
                       max_bonds=64)
    st = SimState.zeros(6, params).replace_fields(
        active_count=jnp.int32(4),
        mode=jnp.zeros(6, jnp.int32),
        split_timer=jnp.full(6, 0.99, jnp.float32),   # all 4 fire (+0.5)
    )
    out = queue_splits(st, params, gd)
    assert int(out.pending.count) == 2                # allowed = 6 - 4
    np.testing.assert_allclose(np.asarray(out.split_timer[:4]), 0.0)


def test_timers_freeze_at_capacity():
    # With NO headroom the reference returns before the timer-advance loop
    # (cs:648-649): timers FREEZE — no advance and no reset — so phases
    # resume where they stopped after a resize.
    from sphsim.biology.division import queue_splits

    genome = simple_genome()
    gd = genome.to_device()
    params = SimParams(dt=0.5, capacity=4, max_splits_per_step=4,
                       max_bonds=64)
    st = SimState.zeros(4, params).replace_fields(
        active_count=jnp.int32(4),
        mode=jnp.zeros(4, jnp.int32),
        split_timer=jnp.asarray([0.2, 0.7, 0.99, 1.4], jnp.float32),
    )
    out = queue_splits(st, params, gd)
    assert int(out.pending.count) == 0
    np.testing.assert_allclose(
        np.asarray(out.split_timer), [0.2, 0.7, 0.99, 1.4]
    )


def make_bond(b, i, uid_a, uid_b, slot_a, slot_b, zone_a, zone_b,
              created_step=8):
    # Default created_step = 8 with the tests' step_count = 10: eligible
    # (created < step) AND within filter_bonds' settled-gate window
    # (created >= step − 2) — hand-built tables bypass the division paths
    # that normally stamp created_step, so they must look freshly touched
    # for the prune to run (as any real mutation would make them).
    return b.replace_fields(
        active=b.active.at[i].set(True),
        uid_a=b.uid_a.at[i].set(uid_a),
        uid_b=b.uid_b.at[i].set(uid_b),
        slot_a=b.slot_a.at[i].set(slot_a),
        slot_b=b.slot_b.at[i].set(slot_b),
        zone_a=b.zone_a.at[i].set(zone_a),
        zone_b=b.zone_b.at[i].set(zone_b),
        created_step=b.created_step.at[i].set(created_step),
    )


def test_filter_bonds_keeps_shortest():
    params = SimParams(capacity=8)
    st = SimState.zeros(8, params)
    st = st.replace_fields(
        pos=st.pos.at[1].set(jnp.array([2.0, 0, 0]))
               .at[2].set(jnp.array([5.0, 0, 0])),
        active_count=jnp.int32(3),
        step_count=jnp.int32(10),
    )
    b = st.bonds
    # Two bonds from (cell 0, ZoneB): to cell1 (dist 2) and cell2 (dist 5).
    b = make_bond(b, 0, 10, 11, 0, 1, ZONE_B, ZONE_A)
    b = make_bond(b, 1, 10, 12, 0, 2, ZONE_B, ZONE_A)
    st = st.replace_fields(bonds=b)
    out = filter_bonds(st)
    assert bool(out.active[0]) and not bool(out.active[1])


def test_filter_bonds_mixed_zone_exemption():
    # Groups containing a C↔(A|B) bond skip filtering (CAM:197-200).
    params = SimParams(capacity=8)
    st = SimState.zeros(8, params)
    st = st.replace_fields(
        pos=st.pos.at[1].set(jnp.array([2.0, 0, 0]))
               .at[2].set(jnp.array([5.0, 0, 0])),
        active_count=jnp.int32(3),
        step_count=jnp.int32(10),
    )
    b = st.bonds
    b = make_bond(b, 0, 10, 11, 0, 1, ZONE_C, ZONE_A)  # mixed C↔A
    b = make_bond(b, 1, 10, 12, 0, 2, ZONE_C, ZONE_C)
    st = st.replace_fields(bonds=b)
    out = filter_bonds(st)
    assert bool(out.active[0]) and bool(out.active[1])


def test_filter_bonds_fresh_exempt():
    params = SimParams(capacity=8)
    st = SimState.zeros(8, params)
    st = st.replace_fields(
        pos=st.pos.at[1].set(jnp.array([2.0, 0, 0]))
               .at[2].set(jnp.array([5.0, 0, 0])),
        active_count=jnp.int32(3),
        step_count=jnp.int32(10),
    )
    b = st.bonds
    b = make_bond(b, 0, 10, 11, 0, 1, ZONE_B, ZONE_A, created_step=10)
    b = make_bond(b, 1, 10, 12, 0, 2, ZONE_B, ZONE_A, created_step=10)
    st = st.replace_fields(bonds=b)
    out = filter_bonds(st)
    assert bool(out.active[0]) and bool(out.active[1])


@pytest.mark.parametrize(
    "zone,keep_a,keep_b,inheritors",
    [
        (ZONE_C, True, True, {"A", "B"}),
        (ZONE_C, True, False, {"A"}),
        (ZONE_C, False, True, {"B"}),
        (ZONE_C, False, False, set()),
        (ZONE_B, True, False, {"A"}),
        (ZONE_B, False, True, set()),
        (ZONE_A, False, True, {"B"}),
        (ZONE_A, True, False, set()),
    ],
)
def test_bond_inheritance_truth_table(zone, keep_a, keep_b, inheritors):
    from sphsim.biology.bonds import handle_cell_split

    params = SimParams(capacity=8)
    st = SimState.zeros(8, params)
    b = st.bonds
    # Parent uid=5 at slot 0 bonded to neighbor uid=7 at slot 2.
    b = make_bond(b, 0, 5, 7, 0, 2, zone, ZONE_A)
    rot = st.rot
    out, dropped = handle_cell_split(
        b, rot,
        parent_uid=jnp.int32(5), uid_a=jnp.int32(10), uid_b=jnp.int32(11),
        slot_a=jnp.int32(0), slot_b=jnp.int32(3),
        keep_a=jnp.bool_(keep_a), keep_b=jnp.bool_(keep_b),
        make_adhesion=jnp.bool_(False), step_count=jnp.int32(4),
    )
    active = np.asarray(out.active)
    ua, ub = np.asarray(out.uid_a), np.asarray(out.uid_b)
    got = set()
    for i in range(len(active)):
        if active[i]:
            assert ub[i] == 7
            got.add("A" if ua[i] == 10 else "B")
    assert got == inheritors
    assert int(dropped) == 0


def test_bond_inheritance_resets_bond_freshness():
    from sphsim.biology.bonds import handle_cell_split

    params = SimParams(capacity=8)
    st = SimState.zeros(8, params)
    b = make_bond(st.bonds, 0, 5, 7, 0, 2, ZONE_B, ZONE_A, created_step=1)
    b = b.replace_fields(anchors_set=b.anchors_set.at[0].set(True))
    out, _ = handle_cell_split(
        b, st.rot, jnp.int32(5), jnp.int32(10), jnp.int32(11),
        jnp.int32(0), jnp.int32(3),
        jnp.bool_(True), jnp.bool_(False), jnp.bool_(False), jnp.int32(9),
    )
    assert int(out.created_step[0]) == 9
    assert not bool(out.anchors_set[0])
    assert not bool(out.child_to_child[0])


def test_filter_bonds_settled_gate_is_exact():
    """filter_bonds skips its prune on settled tables (no bond touched
    within 2 steps) through a lax.cond. Assert the skip is EXACT: at every
    step of the reference scenario's first two division waves, the gated
    pass equals the ungated prune applied to the same state — i.e. the
    prune really is a fixed point once the table settles."""
    from sphsim import Simulation
    from sphsim.biology.bonds import _filter_bonds_active, filter_bonds
    from sphsim.engine.config import reference_genome, reference_scene_params

    params = reference_scene_params(capacity=32).replace(
        dt=1 / 60, max_splits_per_step=8, max_bonds=128)
    sim = Simulation(reference_genome(), params, auto_grow=False)

    # Windows: around both division waves (bond churn) and deep-settled.
    windows = (
        set(range(296, 314)) | set(range(596, 614)) | set(range(450, 456))
    )
    checked_settled = checked_dirty = 0
    for t in range(614):
        if t in windows:
            st = sim.state
            gated = filter_bonds(st)
            full = _filter_bonds_active(st)
            np.testing.assert_array_equal(
                np.asarray(gated.active), np.asarray(full.active),
                err_msg=f"step {t}",
            )
            if bool(jnp.any(st.bonds.active
                            & (st.bonds.created_step
                               >= st.step_count - 2))):
                checked_dirty += 1
            elif int(jnp.sum(st.bonds.active)) > 0:
                checked_settled += 1
        sim.step(1)

    assert checked_dirty >= 2      # prune actually ran around divisions
    assert checked_settled >= 2    # and the settled no-op claim was tested


def test_drop_only_division_reopens_filter_gate():
    """A division where NO child keeps adhesion only DROPS the parent's
    bonds (no rewrite, no insert). Dropping a mixed C↔A bond strips its
    group's prune exemption, so filter_bonds' settled-gate must reopen
    and prune the group that frame (the reference runs FilterBonds every
    frame, CAM:72-75). Regression: the gate used to key on ACTIVE stamped
    bonds only, so a drop-only division left the gate shut and the
    stale-exempt group alive forever."""
    from sphsim.biology.bonds import filter_bonds, handle_cell_split

    params = SimParams(capacity=8)
    st = SimState.zeros(8, params)
    # X=slot0/uid1 bonded to: Y=slot1/uid2 (X-side ZoneA, Y-side ZoneC —
    # the MIXED bond exempting X's ZoneA group), Z=slot2/uid3 (dist 3),
    # W=slot3/uid4 (dist 5). Without the exemption, the (X, ZoneA) group
    # keeps only its shortest member (the X↔Z bond).
    pos = st.pos.at[1].set(jnp.array([0.0, 2.0, 0.0]))
    pos = pos.at[2].set(jnp.array([3.0, 0.0, 0.0]))
    pos = pos.at[3].set(jnp.array([5.0, 0.0, 0.0]))
    st = st.replace_fields(pos=pos, active_count=jnp.int32(5),
                           step_count=jnp.int32(10))
    b = st.bonds
    b = make_bond(b, 0, 1, 2, 0, 1, ZONE_A, ZONE_C, created_step=0)
    b = make_bond(b, 1, 1, 3, 0, 2, ZONE_A, ZONE_A, created_step=0)
    b = make_bond(b, 2, 1, 4, 0, 3, ZONE_A, ZONE_A, created_step=0)

    # Settled table: the gate is shut and the exemption holds all 3 alive.
    pre = filter_bonds(st.replace_fields(bonds=b))
    np.testing.assert_array_equal(np.asarray(pre.active)[:3],
                                  [True, True, True])

    # Y (uid 2) divides; neither child keeps adhesion — pure drop.
    b2, dropped = handle_cell_split(
        b, st.rot,
        parent_uid=jnp.int32(2), uid_a=jnp.int32(10), uid_b=jnp.int32(11),
        slot_a=jnp.int32(1), slot_b=jnp.int32(4),
        keep_a=jnp.bool_(False), keep_b=jnp.bool_(False),
        make_adhesion=jnp.bool_(False), step_count=jnp.int32(10),
    )
    assert int(dropped) == 0
    assert not bool(b2.active[0])          # the mixed bond was dropped
    out = filter_bonds(st.replace_fields(bonds=b2))
    # The gate reopened and the un-exempted group was pruned to its
    # shortest member: X↔Z stays, X↔W goes.
    assert bool(out.active[1])
    assert not bool(out.active[2])


def test_adhesion_flags_come_from_child_a_mode():
    """The reference reads particleData[parentIndex].modeIndex AFTER the
    parent slot was overwritten with childAModeIndex (cs:857 write,
    cs:933 read), so HandleCellSplit's keep/make flags come from CHILD A's
    mode, not the parent's. Regression: with parent mode 0 (all flags
    False) transitioning child A to mode 1 (all flags True), the parent's
    bond must be inherited and the A↔B bond created."""
    from sphsim.biology.division import process_pending_splits, queue_splits

    genome = Genome((
        GenomeMode(is_initial=True, split_interval=1.0,
                   parent_make_adhesion=False,
                   child_a_mode_index=1, child_b_mode_index=1,
                   child_a_keep_adhesion=False,
                   child_b_keep_adhesion=False),
        GenomeMode(split_interval=9.0, parent_make_adhesion=True,
                   child_a_mode_index=1, child_b_mode_index=1,
                   child_a_keep_adhesion=True, child_b_keep_adhesion=True),
    )).validate_for_simulation()
    gd = genome.to_device()
    params = SimParams(dt=0.5, capacity=8, max_splits_per_step=4,
                       max_bonds=16)
    st = SimState.zeros(8, params).replace_fields(
        pos=jnp.zeros((8, 3)).at[1].set(jnp.array([3.0, 0.0, 0.0])),
        mode=jnp.zeros(8, jnp.int32),
        uid=jnp.arange(1, 9, dtype=jnp.int32),
        next_uid=jnp.int32(9),
        active_count=jnp.int32(2),
        split_timer=jnp.asarray([0.99, 0.0] + [0.0] * 6, jnp.float32),
        step_count=jnp.int32(10),
    )
    # Parent (uid 1, slot 0) bonded to neighbor (uid 2, slot 1); parent
    # side ZoneB → inherited by child A iff keep_a.
    st = st.replace_fields(
        bonds=make_bond(st.bonds, 0, 1, 2, 0, 1, ZONE_B, ZONE_A,
                        created_step=0)
    )
    st = queue_splits(st, params, gd)
    assert int(st.pending.count) == 1
    out = process_pending_splits(st, params, gd)
    b = out.bonds
    active = np.asarray(b.active)
    ua, ub = np.asarray(b.uid_a), np.asarray(b.uid_b)
    pairs = {(int(ua[i]), int(ub[i])) for i in range(len(active))
             if active[i]}
    # Child A (uid 9) inherited the ZoneB bond to uid 2 (keep_a from
    # MODE 1), and the A↔B bond (9, 10) exists (make_adhesion from MODE 1).
    assert (9, 2) in pairs, pairs
    assert (9, 10) in pairs, pairs
