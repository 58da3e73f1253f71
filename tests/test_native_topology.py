"""JAX topology passes vs the native C++ golden core.

Division slot policy, uid allocation, bond inheritance, zone
classification/anchors, and the per-side FilterBonds prune are re-derived
in scalar C++ (native/golden.cpp) and must agree with the JAX engine —
the topology analog of the kernel oracles in test_native_golden.py
(SURVEY §4 item 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sphsim.biology.bonds import filter_bonds, update_bond_zones
from sphsim.biology.division import process_pending_splits, queue_splits
from sphsim.core import quat
from sphsim.core.types import (
    BondTable, Genome, GenomeMode, SimParams, SimState,
)
from sphsim.native import (
    filter_bonds_native,
    process_splits_native,
    queue_splits_native,
    update_bond_zones_native,
)

ATOL = 2e-5


def make_mode(**kw):
    base = dict(
        mode_name="m", split_interval=5.0, is_initial=False,
        parent_make_adhesion=False, mode_color=(1, 1, 1, 1),
        parent_split_yaw=0.0, parent_split_pitch=0.0,
        child_a_mode_index=0, child_a_orientation_yaw=0.0,
        child_a_orientation_pitch=0.0, child_a_keep_adhesion=False,
        child_b_mode_index=0, child_b_orientation_yaw=0.0,
        child_b_orientation_pitch=0.0, child_b_keep_adhesion=False,
        adhesion_rest_length=2.96, adhesion_spring_stiffness=200.0,
        adhesion_spring_damping=0.0, orientation_constraint_strength=0.493,
        max_allowed_angle_deviation=0.0,
    )
    base.update(kw)
    return GenomeMode(**base)


def rich_genome():
    """Three modes exercising every inheritance branch: keep-A-only,
    keep-B-only, keep-both + parentMakeAdhesion, with distinct split
    directions and child-mode remaps (incl. an out-of-range index that must
    fall back to the parent mode)."""
    return Genome((
        make_mode(split_interval=4.0, is_initial=True,
                  parent_make_adhesion=True, parent_split_yaw=15.0,
                  parent_split_pitch=30.0, child_a_mode_index=1,
                  child_a_orientation_yaw=90.0, child_a_keep_adhesion=True,
                  child_b_mode_index=2, child_b_orientation_pitch=45.0,
                  child_b_keep_adhesion=True),
        make_mode(split_interval=6.0, parent_split_yaw=-40.0,
                  child_a_mode_index=-1, child_a_keep_adhesion=True,
                  child_b_mode_index=0),
        make_mode(split_interval=5.0, parent_split_pitch=-25.0,
                  child_a_mode_index=7,  # out of range -> inherit parent
                  child_b_mode_index=1, child_b_keep_adhesion=True,
                  parent_make_adhesion=True),
    )).validate_for_simulation()


def random_colony(n=24, active=17, seed=0, n_bonds=48, params=None):
    params = params or SimParams(capacity=n, max_bonds=n_bonds)
    k = jax.random.split(jax.random.PRNGKey(seed), 8)
    st = SimState.zeros(n, params)
    q = quat.normalize(jax.random.normal(k[0], (n, 4)))
    st = st.replace_fields(
        pos=jax.random.uniform(k[1], (n, 3), minval=-8.0, maxval=8.0),
        vel=jax.random.normal(k[2], (n, 3)),
        ang_vel=jax.random.normal(k[3], (n, 3)) * 0.3,
        rot=q,
        radius=jax.random.uniform(k[4], (n,), minval=1.5, maxval=2.5),
        mass=jax.random.uniform(k[5], (n,), minval=0.5, maxval=2.0),
        mode=jax.random.randint(k[6], (n,), -1, 4),  # incl. invalid modes
        split_timer=jax.random.uniform(k[7], (n,), minval=3.4, maxval=6.2),
        uid=jnp.arange(n, dtype=jnp.int32),
        next_uid=jnp.int32(n),
        active_count=jnp.int32(active),
        step_count=jnp.int32(100),
    )
    return st, params


def random_bonds(st, seed=0, n_active=20):
    """Random bond table over the active cells, all zone combinations."""
    B = st.bonds.capacity
    n = int(st.active_count)
    k = jax.random.split(jax.random.PRNGKey(seed + 77), 6)
    sa = jax.random.randint(k[0], (B,), 0, n)
    sb = (sa + jax.random.randint(k[1], (B,), 1, n)) % n
    active = jnp.arange(B) < n_active
    b = st.bonds.replace_fields(
        active=active,
        slot_a=sa.astype(jnp.int32), slot_b=sb.astype(jnp.int32),
        uid_a=st.uid[sa], uid_b=st.uid[sb],
        zone_a=jax.random.randint(k[2], (B,), 0, 3),
        zone_b=jax.random.randint(k[3], (B,), 0, 3),
        # Random ages, but pin rows 0-2 so every run covers the three
        # young-bond cases: anchor-set step (created+1 == now), same-step
        # creation, and a settled bond (seeded draws can miss 99 entirely).
        created_step=jnp.asarray(
            jax.random.randint(k[4], (B,), 90, 101)
        ).at[0].set(99).at[1].set(100).at[2].set(95),
        rel_orientation=quat.normalize(jax.random.normal(k[5], (B, 4))),
    )
    return st.replace_fields(bonds=b)


def assert_bonds_equal(b_jax: BondTable, b_nat: dict):
    np.testing.assert_array_equal(
        np.asarray(b_jax.active).astype(np.uint8), b_nat["active"],
        err_msg="active")
    for f in ("uid_a", "uid_b", "slot_a", "slot_b", "zone_a", "zone_b",
              "created_step"):
        # Inactive rows may hold unwritten scratch; compare active rows.
        m = b_nat["active"] > 0
        np.testing.assert_array_equal(
            np.asarray(getattr(b_jax, f))[m], b_nat[f][m], err_msg=f)
    m = b_nat["active"] > 0
    np.testing.assert_array_equal(
        np.asarray(b_jax.child_to_child).astype(np.uint8)[m],
        b_nat["child_to_child"][m], err_msg="child_to_child")
    np.testing.assert_array_equal(
        np.asarray(b_jax.anchors_set).astype(np.uint8)[m],
        b_nat["anchors_set"][m], err_msg="anchors_set")
    for f in ("rel_orientation", "anchor_a", "anchor_b"):
        np.testing.assert_allclose(
            np.asarray(getattr(b_jax, f))[m], b_nat[f][m], atol=ATOL,
            err_msg=f)


def compare_queue(st, params, gd):
    out_j = queue_splits(st, params, gd)
    timer_n, p_n = queue_splits_native(st, params, gd)
    np.testing.assert_allclose(
        np.asarray(out_j.split_timer), timer_n, atol=1e-6)
    pj = out_j.pending
    assert int(pj.count) == p_n["count"]
    c = p_n["count"]
    np.testing.assert_array_equal(np.asarray(pj.parent_slot)[:c],
                                  p_n["parent_slot"][:c])
    for f in ("mode_a", "mode_b", "parent_mode"):
        np.testing.assert_array_equal(np.asarray(getattr(pj, f))[:c],
                                      p_n[f][:c], err_msg=f)
    for f in ("pos_a", "pos_b", "vel_a", "vel_b", "rot_a", "rot_b"):
        np.testing.assert_allclose(np.asarray(getattr(pj, f))[:c],
                                   p_n[f][:c], atol=ATOL, err_msg=f)
    return out_j


def compare_process(st, params, gd):
    out_j = process_pending_splits(st, params, gd)
    out_n = process_splits_native(st, gd)
    assert int(out_j.active_count) == out_n["active_count"]
    assert int(out_j.next_uid) == out_n["next_uid"]
    assert int(out_j.overflow) - int(st.overflow) == out_n["overflow"]
    for f in ("mode", "uid", "parent_uid", "child_type"):
        np.testing.assert_array_equal(
            np.asarray(getattr(out_j, f)), out_n[f], err_msg=f)
    for f in ("pos", "vel", "rot", "ang_vel", "radius", "mass", "inertia",
              "drag", "repulsion", "split_timer"):
        np.testing.assert_allclose(
            np.asarray(getattr(out_j, f)), out_n[f], atol=ATOL, err_msg=f)
    assert_bonds_equal(out_j.bonds, out_n["bonds"])
    return out_j


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_queue_splits_matches(seed):
    gd = rich_genome().to_device()
    st, params = random_colony(seed=seed)
    compare_queue(st, params, gd)


def test_queue_splits_capacity_cap():
    """More ready cells than free slots: queue caps, timers still reset."""
    gd = rich_genome().to_device()
    st, params = random_colony(n=16, active=14, seed=5)
    st = st.replace_fields(
        split_timer=jnp.full(16, 10.0),     # everyone past every interval
        mode=jnp.zeros(16, jnp.int32),
    )
    out = compare_queue(st, params, gd)
    assert int(out.pending.count) == 2      # only 2 free slots
    assert float(jnp.max(out.split_timer[:14])) == 0.0


@pytest.mark.parametrize("seed", [0, 3])
def test_process_splits_matches(seed):
    """Queued splits + a bond table touching the parents in every zone."""
    gd = rich_genome().to_device()
    st, params = random_colony(seed=seed)
    st = random_bonds(st, seed=seed)
    st = queue_splits(st, params, gd)
    assert int(st.pending.count) > 0
    compare_process(st, params, gd)


def test_process_splits_bond_overflow_matches():
    """Bond capacity too small for the ZoneC duplications + A<->B inserts:
    both implementations must drop the same inserts and count them."""
    gd = rich_genome().to_device()
    # A FULL bond table (n_active == capacity): inserts can only use slots
    # freed by the same split's drops, so duplications overflow. (Seed 0
    # overflows under the child-A-mode flag sourcing; the old seed-7/23
    # setup only overflowed under the pre-fix parent-mode flags.)
    st, params = random_colony(
        n=24, active=17, seed=0,
        params=SimParams(capacity=24, max_bonds=24),
    )
    st = random_bonds(st, seed=0, n_active=24)
    st = queue_splits(st, params, gd)
    assert int(st.pending.count) > 0
    out = compare_process(st, params, gd)
    assert int(out.overflow) > 0


def test_process_splits_chain_through_bond_table():
    """Multiple splits in one step chain sequentially: a bond rewritten by
    split k is visible to split k+1 (the reference's in-order loop)."""
    gd = rich_genome().to_device()
    st, params = random_colony(n=32, active=10, seed=11)
    # Two ready parents bonded to each other (uid match on both ends).
    st = st.replace_fields(
        split_timer=jnp.where(jnp.arange(32) < 2, 10.0, 0.0),
        mode=jnp.zeros(32, jnp.int32),
    )
    b = st.bonds.replace_fields(
        active=jnp.arange(st.bonds.capacity) < 1,
        slot_a=jnp.full(st.bonds.capacity, 0, jnp.int32),
        slot_b=jnp.full(st.bonds.capacity, 1, jnp.int32),
        uid_a=jnp.full(st.bonds.capacity, 0, jnp.int32),
        uid_b=jnp.full(st.bonds.capacity, 1, jnp.int32),
        zone_a=jnp.full(st.bonds.capacity, 2, jnp.int32),
        zone_b=jnp.full(st.bonds.capacity, 2, jnp.int32),
        created_step=jnp.full(st.bonds.capacity, 50, jnp.int32),
    )
    st = st.replace_fields(bonds=b)
    st = queue_splits(st, params, gd)
    assert int(st.pending.count) == 2
    compare_process(st, params, gd)


@pytest.mark.parametrize("seed", [0, 4])
def test_update_bond_zones_matches(seed):
    gd = rich_genome().to_device()
    st, params = random_colony(seed=seed)
    st = random_bonds(st, seed=seed)
    # Mix of young bonds (zone/anchor refresh) and settled ones (untouched):
    # created_step in [90, 100], step_count 100 -> rows at 99/100 are young,
    # rows at 100 exactly get anchors.
    out_j = update_bond_zones(st, params, gd)
    out_n = update_bond_zones_native(st, params, gd)
    assert_bonds_equal(out_j, out_n)
    assert int(jnp.sum(out_j.anchors_set)) > 0


@pytest.mark.parametrize("seed", [0, 5])
def test_filter_bonds_matches(seed):
    gd = rich_genome().to_device()
    st, params = random_colony(seed=seed)
    st = random_bonds(st, seed=seed, n_active=32)
    out_j = filter_bonds(st)
    act_n = filter_bonds_native(st)
    np.testing.assert_array_equal(
        np.asarray(out_j.active).astype(np.uint8), act_n)
    assert int(jnp.sum(out_j.active)) < 32  # something was pruned


def test_filter_bonds_tie_keeps_lowest_index():
    """Two equal-length bonds in one (cell, zone) A-side group: the lowest
    bond index survives (the reference's stable OrderBy keeps list order)."""
    st, params = random_colony(n=8, active=8, seed=9)
    pos = jnp.zeros((8, 3)).at[1].set([3.0, 0, 0]).at[2].set([0, 3.0, 0])
    st = st.replace_fields(pos=pos)
    B = st.bonds.capacity
    b = st.bonds.replace_fields(
        active=jnp.arange(B) < 2,
        slot_a=jnp.zeros(B, jnp.int32),
        slot_b=jnp.where(jnp.arange(B) == 0, 1, 2).astype(jnp.int32),
        uid_a=jnp.zeros(B, jnp.int32),
        uid_b=jnp.where(jnp.arange(B) == 0, 1, 2).astype(jnp.int32),
        zone_a=jnp.zeros(B, jnp.int32),
        zone_b=jnp.zeros(B, jnp.int32),
        # Eligible (created < step) and inside the settled-gate window
        # (created >= step − 2): hand-built rows bypass the stamping paths.
        created_step=jnp.full(B, 99, jnp.int32),
    )
    st = st.replace_fields(bonds=b)
    out_j = filter_bonds(st)
    act_n = filter_bonds_native(st)
    np.testing.assert_array_equal(
        np.asarray(out_j.active).astype(np.uint8), act_n)
    assert bool(out_j.active[0]) and not bool(out_j.active[1])


def test_reference_scenario_topology_sequence():
    """Drive the reference scenario through its first two division waves and
    cross-check every topology pass against the C++ oracle on the live
    states (the golden-trace scenario, now validated by an independent
    implementation rather than a self-regression)."""
    from sphsim import Simulation
    from sphsim.engine.config import reference_genome, reference_scene_params

    params = reference_scene_params(capacity=32).replace(
        dt=1 / 60, max_splits_per_step=8, max_bonds=128)
    sim = Simulation(reference_genome(), params, auto_grow=False)
    gd = sim.genome_dev

    windows = set(range(296, 312)) | set(range(596, 612))
    checked_split = 0
    for t in range(612):
        if t in windows:
            st = sim.state
            out_q = compare_queue(st, params, gd)
            if int(out_q.pending.count) > 0:
                compare_process(out_q, params, gd)
                checked_split += 1
            out_z = update_bond_zones(st, params, gd)
            out_zn = update_bond_zones_native(st, params, gd)
            assert_bonds_equal(out_z, out_zn)
            act_n = filter_bonds_native(st)
            np.testing.assert_array_equal(
                np.asarray(filter_bonds(st).active).astype(np.uint8), act_n)
        sim.step(1)

    assert checked_split >= 2           # both division waves exercised
    assert int(sim.metrics()["active_particles"]) >= 4
    assert int(sim.metrics()["bond_count"]) >= 2
