"""Adhesion constraint tests (K10/K11 parity, DESIGN.md §4)."""

import jax.numpy as jnp
import numpy as np

from sphsim.core import quat
from sphsim.core.types import Genome, GenomeMode, SimParams, SimState
from sphsim.physics.adhesion import apply_adhesion, bond_deltas


def make_genome(rest=3.0, stiff=100.0, damp=5.0, orient=0.5):
    return Genome((
        GenomeMode(
            is_initial=True,
            adhesion_rest_length=rest,
            adhesion_spring_stiffness=stiff,
            adhesion_spring_damping=damp,
            orientation_constraint_strength=orient,
        ),
    )).validate_for_simulation()


def bonded_pair(params, pos_b=(5.0, 0.0, 0.0), vel_b=(0.0, 0.0, 0.0),
                rot_a=None, rot_b=None, rel=None, anchors=None):
    st = SimState.zeros(4, params)
    st = st.replace_fields(
        pos=st.pos.at[1].set(jnp.asarray(pos_b, jnp.float32)),
        vel=st.vel.at[1].set(jnp.asarray(vel_b, jnp.float32)),
        mass=jnp.full(4, 2.0),
        active_count=jnp.int32(2),
        uid=st.uid.at[0].set(0).at[1].set(1),
    )
    if rot_a is not None:
        st = st.replace_fields(rot=st.rot.at[0].set(rot_a))
    if rot_b is not None:
        st = st.replace_fields(rot=st.rot.at[1].set(rot_b))
    b = st.bonds
    b = b.replace_fields(
        active=b.active.at[0].set(True),
        uid_a=b.uid_a.at[0].set(0),
        uid_b=b.uid_b.at[0].set(1),
        slot_a=b.slot_a.at[0].set(0),
        slot_b=b.slot_b.at[0].set(1),
    )
    if rel is not None:
        b = b.replace_fields(rel_orientation=b.rel_orientation.at[0].set(rel))
    if anchors is not None:
        b = b.replace_fields(
            anchor_a=b.anchor_a.at[0].set(jnp.asarray(anchors[0], jnp.float32)),
            anchor_b=b.anchor_b.at[0].set(jnp.asarray(anchors[1], jnp.float32)),
            anchors_set=b.anchors_set.at[0].set(True),
        )
    return st.replace_fields(bonds=b)


def test_spring_force_hand_computed():
    # dist=5, rest=3 ⇒ |F| = 2·100 = 200 pulling together; mass 2, dt=0.01:
    # Δv_A = F/m·dt = (200/2)·0.01 = +1 x̂, Δv_B = −1 x̂.
    params = SimParams(dt=0.01, enable_anchor_constraints=False)
    genome = make_genome(rest=3.0, stiff=100.0, damp=0.0)
    st = bonded_pair(params)
    dv, dq = bond_deltas(st, params, genome.to_device())
    np.testing.assert_allclose(dv[0], [1.0, 0, 0], atol=1e-5)
    np.testing.assert_allclose(dv[1], [-1.0, 0, 0], atol=1e-5)
    np.testing.assert_allclose(dq, 0.0, atol=1e-7)


def test_spring_damping():
    # B receding at +1 x̂: damping adds dir·(relVel·dir)·c = +5 x̂ to F.
    params = SimParams(dt=0.01, enable_anchor_constraints=False)
    genome = make_genome(rest=3.0, stiff=100.0, damp=5.0)
    st = bonded_pair(params, vel_b=(1.0, 0.0, 0.0))
    dv, _ = bond_deltas(st, params, genome.to_device())
    np.testing.assert_allclose(dv[0], [(200 + 5) / 2 * 0.01, 0, 0], atol=1e-5)


def test_spring_momentum_conservation():
    params = SimParams(dt=0.01, enable_anchor_constraints=False)
    genome = make_genome()
    st = bonded_pair(params, pos_b=(4.2, 1.0, -0.5), vel_b=(0.3, -0.2, 0.1))
    dv, _ = bond_deltas(st, params, genome.to_device())
    # Equal masses ⇒ Δp cancels.
    np.testing.assert_allclose(dv[0] + dv[1], 0.0, atol=1e-6)


def test_orientation_constraint_restores_rel_orientation():
    # B twisted 0.2 rad about x vs captured identity rel orientation:
    # correction splits ±½ between the two (compute:541-583).
    params = SimParams(dt=0.01, enable_anchor_constraints=True)
    genome = make_genome(orient=0.5)
    twist = quat.from_axis_angle(jnp.array([1.0, 0.0, 0.0]), 0.2)
    st = bonded_pair(params, rot_b=twist, rel=quat.IDENTITY)
    st2 = apply_adhesion(st, params, genome.to_device())
    # Relative angle between A and B must shrink.
    rel_before = quat.mul(quat.conjugate(st.rot[0]), st.rot[1])
    rel_after = quat.mul(quat.conjugate(st2.rot[0]), st2.rot[1])
    ang_before = 2 * np.arccos(np.clip(abs(float(rel_before[3])), 0, 1))
    ang_after = 2 * np.arccos(np.clip(abs(float(rel_after[3])), 0, 1))
    assert ang_after < ang_before


def test_anchor_constraint_swings_anchors_together():
    # Anchors on opposite sides (pointing away from each other): the swing
    # constraint should rotate both to bring anchor points closer.
    params = SimParams(dt=0.01, enable_anchor_constraints=True)
    genome = make_genome(orient=0.5)
    st = bonded_pair(
        params, pos_b=(3.0, 0.0, 0.0),
        anchors=((0.0, 1.0, 0.0), (0.0, -1.0, 0.0)),
        rel=quat.IDENTITY,
    )
    b = st.bonds

    def anchor_gap(state):
        a = state.pos[0] + quat.rotate(state.rot[0], b.anchor_a[0])
        c = state.pos[1] + quat.rotate(state.rot[1], b.anchor_b[0])
        return float(jnp.linalg.norm(c - a))

    gap0 = anchor_gap(st)
    st2 = apply_adhesion(st, params, genome.to_device())
    assert anchor_gap(st2) < gap0


def test_quaternions_stay_normalized():
    params = SimParams(dt=0.05, enable_anchor_constraints=True)
    genome = make_genome()
    twist = quat.from_axis_angle(jnp.array([0.3, 0.5, 0.8]) / jnp.sqrt(0.98), 0.7)
    st = bonded_pair(params, rot_b=twist, rel=quat.IDENTITY,
                     anchors=((0.0, 1.0, 0.0), (1.0, 0.0, 0.0)))
    for _ in range(10):
        st = apply_adhesion(st, params, genome.to_device())
    norms = jnp.linalg.norm(st.rot[:2], axis=-1)
    np.testing.assert_allclose(norms, 1.0, atol=1e-5)


def test_mode_quirk_uid_modulo():
    # Spring params come from mode (uid_A % n_modes), NOT the cell's mode
    # (CellAdhesionManager.cs:537).
    params = SimParams(dt=0.01, enable_anchor_constraints=False)
    g = Genome((
        GenomeMode(is_initial=True, adhesion_rest_length=3.0,
                   adhesion_spring_stiffness=100.0, adhesion_spring_damping=0.0),
        GenomeMode(adhesion_rest_length=5.0, adhesion_spring_stiffness=10.0,
                   adhesion_spring_damping=0.0),
    )).validate_for_simulation()
    st = bonded_pair(params)
    # uid_a = 0 ⇒ mode 0 regardless of particle modes.
    st = st.replace_fields(mode=st.mode.at[0].set(1).at[1].set(1))
    dv, _ = bond_deltas(st, params, g.to_device())
    np.testing.assert_allclose(dv[0], [1.0, 0, 0], atol=1e-5)  # mode-0 params

    # uid_a = 1 ⇒ mode 1: |F| = (5−5)·10 = 0 at dist 5.
    b = st.bonds.replace_fields(uid_a=st.bonds.uid_a.at[0].set(1))
    st2 = st.replace_fields(bonds=b)
    dv2, _ = bond_deltas(st2, params, g.to_device())
    np.testing.assert_allclose(dv2[0], 0.0, atol=1e-6)


def test_inactive_bond_no_effect():
    params = SimParams(dt=0.01)
    genome = make_genome()
    st = bonded_pair(params)
    b = st.bonds.replace_fields(active=st.bonds.active.at[0].set(False))
    st = st.replace_fields(bonds=b)
    dv, dq = bond_deltas(st, params, genome.to_device())
    np.testing.assert_allclose(dv, 0.0)
    np.testing.assert_allclose(dq, 0.0)


# --- Planned (settled-window) accumulation ------------------------------

def test_planned_accumulate_matches_segment_sum():
    """accumulate_bond_deltas_planned == accumulate_bond_deltas on random
    rows/topologies, including a stale-validity plan (bonds deactivated
    AFTER the plan was built contribute zeros through the deltas' validity
    gating, so bond_deltas(plan=stale) must still be exact)."""
    import jax

    from sphsim.core.types import BondTable
    from sphsim.physics.adhesion import (
        accumulate_bond_deltas,
        accumulate_bond_deltas_planned,
        build_bond_plan,
    )

    rng = np.random.default_rng(7)
    N, B = 300, 1024
    slot_a = rng.integers(-1, N, B).astype(np.int32)
    slot_b = rng.integers(0, N, B).astype(np.int32)
    active = rng.random(B) < 0.8
    bonds = BondTable.empty(B)
    bonds = bonds.replace_fields(
        active=jnp.asarray(active), slot_a=jnp.asarray(slot_a),
        slot_b=jnp.asarray(slot_b),
    )
    plan = jax.jit(lambda bb: build_bond_plan(bb, N))(bonds)

    valid = active & (slot_a >= 0) & (slot_b >= 0)
    mk = lambda w: jnp.asarray(  # noqa: E731
        np.where(valid[:, None],
                 rng.normal(size=(B, w)).astype(np.float32), 0.0))
    dv_a, dq_a, dv_b, dq_b = mk(3), mk(4), mk(3), mk(4)
    seg_a = jnp.asarray(np.where(valid, np.clip(slot_a, 0, N - 1), N))
    seg_b = jnp.asarray(np.where(valid, np.clip(slot_b, 0, N - 1), N))
    want_v, want_q = accumulate_bond_deltas(
        dv_a, dq_a, dv_b, dq_b, seg_a, seg_b, N)
    got_v, got_q = jax.jit(
        lambda *r: accumulate_bond_deltas_planned(*r, plan)
    )(dv_a, dq_a, dv_b, dq_b)
    np.testing.assert_allclose(got_v, want_v, rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(got_q, want_q, rtol=2e-5, atol=1e-6)

    # Stale plan: prune some bonds after building; their rows must now be
    # zero (the engine's validity gating) and the sums must match a fresh
    # segment_sum of the pruned table.
    keep = rng.random(B) < 0.6
    valid2 = valid & keep
    z = lambda a: jnp.where(jnp.asarray(valid2)[:, None], a, 0.0)  # noqa: E731
    seg_a2 = jnp.asarray(np.where(valid2, np.clip(slot_a, 0, N - 1), N))
    seg_b2 = jnp.asarray(np.where(valid2, np.clip(slot_b, 0, N - 1), N))
    want_v2, want_q2 = accumulate_bond_deltas(
        z(dv_a), z(dq_a), z(dv_b), z(dq_b), seg_a2, seg_b2, N)
    got_v2, got_q2 = jax.jit(
        lambda *r: accumulate_bond_deltas_planned(*r, plan)
    )(z(dv_a), z(dq_a), z(dv_b), z(dq_b))
    np.testing.assert_allclose(got_v2, want_v2, rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(got_q2, want_q2, rtol=2e-5, atol=1e-6)


def test_use_bond_plan_threshold_boundary():
    """The auto crossover sits exactly at the threshold capacity 163,840:
    one row below auto stays plain, at/above it goes planned, and the
    explicit modes override in both directions."""
    import dataclasses

    from sphsim.engine.colony import bonded_colony
    from sphsim.engine.step import use_bond_plan

    state, params, _ = bonded_colony(
        128, neighbor_mode="dense", dense_k=2)

    def with_cap(cap):
        b = state.bonds
        pad = lambda x: jnp.concatenate(  # noqa: E731
            [x, jnp.zeros((cap - x.shape[0],) + x.shape[1:], x.dtype)])
        return state.replace_fields(
            bonds=type(b)(**{f: pad(getattr(b, f))
                             for f in b.__dataclass_fields__}))

    below, at = with_cap(163839), with_cap(163840)
    assert not use_bond_plan(params, below)
    assert use_bond_plan(params, at)
    p_on = dataclasses.replace(params, adhesion_plan="on")
    p_off = dataclasses.replace(params, adhesion_plan="off")
    assert use_bond_plan(p_on, below)
    assert not use_bond_plan(p_off, at)


def test_planned_run_steps_matches_plain_through_division():
    """run_steps with adhesion_plan='on' (plan carried in the scan,
    rebuilt after division steps) matches the plain path through a window
    with real splits firing — topology exact, floats allclose (the scan
    reassociates each particle's sum)."""
    import dataclasses

    import jax

    from sphsim import Simulation
    from sphsim.engine.colony import bonded_colony
    from sphsim.engine.step import run_steps, use_bond_plan

    state, params, genome = bonded_colony(
        256, neighbor_mode="dense", dense_k=2, max_splits_per_step=32,
        use_pallas=False)
    sim = Simulation(genome, params, auto_grow=False, donate=False)
    sim.state = state
    sim.resize(320)
    pp, gd = sim.params, sim.genome_dev
    timer = sim.state.split_timer.at[:16].set(
        jnp.float32(float(gd.split_interval[0]) - 3 * pp.dt))
    st = sim.state.replace_fields(split_timer=timer)

    p_on = dataclasses.replace(pp, adhesion_plan="on")
    p_off = dataclasses.replace(pp, adhesion_plan="off")
    assert use_bond_plan(p_on, st) and not use_bond_plan(p_off, st)
    a = jax.jit(lambda s: run_steps(s, p_off, gd, 10))(st)
    b = jax.jit(lambda s: run_steps(s, p_on, gd, 10))(st)
    assert int(a.active_count) == 256 + 16 == int(b.active_count)
    na = int(a.active_count)
    for f in ("pos", "vel", "ang_vel", "rot"):
        np.testing.assert_allclose(
            np.asarray(getattr(a, f))[:na], np.asarray(getattr(b, f))[:na],
            rtol=1e-4, atol=1e-4, err_msg=f)
    for f in ("active", "slot_a", "slot_b", "zone_a", "zone_b",
              "created_step"):
        np.testing.assert_array_equal(
            np.asarray(getattr(a.bonds, f)), np.asarray(getattr(b.bonds, f)),
            err_msg=f"bonds.{f}")
    np.testing.assert_array_equal(np.asarray(a.uid), np.asarray(b.uid))


def test_hybrid_accumulate_stale_plan_with_rewrites():
    """accumulate_bond_deltas_hybrid == segment_sum on a table whose slot
    endpoints were REWRITTEN and whose bonds were CREATED after the plan
    snapshot (the division pattern — a plain stale plan would accumulate
    rewritten rows into the wrong particles), and the full-segment_sum
    fallback must engage when the drift exceeds the side capacity."""
    import jax

    import sphsim.physics.adhesion as adh
    from sphsim.core.types import BondTable

    rng = np.random.default_rng(11)
    N, B = 300, 1024
    slot_a = rng.integers(0, N, B).astype(np.int32)
    slot_b = rng.integers(0, N, B).astype(np.int32)
    active = rng.random(B) < 0.7
    bonds0 = BondTable.empty(B).replace_fields(
        active=jnp.asarray(active), slot_a=jnp.asarray(slot_a),
        slot_b=jnp.asarray(slot_b),
    )
    plan = jax.jit(lambda bb: adh.build_bond_plan(bb, N))(bonds0)

    # Post-snapshot topology: rewrite ~50 endpoints, activate ~30 new.
    slot_a2, slot_b2, active2 = slot_a.copy(), slot_b.copy(), active.copy()
    rw = rng.choice(B, 50, replace=False)
    slot_a2[rw] = rng.integers(0, N, 50)
    newb = rng.choice(np.nonzero(~active)[0], 30, replace=False)
    active2[newb] = True
    # and prune some (must be exact through the stale plan, no side needed)
    active2[rng.choice(np.nonzero(active)[0], 40, replace=False)] = False
    bonds1 = bonds0.replace_fields(
        active=jnp.asarray(active2), slot_a=jnp.asarray(slot_a2),
        slot_b=jnp.asarray(slot_b2),
    )

    valid = active2 & (slot_a2 >= 0) & (slot_b2 >= 0)
    mk = lambda w: jnp.asarray(  # noqa: E731
        np.where(valid[:, None],
                 rng.normal(size=(B, w)).astype(np.float32), 0.0))
    dv_a, dq_a, dv_b, dq_b = mk(3), mk(4), mk(3), mk(4)
    seg_a = jnp.asarray(np.where(valid, np.clip(slot_a2, 0, N - 1), N))
    seg_b = jnp.asarray(np.where(valid, np.clip(slot_b2, 0, N - 1), N))
    want_v, want_q = adh.accumulate_bond_deltas(
        dv_a, dq_a, dv_b, dq_b, seg_a, seg_b, N)
    got_v, got_q = jax.jit(
        lambda *r: adh.accumulate_bond_deltas_hybrid(*r, bonds1, N, plan)
    )(dv_a, dq_a, dv_b, dq_b)
    np.testing.assert_allclose(got_v, want_v, rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(got_q, want_q, rtol=2e-5, atol=1e-6)

    n_drift = int(jax.jit(
        lambda bb: adh.plan_changed_count(bb, plan))(bonds1))
    assert 0 < n_drift <= adh._SIDE_CAP

    # Overflow fallback: shrink the side capacity below the drift count.
    orig = adh._SIDE_CAP
    try:
        adh._SIDE_CAP = 16
        got_v2, got_q2 = jax.jit(
            lambda *r: adh.accumulate_bond_deltas_hybrid(*r, bonds1, N, plan)
        )(dv_a, dq_a, dv_b, dq_b)
    finally:
        adh._SIDE_CAP = orig
    np.testing.assert_allclose(got_v2, want_v, rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(got_q2, want_q, rtol=2e-5, atol=1e-6)
