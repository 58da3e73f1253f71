"""In-run failure detection + recovery (SURVEY §5.3, engine/recovery.py):
fault injection mid-run, halt-with-dump, rollback-and-retry for transient
faults, and determinism of the restored state."""

import numpy as np
import jax.numpy as jnp
import pytest

from sphsim import Simulation
from sphsim.engine.config import reference_genome, reference_scene_params
from sphsim.engine.recovery import GuardedRun, SimulationFault, fault_flag


def small_params(**kw):
    base = reference_scene_params(capacity=16).replace(
        dt=0.5, max_splits_per_step=8, max_bonds=64,
    )
    return base.replace(**kw) if kw else base


def make_sim():
    return Simulation(reference_genome(), small_params())


def nan_injector(at_step):
    """Corrupt one velocity lane once, the first time step_count >= at."""
    fired = []

    def inject(sim, step):
        if not fired and step >= at_step:
            fired.append(step)
            sim.state = sim.state.replace_fields(
                vel=sim.state.vel.at[0, 0].set(jnp.float32(np.nan))
            )
    return inject


def test_fault_flag_clean_and_nan():
    sim = make_sim()
    sim.step(3)
    assert int(fault_flag(sim.state)) == 0
    bad = sim.state.replace_fields(
        vel=sim.state.vel.at[0, 1].set(jnp.float32(np.inf))
    )
    assert int(fault_flag(bad)) == 1
    # Non-finite garbage in INACTIVE rows is not a fault.
    n = int(sim.state.active_count)
    pad_bad = sim.state.replace_fields(
        vel=sim.state.vel.at[n + 2, 0].set(jnp.float32(np.nan))
    )
    assert int(fault_flag(pad_bad)) == 0


def test_halt_restores_last_good_and_dumps(tmp_path):
    sim = make_sim()
    dump = str(tmp_path / "crash.npz")
    guard = GuardedRun(sim, chunk=4, policy="halt", dump_path=dump,
                       inject=nan_injector(at_step=9))
    with pytest.raises(SimulationFault) as ei:
        guard.run(20)
    # Injection arms at the step-12 chunk boundary (first boundary with
    # step_count >= 9); the 12->16 chunk faults; restored to 12.
    assert int(sim.state.step_count) == ei.value.good_step == 12
    assert int(fault_flag(sim.state)) == 0
    # Crash dump holds the FAULTED state for post-mortem.
    post = Simulation.load(dump)
    assert int(fault_flag(post.state)) == 1
    assert ei.value.dump_path == dump
    # The restored sim keeps stepping cleanly.
    sim.step(4)
    assert int(fault_flag(sim.state)) == 0


def test_rollback_recovers_transient_fault(tmp_path):
    sim = make_sim()
    guard = GuardedRun(sim, chunk=4, policy="rollback",
                       dump_path=str(tmp_path / "c.npz"),
                       inject=nan_injector(at_step=9))  # fires ONCE
    guard.run(20)                       # retry after rollback succeeds
    assert int(sim.state.step_count) == 20
    assert int(fault_flag(sim.state)) == 0
    assert len(guard.faults) == 1
    # The recovered trajectory equals an uninjected run (deterministic
    # step + rollback to the exact chunk boundary).
    ref = make_sim()
    ref.step(20)
    np.testing.assert_array_equal(np.asarray(ref.state.pos),
                                  np.asarray(sim.state.pos))


def test_rollback_halts_on_permanent_fault(tmp_path):
    sim = make_sim()

    def always_inject(s, step):
        if step >= 8:
            s.state = s.state.replace_fields(
                vel=s.state.vel.at[0, 0].set(jnp.float32(np.nan))
            )

    guard = GuardedRun(sim, chunk=4, policy="rollback", dump_path=None,
                       max_retries=2, inject=always_inject)
    with pytest.raises(SimulationFault, match="reproduced"):
        guard.run(20)
    assert int(sim.state.step_count) == 8   # left at the last good state
    assert len(guard.faults) == 3           # initial + 2 retries
