"""In-run failure detection + recovery (SURVEY §5.3).

The reference has NO failure handling beyond `enabled = false` on a bad
genome (ParticleSystemController.cs:224) and an error log on readback
failure (:1125). The rebuild's §5.3 story so far was step-function purity
+ checkpointing (engine/checkpoint.py) so a host loop can restart from
any saved state; this module closes the remaining gap — detection and
recovery DURING a run:

- `fault_flag(state)`: ONE on-device scalar — any non-finite pos/vel/rot,
  or counted cell overflow — evaluated inside jit and fetched with the
  same sync that ends a step chunk (no extra dispatch).
- `GuardedRun`: steps the sim in chunks; after each chunk the flag is
  checked. On fault it writes a crash checkpoint (full pytree, loadable
  with Simulation.load for post-mortem), restores the last good on-device
  snapshot, and applies the policy:
    * "halt" (default): raise SimulationFault — state is left at the last
      good snapshot, crash dump on disk.
    * "rollback": keep running from the snapshot, skipping nothing — for
      TRANSIENT faults (preemption glitches, transfer corruption). The step
      function is deterministic, so a fault that reproduces from the same
      state is permanent; after `max_retries` identical faults the guard
      halts rather than loop forever.
- `inject_nan_at(sim, step)`: test hook — arms a host-side injector that
  corrupts one velocity lane at a given step count, exercising the same
  path a real non-finite blowup would take (tests/test_recovery.py).

Snapshots are DEVICE-side copies (one buffer donate-safe clone per chunk
boundary, no host round trip); crash dumps go through
engine/checkpoint.py's npz format.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


class SimulationFault(RuntimeError):
    """Raised by GuardedRun when a fault is detected. Carries the step
    count of the last GOOD state (the sim is left restored to it) and the
    crash-dump path (state AT the fault, for post-mortem)."""

    def __init__(self, msg: str, good_step: int, dump_path: str | None):
        super().__init__(msg)
        self.good_step = good_step
        self.dump_path = dump_path


def fault_flag(state) -> jnp.ndarray:
    """Scalar i32: 1 iff the state is faulted — any non-finite pos/vel/rot
    among ACTIVE rows, or counted cell overflow this run. Pure/jittable;
    cheap enough to fold into every chunk (three [N,·] isfinite reduces)."""
    alive = (jnp.arange(state.capacity) < state.active_count)[:, None]
    bad = jnp.int32(0)
    for f in (state.pos, state.vel, state.rot):
        bad = bad | jnp.any(~jnp.isfinite(f) & alive).astype(jnp.int32)
    return bad | (state.overflow > 0).astype(jnp.int32)


def _device_copy(state):
    """Snapshot the state pytree on device (no host transfer)."""
    return jax.tree_util.tree_map(
        lambda x: x.copy() if hasattr(x, "copy") else x, state
    )


class GuardedRun:
    """Failure-monitored stepping for a Simulation.

    >>> guard = GuardedRun(sim, chunk=64, policy="halt",
    ...                    dump_path="crash.npz")
    >>> guard.run(10_000)   # raises SimulationFault on NaN/overflow

    policy="rollback" restores the last good snapshot and retries the
    chunk (for transient faults); identical faults `max_retries` times in
    a row halt. The injector hook (`inject`) is called as
    inject(sim, step_count) before each chunk — tests use it to corrupt
    state mid-run."""

    def __init__(self, sim, chunk: int = 64, policy: str = "halt",
                 dump_path: str | None = "crash_dump.npz",
                 max_retries: int = 2, inject=None):
        assert policy in ("halt", "rollback"), policy
        self.sim = sim
        self.chunk = int(chunk)
        self.policy = policy
        self.dump_path = dump_path
        self.max_retries = int(max_retries)
        self.inject = inject
        self.faults: list[dict] = []

    def _flag(self) -> bool:
        return bool(jax.jit(fault_flag)(self.sim.state))

    def run(self, n_steps: int) -> None:
        sim = self.sim
        good = _device_copy(sim.state)
        good_step = int(sim.state.step_count)
        done = 0
        retries = 0
        while done < n_steps:
            n = min(self.chunk, n_steps - done)
            if self.inject is not None:
                self.inject(sim, int(sim.state.step_count))
            sim.step(n)
            if not self._flag():
                done += n
                retries = 0
                good = _device_copy(sim.state)
                good_step = int(sim.state.step_count)
                continue

            # Fault: dump the faulted state, restore the last good one.
            at = int(sim.state.step_count)
            dump = None
            if self.dump_path:
                try:
                    sim.save(self.dump_path)   # state IS the faulted state
                    dump = self.dump_path
                except Exception:
                    dump = None
            self.faults.append({"at_step": at, "good_step": good_step,
                                "dump": dump})
            sim.state = _device_copy(good)
            if self.policy == "halt":
                raise SimulationFault(
                    f"fault detected at step {at}; state restored to "
                    f"step {good_step}" + (f", dump: {dump}" if dump
                                           else ""),
                    good_step, dump,
                )
            retries += 1
            if retries > self.max_retries:
                raise SimulationFault(
                    f"fault at step {at} reproduced {retries}x from the "
                    f"same state (deterministic step => permanent); "
                    f"halting at good step {good_step}",
                    good_step, dump,
                )
