"""Host-facing Simulation API.

Wraps the pure step function with lifecycle management mirroring the
reference controller: init (Start, cs:211-242), capacity growth
(ResizeParticleBuffers, cs:1162-1222), genome hot-reload (OnGenomeChanged,
cs:357-367), interactive drag (cs:975-1034), metrics, and checkpointing.
"""

from __future__ import annotations

import time
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from sphsim.core.init import init_particles
from sphsim.core.types import (
    Genome,
    SimParams,
    SimState,
    formatted_id,
)
from sphsim.engine.step import make_step_fn


class Simulation:
    """A running simulation instance.

    >>> sim = Simulation(genome, SimParams(capacity=64))
    >>> sim.run(600)
    >>> sim.metrics()
    """

    def __init__(
        self,
        genome: Genome,
        params: SimParams,
        seed: int = 0,
        rng_mode: str = "jax",
        auto_grow: bool = False,
        donate: bool = True,
        scan_chunk: int = 64,   # substeps per dispatch
        mesh=None,
    ):
        self.genome = genome.validate_for_simulation()
        self.params = params
        self.seed = seed
        self.rng_mode = rng_mode
        self.auto_grow = auto_grow
        self.donate = donate
        self.scan_chunk = max(1, scan_chunk)
        self.contact_fn = self._make_contact_fn(mesh)
        self.genome_dev = self.genome.to_device()
        self._step_cache: dict[tuple, Callable] = {}
        self._bond_plan = None
        self._bond_plan_cap = None
        self.state = init_particles(
            params,
            self.genome_dev,
            n_modes=len(self.genome.modes),
            initial_mode=self.genome.initial_mode_index,
            capacity=params.capacity,
            seed=seed,
            rng_mode=rng_mode,
        )
        self._steps_per_sec = float("nan")
        self.last_selected = -1   # lastSelectedParticleID (cs:125)

    # -- lifecycle ---------------------------------------------------------

    def _make_contact_fn(self, mesh):
        """Sharded contact sweep over a 1D z-slab ring or a 2D
        (z-slab × y-block) device mesh (parallel/dist.py) — the biology
        regime's spatial domain decomposition. Only the O(slots·k·variants)
        sweep is decomposed; division/bond tables and integration stay
        replicated (they are O(N) and topology-global). Bitwise equal to
        the single-device step (tests/test_dist.py)."""
        if mesh is None:
            return None
        if self.params.neighbor_mode != "dense":
            raise ValueError(
                "mesh-sharded contact requires neighbor_mode='dense' "
                f"(got {self.params.neighbor_mode!r})"
            )
        from sphsim.parallel.dist import (
            make_sharded_contact_forces,
            make_sharded_contact_forces_2d,
        )

        if mesh.devices.ndim == 2:
            return make_sharded_contact_forces_2d(
                self.params, mesh, donate=False
            )
        return make_sharded_contact_forces(self.params, mesh, donate=False)

    def _stepper(self, chunk: int = 1):
        key = (self.params, self.state.capacity, chunk)
        if key not in self._step_cache:
            if chunk == 1:
                fn = make_step_fn(
                    self.params, donate=self.donate,
                    contact_fn=self.contact_fn,
                )
            else:
                from sphsim.engine.step import run_steps

                fn = jax.jit(
                    lambda st, gd, plan: run_steps(
                        st, self.params, gd, chunk,
                        contact_fn=self.contact_fn,
                        bond_plan=plan, return_plan=True,
                    ),
                    donate_argnums=(0,) if self.donate else (),
                )
            self._step_cache[key] = fn
        return self._step_cache[key]

    def _plan_for_state(self):
        """Adhesion BondPlan carried across scan chunks (the build costs a
        2B-row argsort, so re-sorting per chunk is avoided). Content staleness is safe (the hybrid accumulate
        detects drifted bonds per step and run_steps rebuilds in-scan);
        only SHAPE changes (resize) force a fresh build here."""
        from sphsim.engine.step import use_bond_plan

        if not use_bond_plan(self.params, self.state):
            return None
        cap = (self.state.capacity, self.state.bonds.capacity)
        if self._bond_plan is None or self._bond_plan_cap != cap:
            from sphsim.physics.adhesion import build_bond_plan

            self._bond_plan = jax.jit(
                build_bond_plan, static_argnums=(1,)
            )(self.state.bonds, self.state.capacity)
            self._bond_plan_cap = cap
        return self._bond_plan

    def step(self, n: int = 1, dt=None) -> None:
        """Advance n physics steps.

        Steps are batched into lax.scan chunks of `scan_chunk` substeps per
        dispatch (one host round trip per chunk; division and bond
        rewrites run fully in-jit, so scanning is semantics-preserving).
        Under auto_grow, the chunk size is additionally bounded so the
        population cannot outgrow capacity mid-chunk; the grow check runs
        between chunks (growth policy cs:788-792).

        dt: variable-dt compat (cs:246) — a scalar applied to all n steps,
        or a length-n sequence of per-step dt values. None = fixed
        params.dt (recommended)."""
        if dt is not None:
            dts = np.broadcast_to(np.asarray(dt, np.float32), (n,)).copy()
            key = (self.params, self.state.capacity, "vdt")
            if key not in self._step_cache:
                from sphsim.engine.step import step as _step

                self._step_cache[key] = jax.jit(
                    lambda st, gd, dt: _step(
                        st, self.params, gd, dt=dt,
                        contact_fn=self.contact_fn,
                    ),
                    donate_argnums=(0,) if self.donate else (),
                )
            for d in dts:
                if self.auto_grow:
                    self._maybe_grow()
                self.state = self._step_cache[key](
                    self.state, self.genome_dev, jnp.float32(d)
                )
            return
        remaining = n
        while remaining > 0:
            safe = remaining
            if self.auto_grow:
                self._maybe_grow()
                headroom = self.state.capacity - int(self.state.active_count)
                safe = max(
                    1, headroom // max(1, self.params.max_splits_per_step)
                )
            # Only two compiled variants ever exist: the scan_chunk-sized
            # scan and the single step (used for tails / tight headroom).
            c = (
                self.scan_chunk
                if (remaining >= self.scan_chunk and safe >= self.scan_chunk)
                else 1
            )
            if c == 1:
                self.state = self._stepper(c)(self.state, self.genome_dev)
            else:
                self.state, self._bond_plan = self._stepper(c)(
                    self.state, self.genome_dev, self._plan_for_state()
                )
            remaining -= c

    def run(self, n_steps: int, block: bool = True) -> float:
        """Run n steps, return measured physics steps/sec."""
        t0 = time.perf_counter()
        self.step(n_steps)
        if block:
            jax.block_until_ready(self.state.pos)
        dt = time.perf_counter() - t0
        self._steps_per_sec = n_steps / dt if dt > 0 else float("inf")
        return self._steps_per_sec

    def _maybe_grow(self) -> None:
        """Grow capacity 2× when the population could exceed it next step
        (growth policy mirrors cs:788-792: max(needed, 2×current))."""
        active = int(self.state.active_count)
        cap = self.state.capacity
        headroom = cap - active
        if headroom > max(1, self.params.max_splits_per_step // 2):
            return
        self.resize(max(active + self.params.max_splits_per_step, cap * 2))

    def resize(self, new_capacity: int) -> None:
        """Migrate state into a larger fixed-capacity pytree
        (ResizeParticleBuffers, cs:1162-1222)."""
        if new_capacity <= self.state.capacity:
            return
        old = self.state
        fresh = init_particles(
            self.params,
            self.genome_dev,
            n_modes=len(self.genome.modes),
            initial_mode=self.genome.initial_mode_index,
            capacity=new_capacity,
            seed=self.seed,
            rng_mode=self.rng_mode,
        )
        n = old.capacity

        def migrate(new_arr, old_arr):
            if new_arr.ndim == 0 or new_arr.shape[:1] != (new_capacity,):
                return old_arr if new_arr.shape == old_arr.shape else new_arr
            return new_arr.at[:n].set(old_arr)

        import dataclasses

        upd = {}
        for f in dataclasses.fields(SimState):
            name = f.name
            ov, nv = getattr(old, name), getattr(fresh, name)
            if name in ("bonds", "pending", "drag_input"):
                upd[name] = ov  # capacities unchanged
            elif name in ("active_count", "next_uid", "step_count",
                          "overflow", "rng"):
                upd[name] = ov
            else:
                upd[name] = migrate(nv, ov)
        self.state = SimState(**upd)

    def on_genome_changed(self, genome: Genome) -> None:
        """Hot-reload hook: re-init particles with the new genome
        (cs:357-367)."""
        self.genome = genome.validate_for_simulation()
        self.genome_dev = self.genome.to_device()
        self.state = init_particles(
            self.params,
            self.genome_dev,
            n_modes=len(self.genome.modes),
            initial_mode=self.genome.initial_mode_index,
            capacity=self.state.capacity,
            seed=self.seed,
            rng_mode=self.rng_mode,
        )

    # -- interaction (L5) ----------------------------------------------------

    def pick(self, ray_origin, ray_dir) -> int:
        """CPU ray-sphere intersection over active particles using max_radius
        as pick radius (cs:977-1013). Returns slot or -1."""
        n = int(self.state.active_count)
        if n == 0:
            return -1
        pos = np.asarray(self.state.pos)[:n]
        o = np.asarray(ray_origin, np.float32)
        d = np.asarray(ray_dir, np.float32)
        d = d / max(np.linalg.norm(d), 1e-12)
        r = self.params.max_radius
        oc = pos - o                                   # [n, 3]
        tca = oc @ d                                   # [n]
        d2 = np.einsum("ij,ij->i", oc, oc) - tca * tca
        hit = (tca >= 0) & (d2 <= r * r)
        t = tca - np.sqrt(np.maximum(r * r - d2, 0.0))
        t = np.where(hit, t, np.inf)
        best = int(np.argmin(t))
        if not np.isfinite(t[best]):
            return -1
        # Sticky selection for the split-plane ring (lastSelectedParticleID,
        # cs:125-126: survives drag release).
        self.last_selected = best
        return best

    def set_drag(self, slot: int, target, strength: float = 100.0) -> None:
        """Engage the drag force on a particle (K5 parity; strength 100 while
        held, cs:1027-1032)."""
        d = self.state.drag_input
        self.state = self.state.replace_fields(
            drag_input=d.replace_fields(
                selected_slot=jnp.int32(slot),
                target=jnp.asarray(target, jnp.float32),
                strength=jnp.float32(strength),
            )
        )

    def clear_drag(self) -> None:
        self.set_drag(-1, (0.0, 0.0, 0.0), 0.0)

    # -- observability ---------------------------------------------------------

    def particle_ids(self) -> list[str]:
        """Formatted 'PP.UU.C' ids for active particles (cs:178-191)."""
        n = int(self.state.active_count)
        pu = np.asarray(self.state.parent_uid[:n])
        u = np.asarray(self.state.uid[:n])
        ct = np.asarray(self.state.child_type[:n])
        return [formatted_id(pu[i], u[i], ct[i]) for i in range(n)]

    def bond_lines(self) -> list[dict]:
        """Bond visualization channels (CellAdhesionManager.UpdateBondVisuals,
        CAM:245-304): per active bond, endpoint positions, midpoint, zone
        colors for each half-segment (with the reference's A/B color swap,
        CAM:275-276), and world-space anchor endpoints for the white
        anchor-to-anchor line."""
        st = self.state
        b = st.bonds
        # ONE host fetch per column, then pure-numpy vector math. Indexing
        # a live device array per bond (`int(b.slot_a[i])`) is a device op
        # PER ELEMENT, which made a 16k-bond colony take hours per frame.
        active = np.asarray(b.active)
        idx = np.nonzero(active)[0]
        if idx.size == 0:
            return []
        pos = np.asarray(st.pos)
        rot = np.asarray(st.rot)
        slot_a = np.asarray(b.slot_a)[idx]
        slot_b = np.asarray(b.slot_b)[idx]
        zone_a = np.asarray(b.zone_a)[idx]
        zone_b = np.asarray(b.zone_b)[idx]
        aa = np.asarray(b.anchor_a)[idx]
        ab = np.asarray(b.anchor_b)[idx]
        c2c = np.asarray(b.child_to_child)[idx]

        def rot_np(q, v):
            # numpy twin of core.quat.rotate (compute:373-377)
            u, w = q[:, :3], q[:, 3:4]
            return v + 2.0 * np.cross(u, np.cross(u, v) + w * v)

        pa = pos[slot_a]
        pb = pos[slot_b]
        anchor_a = pa + rot_np(rot[slot_a], aa)
        anchor_b = pb + rot_np(rot[slot_b], ab)
        mid = (pa + pb) * 0.5
        # Reference inspector defaults: zoneA green, zoneB blue, zoneC red —
        # with the swap, ZoneB renders green and ZoneA blue (CAM:275).
        zone_color = {1: (0, 1, 0), 0: (0, 0, 1), 2: (1, 0, 0)}
        return [{
            "a": pa[j].tolist(), "b": pb[j].tolist(),
            "midpoint": mid[j].tolist(),
            "color_a": zone_color[int(zone_a[j])],
            "color_b": zone_color[int(zone_b[j])],
            "anchor_a": anchor_a[j].tolist(),
            "anchor_b": anchor_b[j].tolist(),
            "child_to_child": bool(c2c[j]),
        } for j in range(idx.size)]

    def forward_axes(self) -> np.ndarray:
        """Per-particle +Z body axis in world space — the data behind the
        reference's red forward-axis dot (InstancedParticles.shader:171-175)."""
        from sphsim.core import quat

        n = int(self.state.active_count)
        return np.asarray(
            quat.rotate(self.state.rot[:n], jnp.array([0.0, 0.0, 1.0]))
        )

    def metrics(self) -> dict:
        """Structured per-step metrics (SURVEY §5.5 rebuild plan)."""
        st = self.state
        n = int(st.active_count)
        alive = np.arange(st.capacity) < n
        vel = np.asarray(st.vel)[alive]
        mass = np.asarray(st.mass)[alive]
        ke = float(0.5 * np.sum(mass * np.sum(vel * vel, axis=-1)))
        return {
            "step": int(st.step_count),
            "active_particles": n,
            "bond_count": int(np.sum(np.asarray(st.bonds.active))),
            "kinetic_energy": ke,
            "max_speed": float(np.max(np.linalg.norm(vel, axis=-1))) if n else 0.0,
            "overflow": int(st.overflow),
            "steps_per_sec": self._steps_per_sec,
        }

    # -- checkpoint / resume ----------------------------------------------------

    def save(self, path: str) -> None:
        from sphsim.engine.checkpoint import save_checkpoint

        save_checkpoint(path, self.state, self.params, self.genome,
                        sim_meta={"seed": self.seed,
                                  "rng_mode": self.rng_mode})

    @classmethod
    def load(cls, path: str, mesh=None) -> "Simulation":
        from sphsim.engine.checkpoint import load_checkpoint

        state, params, genome, meta = load_checkpoint(path)
        sim = cls.__new__(cls)
        sim.genome = genome
        sim.params = params
        # Restore the original seed/rng_mode (older checkpoints without
        # the sim header fall back to the constructor defaults) so a later
        # resize() initializes grown rows from the SAME stream as the
        # never-checkpointed run.
        sim.seed = int(meta.get("seed", 0))
        sim.rng_mode = str(meta.get("rng_mode", "jax"))
        sim.auto_grow = False
        sim.donate = True
        sim.scan_chunk = 64
        sim.genome_dev = genome.to_device()
        sim.contact_fn = sim._make_contact_fn(mesh)
        sim._step_cache = {}
        sim.state = state
        sim._steps_per_sec = float("nan")
        sim.last_selected = -1
        return sim
