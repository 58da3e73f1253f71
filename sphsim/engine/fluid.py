"""Host-facing fluid simulation API (the WCSPH counterpart of
engine.simulation.Simulation): scene setup, stepping on the dense engine,
metrics, checkpointing, and on-device rendering."""

from __future__ import annotations

import dataclasses
import json
import time

import jax
import jax.numpy as jnp
import numpy as np

from sphsim.sph.dense import (
    DenseFluidState,
    make_dense_spec,
    make_dense_step,
    pack,
    unpack,
)
from sphsim.sph.model import SPHParams, SPHState


class FluidSimulation:
    """A running fluid simulation on the dense cell-grid engine.

    >>> sim = FluidSimulation.from_scene("dam_break_3d", n_target=262144)
    >>> sim.run(600)
    >>> sim.render_frame("frame.png")
    """

    def __init__(self, state: SPHState, params: SPHParams,
                 substeps: int = 10, donate: bool = True, mesh=None):
        """mesh: optional jax.sharding.Mesh (1D) — the simulation then runs
        sharded over layout dim 0 with ppermute halo exchange (spatial
        domain decomposition); results match the single-device engine
        (tests/test_dist.py)."""
        self.params = params
        self.substeps = substeps
        self.donate = donate
        self.mesh = mesh
        self.spec = make_dense_spec(
            params, k=params.dense_k, cell_factor=params.cell_factor
        )
        self.dstate: DenseFluidState = pack(state, params, self.spec)
        if mesh is None:
            self._step = make_dense_step(
                params, self.spec, substeps=substeps, donate=donate
            )
        else:
            from sphsim.parallel.dist import (
                make_sharded_dense_step,
                shard_dense_state,
            )

            self.dstate = shard_dense_state(self.dstate, mesh)
            self._step = make_sharded_dense_step(
                params, self.spec, mesh, substeps=substeps, donate=donate
            )
        self._steps_per_sec = float("nan")
        self._drag = None
        self._drag_step = None

    @classmethod
    def from_scene(cls, scene: str, substeps: int = 10, mesh=None,
                   **scene_kwargs):
        from sphsim.sph import scenes

        builder = getattr(scenes, scene)
        state, params = builder(**scene_kwargs)
        return cls(state, params, substeps=substeps, mesh=mesh)

    # -- stepping -------------------------------------------------------------

    def run(self, n_steps: int) -> float:
        """Run ≥ n_steps (rounded up to substep blocks); returns steps/sec."""
        blocks = max(1, -(-n_steps // self.substeps))
        t0 = time.perf_counter()
        for _ in range(blocks):
            if self._drag is not None:
                self.dstate = self._drag_step(self.dstate, self._drag)
            else:
                self.dstate = self._step(self.dstate)
        jax.block_until_ready(self.dstate.px)
        n_done = blocks * self.substeps
        dt = time.perf_counter() - t0
        self._steps_per_sec = n_done / dt if dt > 0 else float("inf")
        return self._steps_per_sec

    # -- interaction (L5: K5 analog for the fluid regime) ---------------------

    def pick(self, ray_origin, ray_dir):
        """Nearest fluid particle along a ray (pick radius h, the fluid's
    'visual' scale) — the reference's CPU ray-sphere pick
    (ParticleSystemController.cs:977-1013) over the dense state. Returns
    the particle's world position (the drag anchor) or None."""
        pos, _, _, _, mask = unpack(self.dstate)
        p = np.asarray(pos)[np.asarray(mask)]
        if not len(p):
            return None
        o = np.asarray(ray_origin, np.float32)
        d = np.asarray(ray_dir, np.float32)
        d = d / max(np.linalg.norm(d), 1e-12)
        oc = p - o
        tca = oc @ d
        d2 = np.einsum("ij,ij->i", oc, oc) - tca * tca
        r = self.params.h
        hit = (tca >= 0) & (d2 <= r * r)
        if not hit.any():
            return None
        t = np.where(hit, tca, np.inf)
        return p[int(np.argmin(t))]

    def set_drag(self, center, target, radius=None,
                 strength: float = 100.0) -> None:
        """Engage the space-anchored drag sphere (sph.model.FluidDrag):
    particles within `radius` (default 3h) of `center` are pulled toward
    `target` with the reference's impulse form (compute:311-324)."""
        from sphsim.sph.model import FluidDrag

        if radius is None:
            radius = 3.0 * self.params.h
        if self._drag_step is None:
            if self.mesh is not None:
                raise NotImplementedError(
                    "interactive drag is single-device for now"
                )
            self._drag_step = make_dense_step(
                self.params, self.spec, substeps=self.substeps,
                donate=self.donate, with_drag=True,
            )
        self._drag = FluidDrag.at(center, target, radius, strength)

    def clear_drag(self) -> None:
        self._drag = None

    # -- observability --------------------------------------------------------

    def particles(self):
        """(pos, vel, rho, prs) numpy arrays of alive particles."""
        pos, vel, rho, prs, mask = unpack(self.dstate)
        m = np.asarray(mask)
        return (
            np.asarray(pos)[m], np.asarray(vel)[m],
            np.asarray(rho)[m], np.asarray(prs)[m],
        )

    def metrics(self) -> dict:
        pos, vel, rho, _ = self.particles()
        ke = float(
            0.5 * self.params.particle_mass * np.sum(np.sum(vel ** 2, -1))
        )
        return {
            "step": int(self.dstate.step_count),
            "n_particles": int(pos.shape[0]),
            "kinetic_energy": ke,
            "mean_density": float(rho.mean()) if len(rho) else 0.0,
            "max_density": float(rho.max()) if len(rho) else 0.0,
            "max_speed": float(np.linalg.norm(vel, axis=-1).max()) if len(vel) else 0.0,
            "dropped": int(self.dstate.dropped),
            "clamped": int(self.dstate.clamped),
            "steps_per_sec": self._steps_per_sec,
        }

    def render_frame(self, path: str | None = None, camera=None,
                     width: int = 800, height: int = 450):
        """On-device point splat of the current state; optionally saved."""
        from sphsim.render.camera import Camera
        from sphsim.render.splat import render_points, save_image

        if camera is None:
            lo = np.asarray(self.params.bounds_min)
            hi = np.asarray(self.params.bounds_max)
            center = (lo + hi) / 2
            extent = float(np.linalg.norm(hi - lo))
            camera = Camera(position=np.array(
                [center[0], center[1] + 0.3 * extent, center[2] - 1.6 * extent],
                np.float32,
            ))
            camera.focus_on(center, distance=1.6 * extent)
        import jax.numpy as jnp

        pos, _, rho, _, mask = unpack(self.dstate)
        # Screen-space radius scaling (projected-size splat classes): SPH
        # particles render at their smoothing-scale footprint h/2.
        img = render_points(
            pos, camera.view_params(), width=width, height=height, mask=mask,
            radius=jnp.full(pos.shape[0], self.params.h * 0.5),
        )
        if path:
            save_image(img, path)
        return img

    # -- checkpoint / resume ---------------------------------------------------

    def save(self, path: str) -> None:
        flat = {
            f.name: np.asarray(getattr(self.dstate, f.name))
            for f in dataclasses.fields(DenseFluidState)
        }
        header = json.dumps({
            "params": dataclasses.asdict(self.params),
            "substeps": self.substeps,
        })
        np.savez_compressed(path, __header__=header, **flat)

    @classmethod
    def load(cls, path: str, mesh=None) -> "FluidSimulation":
        """Resume from a checkpoint — optionally onto a device mesh (the
        state resharding is just a device_put; checkpoints are
        mesh-agnostic)."""
        with np.load(path, allow_pickle=False) as data:
            header = json.loads(str(data["__header__"]))
            flat = {k: data[k] for k in data.files if k != "__header__"}
        # Checkpoints written before the clamp diagnostic existed lack it.
        flat.setdefault("clamped", np.int32(0))
        params = SPHParams(**{
            k: tuple(v) if isinstance(v, list) else v
            for k, v in header["params"].items()
        })
        sim = cls.__new__(cls)
        sim.params = params
        sim.substeps = header["substeps"]
        sim.mesh = mesh
        sim.spec = make_dense_spec(
            params, k=params.dense_k, cell_factor=params.cell_factor
        )
        sim.dstate = DenseFluidState(**{
            k: jnp.asarray(v) for k, v in flat.items()
        })
        if mesh is None:
            sim._step = make_dense_step(
                params, sim.spec, substeps=sim.substeps, donate=True
            )
        else:
            from sphsim.parallel.dist import (
                make_sharded_dense_step,
                shard_dense_state,
            )

            sim.dstate = shard_dense_state(sim.dstate, mesh)
            sim._step = make_sharded_dense_step(
                params, sim.spec, mesh, substeps=sim.substeps, donate=True
            )
        sim.donate = True   # load() builds its own donating step fns
        sim._steps_per_sec = float("nan")
        sim._drag = None
        sim._drag_step = None
        return sim
