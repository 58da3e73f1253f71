"""FluidSimulation host API: scene boot, stepping, metrics, checkpoint,
render; plus the app CLI smoke (headless frames)."""

import json
import subprocess
import sys

import numpy as np


def make_sim(n=300, substeps=20):
    from sphsim.engine.fluid import FluidSimulation

    return FluidSimulation.from_scene(
        "dam_break_2d", n_target=n, substeps=substeps, use_pallas="interpret"
    )


def test_fluid_simulation_runs_and_reports():
    sim = make_sim()
    sim.run(40)
    m = sim.metrics()
    assert m["n_particles"] > 0
    assert m["dropped"] == 0
    assert np.isfinite(m["kinetic_energy"])
    assert m["mean_density"] > 100.0


def test_fluid_checkpoint_roundtrip(tmp_path):
    sim = make_sim()
    sim.run(40)
    p = str(tmp_path / "fluid.npz")
    sim.save(p)

    from sphsim.engine.fluid import FluidSimulation

    sim2 = FluidSimulation.load(p)
    np.testing.assert_array_equal(
        np.asarray(sim.dstate.px), np.asarray(sim2.dstate.px)
    )
    sim.run(20)
    sim2.run(20)
    np.testing.assert_array_equal(
        np.asarray(sim.dstate.px), np.asarray(sim2.dstate.px)
    )


def test_fluid_render_frame(tmp_path):
    sim = make_sim()
    sim.run(20)
    img = np.asarray(sim.render_frame(str(tmp_path / "f.png")))
    assert img.shape[-1] == 3
    assert (tmp_path / "f.png").exists()
    # The fluid must actually appear: some pixels well above background.
    assert img.max() > 0.3


def test_app_cli_fluid_smoke(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "sphsim.app", "fluid", "--scene",
         "dam_break_2d", "--n", "200", "--steps", "20", "--substeps", "20",
         "--use-pallas", "false", "--out", str(tmp_path)],
        capture_output=True, text=True, timeout=500,
        env={"JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin:/usr/local/bin"},
    )
    assert out.returncode == 0, out.stderr[-2000:]
    line = [l for l in out.stdout.splitlines() if l.startswith("{")][-1]
    m = json.loads(line)
    assert m["n_particles"] > 0


def test_fluid_simulation_on_mesh(tmp_path):
    """Public multi-chip path: FluidSimulation(mesh=...) runs the sharded
    engine (config[4] decomposition) and matches the single-device API;
    checkpoints are mesh-agnostic both ways."""
    import jax
    import numpy as np
    from jax.sharding import Mesh

    from sphsim.engine.fluid import FluidSimulation

    from sphsim.sph.model import SPHParams, SPHState

    mesh = Mesh(np.array(jax.devices()[:4]), ("x",))
    # Random fluid (a lattice packs 2^3 points per cell at any cell_factor,
    # forcing k=8 whose XLA twin compiles slowly on CPU — k=4 keeps this
    # fast, same trade as tests/test_dist.py).
    rng = np.random.default_rng(0)
    n = 500
    pos = rng.uniform(0.05, 0.95, (n, 3)).astype(np.float32)
    h = float((0.15 * 0.729 / n) ** (1 / 3))
    params = SPHParams(
        ndim=3, h=h, particle_mass=1000.0 / n,
        bounds_min=(0.0, 0.0, 0.0), bounds_max=(1.0, 1.0, 1.0),
        dt=0.25 * h / 60.0, sound_speed=60.0,
        dense_k=4, cell_factor=1.3, rebin_every=3, use_pallas=False,
    )
    import jax.numpy as jnp

    state = SPHState.from_positions(jnp.asarray(pos), params)
    a = FluidSimulation(state, params, substeps=6)
    b = FluidSimulation(state, params, substeps=6, mesh=mesh)
    a.run(6)
    b.run(6)
    np.testing.assert_array_equal(
        np.asarray(a.dstate.occ), np.asarray(b.dstate.occ)
    )
    np.testing.assert_allclose(
        np.asarray(a.dstate.px), np.asarray(b.dstate.px), rtol=1e-6
    )
    assert b.metrics()["dropped"] == 0

    # Checkpoint round-trip across meshes.
    p = str(tmp_path / "ck.npz")
    b.save(p)
    c = FluidSimulation.load(p)          # sharded -> single device
    d = FluidSimulation.load(p, mesh=mesh)  # single file -> mesh
    c.run(6)
    d.run(6)
    np.testing.assert_allclose(
        np.asarray(c.dstate.px), np.asarray(d.dstate.px), rtol=1e-6
    )


def test_fluid_interactive_drag():
    """K5 analog for the fluid regime: the space-anchored drag sphere pulls
    nearby fluid toward the target (SimulateParticles.compute:311-324
    impulse form; dense slots migrate on rebin, so
    drag anchors in space, not on a particle id)."""
    import numpy as np

    from sphsim.engine.fluid import FluidSimulation

    # k=8 3D: the Triton kernels in the interpreter (the XLA twin at k=8
    # takes ~30 min to compile on CPU).
    sim = FluidSimulation.from_scene("dam_break_3d", n_target=400, substeps=5,
                                     use_pallas="interpret")
    sim.run(5)
    # Pick a fluid particle with a ray straight down its column.
    pos0, _, _, _ = sim.particles()
    anchor = pos0[len(pos0) // 2]
    hit = sim.pick(anchor + np.array([0, 0, -1], np.float32), (0, 0, 1))
    assert hit is not None and np.linalg.norm(hit - anchor) < 4 * sim.params.h

    target = anchor + np.array([0.0, 0.3, 0.0], np.float32)
    baseline = FluidSimulation.from_scene(
        "dam_break_3d", n_target=400, substeps=5, use_pallas="interpret"
    )
    import jax
    import jax.numpy as jnp

    # Deep copy: both sims step with donated buffers.
    baseline.dstate = jax.tree_util.tree_map(jnp.array, sim.dstate)
    sim.set_drag(anchor, target, strength=5000.0)
    sim.run(30)
    baseline.run(30)
    pos_d, _, _, _ = sim.particles()
    pos_b, _, _, _ = baseline.particles()
    # Dragged fluid's center of mass moved toward the target (up in y)
    # relative to the no-drag baseline.
    assert pos_d[:, 1].mean() > pos_b[:, 1].mean() + 1e-4
    sim.clear_drag()
    sim.run(5)  # drag-free stepping still works after release
