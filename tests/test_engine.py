"""End-to-end engine tests: reference scenario, checkpoint round-trip,
drag, genome hot-reload, resize, config I/O."""

import numpy as np

from sphsim import Simulation
from sphsim.engine.config import (
    genome_from_json,
    genome_to_json,
    params_from_json,
    params_to_json,
    reference_genome,
    reference_scene_params,
)


def small_params(**kw):
    base = reference_scene_params(capacity=16).replace(
        dt=0.5, max_splits_per_step=8, max_bonds=64,
    )
    return base.replace(**kw) if kw else base


def test_reference_scenario_grows_with_adhesion():
    sim = Simulation(reference_genome(), small_params())
    sim.step(25)  # interval 5 / dt 0.5 ⇒ divisions at steps ~11 and ~22
    m = sim.metrics()
    assert m["active_particles"] == 4
    assert m["bond_count"] >= 2
    ids = sim.particle_ids()
    assert ids[0].endswith(".A") and len(ids) == 4
    # Boundary invariant: everything inside the spawn sphere (+slack).
    n = m["active_particles"]
    d = np.linalg.norm(np.asarray(sim.state.pos[:n]), axis=-1)
    assert d.max() <= sim.params.spawn_radius + 1e-3
    # Quaternions normalized.
    q = np.linalg.norm(np.asarray(sim.state.rot[:n]), axis=-1)
    np.testing.assert_allclose(q, 1.0, atol=1e-4)


def test_checkpoint_roundtrip(tmp_path):
    sim = Simulation(reference_genome(), small_params())
    sim.step(13)
    path = str(tmp_path / "ckpt.npz")
    sim.save(path)
    sim2 = Simulation.load(path)
    np.testing.assert_array_equal(sim.state.pos, sim2.state.pos)
    np.testing.assert_array_equal(sim.state.uid, sim2.state.uid)
    assert sim.params == sim2.params
    assert sim.genome == sim2.genome
    # Both continue identically (deterministic step).
    sim.step(5)
    sim2.step(5)
    np.testing.assert_allclose(sim.state.pos, sim2.state.pos, atol=1e-6)
    np.testing.assert_array_equal(
        sim.state.bonds.active, sim2.state.bonds.active
    )


def test_determinism_same_seed():
    a = Simulation(reference_genome(), small_params(), seed=7)
    b = Simulation(reference_genome(), small_params(), seed=7)
    a.step(20)
    b.step(20)
    np.testing.assert_array_equal(a.state.pos, b.state.pos)
    np.testing.assert_array_equal(a.state.rot, b.state.rot)


def test_drag_impulse():
    sim = Simulation(reference_genome(), small_params(repulsion_strength=0.0))
    sim.set_drag(0, (10.0, 0.0, 0.0), strength=100.0)
    v0 = np.asarray(sim.state.vel[0])
    sim.step(1)
    v1 = np.asarray(sim.state.vel[0])
    assert v1[0] > v0[0]  # pulled toward +x
    sim.clear_drag()
    assert int(sim.state.drag_input.selected_slot) == -1


def test_genome_hot_reload_reinitializes():
    sim = Simulation(reference_genome(), small_params())
    sim.step(12)
    assert int(sim.state.active_count) >= 2
    sim.on_genome_changed(reference_genome())
    assert int(sim.state.active_count) == 1  # full re-init (cs:357-367)
    assert int(sim.state.step_count) == 0


def test_scene_watcher_fires_on_genome_changed(tmp_path):
    """watch_scene closes the reference's live-edit loop (OnValidate →
    delayCall → OnGenomeChanged, CellGenome.cs:90-105, cs:357-367): an
    edit to the watched JSON re-inits the population on the next poll;
    torn writes are skipped and retried, unchanged files never fire."""
    import dataclasses
    import json
    import os

    from sphsim.engine.config import save_scene, watch_scene

    params = small_params()
    genome = reference_genome()
    path = tmp_path / "scene.json"
    save_scene(path, params, genome)

    sim = Simulation(genome, params)
    w = watch_scene(sim, path)
    sim.step(12)
    assert int(sim.state.active_count) >= 2
    assert w.poll() is False          # unchanged file: no fire
    assert int(sim.state.active_count) >= 2

    # Edit: change split_interval (an OnValidate-style genome tweak).
    g2 = dataclasses.replace(genome.modes[0], split_interval=9.0)
    save_scene(path, params, type(genome)((g2,)))
    os.utime(path, ns=(1, 1))         # force a distinct stamp
    assert w.poll() is True
    assert int(sim.state.active_count) == 1   # full re-init (cs:357-367)
    assert int(sim.state.step_count) == 0
    assert float(sim.genome.modes[0].split_interval) == 9.0

    # Torn write: invalid JSON is reported, skipped, and retried.
    errs = []
    w.on_error = errs.append
    path.write_text('{"genome": {"modes": [{')
    os.utime(path, ns=(2, 2))
    assert w.poll() is False
    assert len(errs) == 1
    # The fixed file (bare-genome form) fires on the next poll.
    path.write_text(json.dumps(
        {"modes": [dataclasses.asdict(
            dataclasses.replace(genome.modes[0], split_interval=3.0))]}
    ))
    os.utime(path, ns=(3, 3))
    assert w.poll() is True
    assert float(sim.genome.modes[0].split_interval) == 3.0


def test_resize_preserves_state():
    sim = Simulation(reference_genome(), small_params())
    sim.step(12)
    pos_before = np.asarray(sim.state.pos)
    n = int(sim.state.active_count)
    sim.resize(64)
    assert sim.state.capacity == 64
    np.testing.assert_array_equal(np.asarray(sim.state.pos[:16]), pos_before)
    assert int(sim.state.active_count) == n
    sim.step(3)  # still steps fine at new capacity


def test_auto_grow():
    sim = Simulation(
        reference_genome(),
        small_params(capacity=2, max_splits_per_step=4),
        auto_grow=True,
    )
    sim.step(40)
    assert int(sim.state.active_count) > 2
    assert sim.state.capacity > 2


def test_config_json_roundtrip():
    p = small_params()
    assert params_from_json(params_to_json(p)) == p
    g = reference_genome()
    assert genome_from_json(genome_to_json(g)) == g


def test_pick_ray():
    sim = Simulation(reference_genome(), small_params())
    pos = np.asarray(sim.state.pos[0])
    origin = pos + np.array([0.0, 0.0, -30.0])
    assert sim.pick(origin, (0.0, 0.0, 1.0)) == 0
    assert sim.pick(origin + np.array([100.0, 0, 0]), (0.0, 0.0, 1.0)) == -1


def test_variable_dt_compat():
    """Variable-dt compat mode (ParticleSystemController.cs:246 steps with
    Time.deltaTime): dt == params.dt reproduces the fixed path exactly, and
    a non-uniform dt schedule advances division timers by the summed time."""
    a = Simulation(reference_genome(), small_params(), seed=3)
    b = Simulation(reference_genome(), small_params(), seed=3)
    a.step(6)
    b.step(6, dt=b.params.dt)
    np.testing.assert_array_equal(np.asarray(a.state.pos), np.asarray(b.state.pos))
    np.testing.assert_array_equal(np.asarray(a.state.rot), np.asarray(b.state.rot))
    assert int(a.state.active_count) == int(b.state.active_count)

    # Non-uniform schedule: dts sum past the 5.0 split interval by step 6
    # (cumulative 5.4), so the queued split applies at step 7; 8 fixed
    # steps of params.dt=0.5 (4.0) must not divide.
    c = Simulation(reference_genome(), small_params(), seed=3)
    c.step(8, dt=[0.9, 0.9, 0.9, 0.9, 0.9, 0.9, 0.1, 0.1])
    assert int(c.state.active_count) == 2
    d = Simulation(reference_genome(), small_params(), seed=3)
    d.step(8)
    assert int(d.state.active_count) == 1
