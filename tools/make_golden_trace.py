"""Regenerate tests/golden/reference_scenario_trace.json — the end-to-end
parity artifact (north star: population/energy traces of the reference
scenario: 1 cell, NewCellGenome params, fixed dt = 1/60, 40 sim-seconds).

Run on CPU for cross-platform reproducibility:
    JAX_PLATFORMS=cpu python tools/make_golden_trace.py
"""

import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from sphsim import Simulation  # noqa: E402
from sphsim.engine.config import (  # noqa: E402
    reference_genome,
    reference_scene_params,
)


def make_trace():
    p = reference_scene_params(capacity=512).replace(
        dt=1 / 60, max_splits_per_step=256, max_bonds=2048
    )
    sim = Simulation(reference_genome(), p, seed=0)
    trace = []
    for _ in range(48):  # 2400 steps = 40 sim-seconds → 128 cells
        sim.step(50)
        m = sim.metrics()
        n = m["active_particles"]
        pos = np.asarray(sim.state.pos[:n])
        trace.append({
            "step": m["step"],
            "n": n,
            "bonds": m["bond_count"],
            "kinetic_energy": round(m["kinetic_energy"], 6),
            "mean_radius_from_origin": round(
                float(np.linalg.norm(pos, axis=1).mean()), 5
            ),
            "next_uid": int(sim.state.next_uid),
        })
    return trace


if __name__ == "__main__":
    out = os.path.join(
        os.path.dirname(__file__), "..", "tests", "golden",
        "reference_scenario_trace.json",
    )
    json.dump(make_trace(), open(out, "w"), indent=1)
    print("wrote", out)
