"""Time each hand-written kernel against what XLA makes of its plain twin,
end to end, on the current GPU. Prints one JSON line per measurement.

    python tools/kernel_decisions.py [--cells fluid256k,fluid1m,colony100k,...]
                                     [--pieces] [--rounds 5]

Cells (use_pallas=True vs False, same state, same call, alternating
kernel/twin/twin/kernel rounds so drift hits both alike):
- fluid256k, fluid1m: FluidSimulation dam breaks (1M with the cylinder
  obstacle at cell_factor 1.38; 256k at 1.25), ms per step over
  `substeps`-step dispatches (rebin included every 6th step);
- colony100k, colony1m: Simulation on settled bonded colonies (k=2), ms
  per step over scan chunks. A settled colony is the block screen's best
  case: lattice neighbours sit beyond the contact reach, so almost every
  block skips its pair sweep;
- colony100k_squeezed, colony1m_squeezed: the same colonies squeezed to
  85% of their size (as in chip_smoke.py's kernel check), so contacts
  fire throughout. Besides the step, these time the contact sweep alone
  (contact_pass) and count the cells that feel a contact force. The
  squeezed state packs into k=2 without overflow, but once stepped it
  overflows (reported), so its step times are indicative only.
--pieces also times the XLA rebin alone and the contact pack's column
scatter (_scatter_sorted) at 1M, the paths that replaced the removed
kernels. Each line names the device and its power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sphsim.utils.profiling import device_record  # noqa: E402

OBSTACLE = (("cylinder_z", (1.2, 0.15), 0.12),)


def _emit(rec: dict) -> None:
    print(json.dumps(rec), flush=True)


def _time_windows(run_window, rounds: int) -> list[float]:
    out = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        run_window()
        out.append(time.perf_counter() - t0)
    return out


def fluid_cell(name: str, n: int, cf: float, obstacles, rounds: int,
               substeps: int = 30, windows: int = 4):
    import jax

    from sphsim.engine.fluid import FluidSimulation

    sims = {}
    for route, use in (("kernel", True), ("xla", False)):
        sim = FluidSimulation.from_scene(
            "dam_break_3d", n_target=n, obstacles=obstacles, dense_k=8,
            cell_factor=cf, rebin_every=6, use_pallas=use,
            substeps=substeps)
        t0 = time.perf_counter()
        sim.run(substeps)
        compile_s = time.perf_counter() - t0
        sims[route] = (sim, compile_s)
    ms = {"kernel": [], "xla": []}
    order = ["kernel", "xla", "xla", "kernel"] * ((rounds + 1) // 2)
    for route in order[:2 * rounds]:
        sim = sims[route][0]
        ts = _time_windows(lambda: sim.run(substeps * windows), 1)
        ms[route].append(ts[0] / (substeps * windows) * 1e3)
    for route, (sim, compile_s) in sims.items():
        m = sim.metrics()
        _emit({"cell": name, "route": route, "n": m["n_particles"],
               "ms_per_step_median": statistics.median(ms[route]),
               "ms_per_step_min": min(ms[route]), "ms_all": ms[route],
               "first_dispatch_s": compile_s, "dropped": m["dropped"],
               "clamped": m["clamped"], "device": device_record()})
    jax.clear_caches()


def squeeze(state):
    """A settled colony squeezed to 85% of its size: lattice neighbours
    come within 0.85·(2.96 − 0.7) ≈ 1.92 of each other, inside the contact
    reach 2.0, and every cell moves and spins."""
    import jax.numpy as jnp

    return state.replace_fields(
        pos=state.pos * 0.85,
        vel=0.5 * jnp.sin(state.pos * 7.0),
        ang_vel=0.5 * jnp.cos(state.pos * 5.0),
    )


def contact_pass(name: str, n: int, rounds: int, reps: int = 20):
    """The contact sweep alone on packed fields, ms per call: the kernel
    with its block screen on the settled and on the squeezed colony, the
    kernel without the screen (every occupied block sweeps, as if contacts
    fired in all of them), and the XLA twin."""
    import jax
    import jax.numpy as jnp

    from sphsim.engine.colony import bonded_colony
    from sphsim.ops.pallas.sweep import contact_sweep_pallas
    from sphsim.physics.contact_dense import (
        FIELD_FILLS,
        _pack_args,
        _sweep_xla,
        contact_pair_terms,
        contact_screen,
        make_contact_spec,
    )

    settled, params, _ = bonded_colony(n, neighbor_mode="dense", dense_k=2)
    spec = make_contact_spec(params, k=2,
                             cell_factor=params.dense_cell_factor)
    pair = lambda *a: contact_pair_terms(params, *a)  # noqa: E731
    screen = lambda *a: contact_screen(params, *a)  # noqa: E731
    sweeps = {
        "kernel": lambda f: contact_sweep_pallas(f, spec, pair, FIELD_FILLS,
                                                 screen_fn=screen),
        "kernel, no screen": lambda f: contact_sweep_pallas(
            f, spec, pair, FIELD_FILLS),
        "xla": lambda f: _sweep_xla(f, pair, ncomp=6, spec=spec),
    }
    for label, st in (("settled", settled), ("squeezed", squeeze(settled))):
        fields, _, ovf = jax.jit(lambda s: _pack_args(s, spec))(st)
        ref = jax.jit(sweeps["xla"])(fields)
        touching = int(jnp.sum(jnp.any(
            jnp.stack([r != 0.0 for r in ref[:3]]), axis=0)))
        for route, fn in sweeps.items():
            if label == "settled" and route == "kernel, no screen":
                continue

            def body(i, acc, fn=fn):
                # acc (≈ 0) feeds back into the fields so that no call is
                # hoisted out of the loop.
                out = fn([fields[0] + acc] + list(fields[1:]))
                return acc + 1e-30 * sum(jnp.sum(o) for o in out)

            g = jax.jit(lambda body=body: jax.lax.fori_loop(
                0, reps, body, jnp.float32(0)))
            jax.block_until_ready(g())
            ts = _time_windows(lambda: jax.block_until_ready(g()), rounds)
            _emit({"cell": f"{name} contact sweep", "state": label,
                   "route": route, "n": n,
                   "ms_per_call_median": statistics.median(ts) / reps * 1e3,
                   "ms_per_call_min": min(ts) / reps * 1e3,
                   "cells_touching": touching, "overflow": int(ovf),
                   "device": device_record()})
    jax.clear_caches()


def colony_cell(name: str, n: int, rounds: int, chunk: int,
                squeezed: bool = False):
    import jax
    import jax.numpy as jnp

    from sphsim import Simulation
    from sphsim.engine.colony import bonded_colony

    sims = {}
    for route, use in (("kernel", True), ("xla", False)):
        state, params, genome = bonded_colony(
            n, neighbor_mode="dense", dense_k=2, max_splits_per_step=64,
            use_pallas=use)
        if squeezed:
            state = squeeze(state)
        sim = Simulation(genome, params, auto_grow=False, scan_chunk=chunk)
        sim.state = state
        t0 = time.perf_counter()
        sim.run(chunk)
        sims[route] = (sim, time.perf_counter() - t0)
    ms = {"kernel": [], "xla": []}
    order = ["kernel", "xla", "xla", "kernel"] * ((rounds + 1) // 2)
    for route in order[:2 * rounds]:
        sim = sims[route][0]
        ts = _time_windows(lambda: sim.run(2 * chunk), 1)
        ms[route].append(ts[0] / (2 * chunk) * 1e3)
    for route, (sim, compile_s) in sims.items():
        m = sim.metrics()
        _emit({"cell": name, "route": route, "n": n,
               "ms_per_step_median": statistics.median(ms[route]),
               "ms_per_step_min": min(ms[route]), "ms_all": ms[route],
               "first_dispatch_s": compile_s, "overflow": m["overflow"],
               "bonds": int(jnp.sum(sim.state.bonds.active)),
               "device": device_record()})
    jax.clear_caches()


def pieces(rounds: int):
    """The XLA paths that replaced the removed rebin and expand-pack
    kernels, timed alone at 1M (ms per call, `reps` calls per window)."""
    import jax
    import jax.numpy as jnp

    from sphsim.engine.colony import bonded_colony
    from sphsim.physics.contact_dense import (
        FIELD_FILLS,
        _scatter_sorted,
        _sort_with_payload,
        make_contact_spec,
    )
    from sphsim.sph.dense import make_dense_spec, pack, rebin
    from sphsim.sph.scenes import dam_break_3d

    reps = 20
    state, params = dam_break_3d(n_target=1_000_000, obstacles=OBSTACLE,
                                 dense_k=8, cell_factor=1.38, rebin_every=6)
    spec = make_dense_spec(params, k=8, cell_factor=1.38)
    d = pack(state, params, spec)
    shift = 0.3 * (spec.cell - params.h)
    f = jax.jit(lambda d: jax.lax.fori_loop(0, reps, lambda i, s: rebin(
        s, s.px + jnp.where(s.occ > 0.5, shift * (1 - 2 * (i % 2)), 0.0),
        s.py, s.pz, s.vx, s.vy, s.vz, params, spec), d))
    jax.block_until_ready(f(d))
    ts = _time_windows(lambda: jax.block_until_ready(f(d)), rounds)
    _emit({"piece": "xla rebin (fluid 1M, k=8)",
           "ms_per_call_median": statistics.median(ts) / reps * 1e3,
           "ms_per_call_min": min(ts) / reps * 1e3, "device": device_record()})

    cstate, cparams, _ = bonded_colony(1_048_576, neighbor_mode="dense",
                                       dense_k=2)
    cspec = make_contact_spec(cparams, k=2,
                              cell_factor=cparams.dense_cell_factor)
    cols, flat, fits, _, _ = jax.jit(
        lambda s: _sort_with_payload(s, cspec))(cstate)

    def scat(cols):
        def body(i, acc):
            out = _scatter_sorted([c + acc for c in cols], FIELD_FILLS,
                                  flat, fits, cspec)
            # Read every scattered column so none is dead code.
            return acc + 1e-30 * sum(jnp.sum(o[-1]) for o in out)
        return jax.lax.fori_loop(0, reps, body, jnp.float32(0))

    g = jax.jit(scat)
    jax.block_until_ready(g(cols))
    ts = _time_windows(lambda: jax.block_until_ready(g(cols)), rounds)
    _emit({"piece": "_scatter_sorted (colony 1M, 10 columns, k=2)",
           "slots": cspec.slots,
           "ms_per_call_median": statistics.median(ts) / reps * 1e3,
           "ms_per_call_min": min(ts) / reps * 1e3, "device": device_record()})


CELLS = {
    "fluid256k": lambda r: fluid_cell("fluid 256k", 262_144, 1.25, (), r),
    "fluid1m": lambda r: fluid_cell("fluid 1M + obstacle", 1_000_000, 1.38,
                                    OBSTACLE, r),
    "colony100k": lambda r: colony_cell("colony 100k", 102_400, r, 60),
    "colony1m": lambda r: colony_cell("colony 1M", 1_048_576, r, 20),
    "colony100k_squeezed": lambda r: (
        contact_pass("colony 100k", 102_400, r),
        colony_cell("colony 100k squeezed", 102_400, r, 60, squeezed=True)),
    "colony1m_squeezed": lambda r: (
        contact_pass("colony 1M", 1_048_576, r),
        colony_cell("colony 1M squeezed", 1_048_576, r, 20, squeezed=True)),
}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", default=",".join(CELLS))
    ap.add_argument("--pieces", action="store_true")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()

    import jax

    from sphsim.utils.compile_cache import setup_persistent_cache

    setup_persistent_cache()
    if jax.devices()[0].platform != "gpu":
        print("kernel_decisions: needs a GPU", file=sys.stderr)
        return 2
    for c in filter(None, args.cells.split(",")):
        CELLS[c](args.rounds)
    if args.pieces:
        pieces(args.rounds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
