"""Benchmark harness. Prints ONE JSON line:
{"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "device": ...}

Headline metric: particle-steps/sec on the north-star config (BASELINE.json:
1M-particle 3D dam break with an obstacle at >=60 physics steps/s on one
card) — the dense-grid engine with its default pair sweeps, the Triton
kernels. vs_baseline is the fraction of the 60M particle-steps/s target
(1M particles x 60 steps/s).

Needs a GPU: it exits non-zero, printing no result, when JAX finds none.
Pass --config N for other ladder rungs, --all for the whole ladder,
--cells for the bonded colonies, --breakdown for per-phase times. Each
timing window is one jitted multi-step dispatch ended by
block_until_ready. The output names the device (device_kind) and the
card's power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import jax
import jax.numpy as jnp


_T0 = time.monotonic()


def _note(msg: str) -> None:
    """Flushed stderr progress line (stdout stays the single JSON line),
    so a hung stage leaves a diagnosable tail."""
    print(f"[bench +{time.monotonic() - _T0:7.1f}s] {msg}",
          file=sys.stderr, flush=True)


def _rate_stats(rates: list[float], n: int) -> dict:
    """Best AND median steps/s over timing windows."""
    best = max(rates)
    med = statistics.median(rates)
    return {
        "steps_per_sec": round(best, 2),
        "steps_per_sec_median": round(med, 2),
        "n_particles": n,
        "particle_steps_per_sec": round(best * n, 0),
        "particle_steps_per_sec_median": round(med * n, 0),
    }


def _bench_dense(n_target: int, steps: int = 240, substeps: int = 60,
                 rebin_every: int = 6, obstacles=(), cell_factor: float = 1.25):
    from sphsim.sph.dense import make_dense_spec, pack, make_dense_step
    from sphsim.sph.scenes import dam_break_3d

    state, params = dam_break_3d(n_target=n_target, obstacles=obstacles)
    params = params.replace(
        cell_factor=cell_factor, dense_k=8, rebin_every=rebin_every,
    )
    spec = make_dense_spec(params, k=8, cell_factor=cell_factor)
    N = state.pos.shape[0]
    d = pack(state, params, spec)
    f = make_dense_step(params, spec, substeps=substeps, donate=True)
    red = jax.jit(lambda s: (jnp.sum(s.occ), s.dropped, s.clamped))
    d = jax.block_until_ready(f(d))  # warm (compile)
    rates = []
    rounds = max(1, steps // substeps)
    for _ in range(rounds):
        t0 = time.perf_counter()
        d = jax.block_until_ready(f(d))
        rates.append(substeps / (time.perf_counter() - t0))
    n_alive, dropped, clamped = (float(x) for x in red(d))
    out = _rate_stats(rates, N)
    out.update(alive=int(n_alive), dropped=int(dropped),
               clamped=int(clamped))
    return out


def _bench_2d_bruteforce(n_target: int, steps: int = 20):
    """Config[0]: the O(N²) executable-spec path (slow by design)."""
    from sphsim.sph.model import make_sph_step
    from sphsim.sph.scenes import dam_break_2d

    state, params = dam_break_2d(n_target=n_target)
    N = state.pos.shape[0]
    f = make_sph_step(params, donate=True, substeps=steps)
    state = jax.block_until_ready(f(state))
    t0 = time.perf_counter()
    state = jax.block_until_ready(f(state))
    sps = steps / (time.perf_counter() - t0)
    return {"steps_per_sec": round(sps, 2), "n_particles": N,
            "particle_steps_per_sec": round(sps * N, 0)}


def _bench_2d_dense(n_target: int, steps: int = 480, substeps: int = 120):
    """Config[1]: 2D splash/pour on the dense spatial-hash grid engine."""
    from sphsim.sph.dense import make_dense_spec, pack, make_dense_step
    from sphsim.sph.scenes import splash_pour_2d

    state, params = splash_pour_2d(n_target=n_target)
    params = params.replace(cell_factor=1.2, dense_k=8, rebin_every=3)
    spec = make_dense_spec(params, k=8, cell_factor=1.2)
    N = state.pos.shape[0]
    d = pack(state, params, spec)
    f = make_dense_step(params, spec, substeps=substeps, donate=True)
    red = jax.jit(lambda s: (jnp.sum(s.occ), s.dropped, s.clamped))
    d = jax.block_until_ready(f(d))
    rates = []
    for _i in range(max(1, steps // substeps)):
        t0 = time.perf_counter()
        d = jax.block_until_ready(f(d))
        rates.append(substeps / (time.perf_counter() - t0))
    n_alive, dropped, clamped = (float(x) for x in red(d))
    out = _rate_stats(rates, N)
    out.update(alive=int(n_alive), dropped=int(dropped),
               clamped=int(clamped))
    return out


def _bench_cells(n: int, steps: int = 240, chunk: int = 120,
                 neighbor_mode: str = "dense"):
    """Biology/contact regime on the CURRENT backend: a BONDED settled
    colony (contact sweep + rotation + adhesion constraints + bond pruning
    + division bookkeeping — the reference's full frame on its own steady
    state: cells at the genome's adhesion rest length, every cell bonded to
    its lattice neighbors as division leaves them, CAM:504-509) stepped via
    lax.scan chunks. 'dense' = the colony-specced [Z, Y, X·K] slot grid
    (physics/contact_dense.py, k=2: jitter 0.35 keeps per-axis neighbor
    separation ≥ 2.96 − 0.7 > the 2.1 cell, so ≤ 2 centers/cell and
    overflow stays 0); 'grid' = the sort+gather engine (ops/grid.py)."""
    from sphsim.engine.colony import bonded_colony

    from sphsim import Simulation

    state, params, genome = bonded_colony(
        n,
        neighbor_mode=neighbor_mode,
        grid_dim=48, grid_cell_size=4.0, cell_capacity=16,
        max_splits_per_step=64,
        dense_k=2,
    )
    sim = Simulation(genome, params, auto_grow=False, scan_chunk=chunk)
    sim.state = state
    sync = lambda: jax.block_until_ready(sim.state.pos)  # noqa: E731
    sim.step(chunk)  # warm + compile
    sync()
    rates = []
    for _ in range(max(1, steps // chunk)):
        t0 = time.perf_counter()
        sim.step(chunk)
        sync()
        rates.append(chunk / (time.perf_counter() - t0))
    out = _rate_stats(rates, n)
    out.update(
        neighbor_mode=neighbor_mode,
        bonds=int(jnp.sum(sim.state.bonds.active)),
        cell_overflow=int(sim.state.overflow),
        backend=jax.default_backend(),
    )
    return out


def _bench_4m():
    """Config[4]: 4M+ on one card (higher cell_factor packs cells fuller,
    shrinking the slot count)."""
    return _bench_dense(4_000_000, steps=45, substeps=15, cell_factor=1.35)


CONFIGS = {
    0: ("2D dam-break 4k (brute-force executable spec)",
        lambda: _bench_2d_bruteforce(4096)),
    1: ("2D splash/pour 32k (dense grid)",
        lambda: _bench_2d_dense(32768)),
    2: ("3D dam-break 256k (dense grid)",
        lambda: _bench_dense(262144)),
    3: ("3D dam-break + SDF obstacle 1M (dense grid)",
        lambda: _bench_dense(
            1_000_000, obstacles=(("cylinder_z", (1.2, 0.15), 0.12),),
            cell_factor=1.38,   # not yet measured on the card
        )),
    4: ("3D dam-break 4M (dense grid, one card)", _bench_4m),
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=int, default=3,
                    choices=sorted(CONFIGS), help="ladder rung to run")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--breakdown", action="store_true",
                    help="also report per-phase ms (grid build vs force sum)")
    ap.add_argument("--cells", action="store_true",
                    help="also bench the biology/contact regime: BONDED "
                         "settled colonies at 10k (grid + dense engines), "
                         "100k and 1M (dense)")
    args = ap.parse_args()

    from sphsim.utils.compile_cache import setup_persistent_cache
    from sphsim.utils.profiling import device_record

    setup_persistent_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: no GPU found (JAX platform {dev.platform!r}); "
              "nothing was run", file=sys.stderr)
        return 2

    if args.all:
        detail = {}
        for _idx, (name, fn) in CONFIGS.items():
            _note(f"config[{_idx}] start: {name}")
            try:
                detail[name] = fn()
                _note(f"config[{_idx}] done: "
                      f"{detail[name].get('steps_per_sec')} steps/s")
            except Exception as e:  # noqa: BLE001
                detail[name] = {"error": str(e)[:200]}
                _note(f"config[{_idx}] ERROR: {str(e)[:200]}")
        head_name = CONFIGS[3][0]
        head = detail[head_name]
    else:
        head_name, fn = CONFIGS[args.config]
        _note(f"config[{args.config}] start: {head_name}")
        head = fn()
        detail = {head_name: head}

    if args.cells:
        for n, mode, steps, chunk in (
            (10_240, "grid", 240, 120), (10_240, "dense", 240, 120),
            (102_400, "dense", 240, 120),
            # 100x the reference's 10k default capacity on ONE card
            # (1.7M bonds) — scale row, short run.
            (1_048_576, "dense", 40, 20),
        ):
            size = f"{n//1024}k" if n < 1 << 20 else f"{n/(1<<20):g}M"
            key = f"cell colony {size} (contact+adhesion, {mode})"
            _note(f"cells start: {key}")
            try:
                detail[key] = _bench_cells(
                    n, steps=steps, chunk=chunk, neighbor_mode=mode
                )
                _note(f"cells done: {key} = "
                      f"{detail[key].get('steps_per_sec')} steps/s")
            except Exception as e:  # noqa: BLE001
                detail[key] = {"error": str(e)[:200]}
                _note(f"cells ERROR: {key}: {str(e)[:200]}")

    if args.breakdown:
        _note("breakdown start (256k + 1M phase splits)")
        from sphsim.sph.dense import make_dense_spec, pack
        from sphsim.sph.scenes import dam_break_3d
        from sphsim.utils.profiling import step_breakdown

        # Same settings as the CONFIGS[2] rung so the split explains the
        # recorded rate (was cf=1.2/rebin=3 — a different binary).
        st, prm = dam_break_3d(n_target=262144)
        prm = prm.replace(cell_factor=1.25, dense_k=8, rebin_every=6)
        spc = make_dense_spec(prm, k=8, cell_factor=1.25)
        detail["phase_breakdown_256k"] = step_breakdown(
            pack(st, prm, spc), prm, spc
        )
        # North-star rung at its exact settings (CONFIGS[3]: obstacle,
        # cf=1.38).
        st1, prm1 = dam_break_3d(
            n_target=1_000_000,
            obstacles=(("cylinder_z", (1.2, 0.15), 0.12),),
        )
        prm1 = prm1.replace(cell_factor=1.38, dense_k=8, rebin_every=6)
        spc1 = make_dense_spec(prm1, k=8, cell_factor=1.38)
        detail["phase_breakdown_1m"] = step_breakdown(
            pack(st1, prm1, spc1), prm1, spc1
        )

    out = {
        "metric": f"particle-steps/sec ({head_name}, 1 card)",
        "value": head.get("particle_steps_per_sec", 0.0),
        "unit": "particle-steps/sec",
        "vs_baseline": round(head.get("particle_steps_per_sec", 0.0) / 60e6,
                             4),
        "detail": detail,
        "device": device_record(),
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
