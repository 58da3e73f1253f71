"""Tracing / profiling utilities (SURVEY §5.1).

The reference has no profiling hooks at all (its only perf knob is
Application.targetFrameRate, ParticleSystemController.cs:213). Here:

- `trace(path)`: context manager around `jax.profiler` emitting a TensorBoard
  trace of whatever runs inside.
- `step_breakdown(...)`: per-phase wall times of the dense fluid step —
  grid/occupancy build, density pass, force pass, integrate, rebin. Each
  phase is timed as a state→state map iterated `sub` times inside one
  `lax.scan` dispatch, ended by `block_until_ready`. The phases are
  separate programs, so their sum can differ from the fused step.
- `device_peaks(kind)`: published peaks of a device, keyed by
  `device_kind`; an unknown device raises, and step_breakdown then reports
  no roofline columns rather than a guessed peak.
"""

from __future__ import annotations

import contextlib
import time

import jax
import jax.numpy as jnp


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler trace scope: view with TensorBoard."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


# Published peaks by jax device_kind (NVIDIA H100 SXM data sheet, dense
# rates): HBM bandwidth, and float32 outside the tensor cores — the pair
# sweeps are float32 elementwise work, so the tensor-core rates are not
# their ceiling. Rated at the 700 W power limit; a card set lower cannot
# hold its top clock.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_gbps": 3350.0, "fp32_gflops": 67000.0},
}


def card_name_power() -> list[str]:
    """`name, power.limit` per card as nvidia-smi reports them (empty
    where nvidia-smi is absent)."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
        ).stdout
    except OSError:
        return []
    return [ln.strip() for ln in out.strip().splitlines() if ln.strip()]


def device_record() -> dict:
    """The device as JAX reports it, with the card's name and power limit
    — attached to every number a measurement prints."""
    d = jax.devices()[0]
    smi = card_name_power()
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices()),
            "name_power_limit": smi[0] if smi else "not available"}


def device_peaks(device_kind: str) -> dict:
    """Peaks for a device_kind; KeyError for a device not in PEAKS."""
    if device_kind not in PEAKS:
        raise KeyError(f"no published peaks for device {device_kind!r}")
    return PEAKS[device_kind]


def _scan_timed(body, x, sub=30, rounds=4):
    """Best ms per body application, `sub` chained applications per
    dispatch."""
    f = jax.jit(lambda x: jax.lax.scan(
        lambda c, _: (body(c), None), x, None, length=sub)[0])
    out = jax.block_until_ready(f(x))
    best = 1e9
    for _i in range(rounds):
        t0 = time.perf_counter()
        out = jax.block_until_ready(f(x))
        best = min(best, (time.perf_counter() - t0) / sub * 1000.0)
    return best, out


def step_breakdown(dstate, params, spec, n=4, sub=30) -> dict:
    """Per-phase ms for one dense fluid step at the current state, on the
    pair-pass route params.use_pallas resolves to."""
    from sphsim.sph.dense import (
        _integrate,
        dense_step,
        pair_accel,
        pair_density,
        rebin,
        rebin_vmax,
    )
    from sphsim.sph.model import eos_pressure

    vmax = rebin_vmax(params, spec)

    def ph_occ(d):
        t = jnp.max(d.occ, axis=1)
        return d.replace_fields(rho=d.rho + 1e-30 * jnp.sum(t))

    def ph_density(d):
        rho = pair_density(d, params, spec)
        prs = jnp.where(d.occ > 0.5, eos_pressure(rho, params), 0.0)
        return d.replace_fields(rho=rho, prs=prs)

    def ph_force(d):
        ax, ay, az = pair_accel(d, params, spec)
        return d.replace_fields(vx=d.vx + 1e-30 * ax, vy=d.vy + 1e-30 * ay,
                                vz=d.vz + 1e-30 * az)

    def ph_integrate(d):
        z = jnp.zeros_like(d.px)
        px, py, pz, vx, vy, vz, _ncl = _integrate(
            d, z, z, z, params, vmax)
        return d.replace_fields(px=px, py=py, pz=pz)

    def ph_rebin(d):
        return rebin(d, d.px, d.py, d.pz, d.vx, d.vy, d.vz, params, spec)

    out = {}
    d2 = ph_density(dstate)
    out["grid_build_ms"], _ = _scan_timed(ph_occ, dstate, sub, n)
    out["density_ms"], _ = _scan_timed(ph_density, dstate, sub, n)
    out["force_ms"], _ = _scan_timed(ph_force, d2, sub, n)
    out["integrate_ms"], _ = _scan_timed(ph_integrate, d2, sub, n)
    out["rebin_ms"], _ = _scan_timed(ph_rebin, d2, sub, n)
    out["rebin_amortized_ms"] = out["rebin_ms"] / max(params.rebin_every, 1)
    out["full_step_ms"], _ = _scan_timed(
        lambda d: dense_step(d, params, spec), dstate, sub, n)
    out["total_ms"] = out["full_step_ms"]
    out = {k: round(v, 3) for k, v in out.items()}
    try:
        peaks = device_peaks(jax.devices()[0].device_kind)
    except KeyError:
        return out
    out.update(_roofline(out, dstate, params, spec, peaks))
    return out


def pair_evals(dstate, params, spec) -> int:
    """Pair-term evaluations of one fluid pair pass on the route
    params.use_pallas resolves to. The kernel sweeps the full stencil, own
    only, for the lanes of occupied blocks alone (an empty block exits
    before any pair work); the XLA twin sweeps the Newton-halved variants
    (sph.dense.sweep_groups) for every lane."""
    import numpy as np

    from sphsim.ops.pallas.sweep import (
        block_lanes,
        fluid_variants,
        kernel_mode,
    )
    from sphsim.sph.dense import sweep_groups

    N0, K, C = dstate.occ.shape
    if kernel_mode(params.use_pallas) is None:
        per_lane = sum(len(dxs) * len(ms)
                       for _, _, dxs, ms, _, _ in sweep_groups(spec))
        return N0 * K * C * per_lane
    bc = block_lanes(C, K)
    occ = np.asarray(dstate.occ).reshape(N0, K, C // bc, bc) > 0.5
    blocks = int(occ.any(axis=(1, 3)).sum())
    return blocks * K * bc * len(fluid_variants(spec)) * K


def _roofline(ms: dict, dstate, params, spec, peaks: dict) -> dict:
    """Analytic flop/byte counts per phase → achieved GFLOP/s, GB/s and %
    of the device's published peaks. Pair passes count the pair terms the
    route really evaluates (pair_evals); bytes are one read of each field
    the timed phase body reads and one write of each field it changes,
    per lane, a lower bound on the traffic (fields a phase passes through
    unchanged cost nothing inside the scan)."""
    N0, K, C = dstate.occ.shape
    lanes = N0 * K * C
    pairs = pair_evals(dstate, params, spec)
    # (flops, bytes) per phase.
    est = {
        "grid_build": (lanes, lanes * 4 * (1 + 1 / K)),
        "density": (16 * pairs, lanes * 4 * (3 + 1)),
        "force": (40 * pairs, lanes * 4 * (8 + 3)),
        # ph_integrate reads p, v and occ (7 fields) and writes p (3).
        "integrate": (lanes * 40, lanes * 4 * (7 + 3)),
        "rebin": (lanes * 3 * 7 * 10, lanes * 4 * 3 * 7 * (3 + 1)),
    }
    out = {}
    for phase, (fl, by) in est.items():
        t = ms.get(f"{phase}_ms", 0.0)
        if t <= 0:
            continue
        gflops = fl / (t * 1e-3) / 1e9
        gbps = by / (t * 1e-3) / 1e9
        out[f"{phase}_gflops"] = round(gflops, 1)
        out[f"{phase}_gbps"] = round(gbps, 1)
        out[f"{phase}_pct_roof"] = round(
            100.0 * max(gflops / peaks["fp32_gflops"],
                        gbps / peaks["hbm_gbps"]), 1)
    return out
