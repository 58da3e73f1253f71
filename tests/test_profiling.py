"""Profiling utilities smoke test (SURVEY §5.1)."""

import numpy as np


def test_step_breakdown_reports_phases(tmp_path):
    from sphsim.sph.dense import make_dense_spec, pack
    from sphsim.sph.scenes import dam_break_2d
    from sphsim.utils.profiling import step_breakdown

    state, params = dam_break_2d(n_target=200)
    params = params.replace(dense_k=4, cell_factor=1.2, use_pallas=False)
    spec = make_dense_spec(params, k=4, cell_factor=1.2)
    d = pack(state, params, spec)
    bd = step_breakdown(d, params, spec, n=1, sub=2)
    for key in ("grid_build_ms", "density_ms", "force_ms", "integrate_ms",
                "rebin_ms", "total_ms"):
        assert key in bd and np.isfinite(bd[key]) and bd[key] >= 0


def test_trace_writes_profile(tmp_path):
    import jax.numpy as jnp

    from sphsim.utils.profiling import trace

    with trace(str(tmp_path)):
        _ = jnp.sum(jnp.ones((128, 128)) * 2.0)
    # A trace directory with at least one artifact appears.
    import os

    found = any(files for _, _, files in os.walk(tmp_path))
    assert found


def test_peak_table_refuses_unknown_device():
    """Roofline peaks come only from the device_kind table: an unknown
    device raises, and step_breakdown then reports no roofline columns
    (the CPU here is such a device)."""
    import pytest

    from sphsim.utils.profiling import PEAKS, device_peaks

    h100 = device_peaks("NVIDIA H100 80GB HBM3")
    assert h100 == {"hbm_gbps": 3350.0, "fp32_gflops": 67000.0}
    assert h100 is PEAKS["NVIDIA H100 80GB HBM3"]
    for kind in ("cpu", "NVIDIA H100 PCIe", ""):
        with pytest.raises(KeyError):
            device_peaks(kind)


def test_step_breakdown_has_no_roofline_off_table(tmp_path):
    from sphsim.sph.dense import make_dense_spec, pack
    from sphsim.sph.scenes import dam_break_2d
    from sphsim.utils.profiling import step_breakdown

    state, params = dam_break_2d(n_target=200)
    params = params.replace(dense_k=4, cell_factor=1.2, use_pallas=False)
    spec = make_dense_spec(params, k=4, cell_factor=1.2)
    bd = step_breakdown(pack(state, params, spec), params, spec, n=1, sub=2)
    assert not any(k.endswith(("_pct_roof", "_gflops", "_gbps"))
                   for k in bd)


def test_pair_evals_counts_the_route():
    """The roofline counts the pair terms each route evaluates: the kernel
    only over occupied blocks (full stencil, own only), the XLA twin the
    Newton-halved variants over every lane."""
    import pytest

    from sphsim.ops.pallas.sweep import block_lanes, fluid_variants
    from sphsim.sph.dense import make_dense_spec, pack, sweep_groups
    from sphsim.sph.scenes import dam_break_3d
    from sphsim.utils.profiling import pair_evals

    state, params = dam_break_3d(n_target=400, dense_k=8, cell_factor=1.2)
    spec = make_dense_spec(params, k=8, cell_factor=1.2)
    d = pack(state, params, spec)
    N0, K, C = d.occ.shape
    bc = block_lanes(C, K)
    occ = np.asarray(d.occ).reshape(N0, K, C // bc, bc) > 0.5
    blocks = int(occ.any(axis=(1, 3)).sum())
    # A dam break leaves part of the tank empty: some blocks are skipped.
    assert 0 < blocks < N0 * (C // bc)
    kernel = pair_evals(d, params.replace(use_pallas="interpret"), spec)
    assert kernel == blocks * K * bc * 27 * K
    assert len(fluid_variants(spec)) == 27
    twin = pair_evals(d, params.replace(use_pallas=False), spec)
    halved = sum(len(dxs) * len(ms) for _, _, dxs, ms, _, _ in
                 sweep_groups(spec))
    assert twin == N0 * K * C * halved
    # Newton halving: a bit over half the full stencil's 27·K per lane.
    assert 13 * K < halved < 27 * K / 2 + K
    with pytest.raises(RuntimeError, match="GPU"):
        pair_evals(d, params.replace(use_pallas=True), spec)
