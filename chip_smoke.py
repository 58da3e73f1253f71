"""Quickest proof that the system runs on the GPU.

    python chip_smoke.py              # one card: all phases below
    python chip_smoke.py --cards 4    # four cards: the sharded paths only

One card drives both main paths through the entry points a user calls, at
full size, and checks every Triton kernel against its plain reference:

- fluid: FluidSimulation.from_scene("dam_break_3d", n_target=1_000_000)
  with a cylinder obstacle (dense_k=8, cell_factor=1.38, rebin_every=6),
  a few hundred steps, metrics() and render_frame();
- colony: Simulation on a settled 102,400-cell bonded colony (dense
  contact, k=2) for a few scan chunks, then a division wave (64 cells
  spread through the colony divide in one chunk), then a short run at
  1,048,576 cells;
- kernels: the Triton density and acceleration sweeps against the XLA
  twins on the 1M dam-break state, and the Triton contact sweep against
  the XLA twin and ops.grid.contact_forces_grid on a 100k colony.

With --cards 4 it runs only the multi-device paths, each compared with
the same state stepped on one card: the 1D-ring FluidSimulation(mesh=...)
at 4M particles, the 2×2 make_sharded_dense_step_2d, and
Simulation(mesh=...) on the 1M colony.

Every phase asserts its own checks; nothing is caught. The script exits
non-zero before any phase when JAX finds no GPU. The last line of stdout is
{"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

OBSTACLE = (("cylinder_z", (1.2, 0.15), 0.12),)
# Sizes and routes (a CPU rehearsal shrinks them and sets the kernels to
# the Pallas interpreter; the card runs them as they stand).
FLUID = dict(n_target=1_000_000, obstacles=OBSTACLE, dense_k=8,
             cell_factor=1.38, rebin_every=6)
FLUID_SHARDED = dict(n_target=4_000_000, obstacles=OBSTACLE, dense_k=8,
                     cell_factor=1.35, rebin_every=6)
COLONY, COLONY_BIG = 102_400, 1_048_576
FLUID_STEPS = 300
USE_PALLAS = True          # main paths: the compiled kernels
INTERPRET = False          # direct kernel calls
_T0 = time.monotonic()


def log(msg: str) -> None:
    print(f"[{time.monotonic() - _T0:7.1f}s] {msg}", flush=True)


def max_rel_err(got, ref, mask=None) -> float:
    """max |got − ref| / max |ref| over the (masked) lanes."""
    import numpy as np

    got = np.asarray(got, np.float64).reshape(-1)
    ref = np.asarray(ref, np.float64).reshape(-1)
    if mask is not None:
        m = np.asarray(mask).reshape(-1)
        got, ref = got[m], ref[m]
    assert np.isfinite(got).all(), "non-finite kernel output"
    scale = np.abs(ref).max()
    assert scale > 0, "degenerate reference (all zero)"
    return float(np.abs(got - ref).max() / scale)


def check(name: str, err: float, tol: float, why: str) -> None:
    log(f"{name}: max err / max |ref| = {err:.3e} (tolerance {tol:g}: {why})")
    assert err <= tol, f"{name} outside tolerance"


# ---------------------------------------------------------------------------
# One card
# ---------------------------------------------------------------------------


def phase_fluid() -> None:
    import numpy as np

    from sphsim.engine.fluid import FluidSimulation

    sim = FluidSimulation.from_scene("dam_break_3d", use_pallas=USE_PALLAS,
                                     **FLUID)
    n = sim.metrics()["n_particles"]
    spec = sim.spec
    log(f"fluid: {n} particles, grid {spec.n0}x{spec.n1}x{spec.n2} k={spec.k}")
    t = time.perf_counter()
    sim.run(10)
    log(f"fluid: first 10 steps (compile included) {time.perf_counter() - t:.1f} s")
    rate = sim.run(FLUID_STEPS)
    m = sim.metrics()
    log(f"fluid: {rate:.2f} steps/s over {FLUID_STEPS} steps "
        f"({rate * n / 1e6:.2f}M particle-steps/s); metrics {json.dumps(m)}")
    assert m["n_particles"] == n and m["dropped"] == 0, m
    assert m["clamped"] == 0, m
    assert np.isfinite(m["kinetic_energy"]) and np.isfinite(m["max_speed"]), m
    assert 500.0 < m["mean_density"] < 2000.0, m
    img = np.asarray(sim.render_frame(width=640, height=360))
    assert img.shape == (360, 640, 3) and np.isfinite(img).all(), img.shape
    assert img.max() > 0.3, "fluid not visible in the frame"
    from sphsim.render.splat import png_bytes

    png = png_bytes((np.clip(img, 0, 1) * 255).astype(np.uint8))
    log(f"fluid: render_frame 640x360 ok, PNG {len(png)} bytes")


def _colony(n: int, **kw):
    from sphsim.engine.colony import bonded_colony

    return bonded_colony(n, neighbor_mode="dense", dense_k=2,
                         max_splits_per_step=64, use_pallas=USE_PALLAS,
                         **kw)


def phase_colony() -> None:
    import jax.numpy as jnp
    import numpy as np

    from sphsim import Simulation

    # Every step runs the contact pack and sweep, adhesion, the division
    # queue and bond pruning; the division wave below makes splits fire.
    n, chunk = COLONY, 60
    state, params, genome = _colony(n)
    sim = Simulation(genome, params, auto_grow=False, scan_chunk=chunk)
    sim.state = state
    bonds0 = int(jnp.sum(sim.state.bonds.active))
    t = time.perf_counter()
    sim.run(chunk)
    log(f"colony 100k: first chunk (compile included) "
        f"{time.perf_counter() - t:.1f} s")
    rate = sim.run(3 * chunk)
    m = sim.metrics()
    log(f"colony 100k: {rate:.2f} steps/s over {3 * chunk} steps; "
        f"bonds {bonds0} -> {m['bond_count']}; metrics {json.dumps(m)}")
    assert m["active_particles"] == n, m
    assert m["overflow"] == 0 and m["bond_count"] > 0, m
    live = np.asarray(sim.state.pos)[:m["active_particles"]]
    assert np.isfinite(live).all() and np.isfinite(m["kinetic_energy"]), m

    # Division wave: arm one cell in every n/64 to split within the chunk
    # (64 = max_splits_per_step; spread out, each pair of children lands in
    # cells of its own, so k=2 does not overflow). The children are placed
    # overlapping, so contacts fire where they push apart.
    wave = params.max_splits_per_step
    armed = np.arange(wave) * (n // wave)
    sim.resize(n + wave)
    st = sim.state
    interval = float(genome.modes[0].split_interval)
    sim.state = st.replace_fields(split_timer=st.split_timer.at[armed].set(
        interval - 2.5 * params.dt))
    t = time.perf_counter()
    sim.run(chunk)
    m2 = sim.metrics()
    log(f"colony 100k division wave: {wave} cells split in one chunk of "
        f"{chunk} steps ({time.perf_counter() - t:.1f} s, compile "
        f"included); bonds {m['bond_count']} -> {m2['bond_count']}; "
        f"metrics {json.dumps(m2)}")
    assert m2["active_particles"] == n + wave and m2["overflow"] == 0, m2
    assert m2["bond_count"] > m["bond_count"], m2
    live = np.asarray(sim.state.pos)[:m2["active_particles"]]
    assert np.isfinite(live).all() and np.isfinite(m2["kinetic_energy"]), m2

    n1m, chunk1 = COLONY_BIG, 20
    state, params, genome = _colony(n1m)
    sim = Simulation(genome, params, auto_grow=False, scan_chunk=chunk1)
    sim.state = state
    t = time.perf_counter()
    sim.run(chunk1)
    log(f"colony 1M: first chunk (compile included) "
        f"{time.perf_counter() - t:.1f} s")
    rate = sim.run(2 * chunk1)
    m = sim.metrics()
    log(f"colony 1M: {rate:.2f} steps/s over {2 * chunk1} steps; "
        f"metrics {json.dumps(m)}")
    assert m["active_particles"] == n1m and m["overflow"] == 0, m
    assert m["bond_count"] > 0 and np.isfinite(m["kinetic_energy"]), m


def phase_kernels() -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from sphsim.ops.grid import contact_forces_grid
    from sphsim.ops.pallas.sweep import (
        accel_pallas,
        contact_sweep_pallas,
        density_pallas,
    )
    from sphsim.physics.contact_dense import (
        FIELD_FILLS,
        _pack_args,
        _sweep_xla as contact_twin,
        contact_forces_dense,
        contact_pair_terms,
        contact_screen,
        make_contact_spec,
    )
    from sphsim.sph.dense import (
        accel_pass,
        density_pass,
        make_dense_spec,
        pack,
    )
    from sphsim.sph.model import eos_pressure
    from sphsim.sph.scenes import dam_break_3d

    # --- fluid sweeps vs the XLA twin, 1M dam break ---
    state, params = dam_break_3d(**FLUID)
    # Break the lattice's symmetry (±5% of the spacing keeps ≤ 2 particles
    # per cell axis at cell_factor 1.38, so k=8 cannot overflow) so that
    # no pair terms cancel exactly.
    dx = params.h / 1.3
    rng = np.random.default_rng(0)
    state = state.replace_fields(pos=state.pos + jnp.asarray(
        rng.uniform(-0.05 * dx, 0.05 * dx, state.pos.shape), jnp.float32))
    spec = make_dense_spec(params, k=params.dense_k,
                           cell_factor=params.cell_factor)
    d = pack(state, params, spec)
    occ = np.asarray(d.occ) > 0.5
    rho_x = jax.jit(lambda d: density_pass(d, params, spec))(d)
    rho_k = jax.jit(lambda d: jnp.where(
        d.occ > 0.5,
        jnp.maximum(density_pallas(d.px, d.py, d.pz, params, spec,
                                   interpret=INTERPRET), 1e-6),
        params.rest_density))(d)
    # Same pair terms summed in another order (own-only full stencil vs
    # the twin's Newton-halved mirrors): float32 reassociation of ≤ 216
    # positive terms, ~1e-6 relative; a missed or doubled pair is ≥ 1e-3.
    check("density Triton vs XLA twin (1M)",
          max_rel_err(rho_k, rho_x, occ), 2e-5,
          "reassociation of positive terms")
    # Lattice start: perturb velocities so viscosity terms are non-zero.
    prs = jnp.where(d.occ > 0.5, eos_pressure(rho_x, params), 0.0)
    d2 = d.replace_fields(
        rho=rho_x, prs=prs,
        vx=jnp.sin(d.px * 37.0) * d.occ, vy=jnp.cos(d.py * 41.0) * d.occ,
        vz=jnp.sin(d.pz * 43.0) * d.occ,
    )
    a_x = jax.jit(lambda d: accel_pass(d, params, spec))(d2)
    a_k = jax.jit(lambda d: accel_pallas(
        d, d.prs / (d.rho * d.rho), params, spec, interpret=INTERPRET))(d2)
    for c, (k_, x_) in enumerate(zip(a_k, a_x)):
        # Signed pair terms cancel, so the error is taken against the
        # largest |a| of the component, not per lane.
        check(f"accel[{'xyz'[c]}] Triton vs XLA twin (1M)",
              max_rel_err(k_, x_, occ), 1e-4,
              "reassociation of signed terms that largely cancel")

    # --- contact sweep vs the twin and the sort+gather grid, 100k ---
    cstate, cparams, _ = _colony(COLONY)
    # Squeeze the settled lattice (spacing 2.96 > contact reach 2.0) to 85%
    # so contacts really fire: neighbor distance ≥ 0.85·(2.96 − 0.7) ≈ 1.92.
    cstate = cstate.replace_fields(
        pos=cstate.pos * 0.85,
        vel=0.5 * jnp.sin(cstate.pos * 7.0),
        ang_vel=0.5 * jnp.cos(cstate.pos * 5.0),
    )
    cspec = make_contact_spec(cparams, k=cparams.dense_k,
                              cell_factor=cparams.dense_cell_factor)

    def sweeps(s):
        fields, _slot_of, overflow = _pack_args(s, cspec)
        pair = lambda *a: contact_pair_terms(cparams, *a)  # noqa: E731
        screen = lambda *a: contact_screen(cparams, *a)  # noqa: E731
        tk = contact_sweep_pallas(fields, cspec, pair, FIELD_FILLS,
                                  screen_fn=screen, interpret=INTERPRET)
        tx = contact_twin(fields, pair, ncomp=6, spec=cspec)
        return tk, tx, overflow

    tk, tx, ovf = jax.jit(sweeps)(cstate)
    assert int(ovf) == 0, f"contact pack overflow {int(ovf)}"
    for c in range(6):
        # Same variant order as the twin; only FMA contraction differs.
        check(f"contact sweep[{c}] Triton vs XLA twin (100k)",
              max_rel_err(tk[c], tx[c]), 1e-5,
              "same order, FMA contraction only")
    f_k, t_k, _ = jax.jit(lambda s: contact_forces_dense(
        s, cparams.replace(use_pallas="interpret" if INTERPRET else True))
    )(cstate)
    extent = 2.0 * cparams.spawn_radius
    cell = 4.0
    gparams = cparams.replace(
        neighbor_mode="grid", grid_cell_size=cell,
        grid_dim=int(np.ceil(extent / cell)) + 2, cell_capacity=16,
    )
    f_g, t_g, g_ovf = jax.jit(lambda s: contact_forces_grid(s, gparams))(
        cstate)
    assert int(g_ovf) == 0, f"grid overflow {int(g_ovf)}"
    for name, got, ref in (("force", f_k, f_g), ("torque", t_k, t_g)):
        # Different pair enumeration order (27-cell bins vs slot lanes).
        check(f"contact {name} Triton vs ops.grid (100k)",
              max_rel_err(got, ref), 2e-4, "different summation order")


# ---------------------------------------------------------------------------
# Four cards
# ---------------------------------------------------------------------------


def phase_sharded() -> None:
    import jax
    import numpy as np
    from jax.sharding import Mesh

    from sphsim import Simulation
    from sphsim.engine.fluid import FluidSimulation
    from sphsim.parallel.dist import make_mesh_2d, make_sharded_dense_step_2d
    from sphsim.sph.dense import make_dense_step, pack
    from sphsim.sph.scenes import dam_break_3d

    devs = jax.devices()
    assert len(devs) >= 4, f"--cards 4 needs 4 devices, found {len(devs)}"
    mesh = Mesh(np.array(devs[:4]), ("x",))
    steps = 24

    def compare(name, ref, out):
        np.testing.assert_array_equal(np.asarray(ref.occ),
                                      np.asarray(out.occ), err_msg=name)
        assert int(out.dropped) == int(ref.dropped) == 0, name
        err = max_rel_err(out.px, ref.px, np.asarray(ref.occ) > 0.5)
        check(f"{name} px vs one card", err, 1e-6,
              "same per-lane sums; XLA may fuse the integrate differently")

    state, params = dam_break_3d(use_pallas=USE_PALLAS, **FLUID_SHARDED)
    one = FluidSimulation(state, params, substeps=12)
    t = time.perf_counter()
    one.run(steps)
    log(f"fluid 4M one card: {steps} steps {time.perf_counter() - t:.1f} s "
        f"(compile included)")
    ring = FluidSimulation(state, params, substeps=12, mesh=mesh)
    t = time.perf_counter()
    ring.run(steps)
    log(f"fluid 4M 1D ring x4: {steps} steps {time.perf_counter() - t:.1f} s "
        f"(compile included); metrics {json.dumps(ring.metrics())}")
    compare("fluid 4M 1D ring", one.dstate, ring.dstate)

    d0 = pack(state, params, one.spec)
    ref = make_dense_step(params, one.spec, substeps=steps,
                          donate=False)(d0)
    mesh2 = make_mesh_2d((2, 2), devs[:4])
    t = time.perf_counter()
    out = make_sharded_dense_step_2d(params, one.spec, mesh2,
                                     substeps=steps, donate=False)(d0)
    jax.block_until_ready(out.px)
    log(f"fluid 4M 2x2 mesh: {steps} steps {time.perf_counter() - t:.1f} s "
        f"(compile included)")
    compare("fluid 4M 2x2 mesh", ref, out)

    n, chunk = COLONY_BIG, 20
    states = {}
    for label, m in (("one card", None), ("1D ring x4", mesh)):
        cstate, cparams, genome = _colony(n)
        sim = Simulation(genome, cparams, auto_grow=False, donate=False,
                         scan_chunk=chunk, mesh=m)
        sim.state = cstate
        t = time.perf_counter()
        sim.run(2 * chunk)
        log(f"colony 1M {label}: {2 * chunk} steps "
            f"{time.perf_counter() - t:.1f} s (compile included)")
        states[label] = sim.state
    a, b = states["one card"], states["1D ring x4"]
    assert int(a.overflow) == int(b.overflow) == 0
    np.testing.assert_array_equal(np.asarray(a.bonds.active),
                                  np.asarray(b.bonds.active))
    check("colony 1M sharded pos vs one card",
          max_rel_err(b.pos, a.pos), 1e-6,
          "same contact sums; replicated bookkeeping")


# ---------------------------------------------------------------------------


PHASES = {"fluid": phase_fluid, "colony": phase_colony,
          "kernels": phase_kernels}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1)
    ap.add_argument("--only", default="",
                    help="comma-separated one-card phases to run "
                         f"({', '.join(PHASES)}); default all")
    args = ap.parse_args()

    import jax

    from sphsim.utils.compile_cache import setup_persistent_cache

    setup_persistent_cache()
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU found (JAX platform "
              f"{devs[0].platform!r}); nothing was run", file=sys.stderr)
        return 2
    from sphsim.utils.profiling import card_name_power

    smi = card_name_power()
    assert smi, "nvidia-smi reported no card"
    print("\n".join(smi), flush=True)
    log(f"jax {jax.__version__}: {len(devs)} x {devs[0].device_kind}")

    with jax.default_matmul_precision("highest"):
        if args.cards == 4:
            phase_sharded()
        else:
            names = args.only.split(",") if args.only else list(PHASES)
            for name in names:
                log(f"phase {name}: start")
                PHASES[name]()
                log(f"phase {name}: ok")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
