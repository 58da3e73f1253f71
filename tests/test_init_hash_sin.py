"""hash_sin init compat mode vs hand-evaluated HLSL values.

The reference seeds particles with `frac(sin(seed·k)·m)` hashes
(SimulateParticles.compute:118-194). `_init_fields_hash_sin` mirrors that
generator structurally; here we pin it against an independent NumPy f32
transliteration of the HLSL (the same executable-spec technique as the
golden model) plus literal values computed by hand, then prove the mode
survives a full engine run.
"""

import numpy as np
import jax.numpy as jnp

from sphsim.core.init import init_particles
from sphsim.engine.config import reference_genome, reference_scene_params
from sphsim.engine.simulation import Simulation

f32 = np.float32


def _frac_sin(seed, k, m):
    """HLSL frac(sin(seed·k)·m) in strict f32 (compute:134-141)."""
    x = np.sin(f32(seed) * f32(k), dtype=f32) * f32(m)
    return f32(x - np.floor(x))


def _expected_hlsl(i: int, n: int, spawn, rmin, rmax, n_modes, default_mode):
    """NumPy transliteration of InitParticles (compute:123-186)."""
    seed = f32(np.uint32(i * 65537 + 17))

    def rand3(k1, k2, k3):
        v = np.array([
            _frac_sin(seed, k1, 43758.5453) * 2 - 1,
            _frac_sin(seed, k2, 43758.5453) * 2 - 1,
            _frac_sin(seed, k3, 43758.5453) * 2 - 1,
        ], dtype=f32)
        return v / np.linalg.norm(v)

    if i == 0:
        pos = np.zeros(3, f32)
    else:
        d = rand3(12.9898, 78.233, 91.934)
        rv = _frac_sin(seed, 1.2345, 10000.0)
        pos = d * (np.cbrt(rv) * f32(spawn))
        if i > 1:
            rep = np.cbrt(f32(0.5) * f32(i) / f32(n)) * f32(spawn) * f32(0.1)
            pos = pos + rand3(45.678, 67.890, 12.345) * rep
    radius = f32(rmin) + (f32(rmax) - f32(rmin)) * _frac_sin(seed, 3.456, 999.0)
    drag = f32(0.5) + f32(0.5) * _frac_sin(seed, 5.6789, 888.0)
    if _frac_sin(seed, 78.123, 5432.1) < 0.5:
        mode = default_mode
    else:
        mode = int(_frac_sin(seed, 43.21, 8765.43) * n_modes)
    return pos, float(radius), float(drag), int(np.clip(mode, 0, n_modes - 1))


def test_hash_sin_matches_hlsl_transliteration():
    n = 8
    params = reference_scene_params(
        capacity=n, min_radius=1.0, max_radius=3.0, spawn_radius=15.0
    )
    st = init_particles(params, None, n_modes=4, initial_mode=0,
                        rng_mode="hash_sin")
    pos = np.asarray(st.pos)
    rad = np.asarray(st.radius)
    drag = np.asarray(st.drag)
    mode = np.asarray(st.mode)
    for i in range(n):
        e_pos, e_rad, e_drag, e_mode = _expected_hlsl(
            i, n, 15.0, 1.0, 3.0, 4, 0
        )
        np.testing.assert_allclose(pos[i], e_pos, rtol=2e-4, atol=2e-4,
                                   err_msg=f"pos[{i}]")
        np.testing.assert_allclose(rad[i], e_rad, rtol=2e-4,
                                   err_msg=f"radius[{i}]")
        np.testing.assert_allclose(drag[i], e_drag, rtol=2e-4,
                                   err_msg=f"drag[{i}]")
        if i > 0:  # slot 0's mode is forced to the initial mode (cs:516-523)
            assert mode[i] == e_mode, f"mode[{i}]"
    # Mass/inertia follow the HLSL formulas from the hashed radius
    # (compute:163-165): m = ρ·(4/3)πr³, I = (2/5)·m·r².
    vol = (4.0 / 3.0) * np.pi * rad ** 3
    np.testing.assert_allclose(np.asarray(st.mass), params.density * vol,
                               rtol=1e-5)
    np.testing.assert_allclose(np.asarray(st.inertia),
                               0.4 * np.asarray(st.mass) * rad ** 2, rtol=1e-5)


def test_hash_sin_literal_pins():
    """Literal values hand-evaluated from SimulateParticles.compute:123-186
    for the reference scene (spawnRadius 15, radius 2)."""
    params = reference_scene_params(capacity=8)
    st = init_particles(params, None, n_modes=1, initial_mode=0,
                        rng_mode="hash_sin")
    pos = np.asarray(st.pos)
    np.testing.assert_allclose(
        pos[1], [-5.802058, 3.405556, -8.576956], rtol=2e-4, atol=2e-4
    )
    np.testing.assert_allclose(
        pos[2], [2.976511, 11.643909, 7.008399], rtol=2e-4, atol=2e-4
    )
    np.testing.assert_allclose(
        pos[5], [-9.442224, -11.289720, -2.510788], rtol=2e-4, atol=2e-4
    )
    np.testing.assert_allclose(float(st.drag[1]), 0.693115, rtol=2e-4)
    np.testing.assert_allclose(float(st.drag[2]), 0.798370, rtol=2e-4)
    assert (pos[0] == 0).all()


def test_hash_sin_survives_full_sim():
    """The compat mode must run the reference scenario end-to-end: one cell
    grows and divides with adhesion exactly like the jax-RNG mode does."""
    params = reference_scene_params(capacity=16).replace(
        dt=1.0 / 60.0, max_splits_per_step=4, max_bonds=64
    )
    sim = Simulation(reference_genome(), params, rng_mode="hash_sin")
    sim.run(310)  # first division lands at sim-time t=5s
    m = sim.metrics()
    assert m["active_particles"] == 2
    assert m["bond_count"] == 1
    assert sim.particle_ids()[:2] == ["00.01.A", "00.02.B"]
    p = np.asarray(sim.state.pos[:2])
    assert np.isfinite(p).all()
