"""Particle initialization — the equivalent of the InitParticles kernel
(SimulateParticles.compute:118-194).

Default RNG is the JAX PRNG with the same distributions (uniform-in-sphere via
cube-root radial, radius ~ U[min,max], drag ~ U[0.5,1], mode 50% initial / 50%
uniform-random). A `hash_sin` compat mode reproduces the reference's
`frac(sin(seed·k)·m)` generator structurally for trace comparison.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from sphsim.core.types import GenomeDevice, SimParams, SimState


def _hash_sin(seed: jnp.ndarray, k: float, m: float) -> jnp.ndarray:
    """frac(sin(seed·k)·m) — the reference's hash PRNG (compute:134-141)."""
    x = jnp.sin(seed.astype(jnp.float32) * jnp.float32(k)) * jnp.float32(m)
    return x - jnp.floor(x)


def _init_fields_hash_sin(N: int, params: SimParams, n_modes: int,
                          default_mode: int):
    ids = jnp.arange(N, dtype=jnp.uint32)
    seed = (ids * 65537 + 17).astype(jnp.float32)  # compute:123

    def rand3(k1, k2, k3):
        return jnp.stack(
            [
                _hash_sin(seed, k1, 43758.5453) * 2 - 1,
                _hash_sin(seed, k2, 43758.5453) * 2 - 1,
                _hash_sin(seed, k3, 43758.5453) * 2 - 1,
            ],
            axis=-1,
        )

    dirv = rand3(12.9898, 78.233, 91.934)
    dirv = dirv / jnp.maximum(jnp.linalg.norm(dirv, axis=-1, keepdims=True), 1e-12)
    rand_val = _hash_sin(seed, 1.2345, 10000.0)
    dist = jnp.cbrt(rand_val) * params.spawn_radius
    pos = dirv * dist[:, None]
    # Stratified anti-clump nudge for id > 1 (compute:147-155).
    repel = jnp.cbrt(0.5 * ids.astype(jnp.float32) / N) * params.spawn_radius * 0.1
    nudge = rand3(45.678, 67.890, 12.345)
    nudge = nudge / jnp.maximum(jnp.linalg.norm(nudge, axis=-1, keepdims=True), 1e-12)
    pos = jnp.where((ids > 1)[:, None], pos + nudge * repel[:, None], pos)
    pos = jnp.where((ids == 0)[:, None], 0.0, pos)  # particle 0 at origin

    radius = params.min_radius + (params.max_radius - params.min_radius) * \
        _hash_sin(seed, 3.456, 999.0)
    drag = 0.5 + 0.5 * _hash_sin(seed, 5.6789, 888.0)

    if n_modes > 0:
        use_default = _hash_sin(seed, 78.123, 5432.1) < 0.5
        rand_mode = (_hash_sin(seed, 43.21, 8765.43) * n_modes).astype(jnp.int32)
        mode = jnp.where(use_default, default_mode, rand_mode)
        mode = jnp.clip(mode, 0, n_modes - 1)
    else:
        mode = jnp.full(N, -1, jnp.int32)
    return pos, radius, drag, mode


def _init_fields_jax(key: jnp.ndarray, N: int, params: SimParams, n_modes: int,
                     default_mode: int):
    k_dir, k_dist, k_rad, k_drag, k_pick, k_mode, k_nudge, k_repel = \
        jax.random.split(key, 8)
    dirv = jax.random.normal(k_dir, (N, 3), jnp.float32)
    dirv = dirv / jnp.maximum(jnp.linalg.norm(dirv, axis=-1, keepdims=True), 1e-12)
    dist = jnp.cbrt(jax.random.uniform(k_dist, (N,))) * params.spawn_radius
    pos = dirv * dist[:, None]
    ids = jnp.arange(N)
    repel = jnp.cbrt(0.5 * ids.astype(jnp.float32) / N) * params.spawn_radius * 0.1
    nudge = jax.random.normal(k_nudge, (N, 3), jnp.float32)
    nudge = nudge / jnp.maximum(jnp.linalg.norm(nudge, axis=-1, keepdims=True), 1e-12)
    pos = jnp.where((ids > 1)[:, None], pos + nudge * repel[:, None], pos)
    pos = jnp.where((ids == 0)[:, None], 0.0, pos)

    radius = jax.random.uniform(
        k_rad, (N,), minval=params.min_radius, maxval=params.max_radius
    )
    drag = jax.random.uniform(k_drag, (N,), minval=0.5, maxval=1.0)
    if n_modes > 0:
        use_default = jax.random.uniform(k_pick, (N,)) < 0.5
        rand_mode = jax.random.randint(k_mode, (N,), 0, n_modes)
        mode = jnp.where(use_default, default_mode, rand_mode).astype(jnp.int32)
    else:
        mode = jnp.full(N, -1, jnp.int32)
    return pos, radius, drag, mode


def init_particles(
    params: SimParams,
    genome_dev: GenomeDevice | None,
    n_modes: int,
    initial_mode: int,
    capacity: int | None = None,
    active_count: int = 1,
    seed: int = 0,
    rng_mode: str = "jax",
) -> SimState:
    """Build a fresh SimState.

    Mirrors Start()/InitializeParticles (cs:211-233, :484-552): all capacity
    slots get initialized fields, `active_count` defaults to 1, and slot 0's
    mode is forced to the genome's initial mode (cs:516-523).
    """
    N = capacity if capacity is not None else params.capacity
    state = SimState.zeros(N, params, seed=seed)
    key, sub = jax.random.split(state.rng)

    if rng_mode == "hash_sin":
        pos, radius, drag, mode = _init_fields_hash_sin(
            N, params, n_modes, initial_mode
        )
    else:
        pos, radius, drag, mode = _init_fields_jax(
            sub, N, params, n_modes, initial_mode
        )

    volume = (4.0 / 3.0) * jnp.pi * radius ** 3
    mass = params.density * volume
    inertia = 0.4 * mass * radius ** 2

    mode = mode.at[0].set(initial_mode if n_modes > 0 else -1)

    # Root cell identity: 00.00.A (cs:490-493).
    uid = jnp.full(N, -1, jnp.int32).at[0].set(0)

    return state.replace_fields(
        pos=pos.astype(jnp.float32),
        radius=radius.astype(jnp.float32),
        mass=mass.astype(jnp.float32),
        inertia=inertia.astype(jnp.float32),
        drag=drag.astype(jnp.float32),
        mode=mode,
        uid=uid,
        active_count=jnp.int32(active_count),
        next_uid=jnp.int32(1),
        rng=key,
    )
