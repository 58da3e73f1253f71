"""Weakly-compressible SPH (WCSPH) fluid model.

Second ForceModel behind the same neighbor machinery as the contact sim
(SURVEY §7 step 6): poly6 density, Tait EOS, spiky pressure gradient
(symmetric p/ρ² form), viscosity Laplacian, gravity, symplectic-Euler
integration, box boundaries with damped reflection, optional SDF obstacle
colliders (BASELINE configs 0-3).

2D scenes embed in 3D with z = 0 and a 1-cell-deep grid; kernel
normalizations use the true dimensionality.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp

from sphsim.core.types import pytree_dataclass
from sphsim.ops.grid import (
    GridSpec,
    cell_coords,
    sort_by_cell,
    stencil_candidates_sorted,
)
from sphsim.sph import kernels as K


@dataclass(frozen=True)
class SPHParams:
    """Static fluid parameters. Cell size = support radius h, so one 27-cell
    stencil covers the kernel support exactly."""

    ndim: int = 3
    h: float = 0.1                    # support radius
    rest_density: float = 1000.0
    particle_mass: float = 1.0
    sound_speed: float = 20.0         # Tait EOS stiffness: B = ρ0·c²/γ
    gamma: float = 7.0
    viscosity: float = 0.1            # dynamic viscosity μ
    gravity: float = 9.81
    dt: float = 4e-4
    bounds_min: tuple[float, float, float] = (0.0, 0.0, 0.0)
    bounds_max: tuple[float, float, float] = (1.0, 1.0, 1.0)
    boundary_damping: float = 0.5     # velocity restitution on wall hit
    # With h = 1.3·dx a cell holds ~2.2 particles at rest density; 16 leaves
    # ample headroom for compression and wall pile-up (overflow is counted).
    cell_capacity: int = 16
    row_block: int = 4096
    # Dense-grid engine knobs (sphsim.sph.dense): slots per cell, cell size
    # as a multiple of h (≥ 1 required by the ±1-cell stencil coverage
    # argument), the pair-pass route and the rebin cadence (velocities are
    # clamped so drift between rebins stays within the stencil margin).
    # dense_k, cell_factor and rebin_every are not yet measured on the
    # card. use_pallas: True = the Triton kernels (raises without a GPU;
    # the default, as the kernels won on every cell measured, PERF.md);
    # False = the XLA twin; "interpret" = the kernels in the Pallas
    # interpreter (ops/pallas/sweep.kernel_mode).
    dense_k: int = 8
    cell_factor: float = 1.25
    use_pallas: bool | str = True
    rebin_every: int = 6
    # SDF obstacles: tuple of (kind, params...) — see sdf_obstacles().
    obstacles: tuple = ()
    obstacle_stiffness: float = 3e4

    @property
    def tait_b(self) -> float:
        return self.rest_density * self.sound_speed ** 2 / self.gamma

    def grid_spec(self) -> GridSpec:
        # Pure-Python math: this runs during tracing, so no jnp here.
        lo, hi = self.bounds_min, self.bounds_max
        # One cell of margin so wall-adjacent particles never clamp across.
        dims = []
        for a in range(3):
            extent = hi[a] - lo[a]
            d = (
                max(1, int(-(-extent // self.h)) + 2) if extent > 0 else 1
            )
            dims.append(d)
        if self.ndim == 2:
            dims[2] = 1
        return GridSpec(
            dim=tuple(dims),
            cell_size=self.h,
            origin=(
                lo[0] - self.h, lo[1] - self.h,
                lo[2] - (self.h if self.ndim == 3 else 0.0),
            ),
            cell_capacity=self.cell_capacity,
        )

    def replace(self, **kw) -> "SPHParams":
        import dataclasses

        return dataclasses.replace(self, **kw)


@pytree_dataclass
class SPHState:
    """Flat SoA fluid state (pos/vel/density/pressure per the north star)."""

    pos: jnp.ndarray       # [N,3] (z = 0 in 2D)
    vel: jnp.ndarray       # [N,3]
    density: jnp.ndarray   # [N]
    pressure: jnp.ndarray  # [N]
    step_count: jnp.ndarray
    bin_overflow: jnp.ndarray

    @staticmethod
    def from_positions(pos: jnp.ndarray, params: SPHParams) -> "SPHState":
        n = pos.shape[0]
        return SPHState(
            pos=pos.astype(jnp.float32),
            vel=jnp.zeros((n, 3), jnp.float32),
            density=jnp.full(n, params.rest_density, jnp.float32),
            pressure=jnp.zeros(n, jnp.float32),
            step_count=jnp.int32(0),
            bin_overflow=jnp.int32(0),
        )


@pytree_dataclass
class FluidDrag:
    """Interactive drag for the fluid regime (K5 analog,
    SimulateParticles.compute:311-324).

    The reference drags ONE particle by id; dense-fluid slots migrate on
    rebin, so this redesign anchors the drag in SPACE: every
    particle within `radius` of `center` gets the reference's impulse form
    `(target − pos)·strength·dt/mass`. The viewer re-centers the sphere on
    the picked fluid each frame, which follows the dragged blob the way the
    reference follows the dragged particle. strength ≤ 0 disables (inert
    default, so one compiled step serves both modes)."""

    center: jnp.ndarray     # [3]
    radius: jnp.ndarray     # scalar
    target: jnp.ndarray     # [3]
    strength: jnp.ndarray   # scalar; <= 0 ⇒ no-op

    @staticmethod
    def none() -> "FluidDrag":
        z = jnp.zeros(3, jnp.float32)
        return FluidDrag(center=z, radius=jnp.float32(0.0), target=z,
                         strength=jnp.float32(0.0))

    @staticmethod
    def at(center, target, radius, strength=100.0) -> "FluidDrag":
        return FluidDrag(
            center=jnp.asarray(center, jnp.float32),
            radius=jnp.float32(radius),
            target=jnp.asarray(target, jnp.float32),
            strength=jnp.float32(strength),
        )


# ---------------------------------------------------------------------------
# SDF obstacles (config[3]): signed-distance colliders with penalty forces.
# ---------------------------------------------------------------------------


def sdf_value_grad(pos: jnp.ndarray, obstacle) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Signed distance + outward normal for one obstacle.

    Obstacle specs (static python data):
      ("sphere", (cx, cy, cz), r)
      ("box", (cx, cy, cz), (hx, hy, hz))
      ("cylinder_z", (cx, cy), r)    — infinite along z
    """
    kind = obstacle[0]
    if kind == "sphere":
        c = jnp.asarray(obstacle[1], jnp.float32)
        r = obstacle[2]
        d = pos - c
        dist = jnp.linalg.norm(d, axis=-1)
        return dist - r, d / jnp.maximum(dist, 1e-9)[..., None]
    if kind == "box":
        c = jnp.asarray(obstacle[1], jnp.float32)
        half = jnp.asarray(obstacle[2], jnp.float32)
        q = jnp.abs(pos - c) - half
        outside = jnp.maximum(q, 0.0)
        dist_out = jnp.linalg.norm(outside, axis=-1)
        dist_in = jnp.minimum(jnp.max(q, axis=-1), 0.0)
        sd = dist_out + dist_in
        # Gradient via the same closed form (numerically robust enough for
        # penalty forces): outside → normalized clamp, inside → axis of max q.
        grad_out = jnp.sign(pos - c) * outside / jnp.maximum(dist_out, 1e-9)[..., None]
        ax = jnp.argmax(q, axis=-1)
        grad_in = jnp.sign(pos - c) * jax.nn.one_hot(ax, 3, dtype=pos.dtype)
        return sd, jnp.where((dist_out > 0)[..., None], grad_out, grad_in)
    if kind == "cylinder_z":
        c = jnp.asarray(obstacle[1], jnp.float32)
        r = obstacle[2]
        d = pos[..., :2] - c
        dist = jnp.linalg.norm(d, axis=-1)
        n2 = d / jnp.maximum(dist, 1e-9)[..., None]
        normal = jnp.concatenate([n2, jnp.zeros_like(pos[..., 2:3])], axis=-1)
        return dist - r, normal
    raise ValueError(f"unknown obstacle kind {kind!r}")


def obstacle_accel(pos: jnp.ndarray, params: SPHParams) -> jnp.ndarray:
    """Penalty acceleration pushing particles out of obstacle interiors
    (plus a thin boundary layer of h/2)."""
    acc = jnp.zeros_like(pos)
    for ob in params.obstacles:
        sd, normal = sdf_value_grad(pos, ob)
        pen = jnp.maximum(params.h * 0.5 - sd, 0.0)
        acc = acc + normal * (pen * params.obstacle_stiffness)[..., None]
    return acc


# ---------------------------------------------------------------------------
# Density / force passes
# ---------------------------------------------------------------------------


def _row_blocked(N: int, row_block: int, block_fn):
    """Apply block_fn over row blocks and concatenate (bounds peak memory of
    the [R, 27K] candidate tensors)."""
    R = min(row_block, N)
    nb = -(-N // R)
    if nb == 1:
        out = block_fn(jnp.int32(0))
        return jax.tree_util.tree_map(lambda x: x[:N], out)
    outs = jax.lax.map(block_fn, jnp.arange(nb, dtype=jnp.int32))
    return jax.tree_util.tree_map(
        lambda x: x.reshape(nb * R, *x.shape[2:])[:N], outs
    )


def _density_sorted(pos, coords, bins, spec, params: SPHParams):
    """ρ over SORTED particle rows (self term included via the r²=0 lane)."""
    N = pos.shape[0]
    h2 = params.h * params.h

    def block(b):
        rows = jnp.minimum(b * min(params.row_block, N) + jnp.arange(
            min(params.row_block, N)), N - 1)
        cand = stencil_candidates_sorted(coords[rows], bins, spec)
        cj = jnp.clip(cand, 0, N - 1)
        d = pos[rows][:, None, :] - pos[cj]
        r2 = jnp.sum(d * d, axis=-1)
        w = jnp.where(
            (cand >= 0) & (r2 < h2), K.w_poly6(r2, params.h, params.ndim), 0.0
        )
        return params.particle_mass * jnp.sum(w, axis=1)

    return jnp.maximum(_row_blocked(N, params.row_block, block), 1e-6)


def _accel_sorted(pos, vel, rho, p, coords, bins, spec, params: SPHParams):
    """Pressure + viscosity acceleration over SORTED rows."""
    N = pos.shape[0]
    h = params.h
    m = params.particle_mass
    p_over_rho2 = p / (rho * rho)

    def block(b):
        rows = jnp.minimum(b * min(params.row_block, N) + jnp.arange(
            min(params.row_block, N)), N - 1)
        cand = stencil_candidates_sorted(coords[rows], bins, spec)
        cj = jnp.clip(cand, 0, N - 1)
        d = pos[rows][:, None, :] - pos[cj]
        r2 = jnp.sum(d * d, axis=-1)
        r = jnp.sqrt(jnp.maximum(r2, 1e-18))
        near = (cand >= 0) & (r2 < h * h) & (r2 > 1e-16)

        grad = K.grad_w_spiky(d, r, h, params.ndim)
        pij = p_over_rho2[rows][:, None] + p_over_rho2[cj]
        a_press = -m * jnp.sum(
            jnp.where(near[..., None], grad * pij[..., None], 0.0), axis=1
        )
        lap = K.lap_w_viscosity(r, h, params.ndim)
        dv = vel[cj] - vel[rows][:, None, :]
        a_visc = params.viscosity * m * jnp.sum(
            jnp.where(
                near[..., None],
                dv * (lap / (rho[rows][:, None] * rho[cj]))[..., None],
                0.0,
            ),
            axis=1,
        )
        return a_press + a_visc

    return _row_blocked(N, params.row_block, block)


def _external_accel(pos, acc, params: SPHParams):
    g = jnp.zeros(3, jnp.float32).at[1].set(-params.gravity)
    acc = acc + g
    if params.obstacles:
        acc = acc + obstacle_accel(pos, params)
    if params.ndim == 2:
        acc = acc.at[:, 2].set(0.0)
    return acc


def compute_density(state: SPHState, params: SPHParams):
    """ρ in input particle order (sorted pipeline + inverse permutation)."""
    spec = params.grid_spec()
    order, bins = sort_by_cell(state.pos, spec)
    pos_s = state.pos[order]
    rho_s = _density_sorted(pos_s, cell_coords(pos_s, spec), bins, spec, params)
    N = state.pos.shape[0]
    rho = jnp.zeros(N, rho_s.dtype).at[order].set(rho_s)
    return rho, bins.overflow


def eos_pressure(rho: jnp.ndarray, params: SPHParams) -> jnp.ndarray:
    """Tait equation of state, clamped ≥ 0 against tensile instability."""
    p = params.tait_b * ((rho / params.rest_density) ** params.gamma - 1.0)
    return jnp.maximum(p, 0.0)


def compute_accel(state: SPHState, params: SPHParams) -> jnp.ndarray:
    """Acceleration in input particle order (sorted pipeline inside)."""
    spec = params.grid_spec()
    order, bins = sort_by_cell(state.pos, spec)
    pos_s, vel_s = state.pos[order], state.vel[order]
    rho_s, p_s = state.density[order], state.pressure[order]
    acc_s = _accel_sorted(
        pos_s, vel_s, rho_s, p_s, cell_coords(pos_s, spec), bins, spec, params
    )
    acc_s = _external_accel(pos_s, acc_s, params)
    N = state.pos.shape[0]
    return jnp.zeros((N, 3), acc_s.dtype).at[order].set(acc_s)


def apply_boundaries(pos, vel, params: SPHParams):
    """Box walls: clamp position, damp + reflect the normal velocity."""
    lo = jnp.asarray(params.bounds_min, jnp.float32)
    hi = jnp.asarray(params.bounds_max, jnp.float32)
    if params.ndim == 2:
        lo = lo.at[2].set(-1.0)
        hi = hi.at[2].set(1.0)
    below = pos < lo
    above = pos > hi
    hit = below | above
    pos = jnp.clip(pos, lo, hi)
    vel = jnp.where(hit, -params.boundary_damping * vel, vel)
    return pos, vel


def sph_step(state: SPHState, params: SPHParams) -> SPHState:
    """One WCSPH step: sort by cell → density → EOS → forces → symplectic
    Euler → walls.

    Fluid particles carry no identity, so the cell-sort permutation is kept —
    the output state IS in sorted order. This makes every neighbor gather
    (mostly) contiguous in device memory, which keeps the bandwidth-bound
    pipeline streaming (SURVEY §7).
    """
    spec = params.grid_spec()
    order, bins = sort_by_cell(state.pos, spec)
    pos = state.pos[order]
    vel = state.vel[order]
    coords = cell_coords(pos, spec)

    rho = _density_sorted(pos, coords, bins, spec, params)
    p = eos_pressure(rho, params)
    acc = _accel_sorted(pos, vel, rho, p, coords, bins, spec, params)
    acc = _external_accel(pos, acc, params)

    vel = vel + acc * params.dt
    pos = pos + vel * params.dt
    pos, vel = apply_boundaries(pos, vel, params)
    return SPHState(
        pos=pos, vel=vel, density=rho, pressure=p,
        step_count=state.step_count + 1,
        bin_overflow=state.bin_overflow + bins.overflow,
    )


_SPH_STEP_CACHE: dict = {}


def make_sph_step(params: SPHParams, donate: bool = True, substeps: int = 1):
    key = (params, donate, substeps)
    if key not in _SPH_STEP_CACHE:
        def f(st):
            if substeps == 1:
                return sph_step(st, params)
            return jax.lax.scan(
                lambda s, _: (sph_step(s, params), None), st, None,
                length=substeps,
            )[0]
        _SPH_STEP_CACHE[key] = jax.jit(f, donate_argnums=(0,) if donate else ())
    return _SPH_STEP_CACHE[key]


# -- brute-force reference paths (executable spec; BASELINE config[0]) -------


def compute_density_bruteforce(state: SPHState, params: SPHParams):
    d = state.pos[:, None, :] - state.pos[None, :, :]
    r2 = jnp.sum(d * d, axis=-1)
    w = jnp.where(r2 < params.h ** 2, K.w_poly6(r2, params.h, params.ndim), 0.0)
    return jnp.maximum(params.particle_mass * jnp.sum(w, axis=1), 1e-6)


def compute_accel_bruteforce(state: SPHState, params: SPHParams):
    h = params.h
    m = params.particle_mass
    rho, p = state.density, state.pressure
    pr2 = p / (rho * rho)
    d = state.pos[:, None, :] - state.pos[None, :, :]
    r2 = jnp.sum(d * d, axis=-1)
    r = jnp.sqrt(jnp.maximum(r2, 1e-18))
    near = (r2 < h * h) & (r2 > 1e-16)
    grad = K.grad_w_spiky(d, r, h, params.ndim)
    a_press = -m * jnp.sum(
        jnp.where(near[..., None], grad * (pr2[:, None] + pr2[None, :])[..., None], 0.0),
        axis=1,
    )
    lap = K.lap_w_viscosity(r, h, params.ndim)
    dv = state.vel[None, :, :] - state.vel[:, None, :]
    a_visc = params.viscosity * m * jnp.sum(
        jnp.where(near[..., None], dv * (lap / (rho[:, None] * rho[None, :]))[..., None], 0.0),
        axis=1,
    )
    acc = a_press + a_visc + jnp.zeros(3).at[1].set(-params.gravity)
    if params.obstacles:
        acc = acc + obstacle_accel(state.pos, params)
    if params.ndim == 2:
        acc = acc.at[:, 2].set(0.0)
    return acc
