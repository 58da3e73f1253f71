"""Spatial-hash neighbor grid — sort-based, race-free replacement for the
reference's atomic linked-list grid (ClearGrid/BuildHashGrid/ApplySPHForces
traversal, SimulateParticles.compute:102-116, :196-209, :228-233).

Design (DESIGN.md, SURVEY §7): no atomics — particles are sorted by
cell id, ranked within their cell, and scattered into dense fixed-capacity
bins [n_cells, K]. The 27-cell stencil then becomes a static gather of
[27·K] candidates per particle, which XLA vectorizes. Overflow
(cell fuller than K) is counted and surfaced, never silently dropped —
`counts` still reports true occupancy.

Grid geometry matches the reference: coord = clamp((pos + half_extent)/cell,
0, dim−1) with linear hash x + y·dim + z·dim² (compute:102-109); out-of-range
positions clamp into edge cells.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp

from sphsim.core.types import SimParams, SimState, pytree_dataclass


@dataclass(frozen=True)
class GridSpec:
    """Static grid geometry (parameterized; reference hardcodes 32³ × 4.0)."""

    dim: tuple[int, int, int]
    cell_size: float
    origin: tuple[float, float, float]  # world position of cell (0,0,0) corner
    cell_capacity: int

    @property
    def n_cells(self) -> int:
        return self.dim[0] * self.dim[1] * self.dim[2]

    @staticmethod
    def from_params(params: SimParams) -> "GridSpec":
        d = params.grid_dim
        r = params.spawn_radius
        return GridSpec(
            dim=(d, d, d),
            cell_size=params.grid_cell_size,
            origin=(-r, -r, -r),
            cell_capacity=params.cell_capacity,
        )


def cell_coords(pos: jnp.ndarray, spec: GridSpec) -> jnp.ndarray:
    """Clamped integer cell coordinates (compute:102-105)."""
    g = (pos - jnp.asarray(spec.origin, jnp.float32)) / spec.cell_size
    dims = jnp.asarray(spec.dim, jnp.int32)
    return jnp.clip(g.astype(jnp.int32), 0, dims - 1)


def cell_ids(coords: jnp.ndarray, spec: GridSpec) -> jnp.ndarray:
    """Linear hash x + y·dimx + z·dimx·dimy (compute:107-109)."""
    dx, dy, _ = spec.dim
    return coords[..., 0] + coords[..., 1] * dx + coords[..., 2] * dx * dy


@pytree_dataclass
class Bins:
    """Dense per-cell particle index table.

    idx: [n_cells, K] particle indices, -1 for empty lanes.
    counts: [n_cells] true occupancy (may exceed K; overflow is dropped
    from idx but counted).
    overflow: scalar number of particles that did not fit their cell.
    """

    idx: jnp.ndarray
    counts: jnp.ndarray
    overflow: jnp.ndarray


def build_bins(pos: jnp.ndarray, alive: jnp.ndarray, spec: GridSpec) -> Bins:
    """Sort + rank + scatter: deterministic replacement for the
    InterlockedExchange list push (compute:207)."""
    N = pos.shape[0]
    C = spec.n_cells
    K = spec.cell_capacity

    cid = cell_ids(cell_coords(pos, spec), spec)
    cid = jnp.where(alive, cid, C)  # dead particles go to the trash cell

    order = jnp.argsort(cid)                     # stable: ties by slot index
    cid_sorted = cid[order]
    # starts[c] = first sorted position of cell c.
    starts = jnp.searchsorted(cid_sorted, jnp.arange(C + 1), side="left")
    counts = jnp.diff(starts)                    # [C]
    rank = jnp.arange(N) - starts[jnp.minimum(cid_sorted, C)]

    fits = (cid_sorted < C) & (rank < K)
    flat_target = jnp.where(fits, cid_sorted * K + rank, C * K)
    idx_flat = jnp.full(C * K + 1, -1, jnp.int32).at[flat_target].set(
        order.astype(jnp.int32)
    )
    overflow = jnp.sum((cid_sorted < C) & (rank >= K))
    return Bins(
        idx=idx_flat[: C * K].reshape(C, K),
        counts=counts.astype(jnp.int32),
        overflow=overflow.astype(jnp.int32),
    )


def stencil_candidates(coords: jnp.ndarray, bins: Bins, spec: GridSpec):
    """For each query coordinate, gather the 27-cell (3×3×3) stencil's bin
    contents → candidate particle indices [N, 27·K] (-1 = empty/out of
    bounds). The reference walks the same stencil per thread
    (compute:228-233)."""
    dims = jnp.asarray(spec.dim, jnp.int32)
    offsets = jnp.stack(
        jnp.meshgrid(
            jnp.arange(-1, 2), jnp.arange(-1, 2), jnp.arange(-1, 2),
            indexing="ij",
        ),
        axis=-1,
    ).reshape(27, 3)  # [27, 3] in (x, y, z) order per meshgrid(ij) of x,y,z

    nb = coords[:, None, :] + offsets[None, :, :]          # [N, 27, 3]
    in_bounds = jnp.all((nb >= 0) & (nb < dims), axis=-1)  # [N, 27]
    nb_clamped = jnp.clip(nb, 0, dims - 1)
    nb_cid = cell_ids(nb_clamped, spec)                    # [N, 27]
    cand = bins.idx[nb_cid]                                # [N, 27, K]
    cand = jnp.where(in_bounds[..., None], cand, -1)
    return cand.reshape(coords.shape[0], -1)               # [N, 27K]


# ---------------------------------------------------------------------------
# Sorted layout: the fluid path reorders particle data by cell every step, so
# neighbor gathers hit (mostly) contiguous memory and bins need no scatter —
# cell c's members are sorted rows [starts[c], starts[c]+counts[c]).
# ---------------------------------------------------------------------------


@pytree_dataclass
class SortedBins:
    """Cell ranges over the SORTED particle order."""

    starts: jnp.ndarray    # [C+1] first sorted row of each cell
    counts: jnp.ndarray    # [C]
    overflow: jnp.ndarray  # particles beyond cell_capacity (missed as
    #                        neighbors; counted, never silent)


def sort_by_cell(pos: jnp.ndarray, spec: GridSpec):
    """Returns (order, SortedBins): `order` is the permutation that sorts
    particles by cell id (stable)."""
    C = spec.n_cells
    cid = cell_ids(cell_coords(pos, spec), spec)
    order = jnp.argsort(cid)
    cid_sorted = cid[order]
    starts = jnp.searchsorted(cid_sorted, jnp.arange(C + 1), side="left")
    counts = jnp.diff(starts).astype(jnp.int32)
    overflow = jnp.sum(jnp.maximum(counts - spec.cell_capacity, 0))
    return order, SortedBins(
        starts=starts.astype(jnp.int32), counts=counts,
        overflow=overflow.astype(jnp.int32),
    )


def stencil_candidates_sorted(
    coords: jnp.ndarray, bins: SortedBins, spec: GridSpec
) -> jnp.ndarray:
    """For each query coordinate: sorted-row indices of all particles in the
    3×3×3 stencil, as [Q, 27·K] (-1 = empty lane / out of bounds)."""
    K = spec.cell_capacity
    dims = jnp.asarray(spec.dim, jnp.int32)
    offsets = jnp.stack(
        jnp.meshgrid(
            jnp.arange(-1, 2), jnp.arange(-1, 2), jnp.arange(-1, 2),
            indexing="ij",
        ),
        axis=-1,
    ).reshape(27, 3)

    nb = coords[:, None, :] + offsets[None, :, :]           # [Q, 27, 3]
    in_bounds = jnp.all((nb >= 0) & (nb < dims), axis=-1)   # [Q, 27]
    nb_cid = cell_ids(jnp.clip(nb, 0, dims - 1), spec)      # [Q, 27]
    lane = jnp.arange(K, dtype=jnp.int32)
    cand = bins.starts[nb_cid][..., None] + lane            # [Q, 27, K]
    valid = in_bounds[..., None] & (lane < bins.counts[nb_cid][..., None])
    cand = jnp.where(valid, cand, -1)
    return cand.reshape(coords.shape[0], -1)


def contact_forces_grid(state: SimState, params: SimParams,
                        row_block: int = 2048):
    """Grid-accelerated contact sums; must match contact_forces_bruteforce
    exactly whenever the interaction radius fits one cell.

    Returns (force, torque, overflow): particles beyond a cell's capacity K
    are absent from the candidate bins (they exert/receive no force this
    step) but COUNTED — the module contract, never silently dropped."""
    from sphsim.physics.contact import pair_contact

    N = state.capacity
    spec = GridSpec.from_params(params)
    alive = jnp.arange(N) < state.active_count
    bins = build_bins(state.pos, alive, spec)
    coords = cell_coords(state.pos, spec)

    nb = max(1, -(-N // row_block))
    padded = nb * row_block

    def block(b):
        i0 = b * row_block
        rows = jnp.minimum(i0 + jnp.arange(row_block), N - 1)
        cand = stencil_candidates(coords[rows], bins, spec)   # [R, 27K]
        cj = jnp.clip(cand, 0, N - 1)
        valid = (cand >= 0) & (cand != rows[:, None]) & alive[rows][:, None]
        f, t = pair_contact(
            state.pos[rows][:, None], state.vel[rows][:, None],
            state.ang_vel[rows][:, None], state.radius[rows][:, None],
            state.pos[cj], state.vel[cj], state.ang_vel[cj], state.radius[cj],
            valid, params,
        )
        return f.sum(axis=1), t.sum(axis=1)

    if nb == 1:
        force, torque = block(jnp.int32(0))
        force, torque = force[:N], torque[:N]
    else:
        fb, tb = jax.lax.map(block, jnp.arange(nb, dtype=jnp.int32))
        force = fb.reshape(padded, 3)[:N]
        torque = tb.reshape(padded, 3)[:N]
    return force, torque, bins.overflow
