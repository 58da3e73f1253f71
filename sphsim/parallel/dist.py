"""Multi-device spatial domain decomposition.

The dense layout [N0, K, C=Y·X] (sphsim.sph.dense) is sharded over layout
dim 0 (world x in 3D) across a 1D device mesh — or over BOTH layout dim 0
and the row blocks of the fused axis (world y) across a 2D (pz × py) mesh
(`make_sharded_dense_step_2d`). Each step exchanges one-plane / one-row
halos with the neighbors via `jax.lax.ppermute` inside `shard_map`; 2D
corner cells arrive transitively (rows padded first, then planes — the
plane exchange ships row-padded boundary planes).

Why this is correct with zero special cases: the unsharded engine's rolls
wrap around dim 0 into the sentinel margin ring. Under a wrapping ppermute
ring, shard 0's left halo is the LAST shard's last plane — which is the
global right margin, i.e. sentinel. So the sharded halo ring reproduces the
unsharded wrap semantics exactly (asserted in tests/test_dist.py).

Per step: 3 halo exchanges (positions for density, rho/pressure for forces,
post-integration state for rebin), each 2 planes × fields — O(N1·L) bytes.
The cards of one host are joined all to all, so the mesh follows the
algorithm alone: devices in id order. The reference has no distributed
layer at all (SURVEY §2.13-2.16).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from sphsim.sph.dense import (
    SENTINEL,
    DenseFluidState,
    DenseSpec,
    _integrate,
    pair_accel,
    pair_density,
    rebin,
    rebin_vmax,
)
from sphsim.sph.model import SPHParams, eos_pressure


def exchange_halo(arr: jnp.ndarray, axis_name: str) -> jnp.ndarray:
    """[P, ...] local slab → [P+2, ...] with neighbor halo planes.

    Wrapping ring: matches the unsharded engine's dim-0 roll wraparound
    (inert, since the wrapped planes are the global sentinel margins).
    """
    n = jax.lax.axis_size(axis_name)
    fwd = [(i, (i + 1) % n) for i in range(n)]   # send toward +dim0
    bwd = [(i, (i - 1) % n) for i in range(n)]
    # My last plane becomes my +1 neighbor's left halo, and vice versa.
    left_halo = jax.lax.ppermute(arr[-1:], axis_name, fwd)
    right_halo = jax.lax.ppermute(arr[:1], axis_name, bwd)
    return jnp.concatenate([left_halo, arr, right_halo], axis=0)


def _local_step(d: DenseFluidState, params: SPHParams, spec: DenseSpec,
                axis_name: str) -> DenseFluidState:
    """One step on a local slab, with halo exchanges where planes of
    neighbor data are needed. Interior = [1:-1] of every padded tensor."""
    ex = functools.partial(exchange_halo, axis_name=axis_name)

    def pad_state(st, fields):
        return st.replace_fields(**{f: ex(getattr(st, f)) for f in fields})

    # --- density (needs ONLY neighbor positions + occupancy; shipping
    # vel/rho/prs halos here would be 2-3× the necessary bytes per step) ---
    dp = pad_state(d, ("px", "py", "pz", "occ"))
    rho_p = pair_density(dp, params, spec)
    prs_p = jnp.where(dp.occ > 0.5, eos_pressure(rho_p, params), 0.0)

    # --- forces: additionally need neighbor velocities and rho/prs. The
    # rho/prs halos must come from the OWNER's full-stencil values (the
    # locally computed halo planes saw positions only), hence the second
    # exchange. ---
    rho_own = rho_p[1:-1]
    prs_own = prs_p[1:-1]
    rho_pad = ex(rho_own)
    prs_pad = ex(prs_own)
    dp = dp.replace_fields(
        vx=ex(d.vx), vy=ex(d.vy), vz=ex(d.vz),
        rho=rho_pad, prs=prs_pad,
    )
    ax, ay, az = pair_accel(dp, params, spec)

    dpi = d.replace_fields(rho=rho_own, prs=prs_own)
    px, py, pz, vx, vy, vz, n_clamped = _integrate(
        dp, ax, ay, az, params, rebin_vmax(params, spec),
    )
    # Clamp diagnostic: counted on the padded slab, so boundary-plane hits
    # can double-count across shards (alarm semantics, like `dropped`);
    # psum keeps the replicated counter identical on every shard.
    n_clamped = jax.lax.psum(n_clamped, axis_name)
    px, py, pz = px[1:-1], py[1:-1], pz[1:-1]
    vx, vy, vz = vx[1:-1], vy[1:-1], vz[1:-1]

    def do_rebin(args):
        px, py, pz, vx, vy, vz = args
        # Rebin on the padded slab: emigrants into halo planes land in the
        # neighbor's interior via ITS copy of our boundary plane.
        dpad = pad_state(
            dpi.replace_fields(px=px, py=py, pz=pz, vx=vx, vy=vy, vz=vz),
            ("px", "py", "pz", "vx", "vy", "vz", "occ"),
        )
        p_local = px.shape[0]
        offset = jax.lax.axis_index(axis_name) * p_local - 1
        out = rebin(
            dpad, dpad.px, dpad.py, dpad.pz, dpad.vx, dpad.vy,
            dpad.vz, params, spec, dim0_offset=offset,
        )
        # Diagnostic drop count: psum of local counts (shard-edge cells are
        # compacted on both owners, so edge drops can double-count — this is
        # an overflow alarm, not an exact tally).
        local_drops = out.dropped - dpi.dropped
        total_drops = jax.lax.psum(local_drops, axis_name)
        return dpi.replace_fields(
            px=out.px[1:-1], py=out.py[1:-1], pz=out.pz[1:-1],
            vx=out.vx[1:-1], vy=out.vy[1:-1], vz=out.vz[1:-1],
            occ=out.occ[1:-1],
            dropped=dpi.dropped + total_drops,
        )

    def no_rebin(args):
        px, py, pz, vx, vy, vz = args
        return dpi.replace_fields(px=px, py=py, pz=pz,
                                  vx=vx, vy=vy, vz=vz)

    if params.rebin_every == 1:
        d = do_rebin((px, py, pz, vx, vy, vz))
    else:
        d = jax.lax.cond(
            d.step_count % params.rebin_every == params.rebin_every - 1,
            do_rebin, no_rebin, (px, py, pz, vx, vy, vz),
        )
    return d.replace_fields(
        step_count=d.step_count + 1, clamped=d.clamped + n_clamped
    )


def _pad_fill(params: SPHParams) -> dict[str, float]:
    """Per-field fill value for inert (sentinel/empty) planes."""
    return dict(px=SENTINEL, py=SENTINEL, pz=SENTINEL,
                vx=0.0, vy=0.0, vz=0.0, occ=0.0,
                rho=params.rest_density, prs=0.0)


def make_sharded_dense_step(params: SPHParams, spec: DenseSpec, mesh: Mesh,
                            substeps: int = 1, donate: bool = True):
    """Jitted multi-device step: dense state sharded over layout dim 0.

    When `spec.n0` is not a multiple of the device count, the state is
    padded with inert sentinel planes (appended past the top margin, so
    rolls and rebin targets never touch them) before the shard_map and
    sliced back after — callers never pad by hand.
    """
    axis = mesh.axis_names[0]
    n = mesh.devices.size
    pad = (-spec.n0) % n
    from sphsim.sph.dense import _check_rebin_cadence

    _check_rebin_cadence(params, spec)

    # The local rebin operates on a padded slab: spec is geometry-only and
    # unchanged (it reads world_cells for coordinate clamps, which stay
    # global).
    def local(d):
        if substeps == 1:
            return _local_step(d, params, spec, axis)
        return jax.lax.scan(
            lambda s, _: (_local_step(s, params, spec, axis), None),
            d, None, length=substeps,
        )[0]

    arr = P(axis, None, None)
    spec_in = DenseFluidState(
        px=arr, py=arr, pz=arr, vx=arr, vy=arr, vz=arr, occ=arr,
        rho=arr, prs=arr, dropped=P(), clamped=P(), step_count=P(),
    )
    f_shard = jax.shard_map(
        local, mesh=mesh, in_specs=(spec_in,), out_specs=spec_in,
        check_vma=False,
    )
    if pad == 0:
        return jax.jit(f_shard, donate_argnums=(0,) if donate else ())

    fills = _pad_fill(params)

    def f(d):
        ext = (pad,) + d.px.shape[1:]
        padded = {
            k: jnp.concatenate(
                [getattr(d, k), jnp.full(ext, v, jnp.float32)], axis=0
            )
            for k, v in fills.items()
        }
        out = f_shard(d.replace_fields(**padded))
        return out.replace_fields(
            **{k: getattr(out, k)[: spec.n0] for k in fills}
        )

    return jax.jit(f, donate_argnums=(0,) if donate else ())


# ---------------------------------------------------------------------------
# 2D decomposition: plane slabs (layout dim 0 = world x) × row blocks
# (layout dim 1 = world y, contiguous X-lane groups of the fused axis).
#
# Row halos ride the fused axis: each shard ships its boundary ROW (X lanes)
# to its ±y neighbors and embeds the received rows inside a 7-sentinel-row
# pad — [7·sent | halo | local rows | halo | 7·sent] — so the padded fused
# axis stays a multiple of 128 (rows_local + 16 ≡ 0 mod 8, X ≡ 0 mod 16)
# and the Pallas sub-chunk machinery runs unchanged on a derived local spec.
# Only 1 row of real data crosses the wire per side; the sentinel filler is
# local. Pad ORDER is y first, then z: the z exchange then ships y-padded
# boundary planes, which is exactly how corner-neighbor cells (dz=±1,
# dy=±1) reach the diagonal shard transitively — no explicit corner sends.
# The wrapping rings stay inert for the same reason as 1D: global-edge
# halos resolve to the opposite edge's sentinel margin.
# ---------------------------------------------------------------------------


def exchange_row_halo(arr: jnp.ndarray, X: int, axis_name: str,
                      sent_fill: float) -> jnp.ndarray:
    """[P, K, C_local] → [P, K, C_local + 16·X]: ±1 real halo row from the
    y-neighbors, wrapped in 7 sentinel rows per side (alignment filler)."""
    n = jax.lax.axis_size(axis_name)
    fwd = [(i, (i + 1) % n) for i in range(n)]   # send toward +y
    bwd = [(i, (i - 1) % n) for i in range(n)]
    left = jax.lax.ppermute(arr[:, :, -X:], axis_name, fwd)
    right = jax.lax.ppermute(arr[:, :, :X], axis_name, bwd)
    sent = jnp.full(arr.shape[:2] + (7 * X,), sent_fill, arr.dtype)
    return jnp.concatenate([sent, left, arr, right, sent], axis=2)


def _local_step_2d(d: DenseFluidState, params: SPHParams, spec: DenseSpec,
                   local_spec: DenseSpec, za: str, ya: str
                   ) -> DenseFluidState:
    """One step on a (plane-slab × row-block) local state. Mirrors
    _local_step; every halo pad is y-rows first, then z-planes."""
    X = spec.X
    fills = _pad_fill(params)

    def ex2(arr, field):
        a = exchange_row_halo(arr, X, ya, fills[field])
        return exchange_halo(a, za)

    def pad_state(st, fields):
        return st.replace_fields(
            **{f: ex2(getattr(st, f), f) for f in fields}
        )

    dp = pad_state(d, ("px", "py", "pz", "occ"))
    rho_p = pair_density(dp, params, local_spec)
    prs_p = jnp.where(dp.occ > 0.5, eos_pressure(rho_p, params), 0.0)

    def interior(a):
        return a[1:-1, :, 8 * X:-8 * X]

    rho_own = interior(rho_p)
    prs_own = interior(prs_p)
    dp = dp.replace_fields(
        vx=ex2(d.vx, "vx"), vy=ex2(d.vy, "vy"), vz=ex2(d.vz, "vz"),
        rho=ex2(rho_own, "rho"), prs=ex2(prs_own, "prs"),
    )
    ax, ay, az = pair_accel(dp, params, local_spec)

    dpi = d.replace_fields(rho=rho_own, prs=prs_own)
    px, py, pz, vx, vy, vz, n_clamped = _integrate(
        dp, ax, ay, az, params, rebin_vmax(params, spec),
    )
    n_clamped = jax.lax.psum(jax.lax.psum(n_clamped, za), ya)
    px, py, pz = interior(px), interior(py), interior(pz)
    vx, vy, vz = interior(vx), interior(vy), interior(vz)

    rows_local = d.px.shape[2] // X

    def do_rebin(args):
        px, py, pz, vx, vy, vz = args
        dpad = pad_state(
            dpi.replace_fields(px=px, py=py, pz=pz, vx=vx, vy=vy, vz=vz),
            ("px", "py", "pz", "vx", "vy", "vz", "occ"),
        )
        p_local = px.shape[0]
        off0 = jax.lax.axis_index(za) * p_local - 1
        # Padded row r maps to global row (block start − 8 + r): the first
        # local row sits at padded row 8.
        off1 = jax.lax.axis_index(ya) * rows_local - 8
        out = rebin(
            dpad, dpad.px, dpad.py, dpad.pz, dpad.vx, dpad.vy, dpad.vz,
            params, spec, dim0_offset=off0, dim1_offset=off1,
        )
        local_drops = out.dropped - dpi.dropped
        total_drops = jax.lax.psum(jax.lax.psum(local_drops, za), ya)
        return dpi.replace_fields(
            px=interior(out.px), py=interior(out.py), pz=interior(out.pz),
            vx=interior(out.vx), vy=interior(out.vy), vz=interior(out.vz),
            occ=interior(out.occ),
            dropped=dpi.dropped + total_drops,
        )

    def no_rebin(args):
        px, py, pz, vx, vy, vz = args
        return dpi.replace_fields(px=px, py=py, pz=pz,
                                  vx=vx, vy=vy, vz=vz)

    if params.rebin_every == 1:
        d = do_rebin((px, py, pz, vx, vy, vz))
    else:
        d = jax.lax.cond(
            d.step_count % params.rebin_every == params.rebin_every - 1,
            do_rebin, no_rebin, (px, py, pz, vx, vy, vz),
        )
    return d.replace_fields(
        step_count=d.step_count + 1, clamped=d.clamped + n_clamped
    )


def make_sharded_dense_step_2d(params: SPHParams, spec: DenseSpec,
                               mesh: Mesh, substeps: int = 1,
                               donate: bool = True):
    """Jitted 2D-decomposed step over a (pz, py) mesh: layout dim 0 (world
    x planes) over mesh axis 0, layout dim 1 (world y rows, inside the
    fused axis) over mesh axis 1. Uneven n0/n1 are padded with inert
    sentinel planes/rows past the top margins, exactly like the 1D path."""
    import dataclasses

    from sphsim.sph.dense import _check_rebin_cadence

    assert spec.ndim == 3 and spec.stencil0 and spec.stencil1, (
        "2D decomposition needs a 3D spec with both stencils"
    )
    _check_rebin_cadence(params, spec)
    za, ya = mesh.axis_names
    pz, py = mesh.devices.shape
    X = spec.X

    pad0 = (-spec.n0) % pz
    # Row blocks must be whole multiples of 8 rows so every local fused
    # axis (rows_local + 16)·X stays a multiple of 128 (X ≡ 0 mod 16).
    n1_tgt = -(-spec.n1 // (8 * py)) * (8 * py)
    pad1_rows = n1_tgt - spec.n1
    rows_local = n1_tgt // py
    local_spec = dataclasses.replace(spec, n1=rows_local + 16)
    assert local_spec.C % 128 == 0, (rows_local, X)

    def local(d):
        if substeps == 1:
            return _local_step_2d(d, params, spec, local_spec, za, ya)
        return jax.lax.scan(
            lambda s, _: (
                _local_step_2d(s, params, spec, local_spec, za, ya), None
            ),
            d, None, length=substeps,
        )[0]

    arr = P(za, None, ya)
    spec_in = DenseFluidState(
        px=arr, py=arr, pz=arr, vx=arr, vy=arr, vz=arr, occ=arr,
        rho=arr, prs=arr, dropped=P(), clamped=P(), step_count=P(),
    )
    f_shard = jax.shard_map(
        local, mesh=mesh, in_specs=(spec_in,), out_specs=spec_in,
        check_vma=False,
    )

    fills = _pad_fill(params)

    def f(d):
        if pad0 or pad1_rows:
            def padf(x, v):
                if pad1_rows:
                    ext = x.shape[:2] + (pad1_rows * X,)
                    x = jnp.concatenate(
                        [x, jnp.full(ext, v, jnp.float32)], axis=2
                    )
                if pad0:
                    ext = (pad0,) + x.shape[1:]
                    x = jnp.concatenate(
                        [x, jnp.full(ext, v, jnp.float32)], axis=0
                    )
                return x

            d = d.replace_fields(
                **{k: padf(getattr(d, k), v) for k, v in fills.items()}
            )
        out = f_shard(d)
        if pad0 or pad1_rows:
            out = out.replace_fields(
                **{
                    k: getattr(out, k)[: spec.n0, :, : spec.C]
                    for k in fills
                }
            )
        return out

    return jax.jit(f, donate_argnums=(0,) if donate else ())


def make_mesh_2d(shape: tuple[int, int], devices=None,
                 axis_names=("x", "y")) -> Mesh:
    """(pz, py) mesh over the first pz·py devices, in id order."""
    import numpy as np

    devices = list(jax.devices() if devices is None else devices)
    n = shape[0] * shape[1]
    return Mesh(np.array(devices[:n]).reshape(shape), axis_names)


def make_sharded_contact_forces(params, mesh: Mesh, spec=None,
                                donate: bool = False):
    """Jitted SimState -> (force, torque, overflow) with the CONTACT sweep
    (the biology regime's O(slots·k·variants) hot loop) decomposed over a
    1D mesh: z-plane slabs of the [Z, Y, X·K] layout with one-plane
    ppermute halos — the same ring the fluid engine uses.

    The in-jit pack/unpack (O(N) sort + scatter) stays replicated: at
    colony scale the sweep dominates, and division/bond tables are
    replicated anyway. Results are BITWISE identical to the single-device
    sweep: slab-interior planes see identical 3-plane inputs, and both the
    single-device edge handling and the wrapping halo ring resolve
    global-edge planes to sentinel data whose pair terms are exact zeros
    (asserted in tests/test_dist.py). The sweep honors use_pallas like the
    single-device path; the XLA twin's rolls are safe on the padded slab
    (the wrap only corrupts the halo planes' OWN rows, which the [1:-1]
    trim discards)."""
    from sphsim.physics.contact_dense import (
        FIELD_FILLS,
        _pack_args,
        contact_sweep,
        gather_back,
        make_contact_spec,
    )

    if spec is None:
        spec = make_contact_spec(
            params, k=params.dense_k, cell_factor=params.dense_cell_factor
        )
    axis = mesh.axis_names[0]
    n = mesh.devices.size
    NZ = spec.nz
    pad = (-NZ) % n

    def sweep_local(*fields):
        padded = tuple(exchange_halo(f, axis) for f in fields)
        comps = contact_sweep(padded, params, spec)
        return tuple(c[1:-1] for c in comps)

    arr = P(axis, None, None)
    f_shard = jax.shard_map(
        sweep_local, mesh=mesh,
        in_specs=(arr,) * len(FIELD_FILLS), out_specs=(arr,) * 6,
        check_vma=False,
    )

    def f(state):
        fields, slot_of, overflow = _pack_args(state, spec)
        if pad:
            ext = (pad,) + fields[0].shape[1:]
            fields = tuple(
                jnp.concatenate(
                    [f, jnp.full(ext, fill, jnp.float32)], axis=0
                )
                for f, fill in zip(fields, FIELD_FILLS)
            )
        comps = f_shard(*fields)
        return gather_back(
            [c[:NZ].reshape(-1) for c in comps], slot_of, overflow
        )

    return jax.jit(f, donate_argnums=(0,) if donate else ())


def make_sharded_contact_forces_2d(params, mesh: Mesh, spec=None,
                                   donate: bool = False):
    """2D (z-slab × y-block) decomposition of the contact sweep over a
    (pz, py) mesh. The colony layout [Z, Y, X·K] has Y as a real array
    axis, so the y halo is a plain ±1-row ppermute. Pad order y then z, so
    corner cells arrive transitively. Interior results are BITWISE equal
    to the single-device sweep by the same argument as the 1D ring."""
    import dataclasses

    from sphsim.physics.contact_dense import (
        FIELD_FILLS,
        _pack_args,
        contact_sweep,
        gather_back,
        make_contact_spec,
    )

    if spec is None:
        spec = make_contact_spec(
            params, k=params.dense_k, cell_factor=params.dense_cell_factor
        )
    za, ya = mesh.axis_names
    pz, py = mesh.devices.shape
    NZ, NY = spec.nz, spec.ny
    pad0 = (-NZ) % pz
    pad1 = (-NY) % py
    rows_local = (NY + pad1) // py
    lspec = dataclasses.replace(spec, ny=rows_local + 2)

    def ex_y(arr):
        n = jax.lax.axis_size(ya)
        fwd = [(i, (i + 1) % n) for i in range(n)]
        bwd = [(i, (i - 1) % n) for i in range(n)]
        top = jax.lax.ppermute(arr[:, -1:], ya, fwd)
        bot = jax.lax.ppermute(arr[:, :1], ya, bwd)
        return jnp.concatenate([top, arr, bot], axis=1)

    def sweep_local(*fields):
        padded = tuple(exchange_halo(ex_y(f), za) for f in fields)
        comps = contact_sweep(padded, params, lspec)
        return tuple(c[1:-1, 1:1 + rows_local] for c in comps)

    arr = P(za, ya, None)
    f_shard = jax.shard_map(
        sweep_local, mesh=mesh,
        in_specs=(arr,) * len(FIELD_FILLS), out_specs=(arr,) * 6,
        check_vma=False,
    )

    def f(state):
        fields, slot_of, overflow = _pack_args(state, spec)

        def padf(x, fill):
            if pad1:
                ext = (x.shape[0], pad1) + x.shape[2:]
                x = jnp.concatenate(
                    [x, jnp.full(ext, fill, jnp.float32)], axis=1
                )
            if pad0:
                ext = (pad0,) + x.shape[1:]
                x = jnp.concatenate(
                    [x, jnp.full(ext, fill, jnp.float32)], axis=0
                )
            return x

        fields = tuple(padf(f_, fl) for f_, fl in zip(fields, FIELD_FILLS))
        comps = f_shard(*fields)
        # slot_of indexes the UNPADDED [NZ, NY, L] flat layout.
        return gather_back(
            [c[:NZ, :NY].reshape(-1) for c in comps], slot_of, overflow
        )

    return jax.jit(f, donate_argnums=(0,) if donate else ())


def shard_dense_state(d: DenseFluidState, mesh: Mesh) -> DenseFluidState:
    axis = mesh.axis_names[0]
    n = mesh.devices.size

    def put(x):
        if x.ndim >= 1 and x.shape[0] % n == 0:
            return jax.device_put(
                x, NamedSharding(mesh, P(axis, *[None] * (x.ndim - 1)))
            )
        # Uneven dim 0: leave replicated; the sharded step pads the state
        # to a multiple of the device count and reshards internally.
        return jax.device_put(x, NamedSharding(mesh, P()))

    return jax.tree_util.tree_map(put, d)


def unshard_dense_state(d: DenseFluidState) -> DenseFluidState:
    return jax.tree_util.tree_map(lambda x: jax.device_get(x), d)
