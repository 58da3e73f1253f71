"""The pure per-step function.

The reference's 13-dispatch frame + host bookkeeping
(ParticleSystemController.cs:244-351 + CellAdhesionManager.LateUpdate) becomes
one `step(state, params, genome) -> state` under jit. Order per DESIGN.md §3.
"""

from __future__ import annotations

import jax

from sphsim.biology.bonds import filter_bonds, update_bond_zones
from sphsim.biology.division import process_pending_splits, queue_splits
from sphsim.core.types import GenomeDevice, SimParams, SimState
from sphsim.physics.adhesion import apply_adhesion
from sphsim.physics.contact import apply_contact, contact_forces_bruteforce
from sphsim.physics.drag import apply_drag_force
from sphsim.physics.integrate import update_motion, update_rotation


def contact_forces(state: SimState, params: SimParams):
    """Neighbor-sum dispatch: brute force (executable spec / BASELINE
    config[0]), spatial-hash grid, or the dense slot-grid sweep ('dense' —
    the fast path, physics/contact_dense.py). Returns (force, torque,
    overflow)."""
    import jax.numpy as jnp

    if params.neighbor_mode == "bruteforce":
        f, t = contact_forces_bruteforce(state, params)
        return f, t, jnp.int32(0)
    elif params.neighbor_mode == "grid":
        from sphsim.ops.grid import contact_forces_grid
        return contact_forces_grid(state, params)
    elif params.neighbor_mode == "dense":
        from sphsim.physics.contact_dense import contact_forces_dense
        return contact_forces_dense(state, params)
    raise ValueError(f"unknown neighbor_mode {params.neighbor_mode!r}")


def step(state: SimState, params: SimParams, genome: GenomeDevice,
         dt=None, contact_fn=None, bond_plan=None) -> SimState:
    """One full frame (DESIGN.md §3). `params` is static; jit with
    static_argnums/closure.

    `dt` (optional, traced scalar) overrides params.dt for every dt-dependent
    pass — the variable-dt compat mode mirroring the reference's
    `Time.deltaTime` stepping (ParticleSystemController.cs:246). Default
    None = fixed params.dt (the recommended fidelity mode, SURVEY §7).

    `contact_fn` (optional, `state -> (force, torque, overflow)`) overrides
    the neighbor-sum dispatch — the hook the sharded biology step uses to
    run the contact sweep decomposed over a device mesh
    (parallel/dist.make_sharded_contact_forces[_2d]) while division, bonds
    and integration stay replicated; results are bitwise equal either way
    (tests/test_dist.py).

    `bond_plan` (optional): a physics.adhesion.BondPlan — the adhesion
    accumulate then runs scatter-free through the plan's frozen order.
    The plan may be STALE: bonds that drifted from its snapshot (division
    endpoint rewrites, new bonds) are detected per step and accumulated
    through the compact hybrid side path
    (adhesion.accumulate_bond_deltas_hybrid), so this is valid on every
    step including ones that apply splits."""
    # 1-2. Division: apply last step's queued splits, then advance timers and
    #      queue new ones (cs:253 runs before all dispatches).
    state = process_pending_splits(state, params, genome)
    state = queue_splits(state, params, genome, dt=dt)

    # 3-4. Neighbor structure + contact force pass (K2/K3/K4).
    if contact_fn is None:
        force, torque, cell_overflow = contact_forces(state, params)
    else:
        force, torque, cell_overflow = contact_fn(state)
    state = apply_contact(state, params, force, torque, dt=dt)
    state = state.replace_fields(
        overflow=state.overflow + cell_overflow.astype(state.overflow.dtype)
    )

    # 5. Adhesion constraints (K10/K11) — reads post-contact velocities.
    state = apply_adhesion(state, params, genome, dt=dt, plan=bond_plan)

    # 6. Interactive drag impulse (K5).
    state = apply_drag_force(state, params, dt=dt)

    # 7-8. Motion + rotation integration (K6/K7).
    state = update_motion(state, params, dt=dt)
    state = update_rotation(state, params, dt=dt)

    # 9-10. Bond zone/anchor refresh for young bonds + pruning (LateUpdate).
    state = state.replace_fields(bonds=update_bond_zones(state, params, genome))
    state = state.replace_fields(bonds=filter_bonds(state))

    return state.replace_fields(step_count=state.step_count + 1)


_STEP_CACHE: dict = {}


def make_step_fn(params: SimParams, donate: bool = True, contact_fn=None):
    """Build a jitted step closure over static params.

    Memoized on (params, donate) so every Simulation with equal params
    shares one compiled executable (per state shape, via jit's own cache).
    A `contact_fn` closure is per-Simulation (one fresh function per mesh),
    so those steps are NOT put in the module-level cache — keying on the
    closure would leak one compiled executable + captured Mesh per
    Simulation instance; the caller's per-instance cache
    (Simulation._step_cache) scopes them correctly."""
    if contact_fn is not None:
        f = lambda st, gd: step(st, params, gd, contact_fn=contact_fn)  # noqa: E731
        return jax.jit(f, donate_argnums=(0,) if donate else ())
    key = (params, donate)
    if key not in _STEP_CACHE:
        f = lambda st, gd: step(st, params, gd)  # noqa: E731
        _STEP_CACHE[key] = jax.jit(f, donate_argnums=(0,) if donate else ())
    return _STEP_CACHE[key]


def use_bond_plan(params: SimParams, state: SimState) -> bool:
    """Static decision (bond capacity is a shape): the planned (sort +
    segmented scan) adhesion accumulate instead of segment_sum for bond
    tables of 163,840 rows and more. The threshold was tuned on earlier
    hardware and is not yet measured on the card. Below it the plain path
    also keeps small scenes (and the golden reference trace)
    bitwise-identical to previous releases."""
    mode = getattr(params, "adhesion_plan", "auto")
    if mode == "off":
        return False
    if mode == "on":
        return True
    return state.bonds.capacity >= 163840


def run_steps(state: SimState, params: SimParams, genome: GenomeDevice,
              n_steps: int, dts=None, contact_fn=None, bond_plan=None,
              return_plan: bool = False):
    """Roll n physics steps with lax.scan (for benchmarking / headless runs).

    dts: optional [n_steps] array of per-step dt values (variable-dt compat,
    cs:246); None = fixed params.dt.

    Large bond tables run the planned adhesion accumulate (use_bond_plan):
    the scan carries a BondPlan and applies it on EVERY step — a stale
    plan is valid because bonds that drifted from its snapshot accumulate
    through the hybrid side path (adhesion.accumulate_bond_deltas_hybrid),
    so division steps no longer pay the full segment_sum. The plan is
    rebuilt inside the scan only when the drift count nears the side
    capacity.

    bond_plan / return_plan: callers that step in chunks (Simulation)
    can carry the plan across calls instead of re-sorting per chunk
    (the build is a 2B-row argsort)."""
    if not use_bond_plan(params, state):
        def body(st, dt):
            return step(st, params, genome, dt=dt,
                        contact_fn=contact_fn), None

        state, _ = jax.lax.scan(body, state, dts, length=n_steps)
        return (state, None) if return_plan else state

    from sphsim.physics.adhesion import (
        _SIDE_CAP,
        build_bond_plan,
        plan_changed_count,
    )

    def body(carry, dt):
        st, plan = carry
        st2 = step(st, params, genome, dt=dt, contact_fn=contact_fn,
                   bond_plan=plan)
        plan2 = jax.lax.cond(
            plan_changed_count(st2.bonds, plan) > _SIDE_CAP // 2,
            lambda s: build_bond_plan(s.bonds, s.capacity),
            lambda s: plan,
            st2,
        )
        return (st2, plan2), None

    plan0 = (bond_plan if bond_plan is not None
             else build_bond_plan(state.bonds, state.capacity))
    (state, plan), _ = jax.lax.scan(body, (state, plan0), dts,
                                    length=n_steps)
    return (state, plan) if return_plan else state
