"""Genome-driven cell division as masked in-jit passes.

Re-implements UpdateCellDivisionTimers / SplitCell / ProcessPendingSplits
(ParticleSystemController.cs:631-969) — see DESIGN.md §5:

- splits detected in step t are queued and applied at the start of step t+1
  (the reference's one-frame deferral, cs:643-646);
- timers reset for ALL ready cells even when queueing is capacity-capped
  (cs:682);
- child A overwrites the parent slot, child B appends; uids are allocated
  A-then-B in queue order (cs:846-851).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from sphsim.core import quat
from sphsim.core.types import GenomeDevice, PendingSplits, SimParams, SimState
from sphsim.biology.bonds import handle_cell_split


def division_ready(state: SimState, params: SimParams, genome: GenomeDevice,
                   dt=None):
    """The timer-advance + readiness test of queue_splits: returns
    (timer_advanced, ready_mask, mode_clipped) (cs:648-659 semantics incl.
    the 0.001 epsilon)."""
    N = state.capacity
    alive = jnp.arange(N) < state.active_count
    dt = params.dt if dt is None else dt

    n_modes = genome.n_modes
    # The reference RETURNS before the timer-advance loop when there is no
    # capacity headroom or no genome modes (cs:648-649): at-capacity
    # colonies FREEZE their timers (phases resume where they stopped after
    # a resize), they do not keep cycling.
    gate = (state.active_count < N) & (n_modes > 0)
    timer = jnp.where(gate & alive, state.split_timer + dt,
                      state.split_timer)

    mode_valid = alive & (state.mode >= 0) & (state.mode < n_modes)
    mode_c = jnp.clip(state.mode, 0, jnp.maximum(n_modes - 1, 0))
    interval = genome.split_interval[mode_c]
    ready = gate & mode_valid & (timer >= interval - 0.001)  # cs:659 epsilon
    return timer, ready, mode_c


def queue_splits(
    state: SimState, params: SimParams, genome: GenomeDevice, dt=None
) -> SimState:
    """Advance timers, detect ready cells (slot order, capacity-capped), and
    queue their split data computed from CURRENT pose (cs:652-778).

    The pending-buffer bound S (params.max_splits_per_step) composes with
    the reference's own allowance mechanism: ready cells beyond the
    allowance reset their timer and wait a full interval (cs:682), exactly
    what the reference does to ready cells beyond its capacity headroom —
    S is just a tighter allowance. It exists because the pending pytree is
    fixed-shape under jit."""
    N = state.capacity
    S = state.pending.parent_slot.shape[0]
    timer, ready, mode_c = division_ready(state, params, genome, dt=dt)

    allowed = jnp.maximum(N - state.active_count, 0)  # cs:648
    allowed = jnp.minimum(allowed, S)
    rank = jnp.cumsum(ready.astype(jnp.int32)) - 1
    queued = ready & (rank < allowed)

    # Timers reset for every ready cell, queued or not (cs:682).
    timer = jnp.where(ready, 0.0, timer)

    # Quiet-step fast path: split geometry (quaternion frames, look
    # rotations) and the 11 pack-scatters only run when some cell is ready —
    # between divisions (split_interval spans many dt steps) the pass is
    # just the timer advance above.
    def no_splits(_):
        return PendingSplits.empty(S)

    def build(_):
        return _build_pending(state, params, genome, queued, rank, mode_c, S)

    pending = jax.lax.cond(jnp.any(ready), build, no_splits, None)
    return state.replace_fields(split_timer=timer, pending=pending)


def _build_pending(state, params, genome, queued, rank, mode_c, S):
    """Split geometry + dense packing for the queued cells (SplitCell,
    cs:729-778)."""
    N = state.capacity
    slots = jnp.arange(N)
    n_modes = genome.n_modes

    mode_row = mode_c
    # Child modes: -1 or out-of-range ⇒ inherit parent (cs:742-747).
    def child_mode(child_idx):
        ci = child_idx[mode_row]
        return jnp.where((ci >= 0) & (ci < n_modes), ci, mode_row)

    mode_a = child_mode(genome.child_a_mode_index)
    mode_b = child_mode(genome.child_b_mode_index)

    right, up, fwd = quat.axis3(state.rot)

    def local_to_world(d_local):
        return (
            right * d_local[..., 0:1]
            + up * d_local[..., 1:2]
            + fwd * d_local[..., 2:3]
        )

    split_dir = local_to_world(
        quat.euler_direction(
            genome.parent_split_yaw[mode_row], genome.parent_split_pitch[mode_row]
        )
    )
    pos_a = state.pos + split_dir * params.spawn_overlap_offset
    pos_b = state.pos - split_dir * params.spawn_overlap_offset
    # Parent velocity is ignored (cs:761).
    vel_a = split_dir * params.split_velocity_magnitude
    vel_b = -split_dir * params.split_velocity_magnitude
    dir_a = local_to_world(
        quat.euler_direction(
            genome.child_a_orientation_yaw[mode_row],
            genome.child_a_orientation_pitch[mode_row],
        )
    )
    dir_b = local_to_world(
        quat.euler_direction(
            genome.child_b_orientation_yaw[mode_row],
            genome.child_b_orientation_pitch[mode_row],
        )
    )
    rot_a = quat.look_rotation(dir_a, up)
    rot_b = quat.look_rotation(dir_b, up)

    # Pack queued splits densely by rank; index S is the trash row.
    target = jnp.where(queued, jnp.clip(rank, 0, S - 1), S)

    def pack(per_particle, init):
        padded = jnp.concatenate([init, init[:1]], axis=0)
        return padded.at[target].set(per_particle)[:S]

    p0 = PendingSplits.empty(S)
    return PendingSplits(
        count=jnp.sum(queued).astype(jnp.int32),
        parent_slot=pack(slots.astype(jnp.int32), p0.parent_slot),
        pos_a=pack(pos_a, p0.pos_a),
        pos_b=pack(pos_b, p0.pos_b),
        vel_a=pack(vel_a, p0.vel_a),
        vel_b=pack(vel_b, p0.vel_b),
        rot_a=pack(rot_a, p0.rot_a),
        rot_b=pack(rot_b, p0.rot_b),
        mode_a=pack(mode_a.astype(jnp.int32), p0.mode_a),
        mode_b=pack(mode_b.astype(jnp.int32), p0.mode_b),
        parent_mode=pack(mode_row.astype(jnp.int32), p0.parent_mode),
    )


def process_pending_splits(
    state: SimState, params: SimParams, genome: GenomeDevice
) -> SimState:
    """Apply last step's queued splits sequentially (ProcessPendingSplits,
    cs:780-964), including bond inheritance per split (CAM:425-509).

    Sequential (lax.scan) because splits within one step can chain through the
    bond table — the reference loops over pendingSplits in order.
    """
    S = state.pending.parent_slot.shape[0]
    N = state.capacity

    def body(carry, k):
        st = carry
        pend = st.pending
        do = (k < pend.count) & (st.active_count < N)
        parent_slot = jnp.clip(pend.parent_slot[k], 0, N - 1)
        slot_b = jnp.clip(st.active_count, 0, N - 1)

        parent_uid = st.uid[parent_slot]
        uid_a = st.next_uid
        uid_b = st.next_uid + 1

        def w1(arr, idx, val):
            return arr.at[idx].set(jnp.where(do, val, arr[idx]))

        # Child A overwrites the parent slot; child B copies A's struct
        # (radius/mass/inertia/drag/repulsion inherited, cs:854-869).
        pos = w1(w1(st.pos, parent_slot, pend.pos_a[k]), slot_b, pend.pos_b[k])
        vel = w1(w1(st.vel, parent_slot, pend.vel_a[k]), slot_b, pend.vel_b[k])
        rot = w1(w1(st.rot, parent_slot, pend.rot_a[k]), slot_b, pend.rot_b[k])
        mode = w1(w1(st.mode, parent_slot, pend.mode_a[k]), slot_b, pend.mode_b[k])
        ang_vel = w1(st.ang_vel, slot_b, st.ang_vel[parent_slot])
        radius = w1(st.radius, slot_b, st.radius[parent_slot])
        mass = w1(st.mass, slot_b, st.mass[parent_slot])
        inertia = w1(st.inertia, slot_b, st.inertia[parent_slot])
        dragf = w1(st.drag, slot_b, st.drag[parent_slot])
        repul = w1(st.repulsion, slot_b, st.repulsion[parent_slot])
        timer = w1(w1(st.split_timer, parent_slot, 0.0), slot_b, 0.0)
        uid = w1(w1(st.uid, parent_slot, uid_a), slot_b, uid_b)
        p_uid = w1(w1(st.parent_uid, parent_slot, parent_uid), slot_b, parent_uid)
        ctype = w1(w1(st.child_type, parent_slot, 0), slot_b, 1)

        # Adhesion flags come from CHILD A's (resolved) mode, not the
        # parent's: the reference reads particleData[parentIndex].modeIndex
        # AFTER the parent slot was overwritten with childAModeIndex
        # (cs:857 write, cs:933 read) — the split.childAModeIndex is
        # already resolved in SplitCell (cs:743-745), so it is always in
        # range and the cs:935 fallback-to-0 never fires for split data.
        fm = jnp.clip(pend.mode_a[k], 0, jnp.maximum(genome.n_modes - 1, 0))
        keep_a = genome.child_a_keep_adhesion[fm]
        keep_b = genome.child_b_keep_adhesion[fm]
        make_adh = genome.parent_make_adhesion[fm]

        bonds_new, dropped = handle_cell_split(
            st.bonds, rot,
            parent_uid, uid_a, uid_b,
            parent_slot.astype(jnp.int32), slot_b.astype(jnp.int32),
            keep_a, keep_b, make_adh,
            st.step_count,
        )
        bonds = jax.tree_util.tree_map(
            lambda new, old: jnp.where(do, new, old), bonds_new, st.bonds
        )

        st = st.replace_fields(
            pos=pos, vel=vel, rot=rot, mode=mode, ang_vel=ang_vel,
            radius=radius, mass=mass, inertia=inertia, drag=dragf,
            repulsion=repul, split_timer=timer, uid=uid, parent_uid=p_uid,
            child_type=ctype,
            active_count=st.active_count + jnp.where(do, 1, 0),
            next_uid=st.next_uid + jnp.where(do, 2, 0),
            overflow=st.overflow + jnp.where(do, dropped, 0),
            bonds=bonds,
        )
        return st, None

    def run(st):
        out, _ = jax.lax.scan(body, st, jnp.arange(S, dtype=jnp.int32))
        return out

    # Most steps apply zero splits (the genome's split_interval spans many
    # dt steps); the scan body is then a pure identity, so skip the whole
    # S-iteration scan — its per-iteration scatters over every [N] array
    # and the bond-table argsort dominate quiet-frame cost at colony scale.
    state = jax.lax.cond(state.pending.count > 0, run, lambda st: st, state)
    return state.replace_fields(pending=PendingSplits.empty(S))
