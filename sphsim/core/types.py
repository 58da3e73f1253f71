"""Core datatypes: static config (SimParams, Genome) and device state pytrees.

Config mirrors the reference's three config tiers (SURVEY §5.6): inspector
fields → `SimParams`, genome ScriptableObject → `Genome`/`GenomeMode`
(CellGenome.cs:124-170), with range validation and JSON (de)serialization in
`sphsim.engine.config`.

State is a fixed-capacity SoA pytree with an `active_count` mask — the
reference's `activeParticleCount` guard idiom (SimulateParticles.compute:121).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, fields
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np


def pytree_dataclass(cls):
    """Register a dataclass whose every field is pytree data."""
    cls = dataclass(cls)
    jax.tree_util.register_dataclass(
        cls, [f.name for f in fields(cls)], []
    )
    cls.replace_fields = dataclasses.replace
    return cls


# ---------------------------------------------------------------------------
# Genome (static config; CellGenome.cs:124-170 field-for-field)
# ---------------------------------------------------------------------------

_RANGES = {
    "split_interval": (1.0, 15.0),
    "parent_split_yaw": (-180.0, 180.0),
    "parent_split_pitch": (-90.0, 90.0),
    "child_a_orientation_yaw": (-180.0, 180.0),
    "child_a_orientation_pitch": (-90.0, 90.0),
    "child_b_orientation_yaw": (-180.0, 180.0),
    "child_b_orientation_pitch": (-90.0, 90.0),
    "adhesion_rest_length": (1.0, 10.0),
    "adhesion_spring_stiffness": (10.0, 500.0),
    "adhesion_spring_damping": (0.0, 100.0),
    "orientation_constraint_strength": (0.0, 1.0),
    "max_allowed_angle_deviation": (0.0, 180.0),
    "adhesion_break_force": (100.0, 5000.0),
}


@dataclass(frozen=True)
class GenomeMode:
    """One genome mode (CellGenome.cs:124-170)."""

    mode_name: str = ""
    split_interval: float = 5.0
    is_initial: bool = False
    parent_make_adhesion: bool = False
    mode_color: tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
    parent_split_yaw: float = 0.0
    parent_split_pitch: float = 0.0
    child_a_mode_index: int = -1  # -1 ⇒ inherit parent mode
    child_a_orientation_yaw: float = 0.0
    child_a_orientation_pitch: float = 0.0
    child_a_keep_adhesion: bool = False
    child_b_mode_index: int = -1
    child_b_orientation_yaw: float = 0.0
    child_b_orientation_pitch: float = 0.0
    child_b_keep_adhesion: bool = False
    adhesion_rest_length: float = 3.0
    adhesion_spring_stiffness: float = 100.0
    adhesion_spring_damping: float = 5.0
    orientation_constraint_strength: float = 0.5
    # Declared-but-unread by any reference kernel (CellGenome.cs:164-169);
    # carried for config parity, not acted upon.
    max_allowed_angle_deviation: float = 45.0
    adhesion_can_break: bool = False
    adhesion_break_force: float = 1000.0

    def validate(self) -> None:
        for name, (lo, hi) in _RANGES.items():
            v = getattr(self, name)
            if not (lo <= v <= hi):
                raise ValueError(f"GenomeMode.{name}={v} outside [{lo}, {hi}]")


@dataclass(frozen=True)
class Genome:
    """A validated list of modes; exactly one may be initial
    (CellGenome.cs:73-89)."""

    modes: tuple[GenomeMode, ...] = ()

    def validate_for_simulation(self) -> "Genome":
        """Enforce a single initial mode, mirroring ValidateForSimulation."""
        initial = [i for i, m in enumerate(self.modes) if m.is_initial]
        if len(initial) > 1:
            names = ", ".join(self.modes[i].mode_name or f"Mode {i}" for i in initial)
            raise ValueError(f"Multiple initial modes detected: {names}")
        for m in self.modes:
            m.validate()
        if not initial and self.modes:
            modes = list(self.modes)
            modes[0] = dataclasses.replace(modes[0], is_initial=True)
            return Genome(tuple(modes))
        return self

    @property
    def initial_mode_index(self) -> int:
        for i, m in enumerate(self.modes):
            if m.is_initial:
                return i
        return 0

    def to_device(self) -> "GenomeDevice":
        """Stack per-mode scalars into device arrays for in-jit lookup.

        A zero-mode genome (the reference early-returns on it, cs:649) gets
        one dummy row so in-jit lookups never index an empty array;
        n_modes=0 already marks every particle mode invalid.
        """
        modes = self.modes if self.modes else (GenomeMode(),)

        def col(name, dtype=jnp.float32):
            return jnp.array([getattr(m, name) for m in modes], dtype=dtype)

        return GenomeDevice(
            n_modes=jnp.int32(len(self.modes)),
            split_interval=col("split_interval"),
            parent_make_adhesion=col("parent_make_adhesion", jnp.bool_),
            mode_color=jnp.array([m.mode_color for m in modes], jnp.float32),
            parent_split_yaw=col("parent_split_yaw"),
            parent_split_pitch=col("parent_split_pitch"),
            child_a_mode_index=col("child_a_mode_index", jnp.int32),
            child_a_orientation_yaw=col("child_a_orientation_yaw"),
            child_a_orientation_pitch=col("child_a_orientation_pitch"),
            child_a_keep_adhesion=col("child_a_keep_adhesion", jnp.bool_),
            child_b_mode_index=col("child_b_mode_index", jnp.int32),
            child_b_orientation_yaw=col("child_b_orientation_yaw"),
            child_b_orientation_pitch=col("child_b_orientation_pitch"),
            child_b_keep_adhesion=col("child_b_keep_adhesion", jnp.bool_),
            adhesion_rest_length=col("adhesion_rest_length"),
            adhesion_spring_stiffness=col("adhesion_spring_stiffness"),
            adhesion_spring_damping=col("adhesion_spring_damping"),
            orientation_constraint_strength=col("orientation_constraint_strength"),
        )


@pytree_dataclass
class GenomeDevice:
    """Genome modes as stacked device arrays (one row per mode)."""

    n_modes: jnp.ndarray
    split_interval: jnp.ndarray
    parent_make_adhesion: jnp.ndarray
    mode_color: jnp.ndarray
    parent_split_yaw: jnp.ndarray
    parent_split_pitch: jnp.ndarray
    child_a_mode_index: jnp.ndarray
    child_a_orientation_yaw: jnp.ndarray
    child_a_orientation_pitch: jnp.ndarray
    child_a_keep_adhesion: jnp.ndarray
    child_b_mode_index: jnp.ndarray
    child_b_orientation_yaw: jnp.ndarray
    child_b_orientation_pitch: jnp.ndarray
    child_b_keep_adhesion: jnp.ndarray
    adhesion_rest_length: jnp.ndarray
    adhesion_spring_stiffness: jnp.ndarray
    adhesion_spring_damping: jnp.ndarray
    orientation_constraint_strength: jnp.ndarray


# ---------------------------------------------------------------------------
# SimParams (static; scene/inspector fields, Particle Simulation.unity:150-178)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SimParams:
    """Static simulation parameters. Defaults mirror the shipped scene
    (SURVEY §2.12) except capacity, which mirrors the code default."""

    dt: float = 1.0 / 60.0
    capacity: int = 4               # particleCount (scene value 4, grows 2×)
    min_radius: float = 2.0
    max_radius: float = 2.0
    spawn_radius: float = 15.0
    global_drag_multiplier: float = 10.0
    torque_factor: float = 1.0
    torque_damping: float = 0.5
    boundary_friction: float = 0.8
    rolling_contact_radius_multiplier: float = 5.0
    density: float = 0.1
    repulsion_strength: float = 200.0
    spawn_overlap_offset: float = 0.5
    split_velocity_magnitude: float = 0.5
    enable_anchor_constraints: bool = True   # CellAdhesionManager toggle
    inheritance_angle_deg: float = 10.0      # ZoneC half-width (CAM:320)
    # Capacities (device tables are fixed-size; host grows them on demand).
    max_bonds: int = 4096                    # cs:129
    max_splits_per_step: int = 64
    # Neighbor grid (compute:16-17; parameterized here).
    grid_dim: int = 32
    grid_cell_size: float = 4.0
    # Neighbor algorithm: "bruteforce" | "grid" | "dense"
    # ("dense" = the colony-specced [Z, Y, X·K] slot grid — the fast
    # contact path, physics/contact_dense.py)
    neighbor_mode: str = "bruteforce"
    # Max particles binned per grid cell (grid mode; overflow is counted).
    cell_capacity: int = 32
    # Dense mode: slots per cell and cell-size factor (× max_radius).
    # k=2 suits settled colonies (~0.1 centers per contact-range cell;
    # sweep cost scales with k² — overflow is counted if a cell exceeds k).
    dense_k: int = 2
    dense_cell_factor: float = 1.05
    # Dense mode contact sweep: True = the Triton kernel (raises without a
    # GPU; the default, as the kernel won on every cell measured, PERF.md);
    # False = the XLA twin; "interpret" = the kernel in the Pallas
    # interpreter (ops/pallas/sweep.kernel_mode).
    use_pallas: bool | str = True
    contact_epsilon: float = 0.001
    slip_epsilon: float = 1e-4
    # Adhesion accumulation: "auto" = planned scatter-free accumulate for
    # bond tables >= 163,840 rows (engine/step.use_bond_plan; not yet
    # measured on the card), "on" / "off" force it. Planned differs from segment_sum only by scan-tree
    # reassociation (last-ulp).
    adhesion_plan: str = "auto"

    def replace(self, **kw) -> "SimParams":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Device state pytrees
# ---------------------------------------------------------------------------


@pytree_dataclass
class BondTable:
    """Fixed-capacity adhesion bond graph (CellAdhesionManager.cs:35-54).

    Bonds carry both uids (identity, stable across slot reuse) and slots
    (compute index); slots are rewritten during division.
    Zones: 0 = ZoneA, 1 = ZoneB, 2 = ZoneC.
    """

    active: jnp.ndarray          # [B] bool
    uid_a: jnp.ndarray           # [B] i32
    uid_b: jnp.ndarray           # [B] i32
    slot_a: jnp.ndarray          # [B] i32
    slot_b: jnp.ndarray          # [B] i32
    zone_a: jnp.ndarray          # [B] i32
    zone_b: jnp.ndarray         # [B] i32
    child_to_child: jnp.ndarray  # [B] bool
    created_step: jnp.ndarray    # [B] i32
    rel_orientation: jnp.ndarray  # [B,4] quat conj(qA)⊗qB at creation
    anchor_a: jnp.ndarray        # [B,3] body-frame anchor on A
    anchor_b: jnp.ndarray        # [B,3]
    anchors_set: jnp.ndarray     # [B] bool

    @staticmethod
    def empty(capacity: int) -> "BondTable":
        B = capacity
        return BondTable(
            active=jnp.zeros(B, jnp.bool_),
            uid_a=jnp.full(B, -1, jnp.int32),
            uid_b=jnp.full(B, -1, jnp.int32),
            slot_a=jnp.full(B, -1, jnp.int32),
            slot_b=jnp.full(B, -1, jnp.int32),
            zone_a=jnp.zeros(B, jnp.int32),
            zone_b=jnp.zeros(B, jnp.int32),
            child_to_child=jnp.zeros(B, jnp.bool_),
            created_step=jnp.full(B, -2, jnp.int32),
            rel_orientation=jnp.tile(
                jnp.array([0.0, 0.0, 0.0, 1.0], jnp.float32), (B, 1)
            ),
            anchor_a=jnp.zeros((B, 3), jnp.float32),
            anchor_b=jnp.zeros((B, 3), jnp.float32),
            anchors_set=jnp.zeros(B, jnp.bool_),
        )

    @property
    def capacity(self) -> int:
        return self.active.shape[0]


@pytree_dataclass
class PendingSplits:
    """Split queue: splits detected in step t are applied at the start of
    step t+1 (ParticleSystemController.cs:643-646 one-frame deferral)."""

    count: jnp.ndarray       # i32 scalar
    parent_slot: jnp.ndarray  # [S] i32
    pos_a: jnp.ndarray       # [S,3]
    pos_b: jnp.ndarray       # [S,3]
    vel_a: jnp.ndarray       # [S,3]
    vel_b: jnp.ndarray       # [S,3]
    rot_a: jnp.ndarray       # [S,4]
    rot_b: jnp.ndarray       # [S,4]
    mode_a: jnp.ndarray      # [S] i32
    mode_b: jnp.ndarray      # [S] i32
    parent_mode: jnp.ndarray  # [S] i32 (for adhesion keep-flags, cs:936)

    @staticmethod
    def empty(capacity: int) -> "PendingSplits":
        S = capacity
        return PendingSplits(
            count=jnp.int32(0),
            parent_slot=jnp.full(S, -1, jnp.int32),
            pos_a=jnp.zeros((S, 3), jnp.float32),
            pos_b=jnp.zeros((S, 3), jnp.float32),
            vel_a=jnp.zeros((S, 3), jnp.float32),
            vel_b=jnp.zeros((S, 3), jnp.float32),
            rot_a=jnp.tile(jnp.array([0, 0, 0, 1], jnp.float32), (S, 1)),
            rot_b=jnp.tile(jnp.array([0, 0, 0, 1], jnp.float32), (S, 1)),
            mode_a=jnp.zeros(S, jnp.int32),
            mode_b=jnp.zeros(S, jnp.int32),
            parent_mode=jnp.zeros(S, jnp.int32),
        )


@pytree_dataclass
class DragInput:
    """Interactive drag state (DragInput struct, compute:70-74)."""

    selected_slot: jnp.ndarray  # i32, -1 = none
    target: jnp.ndarray         # [3]
    strength: jnp.ndarray       # f32

    @staticmethod
    def none() -> "DragInput":
        return DragInput(
            selected_slot=jnp.int32(-1),
            target=jnp.zeros(3, jnp.float32),
            strength=jnp.float32(0.0),
        )


@pytree_dataclass
class SimState:
    """Full simulation state: one pytree, fixed capacity N.

    Field-for-field superset of the reference's 84-byte Particle struct
    (SimulateParticles.compute:23-40) in SoA layout, plus the host-side state
    the reference keeps in the controller (timers cs:631, ids cs:178-191,
    uid counter cs:98, bonds CAM:23, pending splits cs:765).
    """

    pos: jnp.ndarray          # [N,3]
    vel: jnp.ndarray          # [N,3]
    ang_vel: jnp.ndarray      # [N,3]
    rot: jnp.ndarray          # [N,4] quat
    radius: jnp.ndarray       # [N]
    mass: jnp.ndarray         # [N]
    inertia: jnp.ndarray      # [N] momentOfInertia
    drag: jnp.ndarray         # [N]
    repulsion: jnp.ndarray    # [N] (uploaded-but-unused in ref kernel; kept)
    mode: jnp.ndarray         # [N] i32
    torque_accum: jnp.ndarray  # [N,3] f32 (ref: int3 fixed-point, compute:79)
    split_timer: jnp.ndarray  # [N]
    uid: jnp.ndarray          # [N] i32
    parent_uid: jnp.ndarray   # [N] i32
    child_type: jnp.ndarray   # [N] i32 0='A', 1='B'
    active_count: jnp.ndarray  # i32 scalar
    next_uid: jnp.ndarray     # i32 scalar
    step_count: jnp.ndarray   # i32 scalar
    overflow: jnp.ndarray     # i32 scalar: dropped splits/bonds/bin overflows
    bonds: BondTable
    pending: PendingSplits
    drag_input: DragInput
    rng: jnp.ndarray          # PRNG key

    @property
    def capacity(self) -> int:
        return self.pos.shape[0]

    @staticmethod
    def zeros(capacity: int, params: SimParams, seed: int = 0) -> "SimState":
        N = capacity
        return SimState(
            pos=jnp.zeros((N, 3), jnp.float32),
            vel=jnp.zeros((N, 3), jnp.float32),
            ang_vel=jnp.zeros((N, 3), jnp.float32),
            rot=jnp.tile(jnp.array([0, 0, 0, 1], jnp.float32), (N, 1)),
            radius=jnp.ones(N, jnp.float32),
            mass=jnp.ones(N, jnp.float32),
            inertia=jnp.ones(N, jnp.float32),
            drag=jnp.ones(N, jnp.float32),
            repulsion=jnp.ones(N, jnp.float32),
            mode=jnp.zeros(N, jnp.int32),
            torque_accum=jnp.zeros((N, 3), jnp.float32),
            split_timer=jnp.zeros(N, jnp.float32),
            uid=jnp.full(N, -1, jnp.int32),
            parent_uid=jnp.zeros(N, jnp.int32),
            child_type=jnp.zeros(N, jnp.int32),
            active_count=jnp.int32(0),
            next_uid=jnp.int32(1),
            step_count=jnp.int32(0),
            overflow=jnp.int32(0),
            bonds=BondTable.empty(params.max_bonds),
            pending=PendingSplits.empty(params.max_splits_per_step),
            drag_input=DragInput.none(),
            rng=jax.random.PRNGKey(seed),
        )


def formatted_id(parent_uid: int, uid: int, child_type: int) -> str:
    """'PP.UU.C' formatting (ParticleIDData.GetFormattedID, cs:178-191)."""
    c = "A" if child_type == 0 else "B"
    return f"{int(parent_uid):02d}.{int(uid):02d}.{c}"


def state_to_numpy(state: SimState) -> dict[str, Any]:
    """Pull the whole state to host as a flat dict of numpy arrays."""
    flat = {}

    def add(prefix: str, obj):
        for f in fields(obj):
            v = getattr(obj, f.name)
            if isinstance(v, (BondTable, PendingSplits, DragInput)):
                add(prefix + f.name + ".", v)
            else:
                flat[prefix + f.name] = np.asarray(v)

    add("", state)
    return flat
