"""Checkpoint / resume: the whole simulation is one pytree, so persistence is
a single npz plus a JSON header (params + genome). The reference has no
runtime persistence at all (SURVEY §5.4) — this is strictly additive."""

from __future__ import annotations

import dataclasses
import json

import jax.numpy as jnp
import numpy as np

from sphsim.core.types import (
    BondTable,
    DragInput,
    Genome,
    GenomeMode,
    PendingSplits,
    SimParams,
    SimState,
    state_to_numpy,
)

_FORMAT_VERSION = 1


def save_checkpoint(path: str, state: SimState, params: SimParams,
                    genome: Genome, sim_meta: dict | None = None) -> None:
    """sim_meta: host-level Simulation settings worth restoring (seed,
    rng_mode) — without them, a later resize() on the loaded sim would
    initialize grown rows from a different stream than the original run."""
    flat = state_to_numpy(state)
    header = {
        "version": _FORMAT_VERSION,
        "params": dataclasses.asdict(params),
        "genome": [dataclasses.asdict(m) for m in genome.modes],
        "sim": sim_meta or {},
    }
    np.savez_compressed(path, __header__=json.dumps(header), **flat)


def _build(cls, flat: dict, prefix: str):
    kwargs = {}
    for f in dataclasses.fields(cls):
        name = prefix + f.name
        if f.name == "bonds":
            kwargs[f.name] = _build(BondTable, flat, prefix + "bonds.")
        elif f.name == "pending":
            kwargs[f.name] = _build(PendingSplits, flat, prefix + "pending.")
        elif f.name == "drag_input":
            kwargs[f.name] = _build(DragInput, flat, prefix + "drag_input.")
        else:
            kwargs[f.name] = jnp.asarray(flat[name])
    return cls(**kwargs)


def load_checkpoint(path: str):
    with np.load(path, allow_pickle=False) as data:
        flat = {k: data[k] for k in data.files if k != "__header__"}
        header = json.loads(str(data["__header__"]))
    if header["version"] != _FORMAT_VERSION:
        raise ValueError(f"unsupported checkpoint version {header['version']}")
    # Keys of fields that no longer exist (e.g. the retired `resident`
    # flag) are dropped.
    known = {f.name for f in dataclasses.fields(SimParams)}
    params = SimParams(**{
        k: tuple(v) if isinstance(v, list) else v
        for k, v in header["params"].items() if k in known
    })
    modes = []
    for m in header["genome"]:
        m = dict(m)
        m["mode_color"] = tuple(m["mode_color"])
        modes.append(GenomeMode(**m))
    genome = Genome(tuple(modes))
    state = _build(SimState, flat, "")
    return state, params, genome, header.get("sim", {})
