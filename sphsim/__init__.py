"""sphsim — a JAX particle-simulation framework.

Built from scratch (JAX / XLA / Pallas / shard_map) with the capabilities of the
Unity GPU-compute reference Quadraxis77/SPH-TEST:

- soft-sphere contact dynamics with rigid-body rotation and rolling friction
- genome-driven cell division with an adhesion bond graph
- classical SPH fluid models (poly6/spiky density/pressure/viscosity)
- spatial-hash neighbor search, Triton-route Pallas sweep kernels, sharded
  domain decomposition with halo exchange, on-device point-splat rendering

See DESIGN.md for the deterministic executable spec and SURVEY.md for the
structural analysis of the reference.
"""

__version__ = "0.1.0"

from sphsim.core.types import (  # noqa: F401
    Genome,
    GenomeMode,
    SimParams,
    SimState,
)
from sphsim.engine.simulation import Simulation  # noqa: F401
