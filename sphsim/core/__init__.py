from sphsim.core import quat  # noqa: F401
from sphsim.core.types import (  # noqa: F401
    BondTable,
    Genome,
    GenomeDevice,
    GenomeMode,
    PendingSplits,
    SimParams,
    SimState,
)
