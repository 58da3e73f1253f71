from sphsim.biology.bonds import (  # noqa: F401
    classify_zone,
    filter_bonds,
    handle_cell_split,
    update_bond_zones,
)
from sphsim.biology.division import (  # noqa: F401
    process_pending_splits,
    queue_splits,
)

ZONE_A = 0
ZONE_B = 1
ZONE_C = 2
