from sphsim.native.golden import (  # noqa: F401
    adhesion_deltas_native,
    contact_forces_native,
    ensure_built,
    filter_bonds_native,
    process_splits_native,
    queue_splits_native,
    sph_density_accel_native,
    update_bond_zones_native,
    update_motion_native,
    update_rotation_native,
)
