from sphsim.physics.contact import contact_forces_bruteforce  # noqa: F401
from sphsim.physics.integrate import update_motion, update_rotation  # noqa: F401
from sphsim.physics.adhesion import apply_adhesion  # noqa: F401
from sphsim.physics.drag import apply_drag_force  # noqa: F401
