from sphsim.sph.model import SPHParams, SPHState, sph_step, make_sph_step  # noqa: F401
from sphsim.sph.scenes import dam_break_2d, dam_break_3d, splash_pour_2d  # noqa: F401
