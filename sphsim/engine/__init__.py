from sphsim.engine.step import step  # noqa: F401
from sphsim.engine.simulation import Simulation  # noqa: F401
