from sphsim.render.camera import Camera  # noqa: F401
from sphsim.render.splat import render_points, save_image  # noqa: F401
