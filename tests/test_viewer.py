"""Interactive viewer loop (L5) tests — the drag-while-running demo the
reference does live (ParticleSystemController.cs:975-1034 + CameraFly)."""

import numpy as np

from sphsim import Simulation
from sphsim.app.viewer import ViewerLoop
from sphsim.engine.config import reference_genome, reference_scene_params


def make_sim():
    params = reference_scene_params(capacity=16).replace(
        dt=1 / 60, max_splits_per_step=8, max_bonds=64,
    )
    return Simulation(reference_genome(), params, scan_chunk=4)


def test_scripted_drag_session():
    """Press on the root cell's pixel, drag right across the screen, release:
    the cell must move toward the drag target while physics keeps running."""
    sim = make_sim()
    v = ViewerLoop(sim, width=320, height=180, substeps=4, show_bonds=False)

    # The root cell sits at the origin; the focused camera centers it.
    cx, cy = v.width // 2, v.height // 2
    x0 = float(sim.state.pos[0, 0])

    v.frame([{"type": "mouse_down", "x": cx, "y": cy}])
    assert v.drag_slot == 0
    assert int(sim.state.drag_input.selected_slot) == 0
    assert v.drag_distance > 0

    # Drag toward the right edge over a few frames (target follows the pixel
    # ray at the fixed pick distance, cs:1016-1020).
    for x in (cx + 40, cx + 80, cx + 120):
        v.frame([{"type": "mouse_move", "x": x, "y": cy}])
    for _ in range(6):
        v.frame()
    x1 = float(sim.state.pos[0, 0])
    assert x1 > x0 + 0.5, (x0, x1)

    v.frame([{"type": "mouse_up"}])
    assert v.drag_slot == -1
    assert int(sim.state.drag_input.selected_slot) == -1

    assert v.frame_count == 11
    assert np.isfinite(v.fps) and v.fps > 0


def test_missed_pick_and_camera_events():
    """Clicking empty space picks nothing; camera fly/orbit/zoom events steer
    the camera (CameraFly.cs:87-146 semantics) without disturbing the sim."""
    sim = make_sim()
    v = ViewerLoop(sim, width=320, height=180, substeps=2, show_bonds=False)
    v.frame([{"type": "mouse_down", "x": 2, "y": 2}])  # corner: no sphere
    assert v.drag_slot == -1

    p0 = v.camera.position.copy()
    v.frame([
        {"type": "mouse_up"},
        {"type": "key", "key": "w", "dt": 0.5},
        {"type": "look", "dx": 10.0, "dy": 0.0},
        {"type": "scroll", "amount": 1.0},
    ])
    assert np.linalg.norm(v.camera.position - p0) > 1.0
    assert v.camera.yaw != 0.0

    v.frame([{"type": "orbit"}])
    assert v.camera.orbit_mode
    yaw0 = v.camera.yaw
    v.frame()
    assert v.camera.yaw != yaw0  # orbiting advances even with no events


def test_pixel_ray_roundtrip():
    """pixel_ray inverts project_points: a world point projected to a pixel
    is on (within a pixel of) the ray cast back through that pixel."""
    import jax.numpy as jnp

    from sphsim.render.camera import Camera
    from sphsim.render.splat import project_points

    cam = Camera()
    cam.focus_on((0, 0, 0), distance=40.0)
    cam.look(13.0, -7.0)
    w, h = 640, 360
    pt = np.array([3.0, -2.0, 5.0], np.float32)
    eye, right, up, fwd, tanf = cam.view_params()
    px, py, z, vis = project_points(
        jnp.asarray(pt)[None], jnp.asarray(eye), jnp.asarray(right),
        jnp.asarray(up), jnp.asarray(fwd), tanf, w, h,
    )
    assert bool(vis[0])
    origin, d = cam.pixel_ray(float(px[0]), float(py[0]), w, h)
    t = float(np.dot(pt - origin, d))
    closest = origin + d * t
    # Within a pixel's footprint at that depth.
    pix_world = float(z[0]) * tanf * 2.0 / h
    assert np.linalg.norm(closest - pt) < 2.0 * pix_world
