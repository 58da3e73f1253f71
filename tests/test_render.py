"""On-device point-splat rasterizer + camera tests (reference L4/L5
parity surface: instanced render cs:344-347, CameraFly.cs)."""

import jax.numpy as jnp
import numpy as np

from sphsim.render.camera import Camera
from sphsim.render.splat import project_points, render_points, zbuffer


def straight_camera():
    cam = Camera(position=np.array([0.0, 0.0, -10.0], np.float32))
    cam.yaw = 0.0
    cam.pitch = 0.0
    return cam


def test_projection_center_and_offsets():
    cam = straight_camera()
    eye, r, u, f, tanf = cam.view_params()
    pos = jnp.array([
        [0.0, 0.0, 0.0],     # straight ahead → image center
        [1.0, 0.0, 0.0],     # right of camera → right of center
        [0.0, 1.0, 0.0],     # above → upper half (smaller py)
        [0.0, 0.0, -20.0],   # behind the camera → invisible
    ])
    px, py, z, vis = project_points(
        pos, jnp.asarray(eye), jnp.asarray(r), jnp.asarray(u),
        jnp.asarray(f), tanf, 200, 100,
    )
    assert abs(float(px[0]) - 99.5) < 1.0 and abs(float(py[0]) - 49.5) < 1.0
    assert float(px[1]) > float(px[0])
    assert float(py[2]) < float(py[0])
    assert bool(vis[0]) and bool(vis[1]) and bool(vis[2]) and not bool(vis[3])


def test_render_points_lights_up_particle_pixels():
    cam = straight_camera()
    pos = jnp.array([[0.0, 0.0, 0.0]])
    img = render_points(pos, cam.view_params(), width=64, height=64,
                        splat_radius_px=2, background=(0.0, 0.0, 0.0))
    img = np.asarray(img)
    assert img.shape == (64, 64, 3)
    cy, cx = np.unravel_index(img.sum(-1).argmax(), (64, 64))
    assert abs(cx - 31.5) < 3 and abs(cy - 31.5) < 3
    # Corners stay background-dark.
    assert img[0, 0].sum() < 0.05


def test_render_mask_and_determinism():
    cam = straight_camera()
    key_pos = jnp.array([[0.0, 0.0, 0.0], [50.0, 50.0, 0.0]])
    mask = jnp.array([True, False])
    img1 = render_points(key_pos, cam.view_params(), width=64, height=64,
                         mask=mask)
    img2 = render_points(key_pos, cam.view_params(), width=64, height=64,
                         mask=mask)
    np.testing.assert_array_equal(np.asarray(img1), np.asarray(img2))


def test_zbuffer_nearest():
    cam = straight_camera()
    pos = jnp.array([[0.0, 0.0, 0.0], [0.0, 0.0, 5.0]])  # same ray, z=10/15
    zb = np.asarray(zbuffer(pos, cam.view_params(), width=32, height=32))
    assert abs(zb.min() - 10.0) < 1e-3  # nearest wins


def test_camera_pitch_clamp_and_move():
    cam = Camera()
    cam.look(0.0, 1000.0)
    assert cam.pitch == 80.0  # CameraFly.cs ±80° clamp
    p0 = cam.position.copy()
    cam.move(1.0, forward=1.0)
    assert np.linalg.norm(cam.position - p0) > 0
    cam.move(1.0, forward=1.0, sprint=True)  # sprint moves farther
    d1 = np.linalg.norm(cam.position - p0)
    assert d1 > cam.move_speed  # > one non-sprint step


def test_camera_focus_on_looks_at_target():
    cam = Camera(position=np.array([5.0, 3.0, -20.0], np.float32))
    cam.focus_on((1.0, 2.0, 3.0), distance=7.0)
    _, _, f = cam.basis()
    to_target = np.array([1.0, 2.0, 3.0]) - cam.position
    assert abs(np.linalg.norm(to_target) - 7.0) < 1e-3
    cos = to_target @ f / np.linalg.norm(to_target)
    assert cos > 0.999


def test_camera_orbit_keeps_distance():
    cam = Camera(position=np.array([0.0, 0.0, -15.0], np.float32))
    cam.toggle_orbit(target=(0.0, 0.0, 0.0))
    for _ in range(10):
        cam.orbit(0.1)
        d = np.linalg.norm(cam.position - cam.orbit_target)
        assert abs(d - 15.0) < 1e-3


def test_cells_overlay_frame(tmp_path):
    """Full visual channel set: splat + id labels + zone-colored bond lines
    + drag marker (reference L4 parity surface)."""
    from sphsim import Simulation
    from sphsim.engine.config import reference_genome, reference_scene_params
    from sphsim.render.overlay import render_cells_frame

    p = reference_scene_params(capacity=16).replace(
        dt=0.5, max_splits_per_step=8, max_bonds=64
    )
    sim = Simulation(reference_genome(), p)
    sim.step(24)
    sim.set_drag(0, (5.0, 5.0, 0.0), 100.0)
    sim.last_selected = 0   # as a pick() hit would set (cs:125)
    out = tmp_path / "cells.png"
    pil = render_cells_frame(sim, path=str(out), show_split_rings=True,
                             show_anchors=True)
    assert out.exists()
    arr = np.asarray(pil)
    assert arr.shape == (450, 800, 3)
    # Overlays leave non-background pixels (labels are yellowish, drag green).
    assert (arr[..., 1].astype(int) - arr[..., 2].astype(int) > 60).any()
    # The split-plane ring draws pure cyan pixels (cs:1065-1109 channel).
    cyan = (arr[..., 0] < 40) & (arr[..., 1] > 200) & (arr[..., 2] > 200)
    assert cyan.any()
    # Baseline frame (rings off, anchors off) differs.
    base = render_cells_frame(sim, show_split_rings=False,
                              show_anchors=False)
    assert (np.asarray(base) != arr).any()


def test_split_plane_ring_geometry():
    """Ring points lie on the radius-2 circle in the plane ⊥ the world
    split direction (cs:1065-1109: normal = frame · GetDirection(yaw,
    pitch), radius 2, 48 segments + closing point)."""
    from sphsim.render.overlay import split_plane_ring_points

    center = np.array([1.0, 2.0, 3.0], np.float32)
    rot = np.array([0.0, 0.0, 0.0, 1.0], np.float32)   # identity
    pts = split_plane_ring_points(center, rot, split_yaw=0.0,
                                  split_pitch=0.0)
    assert pts.shape == (49, 3)
    rel = pts - center
    # yaw 0 / pitch 0 ⇒ split dir (= normal) is local +z.
    np.testing.assert_allclose(rel[:, 2], 0.0, atol=1e-5)
    np.testing.assert_allclose(
        np.linalg.norm(rel, axis=-1), 2.0, rtol=1e-5
    )
    np.testing.assert_allclose(pts[0], pts[-1], atol=1e-5)  # closed loop


def test_sphere_impostor_radius_and_forward_dot():
    """Reference parity (InstancedParticles.shader:84-116, 146-177): radius
    visibly scales the drawn sphere, and the red forward-axis dot appears
    where the surface normal aligns with the particle's body +Z axis."""
    import jax

    from sphsim.core import quat
    from sphsim.render.impostor import render_spheres

    cam = straight_camera()
    # Two cells: the right one has twice the radius. Identity rotation means
    # body +Z == world +Z == pointing AWAY from the camera (forward dot on
    # the far side, invisible); rotate the left cell 180° about y so its +Z
    # faces the camera.
    pos = jnp.array([[-3.0, 0.0, 0.0], [3.0, 0.0, 0.0]])
    radius = jnp.array([1.0, 2.0])
    q_flip = quat.from_axis_angle(jnp.array([0.0, 1.0, 0.0]), jnp.pi)
    rot = jnp.stack([q_flip, quat.identity()])
    colors = jnp.array([[0.2, 0.8, 0.2], [0.2, 0.2, 0.9]])
    img = jax.jit(lambda p: render_spheres(
        p, radius, rot, colors, cam.view_params(), width=160, height=120,
        window=40,
    ))(pos)
    arr = np.asarray(img)
    assert np.isfinite(arr).all() and arr.min() >= 0.0 and arr.max() <= 1.0

    # Coverage: count pixels dominated by each cell's color channel.
    bg = np.array([0.02, 0.02, 0.05])
    fg = np.abs(arr - bg).sum(-1) > 0.05
    green = fg & (arr[..., 1] > arr[..., 2])
    blue = fg & (arr[..., 2] > arr[..., 1])
    assert blue.sum() > 2.5 * green.sum(), (green.sum(), blue.sum())

    # Red forward-axis dot: on the flipped (left/green) cell only — pixels
    # where red strongly exceeds the base green shading.
    red_dot = (arr[..., 0] > 0.8) & (arr[..., 0] > arr[..., 1] + 0.3)
    ys, xs = np.nonzero(red_dot)
    assert len(xs) > 0
    assert xs.max() < 80  # all on the left half (the flipped cell)


def test_render_points_radius_binning():
    """Projected-size splat classes: a near/large particle spreads over
    more pixels than a far/small one."""
    cam = straight_camera()
    pos = jnp.array([[-2.0, 0.0, 0.0], [2.0, 0.0, 0.0]])
    radius = jnp.array([1.5, 0.05])
    img = render_points(
        pos, cam.view_params(), width=128, height=96,
        colors=jnp.ones((2, 3)), radius=radius, exposure=4.0,
    )
    arr = np.asarray(img)
    lit = arr.sum(-1) > 0.3
    left = lit[:, :64].sum()
    right = lit[:, 64:].sum()
    assert left > 3 * max(right, 1), (left, right)


def _decode_png(data: bytes) -> np.ndarray:
    """Minimal decoder for the writer's format: 8-bit RGB, filter 0."""
    import struct
    import zlib

    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, hdr = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(kind + body) & 0xFFFFFFFF, kind
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, ctype = hdr[:4]
    assert (depth, ctype) == (8, 2)
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    assert (raw[:, 0] == 0).all()
    return raw[:, 1:].reshape(h, w, 3)


def test_png_writer_roundtrip(tmp_path):
    """save_image writes a valid PNG (stdlib writer) whose pixels decode
    back to the quantized image."""
    from sphsim.render.splat import png_bytes, save_image

    rng = np.random.default_rng(0)
    arr = rng.integers(0, 256, (7, 13, 3), dtype=np.uint8)
    np.testing.assert_array_equal(_decode_png(png_bytes(arr)), arr)

    img = jnp.asarray(rng.uniform(-0.2, 1.2, (5, 9, 3)).astype(np.float32))
    path = tmp_path / "f.png"
    save_image(img, str(path))
    want = (np.clip(np.asarray(img), 0, 1) * 255).astype(np.uint8)
    np.testing.assert_array_equal(_decode_png(path.read_bytes()), want)
