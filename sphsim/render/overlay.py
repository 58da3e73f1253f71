"""Host-side debug overlays on rendered frames — the reference's L4
visualization channels (SURVEY §2.10): per-particle ID labels (TMP labels,
ParticleSystemController.cs:1292-1350), zone-colored bond lines with the
white anchor-to-anchor line (CellAdhesionManager.cs:245-304), yellow anchor
gizmo markers (CAM:564-590), drag circle + particle-to-target line
(cs:1036-1063), and the selected cell's split-plane ring (cs:1065-1109).
Drawn with PIL onto the on-device splat."""

from __future__ import annotations

import numpy as np


def _project(points, camera, width, height):
    """Host-side projection matching render.splat.project_points."""
    eye, right, up, fwd, tanf = camera.view_params()
    rel = np.asarray(points, np.float32) - eye
    x = rel @ right
    y = rel @ up
    z = rel @ fwd
    safe = np.maximum(z, 1e-6)
    aspect = width / height
    px = (x / (safe * tanf * aspect) * 0.5 + 0.5) * (width - 1)
    py = (1.0 - (y / (safe * tanf) * 0.5 + 0.5)) * (height - 1)
    vis = (z > 1e-3) & (px >= 0) & (px < width) & (py >= 0) & (py < height)
    return px, py, vis


def split_plane_ring_points(center, rot, split_yaw, split_pitch,
                            radius: float = 2.0, segments: int = 48):
    """World-space ring showing a cell's division plane
    (UpdateSplitPlaneRings, ParticleSystemController.cs:1065-1109): normal =
    the mode's split direction through the cell's rotated frame; the ring is
    the radius-2 circle in the plane ⊥ normal, 48 segments (+1 closing
    point), matching the reference's defaults (cs:51-52)."""
    from sphsim.core import quat

    d_local = np.asarray(
        quat.euler_direction(np.float32(split_yaw), np.float32(split_pitch))
    )
    import jax.numpy as jnp

    r3 = np.asarray(quat.rotate(jnp.asarray(rot, jnp.float32)[None, :],
                                jnp.eye(3, dtype=jnp.float32)))
    # rows of r3: world images of local x/y/z axes.
    normal = (r3[0] * d_local[0] + r3[1] * d_local[1] + r3[2] * d_local[2])
    normal = normal / max(np.linalg.norm(normal), 1e-12)
    # Quaternion.FromToRotation(up, normal) applied to circle points in the
    # local XZ plane == any orthonormal basis (u, v) of the plane ⊥ normal.
    ref = np.array([0.0, 1.0, 0.0], np.float32)
    if abs(float(normal @ ref)) > 0.99:
        ref = np.array([1.0, 0.0, 0.0], np.float32)
    u = np.cross(ref, normal)
    u = u / max(np.linalg.norm(u), 1e-12)
    v = np.cross(normal, u)
    ang = np.linspace(0.0, 2.0 * np.pi, segments + 1)
    return (
        np.asarray(center, np.float32)[None, :]
        + radius * (np.cos(ang)[:, None] * u + np.sin(ang)[:, None] * v)
    ).astype(np.float32)


def draw_overlays(
    img,
    camera,
    labels: list[tuple] | None = None,        # [(pos3, text)]
    bond_lines: list[dict] | None = None,      # Simulation.bond_lines()
    drag_target=None,                          # world pos or None
    drag_from=None,                            # dragged particle pos or None
    split_ring=None,                           # [S+1, 3] world points or None
    show_anchors: bool = False,                # yellow gizmos (CAM:564-590)
):
    """Return a PIL.Image of `img` ([H,W,3] float 0..1) with overlays."""
    from PIL import Image, ImageDraw

    arr = (np.clip(np.asarray(img), 0, 1) * 255).astype(np.uint8)
    pil = Image.fromarray(arr)
    draw = ImageDraw.Draw(pil)
    h, w = arr.shape[:2]

    if bond_lines:
        # ONE batched projection of all bonds' 5 points (per-bond _project
        # calls were ~B numpy dispatches per frame — a 16k-bond colony
        # spent seconds per frame in projection alone).
        all_pts = np.array(
            [[b["a"], b["midpoint"], b["b"], b["anchor_a"], b["anchor_b"]]
             for b in bond_lines], np.float32
        ).reshape(-1, 3)
        apx, apy, avis = _project(all_pts, camera, w, h)
        apx = apx.reshape(-1, 5)
        apy = apy.reshape(-1, 5)
        avis = avis.reshape(-1, 5)
        for j, b in enumerate(bond_lines):
            px, py, vis = apx[j], apy[j], avis[j]
            if vis[:3].all():
                ca = tuple(int(c * 255) for c in b["color_a"])
                cb = tuple(int(c * 255) for c in b["color_b"])
                draw.line([(px[0], py[0]), (px[1], py[1])], fill=ca, width=2)
                draw.line([(px[1], py[1]), (px[2], py[2])], fill=cb, width=2)
            if vis[3:].all():
                # White anchor-to-anchor line (CAM:287-302).
                draw.line([(px[3], py[3]), (px[4], py[4])],
                          fill=(255, 255, 255), width=1)
                if show_anchors:
                    # Yellow anchor gizmo markers (wire spheres of world
                    # size 0.1, CAM:15-16, :586-587) as small circles.
                    for k in (3, 4):
                        draw.ellipse(
                            [px[k] - 3, py[k] - 3, px[k] + 3, py[k] + 3],
                            outline=(255, 255, 0), width=1,
                        )

    if split_ring is not None:
        # Cyan split-plane ring of the selected cell (cs:1065-1109).
        px, py, vis = _project(np.asarray(split_ring, np.float32),
                               camera, w, h)
        for i in range(len(px) - 1):
            if vis[i] and vis[i + 1]:
                draw.line([(px[i], py[i]), (px[i + 1], py[i + 1])],
                          fill=(0, 255, 255), width=1)

    if labels:
        pts = np.array([p for p, _ in labels], np.float32)
        px, py, vis = _project(pts, camera, w, h)
        for i, (_, text) in enumerate(labels):
            if vis[i] and np.isfinite(px[i]) and np.isfinite(py[i]):
                draw.text((px[i] + 3, py[i] - 8), text, fill=(255, 255, 160))

    if drag_target is not None:
        ends = [np.asarray(drag_target, np.float32)]
        if drag_from is not None:
            ends.append(np.asarray(drag_from, np.float32))
        px, py, vis = _project(np.asarray(ends, np.float32), camera, w, h)
        if vis[0]:
            r = 6
            # Green drag circle (cs:1036-1063).
            draw.ellipse([px[0] - r, py[0] - r, px[0] + r, py[0] + r],
                         outline=(0, 255, 0), width=2)
        if drag_from is not None and vis.all():
            # Particle-to-target drag line (cs:1054-1056).
            draw.line([(px[1], py[1]), (px[0], py[0])],
                      fill=(0, 255, 0), width=1)
    return pil


def render_cells_frame(sim, camera=None, width=800, height=450,
                       show_labels=True, show_bonds=True, path=None,
                       impostor=True, show_anchors=True,
                       show_split_rings=False):
    """Full cell-sim frame: on-device spheres + host overlays (ids, bonds,
    anchor gizmos, drag circle+line, selected cell's split-plane ring) —
    the reference's complete visual channel set. show_anchors defaults on
    and show_split_rings off, matching the shipped scene
    (CellAdhesionManager.cs:14, Particle Simulation.unity
    showSplitPlaneRings 0).

    impostor=True renders radius-scaled, orientation-shaded sphere impostors
    with the red forward-axis dot (InstancedParticles.shader:84-116,
    146-177); False falls back to the cheaper additive splats."""
    import jax.numpy as jnp

    from sphsim.render.camera import Camera
    from sphsim.render.splat import render_points

    if camera is None:
        camera = Camera()
        camera.focus_on((0, 0, 0), distance=3.0 * sim.params.spawn_radius)

    n_modes = max(len(sim.genome.modes), 1)
    colors = jnp.asarray(sim.genome_dev.mode_color[:, :3])[
        jnp.clip(sim.state.mode, 0, n_modes - 1)
    ]
    mask = jnp.arange(sim.state.capacity) < sim.state.active_count
    if impostor:
        from sphsim.render.impostor import render_spheres

        img = render_spheres(
            sim.state.pos, sim.state.radius, sim.state.rot, colors,
            camera.view_params(), width=width, height=height, mask=mask,
        )
    else:
        img = render_points(
            sim.state.pos, camera.view_params(), width=width, height=height,
            colors=colors, mask=mask, splat_radius_px=4,
        )

    n = int(sim.state.active_count)
    labels = None
    if show_labels:
        pos = np.asarray(sim.state.pos[:n])
        ids = sim.particle_ids()
        labels = [(pos[i], ids[i]) for i in range(n)]
    bonds = sim.bond_lines() if show_bonds else None
    drag = drag_from = None
    sel = int(sim.state.drag_input.selected_slot)
    if sel >= 0:
        drag = np.asarray(sim.state.drag_input.target)
        if sel < n:
            drag_from = np.asarray(sim.state.pos[sel])
    ring = None
    last = getattr(sim, "last_selected", -1)
    if show_split_rings and 0 <= last < n:
        mode = int(sim.state.mode[last])
        if 0 <= mode < n_modes:
            m = sim.genome.modes[mode]
            ring = split_plane_ring_points(
                np.asarray(sim.state.pos[last]),
                np.asarray(sim.state.rot[last]),
                m.parent_split_yaw, m.parent_split_pitch,
            )
    pil = draw_overlays(img, camera, labels=labels, bond_lines=bonds,
                        drag_target=drag, drag_from=drag_from,
                        split_ring=ring, show_anchors=show_anchors)
    if path:
        pil.save(path)
    return pil
