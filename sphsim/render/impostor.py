"""Sphere-impostor renderer: radius-scaled, orientation-shaded spheres with
the reference's exact lighting model (InstancedParticles.shader:118-177):

    diffuse  = cellColor · saturate(N·L) · lightColor        (:164)
    ambient  = cellColor · 0.3                                (:165)
    specular = saturate(N·H)^32 · 0.5 · lightColor · 0.5      (:166)
    redDot   = (1,0,0) · smoothstep(0.98, 1, N·F)             (:171-175)
    final    = diffuse + ambient + specular + redDot          (:177)

where F is the particle's body +Z axis in world space (the reference's
visual orientation indicator) and N the sphere surface normal.

Device-first formulation (no per-pixel loops, no instanced meshes): each
particle emits a fixed WINDOW×WINDOW block of screen samples around its
projected center; each sample analytically ray-traces its own sphere point
(disc test + normal + front-surface depth). Occlusion is a two-pass
z-buffer: segment_min of sample depths, then a winner test per sample.
Everything runs under jit; the host reads back one [H, W, 3] frame.

Intended for the cell sim's scale (≤ ~50k particles; samples = N·WINDOW²).
The fluid path keeps the cheaper additive splats (render/splat.py), which
also gained projected-radius scaling.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from sphsim.core import quat
from sphsim.render.splat import project_points


def _smoothstep(e0, e1, x):
    t = jnp.clip((x - e0) / (e1 - e0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def render_spheres(
    pos: jnp.ndarray,
    radius: jnp.ndarray,
    rot: jnp.ndarray,
    colors: jnp.ndarray,
    camera_params,
    width: int = 640,
    height: int = 360,
    mask: jnp.ndarray | None = None,
    window: int = 24,
    light_dir=(0.4, 0.8, -0.45),
    light_color=(1.0, 1.0, 1.0),
    show_dot: bool = True,
    background=(0.02, 0.02, 0.05),
) -> jnp.ndarray:
    """Shaded sphere-impostor image [H, W, 3] in [0, 1], fully on device.

    pos [N,3], radius [N], rot [N,4] quaternions, colors [N,3] (per-mode
    cell colors). window: per-particle sample block edge in pixels; spheres
    whose projected diameter exceeds it are clipped to the window (pick a
    camera distance accordingly)."""
    eye, right, up, forward = (
        jnp.asarray(camera_params[0]), jnp.asarray(camera_params[1]),
        jnp.asarray(camera_params[2]), jnp.asarray(camera_params[3]),
    )
    tanf = camera_params[4]

    px, py, z, visible = project_points(
        pos, eye, right, up, forward, tanf, width, height
    )
    if mask is not None:
        visible = visible & mask

    # Projected pixel radius: world radius / (z·tan_half_fov) in NDC, times
    # half the screen height (the shader scales mesh verts by p.radius —
    # shader:97 — this is the impostor equivalent).
    r_px = radius * (height * 0.5) / (jnp.maximum(z, 1e-6) * tanf)
    r_px = jnp.clip(r_px, 0.5, window * 0.5)

    half = window // 2
    duv = jnp.arange(window, dtype=jnp.float32) - (half - 0.5)
    du = duv[None, :, None]                       # [1, W, 1] x-offsets
    dv = duv[None, None, :]                       # [1, 1, W] y-offsets
    cx = jnp.floor(px)[:, None, None]
    cy = jnp.floor(py)[:, None, None]
    sx = cx + du                                  # sample pixel coords
    sy = cy + dv
    ox = (sx - px[:, None, None]) / r_px[:, None, None]
    oy = (sy - py[:, None, None]) / r_px[:, None, None]
    d2 = ox * ox + oy * oy
    inside = (d2 <= 1.0) & visible[:, None, None]
    in_frame = (sx >= 0) & (sx < width) & (sy >= 0) & (sy < height)
    inside = inside & in_frame

    nz = jnp.sqrt(jnp.maximum(1.0 - d2, 0.0))
    # Camera-space sphere normal at the sample, world-space via the camera
    # basis (screen y grows downward ⇒ −up; the visible surface faces the
    # camera ⇒ −forward).
    n_world = (
        ox[..., None] * right
        - oy[..., None] * up
        - nz[..., None] * forward
    )
    # Front sphere surface depth.
    depth = z[:, None, None] - nz * radius[:, None, None]

    pid = jnp.where(
        inside,
        sy.astype(jnp.int32) * width + sx.astype(jnp.int32),
        width * height,
    )
    npix = width * height

    # Pass 1: z-buffer.
    zed = jnp.where(inside, depth, jnp.inf)
    zb = jax.ops.segment_min(
        zed.reshape(-1), pid.reshape(-1), num_segments=npix + 1
    )[:npix]

    # Pass 2: shade winners (samples whose depth matches the z-buffer).
    win = inside & (depth <= zb[jnp.clip(pid, 0, npix - 1)].reshape(pid.shape)
                    * (1.0 + 1e-6) + 1e-7)

    ldir = jnp.asarray(light_dir, jnp.float32)
    ldir = ldir / jnp.linalg.norm(ldir)
    lcol = jnp.asarray(light_color, jnp.float32)
    ndotl = jnp.clip(jnp.einsum("nwvc,c->nwv", n_world, ldir), 0.0, 1.0)
    view = -forward                                  # orthographic-ish view
    h_vec = ldir + view
    h_vec = h_vec / jnp.linalg.norm(h_vec)
    ndoth = jnp.clip(jnp.einsum("nwvc,c->nwv", n_world, h_vec), 0.0, 1.0)

    cell = colors[:, None, None, :]
    diffuse = cell * ndotl[..., None] * lcol
    ambient = cell * 0.3
    specular = (ndoth ** 32.0)[..., None] * 0.5 * lcol * 0.5
    shade = diffuse + ambient + specular

    if show_dot:
        fwd_axis = quat.rotate(rot, jnp.array([0.0, 0.0, 1.0]))
        fwd_axis = fwd_axis / jnp.maximum(
            jnp.linalg.norm(fwd_axis, axis=-1, keepdims=True), 1e-9
        )
        ndotf = jnp.einsum("nwvc,nc->nwv", n_world, fwd_axis)
        shade = shade + jnp.array([1.0, 0.0, 0.0]) * _smoothstep(
            0.98, 1.0, ndotf
        )[..., None]

    w = win.astype(jnp.float32)
    num = jax.ops.segment_sum(
        (shade * w[..., None]).reshape(-1, 3), pid.reshape(-1),
        num_segments=npix + 1,
    )[:npix]
    den = jax.ops.segment_sum(
        w.reshape(-1), pid.reshape(-1), num_segments=npix + 1
    )[:npix]
    img = num / jnp.maximum(den, 1.0)[:, None]
    covered = (den > 0.0)[:, None]
    bg = jnp.asarray(background, jnp.float32)
    img = jnp.where(covered, img, bg)
    return jnp.clip(img.reshape(height, width, 3), 0.0, 1.0)
