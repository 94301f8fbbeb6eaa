"""Batched analytic ray-tracing camera: RGB / depth / segmentation.

TPU-native replacement of the CPU TinyRenderer camera the reference drives
through `p.getCameraImage` (reference BaseAviary._getDroneImages:565-617):
instead of a host-side C++ rasterizer, the scene is a small set of analytic
primitives (ground plane, landmark boxes/spheres, drone bodies) intersected
in closed form — one fused XLA program renders every pixel of every drone of
every env in parallel, so vision observations stay on device for RL.

Camera parity with the reference: eye at drone pos + [0, 0, L], looking
along the body +x axis (target = pos + R @ [1000, 0, 0]), up [0, 0, 1],
vertical FOV 60 deg, aspect 1.0, near L, far 1000, resolution 64x48
(reference :595-604, IMG_RES at :135).  Depth is returned as an OpenGL-style
normalized depth buffer like PyBullet's; segmentation is an int32 object id
(-1 background, 0 plane, 1.. scene objects, 100+ drones).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import jax.numpy as jnp

from gym_pybullet_drones_tpu.params import DroneParams

FOV_DEG = 60.0
NEAR_FAR = (None, 1000.0)  # near comes from params.l
BIG = 1e9

# TinyRenderer-style fragment shading (the renderer behind the reference's
# p.getCameraImage, BaseAviary.py:606-613):
#   rgb = base_color * (AMBIENT + DIFFUSE * max(0, N . L))
# transcribed from PyBullet's TinyRendererVisualShapeConverter defaults
# lightAmbientCoeff=0.6 / lightDiffuseCoeff=0.35; the 0.05 specular default
# is omitted (small at these coefficients).  The default light DIRECTION in
# PyBullet is scene-scaled and not reproducible offline (zero egress, no
# pybullet binary), so it is pinned here as one documented constant shared
# by the engine and the test oracle (tests/test_render.py shading tests
# recompute the expected colors independently in NumPy from these
# constants).  Environment bound recorded in PARITY.md.
AMBIENT = 0.6
DIFFUSE = 0.35
LIGHT_DIR = (0.4, 0.3, 0.85)


class Scene(NamedTuple):
    """Static primitive scene (device arrays; leading axis = object index)."""

    sphere_center: jnp.ndarray   # (S, 3)
    sphere_radius: jnp.ndarray   # (S,)
    sphere_color: jnp.ndarray    # (S, 3)
    sphere_id: jnp.ndarray       # (S,) int32
    box_center: jnp.ndarray      # (B, 3)
    box_half: jnp.ndarray        # (B, 3)
    box_color: jnp.ndarray       # (B, 3)
    box_id: jnp.ndarray          # (B,) int32


def landmark_scene(dtype=jnp.float32) -> Scene:
    """The 4-landmark RGB-observation scene (reference BaseRLAviary.py:99-128:
    block @ [1,0,.1], small cube @ [0,1,.1], duck @ [-1,0,.1],
    teddy @ [0,-1,.1] — modeled as colored boxes/spheres).

    Palette provenance: the reference objects' colors come from
    pybullet_data URDF/OBJ+MTL materials (duck: yellow rubber-duck
    texture; teddy: brown plush; block / cube_small: textured meshes).
    Those asset files do not exist in this offline image, so the base
    colors below are stand-ins matching each object's well-known
    appearance, NOT transcribed MTL values — an environment bound like
    the firmware binaries (PARITY.md).  The SHADING applied to them is
    the transcribed TinyRenderer model (AMBIENT/DIFFUSE/LIGHT_DIR above),
    verified per-object against an independent NumPy oracle in
    tests/test_render.py."""
    return Scene(
        sphere_center=jnp.asarray([[-1, 0, 0.1], [0, -1, 0.1]], dtype),
        sphere_radius=jnp.asarray([0.08, 0.1], dtype),
        sphere_color=jnp.asarray([[0.95, 0.8, 0.1], [0.6, 0.4, 0.2]], dtype),
        sphere_id=jnp.asarray([3, 4], jnp.int32),
        box_center=jnp.asarray([[1, 0, 0.1], [0, 1, 0.05]], dtype),
        box_half=jnp.asarray([[0.05, 0.05, 0.1], [0.025, 0.025, 0.05]],
                             dtype),
        box_color=jnp.asarray([[0.8, 0.1, 0.1], [0.1, 0.3, 0.85]], dtype),
        box_id=jnp.asarray([1, 2], jnp.int32),
    )


def empty_scene(dtype=jnp.float32) -> Scene:
    return Scene(
        sphere_center=jnp.zeros((0, 3), dtype),
        sphere_radius=jnp.zeros((0,), dtype),
        sphere_color=jnp.zeros((0, 3), dtype),
        sphere_id=jnp.zeros((0,), jnp.int32),
        box_center=jnp.zeros((0, 3), dtype),
        box_half=jnp.zeros((0, 3), dtype),
        box_color=jnp.zeros((0, 3), dtype),
        box_id=jnp.zeros((0,), jnp.int32),
    )


def render(params: DroneParams, scene: Scene, cam_pos, cam_rot,
           drone_pos=None, width: int = 64, height: int = 48):
    """Render one drone's POV.  Broadcasts over leading batch dims of
    cam_pos (..., 3) / cam_rot (..., 3, 3).

    drone_pos: optional (M, 3) other-drone positions rendered as spheres.
    Returns (rgb (..., H, W, 4) in [0, 255], depth (..., H, W) buffer values,
    seg (..., H, W) int32).

    Layout note: all per-pixel state is kept pixel-major — component
    arrays of shape (..., H*W) with the flattened pixel index minormost,
    and hits are an unrolled running minimum over the scene's shapes, with
    no gather.
    """
    dtype = cam_pos.dtype
    near = params.l
    far = 1000.0
    batch = cam_pos.shape[:-1]
    npix = height * width

    def a1(x):
        """(...,) scalar-per-batch -> (..., 1) for pixel broadcasting."""
        return x[..., None]

    eye = cam_pos + jnp.asarray([0.0, 0.0, params.l], dtype)
    ox, oy, oz = a1(eye[..., 0]), a1(eye[..., 1]), a1(eye[..., 2])

    # camera basis (lookAt along body +x, world up)
    forward = cam_rot[..., :, 0]
    up_world = jnp.asarray([0.0, 0.0, 1.0], dtype)
    right = jnp.cross(forward, jnp.broadcast_to(up_world, forward.shape))
    right = right / jnp.maximum(
        jnp.linalg.norm(right, axis=-1, keepdims=True), 1e-6)
    cam_up = jnp.cross(right, forward)

    tan_half = math.tan(math.radians(FOV_DEG) / 2)
    xs = (2 * (jnp.arange(width, dtype=dtype) + 0.5) / width - 1) * tan_half
    ys = (1 - 2 * (jnp.arange(height, dtype=dtype) + 0.5) / height) * tan_half
    px = jnp.tile(xs, height)                              # (P,) row-major
    py = jnp.repeat(ys, width)

    # ray directions, one (..., P) array per component
    dx = a1(forward[..., 0]) + px * a1(right[..., 0]) + py * a1(cam_up[..., 0])
    dy = a1(forward[..., 1]) + px * a1(right[..., 1]) + py * a1(cam_up[..., 1])
    dz = a1(forward[..., 2]) + px * a1(right[..., 2]) + py * a1(cam_up[..., 2])
    inv_len = 1.0 / jnp.sqrt(dx * dx + dy * dy + dz * dz)
    dx, dy, dz = dx * inv_len, dy * inv_len, dz * inv_len

    # running closest-hit buffers; first primitive wins ties (strict <),
    # matching the argmin-over-[spheres, boxes, plane] order of the
    # reference formulation
    big = jnp.full(batch + (npix,), BIG, dtype)
    zero = jnp.zeros(batch + (npix,), dtype)
    t_best = big
    n_bx, n_by, n_bz = zero, zero, zero
    c_br, c_bg, c_bb = zero, zero, zero
    id_b = jnp.full(batch + (npix,), -1, jnp.int32)

    def consider(t, nx, ny, nz, cr, cg, cb, oid):
        nonlocal t_best, n_bx, n_by, n_bz, c_br, c_bg, c_bb, id_b
        m = t < t_best
        t_best = jnp.where(m, t, t_best)
        n_bx = jnp.where(m, nx, n_bx)
        n_by = jnp.where(m, ny, n_by)
        n_bz = jnp.where(m, nz, n_bz)
        c_br = jnp.where(m, cr, c_br)
        c_bg = jnp.where(m, cg, c_bg)
        c_bb = jnp.where(m, cb, c_bb)
        id_b = jnp.where(m, oid, id_b)

    def sphere(cx, cy, cz, r, col, oid):
        """cx/cy/cz/r broadcastable against (..., P); col (3,) constants."""
        ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
        b = ocx * dx + ocy * dy + ocz * dz
        c2 = ocx * ocx + ocy * ocy + ocz * ocz - r * r
        disc = b * b - c2
        sq = jnp.sqrt(jnp.maximum(disc, 0.0))
        t0 = -b - sq
        t1 = -b + sq
        t = jnp.where(t0 > 1e-4, t0, t1)
        t = jnp.where((disc > 0) & (t > 1e-4), t, BIG)
        hx, hy, hz = ox + t * dx - cx, oy + t * dy - cy, oz + t * dz - cz
        inv_n = 1.0 / jnp.maximum(jnp.sqrt(hx * hx + hy * hy + hz * hz),
                                  1e-9)
        consider(t, hx * inv_n, hy * inv_n, hz * inv_n,
                 col[0], col[1], col[2], oid)

    num_s = scene.sphere_radius.shape[0]
    for i in range(num_s):
        c = scene.sphere_center[i]
        sphere(c[0], c[1], c[2], scene.sphere_radius[i],
               scene.sphere_color[i], scene.sphere_id[i])

    if drone_pos is not None:
        # the camera drone must not render its own body: zero the radius of
        # any drone sphere within 3 arm-lengths of this camera (the eye sits
        # at pos + [0,0,L], inside its own 2L sphere)
        drone_col = jnp.asarray([0.35, 0.35, 0.4], dtype)
        for m in range(drone_pos.shape[-2]):
            dpx = drone_pos[..., m, 0]
            dpy = drone_pos[..., m, 1]
            dpz = drone_pos[..., m, 2]
            dist = jnp.sqrt((dpx - cam_pos[..., 0]) ** 2
                            + (dpy - cam_pos[..., 1]) ** 2
                            + (dpz - cam_pos[..., 2]) ** 2)
            r = jnp.where(dist < 3 * params.l, 0.0, 2 * params.l)
            sphere(a1(dpx), a1(dpy), a1(dpz), a1(r), drone_col, 100 + m)

    def sgn(v):
        return jnp.sign(v)

    for i in range(scene.box_half.shape[0]):
        c, h = scene.box_center[i], scene.box_half[i]
        # slab method, one component at a time
        tmin_ax, tmax_ax = [], []
        for (dk, ok, k) in ((dx, ox, 0), (dy, oy, 1), (dz, oz, 2)):
            inv = 1.0 / jnp.where(jnp.abs(dk) > 1e-9, dk,
                                  jnp.where(dk >= 0, 1e-9, -1e-9))
            lo = (c[k] - h[k] - ok) * inv
            hi = (c[k] + h[k] - ok) * inv
            tmin_ax.append(jnp.minimum(lo, hi))
            tmax_ax.append(jnp.maximum(lo, hi))
        tx, ty, tz = tmin_ax
        tmin = jnp.maximum(jnp.maximum(tx, ty), tz)
        tmax = jnp.minimum(jnp.minimum(tmax_ax[0], tmax_ax[1]), tmax_ax[2])
        hit = tmax > jnp.maximum(tmin, 1e-4)
        t = jnp.where(hit, jnp.where(tmin > 1e-4, tmin, tmax), BIG)
        # normal: axis of entry (first-max ordering, like argmax)
        is_x = (tx >= ty) & (tx >= tz)
        is_y = (~is_x) & (ty >= tz)
        nx = jnp.where(is_x, -sgn(dx), 0.0)
        ny = jnp.where(is_y, -sgn(dy), 0.0)
        nz = jnp.where(is_x | is_y, 0.0, -sgn(dz))
        col = scene.box_color[i]
        consider(t, nx, ny, nz, col[0], col[1], col[2], scene.box_id[i])

    # ground plane z = 0 (checkerboard)
    t_p = jnp.where(jnp.abs(dz) > 1e-6, -oz / dz, BIG)
    t_p = jnp.where(t_p > 1e-4, t_p, BIG)
    hpx, hpy = ox + t_p * dx, oy + t_p * dy
    checker = (jnp.floor(hpx) + jnp.floor(hpy)) % 2
    pc = jnp.where(checker > 0.5, jnp.asarray(0.75, dtype),
                   jnp.asarray(0.55, dtype))
    consider(t_p, zero, zero, jnp.ones_like(zero), pc, pc, pc, 0)

    seg = jnp.where(t_best < far, id_b, -1)

    # TinyRenderer-style ambient+diffuse shading (constants above) + sky
    light = jnp.asarray(LIGHT_DIR, dtype)
    light = light / jnp.linalg.norm(light)
    lam = jnp.maximum(
        n_bx * light[0] + n_by * light[1] + n_bz * light[2], 0.0)
    shade = AMBIENT + DIFFUSE * lam
    hit_mask = t_best < far
    sky = jnp.asarray([0.7, 0.85, 1.0], dtype)
    r8 = jnp.clip(jnp.where(hit_mask, shade * c_br, sky[0]) * 255.0, 0, 255)
    g8 = jnp.clip(jnp.where(hit_mask, shade * c_bg, sky[1]) * 255.0, 0, 255)
    b8 = jnp.clip(jnp.where(hit_mask, shade * c_bb, sky[2]) * 255.0, 0, 255)

    # OpenGL-style depth buffer value (what p.getCameraImage returns)
    z = jnp.clip(t_best, near, far)
    depth = (far / (far - near)) * (1.0 - near / z)

    hw = batch + (height, width)
    rgba = jnp.stack(
        [r8.reshape(hw), g8.reshape(hw), b8.reshape(hw),
         jnp.full(hw, 255.0, dtype)], axis=-1)
    return rgba, depth.reshape(hw), seg.reshape(hw)
