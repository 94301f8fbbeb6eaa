"""Aerodynamic effect models: ground effect, rotor drag, downwash.

Parity formulas from the reference engine
(/root/reference/gym_pybullet_drones/envs/BaseAviary.py:715-811):

- ground effect (:715-750): per-prop heights via forward kinematics, clipped
  below at GND_EFF_H_CLIP; upward per-prop force
  kf*rpm^2 * gnd_eff_coeff * (prop_radius / (4 h))^2, gated on
  |roll|, |pitch| < pi/2, applied in the LINK frame (i.e. rotated by R).
- drag (:754-781): body-frame force R^T (-drag_coeff * sum(2 pi rpm / 60) * v),
  applied at the CoM in the LINK frame; the caller must pass the PREVIOUS
  control step's clipped rpm (reference step() passes last_clipped_action,
  BaseAviary.py:359,366).
- downwash (:785-811): for every drone i above drone n (dz > 0, dxy < 10 m),
  alpha = dw1 (prop_radius / (4 dz))^2, beta = dw2 dz + dw3,
  force [0, 0, -alpha exp(-0.5 (dxy/beta)^2)] in the LINK frame.

Where the reference issues per-drone, per-prop PyBullet C-API calls, these are
vectorized closed forms over a trailing drone axis: states are shaped
(..., N, 3)/(..., N, 4) and downwash is a masked O(N^2) pairwise reduction —
the idiomatic TPU formulation of the reference's Python double loop.

Each function returns (world_force, world_torque) increments about the CoM.
"""
from __future__ import annotations

import jax.numpy as jnp
from jax.lax import Precision

from gym_pybullet_drones_tpu.params import DroneParams

# physics contractions run in full float32 on every backend (the GPU's
# default would allow TF32 for float32 dots)
HIGHEST = Precision.HIGHEST


def prop_positions(params: DroneParams, pos: jnp.ndarray,
                   rot: jnp.ndarray) -> jnp.ndarray:
    """World positions of the 4 prop links: pos + R @ offset.

    Analytic replacement of the reference's p.getLinkStates forward kinematics
    (BaseAviary.py:732-737); offsets come from the URDF prop link inertial
    origins (see params.DroneParams.prop_offsets).
    Shapes: pos (..., 3), rot (..., 3, 3) -> (..., 4, 3).
    """
    offsets = jnp.asarray(params.prop_offsets, dtype=pos.dtype)  # (4, 3)
    world_off = jnp.einsum("...ij,pj->...pi", rot, offsets, precision=HIGHEST)
    return pos[..., None, :] + world_off


def ground_effect(params: DroneParams, rpm: jnp.ndarray, pos: jnp.ndarray,
                  rot: jnp.ndarray, rpy: jnp.ndarray):
    """Ground-effect force/torque about the CoM (world frame).

    Per-prop LINK-frame force [0,0,G_i] => world force R @ [0,0,G_i] applied
    at prop position, contributing torque (R @ offset_i) x (R @ [0,0,G_i]).
    """
    dtype = pos.dtype
    offsets = jnp.asarray(params.prop_offsets, dtype=dtype)       # (4, 3)
    world_off = jnp.einsum("...ij,pj->...pi", rot, offsets,
                           precision=HIGHEST)                 # (..., 4, 3)
    heights = pos[..., None, 2] + world_off[..., 2]               # (..., 4)
    heights = jnp.clip(heights, params.gnd_eff_h_clip, jnp.inf)
    gnd = (rpm * rpm) * params.kf * params.gnd_eff_coeff * \
        (params.prop_radius / (4.0 * heights)) ** 2               # (..., 4)
    # Whole-drone attitude gate (BaseAviary.py:742)
    upright = (jnp.abs(rpy[..., 0]) < jnp.pi / 2) & \
              (jnp.abs(rpy[..., 1]) < jnp.pi / 2)
    gnd = gnd * upright[..., None].astype(dtype)
    # world force per prop = G_i * R[:, 2]
    z_axis = rot[..., :, 2]                                       # (..., 3)
    force = jnp.sum(gnd, axis=-1)[..., None] * z_axis
    f_per_prop = gnd[..., None] * z_axis[..., None, :]            # (..., 4, 3)
    torque = jnp.sum(jnp.cross(world_off, f_per_prop), axis=-2)
    return force, torque


def drag(params: DroneParams, last_rpm: jnp.ndarray, vel: jnp.ndarray,
         rot: jnp.ndarray):
    """Rotor drag force about the CoM (world frame), zero torque.

    Reference computes body drag = R^T (-c * sum(omega_rot) * v) and applies
    it in the LINK frame, so the net world force is R @ R^T (-c * ...) — kept
    in this composed form for behavioral parity.
    """
    dtype = vel.dtype
    coeff = jnp.asarray(params.drag_coeff, dtype=dtype)
    omega_sum = jnp.sum(2 * jnp.pi * last_rpm / 60.0, axis=-1)    # (...,)
    drag_world_pre = -coeff * omega_sum[..., None] * vel          # (..., 3)
    drag_body = jnp.einsum("...ji,...j->...i", rot, drag_world_pre,
                           precision=HIGHEST)                 # R^T x
    force = jnp.einsum("...ij,...j->...i", rot, drag_body,
                       precision=HIGHEST)                     # R x
    return force, jnp.zeros_like(force)


def downwash(params: DroneParams, pos: jnp.ndarray, rot: jnp.ndarray):
    """Pairwise downwash forces (world frame), zero torque.

    pos: (..., N, 3) over a trailing drone axis.  For receiver n, every drone
    i with dz = z_i - z_n > 0 and horizontal distance dxy < 10 m contributes a
    LINK-frame force [0, 0, -alpha exp(-0.5 (dxy/beta)^2)] => world force
    along -R_n[:, 2].
    """
    dtype = pos.dtype
    z = pos[..., 2]                                               # (..., N)
    dz = z[..., None, :] - z[..., :, None]                        # [n, i] = z_i - z_n
    dxy_vec = pos[..., None, :, :2] - pos[..., :, None, :2]       # (..., n, i, 2)
    dxy = jnp.linalg.norm(dxy_vec, axis=-1)                       # (..., n, i)
    mask = (dz > 0) & (dxy < 10.0)
    safe_dz = jnp.where(mask, dz, 1.0)
    alpha = params.dw_coeff_1 * (params.prop_radius / (4.0 * safe_dz)) ** 2
    beta = params.dw_coeff_2 * safe_dz + params.dw_coeff_3
    mag = alpha * jnp.exp(-0.5 * (dxy / beta) ** 2)               # (..., n, i)
    total = jnp.sum(jnp.where(mask, mag, 0.0), axis=-1)           # (..., n)
    z_axis = rot[..., :, 2]                                       # (..., n, 3)
    force = -total[..., None].astype(dtype) * z_axis
    return force, jnp.zeros_like(force)
