"""DSL cascaded PID controller (Crazyflie) as a pure, batchable JAX function.

Behavioral parity target: reference
/root/reference/gym_pybullet_drones/control/DSLPIDControl.py — gains and
constants from :37-60, position loop from :149-208, attitude loop from
:212-259.  Controller scratch (`last_rpy`, `integral_pos_e`,
`integral_rpy_e`; reference :65-78) is an explicit carried pytree instead of
object attributes, so the controller fuses into the jitted env step and vmaps
across drones/envs — the TPU-native replacement of the reference's
one-Python-object-per-drone pattern (reference BaseRLAviary.py:73-78).

Note on the reference's euler->quat->matrix round-trip (:242-244): it unpacks
scipy's xyzw as_quat() into variables named (w, x, y, z) and feeds the SAME
list back to from_quat — the permutation is a no-op, so the target rotation
is simply R(target_euler); this implementation computes it directly.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import jax.numpy as jnp
from jax.lax import Precision

from gym_pybullet_drones_tpu.params import DroneParams, G
from gym_pybullet_drones_tpu.utils.enums import DroneModel
from gym_pybullet_drones_tpu.ops import quat as quat_ops

# Gains and PWM constants (reference DSLPIDControl.py:37-46)
P_FOR = (0.4, 0.4, 1.25)
I_FOR = (0.05, 0.05, 0.05)
D_FOR = (0.2, 0.2, 0.5)
P_TOR = (70000.0, 70000.0, 60000.0)
I_TOR = (0.0, 0.0, 500.0)
D_TOR = (20000.0, 20000.0, 12000.0)
PWM2RPM_SCALE = 0.2685
PWM2RPM_CONST = 4070.3
MIN_PWM = 20000.0
MAX_PWM = 65535.0

# Motor mixers (reference DSLPIDControl.py:47-60)
MIXER_CF2X = (
    (-0.5, -0.5, -1.0),
    (-0.5, 0.5, 1.0),
    (0.5, 0.5, -1.0),
    (0.5, -0.5, 1.0),
)
MIXER_CF2P = (
    (0.0, -1.0, -1.0),
    (1.0, 0.0, 1.0),
    (0.0, 1.0, -1.0),
    (-1.0, 0.0, 1.0),
)

# controller contractions run in full float32 on every backend (the GPU's
# default would allow TF32 for float32 dots)
HIGHEST = Precision.HIGHEST


class PIDState(NamedTuple):
    """Carried controller scratch, broadcastable over (..., 3) leading dims."""

    last_rpy: jnp.ndarray         # (..., 3)
    integral_pos_e: jnp.ndarray   # (..., 3)
    integral_rpy_e: jnp.ndarray   # (..., 3)


def init_state(batch_shape: tuple[int, ...] = (),
               dtype=jnp.float32) -> PIDState:
    """Zero controller state (reference DSLPIDControl.reset, :65-78)."""
    z = jnp.zeros(batch_shape + (3,), dtype)
    return PIDState(last_rpy=z, integral_pos_e=z, integral_rpy_e=z)


def compute_control(params: DroneParams, state: PIDState, dt: float,
                    cur_pos: jnp.ndarray, cur_quat: jnp.ndarray,
                    cur_vel: jnp.ndarray, target_pos: jnp.ndarray,
                    target_rpy: jnp.ndarray | None = None,
                    target_vel: jnp.ndarray | None = None,
                    target_rpy_rates: jnp.ndarray | None = None,
                    gains: dict | None = None, g: float = G):
    """One PID tick: state + setpoints -> (rpm, new_state, pos_e, yaw_e).

    All array arguments broadcast over leading batch dims.  `cur_ang_vel` of
    the reference signature is unused there (DSLPIDControl.py:96) and dropped.
    """
    dtype = cur_pos.dtype
    if target_rpy is None:
        target_rpy = jnp.zeros_like(cur_pos)
    if target_vel is None:
        target_vel = jnp.zeros_like(cur_vel)
    if target_rpy_rates is None:
        target_rpy_rates = jnp.zeros_like(cur_pos)

    gains = gains or {}
    g_or = lambda key, default: default if gains.get(key) is None \
        else tuple(gains[key])
    p_for, i_for, d_for = (g_or("p_for", P_FOR), g_or("i_for", I_FOR),
                           g_or("d_for", D_FOR))
    p_tor, i_tor, d_tor = (g_or("p_tor", P_TOR), g_or("i_tor", I_TOR),
                           g_or("d_tor", D_TOR))
    gravity = g * params.m  # reference BaseControl.py:36-41 (g * URDF mass)
    cur_rotation = quat_ops.quat_to_mat(cur_quat)              # (..., 3, 3)

    # ---- Position loop (reference :149-208) ----
    pos_e = target_pos - cur_pos
    vel_e = target_vel - cur_vel
    integral_pos_e = state.integral_pos_e + pos_e * dt
    integral_pos_e = jnp.clip(integral_pos_e, -2.0, 2.0)
    integral_pos_e = integral_pos_e.at[..., 2].set(
        jnp.clip(integral_pos_e[..., 2], -0.15, 0.15))
    target_thrust = (jnp.asarray(p_for, dtype) * pos_e
                     + jnp.asarray(i_for, dtype) * integral_pos_e
                     + jnp.asarray(d_for, dtype) * vel_e)
    target_thrust = target_thrust.at[..., 2].add(gravity)
    scalar_thrust = jnp.maximum(
        0.0, jnp.sum(target_thrust * cur_rotation[..., :, 2], axis=-1))
    thrust = (jnp.sqrt(scalar_thrust / (4 * params.kf))
              - PWM2RPM_CONST) / PWM2RPM_SCALE                 # (...,)
    target_z_ax = target_thrust / jnp.linalg.norm(
        target_thrust, axis=-1, keepdims=True)
    yaw = target_rpy[..., 2]
    target_x_c = jnp.stack(
        [jnp.cos(yaw), jnp.sin(yaw), jnp.zeros_like(yaw)], axis=-1)
    zxc = jnp.cross(target_z_ax, target_x_c)
    target_y_ax = zxc / jnp.linalg.norm(zxc, axis=-1, keepdims=True)
    target_x_ax = jnp.cross(target_y_ax, target_z_ax)
    # columns are the target axes
    target_rotation = jnp.stack(
        [target_x_ax, target_y_ax, target_z_ax], axis=-1)      # (..., 3, 3)
    target_euler = quat_ops.mat_to_euler_xyz(target_rotation)

    # ---- Attitude loop (reference :212-259) ----
    cur_rpy = quat_ops.quat_to_rpy(cur_quat)
    # R(target_euler) via the euler->quat->matrix round-trip (see module doc)
    target_rotation_att = quat_ops.quat_to_mat(
        quat_ops.euler_xyz_to_quat(target_euler))
    rot_matrix_e = (
        jnp.einsum("...ji,...jk->...ik", target_rotation_att, cur_rotation,
                   precision=HIGHEST)
        - jnp.einsum("...ji,...jk->...ik", cur_rotation, target_rotation_att,
                     precision=HIGHEST))
    rot_e = jnp.stack(
        [rot_matrix_e[..., 2, 1], rot_matrix_e[..., 0, 2],
         rot_matrix_e[..., 1, 0]], axis=-1)
    rpy_rates_e = target_rpy_rates - (cur_rpy - state.last_rpy) / dt
    integral_rpy_e = state.integral_rpy_e - rot_e * dt
    integral_rpy_e = jnp.clip(integral_rpy_e, -1500.0, 1500.0)
    integral_rpy_e = integral_rpy_e.at[..., :2].set(
        jnp.clip(integral_rpy_e[..., :2], -1.0, 1.0))
    target_torques = (-jnp.asarray(p_tor, dtype) * rot_e
                      + jnp.asarray(d_tor, dtype) * rpy_rates_e
                      + jnp.asarray(i_tor, dtype) * integral_rpy_e)
    target_torques = jnp.clip(target_torques, -3200.0, 3200.0)
    mixer = jnp.asarray(
        MIXER_CF2P if params.model == DroneModel.CF2P else MIXER_CF2X, dtype)
    pwm = thrust[..., None] + jnp.einsum("mt,...t->...m", mixer,
                                         target_torques, precision=HIGHEST)
    pwm = jnp.clip(pwm, MIN_PWM, MAX_PWM)
    rpm = PWM2RPM_SCALE * pwm + PWM2RPM_CONST

    new_state = PIDState(last_rpy=cur_rpy, integral_pos_e=integral_pos_e,
                         integral_rpy_e=integral_rpy_e)
    yaw_e = target_euler[..., 2] - cur_rpy[..., 2]
    return rpm, new_state, pos_e, yaw_e


def compute_control_from_state(params: DroneParams, state: PIDState,
                               dt: float, drone_state: jnp.ndarray,
                               target_pos: jnp.ndarray,
                               target_rpy: jnp.ndarray | None = None,
                               target_vel: jnp.ndarray | None = None,
                               target_rpy_rates: jnp.ndarray | None = None):
    """Slice the 20-dim state vector (reference BaseControl.py:55-93)."""
    return compute_control(
        params, state, dt,
        cur_pos=drone_state[..., 0:3],
        cur_quat=drone_state[..., 3:7],
        cur_vel=drone_state[..., 10:13],
        target_pos=target_pos, target_rpy=target_rpy, target_vel=target_vel,
        target_rpy_rates=target_rpy_rates)


def one23d_interface(params: DroneParams, thrust: jnp.ndarray) -> jnp.ndarray:
    """1/2/4-dim thrust input -> 4 PWMs (reference DSLPIDControl.py:263-287)."""
    thrust = jnp.atleast_1d(thrust)
    dim = thrust.shape[-1]
    pwm = jnp.clip(
        (jnp.sqrt(thrust / (params.kf * (4 / dim))) - PWM2RPM_CONST)
        / PWM2RPM_SCALE, MIN_PWM, MAX_PWM)
    if dim in (1, 4):
        return jnp.repeat(pwm, 4 // dim, axis=-1)
    if dim == 2:
        return jnp.concatenate([pwm, jnp.flip(pwm, axis=-1)], axis=-1)
    raise ValueError("thrust input must have length 1, 2, or 4")


class DSLPIDControl:
    """Stateful convenience wrapper mirroring the reference class API.

    Holds a PIDState and exposes computeControl / computeControlFromState /
    reset with the reference's signatures (DSLPIDControl.py:19-145) for
    drop-in use in example scripts; the functional core above is what the
    batched env paths use.
    """

    def __init__(self, drone_model: DroneModel = DroneModel.CF2X,
                 g: float = 9.8, dtype=jnp.float64):
        from gym_pybullet_drones_tpu.params import get_params
        if drone_model not in (DroneModel.CF2X, DroneModel.CF2P):
            raise ValueError(
                "DSLPIDControl requires DroneModel.CF2X or DroneModel.CF2P")
        self.params = get_params(drone_model)
        self.g = float(g)
        self.dtype = dtype
        self.control_counter = 0
        self._gains = {}
        self.reset()

    def reset(self):
        self.control_counter = 0
        self.state = init_state((), self.dtype)

    def setPIDCoefficients(self, p_coeff_pos=None, i_coeff_pos=None,
                           d_coeff_pos=None, p_coeff_att=None,
                           i_coeff_att=None, d_coeff_att=None):
        """Override gains (reference BaseControl.setPIDCoefficients:138-177).

        Sets instance-level gain overrides consumed by computeControl via
        the functional core's gain arguments.
        """
        import numpy as np
        self._gains = {
            "p_for": None if p_coeff_pos is None else np.asarray(p_coeff_pos),
            "i_for": None if i_coeff_pos is None else np.asarray(i_coeff_pos),
            "d_for": None if d_coeff_pos is None else np.asarray(d_coeff_pos),
            "p_tor": None if p_coeff_att is None else np.asarray(p_coeff_att),
            "i_tor": None if i_coeff_att is None else np.asarray(i_coeff_att),
            "d_tor": None if d_coeff_att is None else np.asarray(d_coeff_att),
        }

    def computeControl(self, control_timestep, cur_pos, cur_quat, cur_vel,
                       cur_ang_vel=None, target_pos=None,
                       target_rpy=None, target_vel=None,
                       target_rpy_rates=None):
        self.control_counter += 1
        as_arr = lambda x: None if x is None else jnp.asarray(x, self.dtype)
        rpm, self.state, pos_e, yaw_e = compute_control(
            self.params, self.state, float(control_timestep),
            as_arr(cur_pos), as_arr(cur_quat), as_arr(cur_vel),
            as_arr(target_pos), as_arr(target_rpy), as_arr(target_vel),
            as_arr(target_rpy_rates), gains=self._gains, g=self.g)
        return rpm, pos_e, yaw_e

    def computeControlFromState(self, control_timestep, state, target_pos,
                                target_rpy=None, target_vel=None,
                                target_rpy_rates=None):
        state = jnp.asarray(state, self.dtype)
        return self.computeControl(
            control_timestep,
            cur_pos=state[0:3], cur_quat=state[3:7], cur_vel=state[10:13],
            cur_ang_vel=state[13:16], target_pos=target_pos,
            target_rpy=target_rpy, target_vel=target_vel,
            target_rpy_rates=target_rpy_rates)
