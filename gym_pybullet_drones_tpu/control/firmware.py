"""Crazyflie firmware-grade components as jittable JAX functions.

TPU-native reimplementation of the pycffirmware surface consumed by the
reference CFAviary (reference envs/CFAviary.py:127-180,293-301,368-420,
613-652; SURVEY.md §2.3): the 2-pole low-pass sensor filters (`lpf2p*`), the
Mellinger trajectory-tracking controller (`controllerMellinger`), the brushed
motor PWM curve and X-formation power distribution.  Algorithms follow the
published crazyflie-firmware sources (filter.c, controller_mellinger.c,
power_distribution_stock.c); everything is expressed as pure functions with
explicit state so controllers can run batched on device as well as in the
firmware-in-the-loop host environment.

Units follow the firmware conventions: sensor gyro in deg/s, accelerometer
in g, state attitude in degrees (with the legacy inverted pitch), thrust in
the 16-bit PWM-scale units of control_t.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import jax.numpy as jnp
from jax.lax import Precision

RAD2DEG = 180.0 / math.pi
DEG2RAD = math.pi / 180.0
GRAVITY_MAGNITUDE = 9.81
VEHICLE_MASS = 0.032
MASS_THRUST = 132000.0

# Mellinger gains (controller_mellinger.c defaults)
KP_XY, KD_XY, KI_XY, I_RANGE_XY = 0.4, 0.2, 0.05, 2.0
KP_Z, KD_Z, KI_Z, I_RANGE_Z = 1.25, 0.4, 0.05, 0.4
KR_XY, KW_XY, KI_M_XY, I_RANGE_M_XY = 70000.0, 20000.0, 0.0, 1.0
KR_Z, KW_Z, KI_M_Z, I_RANGE_M_Z = 60000.0, 12000.0, 500.0, 1500.0
KD_OMEGA_RP = 200.0

MIN_PWM, MAX_PWM = 20000.0, 65535.0
SUPPLY_VOLTAGE = 3.0


# ---------------------------------------------------------------------------
# 2-pole Butterworth low-pass (firmware filter.c lpf2pInit/lpf2pApply)
# ---------------------------------------------------------------------------

# controller contractions run in full float32 on every backend (the GPU's
# default would allow TF32 for float32 dots)
HIGHEST = Precision.HIGHEST


class Lpf2pState(NamedTuple):
    d1: jnp.ndarray
    d2: jnp.ndarray


def lpf2p_coeffs(sample_freq: float, cutoff_freq: float):
    """Biquad coefficients, matching firmware lpf2pSetCutoffFreq."""
    fr = sample_freq / cutoff_freq
    ohm = math.tan(math.pi / fr)
    c = 1.0 + 2.0 * math.cos(math.pi / 4.0) * ohm + ohm * ohm
    b0 = ohm * ohm / c
    b1 = 2.0 * b0
    b2 = b0
    a1 = 2.0 * (ohm * ohm - 1.0) / c
    a2 = (1.0 - 2.0 * math.cos(math.pi / 4.0) * ohm + ohm * ohm) / c
    return b0, b1, b2, a1, a2


def lpf2p_init(shape=(), dtype=jnp.float32) -> Lpf2pState:
    z = jnp.zeros(shape, dtype)
    return Lpf2pState(d1=z, d2=z)


def lpf2p_apply(coeffs, state: Lpf2pState, sample: jnp.ndarray):
    """Direct-form-II application; returns (filtered, new_state)."""
    b0, b1, b2, a1, a2 = coeffs
    d0 = sample - state.d1 * a1 - state.d2 * a2
    out = d0 * b0 + state.d1 * b1 + state.d2 * b2
    return out, Lpf2pState(d1=d0, d2=state.d1)


# ---------------------------------------------------------------------------
# Setpoint / control structures (firmware stabilizer_types.h equivalents)
# ---------------------------------------------------------------------------
class Setpoint(NamedTuple):
    """Subset of setpoint_t used by the Mellinger controller.

    position/velocity/acceleration in m-based units, attitude_rate in deg/s,
    quat xyzw; `position_mode` True == modeAbs on x/y/z.
    """

    position: jnp.ndarray       # (3,)
    velocity: jnp.ndarray       # (3,)
    acceleration: jnp.ndarray   # (3,)
    attitude_rate: jnp.ndarray  # (3,) deg/s (roll, pitch, yaw)
    quat: jnp.ndarray           # (4,) xyzw desired attitude


class FirmwareState(NamedTuple):
    """Carried Mellinger controller scratch (integrals + gyro memory)."""

    i_error_pos: jnp.ndarray    # (3,) position integral
    i_error_m: jnp.ndarray      # (3,) attitude-moment integral
    prev_omega: jnp.ndarray     # (2,) previous roll/pitch gyro (rad/s)


def firmware_init(dtype=jnp.float32) -> FirmwareState:
    return FirmwareState(i_error_pos=jnp.zeros(3, dtype),
                         i_error_m=jnp.zeros(3, dtype),
                         prev_omega=jnp.zeros(2, dtype))


def mellinger_control(state: FirmwareState, setpoint: Setpoint,
                      pos, vel, quat, gyro_deg, dt: float):
    """One Mellinger tick -> (control(thrust, roll, pitch, yaw), new_state).

    pos/vel: world m, m/s; quat: state attitude xyzw; gyro_deg: deg/s body.
    Output units match control_t (16-bit thrust scale, moment counts).
    """
    from gym_pybullet_drones_tpu.ops import quat as quat_ops

    dtype = pos.dtype
    r_error = setpoint.position - pos
    v_error = setpoint.velocity - vel
    i_pos = state.i_error_pos + r_error * dt
    i_pos = jnp.clip(
        i_pos,
        jnp.asarray([-I_RANGE_XY, -I_RANGE_XY, -I_RANGE_Z], dtype),
        jnp.asarray([I_RANGE_XY, I_RANGE_XY, I_RANGE_Z], dtype))

    kp = jnp.asarray([KP_XY, KP_XY, KP_Z], dtype)
    kd = jnp.asarray([KD_XY, KD_XY, KD_Z], dtype)
    ki = jnp.asarray([KI_XY, KI_XY, KI_Z], dtype)
    gravity_comp = jnp.asarray([0.0, 0.0, GRAVITY_MAGNITUDE], dtype)
    target_thrust = (VEHICLE_MASS * (setpoint.acceleration + gravity_comp)
                     + kp * r_error + kd * v_error + ki * i_pos)

    # desired yaw from the setpoint quaternion (modeAbs quat path)
    sp_rpy = quat_ops.quat_to_rpy(setpoint.quat)
    desired_yaw = sp_rpy[..., 2]

    R = quat_ops.quat_to_mat(quat)
    z_axis = R[..., :, 2]
    current_thrust = jnp.sum(target_thrust * z_axis, axis=-1)
    z_des = target_thrust / jnp.linalg.norm(
        target_thrust, axis=-1, keepdims=True)
    x_c = jnp.stack([jnp.cos(desired_yaw), jnp.sin(desired_yaw),
                     jnp.zeros_like(desired_yaw)], axis=-1)
    y_des = jnp.cross(z_des, x_c)
    y_des = y_des / jnp.linalg.norm(y_des, axis=-1, keepdims=True)
    x_des = jnp.cross(y_des, z_des)
    R_des = jnp.stack([x_des, y_des, z_des], axis=-1)

    eRM = (jnp.einsum("...ji,...jk->...ik", R_des, R, precision=HIGHEST)
           - jnp.einsum("...ji,...jk->...ik", R, R_des, precision=HIGHEST))
    # vee with the firmware's legacy pitch sign flip
    eR = jnp.stack([eRM[..., 2, 1], -eRM[..., 0, 2], eRM[..., 1, 0]],
                   axis=-1) * 0.5

    gyro_rad = gyro_deg * DEG2RAD
    sp_rate_rad = setpoint.attitude_rate * DEG2RAD
    # pitch uses the legacy inverted convention end-to-end (matching the
    # eR.y sign flip above and the power-distribution mixing): its rate
    # error is (gyro - setpoint) where roll/yaw use (setpoint - gyro).
    ew = jnp.stack([
        sp_rate_rad[..., 0] - gyro_rad[..., 0],
        gyro_rad[..., 1] - sp_rate_rad[..., 1],
        sp_rate_rad[..., 2] - gyro_rad[..., 2]], axis=-1)

    err_d_roll = -(gyro_rad[..., 0] - state.prev_omega[..., 0]) / dt
    err_d_pitch = (gyro_rad[..., 1] - state.prev_omega[..., 1]) / dt
    prev_omega = jnp.stack([gyro_rad[..., 0], gyro_rad[..., 1]], axis=-1)

    i_m = state.i_error_m + (-eR) * dt
    i_m = jnp.clip(
        i_m,
        jnp.asarray([-I_RANGE_M_XY, -I_RANGE_M_XY, -I_RANGE_M_Z], dtype),
        jnp.asarray([I_RANGE_M_XY, I_RANGE_M_XY, I_RANGE_M_Z], dtype))

    mx = (-KR_XY * eR[..., 0] + KW_XY * ew[..., 0]
          + KI_M_XY * i_m[..., 0] + KD_OMEGA_RP * err_d_roll)
    my = (-KR_XY * eR[..., 1] + KW_XY * ew[..., 1]
          + KI_M_XY * i_m[..., 1] + KD_OMEGA_RP * err_d_pitch)
    mz = -KR_Z * eR[..., 2] + KW_Z * ew[..., 2] + KI_M_Z * i_m[..., 2]

    thrust = MASS_THRUST * current_thrust
    active = thrust > 0
    roll = jnp.where(active, jnp.clip(mx, -32000, 32000), 0.0)
    pitch = jnp.where(active, jnp.clip(my, -32000, 32000), 0.0)
    yaw = jnp.where(active, jnp.clip(-mz, -32000, 32000), 0.0)
    # reset integrals when the thrust command is non-positive
    i_pos = jnp.where(active, i_pos, 0.0)
    i_m = jnp.where(active, i_m, 0.0)

    control = jnp.stack([thrust, roll, pitch, yaw], axis=-1)
    return control, FirmwareState(i_error_pos=i_pos, i_error_m=i_m,
                                  prev_omega=prev_omega)


# ---------------------------------------------------------------------------
# Power distribution + brushed motor model (reference CFAviary.py:613-652)
# ---------------------------------------------------------------------------
def motors_get_pwm(thrust):
    """Brushed motor thrust->PWM curve (reference CFAviary.py:615-624)."""
    thrust = thrust / 65536.0 * 60.0
    volts = -0.0006239 * thrust * thrust + 0.088 * thrust
    percentage = jnp.minimum(1.0, volts / SUPPLY_VOLTAGE)
    return percentage * MAX_PWM


def power_distribution(control, quad_formation_x: bool = True):
    """control (thrust, roll, pitch, yaw) -> 4 motor PWMs.

    X-formation mixing per reference CFAviary._powerDistribution (:633-652).
    """
    thrust, roll, pitch, yaw = (control[..., i] for i in range(4))
    if quad_formation_x:
        r = roll / 2.0
        p = pitch / 2.0
        m = jnp.stack([thrust - r + p + yaw,
                       thrust - r - p - yaw,
                       thrust + r - p + yaw,
                       thrust + r + p - yaw], axis=-1)
    else:
        m = jnp.stack([thrust + pitch + yaw,
                       thrust - roll - yaw,
                       thrust - pitch + yaw,
                       thrust + roll - yaw], axis=-1)
    m = jnp.clip(m, 0.0, MAX_PWM)
    return motors_get_pwm(m)
