"""Explicit quadrotor rigid-body dynamics (the DYN physics mode).

This is the bit-parity target kernel: it reproduces, with identical arithmetic
ordering, the explicit integrator of the reference engine
(/root/reference/gym_pybullet_drones/envs/BaseAviary.py:815-889, `_dynamics` +
`_integrateQ`):

    thrust_world = R @ [0, 0, sum(kf * rpm^2)]
    force_world  = thrust_world - [0, 0, g*m]
    torques      = mixer(kf*rpm^2, km*rpm^2) - w x (J w)   (w ~ rpy_rates)
    vel       += dt * force_world / m           (explicit)
    rpy_rates += dt * J^-1 torques              (explicit)
    pos       += dt * vel                       (semi-implicit in position)
    quat       = exp-map integration of (quat, new rpy_rates)
    ang_v_world (stored) = R_old @ rpy_rates_new

Unlike the reference — which loops this per drone in Python and round-trips
state through PyBullet's C API — the kernel is a pure function over arrays
with arbitrary leading batch dimensions (envs x drones), so one fused XLA
program advances the whole fleet.  Scalar parameters enter as weakly-typed
Python floats and therefore preserve the working dtype (float32 for
throughput, float64 for the parity harness).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import jax.numpy as jnp
from jax.lax import Precision

from gym_pybullet_drones_tpu.params import DroneParams
from gym_pybullet_drones_tpu.utils.enums import DroneModel
from gym_pybullet_drones_tpu.ops import quat as quat_ops

# physics contractions run in full float32 on every backend (the GPU's
# default would allow TF32 for float32 dots)
HIGHEST = Precision.HIGHEST


class DynState(NamedTuple):
    """Carried state of the explicit integrator (leading dims broadcast)."""

    pos: jnp.ndarray        # (..., 3) world position
    quat: jnp.ndarray       # (..., 4) xyzw orientation
    vel: jnp.ndarray        # (..., 3) world linear velocity
    rpy_rates: jnp.ndarray  # (..., 3) body roll/pitch/yaw rates (DYN-mode carry)
    ang_v: jnp.ndarray      # (..., 3) world angular velocity (stored, not used)


def motor_forces_torques(params: DroneParams, rpm: jnp.ndarray):
    """Per-motor thrusts and the aggregate body torques.

    Mixer parity: reference BaseAviary.py:838-852 (incl. the RACE z-torque
    negation at :843-845 and the CF2X/CF2P arm geometry split at :846-851).

    Two formulations, selected by dtype:

    - float64 (the parity-oracle path): left-to-right sums matching the
      reference's NumPy arithmetic order exactly, for bitwise-trackable
      rollout comparisons against the executed reference.
    - float32 (the production path): each mixer component is computed as a
      sum of FACTORED squared-rpm differences, e.g.
      ``x = ((r0-r2)(r0+r2) + (r1-r3)(r1+r3)) * (kf*arm)``.  The naive
      ``(f0+f1-f2-f3)*arm`` form is algebraically identical, but compiled
      XLA rematerializes ``kf*rpm^2`` into each consumer fusion with FMA
      contraction (excess precision), so the "same" f_i rounds differently
      per use and the cancellation of equal thrusts leaves ~1e-10 torque
      residuals.  Under the 7e4 attitude PID gains those residuals grow
      ~6x per control step (measured against a float64 rollout — a
      symmetric hover diverged to 2.5e-3 obs error in 6 control steps,
      tests/test_fused.py history).  The factored form cancels exactly for
      bitwise-equal rpms in ANY contraction scheme (a-a==0 is exact) and
      is also ~4x closer to the float64 truth on random rpms (1.7e-10 vs
      6.2e-10 max error at hover scale).
    """
    forces = rpm * rpm * params.kf                     # (..., 4)
    z_torques = rpm * rpm * params.km
    if params.model == DroneModel.RACE:
        z_torques = -z_torques
    if rpm.dtype == jnp.float64:
        f0, f1, f2, f3 = (forces[..., i] for i in range(4))
        t0, t1, t2, t3 = (z_torques[..., i] for i in range(4))
        z_torque = -t0 + t1 - t2 + t3
        if params.model == DroneModel.CF2P:
            x_torque = (f1 - f3) * params.l
            y_torque = (-f0 + f2) * params.l
        else:  # CF2X and RACE
            arm = params.l / math.sqrt(2)
            x_torque = (f0 + f1 - f2 - f3) * arm
            y_torque = (-f0 + f1 + f2 - f3) * arm
    else:
        r0, r1, r2, r3 = (rpm[..., i] for i in range(4))
        dsq = lambda a, b: (a - b) * (a + b)           # a^2 - b^2, exact at a==b
        km_s = -params.km if params.model == DroneModel.RACE else params.km
        z_torque = (dsq(r1, r0) + dsq(r3, r2)) * km_s
        if params.model == DroneModel.CF2P:
            x_torque = dsq(r1, r3) * (params.kf * params.l)
            y_torque = dsq(r2, r0) * (params.kf * params.l)
        else:  # CF2X and RACE
            karm = params.kf * params.l / math.sqrt(2)
            x_torque = (dsq(r0, r2) + dsq(r1, r3)) * karm
            y_torque = (dsq(r1, r0) + dsq(r2, r3)) * karm
    torques = jnp.stack([x_torque, y_torque, z_torque], axis=-1)
    return forces, torques


def dyn_step(params: DroneParams, state: DynState, rpm: jnp.ndarray,
             dt: float) -> DynState:
    """One explicit-dynamics substep at the physics rate (PYB_TIMESTEP).

    Pure-function equivalent of reference BaseAviary._dynamics
    (BaseAviary.py:815-874) over batched state.
    """
    rotation = quat_ops.quat_to_mat(state.quat)        # (..., 3, 3)
    forces, torques = motor_forces_torques(params, rpm)
    total_thrust = jnp.sum(forces, axis=-1)            # (...,)
    # R @ [0,0,T] == T * R[:, 2] exactly (zero columns drop out bitwise)
    thrust_world = rotation[..., :, 2] * total_thrust[..., None]
    gravity_vec = jnp.zeros_like(thrust_world).at[..., 2].set(params.gravity)
    force_world = thrust_world - gravity_vec

    # Euler's equation: tau -= w x (J w), J diagonal (BaseAviary.py:853)
    w = state.rpy_rates
    j_diag = jnp.asarray([params.ixx, params.iyy, params.izz], dtype=w.dtype)
    torques = torques - jnp.cross(w, j_diag * w)
    # Multiply by the precomputed reciprocal diagonal (not a division): the
    # reference uses np.dot(J_INV, torques) with J_INV = inv(diag(J)), whose
    # entries are the double-precision reciprocals — multiplication keeps
    # bitwise parity where torques / j_diag would not.
    j_inv_diag = jnp.asarray(
        [1.0 / params.ixx, 1.0 / params.iyy, 1.0 / params.izz], dtype=w.dtype)
    rpy_rates_deriv = torques * j_inv_diag

    acc = force_world / params.m
    vel = state.vel + dt * acc
    rpy_rates = w + dt * rpy_rates_deriv
    pos = state.pos + dt * vel
    new_quat = quat_ops.integrate_quat(state.quat, rpy_rates, dt)
    # Stored world angular velocity uses the PRE-step rotation (reference
    # BaseAviary.py:868-872 reuses `rotation` computed from the old quat).
    ang_v = jnp.einsum("...ij,...j->...i", rotation, rpy_rates,
                       precision=HIGHEST)
    return DynState(pos=pos, quat=new_quat, vel=vel, rpy_rates=rpy_rates,
                    ang_v=ang_v)
