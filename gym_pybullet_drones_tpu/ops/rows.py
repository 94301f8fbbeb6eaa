"""Physics, controller and observation math on per-component row vectors.

The fused env-step kernel (ops/pallas_fused.py) holds every state component
of one drone as a 1-D vector over a block of env lanes.  The functions here
compute one control step on such rows: the DYN motor mix and substeps, the
cascaded DSL-PID tick, and the Euler angles of the observation.  They take
and return plain tuples of arrays, so the same code runs inside a Pallas
kernel and on ordinary jax arrays (the tests compare it with the XLA kernels
of ops/dynamics.py, ops/quat.py and control/dsl_pid.py that way).
"""
from __future__ import annotations

import math

import jax.numpy as jnp
from jax import lax

from gym_pybullet_drones_tpu.control import dsl_pid as C
from gym_pybullet_drones_tpu.params import DroneParams, G
from gym_pybullet_drones_tpu.utils.enums import DroneModel


def quat_rpy_rows(qx, qy, qz, qw):
    """Roll/pitch/yaw rows from (possibly unnormalized) quaternion rows.

    Same math as ops/quat.quat_to_rpy: atan2 is scale-invariant so the
    un-normalized quadratic terms feed it directly; the asin argument is
    normalized by the squared norm.
    """
    n2 = qx * qx + qy * qy + qz * qz + qw * qw
    roll = jnp.arctan2(2.0 * (qw * qx + qy * qz),
                       n2 - 2.0 * (qx * qx + qy * qy))
    pitch = jnp.arcsin(jnp.clip(2.0 * (qw * qy - qz * qx) / n2, -1.0, 1.0))
    yaw = jnp.arctan2(2.0 * (qw * qz + qx * qy),
                      n2 - 2.0 * (qy * qy + qz * qz))
    return roll, pitch, yaw


def _motor_mix(params: DroneParams, r0, r1, r2, r3):
    """Per-motor rpm rows -> (total thrust, x/y/z torques) rows.

    Same arithmetic as ops/dynamics.motor_forces_torques + the DYN torque
    composition (reference BaseAviary.py:838-852).
    """
    kf, km = params.kf, params.km
    f0, f1, f2, f3 = (r * r * kf for r in (r0, r1, r2, r3))
    thrust = f0 + f1 + f2 + f3
    # Torques via factored squared-rpm differences, exactly as the f32 branch
    # of ops/dynamics.motor_forces_torques: (a-b)*(a+b) cancels exactly for
    # bitwise-equal rpms regardless of FMA contraction, so symmetric hovers
    # stay symmetric (the naive sum-of-thrusts form leaves ~1e-10 residuals
    # that the 7e4 attitude gains amplify ~6x per control step).
    dsq = lambda a, b: (a - b) * (a + b)
    km_s = -km if params.model == DroneModel.RACE else km
    z_torque = (dsq(r1, r0) + dsq(r3, r2)) * km_s
    if params.model == DroneModel.CF2P:
        x_torque = dsq(r1, r3) * (kf * params.l)
        y_torque = dsq(r2, r0) * (kf * params.l)
    else:
        karm = kf * params.l / math.sqrt(2)
        x_torque = (dsq(r0, r2) + dsq(r1, r3)) * karm
        y_torque = (dsq(r1, r0) + dsq(r2, r3)) * karm
    return thrust, x_torque, y_torque, z_torque


def _dyn_substeps(params: DroneParams, n_substeps: int, dt: float,
                  state_rows, thrust, x_torque, y_torque, z_torque):
    """Run n explicit-dynamics substeps on row vectors.

    state_rows = (px..pz, qx..qw, vx..vz, wx..wz) (13 rows); returns the 13
    updated rows plus the stored world ang-vel rows (avx, avy, avz).
    Semantics: ops/dynamics.dyn_step (reference BaseAviary.py:815-889).
    """
    jx, jy, jz = params.ixx, params.iyy, params.izz
    inv_jx, inv_jy, inv_jz = 1.0 / jx, 1.0 / jy, 1.0 / jz
    inv_m = 1.0 / params.m
    gm = 9.8 * params.m

    def substep(_, c):
        (px, py, pz, qx, qy, qz, qw, vx, vy, vz, wx, wy, wz) = c[:13]
        # rotation matrix from (normalized) quaternion
        n2 = qx * qx + qy * qy + qz * qz + qw * qw
        inv_n2 = 1.0 / n2
        xx, yy, zz = qx * qx * inv_n2, qy * qy * inv_n2, qz * qz * inv_n2
        xy, xz, yz = qx * qy * inv_n2, qx * qz * inv_n2, qy * qz * inv_n2
        wxq, wyq, wzq = qw * qx * inv_n2, qw * qy * inv_n2, qw * qz * inv_n2
        r00, r01, r02 = 1 - 2 * (yy + zz), 2 * (xy - wzq), 2 * (xz + wyq)
        r10, r11, r12 = 2 * (xy + wzq), 1 - 2 * (xx + zz), 2 * (yz - wxq)
        r20, r21, r22 = 2 * (xz - wyq), 2 * (yz + wxq), 1 - 2 * (xx + yy)

        fx = r02 * thrust
        fy = r12 * thrust
        fz = r22 * thrust - gm
        # tau -= w x (J w)
        tau_x = x_torque - (wy * (jz * wz) - wz * (jy * wy))
        tau_y = y_torque - (wz * (jx * wx) - wx * (jz * wz))
        tau_z = z_torque - (wx * (jy * wy) - wy * (jx * wx))

        vx = vx + dt * fx * inv_m
        vy = vy + dt * fy * inv_m
        vz = vz + dt * fz * inv_m
        wx = wx + dt * tau_x * inv_jx
        wy = wy + dt * tau_y * inv_jy
        wz = wz + dt * tau_z * inv_jz
        px = px + dt * vx
        py = py + dt * vy
        pz = pz + dt * vz

        # exact exponential-map quat update (body rates)
        norm = jnp.sqrt(wx * wx + wy * wy + wz * wz)
        theta = norm * (dt / 2)
        c = jnp.cos(theta)
        safe = jnp.where(norm > 0, norm, 1.0)
        s = jnp.sin(theta) / safe
        nqx = c * qx + s * (wz * qy - wy * qz + wx * qw)
        nqy = c * qy + s * (-wz * qx + wx * qz + wy * qw)
        nqz = c * qz + s * (wy * qx - wx * qy + wz * qw)
        nqw = c * qw + s * (-wx * qx - wy * qy - wz * qz)
        keep = norm <= 1e-8
        qx = jnp.where(keep, qx, nqx)
        qy = jnp.where(keep, qy, nqy)
        qz = jnp.where(keep, qz, nqz)
        qw = jnp.where(keep, qw, nqw)

        # stored world angular velocity: PRE-step rotation, post-step rates
        avx = r00 * wx + r01 * wy + r02 * wz
        avy = r10 * wx + r11 * wy + r12 * wz
        avz = r20 * wx + r21 * wy + r22 * wz
        return (px, py, pz, qx, qy, qz, qw, vx, vy, vz, wx, wy, wz,
                avx, avy, avz)

    # a loop, not an unrolled chain: the kernel's code (and its compile
    # time) stays one substep long
    zero = state_rows[0] * 0.0
    return lax.fori_loop(0, n_substeps, substep,
                         tuple(state_rows[:13]) + (zero, zero, zero))


def _pid_tick(pid_params: DroneParams, ctrl_dt: float, state_rows,
              pid_rows, tgt_rows):
    """One cascaded-PID tick on row vectors.

    state_rows: 10+ rows (px..pz, qx..qw, vx..vz); pid_rows: 9 rows
    (last_rpy, integral_pos_e, integral_rpy_e); tgt_rows: 12 rows
    (target pos/rpy/vel/rpy_rates).  Returns (4 rpm rows, 9 new pid rows).
    """
    px, py, pz = state_rows[0:3]
    qx, qy, qz, qw = state_rows[3:7]
    vx, vy, vz = state_rows[7:10]
    lr_r, lr_p, lr_y = pid_rows[0:3]      # last_rpy
    ip_x, ip_y, ip_z = pid_rows[3:6]      # integral pos error
    ir_x, ir_y, ir_z = pid_rows[6:9]      # integral rpy error
    tp = tgt_rows[0:3]                    # target_pos
    trpy = tgt_rows[3:6]                  # target_rpy
    tv = tgt_rows[6:9]                    # target_vel
    trr = tgt_rows[9:12]                  # target_rpy_rates

    # current rotation matrix from the (normalization-invariant) quat
    n2 = qx * qx + qy * qy + qz * qz + qw * qw
    inv_n2 = 1.0 / n2
    xx, yy, zz = qx * qx * inv_n2, qy * qy * inv_n2, qz * qz * inv_n2
    xy, xz, yz = qx * qy * inv_n2, qx * qz * inv_n2, qy * qz * inv_n2
    wxq, wyq, wzq = qw * qx * inv_n2, qw * qy * inv_n2, qw * qz * inv_n2
    c00, c01, c02 = 1 - 2 * (yy + zz), 2 * (xy - wzq), 2 * (xz + wyq)
    c10, c11, c12 = 2 * (xy + wzq), 1 - 2 * (xx + zz), 2 * (yz - wxq)
    c20, c21, c22 = 2 * (xz - wyq), 2 * (yz + wxq), 1 - 2 * (xx + yy)

    # ---- position loop (control/dsl_pid.py, reference :149-208) ----
    pe = [tp[0] - px, tp[1] - py, tp[2] - pz]
    ve = [tv[0] - vx, tv[1] - vy, tv[2] - vz]
    ip_x = jnp.clip(ip_x + pe[0] * ctrl_dt, -2.0, 2.0)
    ip_y = jnp.clip(ip_y + pe[1] * ctrl_dt, -2.0, 2.0)
    ip_z = jnp.clip(jnp.clip(ip_z + pe[2] * ctrl_dt, -2.0, 2.0),
                    -0.15, 0.15)
    gravity = G * pid_params.m
    tt = [C.P_FOR[i] * pe[i] + C.I_FOR[i] * (ip_x, ip_y, ip_z)[i]
          + C.D_FOR[i] * ve[i] for i in range(3)]
    tt[2] = tt[2] + gravity
    scalar_thrust = jnp.maximum(
        0.0, tt[0] * c02 + tt[1] * c12 + tt[2] * c22)
    thrust_pwm = (jnp.sqrt(scalar_thrust / (4.0 * pid_params.kf))
                  - C.PWM2RPM_CONST) / C.PWM2RPM_SCALE
    tt_norm = jnp.sqrt(tt[0] * tt[0] + tt[1] * tt[1] + tt[2] * tt[2])
    zax = [t / tt_norm for t in tt]
    cyaw, syaw = jnp.cos(trpy[2]), jnp.sin(trpy[2])
    # y_ax = normalize(z_ax x x_c), x_c = [cos yaw, sin yaw, 0]
    zxc = [-zax[2] * syaw, zax[2] * cyaw, zax[0] * syaw - zax[1] * cyaw]
    zxc_n = jnp.sqrt(zxc[0] * zxc[0] + zxc[1] * zxc[1] + zxc[2] * zxc[2])
    yax = [v / zxc_n for v in zxc]
    xax = [yax[1] * zax[2] - yax[2] * zax[1],
           yax[2] * zax[0] - yax[0] * zax[2],
           yax[0] * zax[1] - yax[1] * zax[0]]
    # target rotation columns are (x_ax, y_ax, z_ax); intrinsic-XYZ Euler
    # (ops/quat.mat_to_euler_xyz): b = asin(m02), a = atan2(-m12, m22),
    # c = atan2(-m01, m00)
    ea = jnp.arctan2(-zax[1], zax[2])
    eb = jnp.arcsin(jnp.clip(zax[0], -1.0, 1.0))
    ec = jnp.arctan2(-yax[0], xax[0])

    # ---- attitude loop (reference :212-259) ----
    # cur_rpy (ops/quat.quat_to_rpy; atan2 is scale-invariant so the
    # un-normalized quadratic terms can be used directly)
    cr = jnp.arctan2(2.0 * (qw * qx + qy * qz), n2 - 2.0 * (qx * qx + qy * qy))
    cp = jnp.arcsin(jnp.clip(2.0 * (qw * qy - qz * qx) * inv_n2, -1.0, 1.0))
    cy_ = jnp.arctan2(2.0 * (qw * qz + qx * qy), n2 - 2.0 * (qy * qy + qz * qz))
    # R(target_euler) = Rx(ea) @ Ry(eb) @ Rz(ec)
    ca, sa = jnp.cos(ea), jnp.sin(ea)
    cb, sb = jnp.cos(eb), jnp.sin(eb)
    cc, sc = jnp.cos(ec), jnp.sin(ec)
    t00, t01, t02 = cb * cc, -cb * sc, sb
    t10, t11, t12 = ca * sc + sa * sb * cc, ca * cc - sa * sb * sc, -sa * cb
    t20, t21, t22 = sa * sc - ca * sb * cc, sa * cc + ca * sb * sc, ca * cb
    # rot_matrix_e = Rt^T Rc - Rc^T Rt = E - E^T with E = Rt^T Rc
    e21 = t02 * c01 + t12 * c11 + t22 * c21
    e12 = t01 * c02 + t11 * c12 + t21 * c22
    e02 = t00 * c02 + t10 * c12 + t20 * c22
    e20 = t02 * c00 + t12 * c10 + t22 * c20
    e10 = t01 * c00 + t11 * c10 + t21 * c20
    e01 = t00 * c01 + t10 * c11 + t20 * c21
    rot_e = [e21 - e12, e02 - e20, e10 - e01]
    rre = [trr[0] - (cr - lr_r) / ctrl_dt,
           trr[1] - (cp - lr_p) / ctrl_dt,
           trr[2] - (cy_ - lr_y) / ctrl_dt]
    ir_x = jnp.clip(jnp.clip(ir_x - rot_e[0] * ctrl_dt, -1500.0, 1500.0),
                    -1.0, 1.0)
    ir_y = jnp.clip(jnp.clip(ir_y - rot_e[1] * ctrl_dt, -1500.0, 1500.0),
                    -1.0, 1.0)
    ir_z = jnp.clip(ir_z - rot_e[2] * ctrl_dt, -1500.0, 1500.0)
    ir = (ir_x, ir_y, ir_z)
    tq = [jnp.clip(-C.P_TOR[i] * rot_e[i] + C.D_TOR[i] * rre[i]
                   + C.I_TOR[i] * ir[i], -3200.0, 3200.0)
          for i in range(3)]
    mixer = (C.MIXER_CF2P if pid_params.model == DroneModel.CF2P
             else C.MIXER_CF2X)
    rpm_rows = []
    for m in mixer:
        pwm = thrust_pwm + m[0] * tq[0] + m[1] * tq[1] + m[2] * tq[2]
        pwm = jnp.clip(pwm, C.MIN_PWM, C.MAX_PWM)
        rpm_rows.append(C.PWM2RPM_SCALE * pwm + C.PWM2RPM_CONST)
    return rpm_rows, (cr, cp, cy_, ip_x, ip_y, ip_z, ir_x, ir_y, ir_z)
