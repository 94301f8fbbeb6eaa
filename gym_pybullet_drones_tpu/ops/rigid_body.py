"""Bullet-style rigid-body integrator with impulse-based contact (PYB mode).

TPU-native stand-in for the Bullet C++ engine the reference drives through
`p.stepSimulation` (reference BaseAviary.py:369-370).  Scope per SURVEY.md §7.4
/ BASELINE.json: exact Bullet bit-parity is NOT the target (that is reserved
for the explicit-dynamics mode in ops/dynamics.py); this stepper follows
Bullet's *documented* discrete algorithm so that PYB* trajectories track real
Bullet with quantified (not just qualitative) error:

- external prop forces applied at prop link positions (LINK frame semantics of
  p.applyExternalForce, reference BaseAviary.py:679-711) => world force
  R @ f and torque (R @ offset) x (R @ f) about the CoM,
- velocity update with gravity AND the gyroscopic bias term
  w_b x (J w_b) (btMultiBody's Featherstone dynamics includes
  Coriolis/centrifugal bias forces; PyBullet's loadURDF creates a
  btMultiBody),
- Bullet-style velocity damping v *= (1-d)^dt with PyBullet's URDF default
  d = 0.04 (linear and angular; the reference leaves the defaults in place,
  see the commented-out changeDynamics at reference BaseAviary.py:494),
- contact detected on the PRE-step pose (Bullet runs collision detection at
  the start of stepSimulation), resolved by a projected Gauss-Seidel
  impulse solve with accumulated-impulse clamping:
    * normal impulse >= 0 with Baumgarte penetration correction
      v_n_target = (ERP/dt) * penetration  (ERP = 0.2, the PyBullet
      contactERP default; restitution 0, the URDF default); separated
      points within CONTACT_SLOP join speculatively with the
      closing-velocity limit gap/dt (Bullet's margin-window manifold
      generation), so fast approaches stop at the surface,
    * two tangential friction impulses each clamped to the Coulomb cone
      |j_t| <= mu * j_n with mu = 0.5 (PyBullet URDF default lateral
      friction; the reference URDFs carry no <contact> tags),
    * the ground manifold is 4 points on the bottom rim of the collision
      cylinder (Bullet keeps up to 4 persistent manifold points), giving
      physical lever arms: a tilted lander rights itself, a resting drone
      resists tipping,
- then semi-implicit position integration x += dt v and quaternion update by
  the world-angular-velocity exponential map (btMultiBody's floating-base
  position integration).

Known, documented divergences from real Bullet (bounded in
tests/test_reference_parity.py and PARITY.md): PGS iteration count (we unroll
a fixed small number vs PyBullet's default 50 — single-island contacts
converge in < 4), convex collision margins (we use the exact cylinder
surface), and split-impulse position recovery (btMultiBody uses plain
Baumgarte, which we match; resting bodies therefore show the same ~g dt^2/ERP
~ 0.85 mm steady penetration real Bullet multibodies do).

State layout matches DynState but `ang_v` (world angular velocity) is the
carry, as in Bullet.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.lax import Precision

from gym_pybullet_drones_tpu.params import DroneParams
from gym_pybullet_drones_tpu.ops import quat as quat_ops
from gym_pybullet_drones_tpu.ops.dynamics import motor_forces_torques

# PyBullet defaults for URDF-loaded bodies (changeDynamics docs)
LINEAR_DAMPING = 0.04
ANGULAR_DAMPING = 0.04
GROUND_FRICTION = 0.5     # lateral_friction default; no <contact> tag in URDFs
CONTACT_ERP = 0.2         # PyBullet contactERP default
SOLVER_ITERATIONS = 4     # PGS sweeps (island of <= 7 constraints: converged)
CONTACT_SLOP = 0.02       # speculative-contact window (Bullet's
#                           gContactBreakingThreshold): separated points
#                           within this gap join the solve with the
#                           closing-velocity limit gap/dt, so approaches
#                           stop AT the surface instead of penetrating
#                           deep and taking a Baumgarte kick back out

# physics contractions run in full float32 on every backend (the GPU's
# default would allow TF32 for float32 dots)
HIGHEST = Precision.HIGHEST


class PybState(NamedTuple):
    pos: jnp.ndarray    # (..., 3)
    quat: jnp.ndarray   # (..., 4) xyzw
    vel: jnp.ndarray    # (..., 3) world linear velocity
    ang_v: jnp.ndarray  # (..., 3) world angular velocity


def _prop_coef_pairs(coefs):
    """Greedy pairing of prop indices with opposite-equal coefficients.

    Returns ([(i, j, c)], leftovers): each pair contributes
    c * (f_i - f_j); leftovers contribute c_i * f_i.  All four drone
    models' URDFs pair fully (X and + formations are symmetric)."""
    used = [False] * len(coefs)
    pairs, left = [], []
    for i in range(len(coefs)):
        if used[i]:
            continue
        for j in range(i + 1, len(coefs)):
            if not used[j] and coefs[j] == -coefs[i] and coefs[i] != 0.0:
                used[i] = used[j] = True
                pairs.append((i, j, coefs[i]))
                break
        else:
            if coefs[i] != 0.0:
                left.append(i)
            used[i] = True
    return pairs, left


def _paired_prop_torque(params: DroneParams, rpm, coefs):
    """sum_i coefs[i] * kf * rpm_i^2 with exact symmetric cancellation:
    paired terms are computed as (r_i-r_j)(r_i+r_j) * (c*kf)."""
    pairs, left = _prop_coef_pairs(coefs)
    out = jnp.zeros(rpm.shape[:-1], rpm.dtype)
    for i, j, c in pairs:
        ri, rj = rpm[..., i], rpm[..., j]
        out = out + ((ri - rj) * (ri + rj)) * (c * params.kf)
    for i in left:
        out = out + (rpm[..., i] * rpm[..., i]) * (coefs[i] * params.kf)
    return out


def _ground_manifold(params: DroneParams, pos, rot, dtype):
    """4-point contact manifold on the bottom rim of the collision cylinder.

    Returns (arms, penetrations): world-frame arms r_k from the CoM to each
    candidate contact point (..., 4, 3) and the signed penetration depth of
    each point below the z=0 plane (..., 4), positive = penetrating.
    """
    rc, h2 = params.collision_r, params.collision_h / 2
    zoff = params.collision_z_offset
    # body-frame rim points at 0/90/180/270 deg on the bottom disk
    rim = jnp.asarray([[rc, 0.0, zoff - h2],
                       [0.0, rc, zoff - h2],
                       [-rc, 0.0, zoff - h2],
                       [0.0, -rc, zoff - h2]], dtype)          # (4, 3)
    arms = jnp.einsum("...ij,kj->...ki", rot, rim,
                      precision=HIGHEST)                      # (..., 4, 3)
    pen = -(pos[..., None, 2] + arms[..., 2])                  # (..., 4)
    return arms, pen


def _solve_contacts(params: DroneParams, rot, vel, ang_v, arms, pen,
                    mu: float, dt, extra=(),
                    iterations: int = SOLVER_ITERATIONS):
    """Projected Gauss-Seidel impulse solve for one body vs static geometry.

    arms: (..., K, 3) world arms to contact points, pen: (..., K) depths
    for plane contacts with normal +z.  `extra` is a sequence of
    (normal, penetration) pairs for centered contacts (arm = 0, e.g.
    bounding-sphere obstacle hits) that join the same solve.

    Bullet-style speculative contacts: a point is active when its depth
    exceeds -CONTACT_SLOP; the normal velocity target is ERP/dt * depth
    when penetrating (Baumgarte push-out) and depth/dt when separated
    (allow closing exactly to the surface in one step — this is what
    keeps fast approaches from penetrating deep and taking a Baumgarte
    kick back out).  Returns updated (vel, ang_v).
    """
    dtype = vel.dtype
    inv_m = 1.0 / params.m
    j_inv_diag = jnp.asarray(
        [1.0 / params.ixx, 1.0 / params.iyy, 1.0 / params.izz], dtype)
    # world inverse inertia as an explicit matrix, R diag(J^-1) R^T
    # (the contact-shim computes the same matrix), applied as one matvec
    # per impulse — smaller traced graph than re-rotating per application
    i_inv = jnp.einsum("...ik,k,...jk->...ij", rot, j_inv_diag, rot,
                       precision=HIGHEST)

    def iinv(v):
        return jnp.einsum("...ij,...j->...i", i_inv, v, precision=HIGHEST)

    beta = jnp.asarray(CONTACT_ERP / dt, dtype)
    inv_dt = jnp.asarray(1.0 / dt, dtype)
    k = arms.shape[-2]
    n = jnp.zeros(arms.shape, dtype).at[..., 2].set(1.0)        # (..., K, 3)
    t1 = jnp.zeros(arms.shape, dtype).at[..., 0].set(1.0)
    t2 = jnp.zeros(arms.shape, dtype).at[..., 1].set(1.0)
    active = (pen > -CONTACT_SLOP).astype(dtype)                # (..., K)

    # effective masses (constant through the solve): 1/m + ((I^-1 (r x d))
    # x r) . d for each constraint direction d
    def keff(d):
        rxd = jnp.cross(arms, d)
        return inv_m + jnp.sum(jnp.cross(
            jnp.einsum("...ij,...kj->...ki", i_inv, rxd, precision=HIGHEST),
            arms) * d,
            axis=-1)
    kn, kt1, kt2 = keff(n), keff(t1), keff(t2)

    # speculative target: push out when penetrating, allow closing to the
    # surface when separated
    target = jnp.where(pen > 0, beta * pen, inv_dt * pen)       # (..., K)
    e_active = [(ep > -CONTACT_SLOP).astype(dtype) for _, ep in extra]
    e_target = [jnp.where(ep > 0, beta * ep, inv_dt * ep) for _, ep in extra]

    def one_sweep(_, carry):
        vel, ang_v, acc_n, acc_t1, acc_t2, extra_acc, extra_t = carry
        for ki in range(k):
            r = arms[..., ki, :]
            a = active[..., ki]
            # normal
            v_c = vel + jnp.cross(ang_v, r)
            vn = v_c[..., 2]
            dj = (target[..., ki] - vn) / kn[..., ki]
            new_acc = jnp.maximum(acc_n[..., ki] + dj, 0.0) * a
            dj = new_acc - acc_n[..., ki]
            acc_n = acc_n.at[..., ki].set(new_acc)
            imp = dj[..., None] * n[..., ki, :]
            vel = vel + inv_m * imp
            ang_v = ang_v + iinv(jnp.cross(r, imp))
            # friction (both tangents), cone clamped by accumulated normal
            lim = mu * acc_n[..., ki]
            for tdir, kt, which in ((t1, kt1, 0), (t2, kt2, 1)):
                acc_t = acc_t1 if which == 0 else acc_t2
                v_c = vel + jnp.cross(ang_v, r)
                vt = jnp.sum(v_c * tdir[..., ki, :], axis=-1)
                dj = -vt / kt[..., ki]
                new_acc = jnp.clip(acc_t[..., ki] + dj, -lim, lim) * a
                dj = new_acc - acc_t[..., ki]
                if which == 0:
                    acc_t1 = acc_t1.at[..., ki].set(new_acc)
                else:
                    acc_t2 = acc_t2.at[..., ki].set(new_acc)
                imp = dj[..., None] * tdir[..., ki, :]
                vel = vel + inv_m * imp
                ang_v = ang_v + iinv(jnp.cross(r, imp))
        # centered extra contacts (arm = 0: no angular coupling)
        new_extra = []
        new_extra_t = []
        for ei, (en, _) in enumerate(extra):
            a = e_active[ei]
            vn = jnp.sum(vel * en, axis=-1)
            dj = (e_target[ei] - vn) * params.m
            new_acc = jnp.maximum(extra_acc[ei] + dj, 0.0) * a
            dj = new_acc - extra_acc[ei]
            new_extra.append(new_acc)
            vel = vel + (dj * inv_m)[..., None] * en
            # friction in the contact plane (linear only), with the
            # ACCUMULATED tangential impulse clamped to the Coulomb cone
            # mu * acc_n — per-sweep re-clamping against the full
            # tangential velocity would let the total exceed the cone
            # over SOLVER_ITERATIONS sweeps
            vt = vel - jnp.sum(vel * en, axis=-1)[..., None] * en
            vt_norm = jnp.linalg.norm(vt, axis=-1)
            j_stop = vt_norm * params.m                  # impulse to stop
            new_t = jnp.minimum(extra_t[ei] + j_stop, mu * new_acc) * a
            dj_t = jnp.maximum(new_t - extra_t[ei], 0.0)
            new_extra_t.append(new_t)
            lim_v = dj_t * inv_m                         # velocity units
            scale = jnp.where(vt_norm > 1e-9,
                              jnp.maximum(vt_norm - lim_v, 0.0)
                              / jnp.maximum(vt_norm, 1e-9), 1.0)
            scale = jnp.where(a > 0, scale, 1.0)
            vel = vt * scale[..., None] + (vel - vt)
        return (vel, ang_v, acc_n, acc_t1, acc_t2, tuple(new_extra),
                tuple(new_extra_t))

    zero_k = jnp.zeros(pen.shape, dtype)
    carry = (vel, ang_v, zero_k, zero_k, zero_k,
             tuple(jnp.zeros(ep.shape, dtype) for _, ep in extra),
             tuple(jnp.zeros(ep.shape, dtype) for _, ep in extra))
    # fori_loop keeps the traced graph one-sweep-sized (the unrolled form
    # made downstream XLA compiles of substep x rollout programs explode)
    vel, ang_v, *_ = jax.lax.fori_loop(
        0, iterations, one_sweep, carry)
    return vel, ang_v


def pyb_step(params: DroneParams, state: PybState, rpm: jnp.ndarray,
             dt: float,
             ext_force: jnp.ndarray | None = None,
             ext_torque: jnp.ndarray | None = None,
             obstacles: tuple = (),
             solver_iterations: int = SOLVER_ITERATIONS) -> PybState:
    """One physics substep of the Bullet-like integrator.

    ext_force / ext_torque are additional world-frame force/torque about the
    CoM (the aero effects from ops/aero.py), already composed by the caller
    according to the active Physics mode.
    """
    dtype = state.pos.dtype
    rot = quat_ops.quat_to_mat(state.quat)             # (..., 3, 3)
    # per-motor thrusts + z-torque with model-dependent sign (reference
    # BaseAviary.py:693-697); the mixer handles the RACE negation and the
    # f32 exact-cancellation formulation (unused x/y rows are DCE'd)
    forces, mix_torques = motor_forces_torques(params, rpm)
    z_torque = mix_torques[..., 2]

    # World force: sum of per-prop thrusts along the body z axis.
    z_axis = rot[..., :, 2]
    total_thrust = jnp.sum(forces, axis=-1)
    force_w = z_axis * total_thrust[..., None]
    # Torque about CoM from per-prop application points: R @ (off x [0,0,f])
    if dtype == jnp.float64:   # parity-oracle path: shim arithmetic order
        offsets = jnp.asarray(params.prop_offsets, dtype=dtype)   # (4, 3)
        f_body = jnp.zeros(forces.shape + (3,), dtype) \
            .at[..., 2].set(forces)                                # (...,4,3)
        tau_body = jnp.sum(jnp.cross(offsets, f_body), axis=-2)   # (..., 3)
        tau_body = tau_body.at[..., 2].add(z_torque)
    else:
        # f32 production path: pair props with opposite-equal offset
        # coefficients and compute each pair as (r_i-r_j)(r_i+r_j)*(c*kf) —
        # exact zero for bitwise-equal rpms under any FMA contraction (the
        # cross-product sum leaves ~1e-10 residuals that the closed loop
        # amplifies; see motor_forces_torques)
        tau_x = _paired_prop_torque(
            params, rpm, [o[1] for o in params.prop_offsets])
        tau_y = _paired_prop_torque(
            params, rpm, [-o[0] for o in params.prop_offsets])
        tau_body = jnp.stack([tau_x, tau_y, z_torque], axis=-1)
    torque_w = jnp.einsum("...ij,...j->...i", rot, tau_body, precision=HIGHEST)

    if ext_force is not None:
        force_w = force_w + ext_force
    if ext_torque is not None:
        torque_w = torque_w + ext_torque

    # Gravity + velocity update with the gyroscopic bias term
    # (Featherstone: dw_b = J^-1 (tau_b - w_b x (J w_b)))
    acc = force_w / params.m
    acc = acc.at[..., 2].add(-9.8)
    vel = state.vel + dt * acc
    j_diag = jnp.asarray([params.ixx, params.iyy, params.izz], dtype=dtype)
    j_inv = 1.0 / j_diag
    tau_b = jnp.einsum("...ji,...j->...i", rot, torque_w,
                       precision=HIGHEST)                     # R^T tau
    w_b = jnp.einsum("...ji,...j->...i", rot, state.ang_v, precision=HIGHEST)
    tau_b = tau_b - jnp.cross(w_b, j_diag * w_b)
    dw_b = j_inv * tau_b
    ang_v = state.ang_v + dt * jnp.einsum("...ij,...j->...i", rot, dw_b,
                                          precision=HIGHEST)

    # Bullet-style damping (applied after velocity integration)
    vel = vel * (1.0 - LINEAR_DAMPING) ** dt
    ang_v = ang_v * (1.0 - ANGULAR_DAMPING) ** dt

    # --- Contact solve on the PRE-step pose (Bullet collision order) ---
    arms, pen = _ground_manifold(params, state.pos, rot, dtype)
    # static obstacles as centered bounding-sphere contacts (the arm from
    # the CoM to the closest point is parallel to the contact normal for a
    # sphere about the CoM, so they carry no angular term)
    extra = []
    body_r = params.collision_r
    for entry in obstacles:
        if len(entry) == 4:
            ox, oy, oz, orad = entry
            center = jnp.asarray([ox, oy, oz], dtype)
            delta = state.pos - center
            dist = jnp.linalg.norm(delta, axis=-1)
            n_hat = delta / jnp.maximum(dist, 1e-6)[..., None]
            extra.append((n_hat, orad + body_r - dist))
        else:
            ox, oy, oz, hx, hy, hz = entry
            center = jnp.asarray([ox, oy, oz], dtype)
            half = jnp.asarray([hx, hy, hz], dtype)
            rel = state.pos - center
            closest = jnp.clip(rel, -half, half)
            delta = rel - closest                 # 0 inside the box
            dist = jnp.linalg.norm(delta, axis=-1)
            outside = dist > 1e-6
            n_out = delta / jnp.maximum(dist, 1e-6)[..., None]
            # center inside the box: face normal of least penetration
            pen_ax = half + body_r - jnp.abs(rel)          # (..., 3)
            axis_1h = jax.nn.one_hot(
                jnp.argmin(pen_ax, axis=-1), 3, dtype=dtype)
            sgn = jnp.where(rel >= 0, 1.0, -1.0)
            n_in = axis_1h * sgn
            n_hat = jnp.where(outside[..., None], n_out, n_in)
            depth = jnp.where(outside, body_r - dist,
                              jnp.min(pen_ax, axis=-1))
            extra.append((n_hat, depth))
    vel, ang_v = _solve_contacts(params, rot, vel, ang_v, arms, pen,
                                 GROUND_FRICTION, dt, extra,
                                 iterations=solver_iterations)

    # --- Position integration with the corrected velocities ---
    pos = state.pos + dt * vel
    # Bullet integrates orientation with the world angular velocity
    # (left-multiplied exponential map — NOT the body-rate variant)
    quat = quat_ops.integrate_quat_world(state.quat, ang_v, dt)
    return PybState(pos=pos, quat=quat, vel=vel, ang_v=ang_v)


def resolve_drone_collisions(params: DroneParams, pos: jnp.ndarray,
                             vel: jnp.ndarray, dt: float | None = None,
                             quat: jnp.ndarray | None = None,
                             ang_v: jnp.ndarray | None = None):
    """Pairwise drone-drone contact within one env.

    TPU-native counterpart of Bullet's multibody contact between drone
    collision shapes (the reference loads every drone into one PyBullet
    world, BaseAviary.py:484-491, so bodies collide in all PYB* modes).

    With ``quat``/``ang_v`` provided (the production path), each pair whose
    center distance is inside the sphere-swept window (< 2 * collision_r +
    slop) is resolved as a **cylinder-manifold contact with full angular
    response**, following Bullet's convex pair contact:

    - the contact point is the midpoint of the two bodies' cylinder-clamped
      closest points toward the pair midpoint (each body clamps the midpoint
      into its own collision cylinder: radial part to ``collision_r``, axial
      part to ``collision_z_offset +- collision_h/2`` in body frame), so
      tilted or height-offset drones contact off their center line and the
      normal impulse exerts torque — a glancing collision *tumbles* instead
      of translating;
    - the normal is the center line (j -> i) with the same speculative
      Baumgarte target as the ground solve (ERP = 0.2, restitution 0);
    - a single Coulomb friction impulse opposes the tangential relative
      velocity at the contact point, clamped to ``mu * j_n``
      (GROUND_FRICTION, PyBullet's URDF default lateral friction), and its
      lever arm spins both bodies;
    - impulses use the full two-body effective mass
      ``k = 2/m + n . ((I_i^-1 (r_i x n)) x r_i + (I_j^-1 (r_j x n)) x r_j)``
      (equal masses; one Jacobi pass over ordered pairs — antisymmetric by
      construction, so linear and angular momentum about the contact point
      are conserved up to the Baumgarte bias).

    Returns ``(pos, vel, ang_v)``.  Without ``quat`` the legacy
    bounding-sphere centered response is used (no angular term; returns
    ``(pos, vel)``) — kept for callers that carry no orientation state.
    pos/vel/ang_v are (..., N, 3), quat (..., N, 4); O(N^2) masked
    pairwise, vectorized over leading batch dims.
    """
    dtype = pos.dtype
    n = pos.shape[-2]
    if n < 2:
        return (pos, vel) if quat is None else (pos, vel, ang_v)
    min_d = 2.0 * params.collision_r
    beta = 0.0 if dt is None else CONTACT_ERP / dt
    inv_dt = 0.0 if dt is None else 1.0 / dt
    diff = pos[..., :, None, :] - pos[..., None, :, :]     # d[i,j] = p_i - p_j
    dist = jnp.linalg.norm(diff, axis=-1)                  # (..., N, N)
    eye = jnp.eye(n, dtype=bool)
    depth = min_d - dist                                   # + = penetrating
    hit = (depth > -CONTACT_SLOP) & ~eye & (dist > 1e-6)
    n_hat = diff / jnp.maximum(dist, 1e-6)[..., None]
    rel_v = vel[..., :, None, :] - vel[..., None, :, :]
    target = jnp.where(depth > 0, beta * depth, inv_dt * depth)

    if quat is None:
        # legacy centered response: normal impulse split between the two
        # equal-mass bodies, no angular coupling
        vn = jnp.sum(rel_v * n_hat, axis=-1)               # (..., N, N)
        dv_pair = jnp.maximum(target - vn, 0.0)            # only push apart
        dv = jnp.sum(
            jnp.where(hit[..., None], 0.5 * dv_pair[..., None] * n_hat, 0.0),
            axis=-2)
        return pos, vel + dv

    rot = quat_ops.quat_to_mat(quat)                       # (..., N, 3, 3)
    inv_m = 1.0 / params.m
    j_inv_diag = jnp.asarray(
        [1.0 / params.ixx, 1.0 / params.iyy, 1.0 / params.izz], dtype)
    i_inv = jnp.einsum("...ik,k,...jk->...ij", rot, j_inv_diag, rot,
                       precision=HIGHEST)

    # contact point: midpoint of the two cylinder-clamped closest points
    rc, h2 = params.collision_r, params.collision_h / 2
    zoff = params.collision_z_offset
    mid = 0.5 * (pos[..., :, None, :] + pos[..., None, :, :])  # (..N,N,3)

    def surf_point(body_axis):
        # clamp `mid` into the cylinder of the body indexed on `body_axis`
        if body_axis == 0:        # body i: rows
            c = pos[..., :, None, :]
            r_mat = rot[..., :, None, :, :]
        else:                     # body j: cols
            c = pos[..., None, :, :]
            r_mat = rot[..., None, :, :, :]
        u = jnp.einsum("...ba,...b->...a", r_mat, mid - c,
                       precision=HIGHEST)                     # R^T (mid-c)
        ur = jnp.sqrt(u[..., 0] ** 2 + u[..., 1] ** 2)
        s = jnp.minimum(1.0, rc / jnp.maximum(ur, 1e-9))
        q = jnp.stack([u[..., 0] * s, u[..., 1] * s,
                       jnp.clip(u[..., 2], zoff - h2, zoff + h2)], axis=-1)
        return c + jnp.einsum("...ab,...b->...a", r_mat, q, precision=HIGHEST)
    pc = 0.5 * (surf_point(0) + surf_point(1))             # (..., N, N, 3)
    r_i = pc - pos[..., :, None, :]
    r_j = pc - pos[..., None, :, :]

    w_i = ang_v[..., :, None, :]
    w_j = ang_v[..., None, :, :]
    i_inv_i = i_inv[..., :, None, :, :]
    i_inv_j = i_inv[..., None, :, :, :]
    rel_c = (rel_v + jnp.cross(w_i, r_i, axis=-1)
             - jnp.cross(w_j, r_j, axis=-1))               # at contact point

    def keff(d_vec):
        rxd_i = jnp.cross(r_i, d_vec, axis=-1)
        rxd_j = jnp.cross(r_j, d_vec, axis=-1)
        term_i = jnp.sum(jnp.cross(
            jnp.einsum("...ab,...b->...a", i_inv_i, rxd_i,
                       precision=HIGHEST), r_i,
            axis=-1) * d_vec, axis=-1)
        term_j = jnp.sum(jnp.cross(
            jnp.einsum("...ab,...b->...a", i_inv_j, rxd_j,
                       precision=HIGHEST), r_j,
            axis=-1) * d_vec, axis=-1)
        return 2.0 * inv_m + term_i + term_j

    vn = jnp.sum(rel_c * n_hat, axis=-1)                   # (..., N, N)
    j_n = jnp.maximum(target - vn, 0.0) / keff(n_hat)
    j_n = jnp.where(hit, j_n, 0.0)

    # Coulomb friction along the tangential relative velocity
    vt = rel_c - vn[..., None] * n_hat
    vt_norm = jnp.linalg.norm(vt, axis=-1)
    t_hat = vt / jnp.maximum(vt_norm, 1e-9)[..., None]
    j_t = jnp.minimum(vt_norm / keff(t_hat), GROUND_FRICTION * j_n)
    j_t = jnp.where(hit, j_t, 0.0)

    imp = j_n[..., None] * n_hat - j_t[..., None] * t_hat  # on body i
    dv = jnp.sum(imp, axis=-2) * inv_m
    dw = jnp.sum(jnp.einsum("...ab,...b->...a", i_inv_i,
                            jnp.cross(r_i, imp, axis=-1),
                            precision=HIGHEST), axis=-2)
    return pos, vel + dv, ang_v + dw
