"""Parity tests that execute the ACTUAL reference code as the oracle.

Every test here drives the genuine classes from /root/reference/
gym_pybullet_drones (BaseAviary, CtrlAviary, HoverAviary, BaseRLAviary,
DSLPIDControl) — imported verbatim under tests/ref_harness — and asserts the
JAX framework reproduces their step-by-step outputs in float64.

Oracle independence:
- In Physics.DYN the reference uses PyBullet only as a state store
  (BaseAviary.py:815-874), so the executed dynamics are 100% reference code;
  the shim contributes only Bullet's quaternion<->matrix conversions, which
  test_shim_quat_matches_scipy cross-checks against scipy (an independent
  implementation).
- DSLPIDControl executes the reference controller with scipy Rotation and
  shim quat utilities — again reference code end to end.
- PYB*-mode tests: real Bullet is not installable here, so the shim's
  stepSimulation implements Bullet's *documented* discrete algorithm in
  independent NumPy (Featherstone velocity update with the gyroscopic bias,
  pre-step collision detection, PGS impulse solve with ERP=0.2 Baumgarte /
  mu=0.5 Coulomb cone / 4-point cylinder rim manifold — see PARITY.md for
  the bounded divergences from the real binary).  The force assembly
  (_physics/_groundEffect/_drag/_downwash with their LINK_FRAME quirks) is
  the reference's own Python, executed verbatim.
"""
import sys
import os

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from ref_harness import load_reference  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gym_pybullet_drones_tpu import params as P  # noqa: E402
from gym_pybullet_drones_tpu.envs import core, tasks  # noqa: E402
from gym_pybullet_drones_tpu.control import dsl_pid  # noqa: E402
from gym_pybullet_drones_tpu.utils.enums import (  # noqa: E402
    ActionType, Physics)

F64 = jnp.float64


@pytest.fixture(scope="module")
def ref():
    return load_reference()


def _ref_enums(ref):
    from gym_pybullet_drones.utils.enums import DroneModel as RDrone
    from gym_pybullet_drones.utils.enums import Physics as RPhys
    return RDrone, RPhys


def _my_rollout(cfg, task, actions, dtype=F64):
    """Roll my functional env; returns per-ctrl-step stacked outputs."""
    state, obs0, _ = core.reset(cfg, task, dtype=dtype)

    @jax.jit
    def one(state, action):
        state, obs, rew, term, trunc, _ = core.step(cfg, task, state, action)
        return state, (obs, rew, term, trunc)

    outs = []
    for a in actions:
        state, out = one(state, jnp.asarray(a, dtype))
        outs.append(jax.tree.map(np.asarray, out))
    obs = np.stack([o[0] for o in outs])
    rew = np.stack([o[1] for o in outs])
    term = np.stack([o[2] for o in outs])
    trunc = np.stack([o[3] for o in outs])
    return obs0, obs, rew, term, trunc


# ---------------------------------------------------------------------------
# Shim self-checks against independent implementations
# ---------------------------------------------------------------------------
def test_shim_quat_matches_scipy(ref):
    """Bullet-transcribed shim quat math == scipy (independent source)."""
    import pybullet as pb  # the shim (resolved via ref_harness sys.path)
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(0)
    for _ in range(200):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        # matrix
        m_shim = np.array(pb.getMatrixFromQuaternion(q)).reshape(3, 3)
        m_scipy = Rotation.from_quat(q).as_matrix()
        np.testing.assert_allclose(m_shim, m_scipy, atol=1e-12)
        # euler (Bullet's fixed-axis XYZ == scipy lowercase 'xyz')
        e_shim = np.array(pb.getEulerFromQuaternion(q))
        e_scipy = Rotation.from_quat(q).as_euler("xyz")
        np.testing.assert_allclose(e_shim, e_scipy, atol=1e-9)
        # euler -> quat (up to sign)
        rpy = rng.uniform(-1.5, 1.5, size=3)
        q_shim = np.array(pb.getQuaternionFromEuler(rpy))
        q_scipy = Rotation.from_euler("xyz", rpy).as_quat()
        if np.dot(q_shim, q_scipy) < 0:
            q_scipy = -q_scipy
        np.testing.assert_allclose(q_shim, q_scipy, atol=1e-12)
        # matrix -> quat round trip (btMatrix3x3::getRotation)
        q_rt = np.array(pb._matrix_to_quat(m_scipy))
        if np.dot(q_rt, q) < 0:
            q_rt = -q_rt
        np.testing.assert_allclose(q_rt, q, atol=1e-12)


def test_shim_quat_matches_package_ops(ref):
    """My ops/quat (f64) agrees with the shim's Bullet transcriptions."""
    import pybullet as pb
    from gym_pybullet_drones_tpu.ops import quat as quat_ops

    rng = np.random.default_rng(1)
    q = rng.normal(size=(64, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    m_mine = np.asarray(quat_ops.quat_to_mat(jnp.asarray(q, F64)))
    e_mine = np.asarray(quat_ops.quat_to_rpy(jnp.asarray(q, F64)))
    for i in range(q.shape[0]):
        m_shim = np.array(pb.getMatrixFromQuaternion(q[i])).reshape(3, 3)
        np.testing.assert_allclose(m_mine[i], m_shim, atol=1e-12)
        e_shim = np.array(pb.getEulerFromQuaternion(q[i]))
        np.testing.assert_allclose(e_mine[i], e_shim, atol=1e-9)


# ---------------------------------------------------------------------------
# DSL PID controller vs the executed reference controller
# ---------------------------------------------------------------------------
def test_dslpid_vs_reference(ref):
    """Stateful tick-for-tick parity of control/dsl_pid vs the reference
    DSLPIDControl (control/DSLPIDControl.py:82-259), 120 random ticks."""
    from gym_pybullet_drones.control.DSLPIDControl import DSLPIDControl
    RDrone, _ = _ref_enums(ref)

    ctrl = DSLPIDControl(drone_model=RDrone.CF2X)
    my_state = dsl_pid.init_state((), F64)
    rng = np.random.default_rng(2)
    dt = 1.0 / 48.0
    pos = np.array([0.0, 0.0, 0.5])
    vel = np.zeros(3)
    for t in range(120):
        rpy = rng.uniform(-0.3, 0.3, size=3)
        import pybullet as pb
        quat = np.array(pb.getQuaternionFromEuler(rpy))
        target_pos = pos + rng.uniform(-0.5, 0.5, size=3)
        target_rpy = np.array([0.0, 0.0, rng.uniform(-0.5, 0.5)])
        target_vel = rng.uniform(-0.2, 0.2, size=3)

        rpm_ref, pos_e_ref, yaw_e_ref = ctrl.computeControl(
            control_timestep=dt, cur_pos=pos, cur_quat=quat, cur_vel=vel,
            cur_ang_vel=np.zeros(3), target_pos=target_pos,
            target_rpy=target_rpy, target_vel=target_vel)

        rpm_my, my_state, pos_e_my, yaw_e_my = dsl_pid.compute_control(
            P.CF2X, my_state, dt,
            cur_pos=jnp.asarray(pos, F64), cur_quat=jnp.asarray(quat, F64),
            cur_vel=jnp.asarray(vel, F64),
            target_pos=jnp.asarray(target_pos, F64),
            target_rpy=jnp.asarray(target_rpy, F64),
            target_vel=jnp.asarray(target_vel, F64))

        np.testing.assert_allclose(np.asarray(rpm_my), rpm_ref,
                                   rtol=1e-9, atol=1e-7,
                                   err_msg=f"tick {t}")
        np.testing.assert_allclose(np.asarray(pos_e_my), pos_e_ref,
                                   atol=1e-10)
        # random walk the plant a little so integrals accumulate
        pos = pos + dt * vel
        vel = vel + rng.uniform(-0.05, 0.05, size=3)


# ---------------------------------------------------------------------------
# DYN-mode rollouts: the reference's own dynamics code is the oracle
# ---------------------------------------------------------------------------
def test_dyn_rollout_vs_reference(ref):
    """1200-ctrl-step CtrlAviary(DYN) fixed-action rollout, 2 drones.

    The full 20-dim obs stream of the executed reference
    (BaseAviary._dynamics + _integrateQ, BaseAviary.py:815-889) must match
    the JAX env step for step.
    """
    from gym_pybullet_drones.envs.CtrlAviary import CtrlAviary
    RDrone, RPhys = _ref_enums(ref)

    init_xyzs = np.array([[0.0, 0.0, 0.35], [0.25, 0.25, 0.6]])
    init_rpys = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, 0.4]])
    env = CtrlAviary(drone_model=RDrone.CF2X, num_drones=2,
                     initial_xyzs=init_xyzs, initial_rpys=init_rpys,
                     physics=RPhys.DYN, pyb_freq=240, ctrl_freq=48,
                     gui=False, obstacles=False, user_debug_gui=False)
    obs_ref0, _ = env.reset()
    hover = env.HOVER_RPM

    n_steps = 1200
    t = np.arange(n_steps)[:, None, None]
    base = np.ones((n_steps, 2, 4))
    # gentle asymmetric modulation around hover: keeps the open-loop
    # trajectory bounded so fp-noise divergence stays measurable
    mod = 1.0 + 0.015 * np.sin(0.013 * t) \
        + 0.002 * np.sin(0.031 * t) * np.array([1.0, -1.0, 1.0, -1.0])
    actions = hover * base * mod

    ref_obs = np.zeros((n_steps, 2, 20))
    for i in range(n_steps):
        obs, *_ = env.step(actions[i])
        ref_obs[i] = obs
    env.close()

    cfg = core.AviaryConfig(
        drone=P.CF2X, num_drones=2, physics=Physics.DYN,
        pyb_freq=240, ctrl_freq=48,
        init_xyzs=tuple(map(tuple, init_xyzs)),
        init_rpys=tuple(map(tuple, init_rpys)))
    _, my_obs, *_ = _my_rollout(cfg, tasks.CtrlTask(), actions)

    # pos / rpy / vel / ang_v / last action — full state stream
    np.testing.assert_allclose(my_obs[:, :, 0:3], ref_obs[:, :, 0:3],
                               atol=5e-9, err_msg="pos")
    np.testing.assert_allclose(my_obs[:, :, 7:10], ref_obs[:, :, 7:10],
                               atol=5e-9, err_msg="rpy")
    np.testing.assert_allclose(my_obs[:, :, 10:13], ref_obs[:, :, 10:13],
                               atol=5e-9, err_msg="vel")
    np.testing.assert_allclose(my_obs[:, :, 13:16], ref_obs[:, :, 13:16],
                               atol=5e-9, err_msg="ang_v")
    np.testing.assert_allclose(my_obs[:, :, 16:20], ref_obs[:, :, 16:20],
                               rtol=1e-12, err_msg="last action")
    # quaternions up to per-step sign: the reference's quat round-trips
    # through btMatrix3x3::getRotation each substep, which re-canonicalizes
    # the sign, while my env carries the exponential-map quat continuously
    q_my, q_ref = my_obs[:, :, 3:7], ref_obs[:, :, 3:7]
    sign = np.sign(np.sum(q_my * q_ref, axis=-1, keepdims=True))
    np.testing.assert_allclose(q_my, sign * q_ref, atol=5e-9,
                               err_msg="quat (sign-aligned)")


def test_pid_helix_closed_loop_vs_reference(ref):
    """examples/pid.py helix loop (DYN physics): executed reference
    CtrlAviary + DSLPIDControl vs my env + batched PID, 3 drones, 6 s.

    Mirrors reference examples/pid.py:64-151 (same helix constants, same
    waypoint advance) with gui/plot off.  (VERDICT.md round-1 item #1b.)
    """
    from gym_pybullet_drones.envs.CtrlAviary import CtrlAviary
    from gym_pybullet_drones.control.DSLPIDControl import DSLPIDControl
    RDrone, RPhys = _ref_enums(ref)

    num_drones = 3
    H, H_STEP, R = 0.1, 0.05, 0.3
    init_xyzs = np.array([
        [R * np.cos((i / 6) * 2 * np.pi + np.pi / 2),
         R * np.sin((i / 6) * 2 * np.pi + np.pi / 2) - R,
         H + i * H_STEP] for i in range(num_drones)])
    init_rpys = np.array(
        [[0.0, 0.0, i * (np.pi / 2) / num_drones] for i in range(num_drones)])
    ctrl_hz, pyb_hz, duration = 48, 240, 6
    period = 10
    num_wp = ctrl_hz * period
    target_pos = np.zeros((num_wp, 3))
    for i in range(num_wp):
        target_pos[i, :] = (
            R * np.cos((i / num_wp) * 2 * np.pi + np.pi / 2) + init_xyzs[0, 0],
            R * np.sin((i / num_wp) * 2 * np.pi + np.pi / 2) - R
            + init_xyzs[0, 1], 0)
    wp0 = np.array([int((i * num_wp / 6) % num_wp) for i in range(num_drones)])

    # ---- reference loop ----
    env = CtrlAviary(drone_model=RDrone.CF2X, num_drones=num_drones,
                     initial_xyzs=init_xyzs, initial_rpys=init_rpys,
                     physics=RPhys.DYN, pyb_freq=pyb_hz, ctrl_freq=ctrl_hz,
                     gui=False, obstacles=False, user_debug_gui=False)
    ctrl = [DSLPIDControl(drone_model=RDrone.CF2X) for _ in range(num_drones)]
    action = np.zeros((num_drones, 4))
    wp = wp0.copy()
    n_steps = duration * ctrl_hz
    ref_pos = np.zeros((n_steps, num_drones, 3))
    ref_act = np.zeros((n_steps, num_drones, 4))
    for i in range(n_steps):
        obs, *_ = env.step(action)
        for j in range(num_drones):
            action[j, :], _, _ = ctrl[j].computeControlFromState(
                control_timestep=env.CTRL_TIMESTEP, state=obs[j],
                target_pos=np.hstack([target_pos[wp[j], 0:2],
                                      init_xyzs[j, 2]]),
                target_rpy=init_rpys[j, :])
            wp[j] = wp[j] + 1 if wp[j] < (num_wp - 1) else 0
        ref_pos[i] = obs[:, 0:3]
        ref_act[i] = action
    env.close()

    # ---- my loop (batched PID over the drone axis) ----
    cfg = core.AviaryConfig(
        drone=P.CF2X, num_drones=num_drones, physics=Physics.DYN,
        pyb_freq=pyb_hz, ctrl_freq=ctrl_hz,
        init_xyzs=tuple(map(tuple, init_xyzs)),
        init_rpys=tuple(map(tuple, init_rpys)))
    task = tasks.CtrlTask()
    state, _, _ = core.reset(cfg, task, dtype=F64)
    pid_state = dsl_pid.init_state((num_drones,), F64)

    @jax.jit
    def env_step(state, action):
        state, obs, *_ = core.step(cfg, task, state, action)
        return state, obs

    @jax.jit
    def pid_step(pid_state, obs, tgt_pos, tgt_rpy):
        rpm, pid_state, _, _ = dsl_pid.compute_control_from_state(
            P.CF2X, pid_state, 1.0 / ctrl_hz, obs, tgt_pos,
            target_rpy=tgt_rpy)
        return pid_state, rpm

    action = jnp.zeros((num_drones, 4), F64)
    wp = wp0.copy()
    my_pos = np.zeros((n_steps, num_drones, 3))
    my_act = np.zeros((n_steps, num_drones, 4))
    tgt_rpy = jnp.asarray(init_rpys, F64)
    for i in range(n_steps):
        state, obs = env_step(state, action)
        tgt = np.hstack([target_pos[wp, 0:2],
                         init_xyzs[:, 2:3]])          # (N, 3)
        pid_state, action = pid_step(pid_state, obs,
                                     jnp.asarray(tgt, F64), tgt_rpy)
        wp = np.where(wp < num_wp - 1, wp + 1, 0)
        my_pos[i] = np.asarray(obs[:, 0:3])
        my_act[i] = np.asarray(action)

    np.testing.assert_allclose(my_pos, ref_pos, atol=1e-8,
                               err_msg="helix positions")
    np.testing.assert_allclose(my_act, ref_act, rtol=1e-7, atol=1e-4,
                               err_msg="helix rpm commands")


def test_hover_episode_vs_reference(ref):
    """HoverAviary(DYN) full-episode obs/reward/terminated/truncated streams
    vs the executed reference (HoverAviary.py:68-117, BaseRLAviary obs/action
    machinery).  (VERDICT.md round-1 item #1c.)"""
    from gym_pybullet_drones.envs.HoverAviary import HoverAviary
    from gym_pybullet_drones.utils.enums import (
        ActionType as RAct, ObservationType as RObs)
    RDrone, RPhys = _ref_enums(ref)

    env = HoverAviary(drone_model=RDrone.CF2X, physics=RPhys.DYN,
                      pyb_freq=240, ctrl_freq=30, gui=False,
                      obs=RObs.KIN, act=RAct.ONE_D_RPM)
    obs0_ref, _ = env.reset()

    n_steps = 242  # 8 s episode at 30 Hz truncates a bit past 240
    # Crude altitude P-controller on the REFERENCE's own obs keeps the drone
    # inside the flight box for the full 8 s; the recorded action sequence is
    # then replayed verbatim into my env (identical inputs on both sides).
    ref_obs, ref_rew, ref_term, ref_trunc, rec_actions = [], [], [], [], []
    obs = obs0_ref
    for i in range(n_steps):
        z, vz = float(obs[0, 2]), float(obs[0, 8])
        common = np.clip(0.3 * (1.0 - z) - 0.25 * vz
                         + 0.02 * np.sin(0.05 * i), -0.8, 0.8)
        a = np.array([[common]])
        rec_actions.append(a)
        obs, rew, term, trunc, _ = env.step(a.astype(np.float64))
        ref_obs.append(obs.copy())
        ref_rew.append(rew)
        ref_term.append(term)
        ref_trunc.append(trunc)
        if term or trunc:
            break
    env.close()
    ref_obs = np.array(ref_obs)
    actions = np.array(rec_actions)
    n_done = len(ref_rew)

    cfg = core.AviaryConfig(drone=P.CF2X, num_drones=1, physics=Physics.DYN,
                            pyb_freq=240, ctrl_freq=30)
    task = tasks.HoverTask(act=ActionType.ONE_D_RPM)
    obs0_my, my_obs, my_rew, my_term, my_trunc = _my_rollout(
        cfg, task, actions[:n_done])

    np.testing.assert_allclose(np.asarray(obs0_my)[0], obs0_ref[0],
                               atol=2e-6, err_msg="initial obs")
    np.testing.assert_allclose(my_obs[:, 0, :], ref_obs[:, 0, :], atol=2e-6,
                               err_msg="obs stream (12 + action buffer)")
    np.testing.assert_allclose(my_rew, np.array(ref_rew), atol=1e-7,
                               err_msg="reward stream")
    assert my_term.tolist() == list(np.array(ref_term)), "terminated stream"
    assert my_trunc.tolist() == list(np.array(ref_trunc)), "truncated stream"
    # the episode must actually run to the 8 s truncation boundary
    assert n_done >= 240 and ref_trunc[-1]


# ---------------------------------------------------------------------------
# PYB-family plumbing parity (aero force assembly is reference code)
# ---------------------------------------------------------------------------
def test_pyb_aero_plumbing_vs_reference(ref):
    """CtrlAviary(PYB_GND_DRAG_DW), 2 stacked drones, 240 ctrl steps.

    The reference's _physics/_groundEffect/_drag/_downwash Python runs
    verbatim (incl. the LINK_FRAME downwash/drag rotation quirks and the
    stale-action drag, BaseAviary.py:679-811,359) against the shim's
    rigid-body mirror; my env must reproduce the trajectories.  This pins
    the aero models + force plumbing, NOT Bullet's contact solver
    (SURVEY.md §7.4 scope).
    """
    from gym_pybullet_drones.envs.CtrlAviary import CtrlAviary
    RDrone, RPhys = _ref_enums(ref)

    init_xyzs = np.array([[0.0, 0.0, 0.08], [0.02, 0.0, 0.5]])
    env = CtrlAviary(drone_model=RDrone.CF2X, num_drones=2,
                     initial_xyzs=init_xyzs,
                     physics=RPhys.PYB_GND_DRAG_DW, pyb_freq=240,
                     ctrl_freq=48, gui=False, obstacles=False,
                     user_debug_gui=False)
    env.reset()
    hover = env.HOVER_RPM

    n_steps = 240
    t = np.arange(n_steps)[:, None, None]
    actions = hover * (1.0 + 0.01 * np.sin(0.02 * t)) * np.ones(
        (n_steps, 2, 4))

    ref_obs = np.zeros((n_steps, 2, 20))
    for i in range(n_steps):
        obs, *_ = env.step(actions[i])
        ref_obs[i] = obs
    env.close()

    cfg = core.AviaryConfig(
        drone=P.CF2X, num_drones=2, physics=Physics.PYB_GND_DRAG_DW,
        pyb_freq=240, ctrl_freq=48,
        init_xyzs=tuple(map(tuple, init_xyzs)))
    _, my_obs, *_ = _my_rollout(cfg, tasks.CtrlTask(), actions)

    np.testing.assert_allclose(my_obs[:, :, 0:3], ref_obs[:, :, 0:3],
                               atol=1e-7, err_msg="pos")
    np.testing.assert_allclose(my_obs[:, :, 10:13], ref_obs[:, :, 10:13],
                               atol=1e-7, err_msg="vel")
    np.testing.assert_allclose(my_obs[:, :, 13:16], ref_obs[:, :, 13:16],
                               atol=1e-6, err_msg="ang_v")


def test_pyb_contact_vs_reference(ref):
    """CtrlAviary(PYB): landing, tilted settling, and drone-drone contact.

    The reference executes verbatim over the shim's Bullet-algorithm
    stepSimulation (PGS impulse contact, gyroscopic term) while both drones
    free-fall at zero RPM: drone 0 lands tilted (roll 0.3) and is righted
    by the 4-point rim manifold; drone 1 falls onto drone 0's bounding
    sphere (pair contact) before sliding off to the plane.  My PYB env
    must reproduce the trajectories — this quantifies the JAX solver vs
    the independent NumPy implementation of the same documented algorithm
    (reference force plumbing BaseAviary.py:679-711; contact scope per
    PARITY.md).
    """
    from gym_pybullet_drones.envs.CtrlAviary import CtrlAviary
    RDrone, RPhys = _ref_enums(ref)

    init_xyzs = np.array([[0.0, 0.0, 0.3], [0.05, 0.0, 0.6]])
    init_rpys = np.array([[0.3, 0.0, 0.0], [0.0, 0.0, 0.0]])
    env = CtrlAviary(drone_model=RDrone.CF2X, num_drones=2,
                     initial_xyzs=init_xyzs, initial_rpys=init_rpys,
                     physics=RPhys.PYB, pyb_freq=240, ctrl_freq=48,
                     gui=False, obstacles=False, user_debug_gui=False)
    env.reset()

    n_steps = 96   # 2 s: impact, righting, settling
    actions = np.zeros((n_steps, 2, 4))
    ref_obs = np.zeros((n_steps, 2, 20))
    for i in range(n_steps):
        obs, *_ = env.step(actions[i])
        ref_obs[i] = obs
    env.close()

    cfg = core.AviaryConfig(
        drone=P.CF2X, num_drones=2, physics=Physics.PYB,
        pyb_freq=240, ctrl_freq=48,
        init_xyzs=tuple(map(tuple, init_xyzs)),
        init_rpys=tuple(map(tuple, init_rpys)))
    _, my_obs, *_ = _my_rollout(cfg, tasks.CtrlTask(), actions)

    np.testing.assert_allclose(my_obs[:, :, 0:3], ref_obs[:, :, 0:3],
                               atol=1e-6, err_msg="pos")
    np.testing.assert_allclose(my_obs[:, :, 10:13], ref_obs[:, :, 10:13],
                               atol=1e-5, err_msg="vel")
    np.testing.assert_allclose(my_obs[:, :, 13:16], ref_obs[:, :, 13:16],
                               atol=1e-4, err_msg="ang_v")
    # physical end state: both drones at rest on the plane, righted
    z_rest = P.CF2X.collision_z_offset + P.CF2X.collision_h / 2
    assert abs(ref_obs[-1, 0, 2] - z_rest) < 5e-3
    assert abs(my_obs[-1, 0, 2] - z_rest) < 5e-3
    assert abs(my_obs[-1, 0, 7]) < 0.05      # roll righted from 0.3


def test_pyb_contact_vs_reference_racer(ref):
    """RACE-model landing parity (different mass/inertia/geometry scale)."""
    from gym_pybullet_drones.envs.CtrlAviary import CtrlAviary
    RDrone, RPhys = _ref_enums(ref)

    init_xyzs = np.array([[0.0, 0.0, 0.4]])
    init_rpys = np.array([[0.0, 0.2, 0.0]])
    env = CtrlAviary(drone_model=RDrone.RACE, num_drones=1,
                     initial_xyzs=init_xyzs, initial_rpys=init_rpys,
                     physics=RPhys.PYB, pyb_freq=240, ctrl_freq=48,
                     gui=False, obstacles=False, user_debug_gui=False)
    env.reset()
    n_steps = 72
    actions = np.zeros((n_steps, 1, 4))
    ref_obs = np.zeros((n_steps, 1, 20))
    for i in range(n_steps):
        obs, *_ = env.step(actions[i])
        ref_obs[i] = obs
    env.close()

    cfg = core.AviaryConfig(
        drone=P.RACE, num_drones=1, physics=Physics.PYB,
        pyb_freq=240, ctrl_freq=48,
        init_xyzs=tuple(map(tuple, init_xyzs)),
        init_rpys=tuple(map(tuple, init_rpys)))
    _, my_obs, *_ = _my_rollout(cfg, tasks.CtrlTask(), actions)
    np.testing.assert_allclose(my_obs[:, :, 0:3], ref_obs[:, :, 0:3],
                               atol=1e-6, err_msg="pos")
    np.testing.assert_allclose(my_obs[:, :, 10:13], ref_obs[:, :, 10:13],
                               atol=1e-5, err_msg="vel")


def test_pyb_contact_solver_iteration_convergence(ref):
    """Bound the 4-sweep PGS truncation against PyBullet's default 50.

    ADVICE.md round 2 (medium): the shim previously pinned
    _SOLVER_ITERATIONS = 4 'to match ops/rigid_body.SOLVER_ITERATIONS',
    making the parity oracle self-referential on that choice.  This test
    runs the SAME reference contact scenario (landing + tilted righting +
    drone-drone contact) through the shim at 4 and at 50 PGS sweeps and
    MEASURES the truncation effect.  Result (recorded in PARITY.md): the
    multi-contact impact ticks do NOT fully converge in 4 sweeps — the
    trajectories drift apart by up to ~2.2 mm / ~2 cm/s over the 2 s
    scenario — but both settle to the same resting equilibrium.  The
    asserted bounds below are that measurement; PYB parity claims
    therefore carry a ~mm-scale iteration-truncation term relative to a
    fully-converged (Bullet-default) solve.
    """
    from gym_pybullet_drones.envs.CtrlAviary import CtrlAviary
    import pybullet as shim_pb
    RDrone, RPhys = _ref_enums(ref)

    init_xyzs = np.array([[0.0, 0.0, 0.3], [0.05, 0.0, 0.6]])
    init_rpys = np.array([[0.3, 0.0, 0.0], [0.0, 0.0, 0.0]])
    n_steps = 96
    actions = np.zeros((n_steps, 2, 4))

    def run(iterations):
        old = shim_pb._SOLVER_ITERATIONS
        shim_pb._SOLVER_ITERATIONS = iterations
        try:
            env = CtrlAviary(drone_model=RDrone.CF2X, num_drones=2,
                             initial_xyzs=init_xyzs, initial_rpys=init_rpys,
                             physics=RPhys.PYB, pyb_freq=240, ctrl_freq=48,
                             gui=False, obstacles=False,
                             user_debug_gui=False)
            env.reset()
            out = np.zeros((n_steps, 2, 20))
            for i in range(n_steps):
                obs, *_ = env.step(actions[i])
                out[i] = obs
            env.close()
            return out
        finally:
            shim_pb._SOLVER_ITERATIONS = old

    obs4 = run(4)
    obs50 = run(50)
    # whole-trajectory truncation bound (measured ~2.2e-3 m / ~2e-2 m/s)
    np.testing.assert_allclose(obs4[:, :, 0:3], obs50[:, :, 0:3],
                               atol=5e-3, err_msg="pos: 4 vs 50 sweeps")
    # velocity: the impact impulse can resolve one tick earlier/later at
    # different sweep counts, producing isolated one-tick spikes — bound
    # the bulk at the 99th percentile and cap the spikes
    dv = np.abs(obs4[:, :, 10:13] - obs50[:, :, 10:13])
    assert np.percentile(dv, 99) < 5e-2, \
        f"vel p99 {np.percentile(dv, 99):.3g}: 4 vs 50 sweeps"
    assert dv.max() < 0.5, f"vel spike {dv.max():.3g}: 4 vs 50 sweeps"
    # both converge to the same resting equilibrium: identical resting
    # HEIGHT (same Baumgarte penetration depth) and both at rest — the
    # impact differences displace the post-collision slide by ~mm in xy,
    # which is trajectory, not equilibrium
    np.testing.assert_allclose(obs4[-12:, :, 2], obs50[-12:, :, 2],
                               atol=5e-4, err_msg="resting height")
    assert np.abs(obs4[-12:, :, 10:13]).max() < 5e-3, "4-sweep not at rest"
    assert np.abs(obs50[-12:, :, 10:13]).max() < 5e-3, "50-sweep not at rest"


def test_pyb_contact_50_sweep_parity(ref):
    """Bullet-default converged solve: cfg.solver_iterations=50 tracks the
    reference (executed over the shim at 50 PGS sweeps) as tightly as the
    default-4 path does — the iteration count is now a user-facing
    AviaryConfig knob on the XLA path, so the mm-scale truncation term of
    PARITY.md (e) can be removed entirely when wanted (PyBullet
    numSolverIterations default = 50)."""
    from gym_pybullet_drones.envs.CtrlAviary import CtrlAviary
    import pybullet as shim_pb
    RDrone, RPhys = _ref_enums(ref)

    init_xyzs = np.array([[0.0, 0.0, 0.3], [0.05, 0.0, 0.6]])
    init_rpys = np.array([[0.3, 0.0, 0.0], [0.0, 0.0, 0.0]])
    n_steps = 96
    actions = np.zeros((n_steps, 2, 4))

    old = shim_pb._SOLVER_ITERATIONS
    shim_pb._SOLVER_ITERATIONS = 50
    try:
        env = CtrlAviary(drone_model=RDrone.CF2X, num_drones=2,
                         initial_xyzs=init_xyzs, initial_rpys=init_rpys,
                         physics=RPhys.PYB, pyb_freq=240, ctrl_freq=48,
                         gui=False, obstacles=False, user_debug_gui=False)
        env.reset()
        ref_obs = np.zeros((n_steps, 2, 20))
        for i in range(n_steps):
            obs, *_ = env.step(actions[i])
            ref_obs[i] = obs
        env.close()
    finally:
        shim_pb._SOLVER_ITERATIONS = old

    cfg = core.AviaryConfig(
        drone=P.CF2X, num_drones=2, physics=Physics.PYB,
        pyb_freq=240, ctrl_freq=48,
        init_xyzs=tuple(map(tuple, init_xyzs)),
        init_rpys=tuple(map(tuple, init_rpys)),
        solver_iterations=50)
    _, my_obs, *_ = _my_rollout(cfg, tasks.CtrlTask(), actions)
    np.testing.assert_allclose(my_obs[:, :, 0:3], ref_obs[:, :, 0:3],
                               atol=1e-6, err_msg="pos @ 50 sweeps")
    np.testing.assert_allclose(my_obs[:, :, 10:13], ref_obs[:, :, 10:13],
                               atol=1e-5, err_msg="vel @ 50 sweeps")


def test_obstacle_scene_parity_vs_reference(ref):
    """CtrlAviary(obstacles=True): contact against the reference's obstacle
    bodies (BaseAviary._addObstacles:955-978 — duck/cube/sphere2 loaded
    around the origin), executed verbatim.

    One drone free-falls onto sphere2's top (0, 2, r=0.5), one onto
    cube_no_rotation's top face (-0.5, -2.5, 1 m box).  SCOPE (VERDICT
    round-3 next #8): the 1e-6 agreement verifies PLUMBING + SOLVER, not
    mesh geometry — cube/sphere2 are exact primitives in both stacks, but
    the duck is modeled as the SAME r=0.06 bounding sphere in the engine
    and in the shim oracle, because real Bullet loads duck_vhacd.urdf's
    VHACD convex decomposition from pybullet_data, whose mesh assets are
    not available offline (there is no ground truth to transcribe a
    tighter hull from).  Practical impact is low — the duck sits at
    (-.5,-.5,.05), away from both test flight paths — and the bound is
    recorded in PARITY.md.  This test pins the JAX solver against the
    shim's independent NumPy solve of the same scene, closing VERDICT
    round-2 "Missing #3" (obstacles=True was never compared).
    """
    from gym_pybullet_drones.envs.CtrlAviary import CtrlAviary
    RDrone, RPhys = _ref_enums(ref)

    init_xyzs = np.array([[0.0, 2.0, 1.35], [-0.5, -2.5, 1.5]])
    init_rpys = np.zeros((2, 3))
    env = CtrlAviary(drone_model=RDrone.CF2X, num_drones=2,
                     initial_xyzs=init_xyzs, initial_rpys=init_rpys,
                     physics=RPhys.PYB, pyb_freq=240, ctrl_freq=48,
                     gui=False, obstacles=True, user_debug_gui=False)
    env.reset()
    n_steps = 96
    actions = np.zeros((n_steps, 2, 4))
    ref_obs = np.zeros((n_steps, 2, 20))
    for i in range(n_steps):
        obs, *_ = env.step(actions[i])
        ref_obs[i] = obs
    env.close()

    from gym_pybullet_drones_tpu.envs.gym_adapter import OBSTACLE_SPHERES
    cfg = core.AviaryConfig(
        drone=P.CF2X, num_drones=2, physics=Physics.PYB,
        pyb_freq=240, ctrl_freq=48,
        init_xyzs=tuple(map(tuple, init_xyzs)),
        init_rpys=tuple(map(tuple, init_rpys)),
        obstacles=OBSTACLE_SPHERES)
    _, my_obs, *_ = _my_rollout(cfg, tasks.CtrlTask(), actions)

    np.testing.assert_allclose(my_obs[:, :, 0:3], ref_obs[:, :, 0:3],
                               atol=1e-6, err_msg="pos")
    np.testing.assert_allclose(my_obs[:, :, 10:13], ref_obs[:, :, 10:13],
                               atol=1e-5, err_msg="vel")
    # both drones actually rested ON their obstacles (not the floor)
    assert ref_obs[-1, 0, 2] > 0.9   # on sphere2 (top ~1.0)
    assert ref_obs[-1, 1, 2] > 0.9   # on the 1 m cube
