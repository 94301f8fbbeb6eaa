"""Environment layer tests: spaces, stepping semantics, tasks, auto-reset."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from gym_pybullet_drones_tpu import params as P
from gym_pybullet_drones_tpu.envs import (
    AviaryConfig, BatchedEnv, CtrlAviary, CtrlTask, HoverAviary, HoverTask,
    MultiHoverAviary, MultiHoverTask, VelocityAviary, next_waypoint, reset,
    step, step_autoreset)
from gym_pybullet_drones_tpu.utils.enums import ActionType, Physics

from tests import _oracle as oracle


def test_ctrl_aviary_dyn_matches_oracle():
    """CtrlAviary(DYN) ctrl-step == oracle substep loop + 20-dim state obs."""
    env = CtrlAviary(num_drones=2, physics=Physics.DYN, pyb_freq=240,
                     ctrl_freq=48)
    obs, _ = env.reset()
    assert obs.shape == (2, 20)
    # initial grid placement (reference BaseAviary.py:194-197)
    d = P.CF2X
    np.testing.assert_allclose(obs[1, 0:2], [4 * d.l, 4 * d.l], atol=1e-6)
    np.testing.assert_allclose(obs[:, 2], d.init_z, atol=1e-6)

    action = np.tile(d.hover_rpm * np.array([1.02, 1.0, 0.99, 1.0]), (2, 1))
    obs2, rew, term, trunc, _ = env.step(action)
    assert rew == -1.0 and not term and not trunc

    # oracle: 5 substeps per ctrl step at 240/48
    pos = np.asarray(env.INIT_XYZS[0], np.float64)
    quat = oracle.rpy_to_quat([0, 0, 0])
    vel = np.zeros(3)
    rates = np.zeros(3)
    for _ in range(5):
        pos, quat, vel, rates, angv = oracle.dyn_step(
            d, pos, quat, vel, rates, action[0], 1 / 240)
    np.testing.assert_allclose(obs2[0, 0:3], pos, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(obs2[0, 10:13], vel, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(obs2[0, 16:20], action[0], rtol=1e-6)


def test_rpm_clipping():
    env = CtrlAviary(num_drones=1, physics=Physics.DYN)
    env.reset()
    obs, *_ = env.step(np.full((1, 4), 1e9))
    assert np.all(obs[0, 16:20] <= env.MAX_RPM + 1)


def test_hover_aviary_api_and_reward():
    env = HoverAviary(physics=Physics.DYN)
    obs, info = env.reset()
    # 12 + (30//2)*4 = 72
    assert obs.shape == (1, 72)
    assert env.action_space.shape == (1, 4)
    a = np.zeros((1, 4), np.float32)
    obs, rew, term, trunc, _ = env.step(a)
    # drone starts near z=0.1125, target z=1 -> dist<~0.9 -> reward ~2-0.63
    dist = np.linalg.norm(np.array([0, 0, 1]) - obs[0, 0:3])
    np.testing.assert_allclose(rew, max(0, 2 - dist**4), rtol=1e-5)
    assert not term
    # action history: newest action is at the END of the obs tail
    np.testing.assert_allclose(obs[0, -4:], a[0], atol=1e-7)


def test_hover_truncation_on_timeout():
    env = HoverAviary(physics=Physics.DYN, ctrl_freq=30)
    env.reset()
    a = np.zeros((1, 4), np.float32)
    truncs = []
    for i in range(8 * 30 + 2):
        obs, r, te, tr, _ = env.step(a)
        truncs.append(tr)
        if tr:
            break
    # Timeout semantics (verified against the executed reference in
    # test_reference_parity): hooks see the PRE-increment step counter
    # (BaseAviary.py:376-382), so trunc first fires on the 242nd ctrl step
    # (i=241: counter=241*8 -> 241*8/240 > 8).
    assert truncs[-1]
    assert len(truncs) == 8 * 30 + 2


def test_hover_truncation_on_tilt_or_box():
    env = HoverAviary(physics=Physics.DYN, ctrl_freq=30)
    env.reset()
    # hard asymmetric action tips the drone over quickly (CF2X mixer:
    # x_torque ~ (f0 + f1 - f2 - f3), so [+,+,-,-] rolls hard)
    a = np.array([[1.0, 1.0, -1.0, -1.0]], np.float32)
    done = False
    for i in range(60):
        obs, r, te, tr, _ = env.step(a)
        if tr:
            done = True
            break
    assert done


def test_multihover_reward_sums():
    env = MultiHoverAviary(num_drones=2, physics=Physics.DYN)
    obs, _ = env.reset()
    assert obs.shape == (2, 72)
    _, rew, *_ = env.step(np.zeros((2, 4), np.float32))
    assert np.isscalar(rew) or rew.shape == ()
    assert 0 <= rew <= 4  # two drones, max 2 each


def test_velocity_aviary_tracks_direction():
    # PYB mode: the reference's default for closed-loop PID demos.  (In DYN
    # mode the reference's roll-torque sign is opposite the mixer's, an
    # upstream quirk both engines share, and the roll axis is unstable.)
    env = VelocityAviary(num_drones=1, physics=Physics.PYB, pyb_freq=240,
                         ctrl_freq=48)
    obs, _ = env.reset()
    # command +x at full fraction for 2 seconds
    a = np.array([[1.0, 0.0, 0.0, 1.0]], np.float32)
    for _ in range(96):
        obs, *_ = env.step(a)
    assert obs[0, 0] > 0.15  # moved in +x
    vx = obs[0, 10]
    assert vx > 0.1
    # speed limited: 0.03 * 30 km/h = 0.25 m/s
    assert vx < 0.3


def test_next_waypoint():
    cur = jnp.asarray([0.0, 0.0, 0.0])
    dst = jnp.asarray([10.0, 0.0, 0.0])
    np.testing.assert_allclose(np.asarray(next_waypoint(cur, dst, 1.0)),
                               [1, 0, 0], atol=1e-7)
    near = jnp.asarray([9.5, 0.0, 0.0])
    np.testing.assert_allclose(np.asarray(next_waypoint(near, dst, 1.0)),
                               [10, 0, 0], atol=1e-7)


def test_batched_env_autoreset():
    cfg = AviaryConfig(drone=P.CF2X, num_drones=1, physics=Physics.DYN,
                       pyb_freq=240, ctrl_freq=30)
    task = HoverTask(act=ActionType.RPM)
    benv = BatchedEnv(cfg, task, num_envs=8)
    state, obs = benv.reset()
    assert obs.shape == (8, 1, 72)
    # full-throttle tilt crashes some envs; ensure state stays finite and
    # auto-reset returns to init
    a = jnp.tile(jnp.asarray([[1.0, 1.0, -1.0, -1.0]], jnp.float32),
                 (8, 1, 1))
    for _ in range(80):
        state, obs, r, te, tr = benv.step(state, a)
    assert bool(jnp.all(jnp.isfinite(obs)))
    # after truncation the env restarts near the spawn point
    assert bool(jnp.all(state.pos[..., 2] < 2.5))


def test_physics_modes_compile_and_run():
    for phys in [Physics.PYB, Physics.DYN, Physics.PYB_GND, Physics.PYB_DRAG,
                 Physics.PYB_DW, Physics.PYB_GND_DRAG_DW]:
        cfg = AviaryConfig(drone=P.CF2X, num_drones=2, physics=phys,
                           pyb_freq=240, ctrl_freq=48)
        task = CtrlTask()
        st, obs, _ = reset(cfg, task)
        rpm = jnp.full((2, 4), P.CF2X.hover_rpm)
        st, obs, r, te, tr, _ = jax.jit(
            lambda s, a: step(cfg, task, s, a))(st, rpm)
        assert bool(jnp.all(jnp.isfinite(obs)))


def test_pyb_mode_ground_contact():
    """In PYB mode a powered-off drone falls to the ground and rests there."""
    cfg = AviaryConfig(drone=P.CF2X, num_drones=1, physics=Physics.PYB,
                       pyb_freq=240, ctrl_freq=240)
    task = CtrlTask()
    st, obs, _ = reset(cfg, task)
    zero = jnp.zeros((1, 4))
    stepper = jax.jit(lambda s: step(cfg, task, s, zero)[0])
    for _ in range(240):
        st = stepper(st)
    z = float(st.pos[0, 2])
    assert 0.0 <= z < 0.05  # resting on the plane, not through it
    assert abs(float(st.vel[0, 2])) < 1e-2


def test_gym_registration():
    import gymnasium as gym
    import gym_pybullet_drones_tpu  # noqa: F401
    env = gym.make("hover-aviary-v0", physics=Physics.DYN)
    obs, info = env.reset()
    assert obs.shape == (1, 72)


def test_pyb_obstacle_collision():
    """A drone flying into a static obstacle sphere is stopped at contact."""
    cfg = AviaryConfig(drone=P.CF2X, num_drones=1, physics=Physics.PYB,
                       pyb_freq=240, ctrl_freq=240,
                       init_xyzs=((0.0, 1.4, 0.5),),
                       obstacles=((0.0, 2.0, 0.5, 0.5),))
    task = CtrlTask()
    st, obs, _ = reset(cfg, task)
    st = st._replace(vel=st.vel.at[0, 1].set(2.0))  # fly toward obstacle
    rpm = jnp.full((1, 4), P.CF2X.hover_rpm)
    stepper = jax.jit(lambda s: step(cfg, task, s, rpm)[0])
    for _ in range(240):
        st = stepper(st)
    # stopped outside the obstacle's surface (0.5 + collision_r margin)
    dist = float(jnp.linalg.norm(st.pos[0] - jnp.asarray([0.0, 2.0, 0.5])))
    assert dist > 0.5
    assert float(st.pos[0, 1]) < 2.0


def test_pyb_drone_drone_collision():
    """Two drones on a head-on course separate instead of passing through."""
    cfg = AviaryConfig(drone=P.CF2X, num_drones=2, physics=Physics.PYB,
                       pyb_freq=240, ctrl_freq=240,
                       init_xyzs=((0.0, -0.2, 0.5), (0.0, 0.2, 0.5)))
    task = CtrlTask()
    st, obs, _ = reset(cfg, task)
    st = st._replace(vel=jnp.asarray([[0.0, 1.0, 0.0], [0.0, -1.0, 0.0]],
                                     st.vel.dtype))
    rpm = jnp.full((2, 4), P.CF2X.hover_rpm)
    stepper = jax.jit(lambda s: step(cfg, task, s, rpm)[0])
    min_sep = 1.0
    for _ in range(120):
        st = stepper(st)
        min_sep = min(min_sep,
                      float(jnp.linalg.norm(st.pos[0] - st.pos[1])))
    # never interpenetrate beyond the sphere contact distance
    assert min_sep > 0.9 * 2 * P.CF2X.collision_r
    # inelastic: the approach is absorbed, drones do not tunnel through
    assert float(st.pos[0, 1]) < float(st.pos[1, 1])


def test_pyb_drone_drone_collision_tumbles():
    """A glancing drone-drone collision spins both bodies (angular response).

    Bullet's convex pair contact exerts torque through the contact lever
    arm; the old bounding-sphere center-line model translated only.  Two
    drones pass with a small height offset: the cylinder-manifold contact
    must leave both with angular velocity, while conserving linear and
    angular momentum (Jacobi pair impulses are antisymmetric).
    """
    from gym_pybullet_drones_tpu.ops.rigid_body import (
        resolve_drone_collisions)
    d = P.CF2X
    dt = 1.0 / 240.0
    pos = jnp.array([[0.0, -0.05, 0.5], [0.0, 0.05, 0.52]])
    vel = jnp.array([[0.0, 1.0, 0.0], [0.0, -1.0, 0.0]])
    quat = jnp.tile(jnp.asarray([0.0, 0.0, 0.0, 1.0]), (2, 1))
    ang_v = jnp.zeros((2, 3))
    _, v2, w2 = resolve_drone_collisions(d, pos, vel, dt, quat=quat,
                                         ang_v=ang_v)
    # tumble: nonzero spin about x on both bodies
    assert abs(float(w2[0, 0])) > 0.5
    assert abs(float(w2[1, 0])) > 0.5
    # linear momentum conserved exactly (equal masses)
    np.testing.assert_allclose(np.asarray(v2.sum(0)), 0.0, atol=1e-6)
    # angular momentum about the pair midpoint conserved
    mid = 0.5 * (pos[0] + pos[1])
    J = np.diag([d.ixx, d.iyy, d.izz])
    L0 = sum(np.cross(np.asarray(pos[i] - mid), d.m * np.asarray(vel[i]))
             for i in range(2))
    L1 = sum(np.cross(np.asarray(pos[i] - mid), d.m * np.asarray(v2[i]))
             + J @ np.asarray(w2[i]) for i in range(2))
    np.testing.assert_allclose(L1, L0, atol=1e-7)
    # level same-height head-on: symmetric, no spin (friction vt = 0,
    # lever arm parallel to the normal)
    pos_l = jnp.array([[0.0, -0.05, 0.5], [0.0, 0.05, 0.5]])
    _, v3, w3 = resolve_drone_collisions(d, pos_l, vel, dt, quat=quat,
                                         ang_v=ang_v)
    np.testing.assert_allclose(np.asarray(w3), 0.0, atol=1e-9)


def test_solver_iterations_knob():
    """cfg.solver_iterations: 50 sweeps converge at least as well as 4 on
    a landing scenario (same resting height), and the fast path falls back
    to XLA / the fused kernel rejects non-default counts (its PGS unroll
    is compiled at 4)."""
    from gym_pybullet_drones_tpu.envs.fast import (
        make_batched_step, make_fused_rollout)

    def land(iters):
        cfg = AviaryConfig(drone=P.CF2X, num_drones=1, physics=Physics.PYB,
                           pyb_freq=240, ctrl_freq=48,
                           init_xyzs=((0.0, 0.0, 0.3),),
                           init_rpys=((0.3, 0.0, 0.0),),
                           solver_iterations=iters)
        task = CtrlTask()
        st, _, _ = reset(cfg, task)
        stepper = jax.jit(lambda s: step(cfg, task, s,
                                         jnp.zeros((1, 4)))[0])
        for _ in range(96):
            st = stepper(st)
        return st

    s4, s50 = land(4), land(50)
    z_rest = P.CF2X.collision_z_offset + P.CF2X.collision_h / 2
    assert abs(float(s4.pos[0, 2]) - z_rest) < 5e-3
    assert abs(float(s50.pos[0, 2]) - z_rest) < 5e-3
    # both at rest, righted from the initial 0.3 roll
    assert float(jnp.abs(s50.vel).max()) < 5e-3

    cfg50 = AviaryConfig(drone=P.CF2X, num_drones=1, physics=Physics.PYB,
                         pyb_freq=240, ctrl_freq=48, solver_iterations=50)
    # the batched XLA step runs any sweep count
    reset_fn, step_fn = make_batched_step(cfg50, CtrlTask(), 2,
                                          autoreset=False)
    st, obs = reset_fn(seed=0)
    st, obs, *_ = step_fn(st, jnp.full((2, 1, 4), P.CF2X.hover_rpm))
    assert obs.shape[0] == 2
    # the fused one-launch kernel refuses PYB physics altogether
    import pytest as _pytest
    from gym_pybullet_drones_tpu.envs.tasks import HoverTask
    with _pytest.raises(ValueError, match="DYN"):
        make_fused_rollout(
            AviaryConfig(drone=P.CF2X, num_drones=1, physics=Physics.PYB,
                         pyb_freq=240, ctrl_freq=30, solver_iterations=50),
            HoverTask(act=ActionType.RPM), 128, interpret=True)


def test_randomized_resets_decorrelate_envs():
    """RLTask reset noise gives distinct per-env starts; default is exact."""
    import dataclasses
    cfg = AviaryConfig(drone=P.CF2X, num_drones=1, physics=Physics.DYN,
                       pyb_freq=240, ctrl_freq=30)
    noisy = HoverTask(act=ActionType.RPM, reset_pos_noise=0.2,
                      reset_rpy_noise=0.1)
    benv = BatchedEnv(cfg, noisy, num_envs=16)
    state, obs = benv.reset(seed=3)
    spread = float(jnp.std(state.pos[:, 0, 0]))
    assert spread > 0.01  # x positions differ across envs

    # default task: deterministic reference parity
    plain = HoverTask(act=ActionType.RPM)
    benv2 = BatchedEnv(cfg, plain, num_envs=16)
    s2, _ = benv2.reset(seed=3)
    assert float(jnp.std(s2.pos[:, 0, 0])) == 0.0
    np.testing.assert_allclose(np.asarray(s2.pos[0, 0, 2]), P.CF2X.init_z,
                               atol=1e-6)

    # auto-reset re-randomizes from the carried rng: run noisy envs to
    # truncation and check positions differ again after the reset
    a = jnp.tile(jnp.asarray([[1.0, 1.0, -1.0, -1.0]], jnp.float32),
                 (16, 1, 1))
    state_n = state
    for _ in range(60):
        state_n, obs_n, r, te, tr = benv.step(state_n, a)
    assert float(jnp.std(state_n.pos[:, 0, 0])) > 0.001


def test_pyb_box_obstacle_collision():
    """Box obstacles: side approach stops at the face + bounding-sphere
    margin; flight above the box top is unobstructed
    (reference cube_no_rotation.urdf body, BaseAviary._addObstacles:969-973)."""
    box = (0.0, 2.0, 0.5, 0.5, 0.5, 0.5)   # 1 m cube centered at y=2
    cfg = AviaryConfig(drone=P.CF2X, num_drones=1, physics=Physics.PYB,
                       pyb_freq=240, ctrl_freq=240,
                       init_xyzs=((0.0, 1.2, 0.5),),
                       obstacles=(box,))
    task = CtrlTask()
    st, obs, _ = reset(cfg, task)
    st = st._replace(vel=st.vel.at[0, 1].set(2.0))  # fly toward the box
    rpm = jnp.full((1, 4), P.CF2X.hover_rpm)
    stepper = jax.jit(lambda s: step(cfg, task, s, rpm)[0])
    for _ in range(240):
        st = stepper(st)
    # stopped at the -y face: y <= 2 - 0.5 - collision_r
    assert float(st.pos[0, 1]) <= 2.0 - 0.5 - P.CF2X.collision_r + 1e-5
    assert float(st.pos[0, 1]) > 1.2   # it did advance to the face

    # same flight 1 m higher clears the box (top at z=1.0 + margin)
    cfg2 = AviaryConfig(drone=P.CF2X, num_drones=1, physics=Physics.PYB,
                        pyb_freq=240, ctrl_freq=240,
                        init_xyzs=((0.0, 1.2, 1.2),),
                        obstacles=(box,))
    st2, _, _ = reset(cfg2, task)
    st2 = st2._replace(vel=st2.vel.at[0, 1].set(2.0))
    stepper2 = jax.jit(lambda s: step(cfg2, task, s, rpm)[0])
    for _ in range(240):
        st2 = stepper2(st2)
    assert float(st2.pos[0, 1]) > 2.6  # flew past the box


def test_pyb_box_obstacle_rest_on_top():
    """A drone descending onto a box comes to rest on its top face."""
    box = (0.0, 0.0, 0.5, 0.5, 0.5, 0.5)
    cfg = AviaryConfig(drone=P.CF2X, num_drones=1, physics=Physics.PYB,
                       pyb_freq=240, ctrl_freq=240,
                       init_xyzs=((0.0, 0.0, 1.5),),
                       obstacles=(box,))
    task = CtrlTask()
    st, _, _ = reset(cfg, task)
    rpm = jnp.zeros((1, 4))   # free fall onto the box
    stepper = jax.jit(lambda s: step(cfg, task, s, rpm)[0])
    for _ in range(480):
        st = stepper(st)
    # resting at z ~ box_top + collision_r
    z = float(st.pos[0, 2])
    assert abs(z - (1.0 + P.CF2X.collision_r)) < 0.02
    assert abs(float(st.vel[0, 2])) < 0.05
