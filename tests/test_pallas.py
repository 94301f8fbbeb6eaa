"""The fused kernel's row bodies (ops/rows.py) and the XLA batched step
(envs/fast.make_batched_step) against the core XLA kernels."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from gym_pybullet_drones_tpu import params as P
from gym_pybullet_drones_tpu.ops import rows
from gym_pybullet_drones_tpu.ops.dynamics import DynState, dyn_step
from gym_pybullet_drones_tpu.envs import AviaryConfig, HoverTask
from gym_pybullet_drones_tpu.envs.fast import make_batched_step
from gym_pybullet_drones_tpu.utils.enums import ActionType, Physics

from tests import _oracle as oracle

DT = 1 / 240


def _rand_state(B, seed=0):
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(B, 3)) * 0.3 + [0, 0, 1]
    quat = np.stack([oracle.rpy_to_quat(rng.normal(size=3) * 0.2)
                     for _ in range(B)])
    vel = rng.normal(size=(B, 3)) * 0.3
    rates = rng.normal(size=(B, 3))
    f32 = lambda a: jnp.asarray(a, jnp.float32)
    return DynState(pos=f32(pos), quat=f32(quat), vel=f32(vel),
                    rpy_rates=f32(rates),
                    ang_v=jnp.zeros((B, 3), jnp.float32)), rng


def _row_dyn_step(model, st, n_sub, rpm):
    """rows._motor_mix + rows._dyn_substeps on (B,) component vectors."""
    comps = tuple(st.pos.T) + tuple(st.quat.T) + tuple(st.vel.T) \
        + tuple(st.rpy_rates.T)
    out = rows._dyn_substeps(model, n_sub, DT, comps,
                             *rows._motor_mix(model, *rpm.T))
    col = lambda i, j: jnp.stack(out[i:j], axis=-1)
    return DynState(pos=col(0, 3), quat=col(3, 7), vel=col(7, 10),
                    rpy_rates=col(10, 13), ang_v=col(13, 16))


def test_pallas_matches_xla_ctrl_step():
    model = P.CF2X
    B = 8
    st, rng = _rand_state(B)
    rpm = jnp.asarray(model.hover_rpm * (1 + 0.02 * rng.normal(size=(B, 4))),
                      jnp.float32)
    ref = st
    for _ in range(8):
        ref = dyn_step(model, ref, rpm, DT)
    out = _row_dyn_step(model, st, 8, rpm)
    for name in ("pos", "quat", "vel", "rpy_rates", "ang_v"):
        np.testing.assert_allclose(
            np.asarray(getattr(out, name)), np.asarray(getattr(ref, name)),
            rtol=2e-5, atol=2e-5, err_msg=name)


def test_pallas_matches_xla_cf2p_and_race():
    """Model-dependent torque composition (CF2P mixer arms, RACE z-sign)."""
    for model in (P.CF2P, P.RACE):
        B = 4
        st, rng = _rand_state(B, seed=11)
        rpm = jnp.asarray(
            model.hover_rpm * (1 + 0.02 * rng.normal(size=(B, 4))),
            jnp.float32)
        ref = st
        for _ in range(4):
            ref = dyn_step(model, ref, rpm, DT)
        out = _row_dyn_step(model, st, 4, rpm)
        for name in ("pos", "quat", "vel", "rpy_rates"):
            np.testing.assert_allclose(
                np.asarray(getattr(out, name)),
                np.asarray(getattr(ref, name)),
                rtol=2e-5, atol=2e-5, err_msg=f"{model.model}:{name}")


def test_pallas_zero_omega_branch():
    model = P.CF2X
    st = DynState(pos=jnp.zeros((4, 3), jnp.float32),
                  quat=jnp.tile(jnp.asarray([0, 0, 0, 1], jnp.float32),
                                (4, 1)),
                  vel=jnp.zeros((4, 3), jnp.float32),
                  rpy_rates=jnp.zeros((4, 3), jnp.float32),
                  ang_v=jnp.zeros((4, 3), jnp.float32))
    rpm = jnp.full((4, 4), model.hover_rpm, jnp.float32)
    out = _row_dyn_step(model, st, 8, rpm)
    # hover: quaternion unchanged, z stays 0 (hover rpm balances gravity)
    np.testing.assert_allclose(np.asarray(out.quat), np.asarray(st.quat),
                               atol=1e-7)
    np.testing.assert_allclose(np.asarray(out.pos[:, 2]), 0.0, atol=1e-5)


def test_fast_batched_step_matches_core():
    cfg = AviaryConfig(drone=P.CF2X, num_drones=1, physics=Physics.DYN,
                       pyb_freq=240, ctrl_freq=30)
    task = HoverTask(act=ActionType.RPM)
    B = 4
    reset_fn, step_fn = make_batched_step(cfg, task, B)
    state, obs = reset_fn(seed=0)
    a = jnp.asarray(0.05 * np.random.default_rng(0).normal(size=(B, 1, 4)),
                    jnp.float32)
    s2, obs2, r2, te2, tr2 = jax.jit(step_fn)(state, a)

    # core path from the SAME per-env keys (the fast carry is flattened,
    # so rebuild the (B, N, ...) state independently)
    from gym_pybullet_drones_tpu.envs import core
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    cstate, cobs, _ = jax.vmap(
        lambda k: core.reset(cfg, task, key=k))(keys)
    np.testing.assert_allclose(np.asarray(obs), np.asarray(cobs))
    vstep = jax.vmap(lambda s, a: core.step_autoreset(cfg, task, s, a))
    s3, obs3, r3, te3, tr3, _ = vstep(cstate, a)
    np.testing.assert_allclose(np.asarray(obs2), np.asarray(obs3),
                               rtol=3e-5, atol=3e-5)
    np.testing.assert_allclose(np.asarray(r2), np.asarray(r3), rtol=1e-4)


def test_row_euler_matches_quat_to_rpy():
    """rows.quat_rpy_rows (the kernel's Euler extraction) vs ops/quat,
    including un-normalized quaternions."""
    from gym_pybullet_drones_tpu.ops import quat as quat_ops
    rng = np.random.default_rng(9)
    q = rng.normal(size=(512, 4)).astype(np.float32)
    q[:4] = [[0, 0, 0, 1], [0, 0, 0, 3.0], [0.3, 0, 0, 2.0],
             [0.5, 0.5, 0.5, 0.5]]
    got = np.stack(rows.quat_rpy_rows(*jnp.asarray(q).T), axis=-1)
    ref = np.asarray(quat_ops.quat_to_rpy(jnp.asarray(q)))
    # away from gimbal lock (|pitch| < 1.5, where roll and yaw are
    # ill-conditioned) the angles agree to float32 rounding
    ok = np.abs(ref[:, 1]) < 1.5
    assert ok.sum() > 400
    np.testing.assert_allclose(got[ok], ref[ok], atol=2e-5)


def test_pallas_pid_kernel_matches_xla_chain():
    """Row PID tick + DYN substeps vs dsl_pid.compute_control + dyn_step."""
    from gym_pybullet_drones_tpu.control import dsl_pid
    model = P.CF2X
    B = 16
    st, rng = _rand_state(B, seed=4)
    pid = dsl_pid.PIDState(
        last_rpy=jnp.asarray(rng.normal(size=(B, 3)) * 0.05, jnp.float32),
        integral_pos_e=jnp.asarray(rng.normal(size=(B, 3)) * 0.01,
                                   jnp.float32),
        integral_rpy_e=jnp.asarray(rng.normal(size=(B, 3)) * 0.1,
                                   jnp.float32))
    tp = jnp.asarray(rng.normal(size=(B, 3)) * 0.5 + [0, 0, 1], jnp.float32)
    trpy = jnp.asarray(np.concatenate(
        [np.zeros((B, 2)), rng.normal(size=(B, 1)) * 0.5], axis=-1),
        jnp.float32)
    tv = jnp.asarray(rng.normal(size=(B, 3)) * 0.2, jnp.float32)
    trr = jnp.zeros((B, 3), jnp.float32)

    ctrl_dt, n_sub = 1 / 30, 8
    state_rows = tuple(st.pos.T) + tuple(st.quat.T) + tuple(st.vel.T) \
        + tuple(st.rpy_rates.T)
    pid_rows = tuple(pid.last_rpy.T) + tuple(pid.integral_pos_e.T) \
        + tuple(pid.integral_rpy_e.T)
    tgt_rows = tuple(tp.T) + tuple(trpy.T) + tuple(tv.T) + tuple(trr.T)
    rpm_rows, new_rows = rows._pid_tick(model, ctrl_dt, state_rows,
                                        pid_rows, tgt_rows)
    rpm = jnp.stack(rpm_rows, axis=-1)
    out = _row_dyn_step(model, st, n_sub, rpm)
    col = lambda i, j: jnp.stack(new_rows[i:j], axis=-1)
    new_pid = dsl_pid.PIDState(last_rpy=col(0, 3), integral_pos_e=col(3, 6),
                               integral_rpy_e=col(6, 9))

    rpm_ref, pid_ref, _, _ = dsl_pid.compute_control(
        model, pid, ctrl_dt, cur_pos=st.pos, cur_quat=st.quat,
        cur_vel=st.vel, target_pos=tp, target_rpy=trpy, target_vel=tv,
        target_rpy_rates=trr)
    ref = st
    for _ in range(n_sub):
        ref = dyn_step(model, ref, rpm_ref, DT)
    np.testing.assert_allclose(np.asarray(rpm), np.asarray(rpm_ref),
                               rtol=2e-5, atol=0.5)  # rpm ~ 1e4 scale
    for name in ("pos", "quat", "vel", "rpy_rates", "ang_v"):
        np.testing.assert_allclose(
            np.asarray(getattr(out, name)), np.asarray(getattr(ref, name)),
            rtol=3e-4, atol=3e-5, err_msg=name)
    for name in ("last_rpy", "integral_pos_e", "integral_rpy_e"):
        np.testing.assert_allclose(
            np.asarray(getattr(new_pid, name)),
            np.asarray(getattr(pid_ref, name)),
            rtol=3e-4, atol=2e-5, err_msg=name)


def test_fast_routing_task_matches_core():
    """Flat pre (embedded PID) + flat post (extra obs cols) vs vmapped core."""
    from gym_pybullet_drones_tpu.envs import core
    from gym_pybullet_drones_tpu.envs.routing import make_routing_config
    cfg, task = make_routing_config(num_drones=3, physics=Physics.DYN)
    B = 4
    reset_fn, step_fn = make_batched_step(cfg, task, B)
    state, obs = reset_fn(seed=0)
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    cstate, cobs, _ = jax.vmap(lambda k: core.reset(cfg, task, key=k))(keys)
    np.testing.assert_allclose(np.asarray(obs), np.asarray(cobs))

    rng = np.random.default_rng(7)
    vstep = jax.vmap(lambda s, a: core.step_autoreset(cfg, task, s, a))
    for _ in range(3):
        a = jnp.asarray(rng.normal(size=(B, 3, 3)), jnp.float32)
        state, obs2, r2, te2, tr2 = step_fn(state, a)
        cstate, obs3, r3, te3, tr3, _ = vstep(cstate, a)
        np.testing.assert_allclose(np.asarray(obs2), np.asarray(obs3),
                                   rtol=3e-4, atol=3e-5)
        np.testing.assert_allclose(np.asarray(r2), np.asarray(r3),
                                   rtol=1e-3, atol=1e-4)
        np.testing.assert_array_equal(np.asarray(te2), np.asarray(te3))
        np.testing.assert_array_equal(np.asarray(tr2), np.asarray(tr3))


def test_fast_vel_action_matches_core():
    """Flat embedded-PID VEL action mapping vs the vmapped core path."""
    from gym_pybullet_drones_tpu.envs import core
    cfg = AviaryConfig(drone=P.CF2X, num_drones=1, physics=Physics.DYN,
                       pyb_freq=240, ctrl_freq=30)
    task = HoverTask(act=ActionType.VEL)
    B = 4
    reset_fn, step_fn = make_batched_step(cfg, task, B)
    state, obs = reset_fn(seed=0)
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    cstate, _, _ = jax.vmap(lambda k: core.reset(cfg, task, key=k))(keys)
    vstep = jax.vmap(lambda s, a: core.step_autoreset(cfg, task, s, a))
    rng = np.random.default_rng(3)
    for _ in range(3):
        a = jnp.asarray(rng.normal(size=(B, 1, 4)), jnp.float32)
        state, obs2, r2, *_ = step_fn(state, a)
        cstate, obs3, r3, *_ = vstep(cstate, a)
        np.testing.assert_allclose(np.asarray(obs2), np.asarray(obs3),
                                   rtol=3e-4, atol=3e-5)
        np.testing.assert_allclose(np.asarray(r2), np.asarray(r3),
                                   rtol=1e-3, atol=1e-4)


def test_fast_ctrl_task_flat_post():
    """CtrlTask 20-dim obs through the flat fast path vs vmapped core."""
    from gym_pybullet_drones_tpu.envs import core
    from gym_pybullet_drones_tpu.envs.tasks import CtrlTask
    cfg = AviaryConfig(drone=P.CF2X, num_drones=2, physics=Physics.DYN,
                       pyb_freq=240, ctrl_freq=48)
    task = CtrlTask()
    B = 3
    reset_fn, step_fn = make_batched_step(cfg, task, B, autoreset=False)
    state, obs = reset_fn(seed=0)
    assert obs.shape == (B, 2, 20)
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    cstate, _, _ = jax.vmap(lambda k: core.reset(cfg, task, key=k))(keys)
    vstep = jax.vmap(lambda s, a: core.step(cfg, task, s, a)[:3])
    rng = np.random.default_rng(5)
    for _ in range(2):
        a = jnp.asarray(P.CF2X.hover_rpm
                        * (1 + 0.01 * rng.normal(size=(B, 2, 4))),
                        jnp.float32)
        state, obs2, r2, *_ = step_fn(state, a)
        cstate, obs3, r3 = vstep(cstate, a)
        np.testing.assert_allclose(np.asarray(obs2), np.asarray(obs3),
                                   rtol=3e-5, atol=3e-5)


def _compare_fast_vs_core(cfg, task, B, adim, steps=3, seed=2,
                          scale=1.0, rtol=3e-4, atol=5e-4):
    from gym_pybullet_drones_tpu.envs import core
    reset_fn, step_fn = make_batched_step(cfg, task, B)
    state, obs = reset_fn(seed=0)
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    cstate, cobs, _ = jax.vmap(lambda k: core.reset(cfg, task, key=k))(keys)
    np.testing.assert_allclose(np.asarray(obs), np.asarray(cobs))
    vstep = jax.vmap(lambda s, a: core.step_autoreset(cfg, task, s, a))
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        a = jnp.asarray(scale * rng.normal(size=(B, cfg.num_drones, adim)),
                        jnp.float32)
        state, o2, r2, te2, tr2 = step_fn(state, a)
        cstate, o3, r3, te3, tr3, _ = vstep(cstate, a)
        np.testing.assert_allclose(np.asarray(o2), np.asarray(o3),
                                   rtol=rtol, atol=atol)
        np.testing.assert_allclose(np.asarray(r2), np.asarray(r3),
                                   rtol=1e-3, atol=1e-3)


def test_pallas_env_pyb_rpm_matches_core():
    """Envs-in-lanes kernel: PYB physics + contact, RPM actions, N=2.

    240/120 Hz -> 2 substeps: interpret-mode execution of the unrolled
    kernel is expensive on CPU; 2 substeps already cover the cross-substep
    (stale-drag, contact-after-integrate) semantics.
    """
    from gym_pybullet_drones_tpu.envs import MultiHoverTask
    cfg = AviaryConfig(drone=P.CF2X, num_drones=2, physics=Physics.PYB,
                       pyb_freq=240, ctrl_freq=120)
    _compare_fast_vs_core(cfg, MultiHoverTask(act=ActionType.RPM), 2, 4,
                          steps=2, scale=0.05)


def test_pallas_env_all_aero_matches_core():
    """PYB_GND_DRAG_DW: ground effect + stale-action drag + downwash."""
    from gym_pybullet_drones_tpu.envs import MultiHoverTask
    cfg = AviaryConfig(drone=P.CF2X, num_drones=2,
                       physics=Physics.PYB_GND_DRAG_DW,
                       pyb_freq=240, ctrl_freq=120,
                       init_xyzs=((0.0, 0.0, 0.08), (0.02, 0.0, 0.6)))
    _compare_fast_vs_core(cfg, MultiHoverTask(act=ActionType.RPM), 2, 4,
                          steps=2, scale=0.05)


def test_pallas_env_pyb_pid_routing_matches_core():
    """Routing's DEFAULT config (PYB + embedded PID) through the fused
    envs-in-lanes kernel."""
    from gym_pybullet_drones_tpu.envs.routing import make_routing_config
    cfg, task = make_routing_config(num_drones=2, ctrl_freq=120)
    _compare_fast_vs_core(cfg, task, 2, 3, steps=2, rtol=1e-3, atol=1e-3)


def test_pallas_env_obstacle_matches_core():
    """Static obstacle pushout inside the kernel vs the XLA core path."""
    from gym_pybullet_drones_tpu.envs.tasks import CtrlTask
    cfg = AviaryConfig(drone=P.CF2X, num_drones=1, physics=Physics.PYB,
                       pyb_freq=240, ctrl_freq=120,
                       init_xyzs=((0.0, 1.82, 0.5),),
                       obstacles=((0.0, 2.0, 0.5, 0.1),))
    task = CtrlTask()
    from gym_pybullet_drones_tpu.envs import core
    B = 2
    reset_fn, step_fn = make_batched_step(cfg, task, B, autoreset=False)
    state, _ = reset_fn()
    state = state._replace(
        vel=jnp.tile(jnp.asarray([[0.0, 1.5, 0.0]], jnp.float32), (B, 1)))
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    cstate, _, _ = jax.vmap(lambda k: core.reset(cfg, task, key=k))(keys)
    cstate = cstate._replace(
        vel=jnp.tile(jnp.asarray([[[0.0, 1.5, 0.0]]], jnp.float32),
                     (B, 1, 1)))
    vstep = jax.vmap(lambda s, a: core.step(cfg, task, s, a)[0])
    rpm = jnp.full((B, 1, 4), P.CF2X.hover_rpm, jnp.float32)
    stepper = jax.jit(lambda s: step_fn(s, rpm)[0])
    for _ in range(12):
        state = stepper(state)
        cstate = vstep(cstate, rpm)
    np.testing.assert_allclose(np.asarray(state.pos),
                               np.asarray(cstate.pos.reshape(B, 3)),
                               rtol=1e-4, atol=1e-4)
    assert float(state.pos[0, 1]) < 2.0  # stopped at the obstacle


def test_fast_batched_step_multidrone():
    """Fast path with num_drones=2 (flattened env*drone pallas batch)."""
    cfg = AviaryConfig(drone=P.CF2X, num_drones=2, physics=Physics.DYN,
                       pyb_freq=240, ctrl_freq=30)
    from gym_pybullet_drones_tpu.envs import MultiHoverTask
    task = MultiHoverTask(act=ActionType.RPM)
    B = 3
    reset_fn, step_fn = make_batched_step(cfg, task, B)
    state, obs = reset_fn(seed=0)
    a = jnp.asarray(0.03 * np.random.default_rng(1).normal(size=(B, 2, 4)),
                    jnp.float32)
    s2, obs2, r2, te2, tr2 = jax.jit(step_fn)(state, a)

    from gym_pybullet_drones_tpu.envs import core
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    cstate, _, _ = jax.vmap(lambda k: core.reset(cfg, task, key=k))(keys)
    vstep = jax.vmap(lambda s, a: core.step_autoreset(cfg, task, s, a))
    s3, obs3, r3, *_ = vstep(cstate, a)
    np.testing.assert_allclose(np.asarray(obs2), np.asarray(obs3),
                               rtol=3e-5, atol=3e-5)
    np.testing.assert_allclose(np.asarray(r2), np.asarray(r3), rtol=1e-4)


def test_pallas_env_box_obstacle_matches_core():
    """Box-obstacle pushout inside the kernel vs the XLA core path."""
    from gym_pybullet_drones_tpu.envs.tasks import CtrlTask
    cfg = AviaryConfig(drone=P.CF2X, num_drones=1, physics=Physics.PYB,
                       pyb_freq=240, ctrl_freq=120,
                       init_xyzs=((0.0, 1.82, 0.5),),
                       obstacles=((0.0, 2.5, 0.5, 0.5, 0.5, 0.5),))
    task = CtrlTask()
    from gym_pybullet_drones_tpu.envs import core
    B = 2
    reset_fn, step_fn = make_batched_step(cfg, task, B, autoreset=False)
    state, _ = reset_fn()
    state = state._replace(
        vel=jnp.tile(jnp.asarray([[0.0, 1.5, 0.0]], jnp.float32), (B, 1)))
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    cstate, _, _ = jax.vmap(lambda k: core.reset(cfg, task, key=k))(keys)
    cstate = cstate._replace(
        vel=jnp.tile(jnp.asarray([[[0.0, 1.5, 0.0]]], jnp.float32),
                     (B, 1, 1)))
    vstep = jax.vmap(lambda s, a: core.step(cfg, task, s, a)[0])
    rpm = jnp.full((B, 1, 4), P.CF2X.hover_rpm, jnp.float32)
    stepper = jax.jit(lambda s: step_fn(s, rpm)[0])
    for _ in range(16):
        state = stepper(state)
        cstate = vstep(cstate, rpm)
    np.testing.assert_allclose(np.asarray(state.pos),
                               np.asarray(cstate.pos.reshape(B, 3)),
                               rtol=1e-4, atol=1e-4)
    # stopped at the -y face of the box (y = 2.0) + bounding-sphere margin
    assert float(state.pos[0, 1]) <= 2.0 - P.CF2X.collision_r + 1e-5


_ROW_PYB_CASES = {
    "sphere": (dict(num_drones=1, physics=Physics.PYB,
                    init_xyzs=((0.0, 1.82, 0.5),),
                    obstacles=((0.0, 2.0, 0.5, 0.1),)), (0.0, 1.5, 0.0)),
    "box": (dict(num_drones=1, physics=Physics.PYB,
                 init_xyzs=((0.0, 1.82, 0.5),),
                 obstacles=((0.0, 2.5, 0.5, 0.5, 0.5, 0.5),)),
            (0.0, 1.5, 0.0)),
    "aero-pair": (dict(num_drones=2, physics=Physics.PYB_GND_DRAG_DW,
                       init_xyzs=((0.0, 0.0, 0.08), (0.03, 0.0, 0.15))),
                  (0.2, 0.0, -0.3)),
}


@pytest.mark.parametrize("case", sorted(_ROW_PYB_CASES))
def test_row_pyb_substep_matches_core(case):
    """The PYB family runs on the XLA batched step (the fused kernel covers
    DYN only): its flattened, drone-coupled control step — aero, ground and
    obstacle contact, drone-drone contact — vs the vmapped core step."""
    from gym_pybullet_drones_tpu.envs import core
    from gym_pybullet_drones_tpu.envs.tasks import CtrlTask
    kw, vel = _ROW_PYB_CASES[case]
    cfg = AviaryConfig(drone=P.CF2X, pyb_freq=240, ctrl_freq=30, **kw)
    n, B = cfg.num_drones, 3
    rng = np.random.default_rng(4)
    reset_fn, step_fn = make_batched_step(cfg, CtrlTask(), B,
                                          autoreset=False)
    state, _ = reset_fn(seed=0)
    state = state._replace(vel=jnp.broadcast_to(
        jnp.asarray(vel, jnp.float32), state.vel.shape))
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    cstate, _, _ = jax.vmap(lambda k: core.reset(cfg, CtrlTask(), key=k))(
        keys)
    cstate = cstate._replace(vel=jnp.broadcast_to(
        jnp.asarray(vel, jnp.float32), cstate.vel.shape))
    rpm = jnp.asarray(P.CF2X.hover_rpm
                      * (1 + 0.05 * rng.normal(size=(B, n, 4))), jnp.float32)
    state = jax.jit(step_fn)(state, rpm)[0]
    cstate = jax.vmap(lambda s, a: core.step(cfg, CtrlTask(), s, a)[0])(
        cstate, rpm)
    for name in ("pos", "quat", "vel", "ang_v"):
        np.testing.assert_allclose(
            np.asarray(getattr(state, name)).reshape(B, n, -1),
            np.asarray(getattr(cstate, name)), rtol=1e-4, atol=1e-4,
            err_msg=name)
