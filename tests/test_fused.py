"""Fully-fused rollout kernel (ops/pallas_fused.py, run in the Pallas
interpreter): step-for-step parity with the envs/fast.py batched path,
including auto-reset semantics."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from gym_pybullet_drones_tpu import params as P
from gym_pybullet_drones_tpu.envs import (
    AviaryConfig, HoverTask, MultiHoverTask)
from gym_pybullet_drones_tpu.envs.fast import (
    fused_ineligibility, make_batched_step, make_env_step,
    make_fused_rollout, select_env_path)
from gym_pybullet_drones_tpu.utils.enums import ActionType, Physics


def _compare(cfg, task, B, steps, key=0, scale=0.3, atol=2e-5):
    n = cfg.num_drones
    buf_len, act_dim = task.action_buffer_shape(cfg)
    f_reset, f_step = make_fused_rollout(cfg, task, B, obs_layout="flat",
                                        interpret=True)
    r_reset, r_step = make_batched_step(cfg, task, B, obs_layout="flat")
    fc, fobs = f_reset()
    rs, robs = r_reset()
    np.testing.assert_allclose(np.asarray(fobs), np.asarray(robs),
                               atol=atol)
    keys = jax.random.split(jax.random.PRNGKey(key), steps)
    fs = jax.jit(f_step)
    rsj = jax.jit(r_step)
    any_done = False
    for t in range(steps):
        a = scale * jax.random.normal(keys[t], (B, n, act_dim), jnp.float32)
        fc, fo, fr, fte, ftr = fs(fc, a)
        rs, ro, rr, rte, rtr = rsj(rs, a)
        np.testing.assert_allclose(np.asarray(fr), np.asarray(rr),
                                   rtol=1e-4, atol=atol, err_msg=f"t={t}")
        np.testing.assert_array_equal(np.asarray(fte), np.asarray(rte))
        np.testing.assert_array_equal(np.asarray(ftr), np.asarray(rtr))
        np.testing.assert_allclose(np.asarray(fo), np.asarray(ro),
                                   rtol=1e-4, atol=atol, err_msg=f"t={t}")
        any_done |= bool(jnp.any(fte | ftr))
    return any_done


def test_fused_hover_parity():
    cfg = AviaryConfig(drone=P.CF2X, num_drones=1, physics=Physics.DYN,
                       pyb_freq=240, ctrl_freq=30)
    _compare(cfg, HoverTask(act=ActionType.RPM), 8, steps=6)


def test_fused_hover_autoreset_parity():
    """Large random actions tumble drones -> truncations -> resets."""
    cfg = AviaryConfig(drone=P.CF2X, num_drones=1, physics=Physics.DYN,
                       pyb_freq=240, ctrl_freq=30)
    any_done = _compare(cfg, HoverTask(act=ActionType.RPM), 8, steps=10,
                        scale=1.0)
    assert any_done  # the parity run actually exercised auto-reset


def test_fused_multihover_parity():
    cfg = AviaryConfig(drone=P.CF2X, num_drones=2, physics=Physics.DYN,
                       pyb_freq=240, ctrl_freq=30)
    any_done = _compare(cfg, MultiHoverTask(act=ActionType.RPM), 4,
                        steps=10, scale=0.8)
    assert any_done


def test_fused_one_d_rpm():
    cfg = AviaryConfig(drone=P.CF2X, num_drones=1, physics=Physics.DYN,
                       pyb_freq=240, ctrl_freq=30)
    _compare(cfg, HoverTask(act=ActionType.ONE_D_RPM), 8, steps=4)


def test_fused_pyb_physics_parity():
    """PYB-family physics (ground contact + aero) is not the fused kernel's:
    the path rule sends it to the XLA batched step, which steps it."""
    cfg = AviaryConfig(drone=P.CF2X, num_drones=2,
                       physics=Physics.PYB_GND_DRAG_DW,
                       pyb_freq=240, ctrl_freq=60,
                       init_xyzs=((0.0, 0.0, 0.08), (0.05, 0.0, 0.6)))
    task = MultiHoverTask(act=ActionType.RPM)
    assert "DYN" in fused_ineligibility(cfg, task)
    with pytest.raises(ValueError, match="DYN"):
        make_fused_rollout(cfg, task, 4, interpret=True)
    path, reset_fn, step_fn = make_env_step(cfg, task, 4, interpret=True)
    assert path == "batched"
    state, obs = reset_fn()
    a = 0.05 * jax.random.normal(jax.random.PRNGKey(0), (4, 2, 4))
    state, obs, r, te, tr = jax.jit(step_fn)(state, a)
    assert obs.shape == (4, 2 * task.obs_dim(cfg))
    assert bool(jnp.all(jnp.isfinite(obs)))


def test_fused_pid_action_parity():
    """Embedded DSL-PID runs in-kernel (9 carry rows per drone)."""
    cfg = AviaryConfig(drone=P.CF2X, num_drones=1, physics=Physics.DYN,
                       pyb_freq=240, ctrl_freq=30)
    _compare(cfg, HoverTask(act=ActionType.ONE_D_PID), 8, steps=6,
             scale=0.3, atol=5e-5)


def test_fused_vel_action_parity():
    cfg = AviaryConfig(drone=P.CF2X, num_drones=1, physics=Physics.DYN,
                       pyb_freq=240, ctrl_freq=30)
    _compare(cfg, HoverTask(act=ActionType.VEL), 8, steps=6,
             scale=0.3, atol=5e-5)


def test_fused_routing_parity():
    """RoutingTask: PID waypoint actions + DYN physics + extra obs rows."""
    from gym_pybullet_drones_tpu.envs import make_routing_config
    cfg, task = make_routing_config(num_drones=3, spacing=0.4,
                                    physics=Physics.DYN)
    _compare(cfg, task, 4, steps=6, scale=0.3, atol=5e-5)


def test_fused_rejects_ineligible():
    cfg = AviaryConfig(drone=P.CF2X, num_drones=1, physics=Physics.DYN,
                       pyb_freq=240, ctrl_freq=30)
    from gym_pybullet_drones_tpu.utils.enums import ObservationType
    with pytest.raises(ValueError):
        make_fused_rollout(
            cfg, HoverTask(act=ActionType.RPM, reset_pos_noise=0.1), 8,
            interpret=True)
    with pytest.raises(ValueError):
        make_fused_rollout(
            cfg, HoverTask(act=ActionType.RPM, obs=ObservationType.RGB), 8,
            interpret=True)
    # off the GPU the kernel runs only in the interpreter, and only when
    # the caller asks for it; the path rule then picks the XLA step
    with pytest.raises(ValueError, match="GPU"):
        make_fused_rollout(cfg, HoverTask(act=ActionType.RPM), 8)
    assert select_env_path(cfg, HoverTask(act=ActionType.RPM)) == "batched"
    assert select_env_path(cfg, HoverTask(act=ActionType.RPM),
                           interpret=True) == "fused"
    assert fused_ineligibility(
        cfg, HoverTask(act=ActionType.RPM), jnp.float64) is not None
