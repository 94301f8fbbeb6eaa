"""The fused env-step kernel as the GPU compiles it.

On the CPU: every kernel configuration lowers, uninterpreted, to the Triton
custom call for CUDA (the card's own Triton compile cannot run here).  On a
GPU (`gpu` marker; chip_smoke.py runs these in its own process): the
compiled kernel steps like the XLA batched step at highest precision.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from gym_pybullet_drones_tpu import params as P
from gym_pybullet_drones_tpu.envs import (
    AviaryConfig, HoverTask, MultiHoverTask, make_routing_config)
from gym_pybullet_drones_tpu.envs import fast
from gym_pybullet_drones_tpu.utils.enums import ActionType, Physics


def _configs():
    def dyn(n):
        return AviaryConfig(drone=P.CF2X, num_drones=n, physics=Physics.DYN,
                            pyb_freq=240, ctrl_freq=30)
    return {
        "hover-dyn": (dyn(1), HoverTask(act=ActionType.RPM)),
        "hover-dyn-vel": (dyn(1), HoverTask(act=ActionType.VEL)),
        "multihover-dyn": (dyn(2), MultiHoverTask(act=ActionType.RPM)),
        "routing-dyn-pid": make_routing_config(num_drones=4,
                                               physics=Physics.DYN),
    }


CONFIGS = ("hover-dyn", "hover-dyn-vel", "multihover-dyn", "routing-dyn-pid")


@pytest.mark.parametrize("name,path", [
    ("hover-dyn", "fused"), ("hover-dyn-vel", "fused"),
    ("multihover-dyn", "fused"), ("routing-dyn-pid", "batched")])
def test_gpu_path_rule(name, path, monkeypatch):
    """On the GPU the rule takes the kernel where it was measured faster:
    up to FUSED_MAX_DRONES drones; 4-drone routing stays on XLA."""
    cfg, task = _configs()[name]
    monkeypatch.setattr(fast, "_platform", lambda: "gpu")
    assert fast.select_env_path(cfg, task) == path
    assert fast.fused_ineligibility(cfg, task) is None


@pytest.mark.parametrize("name", CONFIGS)
def test_fused_kernel_lowers_for_cuda(name, monkeypatch):
    cfg, task = _configs()[name]
    # build the uninterpreted step as it is built on a GPU
    monkeypatch.setattr(fast, "_platform", lambda: "gpu")
    reset_fn, step_fn = fast.make_fused_rollout(cfg, task, 4096)
    carry = reset_fn()[0]
    action = jnp.zeros((4096, cfg.num_drones, task.action_dim(cfg)))
    lowered = jax.jit(step_fn).trace(carry, action).lower(
        lowering_platforms=("cuda",))
    text = lowered.as_text()
    assert text.count("__gpu$xla.gpu.triton") == 1, "one kernel launch"
    assert "fused_env_step" in text


@pytest.mark.gpu
@pytest.mark.parametrize("name", CONFIGS)
def test_fused_kernel_matches_xla_on_card(name, gpu, num_envs=1000,
                                          steps=4):
    """Compiled kernel vs the XLA step at highest precision; an env count
    that is not a whole number of blocks exercises the masked lanes."""
    cfg, task = _configs()[name]
    f_reset, f_step = fast.make_fused_rollout(cfg, task, num_envs)
    x_reset, x_step = fast.make_batched_step(cfg, task, num_envs,
                                             obs_layout="flat")
    fc, xc = f_reset()[0], x_reset()[0]
    rng = np.random.default_rng(0)
    f_step = jax.jit(f_step)
    with jax.default_matmul_precision("highest"):
        x_step = jax.jit(x_step)
        for t in range(steps):
            a = jnp.asarray(0.1 * rng.standard_normal(
                (num_envs, cfg.num_drones, task.action_dim(cfg))),
                jnp.float32)
            fc, fo, fr, fte, ftr = f_step(fc, a)
            xc, xo, xr, xte, xtr = x_step(xc, a)
            np.testing.assert_array_equal(np.asarray(fte), np.asarray(xte))
            np.testing.assert_array_equal(np.asarray(ftr), np.asarray(xtr))
            # float32 rounding of two compilers; in the routing
            # configurations the embedded PID's attitude loop about doubles
            # it every step in the angular-rate observations (chip_smoke.py)
            np.testing.assert_allclose(np.asarray(fo), np.asarray(xo),
                                       rtol=1e-4, atol=5e-4, err_msg=f"t={t}")
            np.testing.assert_allclose(np.asarray(fr), np.asarray(xr),
                                       rtol=1e-4, atol=2e-4, err_msg=f"t={t}")
