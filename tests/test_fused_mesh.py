"""The multi-device configuration of the fused kernel: the fully-fused
rollout under a device mesh (make_fused_rollout(mesh=...)).

These tests build it on the virtual 8-device CPU mesh (conftest) with the
kernel in the Pallas interpreter and assert the sharded step is BITWISE
equal to the unsharded fused step: the kernel math is elementwise along the
env-lane axis (drones couple across ROWS within a lane, never across
lanes), so any deviation — not just a large one — is a partitioning bug in
the (rows, envs)-lane carry sharding (envs/fast.py make_fused_rollout,
parallel/mesh.py _env_sharding).

Reference counterpart: the per-drone loops this layer replaces,
/root/reference/gym_pybullet_drones/envs/BaseAviary.py:343-372.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from gym_pybullet_drones_tpu import params as P
from gym_pybullet_drones_tpu.envs import (
    AviaryConfig, HoverTask, make_routing_config)
from gym_pybullet_drones_tpu.envs.fast import make_fused_rollout
from gym_pybullet_drones_tpu.ops.pallas_fused import BLOCK
from gym_pybullet_drones_tpu.parallel import make_mesh
from gym_pybullet_drones_tpu.utils.enums import ActionType, Physics


def _compare_sharded_vs_unsharded(cfg, task, n_dev, steps, scale=0.3):
    """Run the fused kernel sharded over n_dev devices and unsharded on the
    SAME global batch with identical action streams; assert bitwise-equal
    outputs + carry.  Two kernel blocks per shard: the Pallas interpreter
    compiles a one-program grid differently from a looped one (other FMA
    contractions), which a one-block shard would compare against."""
    B = 2 * BLOCK * n_dev
    mesh = make_mesh(jax.devices()[:n_dev])
    n = cfg.num_drones
    _, act_dim = task.action_buffer_shape(cfg)

    s_reset, s_step = make_fused_rollout(cfg, task, B, mesh=mesh,
                                         interpret=True)
    u_reset, u_step = make_fused_rollout(cfg, task, B, interpret=True)
    sc, sobs = s_reset()
    uc, uobs = u_reset()
    np.testing.assert_array_equal(np.asarray(sobs), np.asarray(uobs))

    ss = jax.jit(s_step)
    us = jax.jit(u_step)
    keys = jax.random.split(jax.random.PRNGKey(0), steps)
    for t in range(steps):
        a = scale * jax.random.normal(keys[t], (B, n, act_dim), jnp.float32)
        sc, so, sr, ste, strn = ss(sc, a)
        uc, uo, ur, ute, utrn = us(uc, a)
        np.testing.assert_array_equal(np.asarray(sr), np.asarray(ur),
                                      err_msg=f"reward t={t}")
        np.testing.assert_array_equal(np.asarray(ste), np.asarray(ute))
        np.testing.assert_array_equal(np.asarray(strn), np.asarray(utrn))
        np.testing.assert_array_equal(np.asarray(so), np.asarray(uo),
                                      err_msg=f"obs t={t}")
        np.testing.assert_array_equal(np.asarray(sc), np.asarray(uc),
                                      err_msg=f"carry t={t}")
    # the sharded carry must actually live on all n_dev devices, env-lanes
    # partitioned (PartitionSpec(None, 'data') — parallel/mesh.py)
    assert len(sc.sharding.device_set) == n_dev
    shard_shapes = {s.data.shape for s in sc.addressable_shards}
    assert shard_shapes == {(sc.shape[0], sc.shape[1] // n_dev)}


def test_fused_mesh_hover_dyn():
    """Hover-DYN-RPM, one block of envs per device over 8 devices."""
    cfg = AviaryConfig(drone=P.CF2X, num_drones=1, physics=Physics.DYN,
                       pyb_freq=240, ctrl_freq=30)
    _compare_sharded_vs_unsharded(cfg, HoverTask(act=ActionType.RPM),
                                  n_dev=8, steps=3)


def test_fused_mesh_routing_pyb():
    """Routing (embedded PID + adjacency obs; DYN physics, the fused
    kernel's) sharded.  2 drones / 2 control steps keeps the
    interpret-mode trace ~half the 3-drone cost while still crossing the
    action-ring push and adjacency-obs paths;
    sharding is drone-count-independent (the mesh partitions env LANES,
    drones couple only across rows within a lane), and the 3-drone routing
    kernel itself stays covered unsharded in
    tests/test_fused.py::test_fused_routing_parity."""
    cfg, task = make_routing_config(num_drones=2, spacing=0.4,
                                    physics=Physics.DYN)
    _compare_sharded_vs_unsharded(cfg, task, n_dev=8, steps=2, scale=0.5)


def test_fused_mesh_uneven_batch_rejected():
    """Every shard must hold a whole number of kernel blocks."""
    cfg = AviaryConfig(drone=P.CF2X, num_drones=1, physics=Physics.DYN,
                       pyb_freq=240, ctrl_freq=30)
    mesh = make_mesh(jax.devices()[:8])
    with pytest.raises(ValueError, match="whole blocks"):
        make_fused_rollout(cfg, HoverTask(act=ActionType.RPM),
                           BLOCK * 8 + 8, mesh=mesh, interpret=True)
