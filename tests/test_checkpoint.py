"""Checkpoint/resume: training resumes bit-exactly from a saved state."""
import numpy as np

import jax
import jax.numpy as jnp

from gym_pybullet_drones_tpu import params as P
from gym_pybullet_drones_tpu.envs import AviaryConfig, HoverTask
from gym_pybullet_drones_tpu.parallel import (
    make_mesh, make_sharded_update, shard_train_state)
from gym_pybullet_drones_tpu.rl import PPOConfig, make_train
from gym_pybullet_drones_tpu.utils.checkpoint import (
    restore_checkpoint, save_checkpoint)
from gym_pybullet_drones_tpu.utils.enums import ActionType, Physics


def test_checkpoint_roundtrip_resume(tmp_path):
    cfg = AviaryConfig(drone=P.CF2X, num_drones=1, physics=Physics.DYN,
                       pyb_freq=240, ctrl_freq=30)
    task = HoverTask(act=ActionType.RPM)
    ppo = PPOConfig(num_envs=4, rollout_steps=8, num_minibatches=2,
                    update_epochs=1)
    init, update, _, _ = make_train(cfg, task, ppo)
    upd = jax.jit(update)
    ts = init(jax.random.key(0))
    ts, _ = upd(ts)

    path = save_checkpoint(str(tmp_path / "ckpt"), ts)
    target = ts._replace(key=jax.random.key_data(ts.key))
    target = jax.tree.map(np.zeros_like, target)
    target = target._replace(key=jax.random.wrap_key_data(
        jnp.asarray(target.key)))
    restored = restore_checkpoint(path, target)
    a_leaves = jax.tree.leaves(ts._replace(key=jax.random.key_data(ts.key)))
    b_leaves = jax.tree.leaves(
        restored._replace(key=jax.random.key_data(restored.key)))
    for a, b in zip(a_leaves, b_leaves):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # continuing from original vs restored is identical
    a1, m1 = upd(ts)
    a2, m2 = upd(restored)
    for x, y in zip(jax.tree.leaves(a1.params), jax.tree.leaves(a2.params)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert float(m1["mean_reward"]) == float(m2["mean_reward"])


def test_sharded_checkpoint_roundtrip_resume(tmp_path):
    """Sharded-resume path: save a TrainState whose env
    batch is SHARDED over the 8-device mesh after 2 sharded updates,
    restore into a fresh learner, re-shard, continue 1 update, and assert
    the continuation is bit-identical to a no-restart run.

    Reference counterpart: SB3 model.save / PPO.load
    (reference gym_pybullet_drones/examples/learn.py:84-120) — which saves
    only the policy; here the checkpoint carries the full run state
    (sharded env batch, optimizer, PRNG key, update counter).
    """
    cfg = AviaryConfig(drone=P.CF2X, num_drones=1, physics=Physics.DYN,
                       pyb_freq=240, ctrl_freq=30)
    task = HoverTask(act=ActionType.RPM)
    ppo = PPOConfig(num_envs=16, rollout_steps=8, num_minibatches=2,
                    update_epochs=1)
    mesh = make_mesh(jax.devices())
    init, update, _, _ = make_train(cfg, task, ppo, mesh=mesh)
    supd = make_sharded_update(update, mesh)
    ts = shard_train_state(init(jax.random.key(0)), mesh)
    for _ in range(2):
        ts, _ = supd(ts)
    env_leaf = jax.tree.leaves(ts.env_state)[0]
    assert len(env_leaf.sharding.device_set) == 8  # genuinely sharded save

    path = save_checkpoint(str(tmp_path / "ckpt_sharded"), ts)
    ref_ts, ref_m = supd(ts)  # no-restart continuation

    # fresh context: rebuild the learner from scratch, restore into a
    # zeroed host-side target, re-shard onto the mesh, continue
    init2, update2, _, _ = make_train(cfg, task, ppo, mesh=mesh)
    target = init2(jax.random.key(1))
    target = target._replace(key=jax.random.key_data(target.key))
    target = jax.tree.map(lambda x: np.zeros_like(np.asarray(x)), target)
    target = target._replace(
        key=jax.random.wrap_key_data(jnp.asarray(target.key)))
    restored = restore_checkpoint(path, target)
    restored = shard_train_state(restored, mesh)
    assert int(restored.update_idx) == 2
    new_ts, m = make_sharded_update(update2, mesh)(restored)

    for x, y in zip(jax.tree.leaves(ref_ts.params),
                    jax.tree.leaves(new_ts.params)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    for x, y in zip(jax.tree.leaves(ref_ts.env_state),
                    jax.tree.leaves(new_ts.env_state)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    for k in ref_m:
        assert float(ref_m[k]) == float(m[k]), k
    assert len(jax.tree.leaves(new_ts.env_state)[0]
               .sharding.device_set) == 8
