"""Device-mesh sharding for multi-device training.

The reference has no distributed layer at all (SURVEY.md §2.4: single
process, `make_vec_env(n_envs=1)`); its scale-out counterpart here is
data-parallel environment sharding: the env batch axis is laid out across a
1-D `("data",)` mesh (the cards of a host are joined all to all, so one
axis serves; multi-host extends the same axis via jax.distributed),
policy/optimizer parameters are replicated, and XLA inserts the gradient
all-reduce (NCCL on GPUs) over the mesh where the minibatch loss reduces
over the global batch.
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gym_pybullet_drones_tpu.rl.ppo import TrainState


def make_mesh(devices=None, axis_name: str = "data") -> Mesh:
    """1-D mesh over the given (default: all) devices."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (axis_name,))


def _env_sharding(env_state, mesh: Mesh, axis_name: str) -> NamedSharding:
    """Sharding for env-state leaves.  EnvState pytrees carry the env axis
    leading; the fused rollout carry (ops/pallas_fused.py) is a single
    (rows, envs) block with envs in the LANE (trailing) axis."""
    if not isinstance(env_state, tuple):     # packed fused carry
        return NamedSharding(mesh, P(None, axis_name))
    return NamedSharding(mesh, P(axis_name))


def shard_train_state(ts: TrainState, mesh: Mesh,
                      axis_name: str = "data") -> TrainState:
    """Place a TrainState onto the mesh: env axis sharded, rest replicated."""
    data = NamedSharding(mesh, P(axis_name))
    env = _env_sharding(ts.env_state, mesh, axis_name)
    repl = NamedSharding(mesh, P())
    env_state = jax.tree.map(lambda x: jax.device_put(x, env), ts.env_state)
    last_obs = jax.device_put(ts.last_obs, data)
    params = jax.tree.map(lambda x: jax.device_put(x, repl), ts.params)
    opt_state = jax.tree.map(lambda x: jax.device_put(x, repl), ts.opt_state)
    key = jax.device_put(ts.key, repl)
    update_idx = jax.device_put(ts.update_idx, repl)
    return TrainState(params=params, opt_state=opt_state,
                      env_state=env_state, last_obs=last_obs, key=key,
                      update_idx=update_idx)


def make_sharded_update(update_fn, mesh: Mesh, axis_name: str = "data"):
    """jit the PPO update with env-batch sharding constraints over the mesh.

    The input TrainState must be placed with shard_train_state; XLA then
    partitions the rollout along the env axis and inserts the cross-shard
    all-reduce for the minibatch gradient (params stay replicated).
    """
    data = NamedSharding(mesh, P(axis_name))
    repl = NamedSharding(mesh, P())

    def constrained(ts: TrainState):
        env = _env_sharding(ts.env_state, mesh, axis_name)
        env_state = jax.tree.map(
            lambda x: jax.lax.with_sharding_constraint(x, env),
            ts.env_state)
        last_obs = jax.lax.with_sharding_constraint(ts.last_obs, data)
        ts = ts._replace(env_state=env_state, last_obs=last_obs)
        new_ts, metrics = update_fn(ts)
        env_state = jax.tree.map(
            lambda x: jax.lax.with_sharding_constraint(x, env),
            new_ts.env_state)
        new_ts = new_ts._replace(
            env_state=env_state,
            last_obs=jax.lax.with_sharding_constraint(new_ts.last_obs, data),
            params=jax.tree.map(
                lambda x: jax.lax.with_sharding_constraint(x, repl),
                new_ts.params))
        return new_ts, metrics

    return jax.jit(constrained)
