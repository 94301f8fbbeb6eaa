"""Population-parallel PPO: K independent seeds/policies in ONE program.

A 17k-parameter MLP update is small work per op; vmapping K policies turns
every dense matmul into a K-batched GEMM and fuses all K rollouts into one
env-kernel launch of K*E environments, so the fixed per-op cost is paid
once for the whole population.

It also makes multi-seed robustness cheap: the reference's headline learning
claim ("learn.py reaches the solved threshold",
reference gym_pybullet_drones/examples/learn.py:78-97) is a property of a
SEED POPULATION, not of one lucky run — here every seed trains inside the
same XLA program, so a K-seed learning-curve artifact costs about one run
(scripts/train_population.py).

Scale-out: policies are embarrassingly parallel — there is no cross-policy
gradient reduction — so the population axis shards over the device mesh with
ZERO collectives.  `make_sharded_population_update` wraps the vmapped update
in shard_map over ("data",): each device trains K/D policies locally,
including the fused env kernel, and nothing crosses between devices.
"""
from __future__ import annotations

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gym_pybullet_drones_tpu.envs import core
from gym_pybullet_drones_tpu.rl.ppo import PPOConfig, make_train


def make_train_population(env_cfg: core.AviaryConfig, task, ppo: PPOConfig,
                          num_policies: int, **make_train_kwargs):
    """Build (init, update, evaluate, network) for K policies in one program.

    Thin jax.vmap lift of `make_train`: every TrainState leaf gains a
    leading (num_policies,) axis; `update` runs all K rollouts + optimizer
    steps in one launch; `evaluate` returns (K, num_envs) returns.  Each
    policy sees its own PRNG stream (init splits the seed key K ways), its
    own env batch, and its own optimizer state — results are independent
    per policy, exactly as K separate `make_train` runs would produce.

    `update.many(ts, n)` chains n updates per policy in one lax.scan (one
    host dispatch per chunk); `update.env_path`
    records the underlying env-step implementation ('fused' | 'batched').
    """
    init, update, evaluate, network = make_train(
        env_cfg, task, ppo, **make_train_kwargs)

    def pop_init(key: jax.Array):
        """K TrainStates from one seed key (split K ways), stacked."""
        return jax.vmap(init)(jax.random.split(key, num_policies))

    def pop_update(ts):
        return jax.vmap(update)(ts)

    def pop_update_many(ts, num_updates: int):
        return jax.vmap(lambda t: update.many(t, num_updates))(ts)

    def pop_evaluate(params, key, num_steps=None, episodic=False):
        keys = jax.random.split(key, num_policies)
        return jax.vmap(
            lambda p, k: evaluate(p, k, num_steps, episodic))(params, keys)

    pop_update.many = pop_update_many
    pop_update.env_path = update.env_path
    pop_update.num_policies = num_policies
    pop_update.single = update  # the per-policy update (for sharding wrap)
    return pop_init, pop_update, pop_evaluate, network


def shard_population(ts, mesh: Mesh, axis_name: str = "data"):
    """Lay the population TrainState out with the POLICY axis sharded.

    Every leaf carries the leading (num_policies,) axis after
    make_train_population's init, so one leading-axis sharding covers the
    whole pytree: params, optimizer state, env batches, and PRNG keys all
    split across devices by policy.  Nothing is replicated — the layout is
    D disjoint sub-populations.
    """
    lead = NamedSharding(mesh, P(axis_name))
    return jax.tree.map(lambda x: jax.device_put(x, lead), ts)


def make_sharded_population_update(pop_update, mesh: Mesh,
                                   axis_name: str = "data"):
    """jit the population update with the policy axis sharded over `mesh`.

    shard_map over ("data",): each device vmaps the single-policy update
    over its local K/D policies — the fused env kernel runs on local
    shapes with no GSPMD involvement, and since policies never communicate,
    the program contains ZERO collectives (contrast make_sharded_update,
    whose env-sharded layout all-reduces the minibatch gradient).  Input
    must be placed with shard_population; num_policies must divide by the
    mesh size.
    """
    from jax import shard_map

    n_dev = mesh.devices.size
    if pop_update.num_policies % n_dev:
        raise ValueError(
            f"num_policies={pop_update.num_policies} must divide the mesh "
            f"size {n_dev}")
    spec = P(axis_name)

    def local_update(ts):
        return jax.vmap(pop_update.single)(ts)

    sharded = shard_map(local_update, mesh=mesh,
                        in_specs=(spec,), out_specs=spec,
                        check_vma=False)
    return jax.jit(sharded)
