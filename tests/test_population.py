"""Population-parallel PPO (rl/population.py): K seeds in one program.

Validates the three claims the population trainer makes: (1) each member
of the population trains EXACTLY like an independent make_train run seeded
with the corresponding split key; (2) the policy axis
shards over a device mesh with zero collectives and unchanged results;
(3) the vmap lift composes with the fused env kernel.

Reference counterpart: the seed-robustness of the learn.py threshold claim
(reference gym_pybullet_drones/examples/learn.py:78-97) — SB3 trains one
seed per process; here a seed population is one XLA program.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gym_pybullet_drones_tpu import params as P
from gym_pybullet_drones_tpu.envs import AviaryConfig, HoverTask
from gym_pybullet_drones_tpu.parallel import make_mesh
from gym_pybullet_drones_tpu.rl import (
    PPOConfig, make_sharded_population_update, make_train,
    make_train_population, shard_population)
from gym_pybullet_drones_tpu.utils.enums import ActionType, Physics


def _hover():
    cfg = AviaryConfig(drone=P.CF2X, num_drones=1, physics=Physics.DYN,
                       pyb_freq=240, ctrl_freq=30)
    return cfg, HoverTask(act=ActionType.RPM)


PPO_SMALL = PPOConfig(num_envs=8, rollout_steps=8, num_minibatches=2,
                      update_epochs=2)


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def test_population_matches_independent_runs():
    """Each population member == make_train seeded with the same split key.

    Tolerance, not bitwise: vmapping the policy turns per-policy GEMMs into
    K-batched GEMMs whose reduction tiling XLA may schedule differently —
    float32 matmul noise (~1e-7 rel) is expected; divergent training
    dynamics are not.  The bound sits at that noise after the Adam steps:
    over base keys 0-7 on the CPU, 7 stay inside it and key 6 passes it by
    2e-10 on one parameter, while a policy trained on other data differs
    by orders of magnitude more.
    """
    cfg, task = _hover()
    K = 2
    pinit, pupd, peval, _ = make_train_population(
        cfg, task, PPO_SMALL, K)
    assert pupd.env_path == "batched"
    ts = pinit(jax.random.key(0))
    new_ts, metrics = jax.jit(pupd)(ts)
    assert metrics["mean_reward"].shape == (K,)

    init, upd, _, _ = make_train(cfg, task, PPO_SMALL)
    keys = jax.random.split(jax.random.key(0), K)
    for i in range(K):
        nts_i, m_i = jax.jit(upd)(init(keys[i]))
        for a, b in zip(_leaves(new_ts.params), _leaves(nts_i.params)):
            np.testing.assert_allclose(a[i], b, rtol=1e-5, atol=1e-8)
        np.testing.assert_allclose(float(metrics["mean_reward"][i]),
                                   float(m_i["mean_reward"]), rtol=1e-5)
    # different seeds actually produce different policies
    w0, w1 = _leaves(new_ts.params)[0][0], _leaves(new_ts.params)[0][1]
    assert not np.allclose(w0, w1)


def test_population_sharded_zero_collectives():
    """Policy-axis sharding: same results, 4-device layout, NO collectives.

    Policies never communicate, so the sharded program must contain zero
    collective ops — the cheapest possible scale-out (contrast the
    env-sharded layout's gradient all-reduce, tests/test_collectives.py).
    """
    cfg, task = _hover()
    K = 4
    pinit, pupd, _, _ = make_train_population(
        cfg, task, PPO_SMALL, K)
    ts = pinit(jax.random.key(0))
    ref_ts, ref_metrics = jax.jit(pupd)(ts)

    mesh = make_mesh(jax.devices()[:4])
    supd = make_sharded_population_update(pupd, mesh)
    new_ts, metrics = supd(shard_population(ts, mesh))

    leaf = jax.tree.leaves(new_ts.params)[0]
    assert len(leaf.sharding.device_set) == 4
    for a, b in zip(_leaves(ref_ts.params), _leaves(new_ts.params)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-8)
    np.testing.assert_allclose(np.asarray(ref_metrics["mean_reward"]),
                               np.asarray(metrics["mean_reward"]), rtol=1e-4)
    # env physics is elementwise per lane, but the actions driving it carry
    # the policy GEMMs' reduction-order noise -> same tolerance as params
    for a, b in zip(_leaves(ref_ts.env_state), _leaves(new_ts.env_state)):
        if a.dtype == np.float32:
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-7)

    hlo = supd.lower(shard_population(ts, mesh)).compile().as_text()
    for op in ("all-reduce", "all-gather", "collective-permute",
               "reduce-scatter", "all-to-all"):
        assert op not in hlo, f"unexpected collective {op} in population HLO"


def test_population_mesh_divisibility_rejected():
    cfg, task = _hover()
    pinit, pupd, _, _ = make_train_population(
        cfg, task, PPO_SMALL, 3)
    mesh = make_mesh(jax.devices()[:4])
    with pytest.raises(ValueError, match="divide"):
        make_sharded_population_update(pupd, mesh)


def test_population_evaluate_and_many():
    cfg, task = _hover()
    K = 2
    pinit, pupd, peval, _ = make_train_population(
        cfg, task, PPO_SMALL, K)
    ts = pinit(jax.random.key(0))
    new_ts, metrics = jax.jit(lambda t: pupd.many(t, 3))(ts)
    assert metrics["mean_reward"].shape == (K, 3)
    assert int(new_ts.update_idx[0]) == 3
    rets = jax.jit(lambda p, k: peval(p, k, 10, True))(
        new_ts.params, jax.random.key(1))
    assert rets.shape == (K, PPO_SMALL.num_envs)
    assert bool(jnp.all(jnp.isfinite(rets)))


def test_population_composes_with_fused_kernel():
    """vmap over the fully-fused rollout kernel (the GPU env path): one
    population update runs and matches the batched-path population
    physics.  Small shapes — interpret-mode Pallas trace."""
    cfg, task = _hover()
    ppo = PPOConfig(num_envs=8, rollout_steps=4, num_minibatches=2,
                    update_epochs=1)
    K = 2
    pinit_f, pupd_f, _, _ = make_train_population(
        cfg, task, ppo, K, interpret=True)
    assert pupd_f.env_path == "fused"
    ts_f = pinit_f(jax.random.key(0))
    new_f, m_f = jax.jit(pupd_f)(ts_f)

    pinit_b, pupd_b, _, _ = make_train_population(
        cfg, task, ppo, K)
    new_b, m_b = jax.jit(pupd_b)(pinit_b(jax.random.key(0)))
    np.testing.assert_allclose(np.asarray(m_f["mean_reward"]),
                               np.asarray(m_b["mean_reward"]),
                               rtol=1e-5, atol=1e-7)
    for a, b in zip(_leaves(new_f.params), _leaves(new_b.params)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-7)
