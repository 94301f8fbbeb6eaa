"""On-device PPO learner: env + rollout + GAE + clipped updates in one program.

On-device replacement of the reference's stable-baselines3 PPO training loop
(reference examples/learn.py:52-97): where SB3 alternates host-side torch
updates with single-process env stepping across a numpy boundary
(SURVEY.md §3.2), here the batched env, the policy, GAE, and the optimizer
all live inside one jitted program — rollouts never leave the device, and the
env batch axis is the data-parallel shard axis across devices
(see gym_pybullet_drones_tpu.parallel).

Hyperparameters default to SB3 PPO defaults (lr 3e-4, n_steps per env,
minibatches, 10 epochs, gamma .99, gae_lambda .95, clip .2, vf 0.5,
max_grad_norm 0.5) so learn.py-style workflows transfer.  Minibatch
SEMANTICS differ from SB3 by default (random timestep subsets instead of a
flattened (T*E) shuffle — the communication-free choice on an env-sharded
mesh); set PPOConfig(sb3_minibatching=True) for SB3's exact shuffle on a
single host.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import optax

from gym_pybullet_drones_tpu.envs import core
from gym_pybullet_drones_tpu.models.mlp import (
    ActorCritic, gaussian_entropy, gaussian_log_prob)


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    num_envs: int = 64
    rollout_steps: int = 128       # env steps per update, per env
    num_minibatches: int = 4
    update_epochs: int = 10
    total_timesteps: int = 100_000
    lr: float = 3e-4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    ent_coef: float = 0.0
    vf_coef: float = 0.5
    max_grad_norm: float = 0.5
    anneal_lr: bool = False
    hidden: tuple = (64, 64)       # MLP tower widths (ActorCritic)
    log_std_init: float = 0.0      # initial policy exploration (log sigma)
    # 'bfloat16' runs the policy/value Dense layers in bf16 with float32
    # master weights (models/mlp.py); None = full float32
    compute_dtype: str | None = None
    # SB3-exact minibatch semantics: shuffle the flattened (T*E) batch each
    # epoch (stable-baselines3 RolloutBuffer.get).  Default False = time-axis
    # minibatching (random timestep subsets, all envs per minibatch), which
    # is communication-free on a device mesh — the flattened shuffle would
    # gather the rollout across the env-sharded mesh axis every epoch.
    # Single-host users wanting SB3-identical gradient statistics (reference
    # examples/learn.py:72-94 semantics) set True.
    sb3_minibatching: bool = False

    def __post_init__(self):
        if self.rollout_steps % self.num_minibatches != 0:
            raise ValueError(
                "rollout_steps must be divisible by num_minibatches "
                f"(got {self.rollout_steps} / {self.num_minibatches})")

    @property
    def batch_size(self) -> int:
        return self.num_envs * self.rollout_steps

    @property
    def num_updates(self) -> int:
        return max(1, self.total_timesteps // self.batch_size)


class Transition(NamedTuple):
    obs: jnp.ndarray
    action: jnp.ndarray
    log_prob: jnp.ndarray
    value: jnp.ndarray
    reward: jnp.ndarray
    done: jnp.ndarray


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    env_state: core.EnvState   # batched over num_envs
    last_obs: jnp.ndarray      # (num_envs, obs_flat)
    key: jax.Array
    update_idx: jnp.ndarray


def _flat_obs(obs):
    """(E, N, D) per-drone obs -> (E, N*D) policy input."""
    return obs.reshape(obs.shape[0], -1)


def make_train(env_cfg: core.AviaryConfig, task, ppo: PPOConfig,
               dtype=jnp.float32, network=None, mesh=None,
               interpret: bool = False):
    """Build (init_fn, update_fn, rollout_eval_fn) for PPO on (cfg, task).

    update_fn is a pure jittable step: TrainState -> (TrainState, metrics);
    callers choose single-device jit or a sharded jit over an env-batch mesh
    (parallel.make_sharded_update).  `network` overrides the policy module;
    by default RGB observations get the NatureCNN actor-critic and KIN
    observations the SB3-style MLP.

    mesh: pass the device mesh when training sharded — the env step is then
    wrapped in shard_map so each device steps its local env shard (see
    envs/fast.py).

    The env step is the one envs/fast.select_env_path picks: the fused
    kernel where it is eligible on the GPU, the XLA batched step
    otherwise.  interpret=True runs an eligible configuration through the
    fused kernel in the Pallas interpreter on any backend (tests).  The
    chosen path is recorded as `update.env_path` ('fused' | 'batched').
    """
    n_drones = env_cfg.num_drones
    act_dim_per_drone = task.action_dim(env_cfg)
    act_dim = n_drones * act_dim_per_drone
    if network is None:
        from gym_pybullet_drones_tpu.utils.enums import ObservationType
        if getattr(task, "obs", None) == ObservationType.RGB:
            from gym_pybullet_drones_tpu.models.cnn import ActorCriticCNN
            network = ActorCriticCNN(action_dim=act_dim)
        else:
            cd = (jnp.dtype(ppo.compute_dtype)
                  if ppo.compute_dtype else None)
            network = ActorCritic(action_dim=act_dim,
                                  hidden=tuple(ppo.hidden),
                                  log_std_init=ppo.log_std_init,
                                  compute_dtype=cd)

    # obs_layout="flat": the policy consumes flattened observations
    from gym_pybullet_drones_tpu.envs.fast import make_env_step
    env_path, batched_reset, batched_step = make_env_step(
        env_cfg, task, ppo.num_envs, dtype=dtype, mesh=mesh,
        obs_layout="flat", interpret=interpret)

    if ppo.anneal_lr:
        total_opt_steps = (ppo.num_updates * ppo.update_epochs
                          * ppo.num_minibatches)
        lr = optax.linear_schedule(ppo.lr, 0.0, total_opt_steps)
    else:
        lr = ppo.lr
    tx = optax.chain(
        optax.clip_by_global_norm(ppo.max_grad_norm),
        optax.adam(lr, eps=1e-5),
    )

    def init(key: jax.Array) -> TrainState:
        env_state, obs = batched_reset()
        obs = _flat_obs(obs)
        key, sub = jax.random.split(key)
        params = network.init(sub, obs[:1])
        opt_state = tx.init(params)
        return TrainState(params=params, opt_state=opt_state,
                          env_state=env_state, last_obs=obs, key=key,
                          update_idx=jnp.zeros((), jnp.int32))

    def _policy_step(params, obs, key):
        mean, log_std, value = network.apply(params, obs)
        noise = jax.random.normal(key, mean.shape, mean.dtype)
        action = mean + jnp.exp(log_std) * noise
        log_prob = gaussian_log_prob(mean, log_std, action)
        return action, log_prob, value

    def _env_step(carry, _):
        env_state, obs, params, key = carry
        key, sub = jax.random.split(key)
        action, log_prob, value = _policy_step(params, obs, sub)
        act_env = action.reshape(-1, n_drones, act_dim_per_drone)
        env_state, next_obs, reward, term, trunc = batched_step(
            env_state, act_env)[:5]
        done = jnp.logical_or(term, trunc)
        t = Transition(obs=obs, action=action, log_prob=log_prob,
                       value=value, reward=reward,
                       done=done.astype(obs.dtype))
        return (env_state, _flat_obs(next_obs), params, key), t

    def _gae(traj: Transition, last_value):
        # done[t] marks that the state AFTER step t is a reset state, so the
        # bootstrap V(s_{t+1}) and the recursive GAE term are both masked by
        # (1 - done[t]) of the CURRENT transition.
        def body(carry, t):
            gae, next_value = carry
            nonterminal = 1.0 - t.done
            delta = (t.reward + ppo.gamma * next_value * nonterminal
                     - t.value)
            gae = delta + ppo.gamma * ppo.gae_lambda * nonterminal * gae
            return (gae, t.value), gae

        (_, _), advantages = jax.lax.scan(
            body, (jnp.zeros_like(last_value), last_value),
            traj, reverse=True)
        return advantages, advantages + traj.value

    def _loss(params, batch, advantages, returns):
        mean, log_std, value = network.apply(params, batch.obs)
        log_prob = gaussian_log_prob(mean, log_std, batch.action)
        ratio = jnp.exp(log_prob - batch.log_prob)
        norm_adv = (advantages - advantages.mean()) / (
            advantages.std() + 1e-8)
        pg1 = ratio * norm_adv
        pg2 = jnp.clip(ratio, 1 - ppo.clip_eps, 1 + ppo.clip_eps) * norm_adv
        pg_loss = -jnp.minimum(pg1, pg2).mean()
        v_loss = 0.5 * jnp.square(value - returns).mean()
        ent = gaussian_entropy(log_std).mean()
        total = pg_loss + ppo.vf_coef * v_loss - ppo.ent_coef * ent
        return total, (pg_loss, v_loss, ent)

    def update(ts: TrainState):
        # ---- rollout ----
        (env_state, last_obs, _, key), traj = jax.lax.scan(
            _env_step, (ts.env_state, ts.last_obs, ts.params, ts.key),
            None, length=ppo.rollout_steps)
        _, _, last_value = network.apply(ts.params, last_obs)
        advantages, returns = _gae(traj, last_value)

        # ---- minibatching ----
        # Default: random subsets of rollout TIMESTEPS (all envs per
        # minibatch).  The env axis is the data-parallel shard axis on a
        # mesh: permuting the flattened (T*E) batch would gather the whole
        # rollout across devices every epoch, while time-axis permutation is
        # over a replicated axis and costs no communication — the only
        # cross-shard traffic per minibatch is the gradient all-reduce.
        # sb3_minibatching=True: SB3's exact flattened-(T*E) shuffle, for
        # single-host runs that must reproduce SB3 gradient statistics.
        if ppo.sb3_minibatching:
            total = ppo.rollout_steps * ppo.num_envs
            mb_size = total // ppo.num_minibatches
            flat = jax.tree.map(
                lambda x: x.reshape((total,) + x.shape[2:]), traj)
            flat_adv = advantages.reshape(total)
            flat_ret = returns.reshape(total)
        else:
            mb_t = max(1, ppo.rollout_steps // ppo.num_minibatches)

        def epoch(carry, _):
            params, opt_state, key = carry
            key, sub = jax.random.split(key)
            if ppo.sb3_minibatching:
                perm = jax.random.permutation(sub, total)
            else:
                perm = jax.random.permutation(sub, ppo.rollout_steps)

            def minibatch(carry, idx):
                params, opt_state = carry
                if ppo.sb3_minibatching:
                    take = jax.lax.dynamic_slice_in_dim(
                        perm, idx * mb_size, mb_size)
                    mb = jax.tree.map(lambda x: x[take], flat)
                    adv, ret = flat_adv[take], flat_ret[take]
                else:
                    take = jax.lax.dynamic_slice_in_dim(
                        perm, idx * mb_t, mb_t)
                    # Merge (T_mb, E) ENV-MAJOR: the env axis is the mesh
                    # shard axis, and GSPMD can only express the sharding of
                    # a merged dimension when the sharded axis is major — a
                    # plain (T_mb, E) -> (T_mb*E) reshape forces an
                    # all-gather of every minibatch (observed in the round-2
                    # HLO audit, tests/test_collectives.py).
                    merge = lambda x: jnp.swapaxes(x, 0, 1).reshape(
                        (-1,) + x.shape[2:])
                    mb = jax.tree.map(lambda x: merge(x[take]), traj)
                    adv = merge(advantages[take])
                    ret = merge(returns[take])
                grads, aux = jax.grad(_loss, has_aux=True)(
                    params, mb, adv, ret)
                updates, opt_state = tx.update(grads, opt_state, params)
                params = optax.apply_updates(params, updates)
                return (params, opt_state), aux

            (params, opt_state), aux = jax.lax.scan(
                minibatch, (params, opt_state),
                jnp.arange(ppo.num_minibatches))
            return (params, opt_state, key), aux

        (params, opt_state, key), aux = jax.lax.scan(
            epoch, (ts.params, ts.opt_state, key), None,
            length=ppo.update_epochs)

        metrics = {
            "mean_reward": traj.reward.mean(),
            "mean_value": traj.value.mean(),
            "pg_loss": aux[0].mean(),
            "v_loss": aux[1].mean(),
            "entropy": aux[2].mean(),
        }
        new_ts = TrainState(params=params, opt_state=opt_state,
                            env_state=env_state, last_obs=last_obs, key=key,
                            update_idx=ts.update_idx + 1)
        return new_ts, metrics

    def update_many(ts: TrainState, num_updates: int):
        """`num_updates` PPO updates in ONE jitted lax.scan.

        Chains rollout+optimize iterations on-device so the host dispatches
        once per chunk instead of once per update.  Returns (ts, metrics)
        with a leading (num_updates,) axis on every metric.
        """
        return jax.lax.scan(lambda t, _: update(t), ts, None,
                            length=num_updates)

    def evaluate(params, key, num_steps: int | None = None,
                 episodic: bool = False):
        """Deterministic-policy rollout; returns summed reward per env.

        episodic=True reproduces the reference's episode accounting
        (SB3 EvalCallback): rewards stop accumulating after the first
        terminated/truncated signal.  The reference episode truly lasts
        EPISODE_LEN_SEC * ctrl_freq + 2 control steps (the pre-increment
        step counter, QUIRKS.md #11), so the default num_steps is derived
        from the task as episode_len_sec * ctrl_freq + 2 — passing the
        "natural" 240 would silently measure a truncated return.
        """
        if num_steps is None:
            num_steps = int(
                getattr(task, "episode_len_sec", 8.0)
                * env_cfg.ctrl_freq) + 2
        env_state, obs = batched_reset()
        obs = _flat_obs(obs)
        alive0 = jnp.ones(obs.shape[0], bool)

        def step_fn(carry, _):
            env_state, obs, alive = carry
            mean, _, _ = network.apply(params, obs)
            act_env = mean.reshape(-1, n_drones, act_dim_per_drone)
            env_state, next_obs, reward, term, trunc = batched_step(
                env_state, act_env)[:5]
            if episodic:
                reward = jnp.where(alive, reward, 0.0)
                alive = alive & ~(term | trunc)
            return (env_state, _flat_obs(next_obs), alive), reward

        _, rewards = jax.lax.scan(step_fn, (env_state, obs, alive0), None,
                                  length=num_steps)
        return rewards.sum(axis=0)

    update.many = update_many  # chunked training without changing arity
    update.env_path = env_path  # 'fused' | 'batched' (see docstring)
    return init, update, evaluate, network
