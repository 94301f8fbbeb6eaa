"""Extended benchmark suite on GPUs: one JSON line per tracked config.

BASELINE.md tracked configs beyond the primary bench.py metric:
multi-drone MultiHover, the routing fleet task, PPO learner throughput, and
(when more than one device is visible) data-mesh scaling efficiency.
Every timed window ends with block_until_ready.  Exits non-zero without a
GPU (see bench.py).
"""
from __future__ import annotations

import argparse
import json

import jax

from gym_pybullet_drones_tpu import params as P
from gym_pybullet_drones_tpu.envs import (
    AviaryConfig, HoverTask, MultiHoverTask)
from gym_pybullet_drones_tpu.envs.fast import make_env_step
from gym_pybullet_drones_tpu.envs.routing import make_routing_config
from gym_pybullet_drones_tpu.rl import PPOConfig, make_train
from gym_pybullet_drones_tpu.utils.enums import ActionType, Physics
from gym_pybullet_drones_tpu.utils.platform import enable_compile_cache

from bench import (describe_device, env_rollout, random_actions,
                   time_windows)


def _bench_env(cfg, task, num_envs, chunk=1024):
    # the same env path rl/ppo.py trains on
    path, reset_fn, step_fn = make_env_step(cfg, task, num_envs)
    sec, _ = time_windows(env_rollout(step_fn), reset_fn()[0],
                          random_actions(chunk, num_envs, cfg, task))
    return num_envs * chunk / sec, path


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None,
                    help="also write the results as JSON to this path")
    args = ap.parse_args()
    device = describe_device()
    enable_compile_cache()
    results = []

    # MultiHover: 2-drone multi-agent, 8192 envs
    cfg = AviaryConfig(drone=P.CF2X, num_drones=2, physics=Physics.DYN,
                       pyb_freq=240, ctrl_freq=30)
    rate, path = _bench_env(cfg, MultiHoverTask(act=ActionType.RPM), 8192)
    results.append({"metric": "env_steps_per_sec_multihover2x8192",
                    "value": rate, "unit": "env-steps/s",
                    "env_path": path})

    # Routing fleet: 4-drone PID-routing, DYN physics, 4096 envs
    cfg, task = make_routing_config(num_drones=4, physics=Physics.DYN)
    rate, path = _bench_env(cfg, task, 4096)
    results.append({"metric": "env_steps_per_sec_routing4x4096",
                    "value": rate, "unit": "env-steps/s",
                    "env_path": path})

    # Routing DEFAULT config: PYB physics + embedded PID + contact
    cfg, task = make_routing_config(num_drones=4)
    rate, path = _bench_env(cfg, task, 4096)
    results.append({"metric": "env_steps_per_sec_routing4x4096_pyb",
                    "value": rate, "unit": "env-steps/s",
                    "env_path": path})

    # All aero effects (ground effect + drag + downwash), PYB mode
    cfg = AviaryConfig(drone=P.CF2X, num_drones=1,
                       physics=Physics.PYB_GND_DRAG_DW, pyb_freq=240,
                       ctrl_freq=30)
    rate, path = _bench_env(cfg, HoverTask(act=ActionType.RPM), 4096)
    results.append({"metric": "env_steps_per_sec_hover4096_pyb_aero",
                    "value": rate, "unit": "env-steps/s",
                    "env_path": path})

    # RGB observations: ray-traced (48, 64, 4) per drone (ops/render.py,
    # reference BaseRLAviary.py:252-306) — the pixel path the reference
    # serves through TinyRenderer, here fully on-device
    from gym_pybullet_drones_tpu.utils.enums import ObservationType
    cfg = AviaryConfig(drone=P.CF2X, num_drones=1, physics=Physics.DYN,
                       pyb_freq=240, ctrl_freq=30)
    rate, path = _bench_env(cfg, HoverTask(act=ActionType.RPM,
                                           obs=ObservationType.RGB),
                            256, chunk=64)
    results.append({"metric": "env_steps_per_sec_hover256_rgb",
                    "value": rate, "unit": "env-steps/s",
                    "env_path": path})

    # PPO learner throughput: env-steps consumed per second of training
    cfg = AviaryConfig(drone=P.CF2X, num_drones=1, physics=Physics.DYN,
                       pyb_freq=240, ctrl_freq=30)
    ppo = PPOConfig(num_envs=8192, rollout_steps=64, num_minibatches=4,
                    update_epochs=4)
    init, update, _, _ = make_train(cfg, HoverTask(act=ActionType.RPM), ppo)
    ts = init(jax.random.key(0))
    # chunked training: 32 updates per launch (update.many), as a
    # training loop runs them
    n_chain = 32
    sec, _ = time_windows(lambda t: update.many(t, n_chain), ts, windows=3)
    results.append({"metric": "ppo_env_steps_per_sec_hover8192",
                    "value": n_chain * ppo.batch_size / sec,
                    "unit": "env-steps/s",
                    "env_path": update.env_path})

    # Population-parallel PPO (rl/population.py): K=8 seeds in ONE
    # vmapped program vs one seed at the same per-policy env count;
    # 1024 envs/policy = the multi-seed robustness-artifact shape.
    from gym_pybullet_drones_tpu.rl import make_train_population
    K_pop = 8
    ppo_p = PPOConfig(num_envs=1024, rollout_steps=64, num_minibatches=4,
                      update_epochs=4)
    n_chain = 8
    rates_pop = {}
    for label, k in (("single", None), (f"pop{K_pop}", K_pop)):
        if k is None:
            init_k, upd_k, _, _ = make_train(
                cfg, HoverTask(act=ActionType.RPM), ppo_p)
        else:
            init_k, upd_k, _, _ = make_train_population(
                cfg, HoverTask(act=ActionType.RPM), ppo_p, k)
        sec, _ = time_windows(lambda t, u=upd_k: u.many(t, n_chain),
                              init_k(jax.random.key(0)), windows=3)
        rates_pop[label] = n_chain * ppo_p.batch_size * (k or 1) / sec
    results.append({
        "metric": f"ppo_env_steps_per_sec_population{K_pop}x1024",
        "value": rates_pop[f"pop{K_pop}"],
        "unit": "env-steps/s (aggregate over policies)",
        "single_policy_1024": rates_pop["single"],
        "population_speedup": rates_pop[f"pop{K_pop}"] / rates_pop["single"]})

    # Pixel-based PPO: NatureCNN policy trained on the ray-traced RGB
    # observations, rollout rendering + conv forward/backward all in one
    # on-device program — a configuration the reference cannot train at
    # speed at all (TinyRenderer renders each frame on the host CPU)
    cfg = AviaryConfig(drone=P.CF2X, num_drones=1, physics=Physics.DYN,
                       pyb_freq=240, ctrl_freq=30)
    ppo = PPOConfig(num_envs=512, rollout_steps=32, num_minibatches=4,
                    update_epochs=2, lr=1e-4)
    init, update, _, _ = make_train(
        cfg, HoverTask(act=ActionType.ONE_D_RPM,
                       obs=ObservationType.RGB), ppo)
    sec, _ = time_windows(update, init(jax.random.key(0)), windows=6)
    results.append({"metric": "ppo_env_steps_per_sec_rgb512",
                    "value": ppo.batch_size / sec, "unit": "env-steps/s",
                    "env_path": update.env_path})

    # Mesh scaling efficiency (needs >1 GPU)
    n_dev = len(jax.devices())
    if n_dev > 1:
        from gym_pybullet_drones_tpu.parallel import (
            make_mesh, make_sharded_update, shard_train_state)
        ppo_s = PPOConfig(num_envs=64 * n_dev, rollout_steps=16,
                          num_minibatches=2, update_epochs=2)
        init, update, _, _ = make_train(
            cfg, HoverTask(act=ActionType.RPM), ppo_s)
        rates = {}
        for nd in (1, n_dev):
            mesh = make_mesh(jax.devices()[:nd])
            sec, _ = time_windows(make_sharded_update(update, mesh),
                                  shard_train_state(init(jax.random.key(0)),
                                                    mesh), windows=3)
            rates[nd] = ppo_s.batch_size / sec
        eff = rates[n_dev] / (rates[1] * n_dev)
        results.append({"metric": f"mesh_scaling_efficiency_{n_dev}dev",
                        "value": eff, "unit": "fraction"})

    for r in results:
        print(json.dumps({**r, "device": device}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": device, "results": results}, f, indent=1)
        print(f"-> {args.out}")


if __name__ == "__main__":
    main()
