"""Seeded training runs to the reference's solved thresholds (VERDICT #4).

Trains Hover (ONE_D_RPM, target 474.15) and optionally MultiHover (2 drones,
target 949.5) with the on-device PPO at a fixed seed, recording the full
evaluation curve to artifacts/learning_curve_<task>_seed<seed>.json.  The
thresholds are the reference's early-stop values
(/root/reference/gym_pybullet_drones/examples/learn.py:78-83).

Usage: python scripts/train_to_threshold.py [--multiagent | --routing]
       [--seed 0] [--platform cpu|gpu] [--max_updates 400]

--routing trains the routing fork's namesake task (3 drones, reversed-line
goals, PID waypoint actions) and targets an ALL-ARRIVALS rate >= 0.9 over
64 deterministic eval episodes at the fixed seed — the success metric
VERDICT round 2 asked to define and hit (there is no reference threshold:
the reference never trains its routing machinery).
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--multiagent", action="store_true")
    ap.add_argument("--routing", action="store_true")
    ap.add_argument("--rgb", action="store_true",
                    help="train Hover(ONE_D_RPM) FROM PIXELS (ray-traced "
                         "RGB obs -> NatureCNN policy) to the same "
                         "reference threshold 474.15 (VERDICT r4 next #7); "
                         "the reference renders TinyRenderer frames on the "
                         "host CPU and cannot train this configuration at "
                         "speed at all")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--platform", default="cpu")
    ap.add_argument("--max_updates", type=int, default=400)
    ap.add_argument("--num_envs", type=int, default=64)
    ap.add_argument("--hidden", type=int, default=64,
                    help="MLP tower width (two layers)")
    ap.add_argument("--gamma", type=float, default=0.99)
    ap.add_argument("--log_std_init", type=float, default=0.0)
    ap.add_argument("--lr", type=float, default=3e-4,
                    help="PPO learning rate (RGB runs want 1e-4: 3e-4 "
                         "collapses the shared CNN trunk)")
    ap.add_argument("--rollout_steps", type=int, default=64)
    ap.add_argument("--anneal", action="store_true",
                    help="linear LR anneal over max_updates (used for the "
                         "committed Hover artifact: reaches 474.15 at "
                         "update 325 from seed 0)")
    ap.add_argument("--epochs", type=int, default=10,
                    help="PPO update epochs (sample-reuse sweeps per "
                         "rollout); the epochs-vs-throughput pareto study "
                         "(scripts/ppo_epochs_pareto.py) varies this")
    ap.add_argument("--out", default=None,
                    help="override the output artifact path")
    ap.add_argument("--sharded", type=int, default=0, metavar="N",
                    help="train with the env batch sharded over an N-device "
                         "mesh (make_sharded_update + mesh-wrapped env "
                         "step); uses N virtual CPU devices, so the run "
                         "proves sharded training LEARNS, not just that "
                         "one sharded update executes")
    args = ap.parse_args()

    if args.sharded:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.sharded}"
        ).strip()
        args.platform = "cpu"

    import jax
    if args.platform == "cpu":
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from gym_pybullet_drones_tpu import params as P
    from gym_pybullet_drones_tpu.envs import (
        AviaryConfig, HoverTask, MultiHoverTask)
    from gym_pybullet_drones_tpu.rl import PPOConfig, make_train
    from gym_pybullet_drones_tpu.utils.enums import ActionType, Physics

    if args.routing:
        from gym_pybullet_drones_tpu.envs import make_routing_config
        from gym_pybullet_drones_tpu.envs.fast import make_batched_step
        cfg, task = make_routing_config(num_drones=3, spacing=0.4)
        name, target = "routing", 0.9     # all-arrivals rate
    elif args.rgb:
        from gym_pybullet_drones_tpu.utils.enums import ObservationType
        name, target = "hover_rgb", 474.15
        cfg = AviaryConfig(drone=P.CF2X, num_drones=1, physics=Physics.DYN,
                           pyb_freq=240, ctrl_freq=30)
        task = HoverTask(act=ActionType.ONE_D_RPM,
                         obs=ObservationType.RGB)
    else:
        num_drones = 2 if args.multiagent else 1
        target = 949.5 if args.multiagent else 474.15
        name = "multihover" if args.multiagent else "hover"
        cfg = AviaryConfig(drone=P.CF2X, num_drones=num_drones,
                           physics=Physics.PYB, pyb_freq=240, ctrl_freq=30)
        task_cls = MultiHoverTask if args.multiagent else HoverTask
        task = task_cls(act=ActionType.ONE_D_RPM)
    ppo = PPOConfig(num_envs=args.num_envs, rollout_steps=args.rollout_steps,
                    num_minibatches=4, update_epochs=args.epochs,
                    total_timesteps=(args.max_updates * args.num_envs
                                     * args.rollout_steps),
                    anneal_lr=args.anneal, gamma=args.gamma, lr=args.lr,
                    log_std_init=args.log_std_init,
                    hidden=(args.hidden, args.hidden))
    mesh = None
    if args.sharded:
        from gym_pybullet_drones_tpu.parallel import (
            make_mesh, make_sharded_update, shard_train_state)
        assert len(jax.devices()) >= args.sharded, jax.devices()
        mesh = make_mesh(jax.devices()[:args.sharded])
    init, update, evaluate, network = make_train(cfg, task, ppo, mesh=mesh)

    ts = init(jax.random.key(args.seed))
    if mesh is not None:
        ts = shard_train_state(ts, mesh)
        upd = make_sharded_update(update, mesh)
    else:
        upd = jax.jit(update)
    if args.routing:
        # success metric: fraction of 64 deterministic episodes in which
        # EVERY drone reaches its destination (terminated fires) within
        # the 16 s episode horizon
        n_eval = 64
        horizon = int(task.episode_len_sec * cfg.ctrl_freq)
        er, es = make_batched_step(cfg, task, n_eval, autoreset=False,
                                   obs_layout="flat")

        def _arrival_rate(params, _key):
            st, obs = er()

            def step_fn(carry, _):
                st, obs, ever = carry
                mean, _, _ = network.apply(params, obs)
                act = mean.reshape(-1, cfg.num_drones,
                                   task.action_dim(cfg))
                st, obs, _, term, _ = es(st, act)
                return (st, obs, ever | term), None

            (_, _, ever), _ = jax.lax.scan(
                step_fn, (st, obs, jnp.zeros(n_eval, bool)), None,
                length=horizon)
            return jnp.mean(ever.astype(jnp.float32))
        eval_fn = jax.jit(_arrival_rate)
    else:
        # reference episode accounting: episodes span
        # episode_len_sec*ctrl_freq + 2 control steps (pre-increment step
        # counter, QUIRKS.md #11) and SB3's EvalCallback stops summing at
        # the first terminated/truncated — evaluate(episodic=True) defaults
        # the step count from the task and reproduces both
        eval_fn = jax.jit(lambda p, k: evaluate(p, k, episodic=True))

    curve = []
    start = time.time()
    reached_at = None
    for u in range(args.max_updates):
        ts, metrics = upd(ts)
        rets = eval_fn(ts.params, jax.random.key(u))
        mean_ret = float(jnp.mean(rets))
        curve.append({
            "update": u,
            "env_steps": (u + 1) * ppo.batch_size,
            "eval_return": mean_ret,
            "train_reward": float(metrics["mean_reward"]),
            "wall_s": round(time.time() - start, 1),
        })
        if u % 5 == 0 or mean_ret >= target:
            print(f"[{name} seed {args.seed}] update {u} "
                  f"steps={(u+1)*ppo.batch_size} eval={mean_ret:.2f} "
                  f"({time.time()-start:.0f}s)", flush=True)
        if mean_ret >= target:
            reached_at = u
            break

    out = {
        "task": name,
        "metric": "all_arrivals_rate" if args.routing else "eval_return",
        "action_type": "pid_waypoint" if args.routing else "one_d_rpm",
        "obs_type": "rgb" if args.rgb else "kin",
        "seed": args.seed,
        "platform": jax.devices()[0].platform,
        "device": str(jax.devices()[0]),
        "target_reward": target,
        "reference_source":
            ("gym_pybullet_drones/envs/BaseAviary.py:1105-1147 "
             "(routing machinery; threshold is ours — the reference "
             "defines none)") if args.routing else
            "gym_pybullet_drones/examples/learn.py:78-83",
        "sharded_devices": args.sharded or None,
        "reached": reached_at is not None,
        "reached_at_update": reached_at,
        "reached_at_env_steps":
            None if reached_at is None else (reached_at + 1) * ppo.batch_size,
        "total_wall_s": round(time.time() - start, 1),
        "ppo": {"num_envs": ppo.num_envs, "rollout_steps": ppo.rollout_steps,
                "num_minibatches": ppo.num_minibatches,
                "update_epochs": ppo.update_epochs, "lr": ppo.lr,
                "anneal_lr": ppo.anneal_lr, "gamma": ppo.gamma,
                "log_std_init": ppo.log_std_init,
                "hidden": list(ppo.hidden)},
        "curve": curve,
    }
    os.makedirs(os.path.join(os.path.dirname(__file__), "..", "artifacts"),
                exist_ok=True)
    suffix = f"_sharded{args.sharded}" if args.sharded else ""
    path = args.out or os.path.join(
        os.path.dirname(__file__), "..", "artifacts",
        f"learning_curve_{name}{suffix}_seed{args.seed}.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"[RESULT] {name}: reached={out['reached']} "
          f"at update {reached_at} -> {path}")
    return 0 if out["reached"] else 1


if __name__ == "__main__":
    sys.exit(main())
