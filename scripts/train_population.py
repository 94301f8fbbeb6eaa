"""Multi-seed training-to-threshold in ONE program (VERDICT r4 next #1).

Trains a POPULATION of K seeds simultaneously via rl/population.py (one
vmapped XLA program: K rollouts, K optimizers, K-batched policy GEMMs) and
records every seed's evaluation curve + first threshold crossing.  The
reference capability being made robust is learn.py's train-to-solved claim
(reference gym_pybullet_drones/examples/learn.py:78-97): a threshold that
only one lucky seed ever crossed is not a capability — the artifact this
writes shows how many of K seeds cross in a single session.

Default hyperparameters reproduce the committed single-seed MultiHover
crossing (artifacts/learning_curve_multihover_seed0.json: 128 envs,
rollout 64, 4 minibatches, 10 epochs, lr 3e-4 annealed, gamma .995,
hidden 128x128).

Usage:
  python scripts/train_population.py [--task multihover|hover]
      [--num_policies 8] [--max_updates 1400] [--epochs 10]
      [--platform gpu|cpu] [--out artifacts/...json]
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--task", default="multihover",
                    choices=["multihover", "hover"])
    ap.add_argument("--num_policies", type=int, default=8)
    ap.add_argument("--max_updates", type=int, default=1400)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--num_envs", type=int, default=128)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--gamma", type=float, default=0.995)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ent_coef", type=float, default=0.0)
    ap.add_argument("--log_std_init", type=float, default=0.0)
    ap.add_argument("--rollout_steps", type=int, default=64)
    ap.add_argument("--sb3_minibatching", action="store_true",
                    help="SB3's exact flattened-(T*E) minibatch shuffle "
                         "instead of the communication-free time-axis "
                         "subsets (rl/ppo.py PPOConfig)")
    ap.add_argument("--no_anneal", action="store_true",
                    help="constant lr (SB3's default schedule)")
    ap.add_argument("--num_minibatches", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0,
                    help="population seed key; member i trains from "
                         "split(key(seed), K)[i]")
    ap.add_argument("--eval_every", type=int, default=1)
    ap.add_argument("--platform", default="gpu",
                    help="'cpu' forces the CPU backend; otherwise JAX's "
                         "default device (the card)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import jax
    if args.platform == "cpu":
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from gym_pybullet_drones_tpu import params as P
    from gym_pybullet_drones_tpu.envs import (
        AviaryConfig, HoverTask, MultiHoverTask)
    from gym_pybullet_drones_tpu.rl import PPOConfig, make_train_population
    from gym_pybullet_drones_tpu.utils.enums import ActionType, Physics

    multi = args.task == "multihover"
    target = 949.5 if multi else 474.15
    cfg = AviaryConfig(drone=P.CF2X, num_drones=2 if multi else 1,
                       physics=Physics.PYB, pyb_freq=240, ctrl_freq=30)
    task = (MultiHoverTask if multi else HoverTask)(act=ActionType.ONE_D_RPM)
    ppo = PPOConfig(num_envs=args.num_envs, rollout_steps=args.rollout_steps,
                    num_minibatches=args.num_minibatches,
                    update_epochs=args.epochs,
                    total_timesteps=(args.max_updates * args.num_envs
                                     * args.rollout_steps),
                    anneal_lr=not args.no_anneal, lr=args.lr,
                    gamma=args.gamma,
                    ent_coef=args.ent_coef, log_std_init=args.log_std_init,
                    sb3_minibatching=args.sb3_minibatching,
                    hidden=(args.hidden, args.hidden))
    K = args.num_policies
    pinit, pupd, peval, network = make_train_population(
        cfg, task, ppo, K)
    print(f"[population] task={args.task} K={K} env_path={pupd.env_path} "
          f"platform={jax.devices()[0].platform}", flush=True)

    ts = pinit(jax.random.key(args.seed))
    upd = jax.jit(pupd)
    eval_fn = jax.jit(lambda p, k: peval(p, k, None, True))

    curve = []          # one row per eval: per-seed mean returns
    reached_at = [None] * K   # first crossing update per seed
    start = time.time()
    prev_crossed = 0
    for u in range(args.max_updates):
        ts, metrics = upd(ts)
        if u % args.eval_every and u != args.max_updates - 1:
            continue
        rets = eval_fn(ts.params, jax.random.key(u))
        per_seed = [float(x) for x in jnp.mean(rets, axis=1)]
        for i, r in enumerate(per_seed):
            if reached_at[i] is None and r >= target:
                reached_at[i] = u
        curve.append({"update": u,
                      "env_steps_per_seed": (u + 1) * ppo.batch_size,
                      "eval_return": [round(r, 2) for r in per_seed]})
        crossed = sum(r is not None for r in reached_at)
        if u % 50 == 0 or crossed != prev_crossed:
            print(f"[{args.task} pop] update {u} crossed={crossed}/{K} "
                  f"best={max(per_seed):.1f} mean={np.mean(per_seed):.1f} "
                  f"({time.time()-start:.0f}s)", flush=True)
        prev_crossed = crossed
        if crossed == K:
            break

    crossed = sum(r is not None for r in reached_at)
    out = {
        "task": args.task,
        "metric": "eval_return",
        "action_type": "one_d_rpm",
        "num_policies": K,
        "population_seed": args.seed,
        "platform": jax.devices()[0].platform,
        "device": str(jax.devices()[0]),
        "env_path": pupd.env_path,
        "target_reward": target,
        "reference_source": "gym_pybullet_drones/examples/learn.py:78-83",
        "seeds_crossed": crossed,
        "crossed_of_first3": sum(r is not None for r in reached_at[:3]),
        "reached_at_update": reached_at,
        "reached_at_env_steps": [
            None if r is None else (r + 1) * ppo.batch_size
            for r in reached_at],
        "total_wall_s": round(time.time() - start, 1),
        "ppo": {"num_envs": ppo.num_envs, "rollout_steps": ppo.rollout_steps,
                "num_minibatches": ppo.num_minibatches,
                "update_epochs": ppo.update_epochs, "lr": ppo.lr,
                "anneal_lr": ppo.anneal_lr, "gamma": ppo.gamma,
                "ent_coef": ppo.ent_coef,
                "log_std_init": ppo.log_std_init,
                "sb3_minibatching": ppo.sb3_minibatching,
                "hidden": list(ppo.hidden),
                "max_updates": args.max_updates},
        "note": ("all seeds train in ONE vmapped XLA program "
                 "(rl/population.py); anneal horizon = max_updates"),
        "curve": curve,
    }
    os.makedirs(os.path.join(os.path.dirname(__file__), "..", "artifacts"),
                exist_ok=True)
    path = args.out or os.path.join(
        os.path.dirname(__file__), "..", "artifacts",
        f"learning_curve_{args.task}_population{K}.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"[RESULT] {args.task} population: {crossed}/{K} seeds crossed "
          f"{target} (first3: {out['crossed_of_first3']}/3) -> {path}")
    return 0 if crossed >= max(2, (2 * K) // 3) else 1


if __name__ == "__main__":
    sys.exit(main())
