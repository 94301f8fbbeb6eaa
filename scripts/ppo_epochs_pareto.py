#!/usr/bin/env python
"""Quality side of the PPO sample-reuse lever (update_epochs).

Fewer update epochs per rollout raise training throughput; that lever is
unactionable without its quality cost, so this driver trains Hover and
MultiHover to the reference's solved thresholds (474.15 / 949.5, reference
examples/learn.py:78-83) at update_epochs in {2, 4, 10} (one seed each, on
the default device) and records env-steps and wall-seconds to threshold
per setting in artifacts/ppo_epochs_pareto.json.

Usage: python scripts/ppo_epochs_pareto.py [--max_updates 1200] [--seed 0]
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN = os.path.join(ROOT, "scripts", "train_to_threshold.py")
TRAIN_POP = os.path.join(ROOT, "scripts", "train_population.py")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--max_updates", type=int, default=None,
                    help="override the per-task anneal horizon")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--epochs", type=int, nargs="+", default=[2, 4, 10])
    ap.add_argument("--tasks", nargs="+", default=["hover", "multihover"])
    ap.add_argument("--merge", action="store_true",
                    help="merge new rows into an existing artifact "
                         "(replacing same task+epochs rows)")
    ap.add_argument("--population", type=int, default=0, metavar="K",
                    help="train K seeds per setting in ONE vmapped program "
                         "(scripts/train_population.py) so every row "
                         "carries a seed spread instead of seed 0 alone "
                         "(VERDICT r4 next #8)")
    args = ap.parse_args()

    # flags mirror the committed single-setting artifacts, INCLUDING the
    # max_updates anneal horizon (the LR schedule anneals over
    # max_updates, so comparability requires pinning it per task:
    # hover committed run = 400, multihover = 600; 1200 for hover gives
    # epochs=2 headroom to finish, which it needs)
    tasks = {
        "hover": (1200, ["--num_envs", "64", "--anneal"],
                  ["--num_envs", "64", "--gamma", "0.99",
                   "--hidden", "64"]),
        "multihover": (600, ["--multiagent", "--num_envs", "128",
                             "--anneal", "--gamma", "0.995",
                             "--hidden", "128"],
                       ["--num_envs", "128", "--gamma", "0.995",
                        "--hidden", "128"]),
    }
    settings = []
    for task in args.tasks:
        horizon, flags, pop_flags = tasks[task]
        horizon = args.max_updates or horizon
        for ep in args.epochs:
            with tempfile.NamedTemporaryFile(
                    suffix=".json", delete=False) as f:
                out = f.name
            if args.population:
                # K seeds per setting, one vmapped program (anneal is
                # always on in train_population, matching the --anneal
                # flags of the single-seed rows)
                cmd = [sys.executable, TRAIN_POP, "--task", task,
                       "--num_policies", str(args.population),
                       "--seed", str(args.seed), "--epochs", str(ep),
                       "--max_updates", str(horizon),
                       "--out", out, *pop_flags]
            else:
                cmd = [sys.executable, TRAIN, "--platform", "gpu",
                       "--seed", str(args.seed), "--epochs", str(ep),
                       "--max_updates", str(horizon),
                       "--out", out, *flags]
            print(f"=== {task} epochs={ep}: {' '.join(cmd)}", flush=True)
            try:
                rc = subprocess.call(cmd, cwd=ROOT)
                row = {"task": task, "update_epochs": ep,
                       "seed": args.seed, "max_updates": horizon,
                       "reached": False, "rc": rc}
                if args.population and os.path.exists(out) \
                        and os.path.getsize(out):
                    with open(out) as fh:
                        d = json.load(fh)
                    steps_per_seed = d["reached_at_env_steps"]
                    reached_steps = sorted(
                        s for s in steps_per_seed if s is not None)
                    row.update({
                        "population": args.population,
                        "reached": d["seeds_crossed"] > 0,
                        "seeds_crossed":
                            f"{d['seeds_crossed']}/{d['num_policies']}",
                        "target": d["target_reward"],
                        "env_steps_to_threshold_per_seed": steps_per_seed,
                        "env_steps_to_threshold":
                            (reached_steps[len(reached_steps) // 2]
                             if reached_steps else None),
                        "updates_to_threshold_per_seed":
                            d["reached_at_update"],
                        "total_wall_s_population": d["total_wall_s"],
                        "platform": d["platform"],
                        "device": d["device"],
                    })
                elif os.path.exists(out) and os.path.getsize(out):
                    with open(out) as fh:
                        d = json.load(fh)
                    row.update({
                        "reached": d["reached"],
                        "target": d["target_reward"],
                        "env_steps_to_threshold": d["reached_at_env_steps"],
                        "wall_s_to_threshold":
                            None if d["reached_at_update"] is None else
                            d["curve"][d["reached_at_update"]]["wall_s"],
                        "updates_to_threshold": d["reached_at_update"],
                        "platform": d["platform"],
                        "device": d["device"],
                    })
                else:
                    # the trainer writes its artifact even when the target
                    # is not reached, so a missing file means the child
                    # CRASHED — distinct from "did not converge" (ADVICE r4)
                    row["error"] = f"child run crashed (rc={rc}, no output)"
                    print(f"!!! {task} epochs={ep}: {row['error']}",
                          file=sys.stderr, flush=True)
            finally:
                if os.path.exists(out):
                    os.unlink(out)
            settings.append(row)
            print(f"=== {task} epochs={ep}: {row}", flush=True)

    result = {
        "description": "env-steps and wall-s to the reference solved "
                       "threshold vs PPO update_epochs (sample reuse); "
                       "same hyperparameters as the committed "
                       "learning-curve artifacts.  Rows with a "
                       "'population' field carry a per-seed spread (K "
                       "seeds trained in one vmapped program, "
                       "rl/population.py); env_steps_to_threshold is then "
                       "the MEDIAN over crossing seeds",
        "reference_thresholds":
            "gym_pybullet_drones/examples/learn.py:78-83",
        "settings": settings,
    }
    path = os.path.join(ROOT, "artifacts", "ppo_epochs_pareto.json")
    if args.merge and os.path.exists(path):
        with open(path) as f:
            old = json.load(f)
        new_keys = {(r["task"], r["update_epochs"]) for r in settings}
        kept = [r for r in old["settings"]
                if (r["task"], r["update_epochs"]) not in new_keys]
        result["settings"] = sorted(
            kept + settings, key=lambda r: (r["task"], r["update_epochs"]))
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    print(f"[RESULT] -> {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
