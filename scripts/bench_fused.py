"""A/B on one GPU: the fused env-step kernel vs the XLA batched step.

The measurement behind envs/fast.select_env_path and its
FUSED_MAX_DRONES.  For each family the kernel covers (RPM and PID-family
actions at 1 and 2 drones, routing with the embedded PID at 3 and 4
drones) and for PPO Hover training, both paths run the same work in the
order XLA, fused, fused, XLA.  Each rate is the median of WINDOWS windows
of bench.time_windows; each compile time is printed beside it.

Usage: python scripts/bench_fused.py [--out FILE]   (exits non-zero
without a GPU)
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from unittest import mock

import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from bench import (describe_device, env_rollout,  # noqa: E402
                   random_actions, time_windows)
from gym_pybullet_drones_tpu import params as P  # noqa: E402
from gym_pybullet_drones_tpu.envs import (  # noqa: E402
    AviaryConfig, HoverTask, MultiHoverTask, make_routing_config)
from gym_pybullet_drones_tpu.envs import fast  # noqa: E402
from gym_pybullet_drones_tpu.rl import PPOConfig, make_train  # noqa: E402
from gym_pybullet_drones_tpu.utils.enums import (  # noqa: E402
    ActionType, Physics)
from gym_pybullet_drones_tpu.utils.platform import (  # noqa: E402
    enable_compile_cache)

NUM_ENVS = 4096
STEPS = 256
WINDOWS = 5
PPO = PPOConfig(num_envs=8192, rollout_steps=64, num_minibatches=4,
                update_epochs=4)
PPO_CHAIN = 4


def _dyn(n):
    return AviaryConfig(drone=P.CF2X, num_drones=n, physics=Physics.DYN,
                        pyb_freq=240, ctrl_freq=30)


ENV_CONFIGS = {
    "hover-dyn-rpm": (_dyn(1), HoverTask(act=ActionType.RPM)),
    "hover-dyn-vel": (_dyn(1), HoverTask(act=ActionType.VEL)),
    "multihover2-dyn-rpm": (_dyn(2), MultiHoverTask(act=ActionType.RPM)),
    "multihover2-dyn-vel": (_dyn(2), MultiHoverTask(act=ActionType.VEL)),
    "routing3-dyn-pid": make_routing_config(num_drones=3,
                                            physics=Physics.DYN),
    "routing4-dyn-pid": make_routing_config(num_drones=4,
                                            physics=Physics.DYN),
}


def env_ab(cfg, task):
    """{path: [(env-steps/s, compile s), ...]} in the order x, f, f, x."""
    actions = random_actions(STEPS, NUM_ENVS, cfg, task)
    paths = {"xla": fast.make_batched_step(cfg, task, NUM_ENVS,
                                           obs_layout="flat"),
             "fused": fast.make_fused_rollout(cfg, task, NUM_ENVS)}
    out = {}
    for path in ("xla", "fused", "fused", "xla"):
        reset_fn, step_fn = paths[path]
        sec, comp = time_windows(env_rollout(step_fn), reset_fn()[0],
                                 actions, windows=WINDOWS)
        out.setdefault(path, []).append((NUM_ENVS * STEPS / sec, comp))
    return out


def ppo_ab():
    """PPO Hover 8192 env-steps/s of update.many, on each env path (the
    XLA side by overriding the path rule for this measurement only)."""
    cfg, task = _dyn(1), HoverTask(act=ActionType.RPM)
    out = {}
    for path in ("xla", "fused", "fused", "xla"):
        rule = (lambda *a, **k: "batched") if path == "xla" \
            else fast.select_env_path
        with mock.patch.object(fast, "select_env_path", rule):
            init, update, _, _ = make_train(cfg, task, PPO)
        assert update.env_path == {"xla": "batched"}.get(path, path)
        sec, comp = time_windows(lambda t, u=update: u.many(t, PPO_CHAIN),
                                 init(jax.random.key(0)), windows=WINDOWS)
        out.setdefault(path, []).append(
            (PPO_CHAIN * PPO.batch_size / sec, comp))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write JSON here")
    args = ap.parse_args()
    device = describe_device()
    enable_compile_cache()
    results = {}
    runs = [(f"{name} {NUM_ENVS} envs", lambda c=cfg, t=task: env_ab(c, t))
            for name, (cfg, task) in ENV_CONFIGS.items()]
    runs.append((f"ppo-hover {PPO.num_envs} envs update.many({PPO_CHAIN})",
                 ppo_ab))
    for label, run in runs:
        results[label] = run()
        print(f"{label} (env-steps/s, compile s): {results[label]}",
              flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": device, "results": results}, f, indent=1)


if __name__ == "__main__":
    main()
