"""Benchmark: Hover-DYN stepping rate on one GPU (4096 envs, RPM actions).

Prints the card (platform, device_kind, device count, nvidia-smi name and
power limit), then ONE JSON line {"metric", "value", "unit", "env_path",
"device"}.  Exits non-zero without a GPU: a CPU number is not a device
metric.

The env step is the one rl/ppo.py trains on (envs/fast.make_env_step).
Each timed window is a fixed jitted scan of STEPS control steps, ended by
block_until_ready; the value is the median over WINDOWS windows.
`time_windows` and `env_rollout` are the timer every benchmark script of
the repository uses (bench_all.py, scripts/bench_fused.py, chip_smoke.py).
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from gym_pybullet_drones_tpu import params as P
from gym_pybullet_drones_tpu.envs import AviaryConfig, HoverTask
from gym_pybullet_drones_tpu.envs.fast import make_env_step
from gym_pybullet_drones_tpu.utils.enums import ActionType, Physics
from gym_pybullet_drones_tpu.utils.platform import enable_compile_cache

NUM_ENVS = 4096
STEPS = 1024
WINDOWS = 10


def describe_device() -> dict:
    """Print and return the device; exit non-zero unless it is a GPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"needs a GPU, JAX found {dev.platform} ({dev.device_kind})")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    info = {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()), "card": card}
    print(f"device: {info}", flush=True)
    return info


def time_windows(fn, state, *args, windows: int = WINDOWS):
    """Compile fn(state, *args) -> (state, aux), run it once untimed, then
    time `windows` chained calls, each ended by block_until_ready.

    Returns (median seconds per call, compile seconds)."""
    t0 = time.perf_counter()
    comp = jax.jit(fn).lower(state, *args).compile()
    compile_s = time.perf_counter() - t0
    state, _ = jax.block_until_ready(comp(state, *args))
    times = []
    for _ in range(windows):
        t0 = time.perf_counter()
        state, _ = jax.block_until_ready(comp(state, *args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), compile_s


def env_rollout(step_fn):
    """(state, actions (T, B, ...)) -> (state, reward sum): one scan of
    step_fn over the actions, for time_windows."""
    def rollout(state, actions):
        def one_step(s, a):
            s, obs, r, te, tr = step_fn(s, a)
            # fold the observation into the output so XLA cannot
            # dead-code-eliminate it (the reference env.step returns one)
            return s, r + 1e-30 * jnp.sum(obs)
        s, r = jax.lax.scan(one_step, state, actions)
        return s, jnp.sum(r)
    return rollout


def random_actions(steps: int, num_envs: int, cfg, task, seed: int = 0):
    """(steps, num_envs, drones, action_dim) float32 actions of scale 0.1."""
    return 0.1 * jax.random.normal(
        jax.random.key(seed),
        (steps, num_envs, cfg.num_drones, task.action_dim(cfg)), jnp.float32)


def main():
    device = describe_device()
    enable_compile_cache()
    cfg = AviaryConfig(drone=P.CF2X, num_drones=1, physics=Physics.DYN,
                       pyb_freq=240, ctrl_freq=30)
    task = HoverTask(act=ActionType.RPM)
    path, reset_fn, step_fn = make_env_step(cfg, task, NUM_ENVS)
    sec, _ = time_windows(env_rollout(step_fn), reset_fn()[0],
                          random_actions(STEPS, NUM_ENVS, cfg, task))
    rate = NUM_ENVS * STEPS / sec
    print(json.dumps({
        "metric": "env_steps_per_sec_hover4096",
        "value": rate,
        "unit": "env-steps/s",
        "env_path": path,
        "device": device,
    }))


if __name__ == "__main__":
    main()
