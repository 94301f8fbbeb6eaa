"""PPO training on HoverAviary / MultiHoverAviary — fully on device.

Counterpart of reference examples/learn.py (same CLI flags, same reward
thresholds 474.15/949.5 for ONE_D_RPM and 467/920 otherwise, same
1e7-local / 1e2-test training budgets), with the SB3 learner replaced by the
on-device JAX PPO (gym_pybullet_drones_tpu.rl): env physics, rollout, GAE,
and updates are one jitted program, so there is no env<->learner host
boundary to cross.
"""
import argparse
import os
import pickle
import time
from datetime import datetime

import numpy as np

import jax
import jax.numpy as jnp

from gym_pybullet_drones_tpu import params as P
from gym_pybullet_drones_tpu.envs import (
    AviaryConfig, HoverAviary, HoverTask, MultiHoverAviary, MultiHoverTask)
from gym_pybullet_drones_tpu.rl import PPOConfig, make_train
from gym_pybullet_drones_tpu.utils.enums import ActionType, ObservationType, Physics
from gym_pybullet_drones_tpu.utils.logger import Logger
from gym_pybullet_drones_tpu.utils.utils import sync, str2bool

DEFAULT_GUI = False
DEFAULT_RECORD_VIDEO = False
DEFAULT_OUTPUT_FOLDER = "results"
DEFAULT_COLAB = False
DEFAULT_OBS = ObservationType("kin")
DEFAULT_ACT = ActionType("one_d_rpm")
DEFAULT_AGENTS = 2
DEFAULT_MA = False


def run(multiagent=DEFAULT_MA, output_folder=DEFAULT_OUTPUT_FOLDER,
        gui=DEFAULT_GUI, plot=True, colab=DEFAULT_COLAB,
        record_video=DEFAULT_RECORD_VIDEO, local=True,
        obs=DEFAULT_OBS, act=DEFAULT_ACT, num_envs=64, seed=0):
    filename = os.path.join(
        output_folder,
        "save-" + datetime.now().strftime("%m.%d.%Y_%H.%M.%S"))
    os.makedirs(filename, exist_ok=True)

    num_drones = DEFAULT_AGENTS if multiagent else 1
    env_cfg = AviaryConfig(drone=P.CF2X, num_drones=num_drones,
                           physics=Physics.PYB, pyb_freq=240, ctrl_freq=30)
    task_cls = MultiHoverTask if multiagent else HoverTask
    task = task_cls(act=ActionType(act), obs=ObservationType(obs))

    # reward thresholds (reference learn.py:78-83)
    if ActionType(act) == ActionType.ONE_D_RPM:
        target_reward = 949.5 if multiagent else 474.15
    else:
        target_reward = 920.0 if multiagent else 467.0

    total_timesteps = int(1e7) if local else int(1e2)
    ppo = PPOConfig(num_envs=num_envs, rollout_steps=64,
                    num_minibatches=4, update_epochs=10,
                    total_timesteps=total_timesteps)
    init, update, evaluate, network = make_train(env_cfg, task, ppo)
    dev = jax.devices()[0]
    print(f"[INFO] training on {dev.platform} ({dev.device_kind}), "
          f"env path {update.env_path}")

    ts = init(jax.random.key(seed))
    upd = jax.jit(update)
    # reference eval protocol: episodic accounting over the full
    # episode_len_sec*ctrl_freq + 2 control steps (QUIRKS.md #11) —
    # evaluate() derives that step count from the task by default
    eval_fn = jax.jit(lambda p, k: evaluate(p, k, episodic=True))

    start = time.time()
    best_eval = -np.inf
    num_updates = max(1, total_timesteps // ppo.batch_size)
    for u in range(num_updates):
        ts, metrics = upd(ts)
        if u % 10 == 0 or u == num_updates - 1:
            rets = eval_fn(ts.params, jax.random.key(u))
            mean_ret = float(jnp.mean(rets))
            print(f"update {u}/{num_updates} steps={ (u+1)*ppo.batch_size} "
                  f"eval_return={mean_ret:.2f} "
                  f"mean_reward={float(metrics['mean_reward']):.3f} "
                  f"({time.time()-start:.0f}s)")
            if mean_ret > best_eval:
                best_eval = mean_ret
                with open(os.path.join(filename, "best_model.pkl"), "wb") as f:
                    pickle.dump(jax.tree.map(np.asarray, ts.params), f)
            if mean_ret >= target_reward:
                print(f"[INFO] reached target reward {target_reward}; "
                      "stopping early")
                break
    with open(os.path.join(filename, "final_model.pkl"), "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, ts.params), f)
    print(f"[RESULT] best eval return {best_eval:.2f} "
          f"(target {target_reward})")

    # ---- replay the trained policy in the class-based env ----
    env_cls = MultiHoverAviary if multiagent else HoverAviary
    test_env = env_cls(gui=gui, obs=ObservationType(obs),
                       act=ActionType(act), record=record_video) \
        if multiagent else env_cls(gui=gui, obs=ObservationType(obs),
                                   act=ActionType(act), record=record_video)
    logger = Logger(logging_freq_hz=test_env.CTRL_FREQ,
                    num_drones=num_drones, output_folder=output_folder,
                    colab=colab)
    obs_arr, info = test_env.reset(seed=42)
    start = time.time()
    total_r = 0.0
    for i in range(int(test_env.EPISODE_LEN_SEC + 2) * test_env.CTRL_FREQ):
        flat = jnp.asarray(obs_arr.reshape(1, -1))
        mean, _, _ = network.apply(ts.params, flat)
        action = np.asarray(mean).reshape(num_drones, -1)
        obs_arr, reward, terminated, truncated, _ = test_env.step(action)
        total_r += reward
        for d in range(num_drones):
            state20 = test_env.getDroneStateVector(d)
            logger.log(drone=d, timestamp=i / test_env.CTRL_FREQ,
                       state=state20)
        if gui:
            test_env.render()
            sync(i, start, test_env.CTRL_TIMESTEP)
        if terminated or truncated:
            obs_arr, info = test_env.reset(seed=42)
    test_env.close()
    print(f"[RESULT] replay accumulated reward {total_r:.2f}")
    if plot and ObservationType(obs) == ObservationType.KIN:
        logger.plot()
    return best_eval


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description="PPO hover example")
    parser.add_argument("--multiagent", default=DEFAULT_MA, type=str2bool,
                        help="single or multi-agent", metavar="")
    parser.add_argument("--gui", default=DEFAULT_GUI, type=str2bool,
                        metavar="")
    parser.add_argument("--record_video", default=DEFAULT_RECORD_VIDEO,
                        type=str2bool, metavar="")
    parser.add_argument("--output_folder", default=DEFAULT_OUTPUT_FOLDER,
                        type=str, metavar="")
    parser.add_argument("--colab", default=DEFAULT_COLAB, type=bool,
                        metavar="")
    parser.add_argument("--local", default=True, type=str2bool,
                        help="full budget if True, smoke budget if False",
                        metavar="")
    parser.add_argument("--num_envs", default=64, type=int,
                        help="parallel envs for the on-device learner",
                        metavar="")
    ARGS = parser.parse_args()
    run(**vars(ARGS))
