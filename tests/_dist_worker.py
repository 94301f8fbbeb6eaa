"""Worker process for the multi-process distributed test.

Usage: python tests/_dist_worker.py <rank> <nproc> <port>

Each process owns 2 virtual CPU devices; together they form a 2-host
cluster whose global mesh spans (nproc * 2) devices.  Exercises the
multi-host recipe of parallel/distributed.py end to end: distributed
runtime init -> global mesh -> per-host local env reset ->
global_env_batch assembly (no cross-host data movement) -> shard_map'd
env stepping on the global array -> a cross-process reduction fetched
on every host.
"""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from gym_pybullet_drones_tpu.parallel.distributed import (  # noqa: E402
    global_env_batch, initialize)

rank, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
assert initialize(f"localhost:{port}", num_processes=nproc,
                  process_id=rank) == rank

import jax.numpy as jnp  # noqa: E402

from gym_pybullet_drones_tpu import params as P  # noqa: E402
from gym_pybullet_drones_tpu.envs import AviaryConfig, HoverTask  # noqa: E402
from gym_pybullet_drones_tpu.envs.fast import make_batched_step  # noqa: E402
from gym_pybullet_drones_tpu.parallel import make_mesh  # noqa: E402
from gym_pybullet_drones_tpu.utils.enums import (  # noqa: E402
    ActionType, Physics)

assert jax.process_count() == nproc, jax.process_count()
n_global_dev = len(jax.devices())
assert n_global_dev == 2 * nproc, n_global_dev

LOCAL_ENVS = 8
GLOBAL_ENVS = LOCAL_ENVS * nproc

cfg = AviaryConfig(drone=P.CF2X, num_drones=1, physics=Physics.DYN,
                   pyb_freq=240, ctrl_freq=30)
task = HoverTask(act=ActionType.RPM)

mesh = make_mesh(jax.devices())

# per-host local reset (each host materializes only its own shard), then
# assemble the global sharded env state without data movement
local_reset, _ = make_batched_step(cfg, task, LOCAL_ENVS)
local_state, local_obs = local_reset(seed=rank)
state = global_env_batch(mesh, local_state)
assert state.pos.shape[0] == GLOBAL_ENVS

# the global step: shard_map'd over the mesh (envs/fast.py mesh= path)
_, step_fn = make_batched_step(cfg, task, GLOBAL_ENVS, mesh=mesh)


@jax.jit
def run3(state, action):
    r_sum = jnp.zeros((), jnp.float32)
    for _ in range(3):
        state, obs, r, te, tr = step_fn(state, action)
        r_sum = r_sum + jnp.sum(r) + 1e-30 * jnp.sum(obs)
    return state, r_sum


local_act = 0.05 * jnp.ones((LOCAL_ENVS, cfg.num_drones, 4), jnp.float32)
action = global_env_batch(mesh, local_act)
state, r_sum = run3(state, action)
# r_sum is fully replicated -> addressable on every host
total = float(r_sum)
assert 0.0 < total < 2.0 * 3 * GLOBAL_ENVS, total
assert len(state.pos.sharding.device_set) == n_global_dev
print(f"DIST OK rank={rank} total_reward={total:.3f}", flush=True)
