"""Worker for the multi-process FUSED-kernel mesh test.

Usage: python tests/_dist_fused_worker.py <rank> <nproc> <port>

2 processes x 2 virtual CPU devices = a 4-device global mesh.  Runs the
multi-device configuration of the fused kernel —
`make_fused_rollout(mesh=global_mesh, interpret=True)`, the
shard_map-wrapped fully-fused rollout kernel — on Hover-DYN with one
kernel block of envs per shard, assembling the packed carry across
processes with `global_env_batch(env_axis=1)`, and asserts the stepped
results are BITWISE equal to the single-process unsharded fused path
(the kernel's lane math is env-elementwise, so any deviation is a
partitioning bug).  This is the one layer of the multi-host recipe the
in-process tests (tests/test_fused_mesh.py) cannot reach: the
global-array + multi-host-mesh + pallas_call interaction.

Reference counterpart: the substep x drone loops being scaled,
reference gym_pybullet_drones/envs/BaseAviary.py:343-372.
"""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

rank, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
jax.distributed.initialize(f"localhost:{port}", num_processes=nproc,
                           process_id=rank)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.experimental import multihost_utils  # noqa: E402

from gym_pybullet_drones_tpu import params as P  # noqa: E402
from gym_pybullet_drones_tpu.envs import AviaryConfig, HoverTask  # noqa: E402
from gym_pybullet_drones_tpu.envs.fast import make_fused_rollout  # noqa: E402
from gym_pybullet_drones_tpu.ops.pallas_fused import BLOCK  # noqa: E402
from gym_pybullet_drones_tpu.parallel import make_mesh  # noqa: E402
from gym_pybullet_drones_tpu.parallel.distributed import (  # noqa: E402
    global_env_batch)
from gym_pybullet_drones_tpu.utils.enums import (  # noqa: E402
    ActionType, Physics)

assert jax.process_count() == nproc, jax.process_count()
n_dev = len(jax.devices())
assert n_dev == 2 * nproc, n_dev

GLOBAL_ENVS = 2 * BLOCK * n_dev    # two kernel blocks per device shard
LOCAL_ENVS = GLOBAL_ENVS // nproc
N_STEPS = 3

cfg = AviaryConfig(drone=P.CF2X, num_drones=1, physics=Physics.DYN,
                   pyb_freq=240, ctrl_freq=30)
task = HoverTask(act=ActionType.RPM)
mesh = make_mesh(jax.devices())

# deterministic reset is identical on every host: compute the full packed
# carry locally, carve this host's lane slice, assemble the global sharded
# carry with no cross-host data movement (envs live in the LANE axis)
reset_unsharded, step_unsharded = make_fused_rollout(
    cfg, task, GLOBAL_ENVS, interpret=True)
carry0_full, obs0_full = reset_unsharded()
lo, hi = rank * LOCAL_ENVS, (rank + 1) * LOCAL_ENVS
carry = global_env_batch(mesh, np.asarray(carry0_full)[:, lo:hi],
                         env_axis=1)
assert carry.shape == carry0_full.shape, (carry.shape, carry0_full.shape)

# the sharded step: shard_map'd fused kernel on the mesh
_, step_sharded = make_fused_rollout(cfg, task, GLOBAL_ENVS, mesh=mesh,
                                     interpret=True)

# slightly asymmetric actions so lanes are distinguishable across shards
act_full = (0.02 * np.sin(np.arange(GLOBAL_ENVS, dtype=np.float32))
            ).reshape(GLOBAL_ENVS, 1, 1) * np.ones(
                (GLOBAL_ENVS, cfg.num_drones, 4), np.float32)
action = global_env_batch(mesh, act_full[lo:hi])


@jax.jit
def run(carry, action):
    outs = []
    for _ in range(N_STEPS):
        carry, obs, r, te, tr = step_sharded(carry, action)
        outs.append((obs, r, te, tr))
    return carry, outs


carry_s, outs_s = run(carry, action)

# fetch the globally-sharded results on every host (collective), then
# compare on rank 0 against the SINGLE-PROCESS unsharded fused rollout
carry_s_full = multihost_utils.process_allgather(carry_s, tiled=True)
outs_s_full = multihost_utils.process_allgather(outs_s, tiled=True)


@jax.jit
def run_ref(carry, action):
    outs = []
    for _ in range(N_STEPS):
        carry, obs, r, te, tr = step_unsharded(carry, action)
        outs.append((obs, r, te, tr))
    return carry, outs


if rank == 0:
    carry_r, outs_r = run_ref(carry0_full, jnp.asarray(act_full))
    np.testing.assert_array_equal(np.asarray(carry_s_full),
                                  np.asarray(carry_r))
    for t, (s_t, r_t) in enumerate(zip(outs_s_full, outs_r)):
        for name, a, b in zip(("obs", "reward", "term", "trunc"),
                              s_t, r_t):
            np.testing.assert_array_equal(
                np.asarray(a), np.asarray(b),
                err_msg=f"step {t} {name} diverged (sharded vs unsharded)")
    # sanity: the physics actually moved and lanes differ
    assert not np.array_equal(np.asarray(carry_s_full),
                              np.asarray(carry0_full))
    obs_last = np.asarray(outs_s_full[-1][0])
    assert np.unique(obs_last[:, 2]).size > 4, "lanes indistinguishable"

print(f"DIST FUSED OK rank={rank} envs={GLOBAL_ENVS} steps={N_STEPS}",
      flush=True)
