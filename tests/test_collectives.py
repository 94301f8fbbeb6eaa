"""Communication-pattern assertions on the compiled multi-chip programs.

VERDICT.md round-1 item #7: prove (in a test, from the optimized HLO) that
- the sharded ENV STEP inserts ZERO collectives — environment physics is
  embarrassingly parallel along the env axis, so any collective would be a
  partitioning bug, and
- the sharded PPO UPDATE communicates only via all-reduce (the gradient /
  scalar-metric reductions) — never all-gather / all-to-all /
  collective-permute, i.e. rollout data is NEVER gathered across the mesh.

Runs on the virtual 8-device CPU mesh from conftest; the partitioning
decisions asserted here are backend-independent (GSPMD runs before backend
lowering), so the same program keeps the same communication pattern on a
real multi-GPU mesh.
"""
import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from gym_pybullet_drones_tpu import params as PR
from gym_pybullet_drones_tpu.envs import AviaryConfig, HoverTask, core
from gym_pybullet_drones_tpu.envs.fast import make_batched_step
from gym_pybullet_drones_tpu.parallel import (
    make_mesh, make_sharded_update, shard_train_state)
from gym_pybullet_drones_tpu.rl import PPOConfig, make_train
from gym_pybullet_drones_tpu.utils.enums import ActionType, Physics

COLLECTIVES = ("all-reduce", "all-gather", "all-to-all", "reduce-scatter",
               "collective-permute")


def _collective_counts(hlo_text: str) -> dict:
    counts = {}
    for name in COLLECTIVES:
        # HLO instruction names: all-reduce(.N), all-reduce-start, fused ...
        counts[name] = len(re.findall(rf"\b{name}[.\-(]", hlo_text))
    return counts


def _setup(num_envs):
    cfg = AviaryConfig(drone=PR.CF2X, num_drones=1, physics=Physics.DYN,
                      pyb_freq=240, ctrl_freq=30)
    task = HoverTask(act=ActionType.RPM)
    return cfg, task


def _kernel_matrix():
    """Three kernel configurations (VERDICT.md round-2 "Next #4"): the
    independent-drone DYN path, the drone-coupled PYB contact+aero path
    (downwash + drone-drone contact couple drones WITHIN an env but never
    across envs, so the env axis must still shard collective-free), and the
    routing fork's embedded-PID task with its cross-drone adjacency obs."""
    from gym_pybullet_drones_tpu.envs import (
        MultiHoverTask, make_routing_config)
    cfg_h, task_h = _setup(16)
    cfg_m = AviaryConfig(drone=PR.CF2X, num_drones=2,
                         physics=Physics.PYB_GND_DRAG_DW,
                         pyb_freq=240, ctrl_freq=30,
                         init_xyzs=((0.0, 0.0, 0.15), (0.3, 0.0, 0.6)))
    task_m = MultiHoverTask(act=ActionType.RPM)
    cfg_r, task_r = make_routing_config(num_drones=3, spacing=0.4)
    return [
        ("hover-dyn-rpm", cfg_h, task_h),
        ("multihover-pyb-gnd-drag-dw", cfg_m, task_m),
        ("routing-pid", cfg_r, task_r),
    ]


@pytest.mark.parametrize("kernel", [k[0] for k in _kernel_matrix()])
def test_env_step_compiles_with_zero_collectives(kernel):
    mesh = make_mesh(jax.devices()[:8])
    num_envs = 16
    cfg, task = dict((k, (c, t)) for k, c, t in _kernel_matrix())[kernel]
    n = cfg.num_drones
    reset_fn, step_fn = make_batched_step(cfg, task, num_envs,
                                          autoreset=True, mesh=mesh)
    state, obs = reset_fn()
    shard = NamedSharding(mesh, P("data"))
    state = jax.tree.map(
        lambda x: jax.device_put(x, shard) if x.ndim >= 1 and
        x.shape[0] in (num_envs, num_envs * n) else jax.device_put(
            x, NamedSharding(mesh, P())), state)
    action = jax.device_put(
        jnp.zeros((num_envs, n, task.action_dim(cfg)), jnp.float32), shard)

    lowered = jax.jit(step_fn).lower(state, action)
    hlo = lowered.compile().as_text()
    counts = _collective_counts(hlo)
    assert all(v == 0 for v in counts.values()), \
        f"env step must be communication-free, got {counts}"

    # and it actually runs sharded
    out = jax.jit(step_fn)(state, action)
    jax.block_until_ready(out)
    assert len(out[0].pos.sharding.device_set) == 8


@pytest.mark.parametrize("kernel", [k[0] for k in _kernel_matrix()])
def test_ppo_update_all_reduce_only(kernel):
    """The sharded train step's ONLY collective is all-reduce (gradients +
    scalar metrics); rollout-sized tensors are never gathered."""
    mesh = make_mesh(jax.devices()[:8])
    cfg, task = dict((k, (c, t)) for k, c, t in _kernel_matrix())[kernel]
    ppo = PPOConfig(num_envs=16, rollout_steps=8, num_minibatches=2,
                    update_epochs=2)
    init, update, _, _ = make_train(cfg, task, ppo, mesh=mesh)
    ts = init(jax.random.key(0))
    ts = shard_train_state(ts, mesh)
    sharded_update = make_sharded_update(update, mesh)

    lowered = sharded_update.lower(ts)
    hlo = lowered.compile().as_text()
    counts = _collective_counts(hlo)
    assert counts["all-reduce"] >= 1, "gradient all-reduce missing"
    for bad in ("all-gather", "all-to-all", "collective-permute"):
        assert counts[bad] == 0, \
            f"unexpected {bad} in the train step: {counts}"

    # no all-reduce may touch a rollout-sized tensor: every all-reduce
    # operand must be parameter-sized or smaller (<= biggest layer), far
    # below T*E*obs size
    rollout_elems = (ppo.rollout_steps * ppo.num_envs
                     * max(72, cfg.num_drones * task.obs_dim(cfg)))
    for m in re.finditer(r"all-reduce[^=]*=\s*([a-z0-9]+)\[([0-9,]*)\]",
                         hlo):
        dims = [int(d) for d in m.group(2).split(",") if d]
        size = int(np.prod(dims)) if dims else 1
        assert size <= rollout_elems, \
            f"all-reduce of rollout-sized tensor {dims}"
