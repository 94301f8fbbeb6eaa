"""Batched env stepping: the two paths and the rule that picks one.

- make_batched_step: the general, inspectable path.  The env batch is
  kept as explicit leading axes with the (env, drone) axes of the scan
  carry collapsed to (B*N, k); physics runs through the XLA kernels of
  envs/core.py and the task logic through the tasks' flat hooks (or their
  vmapped per-env methods).  Handles every configuration: PYB-family
  physics, randomised resets, RGB observations, float64.
- make_fused_rollout: the whole control step as ONE Pallas launch
  (ops/pallas_fused.py) with a one-buffer carry, for the configurations
  `fused_ineligibility` accepts (DYN physics, KIN observations,
  deterministic resets).  It compiles through Triton for the GPU;
  elsewhere it runs only in the Pallas interpreter, when asked to.
- make_env_step: picks one by `select_env_path` — the fused kernel where
  it is eligible, measured faster (at most FUSED_MAX_DRONES drones per
  env) and the backend is the GPU, the XLA step otherwise.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from gym_pybullet_drones_tpu.envs import core
from gym_pybullet_drones_tpu.utils.enums import (
    ActionType, ObservationType, Physics)


def make_batched_step(cfg: core.AviaryConfig, task, num_envs: int,
                      autoreset: bool = True, dtype=jnp.float32, mesh=None,
                      obs_layout: str = "drone"):
    """Build step_fn over batched EnvState with a flattened (B*N, ...) carry.

    Returns (reset_fn, step_fn); reset_fn(seed) -> (state, obs);
    step_fn(state, action) -> (state, obs, reward, term, trunc) with per-env
    leading axes on the outputs (obs (B, N, D), reward/term/trunc (B,)).

    mesh: optional jax.sharding.Mesh — step_fn is then wrapped in shard_map
    along the mesh's first axis (env-batch data parallelism; num_envs must
    divide evenly).

    obs_layout: "drone" -> obs (B, N, D) (reference per-drone layout);
    "flat" -> obs (B, N*D), the layout learners that flatten anyway
    (rl/ppo.py) consume.
    """
    if obs_layout not in ("drone", "flat"):
        raise ValueError(f"unknown obs_layout {obs_layout!r}")
    n = cfg.num_drones
    buf_len, act_dim = task.action_buffer_shape(cfg)

    batched_reset = jax.vmap(
        lambda k: core.reset(cfg, task, key=k, dtype=dtype))

    def _flatten(s: core.EnvState) -> core.EnvState:
        # -1: under shard_map the leaves are the LOCAL shard, not num_envs
        r2 = lambda x: x.reshape((-1,) + x.shape[2:])
        return s._replace(
            pos=r2(s.pos), quat=r2(s.quat), vel=r2(s.vel),
            rpy_rates=r2(s.rpy_rates), ang_v=r2(s.ang_v),
            last_rpm=r2(s.last_rpm),
            # explicit leading product: a -1 reshape is ill-posed when the
            # task has no action buffer (buf_len * act_dim == 0)
            action_buffer=s.action_buffer.reshape(
                s.action_buffer.shape[0] * s.action_buffer.shape[1],
                buf_len * act_dim),
            ctrl_state=jax.tree.map(r2, s.ctrl_state))

    def _unflatten(s: core.EnvState) -> core.EnvState:
        # infer the env count from the leaves: under shard_map each shard
        # sees its LOCAL slice, not the global num_envs
        r3 = lambda x: x.reshape((-1, n) + x.shape[1:])
        return s._replace(
            pos=r3(s.pos), quat=r3(s.quat), vel=r3(s.vel),
            rpy_rates=r3(s.rpy_rates), ang_v=r3(s.ang_v),
            last_rpm=r3(s.last_rpm),
            action_buffer=s.action_buffer.reshape(
                s.action_buffer.shape[0] // n, n, buf_len, act_dim),
            ctrl_state=jax.tree.map(r3, s.ctrl_state))

    def reset_fn(seed: int = 0):
        keys = jax.random.split(jax.random.PRNGKey(seed), num_envs)
        state, obs, _ = batched_reset(keys)
        if obs_layout == "flat" and obs.ndim == 3:
            obs = obs.reshape(obs.shape[0], -1)
        return _flatten(state), obs

    def _finalize_obs(obs):
        """Flat-hook 2-D obs (B*N, D) -> the requested output layout."""
        if obs.ndim != 2:
            return obs  # vmapped fallback already returns (B, N, ...)
        lb = obs.shape[0] // n
        if obs_layout == "drone":
            return obs.reshape(lb, n, obs.shape[1])
        return obs.reshape(lb, n * obs.shape[1])

    def _physics(flat: core.EnvState, flat_rpm: jnp.ndarray):
        """Advance the physics on the flattened carry."""
        # the core substep kernels broadcast over the flat (B*N, k) batch
        # directly for the per-drone physics; downwash and drone-drone
        # contact couple drones within an env, so those configurations
        # keep the (B, N, k) structure via vmap.
        drone_coupled = (
            cfg.physics in (Physics.PYB_DW, Physics.PYB_GND_DRAG_DW)
            or (cfg.physics != Physics.DYN and n > 1))
        if drone_coupled:
            def sub(s, r):
                for _ in range(cfg.steps_per_ctrl):
                    s = core._apply_physics_substep(cfg, s, r)
                return s
            st = jax.vmap(sub)(_unflatten(flat),
                               flat_rpm.reshape(-1, n, 4))
            return _flatten(st)
        s = flat
        for _ in range(cfg.steps_per_ctrl):
            s = core._apply_physics_substep(cfg, s, flat_rpm)
        return s

    # ---- task pre/post: flat hooks with vmapped fallback ----
    has_flat_post = getattr(task, "flat_post", None) is not None
    has_flat_pre = getattr(task, "_map_to_rpm", None) is not None

    vmapped_pre = jax.vmap(lambda s, a: task.preprocess_action(cfg, s, a))
    vmapped_post = jax.vmap(lambda s: (task.compute_obs(cfg, s),
                                       task.compute_reward(cfg, s),
                                       task.compute_terminated(cfg, s),
                                       task.compute_truncated(cfg, s)))

    def _pre(flat: core.EnvState, action):
        """action (B, N, A) -> (rpm (B*N, 4), updated flat state)."""
        if not has_flat_pre:
            rpm, view = vmapped_pre(_unflatten(flat), action)
            return rpm.reshape(-1, 4), _flatten(view)
        a = action.reshape(-1, act_dim)
        if buf_len > 0:
            buf = jnp.concatenate(
                [flat.action_buffer[:, act_dim:], a], axis=-1)
            flat = flat._replace(action_buffer=buf)
        rpm, flat = task._map_to_rpm(cfg, flat, a)
        return rpm, flat

    def _post(flat: core.EnvState):
        if has_flat_post:
            out = task.flat_post(cfg, flat, flat.pos.shape[0] // n, n)
            if out is not None:
                return out
        return vmapped_post(_unflatten(flat))

    # Deterministic tasks (no reset noise) re-reset to a CONSTANT state:
    # precompute it once (eagerly; the concrete arrays become trace-time
    # constants of step_fn) instead of running the whole vmapped reset
    # inside every scan iteration.
    randomized = _randomized_reset(task)
    if autoreset and not randomized:
        # ONE env's reset (leaves (N, ...)), tiled to the runtime batch per
        # local shard size (shard_map traces see the local size)
        _s1, _obs1, _ = jax.jit(
            lambda: core.reset(cfg, task, dtype=dtype))()
        _s1_host = jax.tree.map(lambda x: np.asarray(x), _s1)
        _obs1_host = np.asarray(_obs1)

    @functools.lru_cache(maxsize=8)
    def _tiled_init_consts(local_bn: int):
        # numpy-only (cached across traces; jax arrays created inside a
        # trace are tracers and must NOT be cached — jnp conversion happens
        # per trace in _tiled_init)
        lb = local_bn // n
        t = lambda x: np.ascontiguousarray(np.broadcast_to(
            x[None], (lb,) + x.shape).reshape((local_bn,) + x.shape[1:]))
        state = _s1_host._replace(
            pos=t(_s1_host.pos), quat=t(_s1_host.quat), vel=t(_s1_host.vel),
            rpy_rates=t(_s1_host.rpy_rates), ang_v=t(_s1_host.ang_v),
            last_rpm=t(_s1_host.last_rpm),
            action_buffer=t(_s1_host.action_buffer).reshape(
                local_bn, buf_len * act_dim),
            ctrl_state=jax.tree.map(t, _s1_host.ctrl_state),
            step_counter=np.zeros((lb,), np.int32),
            rng=None)
        obs = np.ascontiguousarray(np.broadcast_to(
            _obs1_host[None], (lb,) + _obs1_host.shape))
        return state, obs

    def _tiled_init(local_bn: int, rng):
        """Constant (local_bn, ...) flat reset state (see cache above)."""
        state, obs = _tiled_init_consts(local_bn)
        state = jax.tree.map(jnp.asarray, state)
        return state._replace(rng=rng), jnp.asarray(obs)

    def step_fn(flat: core.EnvState, action):
        action = jnp.asarray(action, flat.pos.dtype)
        rpm, flat = _pre(flat, action)
        flat = _physics(flat, rpm)
        # hooks see the PRE-increment counter (reference BaseAviary.py:376-382)
        obs, reward, term, trunc = _post(flat)
        flat = flat._replace(
            step_counter=flat.step_counter + cfg.steps_per_ctrl)
        if not autoreset:
            return flat, _finalize_obs(obs), reward, term, trunc
        done = jnp.logical_or(term, trunc)                     # (B,)
        local_bn = flat.pos.shape[0]
        local_b = local_bn // n
        if randomized:
            # per-env re-reset from each env's carried key (randomized
            # tasks re-randomize)
            init_state, init_obs, _ = jax.vmap(
                lambda k: core.reset(cfg, task, key=k, dtype=dtype))(
                    flat.rng)
            r2 = lambda x: x.reshape((local_bn,) + x.shape[2:])
            init_flat = init_state._replace(
                pos=r2(init_state.pos), quat=r2(init_state.quat),
                vel=r2(init_state.vel), rpy_rates=r2(init_state.rpy_rates),
                ang_v=r2(init_state.ang_v), last_rpm=r2(init_state.last_rpm),
                action_buffer=init_state.action_buffer.reshape(
                    local_bn, buf_len * act_dim),
                ctrl_state=jax.tree.map(r2, init_state.ctrl_state))
        else:
            # constant re-reset (single-env reset broadcast at trace time);
            # keep the rng carry inert
            init_flat, init_obs = _tiled_init(local_bn, flat.rng)
        done_bn = jnp.broadcast_to(done[:, None], (local_b, n)).reshape(
            local_bn)

        def pick(i, nxt):
            d = done_bn if nxt.shape[:1] == (local_bn,) else done
            d = d.reshape(d.shape + (1,) * (nxt.ndim - 1))
            return jnp.where(d, i, nxt)
        flat = jax.tree.map(pick, init_flat, flat)
        flat = flat._replace(rng=init_flat.rng)
        if obs.ndim == 2:
            # flat-hook obs (B*N, D): select per flattened row, lay out last
            obs = jnp.where(done_bn[:, None],
                            init_obs.reshape(local_bn, obs.shape[1]), obs)
        else:
            d = done.reshape((local_b,) + (1,) * (obs.ndim - 1))
            obs = jnp.where(d, init_obs, obs)
        return flat, _finalize_obs(obs), reward, term, trunc

    if mesh is not None:
        # the env step is embarrassingly parallel along the env axis: each
        # device steps its local shard, no collectives are introduced
        from jax import shard_map
        from jax.sharding import PartitionSpec
        spec = PartitionSpec(mesh.axis_names[0])
        inner = step_fn

        def step_fn(flat, action):  # noqa: F811 - sharded wrapper
            return shard_map(
                inner, mesh=mesh,
                in_specs=(spec, spec), out_specs=spec,
                check_vma=False)(flat, action)

    return reset_fn, step_fn


def _randomized_reset(task) -> bool:
    return any(getattr(task, f, 0.0)
               for f in ("reset_pos_noise", "reset_rpy_noise",
                         "reset_vel_noise"))


_FUSED_ACTIONS = (ActionType.RPM, ActionType.ONE_D_RPM, ActionType.PID,
                  ActionType.VEL, ActionType.ONE_D_PID)


def fused_ineligibility(cfg: core.AviaryConfig, task,
                        dtype=jnp.float32) -> str | None:
    """Why the fused kernel cannot step (cfg, task, dtype), or None.

    The kernel covers float32, DYN physics, KIN observations, every action
    type (PID-family actions carry the embedded DSL-PID state as 9 extra
    rows per drone), and deterministic resets of a task implementing
    `row_post`.
    """
    if cfg.physics != Physics.DYN:
        return ("the fused kernel covers DYN physics only; the PYB family "
                "runs on the XLA batched step")
    if jnp.dtype(dtype) != jnp.float32:
        return "the fused kernel computes in float32"
    if getattr(task, "obs", None) != ObservationType.KIN:
        return "the fused kernel requires KIN observations"
    if getattr(task, "act", None) not in _FUSED_ACTIONS:
        return f"the fused kernel does not support {task.act}"
    if getattr(task, "row_post", None) is None:
        return "task has no row_post hook"
    if _randomized_reset(task):
        return "the fused kernel requires deterministic resets"
    return None


# Most drones per env for which select_env_path picks the fused kernel:
# where its longer compile is won back within a minute of stepping.  The
# kernel unrolls every drone of an env into one thread, so its Triton
# compile grows with the drone count.  On an H100 (scripts/bench_fused.py,
# 4096 envs, PERF.md): 1-2 drones compile in 4-33 s and step 2.9-4.2x
# faster than the XLA step (won back in under 40 s); 3-drone routing
# compiles in 68 s for 2.3x (111 s), 4-drone routing in 146 s for 1.4x
# (8 minutes).
FUSED_MAX_DRONES = 2


def _platform() -> str:
    """Platform the next computation runs on: the default device's (which
    `jax.default_device` sets), else the default backend's."""
    dev = jax.config.jax_default_device
    if isinstance(dev, str):
        return dev
    return dev.platform if dev is not None else jax.default_backend()


def select_env_path(cfg: core.AviaryConfig, task, dtype=jnp.float32,
                    interpret: bool = False) -> str:
    """'fused' where the kernel is eligible, measured faster (at most
    FUSED_MAX_DRONES drones per env) and can run, else 'batched'.

    The kernel compiles only for the GPU; elsewhere it runs only in the
    Pallas interpreter, which is taken only when the caller asks for it.
    """
    runnable = interpret or _platform() == "gpu"
    if (runnable and cfg.num_drones <= FUSED_MAX_DRONES
            and fused_ineligibility(cfg, task, dtype) is None):
        return "fused"
    return "batched"


def make_env_step(cfg: core.AviaryConfig, task, num_envs: int,
                  dtype=jnp.float32, mesh=None, obs_layout: str = "flat",
                  interpret: bool = False):
    """(path, reset_fn, step_fn) on the path `select_env_path` picks, with
    auto-reset.  Both paths share the step signature of make_batched_step;
    the fused path's state is an opaque packed carry."""
    path = select_env_path(cfg, task, dtype, interpret)
    if path == "fused":
        reset_fn, step_fn = make_fused_rollout(
            cfg, task, num_envs, mesh=mesh, obs_layout=obs_layout,
            interpret=interpret)
    else:
        reset_fn, step_fn = make_batched_step(
            cfg, task, num_envs, autoreset=True, dtype=dtype, mesh=mesh,
            obs_layout=obs_layout)
    return path, reset_fn, step_fn


def make_fused_rollout(cfg: core.AviaryConfig, task, num_envs: int,
                       mesh=None, obs_layout: str = "flat",
                       interpret: bool = False):
    """Fully-fused rollout stepping: ONE Pallas launch and a ONE-buffer scan
    carry per control step (ops/pallas_fused.py) — physics, action buffer,
    task reward/termination, obs assembly, and auto-reset all in-kernel.

    Returns (reset_fn, step_fn): reset_fn() -> (carry, obs);
    step_fn(carry, action (B, N, A)) -> (carry, obs, reward, term, trunc).
    The carry is an opaque (RC, Bp) f32 row block (lanes = envs, padded to
    whole kernel blocks); use make_batched_step for an inspectable EnvState
    carry.

    Raises ValueError for a configuration `fused_ineligibility` rejects.
    The kernel compiles for the GPU; interpret=True runs it in the Pallas
    interpreter on any backend (tests).  Under a mesh every shard must
    hold a whole number of kernel blocks.
    """
    from gym_pybullet_drones_tpu.ops import pallas_fused

    why = fused_ineligibility(cfg, task)
    if why is not None:
        raise ValueError(why)
    if not interpret and _platform() != "gpu":
        raise ValueError("the fused env-step kernel compiles only for the "
                         "GPU; pass interpret=True to run it elsewhere")
    if mesh is not None and num_envs % (pallas_fused.BLOCK * mesh.size):
        raise ValueError(
            f"fused rollout under a mesh needs num_envs divisible by "
            f"{pallas_fused.BLOCK} * mesh.size (whole blocks per shard)")
    n = cfg.num_drones
    buf_len, act_dim = task.action_buffer_shape(cfg)
    buf_rows = buf_len * act_dim

    # single-env eager reset -> init scalars + packed initial carry
    s1, obs1, _ = jax.jit(lambda: core.reset(cfg, task))()
    s1h = jax.tree.map(lambda x: np.asarray(x), s1)
    flat16_1 = np.concatenate(
        [s1h.pos, s1h.quat, s1h.vel, s1h.rpy_rates, s1h.ang_v],
        axis=-1)                                       # (N, 16)
    init16 = tuple(tuple(float(v) for v in flat16_1[d]) for d in range(n))
    obs_dim = pallas_fused.obs_rows_per_drone(task, buf_rows)
    bn = num_envs * n

    def _layout_obs(obs):
        return obs.reshape(obs.shape[0], n, obs_dim) \
            if obs_layout == "drone" else obs

    def reset_fn(seed: int = 0):
        leaves = {
            "pos": np.broadcast_to(s1h.pos, (num_envs, n, 3)).reshape(bn, 3),
            "quat": np.broadcast_to(
                s1h.quat, (num_envs, n, 4)).reshape(bn, 4),
            "vel": np.zeros((bn, 3), np.float32),
            "rpy_rates": np.zeros((bn, 3), np.float32),
            "ang_v": np.zeros((bn, 3), np.float32),
            "action_buffer": np.zeros((bn, buf_rows), np.float32),
            "pid": np.zeros((bn, 9), np.float32),
            "step_counter": np.zeros((num_envs,), np.float32),
        }
        carry = pallas_fused.pack_carry(leaves, n, buf_rows, num_envs,
                                        task.act)
        obs0 = np.broadcast_to(
            np.asarray(obs1, np.float32).reshape(1, n * obs_dim),
            (num_envs, n * obs_dim))
        return carry, _layout_obs(jnp.asarray(obs0))

    def step_fn(carry, action):
        a = jnp.asarray(action, jnp.float32).reshape(action.shape[0],
                                                     n * act_dim)
        carry, obs, flags = pallas_fused.fused_env_step(
            cfg, task, init16, carry, a, interpret=interpret)
        return (carry, _layout_obs(obs), flags[0], flags[1] > 0.5,
                flags[2] > 0.5)

    if mesh is not None:
        from jax import shard_map
        from jax.sharding import PartitionSpec
        ax = mesh.axis_names[0]
        inner = step_fn

        def step_fn(carry, action):  # noqa: F811 - sharded wrapper
            return shard_map(
                inner, mesh=mesh,
                in_specs=(PartitionSpec(None, ax), PartitionSpec(ax)),
                out_specs=(PartitionSpec(None, ax), PartitionSpec(ax),
                           PartitionSpec(ax), PartitionSpec(ax),
                           PartitionSpec(ax)),
                check_vma=False)(carry, action)

    return reset_fn, step_fn
