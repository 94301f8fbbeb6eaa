"""Pallas kernel (Triton route): the WHOLE env step in one launch — DYN
physics, action mapping (embedded DSL-PID included), action buffer, task
reward/termination, observation assembly and auto-reset — with the scan
carry held as ONE packed row block.

    carry (RC, Bp): per drone [pos3 quat4 vel3 rpy_rates3 ang_v3]
                    [embedded-PID 9, PID-family actions only]
                    [action-history BUF*A rows]
                    then one global step-counter row (f32)

Envs are lanes and state components are rows.  One program handles a
block of BLOCK env lanes: each carry row is loaded once as a 1-D lane
vector, every substep, the embedded PID, reward, termination, observation
and auto-reset stay in registers, and each row is stored once.  Envs are
independent and cross-drone terms (summed rewards, pairwise separation,
nearest neighbours) are row arithmetic inside a lane, so nothing crosses
lanes: no shared memory, no barriers.

Only the DYN physics mode is covered: the PYB-family modes (coupled
contact solver) made a kernel that Triton did not finish compiling in 18
minutes on an H100 (PERF.md), so they run on the XLA batched step.

Actions are read and observations written in the learner's env-major
layout ((B, N*A) in, (B, N*D) out) with masked strided accesses, so the
step needs no transposes or padding around the kernel; only the carry is
padded to whole blocks (pack_carry).  Auto-reset is a row-wise select
against the reset state embedded as compile-time scalars (deterministic
resets only).

Tasks opt in by implementing `row_post(cfg, drones, sc_row)` (and
optionally `row_extra_obs(cfg, drones)`) — see envs/tasks.py.
Semantics match envs/fast.make_batched_step with autoreset=True for
eligible configs; equivalence is asserted in tests/test_fused.py.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from gym_pybullet_drones_tpu.params import CF2X
from gym_pybullet_drones_tpu.utils.enums import ActionType
from gym_pybullet_drones_tpu.ops import rows

# env lanes per program (a power of two) and warps per program, the best
# of 512/256/128/64/32 lanes measured on an H100 at 4096 envs (PERF.md):
# smaller programs spread the step over more SMs, and one lane per thread
# keeps every row in registers
BLOCK = 32
NUM_WARPS = 1
S = 16    # state rows per drone
PR = 9    # embedded-PID carry rows per drone (PID-family actions only)

PID_FAMILY = (ActionType.PID, ActionType.VEL, ActionType.ONE_D_PID)


def padded_lanes(b: int) -> int:
    """Carry lanes for b envs: whole blocks."""
    return -(-b // BLOCK) * BLOCK


def _layout(n: int, buf_rows: int, act: ActionType = ActionType.RPM):
    pid = PR if act in PID_FAMILY else 0
    per_drone = S + pid + buf_rows
    rc = n * per_drone + 1          # + step-counter row
    return per_drone, rc


def obs_rows_per_drone(task, buf_rows: int) -> int:
    n_extra = (task.n_extra_obs_rows
               if getattr(task, "row_extra_obs", None) is not None else 0)
    return 12 + buf_rows + n_extra


def _kernel(cfg, task, init16, b: int, c_ref, a_ref, oc_ref, oo_ref, of_ref):
    n = cfg.num_drones
    params = cfg.drone
    n_substeps = cfg.steps_per_ctrl
    act = task.act
    buf_len, act_dim = task.action_buffer_shape(cfg)
    buf_rows = buf_len * act_dim
    per_drone, _ = _layout(n, buf_rows, act)
    hover = params.hover_rpm
    has_pid = act in PID_FAMILY
    pid_off = S
    buf_off = S + (PR if has_pid else 0)

    lane = pl.program_id(0) * BLOCK + jnp.arange(BLOCK)
    valid = lane < b        # the carry is padded, actions and outputs not

    # ---- load + action mapping + buffer shift + physics ----
    stepped = []     # per drone: 16 new state rows
    new_bufs = []    # per drone: buf_rows rows (post-push)
    new_pids = []    # per drone: 9 rows (PID-family actions)
    for d in range(n):
        base = d * per_drone
        st = [c_ref[base + k, :] for k in range(S)]
        buf = [c_ref[base + buf_off + k, :] for k in range(buf_rows)]
        a = [plt.load(a_ref.at[:, d * act_dim + k], mask=valid, other=0.0)
             for k in range(act_dim)]
        if act == ActionType.RPM:
            rpm = [hover * (1.0 + 0.05 * ai) for ai in a]
        elif act == ActionType.ONE_D_RPM:
            rpm = [hover * (1.0 + 0.05 * a[0])] * 4
        elif has_pid:
            # embedded DSL-PID tick (always CF2X, QUIRKS.md #2 /
            # reference BaseRLAviary.py:76); setpoints per
            # tasks.RLTask._pid_targets
            p, q = st[0:3], st[3:7]
            zero = p[0] * 0.0
            if act == ActionType.PID:
                # waypoint clamp (core.next_waypoint; reference
                # BaseAviary._calculateNextStep :1105-1147); with
                # relative_actions the action is a step-scaled
                # displacement (tasks.RLTask._pid_targets)
                step = float(getattr(task, "step_size", 1.0))
                if getattr(task, "relative_actions", False):
                    # NOTE: keep `a` untouched — the history ring below
                    # stores the RAW action
                    scale = float(getattr(task, "action_scale", step))
                    dest = [p[k] + scale * a[k] for k in range(3)]
                else:
                    dest = a
                dx = [dest[k] - p[k] for k in range(3)]
                dist = jnp.sqrt(dx[0] * dx[0] + dx[1] * dx[1]
                                + dx[2] * dx[2])
                safe = jnp.where(dist > 0.0, dist, 1.0)
                tp = [jnp.where(dist <= step, dest[k],
                                p[k] + dx[k] / safe * step)
                      for k in range(3)]
                tgt = tp + [zero] * 9
            elif act == ActionType.VEL:
                vx, vy, vz, sf = a
                norm = jnp.sqrt(vx * vx + vy * vy + vz * vz)
                inv = jnp.where(norm > 0.0,
                                1.0 / jnp.where(norm > 0.0, norm, 1.0),
                                0.0)
                mag = cfg.drone.speed_limit * jnp.abs(sf) * inv
                _, _, yaw = rows.quat_rpy_rows(*q)
                tgt = (list(p) + [zero, zero, yaw]
                       + [mag * vx, mag * vy, mag * vz] + [zero] * 3)
            else:  # ONE_D_PID
                tgt = [p[0], p[1], p[2] + 0.1 * a[0]] + [zero] * 9
            pid_rows = [c_ref[base + pid_off + k, :] for k in range(PR)]
            rpm, new_pid = rows._pid_tick(CF2X, cfg.ctrl_dt, st,
                                          pid_rows, tgt)
            new_pids.append(new_pid)
        else:
            raise NotImplementedError(act)
        # history ring: oldest first (reference BaseRLAviary.py:66-67)
        new_bufs.append(buf[act_dim:] + a if buf_rows else [])
        thrust, xt, yt, zt = rows._motor_mix(params, *rpm)
        stepped.append(list(rows._dyn_substeps(
            params, n_substeps, cfg.pyb_dt, tuple(st[:13]),
            thrust, xt, yt, zt)))

    # ---- task post on the stepped rows ----
    def info(state16):
        return {"p": state16[0:3], "rpy": rows.quat_rpy_rows(*state16[3:7]),
                "v": state16[7:10], "w": state16[13:16]}

    sc_row = c_ref[n * per_drone, :]
    # row_post sees the PRE-increment substep counter: the reference advances
    # step_counter only after the termination hooks (BaseAviary.py:376-382)
    reward, term, trunc = task.row_post(
        cfg, [info(stepped[d]) for d in range(n)], sc_row)
    done = term | trunc

    # ---- auto-reset select, carry store ----
    sel = [[jnp.where(done, init16[d][k], stepped[d][k]) for k in range(S)]
           for d in range(n)]
    sel_bufs = [[jnp.where(done, 0.0, row) for row in new_bufs[d]]
                for d in range(n)]
    for d in range(n):
        base = d * per_drone
        for k in range(S):
            oc_ref[base + k, :] = sel[d][k]
        if has_pid:
            for k in range(PR):
                oc_ref[base + pid_off + k, :] = jnp.where(
                    done, 0.0, new_pids[d][k])
        for k in range(buf_rows):
            oc_ref[base + buf_off + k, :] = sel_bufs[d][k]
    oc_ref[n * per_drone, :] = jnp.where(done, 0.0,
                                         sc_row + float(n_substeps))

    # ---- observation columns from the SELECTED (post-reset) state ----
    sel_info = [info(sel[d]) for d in range(n)]
    extra_fn = getattr(task, "row_extra_obs", None)
    extras = extra_fn(cfg, sel_info) if extra_fn is not None else None
    obs_per = obs_rows_per_drone(task, buf_rows)
    for d in range(n):
        di = sel_info[d]
        cols = (di["p"] + list(di["rpy"]) + di["v"] + di["w"] + sel_bufs[d]
                + (list(extras[d]) if extras is not None else []))
        for k, col in enumerate(cols):
            plt.store(oo_ref.at[:, d * obs_per + k], col, mask=valid)
    plt.store(of_ref.at[0, :], reward, mask=valid)
    plt.store(of_ref.at[1, :], term.astype(reward.dtype), mask=valid)
    plt.store(of_ref.at[2, :], trunc.astype(reward.dtype), mask=valid)


def fused_env_step(cfg, task, init16, carry, actions, interpret=False):
    """One fully-fused control step.

    carry: (RC, Bp) f32 row block (see module docstring; Bp whole blocks);
    actions: (B, N*A) env-major.  Returns (carry', obs (B, N*D),
    flags (3, B) = reward / terminated / truncated rows).
    interpret=True runs the kernel in the Pallas interpreter (CPU tests);
    otherwise it compiles through Triton, which needs a GPU.
    """
    n = cfg.num_drones
    buf_len, act_dim = task.action_buffer_shape(cfg)
    buf_rows = buf_len * act_dim
    _, rc = _layout(n, buf_rows, task.act)
    b = actions.shape[0]
    bp = carry.shape[1]
    if carry.shape != (rc, padded_lanes(b)):
        raise ValueError(f"carry {carry.shape} does not fit {b} envs "
                         f"({rc} rows, whole blocks of {BLOCK} lanes)")
    obs_w = n * obs_rows_per_drone(task, buf_rows)
    lanes = lambda r: pl.BlockSpec((r, BLOCK), lambda i: (0, i))
    env_major = lambda w: pl.BlockSpec((BLOCK, w), lambda i: (i, 0))
    return pl.pallas_call(
        functools.partial(_kernel, cfg, task, init16, b),
        out_shape=[jax.ShapeDtypeStruct((rc, bp), jnp.float32),
                   jax.ShapeDtypeStruct((b, obs_w), jnp.float32),
                   jax.ShapeDtypeStruct((3, b), jnp.float32)],
        grid=(bp // BLOCK,),
        in_specs=[lanes(rc), env_major(n * act_dim)],
        out_specs=[lanes(rc), env_major(obs_w), lanes(3)],
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS,
                                           num_stages=1),
        interpret=interpret,
        name="fused_env_step",
    )(carry, actions)


def pack_carry(state_leaves, n: int, buf_rows: int, b: int,
               act: ActionType = ActionType.RPM):
    """numpy EnvState-like leaves (flattened (B*N, k), env-major) ->
    (RC, Bp) drone-major row block, padded to whole blocks."""
    per_drone, rc = _layout(n, buf_rows, act)
    has_pid = act in PID_FAMILY
    buf_off = S + (PR if has_pid else 0)
    blk = np.zeros((rc, padded_lanes(b)), np.float32)
    flat16 = np.concatenate(
        [state_leaves["pos"], state_leaves["quat"], state_leaves["vel"],
         state_leaves["rpy_rates"], state_leaves["ang_v"]], axis=-1)
    buf = state_leaves["action_buffer"]            # (B*N, BUF*A)
    pid = state_leaves.get("pid")                  # (B*N, 9) or None
    # padding lanes get a valid unit quaternion so their math stays finite
    for d in range(n):
        base = d * per_drone
        blk[base + 6, b:] = 1.0
        blk[base:base + S, :b] = flat16[d::n].T    # (16, B) env-major slice
        if has_pid and pid is not None:
            blk[base + S:base + S + PR, :b] = pid[d::n].T
        if buf_rows:
            blk[base + buf_off:base + buf_off + buf_rows, :b] = buf[d::n].T
    blk[n * per_drone, :b] = np.asarray(
        state_leaves["step_counter"], np.float32)
    return jnp.asarray(blk)
