"""Task layer: action preprocessing, observations, rewards, termination.

Functional counterparts of the reference's aviary subclasses:
- CtrlTask      <- CtrlAviary      (reference envs/CtrlAviary.py)
- VelocityTask  <- VelocityAviary  (reference envs/VelocityAviary.py)
- RLTask        <- BaseRLAviary    (reference envs/BaseRLAviary.py)
- HoverTask     <- HoverAviary     (reference envs/HoverAviary.py)
- MultiHoverTask<- MultiHoverAviary(reference envs/MultiHoverAviary.py)

Each task is a frozen (hashable) dataclass closed over by jit; its methods
are pure functions of (cfg, state).  The embedded DSL-PID controllers of the
reference (one Python object per drone, BaseRLAviary.py:73-78) are the
PIDState carried in EnvState, advanced inside preprocess_action.

Reference quirk preserved: embedded controllers are always constructed with
CF2X parameters regardless of the configured drone model
(reference BaseRLAviary.py:76, VelocityAviary.py:62).
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp

from gym_pybullet_drones_tpu.params import CF2X
from gym_pybullet_drones_tpu.utils.enums import ActionType, ObservationType
from gym_pybullet_drones_tpu.ops import quat as quat_ops
from gym_pybullet_drones_tpu.control import dsl_pid
from gym_pybullet_drones_tpu.envs.core import (
    AviaryConfig, EnvState, next_waypoint, state_vector)


@dataclasses.dataclass(frozen=True)
class CtrlTask:
    """Direct-RPM control env (non-RL).

    Action = raw RPMs clipped to [0, MAX_RPM] (reference CtrlAviary.py:121-140);
    obs = raw 20-dim state per drone (:106-117); dummy reward/term/trunc
    (:144-200).
    """

    def action_buffer_shape(self, cfg: AviaryConfig):
        return (0, 4)

    def action_dim(self, cfg: AviaryConfig) -> int:
        return 4

    def obs_dim(self, cfg: AviaryConfig) -> int:
        return 20

    def preprocess_action(self, cfg, state: EnvState, action):
        return self._map_to_rpm(cfg, state, action)

    def _map_to_rpm(self, cfg, state: EnvState, action):
        """Action -> rpm mapping, independent of batch layout (leaves may be
        (N, k) per-env or (B*N, k) flattened — see envs/fast.py)."""
        rpm = jnp.clip(action, 0.0, cfg.drone.max_rpm)
        return rpm, state

    def compute_obs(self, cfg, state: EnvState):
        return state_vector(state)

    def compute_reward(self, cfg, state):
        return jnp.asarray(-1.0, state.pos.dtype)

    def compute_terminated(self, cfg, state):
        return jnp.asarray(False)

    def compute_truncated(self, cfg, state):
        return jnp.asarray(False)

    def flat_post(self, cfg, flat: EnvState, num_envs: int, num_drones: int):
        """Batched post-processing on the FLATTENED (B*N, k) state.

        Returns (obs (B*N, D) 2-D, reward (B,), term (B,), trunc (B,)) or None
        to make envs/fast.py fall back to the vmapped per-env methods.
        Semantics must match compute_obs/_reward/_terminated/_truncated
        (cross-checked in tests/test_pallas.py).
        """
        b = num_envs
        obs = state_vector(flat)                      # (B*N, 20)
        dtype = flat.pos.dtype
        return (obs, jnp.full((b,), -1.0, dtype),
                jnp.zeros((b,), bool), jnp.zeros((b,), bool))


def _embedded_pid(cfg, state: EnvState, target_pos, target_rpy=None,
                  target_vel=None):
    """Advance the embedded per-drone DSL-PIDs one control tick."""
    rpm, ctrl_state, _, _ = dsl_pid.compute_control(
        CF2X, state.ctrl_state, cfg.ctrl_dt,
        cur_pos=state.pos, cur_quat=state.quat, cur_vel=state.vel,
        target_pos=target_pos, target_rpy=target_rpy, target_vel=target_vel)
    return rpm, state._replace(ctrl_state=ctrl_state)


@dataclasses.dataclass(frozen=True)
class VelocityTask(CtrlTask):
    """Velocity-command env with embedded DSL-PIDs.

    Action = [vx, vy, vz, speed-fraction] per drone mapped through PID to RPM
    (reference VelocityAviary.py:129-168); speed limit
    0.03 * MAX_SPEED_KMH * 1000/3600 (:78).
    """

    def _map_to_rpm(self, cfg, state: EnvState, action):
        v = action[..., 0:3]
        norm = jnp.linalg.norm(v, axis=-1, keepdims=True)
        v_unit = jnp.where(norm > 0, v / jnp.where(norm > 0, norm, 1.0), 0.0)
        yaw = quat_ops.quat_to_rpy(state.quat)[..., 2]
        target_rpy = jnp.stack(
            [jnp.zeros_like(yaw), jnp.zeros_like(yaw), yaw], axis=-1)
        target_vel = (cfg.drone.speed_limit
                      * jnp.abs(action[..., 3:4]) * v_unit)
        return _embedded_pid(cfg, state, target_pos=state.pos,
                             target_rpy=target_rpy, target_vel=target_vel)


@dataclasses.dataclass(frozen=True)
class RLTask:
    """Base RL task: 5 action types, KIN observations with action history.

    Parity: reference BaseRLAviary (envs/BaseRLAviary.py) — action buffer of
    ctrl_freq//2 past actions (:66-67), action mappings (:160-239), KIN obs =
    12-dim kinematics + stacked buffer (:243-322).  RGB observations are a
    host-side renderer concern (see SURVEY.md §7 "hard parts"); KIN is the
    benchmark path.
    """

    act: ActionType = ActionType.RPM
    obs: ObservationType = ObservationType.KIN
    # Superset feature (reference resets are always deterministic): uniform
    # reset noise on position [m], attitude [rad], velocity [m/s]
    reset_pos_noise: float = 0.0
    reset_rpy_noise: float = 0.0
    reset_vel_noise: float = 0.0

    def randomize_reset(self, cfg, state: EnvState, key):
        if not (self.reset_pos_noise or self.reset_rpy_noise
                or self.reset_vel_noise):
            return state
        import jax
        kp, kr, kv = jax.random.split(key, 3)
        n = cfg.num_drones
        dtype = state.pos.dtype
        pos = state.pos + self.reset_pos_noise * jax.random.uniform(
            kp, (n, 3), dtype, -1.0, 1.0)
        rpy = quat_ops.quat_to_rpy(state.quat) +             self.reset_rpy_noise * jax.random.uniform(
                kr, (n, 3), dtype, -1.0, 1.0)
        vel = state.vel + self.reset_vel_noise * jax.random.uniform(
            kv, (n, 3), dtype, -1.0, 1.0)
        return state._replace(pos=pos, quat=quat_ops.rpy_to_quat(rpy),
                              vel=vel)

    def action_dim(self, cfg) -> int:
        if self.act in (ActionType.RPM, ActionType.VEL):
            return 4
        if self.act == ActionType.PID:
            return 3
        return 1  # ONE_D_RPM, ONE_D_PID

    def action_buffer_shape(self, cfg: AviaryConfig):
        return (cfg.ctrl_freq // 2, self.action_dim(cfg))

    def obs_dim(self, cfg) -> int:
        buf, adim = self.action_buffer_shape(cfg)
        return 12 + buf * adim

    def preprocess_action(self, cfg, state: EnvState, action):
        # push into the ring (oldest first, like the reference deque);
        # buffer is (N, BUF, A), so the shift runs along axis -2
        buf = jnp.concatenate(
            [state.action_buffer[:, 1:], action[:, None, :]], axis=1)
        state = state._replace(action_buffer=buf)
        return self._map_to_rpm(cfg, state, action)

    def _map_to_rpm(self, cfg, state: EnvState, action):
        """Action -> rpm, layout-independent (no buffer push; leaves may be
        per-env (N, k) or flattened (B*N, k) — see envs/fast.py)."""
        hover = cfg.drone.hover_rpm
        if self.act == ActionType.RPM:
            rpm = hover * (1 + 0.05 * action)
            return rpm, state
        if self.act == ActionType.ONE_D_RPM:
            rpm = jnp.repeat(hover * (1 + 0.05 * action), 4, axis=-1)
            return rpm, state
        if self.act in (ActionType.PID, ActionType.VEL,
                        ActionType.ONE_D_PID):
            tp, trpy, tv, trr = self._pid_targets(cfg, state, action)
            return _embedded_pid(cfg, state, target_pos=tp,
                                 target_rpy=trpy, target_vel=tv)
        raise ValueError(f"unsupported action type {self.act}")

    def _pid_targets(self, cfg, state: EnvState, action):
        """Embedded-PID setpoints (target pos/rpy/vel/rpy_rates), each
        (..., 3), for the PID-family action types.  Layout-independent;
        mirrored row-wise by the fused kernel (ops/pallas_fused.py)."""
        zeros = jnp.zeros_like(state.pos)
        if self.act == ActionType.PID:
            # waypoint step size: RoutingTask overrides via its step_size
            # field; the reference uses 1.0 (BaseRLAviary.py:195-199).
            # relative_actions (RoutingTask's trainable parameterization):
            # the action is a step_size-scaled DISPLACEMENT from the
            # current position instead of an absolute destination.
            step = getattr(self, "step_size", 1.0)
            if getattr(self, "relative_actions", False):
                scale = getattr(self, "action_scale", step)
                dest = state.pos + scale * action
            else:
                dest = action
            return (next_waypoint(state.pos, dest, step_size=step),
                    zeros, zeros, zeros)
        if self.act == ActionType.VEL:
            v = action[..., 0:3]
            norm = jnp.linalg.norm(v, axis=-1, keepdims=True)
            v_unit = jnp.where(norm > 0,
                               v / jnp.where(norm > 0, norm, 1.0), 0.0)
            yaw = quat_ops.quat_to_rpy(state.quat)[..., 2]
            target_rpy = jnp.stack(
                [jnp.zeros_like(yaw), jnp.zeros_like(yaw), yaw], axis=-1)
            target_vel = (cfg.drone.speed_limit
                          * jnp.abs(action[..., 3:4]) * v_unit)
            return state.pos, target_rpy, target_vel, zeros
        if self.act == ActionType.ONE_D_PID:
            delta = 0.1 * jnp.pad(action, [(0, 0)] * (action.ndim - 1)
                                  + [(2, 0)])
            return state.pos + delta, zeros, zeros, zeros
        raise ValueError(f"unsupported action type {self.act}")

    def compute_obs(self, cfg, state: EnvState):
        """KIN: (N, 12 + BUF*A) [pos, rpy, vel, ang_v] + action history.
        RGB: (N, 48, 64, 4) per-drone ray-traced camera images
        (reference BaseRLAviary.py:252-255,293-306)."""
        if self.obs == ObservationType.RGB:
            from gym_pybullet_drones_tpu.ops import render
            scene = render.landmark_scene(state.pos.dtype)
            rot = quat_ops.quat_to_mat(state.quat)
            rgba, _, _ = render.render(cfg.drone, scene, state.pos, rot,
                                       drone_pos=state.pos)
            return rgba
        rpy = quat_ops.quat_to_rpy(state.quat)
        obs12 = jnp.concatenate(
            [state.pos, rpy, state.vel, state.ang_v], axis=-1)
        buf, adim = self.action_buffer_shape(cfg)
        # (N, BUF, A) -> (N, BUF*A), oldest first (reference :317-318);
        # drone-major storage makes this a free reshape, no transpose
        hist = state.action_buffer.reshape(
            state.action_buffer.shape[:-2] + (buf * adim,))
        return jnp.concatenate([obs12, hist], axis=-1)

    def compute_reward(self, cfg, state):
        return jnp.asarray(0.0, state.pos.dtype)

    def compute_terminated(self, cfg, state):
        return jnp.asarray(False)

    def compute_truncated(self, cfg, state):
        return jnp.asarray(False)

    # ---- flattened batched-step hooks (envs/fast.py) ----
    # The same quantities as the vmapped per-env methods above, computed on
    # the flattened (B*N, k) carry of make_batched_step and reduced over the
    # drone axis via a (B, N) reshape.  Equivalence is asserted in
    # tests/test_pallas.py.

    def flat_post(self, cfg, flat: EnvState, num_envs: int, num_drones: int):
        if self.obs == ObservationType.RGB:
            return None  # renderer path: fall back to the vmapped methods
        b, n = num_envs, num_drones
        rpy = quat_ops.quat_to_rpy(flat.quat)                  # (B*N, 3)
        obs12 = jnp.concatenate(
            [flat.pos, rpy, flat.vel, flat.ang_v], axis=-1)
        buf, adim = self.action_buffer_shape(cfg)
        hist = flat.action_buffer.reshape(b * n, buf * adim)
        cols = [obs12, hist]
        extra = self.flat_extra_obs(cfg, flat, num_envs, num_drones)
        if extra is not None:
            cols.append(extra)
        obs = jnp.concatenate(cols, axis=-1)          # (B*N, D)
        reward, term, trunc = self.flat_reward_done(
            cfg, flat, rpy, num_envs, num_drones)
        return obs, reward, term, trunc

    def flat_extra_obs(self, cfg, flat: EnvState, num_envs: int,
                       num_drones: int):
        """Optional task-specific obs columns appended after the history."""
        return None

    def flat_reward_done(self, cfg, flat: EnvState, rpy, num_envs: int,
                         num_drones: int):
        """(reward (B,), terminated (B,), truncated (B,)) on the flat state."""
        dtype = flat.pos.dtype
        return (jnp.zeros((num_envs,), dtype),
                jnp.zeros((num_envs,), bool), jnp.zeros((num_envs,), bool))


@dataclasses.dataclass(frozen=True)
class HoverTask(RLTask):
    """Single-agent hover at TARGET_POS (reference envs/HoverAviary.py).

    reward = max(0, 2 - ||tgt - p||^4) (:68-79); terminated when
    ||tgt - p|| < 1e-4 (:83-96); truncated outside the flight box, when
    tilted > 0.4 rad, or after EPISODE_LEN_SEC (:100-117).
    """

    target_pos: tuple = (0.0, 0.0, 1.0)
    episode_len_sec: float = 8.0

    def _dist(self, state):
        tgt = jnp.asarray(self.target_pos, state.pos.dtype)
        return jnp.linalg.norm(tgt - state.pos[0])

    def compute_reward(self, cfg, state):
        return jnp.maximum(0.0, 2.0 - self._dist(state) ** 4)

    def compute_terminated(self, cfg, state):
        return self._dist(state) < 1e-4

    def compute_truncated(self, cfg, state):
        pos = state.pos[0]
        rpy = quat_ops.quat_to_rpy(state.quat[0])
        out = (jnp.abs(pos[0]) > 1.5) | (jnp.abs(pos[1]) > 1.5) | \
              (pos[2] > 2.0) | (jnp.abs(rpy[0]) > 0.4) | \
              (jnp.abs(rpy[1]) > 0.4)
        timeout = (state.step_counter / cfg.pyb_freq) > self.episode_len_sec
        return out | timeout

    def flat_reward_done(self, cfg, flat, rpy, num_envs, num_drones):
        b, n = num_envs, num_drones
        # drone 0 per env (reference HoverAviary scores the single drone)
        pos = flat.pos.reshape(b, n, 3)[:, 0]                  # (B, 3)
        rpy0 = rpy.reshape(b, n, 3)[:, 0]
        tgt = jnp.asarray(self.target_pos, pos.dtype)
        d = jnp.linalg.norm(tgt - pos, axis=-1)                # (B,)
        reward = jnp.maximum(0.0, 2.0 - d ** 4)
        term = d < 1e-4
        out = (jnp.abs(pos[:, 0]) > 1.5) | (jnp.abs(pos[:, 1]) > 1.5) | \
              (pos[:, 2] > 2.0) | (jnp.abs(rpy0[:, 0]) > 0.4) | \
              (jnp.abs(rpy0[:, 1]) > 0.4)
        timeout = (flat.step_counter / cfg.pyb_freq) > self.episode_len_sec
        return reward, term, out | timeout

    # ---- fused-kernel row hook (ops/pallas_fused.py) ----
    def row_post(self, cfg, drones, sc_row):
        """Reward/term/trunc on (1, B) row vectors (drone 0 scores)."""
        d0 = drones[0]
        tx, ty, tz = self.target_pos
        px, py, pz = d0["p"]
        roll, pitch, _ = d0["rpy"]
        dx, dy, dz = tx - px, ty - py, tz - pz
        d2 = dx * dx + dy * dy + dz * dz
        reward = jnp.maximum(0.0, 2.0 - d2 * d2)   # ||d||^4 == (||d||^2)^2
        term = d2 < 1e-8
        out = (jnp.abs(px) > 1.5) | (jnp.abs(py) > 1.5) | (pz > 2.0) | \
              (jnp.abs(roll) > 0.4) | (jnp.abs(pitch) > 0.4)
        timeout = (sc_row / cfg.pyb_freq) > self.episode_len_sec
        return reward, term, out | timeout


@dataclasses.dataclass(frozen=True)
class MultiHoverTask(RLTask):
    """Multi-agent leader-follower hover (reference envs/MultiHoverAviary.py).

    TARGET_POS = INIT_XYZS + [0, 0, 1/(i+1)] (:71); summed reward (:75-88);
    terminated when the summed distance < 1e-4 (:92-108); truncated when any
    drone leaves the +-2 box / tilts > 0.4 / timeout (:112-130).
    """

    episode_len_sec: float = 8.0

    def _targets(self, cfg, state):
        init = cfg.default_init_xyzs(state.pos.dtype)
        i = jnp.arange(cfg.num_drones, dtype=state.pos.dtype)
        off = jnp.stack([jnp.zeros_like(i), jnp.zeros_like(i),
                         1.0 / (i + 1)], axis=-1)
        return init + off

    def compute_reward(self, cfg, state):
        d = jnp.linalg.norm(self._targets(cfg, state) - state.pos, axis=-1)
        return jnp.sum(jnp.maximum(0.0, 2.0 - d ** 4))

    def compute_terminated(self, cfg, state):
        d = jnp.linalg.norm(self._targets(cfg, state) - state.pos, axis=-1)
        return jnp.sum(d) < 1e-4

    def compute_truncated(self, cfg, state):
        rpy = quat_ops.quat_to_rpy(state.quat)
        out = (jnp.abs(state.pos[:, 0]) > 2.0) | \
              (jnp.abs(state.pos[:, 1]) > 2.0) | (state.pos[:, 2] > 2.0) | \
              (jnp.abs(rpy[:, 0]) > 0.4) | (jnp.abs(rpy[:, 1]) > 0.4)
        timeout = (state.step_counter / cfg.pyb_freq) > self.episode_len_sec
        return jnp.any(out) | timeout

    def flat_reward_done(self, cfg, flat, rpy, num_envs, num_drones):
        b, n = num_envs, num_drones
        init = cfg.default_init_xyzs(flat.pos.dtype)  # (N, 3)
        i = jnp.arange(n, dtype=flat.pos.dtype)
        tgt = init.at[:, 2].add(1.0 / (i + 1))                 # (N, 3)
        d = jnp.linalg.norm(jnp.tile(tgt, (b, 1)) - flat.pos,
                            axis=-1)                           # (B*N,)
        out = (jnp.abs(flat.pos[:, 0]) > 2.0) | \
              (jnp.abs(flat.pos[:, 1]) > 2.0) | (flat.pos[:, 2] > 2.0) | \
              (jnp.abs(rpy[:, 0]) > 0.4) | (jnp.abs(rpy[:, 1]) > 0.4)
        # one (B*N, 3) -> (B, 3) drone-axis reduction for
        # [reward, dist, out] together
        per = jnp.stack([jnp.maximum(0.0, 2.0 - d ** 4), d,
                         out.astype(d.dtype)], axis=-1)        # (B*N, 3)
        red = jnp.sum(per.reshape(b, n, 3), axis=1)            # (B, 3)
        reward = red[:, 0]
        term = red[:, 1] < 1e-4
        timeout = (flat.step_counter / cfg.pyb_freq) > self.episode_len_sec
        trunc = (red[:, 2] > 0) | timeout
        return reward, term, trunc

    # ---- fused-kernel row hook (ops/pallas_fused.py) ----
    def row_post(self, cfg, drones, sc_row):
        """Summed reward / summed-distance termination / any-drone
        truncation as row math (cross-drone reductions are row adds)."""
        import numpy as _np
        # numpy replica of cfg.default_init_xyzs (jnp ops would be traced
        # into the kernel instead of folding to python scalars)
        if cfg.init_xyzs is not None:
            init = _np.asarray(cfg.init_xyzs, _np.float32)
        else:
            idx = _np.arange(cfg.num_drones, dtype=_np.float32)
            init = _np.stack(
                [idx * 4 * cfg.drone.l, idx * 4 * cfg.drone.l,
                 _np.full_like(idx, cfg.drone.init_z)], axis=-1)
        reward = None
        dist_sum = None
        out_any = None
        for i, di in enumerate(drones):
            tx, ty = float(init[i, 0]), float(init[i, 1])
            tz = float(init[i, 2]) + 1.0 / (i + 1)
            px, py, pz = di["p"]
            roll, pitch, _ = di["rpy"]
            dx, dy, dz = tx - px, ty - py, tz - pz
            d2 = dx * dx + dy * dy + dz * dz
            r = jnp.maximum(0.0, 2.0 - d2 * d2)
            dd = jnp.sqrt(d2)
            out = (jnp.abs(px) > 2.0) | (jnp.abs(py) > 2.0) | (pz > 2.0) | \
                  (jnp.abs(roll) > 0.4) | (jnp.abs(pitch) > 0.4)
            reward = r if reward is None else reward + r
            dist_sum = dd if dist_sum is None else dist_sum + dd
            out_any = out if out_any is None else out_any | out
        term = dist_sum < 1e-4
        timeout = (sc_row / cfg.pyb_freq) > self.episode_len_sec
        return reward, term, out_any | timeout

