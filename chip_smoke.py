"""Smoke test of the main path on one NVIDIA GPU.

    python chip_smoke.py               # one card: phases (a)-(e) + timing
    python chip_smoke.py --four-cards  # four cards: sharded PPO only

Runs the simulator and the PPO trainer through their public entry points
(envs.fast.make_env_step, rl.make_train, rl.make_train_population) at the
widths users run, and compares every phase on the card with a plain
reference: the XLA batched step at "highest" matmul precision on the card,
and the same function on the CPU backend of this process.  Exits non-zero,
printing no result, when JAX finds no GPU or any phase fails.  The last
line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback

# the CPU backend is a reference: keep it available next to the GPU
if os.environ.get("JAX_PLATFORMS") and \
        "cpu" not in os.environ["JAX_PLATFORMS"].split(","):
    os.environ["JAX_PLATFORMS"] += ",cpu"

import jax  # noqa: E402
import numpy as np  # noqa: E402

REPO = os.path.dirname(os.path.abspath(__file__))
HOVER_ENVS = (4096, 1 << 20)
ROUTING_ENVS = 4096
CTRL_STEPS = 8
ACTION_SCALE = 0.1


def require_gpu() -> None:
    """Refuse to run anywhere but on a GPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"chip_smoke: needs a GPU, JAX found {dev.platform} "
                 f"({dev.device_kind})")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def compiled(fn, *args, label: str):
    """jit + compile fn for args; print compile time and memory analysis."""
    t0 = time.perf_counter()
    comp = jax.jit(fn).lower(*args).compile()
    print(f"[{label}] compile {time.perf_counter() - t0:.1f} s; "
          f"{comp.memory_analysis()}", flush=True)
    return comp


def assert_close(name, got, ref, atol, rtol=0.0):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err = np.abs(got - ref)
    worst = float(np.max(err)) if err.size else 0.0
    print(f"  {name}: max |diff| {worst:.3g} (atol {atol}, rtol {rtol})",
          flush=True)
    np.testing.assert_allclose(got, ref, atol=atol, rtol=rtol, err_msg=name)


def _rollout(step, n_steps):
    """n_steps control steps -> (state, final obs, rewards, term, trunc)."""
    def run(state, actions):
        def body(s, a):
            s, o, r, te, tr = step(s, a)
            return s, (o, r, te, tr)
        s, (o, r, te, tr) = jax.lax.scan(body, state, actions)
        return s, o[-1], r, te, tr
    return run


def _actions(cfg, task, num_envs, seed):
    return ACTION_SCALE * np.random.default_rng(seed).standard_normal(
        (CTRL_STEPS, num_envs, cfg.num_drones, task.action_dim(cfg))
    ).astype(np.float32)


def _agree(label, got, ref, atol_obs, atol_rew):
    """Same flags; obs and rewards within the phase's limits."""
    (_, obs, rew, te, tr), (_, r_obs, r_rew, r_te, r_tr) = got, ref
    assert np.all(np.isfinite(obs)) and obs.shape == r_obs.shape, obs.shape
    np.testing.assert_array_equal(te, r_te, err_msg=label)
    np.testing.assert_array_equal(tr, r_tr, err_msg=label)
    assert_close(f"{label} obs", obs, r_obs, atol_obs, 1e-4)
    assert_close(f"{label} reward", rew, r_rew, atol_rew, 1e-4)


def env_phase(label, cfg, task, num_envs, atol_obs, atol_rew, seeds=(0,),
              planted=None):
    """The chosen env path on the card vs plain references, for each
    action seed: a fused path vs the XLA step at highest precision on the
    card, and that XLA step vs the same function on the CPU backend.

    planted: a configuration with a deliberate physics error; its XLA step
    on the card must move the observations by more than atol_obs (the
    limit can fail)."""
    from gym_pybullet_drones_tpu.envs import fast
    path, reset_fn, step_fn = fast.make_env_step(cfg, task, num_envs)
    print(f"[{label}] env_path={path} num_envs={num_envs}", flush=True)
    acts = _actions(cfg, task, num_envs, seeds[0])
    x_reset, x_step = fast.make_batched_step(cfg, task, num_envs,
                                             obs_layout="flat")
    x_run = _rollout(x_step, CTRL_STEPS)
    with jax.default_matmul_precision("highest"):
        x_state = x_reset()[0]
        x_comp = compiled(x_run, x_state, acts,
                          label=f"{label} xla step @highest")
    if path == "fused":
        state = reset_fn()[0]
        run = compiled(_rollout(step_fn, CTRL_STEPS), state, acts,
                       label=f"{label} fused step")
    else:
        print(f"  {label}: the chosen path is this XLA step (its physics "
              f"einsums are pinned to HIGHEST); the card is compared with "
              f"the CPU backend only", flush=True)
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        c_state, c_run = x_reset()[0], jax.jit(x_run)
    for seed in seeds:
        acts = _actions(cfg, task, num_envs, seed)
        with jax.default_matmul_precision("highest"):
            xla = jax.device_get(x_comp(x_state, acts))
        if path == "fused":
            _agree(f"{label} seed {seed} fused vs xla",
                   jax.device_get(run(state, acts)), xla, atol_obs,
                   atol_rew)
        with jax.default_device(cpu):
            ref = jax.device_get(c_run(c_state, acts))
        _agree(f"{label} seed {seed} xla gpu vs cpu", xla, ref, atol_obs,
               atol_rew)
    if planted is not None:
        p_reset, p_step = fast.make_batched_step(planted, task, num_envs,
                                                 obs_layout="flat")
        acts = _actions(cfg, task, num_envs, seeds[-1])
        with jax.default_matmul_precision("highest"):
            p_obs = jax.device_get(jax.jit(_rollout(p_step, CTRL_STEPS))(
                p_reset()[0], acts))[1]
        gap = float(np.max(np.abs(p_obs - xla[1])))
        print(f"  {label} planted error moves obs by {gap:.3g} "
              f"(must exceed atol {atol_obs})", flush=True)
        assert gap > atol_obs, gap


def hover_setup(**task_kw):
    from gym_pybullet_drones_tpu import params as P
    from gym_pybullet_drones_tpu.envs import AviaryConfig, HoverTask
    from gym_pybullet_drones_tpu.utils.enums import ActionType, Physics
    cfg = AviaryConfig(drone=P.CF2X, num_drones=1, physics=Physics.DYN,
                       pyb_freq=240, ctrl_freq=30)
    return cfg, HoverTask(**{"act": ActionType.RPM, **task_kw})


# Tolerances of the env phases: float32 states stepped 8 control steps
# (64 substeps) by two compilers whose operation order, FMA contraction
# and atan2/asin/sin/cos implementations differ by a few ulp per op.  The
# open-loop RPM hover keeps those differences near 1e-6.  In routing the
# embedded PID's attitude loop (gains up to 7e4) about doubles them every
# control step in the angular-rate observations (rad/s, of order 1).
# Readings behind the routing limit of 1e-2: sound runs differ by at most
# 1.4e-3 (float32 vs float64 on the CPU, 256 drones) and 2.1e-3 (H100 vs
# CPU, 16,384 drones); a drone whose roll inertia is 1% off moves them by
# 1.6 (CPU, 256 drones).  Phase (b) prints both readings on every run and
# fails if the planted error stays inside the limit.  Positions and
# rewards stay near 1e-6.

def phase_hover():
    cfg, task = hover_setup()
    for b in HOVER_ENVS:
        env_phase("a-hover-dyn", cfg, task, b, atol_obs=2e-5, atol_rew=2e-5)


def phase_routing():
    from gym_pybullet_drones_tpu.envs import make_routing_config
    cfg, task = make_routing_config(num_drones=4)
    heavy = dataclasses.replace(cfg.drone, ixx=1.01 * cfg.drone.ixx)
    env_phase("b-routing-pyb-pid", cfg, task, ROUTING_ENVS, atol_obs=1e-2,
              atol_rew=2e-4, seeds=(0, 1, 2),
              planted=dataclasses.replace(cfg, drone=heavy))


def _losses(m):
    return np.asarray([m[k] for k in ("mean_reward", "pg_loss", "v_loss",
                                      "entropy")], np.float64)


def phase_ppo():
    """PPO Hover 8192: 3 updates through update.many on the card; the first
    update at highest precision vs the same update on the CPU backend."""
    from gym_pybullet_drones_tpu.rl import PPOConfig, make_train
    cfg, task = hover_setup()
    ppo = PPOConfig(num_envs=8192, rollout_steps=64, num_minibatches=4,
                    update_epochs=4)
    init, update, _, _ = make_train(cfg, task, ppo)
    print(f"[c-ppo] env_path={update.env_path}", flush=True)
    ts = init(jax.random.key(0))
    many = compiled(lambda t: update.many(t, 3), ts, label="c-ppo update x3")
    _, m = jax.device_get(many(ts))
    for k, v in m.items():
        assert np.all(np.isfinite(v)), (k, v)
    print(f"  metrics per update: "
          f"{ {k: np.round(v, 5).tolist() for k, v in m.items()} }",
          flush=True)
    with jax.default_matmul_precision("highest"):
        one = compiled(update, ts, label="c-ppo update @highest")
        _, m_gpu = jax.device_get(one(ts))
        with jax.default_device(jax.devices("cpu")[0]):
            c_init, c_update, _, _ = make_train(cfg, task, ppo)
            assert c_update.env_path == "batched"
            _, m_cpu = jax.device_get(
                jax.jit(c_update)(c_init(jax.random.key(0))))
    # the losses average 16 minibatch passes of 131k samples: sums in
    # another order, and Adam steps that divide by sqrt(v) + 1e-5, move
    # them by far less than 1e-3 of their scale
    assert_close("c-ppo first-update losses gpu vs cpu", _losses(m_gpu),
                 _losses(m_cpu), atol=1e-5, rtol=1e-3)


def phase_population():
    """K=8 x 1024 envs, 1 update; member 0 vs a single make_train run."""
    from gym_pybullet_drones_tpu.rl import (PPOConfig, make_train,
                                            make_train_population)
    cfg, task = hover_setup()
    ppo = PPOConfig(num_envs=1024, rollout_steps=64, num_minibatches=4,
                    update_epochs=4)
    k = 8
    p_init, p_update, _, _ = make_train_population(cfg, task, ppo, k)
    print(f"[d-population] env_path={p_update.env_path} K={k}", flush=True)
    ts = p_init(jax.random.key(0))
    upd = compiled(p_update, ts, label="d-population update")
    new_ts, m = jax.device_get(upd(ts))
    assert np.all(np.isfinite(m["mean_reward"])), m
    init, update, _, _ = make_train(cfg, task, ppo)
    key0 = jax.random.split(jax.random.key(0), k)[0]
    ts0, m0 = jax.device_get(jax.jit(update)(init(key0)))
    # vmapped K-batched GEMMs reduce in another order than one policy's
    for a, b in zip(jax.tree.leaves(new_ts.params),
                    jax.tree.leaves(ts0.params)):
        np.testing.assert_allclose(a[0], b, rtol=1e-3, atol=1e-5)
    assert_close("d-population member 0 reward", m["mean_reward"][0],
                 m0["mean_reward"], atol=1e-5, rtol=1e-4)


def phase_pixels():
    """RGB render step at 256 envs vs the CPU backend; one pixel-PPO update
    at 512 envs."""
    from gym_pybullet_drones_tpu.envs import fast
    from gym_pybullet_drones_tpu.rl import PPOConfig, make_train
    from gym_pybullet_drones_tpu.utils.enums import (ActionType,
                                                     ObservationType)
    cfg, task = hover_setup(obs=ObservationType.RGB)
    path, reset_fn, step_fn = fast.make_env_step(cfg, task, 256)
    print(f"[e-pixels] render env_path={path}", flush=True)
    actions = ACTION_SCALE * np.random.default_rng(1).standard_normal(
        (2, 256, 1, 4)).astype(np.float32)
    run = _rollout(step_fn, 2)
    state = reset_fn()[0]
    comp = compiled(run, state, actions, label="e-pixels render step")
    img = np.asarray(jax.device_get(comp(state, actions))[1])
    with jax.default_device(jax.devices("cpu")[0]):
        c_state = reset_fn()[0]
        c_img = np.asarray(jax.device_get(jax.jit(run)(c_state, actions))[1])
    assert img.shape == c_img.shape and img.size == 256 * 48 * 64 * 4, \
        img.shape
    # a ray that grazes an edge may hit the other surface after a few-ulp
    # difference in the camera pose: count such pixels instead of bounding
    # them, and hold everything else to one intensity level
    off = np.abs(img - c_img) > 1.0
    print(f"  e-pixels: {off.mean():.2e} of values differ by > 1 "
          f"(limit 1e-3)", flush=True)
    assert off.mean() < 1e-3
    ppo = PPOConfig(num_envs=512, rollout_steps=32, num_minibatches=4,
                    update_epochs=2, lr=1e-4)
    init, update, _, _ = make_train(
        cfg, hover_setup(act=ActionType.ONE_D_RPM,
                         obs=ObservationType.RGB)[1], ppo)
    ts = init(jax.random.key(0))
    upd = compiled(update, ts, label="e-pixels ppo update")
    _, m = jax.device_get(upd(ts))
    for k, v in m.items():
        assert np.isfinite(v), (k, v)
    print(f"  e-pixels ppo metrics: { {k: float(v) for k, v in m.items()} }",
          flush=True)


def phase_gpu_tests():
    """The repository's `gpu`-marked tests, in this process: every fused
    kernel configuration compiled and compared with the XLA step."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import test_fused_gpu
    for name in test_fused_gpu.CONFIGS:
        t0 = time.perf_counter()
        test_fused_gpu.test_fused_kernel_matches_xla_on_card(name, gpu=None)
        print(f"[gpu-tests] {name}: ok ({time.perf_counter() - t0:.1f} s)",
              flush=True)


def timed_window(card: str):
    """Hover-DYN 4096 env-steps/s on the chosen path."""
    from bench import env_rollout, random_actions, time_windows
    from gym_pybullet_drones_tpu.envs import fast
    cfg, task = hover_setup()
    b, t = HOVER_ENVS[0], 256
    path, reset_fn, step_fn = fast.make_env_step(cfg, task, b)
    sec, compile_s = time_windows(env_rollout(step_fn), reset_fn()[0],
                                  random_actions(t, b, cfg, task, seed=2),
                                  windows=5)
    print(f"[timing] hover-dyn {b} envs, {path} path: {b * t / sec:.0f} "
          f"env-steps/s (median of 5 windows of {t} steps, compile "
          f"{compile_s:.1f} s; {card})", flush=True)


def phase_four_cards():
    """Env-sharded PPO Hover, 4x8192 envs over a 1-D 4-card mesh, vs the
    same global batch on one card: one update."""
    from gym_pybullet_drones_tpu.parallel import (
        make_mesh, make_sharded_update, shard_train_state)
    from gym_pybullet_drones_tpu.rl import PPOConfig, make_train
    devices = jax.devices()
    if len(devices) != 4:
        raise RuntimeError(f"--four-cards needs 4 GPUs, found {len(devices)}")
    cfg, task = hover_setup()
    ppo = PPOConfig(num_envs=4 * 8192, rollout_steps=64, num_minibatches=4,
                    update_epochs=4)
    mesh = make_mesh(devices)
    with jax.default_matmul_precision("highest"):
        init, update, _, _ = make_train(cfg, task, ppo, mesh=mesh)
        print(f"[four-cards] env_path={update.env_path} mesh={mesh.shape}",
              flush=True)
        ts = shard_train_state(init(jax.random.key(0)), mesh)
        sharded = make_sharded_update(update, mesh)
        t0 = time.perf_counter()
        comp = sharded.lower(ts).compile()
        print(f"[four-cards] compile {time.perf_counter() - t0:.1f} s; "
              f"{comp.memory_analysis()}", flush=True)
        new_ts, m = comp(ts)
        leaf = jax.tree.leaves(new_ts.env_state)[0]
        assert len(leaf.sharding.device_set) == 4, leaf.sharding
        print(f"  env leaf {leaf.shape} on {len(leaf.sharding.device_set)} "
              f"devices: {leaf.sharding}", flush=True)
        with jax.default_device(devices[0]):
            s_init, s_update, _, _ = make_train(cfg, task, ppo)
            ref_ts, ref_m = jax.jit(s_update)(s_init(jax.random.key(0)))
        # the gradient is a mean over the same global batch; only the
        # order of the all-reduce's partial sums differs
        for a, b in zip(jax.tree.leaves(jax.device_get(new_ts.params)),
                        jax.tree.leaves(jax.device_get(ref_ts.params))):
            np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-5)
        assert_close("four-cards losses sharded vs one card",
                     _losses(jax.device_get(m)),
                     _losses(jax.device_get(ref_m)), atol=1e-5, rtol=1e-3)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card sharded PPO phase")
    args = ap.parse_args()
    require_gpu()
    sys.path.insert(0, REPO)
    from gym_pybullet_drones_tpu.utils.platform import enable_compile_cache
    enable_compile_cache()
    card = card_line()
    if args.four_cards:
        phases = [phase_four_cards]
    else:
        phases = [phase_hover, phase_routing, phase_ppo, phase_population,
                  phase_pixels, phase_gpu_tests, lambda: timed_window(card)]
    failed = []
    for phase in phases:
        try:
            phase()
        except Exception:  # report every phase, fail the run at the end
            traceback.print_exc()
            sys.stdout.flush()
            failed.append(getattr(phase, "__name__", "phase"))
    print(f"card: {card}", flush=True)
    if failed:
        print(f"chip_smoke: FAILED phases {failed}", file=sys.stderr)
        return 1
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
