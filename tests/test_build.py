"""Import smoke test (reference tests/test_build.py parity), the main path
with only the required dependencies, and the GPU-only entry points."""
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_imports():
    import gym_pybullet_drones_tpu
    import gym_pybullet_drones_tpu.envs
    import gym_pybullet_drones_tpu.control
    import gym_pybullet_drones_tpu.rl
    import gym_pybullet_drones_tpu.parallel
    import gym_pybullet_drones_tpu.ops
    import gym_pybullet_drones_tpu.utils
    import gym_pybullet_drones_tpu.models


def _run(code_or_script, *, script=False, timeout=600):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("XLA_FLAGS", None)
    cmd = [sys.executable, code_or_script] if script else \
        [sys.executable, "-c", code_or_script]
    return subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=timeout)


def test_ppo_update_without_flax_and_gymnasium():
    """The main path (package, envs, trainer) imports and trains with only
    the required dependencies: flax and gymnasium blocked."""
    res = _run("""
import sys
sys.modules["flax"] = sys.modules["gymnasium"] = None
import jax
from gym_pybullet_drones_tpu import CF2X, Physics
from gym_pybullet_drones_tpu.envs import AviaryConfig, HoverTask
from gym_pybullet_drones_tpu.rl import PPOConfig, make_train
cfg = AviaryConfig(drone=CF2X, physics=Physics.DYN, pyb_freq=240,
                   ctrl_freq=30)
ppo = PPOConfig(num_envs=8, rollout_steps=8, num_minibatches=2,
                update_epochs=1)
init, update, _, _ = make_train(cfg, HoverTask(), ppo)
ts, m = jax.jit(update)(init(jax.random.key(0)))
assert all(jax.numpy.isfinite(v) for v in m.values()), m
assert not any("gym_adapter" in k for k in sys.modules)
print("PPO OK", update.env_path)
""")
    assert res.returncode == 0, res.stderr[-3000:]
    assert "PPO OK batched" in res.stdout


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py",
                                    "bench_all.py"])
def test_gpu_entry_points_refuse_the_cpu(script):
    """The card-only entry points exit non-zero and print no result when
    JAX finds no GPU."""
    res = _run(os.path.join(ROOT, script), script=True, timeout=300)
    assert res.returncode != 0
    assert "needs a GPU" in res.stderr, res.stderr[-2000:]
    assert '"ok"' not in res.stdout and '"value"' not in res.stdout
