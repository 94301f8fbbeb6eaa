"""Test configuration: force CPU backend with 8 virtual devices + float64.

The suite runs on the CPU: multi-device sharding logic is exercised on a
virtual 8-device CPU mesh (xla_force_host_platform_device_count), the
fused GPU kernel runs in the Pallas interpreter (interpret=True), and
parity tests against the float64 NumPy oracle require x64 mode.  The
jax.config.update calls below override whatever JAX_PLATFORMS says.
XLA_FLAGS is read lazily at first backend initialization, so setting it
here works as long as no test module touches a jax array at import time.
Tests that need a GPU carry the `gpu` marker and skip here (the `gpu`
fixture); chip_smoke.py runs them on the card.
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

# Persistent XLA compilation cache across test processes AND suite runs
# (JAX_COMPILATION_CACHE_DIR when set, else <repo>/.cache/jax_xla_cache).
# The suite's wall-clock is dominated by XLA:CPU compiles of the
# interpret-mode Pallas programs; with the cache, identical programs (same
# file re-run, or shared kernels across files) load in seconds.
# Correctness-neutral: the cache key is the full HLO + compile options +
# backend, and a miss just compiles.
from gym_pybullet_drones_tpu.utils.platform import enable_compile_cache  # noqa: E402

enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided at run time)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (runs on the card through chip_smoke.py)")
