"""Backend selection and the persistent compile cache for scripts.

The single-env example demos are host-loop programs (one env.step per
Python iteration): running them against an accelerator turns every step
into a device round-trip.  They therefore default to the CPU backend;
batched training and benchmarks (learn.py, bench.py) run on the default
device.  Must be called before any jax computation.
"""
from __future__ import annotations

import os

import jax

_REPO_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".cache", "jax_xla_cache")


def select_platform(device: str | None = None) -> str:
    """Set jax's platform: explicit arg > GPD_PLATFORM env var > cpu."""
    name = device or os.environ.get("GPD_PLATFORM", "cpu")
    if name != "default":
        jax.config.update("jax_platforms", name)
    return name


def enable_compile_cache() -> str:
    """Use the persistent XLA compile cache; returns its directory.

    JAX reads JAX_COMPILATION_CACHE_DIR itself when it is set; otherwise
    the cache lives at the fixed <repo>/.cache/jax_xla_cache (the path is
    part of the cache key, so it must not move between runs).
    """
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return os.environ["JAX_COMPILATION_CACHE_DIR"]
    jax.config.update("jax_compilation_cache_dir", _REPO_CACHE)
    return _REPO_CACHE
