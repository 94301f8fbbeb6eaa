"""True multi-process distributed test: 2 processes x 2 virtual CPU devices.

The virtual-mesh tests (test_ppo) validate sharding semantics in one
process; this spawns REAL separate processes connected through
jax.distributed (the multi-host path on CPU) and runs the
parallel/distributed.py multi-host recipe end to end (SURVEY.md §2.4).
"""
import os
import socket
import subprocess
import sys

import pytest

WORKER = os.path.join(os.path.dirname(__file__), "_dist_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_workers(worker: str, nproc: int = 2, timeout: int = 600,
                 extra_args: tuple = ()):
    """Spawn the rank processes; return (procs, outs) or None on timeout."""
    port = _free_port()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    # the worker is a script (sys.path[0] = tests/); make the package
    # importable without requiring an installed wheel
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(worker)))
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(rank), str(nproc), str(port),
             *extra_args],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env)
        for rank in range(nproc)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        return None
    return procs, outs


def _run_workers_retry(worker: str, nproc: int = 2, timeout: int = 600,
                       extra_args: tuple = ()):
    """One retry on timeout, then FAIL (never skip): this file is the
    suite's only true multi-process proof, and a silent skip under host
    load would let the multi-host recipe vanish from a green run (VERDICT r4
    weak #2).  scripts/run_tests.py schedules this file first so the
    interpret-mode Pallas giants can't starve it."""
    for attempt in (1, 2):
        res = _run_workers(worker, nproc, timeout, extra_args)
        if res is not None:
            return res
        if attempt == 1:
            print("distributed workers timed out; retrying once", flush=True)
    pytest.fail(f"distributed workers timed out twice ({timeout}s each); "
                "multi-process proof did NOT run")


def test_two_process_global_mesh():
    procs, outs = _run_workers_retry(WORKER)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-2000:]
        assert "DIST OK" in out, out[-2000:]


FUSED_WORKER = os.path.join(os.path.dirname(__file__),
                            "_dist_fused_worker.py")


def test_two_process_fused_kernel_mesh():
    """The fused kernel (interpreted) on a MULTI-PROCESS mesh:
    2 processes x 2 devices, global packed carry via
    global_env_batch(env_axis=1), stepped results bitwise-equal to the
    single-process unsharded fused path (asserted inside the rank-0
    worker, tests/_dist_fused_worker.py)."""
    procs, outs = _run_workers_retry(FUSED_WORKER, timeout=900)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-2000:]
        assert "DIST FUSED OK" in out, out[-2000:]
