#!/usr/bin/env python
"""One-command reproducible test run with per-file process isolation.

A single-process `pytest tests/` has died with SIGSEGV inside XLA:CPU `backend_compile_and_load` after ~110 tests'
worth of in-process compilations (reproduced twice at
tests/test_pallas.py::test_pallas_env_box_obstacle_matches_core; the same
test passes alone, and every file passes in chunked runs) — compiler-state
accumulation in one long-lived process, not a test-logic bug.  The fix is
process isolation: each test FILE runs in a fresh pytest subprocess, so no
process compiles more than one file's worth of XLA programs.  Up to
--jobs subprocesses run concurrently (default: min(4, cpu_count)).

Runs share a persistent XLA compilation cache (JAX_COMPILATION_CACHE_DIR,
else .cache/jax_xla_cache; set up in tests/conftest.py): the first-ever
run pays the full XLA:CPU compile cost of the interpret-mode Pallas
programs; later runs (and re-runs of a single file during development)
load the compiled executables from disk.

Usage:  python scripts/run_tests.py [--jobs N] [extra pytest args...]
Exit status is non-zero iff any file fails; a per-file and aggregate
summary is printed either way.  Wired into build_project.sh and CI
(.github/workflows/push.yml).
"""
from __future__ import annotations

import argparse
import glob
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--jobs", type=int,
                    default=min(4, os.cpu_count() or 1))
    args, extra = ap.parse_known_args()

    files = sorted(glob.glob(os.path.join(ROOT, "tests", "test_*.py")))
    if not files:
        print("no test files found", file=sys.stderr)
        return 2

    # Launch order: test_distributed.py FIRST — it is the suite's only
    # true multi-process proof and its workers have a hard timeout, so it
    # must run before the interpret-mode Pallas giants load the host.
    # Then longest-first (the interpret-mode files dominate wall-clock;
    # starting them early minimizes makespan with --jobs slots), then the
    # rest alphabetically.  At most ONE file from HEAVY runs at a time: two
    # interpret-mode Pallas traces sharing a 2-core host contend on XLA
    # compile threads and run far slower than back-to-back.
    _front = ["test_distributed.py", "test_fused_mesh.py", "test_fused.py",
              "test_pallas.py", "test_ppo.py"]
    _rank = {n: i for i, n in enumerate(_front)}
    HEAVY = {"test_fused_mesh.py", "test_fused.py", "test_pallas.py"}
    pending = sorted(files, key=lambda p: (
        _rank.get(os.path.basename(p), len(_front)), p))
    running: list[tuple[str, subprocess.Popen, object]] = []
    results: dict[str, tuple[int, str]] = {}
    start = time.time()

    def launch(path: str):
        import tempfile
        out = tempfile.TemporaryFile(mode="w+")
        proc = subprocess.Popen(
            [sys.executable, "-m", "pytest", path, "-q", *extra],
            cwd=ROOT, stdout=out, stderr=subprocess.STDOUT)
        running.append((path, proc, out))

    def heavy_running() -> bool:
        return any(os.path.basename(p) in HEAVY for p, _, _ in running)

    while pending or running:
        while pending and len(running) < args.jobs:
            # hold a heavy file back while another heavy runs AND light
            # work remains (avoids two interpret-mode traces contending);
            # once only heavies are left, run them concurrently — an idle
            # core is worse than the contention penalty
            only_heavy = all(os.path.basename(p) in HEAVY for p in pending)
            idx = next(
                (i for i, p in enumerate(pending)
                 if only_heavy or not (os.path.basename(p) in HEAVY
                                       and heavy_running())),
                None)
            if idx is None:
                break
            launch(pending.pop(idx))
        time.sleep(0.2)
        for item in running[:]:
            path, proc, out = item
            if proc.poll() is None:
                continue
            running.remove(item)
            out.seek(0)
            text = out.read()
            out.close()
            results[path] = (proc.returncode, text)
            rel = os.path.relpath(path, ROOT)
            m = re.search(r"(\d+) passed", text)
            npass = m.group(1) if m else "?"
            status = "ok" if proc.returncode == 0 else \
                f"FAILED (rc={proc.returncode})"
            print(f"[{len(results)}/{len(files)}] {rel}: {status} "
                  f"({npass} passed)", flush=True)
            if proc.returncode != 0:
                sys.stdout.write(text[-4000:])

    total_pass = sum(
        int(m.group(1)) for _, t in results.values()
        if (m := re.search(r"(\d+) passed", t)))
    failed = [p for p, (rc, _) in results.items() if rc != 0]
    dur = time.time() - start
    print(f"\n{'=' * 60}\n{len(files) - len(failed)}/{len(files)} files "
          f"green, {total_pass} tests passed, {dur:.0f}s")
    if failed:
        print("FAILED files:")
        for p in failed:
            print(f"  {os.path.relpath(p, ROOT)}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
