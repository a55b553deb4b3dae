"""Helpers of the benchmark's CPU tests: one run of a cell at the tiny
CPU shapes, in this process, and its result line."""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))


def run_tiny(capsys, workload: str, *extra: str, seed: int = 3,
             seconds: float = 0.3) -> tuple[int, dict | None, str]:
    """(exit code, the result line as a dict or None, standard error)."""
    from bench import harness

    # a test process may hold JAX from other test files: the run is held
    # to the modules that it loads itself
    before = set(harness.forbidden_modules())
    check = harness.forbidden_modules
    harness.forbidden_modules = lambda: [m for m in check()
                                         if m not in before]
    capsys.readouterr()
    try:
        rc = harness.main(["--workload", workload, "--seed", str(seed),
                           "--seconds", str(seconds), "--tiny", *extra])
    finally:
        harness.forbidden_modules = check
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err
