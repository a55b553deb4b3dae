"""The benchmark's one command: one run of one cell of ``BENCHMARK.json``.

    python3 bench/run.py --workload imagenet.sample --seed 7 --seconds 15 \\
        --trace 0

prints the run's result as the last line of standard output, and each
number compared with its limit as the last lines of standard error. Run it
from the root of a checkout; it reads and writes only there (the port's
kernels build into ``build/kernels``).
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent

if __name__ == "__main__":
    # caches the program or a library may fill, at fixed paths in the
    # checkout
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / "build" / "torch_extensions"))
    os.environ.setdefault("USE_FLAX", "0")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from bench import harness

    sys.exit(harness.main(t_start=T_START))
