"""The benchmark of the PyTorch/CUDA port (``src/repro_torch``).

    python bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cells are ``BENCHMARK.json``'s
``workloads``; ``bench/harness/cli.py`` says what one run does.
"""
import time

T_START = time.perf_counter()

import os      # noqa: E402
import sys     # noqa: E402
from pathlib import Path   # noqa: E402

# one host thread for the CPU's own math: the port's host loop runs on one
# core, and idle worker threads of a pool only compete with it
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(var, "1")

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench.harness import cli   # noqa: E402

if __name__ == "__main__":
    sys.exit(cli.main(t_start=T_START))
