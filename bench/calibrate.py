"""Readings that the cells' correctness limits are set from, on the card,
in one process (the benchmark's runs never call this).

    python bench/calibrate.py --workload <name> --seeds 1,2,... \
        [--control 1,2,...] [--faults half,token]

For each seed: the cell's set-up and one unit of its window at the
cell's own size (a serving cell's batch, whose longest request finishes
in it; an RL cell needs none: its set-up's iterations are what is
compared), then the program's readings.  For the ``--control`` seeds
also the control's: the reference in the next lower precision put in the
program's place (fp8 for a bfloat16 cell, TF32 for a float32 one); for
an RL cell ``--faults`` adds faults planted in that stand-in (``half``:
the loss's mean over half of the rows; ``token``: GEN's log-probs read
at altered tokens).  One JSON line per reading.
"""
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import argparse  # noqa: E402
import os  # noqa: E402

for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(var, "1")

import torch  # noqa: E402

from bench.harness import spec  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", default="")
    ap.add_argument("--faults", default="")
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    low = "fp8" if cell.dtype == "bfloat16" else "tf32"
    controls = {int(s) for s in args.control.split(",") if s}
    faults = [f for f in args.faults.split(",") if f]
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        drv = spec.driver(cell).Driver(cell, seed, device, spec.family(cell),
                                       spec.reference(cell))
        drv.setup()
        units = [] if cell.kind == "rl_grpo" else [drv.unit(drv.first_unit)]
        drv.free()
        modes = ["fp32"] + ([low] + faults if seed in controls else [])
        for mode in modes:
            print(json.dumps({"workload": cell.name, "seed": seed,
                              "reading": "program" if mode == "fp32"
                              else mode,
                              "numbers": drv.readings(units, mode),
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
        del drv, units
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
