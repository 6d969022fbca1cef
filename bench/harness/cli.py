"""One run of one cell: set-up, the measured window, the check, and the
result line.

    python bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (``setup_s``, from the process's start to the window's) makes the
weights on the card from the seed, builds the program's objects and runs
every shape of the cell once (the first run in a checkout also builds
the port's CUDA kernels into ``build/kernels/``).  The window runs the
cell's units back to back (engine batches, RL iterations) until
``--seconds`` have passed; the last one finishes.  With ``--trace 1`` the
window runs under the profiler with the port's spans on, and the result
carries the per-layer metrics instead of the end-to-end ones.  Then the
peak memory, the metrics, the program's state freed, and the comparison
with the plain reference that decides ``correct``: each number beside
its limit, last on standard error and last in the line.  A run whose
process has loaded JAX or the JAX package by then prints no result.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import sys
import time
from typing import Optional

import torch

from bench.harness import devtrace, spec

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


@dataclasses.dataclass
class Run:
    """What a metric's reader reads."""
    cell: spec.Cell
    family: object
    units: list
    setup_s: float
    trace: Optional[devtrace.Trace]

    @property
    def span(self):
        return (self.units[0]["t0"], self.units[-1]["t1"])


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="bench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules(modules=None):
    """JAX and the JAX package among the loaded modules, by whole
    top-level names (``repro_torch`` is not ``repro``)."""
    names = list(sys.modules if modules is None else modules)
    return sorted(FORBIDDEN & {m.split(".")[0] for m in names})


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> dict:
    fam, ref = spec.family(cell), spec.reference(cell)
    drv = spec.driver(cell).Driver(cell, seed, device, fam, ref)
    drv.setup()
    # what set-up made stays: a collection in the window then walks only
    # the window's own objects
    gc.collect()
    gc.freeze()
    cuda = device.type == "cuda"
    tracer = devtrace.Tracer(device) if trace else None
    if tracer:
        tracer.start()
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    units = []
    while True:
        u = drv.unit(drv.first_unit + len(units))
        units.append(u)
        print(f"unit {len(units)}: {u['t1'] - u['t0']:.3f} s "
              + " ".join(f"{k}={v}" for k, v in u.items()
                         if isinstance(v, (int, float))
                         and k not in ("t0", "t1")),
              file=sys.stderr)
        if time.perf_counter() - t0 >= seconds:
            break
    tr = tracer.stop() if tracer else None
    gc.unfreeze()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    rec = Run(cell, fam, units, t0 - t_start, tr)
    metrics = spec.read_metrics(
        cell, cell.per_layer if trace else cell.end_to_end, rec)
    drv.free()
    readings = drv.readings(units)
    checks = {n: {"value": v, "limit": cell.limits[n]}
              for n, v in readings.items()}
    attempted, failed = drv.attempted_failed(units)
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
           "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": dev}
    if tr is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        out["breakdown"] = tr.breakdown()
    out["checks"] = checks
    return out


def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = run(cell, args.seed, args.seconds, bool(args.trace),
              torch.device("cuda", 0), t_start)
    leaked = forbidden_modules()
    if leaked:
        print(f"the run loaded {', '.join(leaked)}: no result",
              file=sys.stderr)
        return 1
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out))
    return 0
