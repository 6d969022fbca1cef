"""Device idle share and time breakdown of one serving run on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve \\
        --arch qwen3-0.6b --batch 48 --wave 16 --prompt-len 256 \\
        --new-tokens 64 [--json FILE]

Takes the launcher's arguments (``repro_torch.launch.serve``).  After a
warm-up pass it serves the batch once unprofiled and once under
``torch.profiler`` (host and card activity), and reports:

  * the card's busy time: the union of the intervals of every kernel,
    copy and memset the card ran during the profiled pass;
  * the idle share, 1 - busy / wall, over the profiled pass's wall time
    and over the unprofiled pass's (the profiler slows the host, not
    the card, so the second is the estimate for an ordinary run);
  * kernels per decode step, and the kernels and host ops that take the
    most time.

``--json`` also writes the report as one JSON object.  Needs a CUDA
card: the trace has no device activity without one.  ``main(argv,
cfg=...)`` profiles a depth cut, as ``serve.run`` serves one:

    PYTHONPATH=src python -c "import dataclasses as d; \
        from repro_torch.configs import archs; \
        from repro_torch.launch import profile_serve as p; \
        c = archs.get('jamba-1.5-large-398b'); \
        p.main('--arch jamba-1.5-large-398b --batch 48 --wave 16 \
        --prompt-len 256 --new-tokens 64'.split(), \
        cfg=d.replace(c, n_layers=4, pattern=c.pattern[:4]))"
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import tempfile
import time
from typing import Dict, List, Optional

import torch

from repro_torch.device import synchronize
from repro_torch.launch import serve
from repro_torch.models.config import ModelConfig

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _busy_us(intervals: List[tuple]) -> float:
    """Length of the union of [start, end) intervals (microseconds)."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        busy += e - max(s, end)
        end = e
    return busy


def device_events(prof) -> List[dict]:
    """The card's activity (kernels, copies, memsets) of a finished
    profile, as Chrome-trace events with ``ts``/``dur`` in µs."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return [e for e in events
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]


def run(args: argparse.Namespace, top: int = 10,
        cfg: Optional[ModelConfig] = None) -> Dict[str, object]:
    device, cfg, dtype, wave, gen = serve.prepare(args, cfg)
    if device.type != "cuda":
        raise SystemExit("profile_serve measures the card: run it with "
                         "--device cuda")
    gen()                                    # warm-up: build, allocator
    synchronize(device)
    t0 = time.perf_counter()
    _, stats = gen()
    synchronize(device)
    wall = time.perf_counter() - t0

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        gen()
        synchronize(device)
        wall_prof = time.perf_counter() - t0
    dev = device_events(prof)
    if not dev:
        raise SystemExit("the profiler recorded no device activity")
    busy = _busy_us([(e["ts"], e["ts"] + e["dur"]) for e in dev]) / 1e6
    kernels = [e for e in dev if e["cat"] == "kernel"]
    by_name: Dict[str, List[float]] = collections.defaultdict(
        lambda: [0, 0.0])
    for e in kernels:
        by_name[e["name"]][0] += 1
        by_name[e["name"]][1] += e["dur"] / 1e3
    top_kernels = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    host = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)
    steps = stats["decode_steps"]
    rep = {
        "arch": cfg.name, "dtype": str(dtype), "batch": args.batch,
        "wave": wave, "decode_steps": steps, "prefills": stats["prefills"],
        "card": torch.cuda.get_device_name(device),
        "wall_s": wall, "wall_profiled_s": wall_prof, "busy_s": busy,
        "idle_share": 1.0 - busy / wall,
        "idle_share_profiled": 1.0 - busy / wall_prof,
        "wall_ms_per_step": wall / steps * 1e3,
        "busy_ms_per_step": busy / steps * 1e3,
        "kernels": len(kernels), "kernels_per_step": len(kernels) / steps,
        "top_kernels": [{"name": n[:120], "count": c, "ms": ms,
                         "share_of_busy": ms / 1e3 / busy}
                        for n, (c, ms) in top_kernels],
        "top_host_ops": [{"name": a.key, "count": a.count,
                          "self_ms": a.self_cpu_time_total / 1e3}
                         for a in host[:top]],
    }
    print(f"{cfg.name} {rep['dtype']} batch {args.batch} wave {wave} on "
          f"{rep['card']}: {steps} decode steps, {stats['prefills']} "
          f"prefills")
    print(f"wall {wall:.4f} s unprofiled ({rep['wall_ms_per_step']:.3f} "
          f"ms/step), {wall_prof:.4f} s profiled; card busy {busy:.4f} s "
          f"({rep['busy_ms_per_step']:.3f} ms/step)")
    print(f"device idle share {rep['idle_share']:.4f} (over the unprofiled "
          f"wall), {rep['idle_share_profiled']:.4f} (over the profiled "
          f"wall); {len(kernels)} kernels, "
          f"{rep['kernels_per_step']:.1f} per decode step")
    for k in rep["top_kernels"]:
        print(f"  kernel {k['ms']:10.3f} ms {k['share_of_busy']:7.2%} "
              f"x{k['count']:<7d} {k['name'][:90]}")
    for h in rep["top_host_ops"]:
        print(f"  host   {h['self_ms']:10.3f} ms self x{h['count']:<7d} "
              f"{h['name'][:90]}")
    return rep


def main(argv: Optional[List[str]] = None,
         cfg: Optional[ModelConfig] = None) -> Dict[str, object]:
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--json", default=None, metavar="FILE",
                    help="also write the report as JSON")
    own, rest = ap.parse_known_args(argv)
    rep = run(serve.parse_args(rest), cfg=cfg)
    if own.json:
        os.makedirs(os.path.dirname(own.json) or ".", exist_ok=True)
        with open(own.json, "w") as f:
            json.dump(rep, f, indent=1)
    print(json.dumps({k: v for k, v in rep.items()
                      if not k.startswith("top_")}))
    return rep


if __name__ == "__main__":
    main()
