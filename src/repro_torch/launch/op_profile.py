"""Dry-run 'profiler': rank one step's heaviest aten ops.

Counterpart of ``repro.launch.hlo_profile``.  The reference attributes
the loop-aware FLOPs / bytes / collective volume of a stored HLO module
to its ops; here the step is counted anew on fake tensors
(``launch.dryrun``: the production mesh, per device) and each (aten op,
output shape) row carries its summed counts and how often it ran.
Prints the top rows as the reference prints its ops:

    PYTHONPATH=src python -m repro_torch.launch.op_profile \\
        --arch qwen3-0.6b --shape decode_32k --top 15 [--sort flops]
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Tuple


def op_contributions(rec: Dict) -> List[Tuple[float, float, float, str,
                                              str]]:
    """(flops, bytes, collective bytes, "op shape", "×count") per row of
    a counted record (``dryrun.count_step`` / ``dryrun_one``)."""
    return [(fl, by, co, f"{op} {shape[:42]}", f"×{n}")
            for (op, shape), (fl, by, co, n) in rec["_rows"].items()]


def render(rows, top: int, sort: str) -> str:
    key = {"flops": 0, "bytes": 1, "coll": 2}[sort]
    rows = sorted(rows, key=lambda r: -r[key])
    tot = [sum(r[i] for r in rows) for i in range(3)]
    out = [f"totals: flops={tot[0]:.3e} bytes={tot[1]:.3e} "
           f"coll={tot[2]:.3e}",
           f"{'flops':>10s} {'bytes':>10s} {'coll':>10s}  op"]
    for r in rows[:top]:
        out.append(f"{r[0]:10.2e} {r[1]:10.2e} {r[2]:10.2e}  {r[3]}  "
                   f"[{r[4]}]")
    return "\n".join(out)


def main(argv=None):
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.launch.dryrun import dryrun_one
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--sort", choices=["flops", "bytes", "coll"],
                    default="bytes")
    args = ap.parse_args(argv)
    rec = dryrun_one(args.arch, args.shape, args.multi_pod, verbose=False)
    if "skipped" in rec:
        print(f"SKIP: {rec['skipped']}")
        return
    print(render(op_contributions(rec), args.top, args.sort))


if __name__ == "__main__":
    main()
