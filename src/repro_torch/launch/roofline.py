"""Roofline analysis of the dry-run records, on H100 constants.

Port of ``repro.launch.roofline``.  Reads the dry-run JSONs
(``launch.dryrun``) and derives, per (arch x shape x mesh):

    compute term    = FLOPs_per_device / peak FLOP/s (bf16; fp32 when
                      the record's dtype is fp32)
    memory term     = bytes_per_device / HBM bandwidth
    collective term = collective_bytes_per_device / link bandwidth

(the counts are per device already).  Hardware constants: one NVIDIA
H100 SXM, dense rates without sparsity, from NVIDIA's data sheet; the
link is charged at one 400 Gb/s NDR port per GPU, the worst case, as
the reference charges one ICI link.  ``bytes_per_device`` is the
unfused upper bound ``op_analysis`` counts, so the memory term bounds
the fused step's from above.

Also reports MODEL_FLOPS = 6·N·D for train and 2·N·D otherwise
(N_active for MoE), the usefulness ratio MODEL_FLOPS / counted global
FLOPs, and each device's peak memory (``peak_bytes_per_device``) beside
the H100's 80 GB: a combination whose peak exceeds it is marked
``NO FIT``.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List, Optional

PEAK_FLOPS = 989e12      # dense bf16 tensor-core FLOP/s (H100 SXM data sheet)
PEAK_FLOPS_FP32 = 67e12  # fp32 FLOP/s outside the tensor cores (same sheet)
HBM_BW = 3.35e12         # B/s of HBM3 (same sheet)
LINK_BW = 50e9           # B/s: one 400 Gb/s NDR port (1 link charged)
HBM_BYTES = 80e9         # B of HBM3 on one H100 SXM (same sheet)


def peak_flops(rec: Dict) -> float:
    return PEAK_FLOPS_FP32 if rec.get("dtype") in ("f32", "float32") \
        else PEAK_FLOPS


def roofline_terms(rec: Dict) -> Optional[Dict]:
    if "skipped" in rec:
        return None
    n_dev = rec["n_devices"]
    comp = rec["flops_per_device"] / peak_flops(rec)
    mem = rec["bytes_per_device"] / HBM_BW
    coll_b = rec["collective_bytes_per_device"]
    coll = sum(v for k, v in coll_b.items() if k != "total") / LINK_BW
    terms = {"compute_s": comp, "memory_s": mem, "collective_s": coll}
    dominant = max(terms, key=terms.get)
    # MODEL_FLOPS: tokens processed globally
    if rec["phase"] == "train":
        tokens = rec["seq_len"] * rec["global_batch"]
        factor = 6.0
    elif rec["phase"] == "prefill":
        tokens = rec["seq_len"] * rec["global_batch"]
        factor = 2.0
    else:  # decode: one token per sequence
        tokens = rec["global_batch"]
        factor = 2.0
    model_flops = factor * rec["active_params"] * tokens
    counted_global = rec["flops_per_device"] * n_dev
    return {
        **terms,
        "dominant": dominant.replace("_s", ""),
        "model_flops": model_flops,
        "counted_flops_global": counted_global,
        "useful_ratio": model_flops / counted_global if counted_global
        else 0.0,
        "bound_est_s": max(terms.values()),
        "peak_bytes": rec.get("peak_bytes_per_device"),
        "fits": (None if rec.get("peak_bytes_per_device") is None
                 else rec["peak_bytes_per_device"] <= HBM_BYTES),
    }


def load_results(result_dir: str) -> List[Dict]:
    out = []
    for path in sorted(glob.glob(os.path.join(result_dir, "*.json"))):
        with open(path) as f:
            out.append(json.load(f))
    return out


HEADER = (f"{'arch':26s} {'shape':12s} {'mesh':6s} {'comp(s)':>9s} "
          f"{'mem(s)':>9s} {'coll(s)':>9s} {'dominant':>10s} "
          f"{'useful':>7s} {'peak(GB)/80':>12s}")


def row(rec: Dict) -> str:
    """One record's line of ``table``."""
    mesh = "multi" if rec.get("multi_pod") else "single"
    if "skipped" in rec:
        return (f"{rec['arch']:26s} {rec['shape']:12s} {mesh:6s} "
                f"SKIP: {rec['skipped']}")
    t = roofline_terms(rec)
    return (f"{rec['arch']:26s} {rec['shape']:12s} {mesh:6s} "
            f"{t['compute_s']:9.4f} {t['memory_s']:9.4f} "
            f"{t['collective_s']:9.4f} {t['dominant']:>10s} "
            f"{t['useful_ratio']:7.3f} {_peak(t):>12s}")


def _peak(t: Dict) -> str:
    if t["peak_bytes"] is None:
        return "-"
    return f"{t['peak_bytes'] / 1e9:.2f}" + ("" if t["fits"] else
                                              " NO FIT")


def table(result_dir: str = "results/dryrun_torch") -> str:
    rows = [HEADER, "-" * len(HEADER)]
    rows += [row(rec) for rec in load_results(result_dir)]
    return "\n".join(rows)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun_torch")
    args = ap.parse_args(argv)
    print(table(args.dir))


if __name__ == "__main__":
    main()
