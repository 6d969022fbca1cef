"""Recount the metrics of existing dry-run JSONs.

Port of ``repro.launch.reanalyze``.  The reference re-reads each
record's stored HLO (``.hlo.zst``) and reruns its loop-aware analysis
without recompiling; the port stores no HLO (it lowers to none), so
each record is counted anew from its (arch, shape, mesh)
(``dryrun.dryrun_one``, a few seconds on fake tensors) and its count
fields are rewritten in place: ``flops_per_device``,
``bytes_per_device``, ``collective_bytes_per_device``.

    PYTHONPATH=src python -m repro_torch.launch.reanalyze \\
        [--dir results/dryrun_torch]
"""
from __future__ import annotations

import argparse
import glob
import json
import os

COUNT_FIELDS = ("flops_per_device", "bytes_per_device",
                "collective_bytes_per_device")


def reanalyze(result_dir: str) -> int:
    """Rewrite the count fields of every record in ``result_dir`` from
    ``dryrun.dryrun_one``; returns how many."""
    from repro_torch.launch import dryrun
    n = 0
    for path in sorted(glob.glob(os.path.join(result_dir, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        if "skipped" in rec:
            continue
        new = dryrun.dryrun_one(rec["arch"], rec["shape"],
                                rec.get("multi_pod", False), verbose=False)
        for k in COUNT_FIELDS:
            rec[k] = new[k]
        with open(path, "w") as f:
            json.dump(rec, f, indent=2)
        n += 1
        print(f"reanalyzed {os.path.basename(path)}: "
              f"flops={rec['flops_per_device']:.3e} "
              f"bytes={rec['bytes_per_device']:.3e}")
    return n


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun_torch")
    args = ap.parse_args(argv)
    reanalyze(args.dir)


if __name__ == "__main__":
    main()
