"""Finding the benchmark's pieces by name.

``BENCHMARK.json`` at the checkout root lists the cells; everything that
belongs to one configuration, traffic mix, cell or metric is a file of
its own, found by its name:

  configs/<config>.json         the configuration as it is run (its
                                ``family`` names the next two)
  families/<family>.py          weight layout, the port's config, work counts
  reference/<family>.py         the plain reference
  traffic/<mix>.json            the mix's parameters (``kind`` picks the
                                driver: ``harness/drivers/<kind>.py``)
  limits/<workload>.json        the cell's correctness limits
  metrics/<metric>.py           the metric's reader: ``read(run)``

A later cell or metric is new files and new entries, never an edit.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from typing import Dict, List, Optional

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    bench_dir: Path

    @property
    def kind(self) -> str:
        return self.traffic["kind"]

    @property
    def family(self) -> str:
        return self.config["family"]

    @property
    def dtype(self) -> str:
        """The configuration's dtype for this kind of cell."""
        return self.config["dtype"][self.kind]


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, root: Path = ROOT,
              bench_dir: Optional[Path] = None) -> Cell:
    bench_dir = bench_dir or root / "bench"
    bm = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bm["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; have {sorted(cells)}")
    w = cells[workload]
    cfg_entry = {c["name"]: c for c in bm["configs"]}[w["config"]]
    config = load_json(root / cfg_entry["file"])
    traffic = load_json(bench_dir / "traffic" / f"{w['traffic']}.json")
    limits = load_json(bench_dir / "limits" / f"{workload}.json")["limits"]
    return Cell(name=workload, chips=int(w["chips"]), config=config,
                traffic=traffic, limits=limits,
                end_to_end=[m for m in bm["end_to_end"]
                            if _applies(m, workload)],
                per_layer=[m for m in bm["per_layer"]
                           if _applies(m, workload)],
                bench_dir=bench_dir)


def load_file(path: Path, name: str):
    """The module in ``path`` (metric files carry dots in their names, so
    they are loaded by path)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(cell: Cell, metric: str):
    path = cell.bench_dir / "metrics" / f"{metric}.py"
    return load_file(path, "bench_metric_" + metric.replace(".", "_")
                     .replace("-", "_"))


def family(cell: Cell):
    return load_file(cell.bench_dir / "families" / f"{cell.family}.py",
                     f"bench_family_{cell.family}")


def reference(cell: Cell):
    return load_file(cell.bench_dir / "reference" / f"{cell.family}.py",
                     f"bench_reference_{cell.family}")


def driver(cell: Cell):
    return load_file(cell.bench_dir / "harness" / "drivers"
                     / f"{cell.kind}.py", f"bench_driver_{cell.kind}")


def read_metrics(cell: Cell, metrics: List[dict], run) -> Dict[str, dict]:
    """Each metric's reader on the finished run; a reader that finds
    nothing to read returns None and the metric is left out."""
    out = {}
    for m in metrics:
        value = metric_reader(cell, m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
