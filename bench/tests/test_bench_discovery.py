"""A configuration, a traffic mix, a cell's limits and a metric added as
new files (and entries of ``BENCHMARK.json``) are found by name, with no
edit to any file the benchmark already has."""
import json

import torch

from bench.tests import smallcells
from bench.harness import cli, spec


def test_new_files_are_found_by_name(tmp_path):
    root = smallcells.make_root(tmp_path)
    before = {p: p.read_bytes() for p in (root / "bench").rglob("*")
              if p.is_file() and p.parent.name != "__pycache__"}
    b = root / "bench"
    cfg = json.loads((b / "configs/qwen3-0.6b.json").read_text())
    cfg.update(name="tiny-qwen", num_hidden_layers=1)
    (b / "configs/tiny-qwen.json").write_text(json.dumps(cfg))
    mix = json.loads((b / "traffic/gen_decode.json").read_text())
    mix.update(requests=5, wave=2)
    (b / "traffic/gen_tiny.json").write_text(json.dumps(mix))
    (b / "limits/tiny-qwen.gen_tiny.json").write_text(json.dumps(
        {"limits": {"max_logit_gap": 1e-3, "max_logprob_gap": 1e-3,
                    "short_requests": 0}}))
    (b / "metrics/gen.requests_done.py").write_text(
        "def read(run):\n    return sum(u['requests'] for u in run.units)\n")
    bm = json.loads((root / "BENCHMARK.json").read_text())
    bm["configs"].append({"name": "tiny-qwen", "source": "test",
                          "file": "bench/configs/tiny-qwen.json",
                          "reduced": ["num_hidden_layers"], "why": "test"})
    bm["workloads"].append({"name": "tiny-qwen.gen_tiny",
                            "config": "tiny-qwen", "traffic": "gen_tiny",
                            "chips": 1, "why": "test"})
    bm["end_to_end"].append({"name": "gen.requests_done", "unit": "requests",
                             "better": "higher", "bound": 0.01,
                             "source": "host_clock",
                             "workloads": ["tiny-qwen.gen_tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bm))

    cell = spec.load_cell("tiny-qwen.gen_tiny", root=root)
    assert cell.config["num_hidden_layers"] == 1 and cell.traffic["wave"] == 2
    assert [m["name"] for m in cell.end_to_end] == ["setup_s",
                                                    "gen.requests_done"]
    out = cli.run(cell, 11, 0.0, False, torch.device("cpu"), 0.0)
    assert out["metrics"]["gen.requests_done"]["value"] == 5
    assert out["correct"] and list(out)[-1] == "checks"
    after = {p: p.read_bytes() for p in before}
    assert after == before
