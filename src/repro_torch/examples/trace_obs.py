"""Observability walkthrough: trace a training run, read the span
report, calibrate the cost model from the measured timeline.

Port of ``examples/trace_obs.py``:

    PYTHONPATH=src python -m repro_torch.examples.trace_obs

Runs a few plan-driven GRPO iterations with span tracing enabled,
prints the per-span aggregate report, exports a Chrome-trace JSON
(``results/trace_obs.json`` under the working directory; open it at
https://ui.perfetto.dev or in chrome://tracing), dumps the
metrics-registry snapshot, and fits the cost-model calibration that
turns the engine's measured-vs-predicted iteration ratio from "orders
of magnitude" into "within a few x".

The actor is a 1-layer model of width 32 with 2 heads of 16: on the
card GEN and INF launch both attention kernels at head dim 16, TRAIN
none.  Runs on ``--device cuda`` (the default; raises without a card)
or ``--device cpu``.  ``REPRO_TRACE=trace.json`` / ``REPRO_METRICS=
metrics.json`` enable tracing / the registry dump on any launcher;
``python -m repro_torch.obs.trace trace.json`` validates a trace.
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.data.synthetic import AdditionTask, VOCAB_SIZE
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.obs import calibrate as obs_cal
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.rl.trainer import RLConfig, RLTrainer


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    obs_trace.enable()

    cfg = ModelConfig(name="obs-demo", n_layers=1, d_model=32, n_heads=2,
                      n_kv_heads=2, d_ff=64, vocab_size=VOCAB_SIZE,
                      dtype="float32")
    task = AdditionTask(max_operand=9)
    trainer = RLTrainer(cfg, RLConfig(algorithm="grpo", n_rollouts=2,
                                      max_new_tokens=task.max_answer_len),
                        task, seed=0, device=dev)

    rng = torch.Generator(device=dev).manual_seed(42)
    rewards = []
    for i in range(4):
        prompts, answers = task.sample_batch(np.random.default_rng(i), 2)
        m = trainer.iteration(prompts, answers, rng)
        rewards.append(m["reward_mean"])
        print(f"iter {i} reward={m['reward_mean']:.3f}")

    print("\n-- span report " + "-" * 45)
    print(obs_trace.report())

    trace_path = obs_trace.export_chrome("results/trace_obs.json")
    print(f"\nchrome trace -> {trace_path} "
          f"(open in https://ui.perfetto.dev)")
    errors = obs_trace.validate_file(trace_path)
    print(f"schema check: {'OK' if not errors else errors}")

    print("\n-- metrics snapshot " + "-" * 40)
    snap = obs_metrics.snapshot()
    for name in sorted(snap):
        v = snap[name]
        if isinstance(v, dict):
            print(f"{name}: count={v['count']} mean={v['mean']:.4g} "
                  f"p95={v['p95']:.4g}")
        else:
            print(f"{name}: {v}")

    print("\n-- calibration " + "-" * 45)
    cal = obs_cal.fit_from_engine(trainer.engine, skip_iterations=1)
    raw = trainer.engine.compare_with_simulator()
    fixed = trainer.engine.compare_with_simulator(
        cost_model=cal.cost_model(trainer.engine.topo, trainer.wf))
    print(f"per-class scales: { {c: round(s, 1) for c, s in cal.class_scale.items()} }")
    print(f"measured/predicted iteration ratio: "
          f"{raw['ratio']:.3g} raw -> {fixed['ratio']:.3g} calibrated")
    return {"trainer": trainer, "rewards": rewards, "trace": trace_path,
            "trace_errors": errors, "snapshot": snap, "calibration": cal}


if __name__ == "__main__":
    main()
