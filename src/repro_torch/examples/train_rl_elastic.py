"""Elastic RL training example (§6 online redeployment, end to end):

    scheduler search -> Plan -> engine-executed GRPO training
      -> injected topology drift (device loss / link degradation)
      -> warm-started reschedule at the iteration boundary
      -> checkpoint -> plan swap (Engine.apply_plan) -> continued training

Port of ``examples/train_rl_elastic.py``:

    PYTHONPATH=src python -m repro_torch.examples.train_rl_elastic \\
        --iters 16 --drift drop_tail --drift-at 6

Trainer/optimizer state crosses the swap untouched (weight_version stays
monotone, the loss curve does not reset), and the run ends with a
measured-vs-predicted iteration-time row per plan epoch — the estimate
never straddles the swap.  ``--require-switch`` makes the run exit
non-zero unless the drift actually produced an applied swap (CI smoke).
Checkpoints land in ``--ckpt-dir`` (``results/elastic_ckpt`` under the
working directory).  Runs on ``--device cuda`` (the default; raises
without a card) or ``--device cpu``.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import torch

from repro_torch.core import topology, workflow
from repro_torch.core.plan import check_constraints
from repro_torch.core.sha import HybridScheduler
from repro_torch.data.synthetic import AdditionTask, PromptDataset, VOCAB_SIZE
from repro_torch.device import resolve_device
from repro_torch.engine.elastic import ElasticConfig, ElasticController
from repro_torch.models.config import ModelConfig
from repro_torch.rl.trainer import RLConfig, RLTrainer


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=16)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--rollouts", type=int, default=4)
    ap.add_argument("--d-model", type=int, default=96)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--async", dest="asynchronous", action="store_true")
    ap.add_argument("--drift", default="drop_tail",
                    choices=topology.DRIFT_SCENARIOS)
    ap.add_argument("--drift-at", type=int, default=None,
                    help="iteration the drift fires at (default iters//3)")
    ap.add_argument("--search-budget", type=int, default=120)
    ap.add_argument("--reschedule-budget", type=int, default=150,
                    help="warm-started budget for the elastic reschedule")
    ap.add_argument("--ckpt-dir", default="results/elastic_ckpt")
    ap.add_argument("--require-switch", action="store_true",
                    help="exit non-zero unless a plan swap was applied")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = ModelConfig(
        name="rl-elastic", n_layers=args.layers, d_model=args.d_model,
        n_heads=max(args.d_model // 48, 2), n_kv_heads=2, head_dim=48,
        d_ff=args.d_model * 3, vocab_size=VOCAB_SIZE, dtype="float32")
    task = AdditionTask(max_operand=9)

    # --- scheduling phase on the healthy reference pool ---
    topo = topology.build_testbed("single_region",
                                  counts={"A100": 4, "L4": 4})
    spec = workflow.LLMSpec.from_model_config(cfg)
    wf = workflow.make_workflow("grpo", spec,
                                synchronous=not args.asynchronous,
                                global_batch=args.batch,
                                n_rollouts=args.rollouts,
                                seq_in=task.prompt_len,
                                seq_out=task.max_answer_len)
    sched = HybridScheduler(topo, wf, max_groupings=8,
                            max_sizes_per_grouping=4)
    r = sched.search(budget=args.search_budget)
    ok, msg = check_constraints(topo, wf, r.plan)
    if not ok:
        raise RuntimeError(f"the searched plan breaks a constraint: {msg}")
    print(f"scheduler: grouping={r.grouping} predicted "
          f"{r.cost * 1e3:.3f}ms/iter on the healthy pool")

    # --- trainer + elasticity loop ---
    rl = RLConfig(algorithm="grpo", n_rollouts=args.rollouts,
                  max_new_tokens=task.max_answer_len, lr=args.lr,
                  kl_beta=0.002, asynchronous=args.asynchronous)
    trainer = RLTrainer(cfg, rl, task, seed=0, plan=r.plan, topo=topo,
                        wf=wf, device=dev)
    drift_at = args.drift_at if args.drift_at is not None \
        else max(args.iters // 3, 1)
    schedule = topology.drift_scenario(args.drift, topo, at=drift_at)
    controller = ElasticController(
        trainer, schedule,
        ElasticConfig(budget=args.reschedule_budget,
                      ckpt_dir=args.ckpt_dir))

    ds = iter(PromptDataset(task, batch=args.batch, seed=1))
    rng = torch.Generator(device=dev).manual_seed(42)
    t0 = time.time()
    history, wv_trace = [], []
    for it in range(args.iters):
        prompts, answers = next(ds)
        m = trainer.iteration(prompts, answers, rng)
        history.append(m)
        wv_trace.append(trainer.weight_version)
        print(f"iter {it:3d} epoch={trainer.engine.epoch} "
              f"reward={m['reward_mean']:.3f} loss={m.get('loss', 0):.4f} "
              f"wv={trainer.weight_version} ({time.time() - t0:.0f}s)")
        rec = controller.poll(it)
        if rec is not None:
            d = rec.decision
            print(f"  drift detected -> reschedule ({rec.reschedule_s:.1f}s "
                  f"wall): switch={d.switch} "
                  f"incumbent={d.old_cost * 1e3:.3f}ms/iter "
                  f"challenger={d.new_cost * 1e3:.3f}ms/iter "
                  f"transition={d.transition_cost_s * 1e3:.3f}ms "
                  f"(amortized over {d.amortization_iters} iters); "
                  f"checkpoint {rec.ckpt_bytes / 1e6:.1f}MB -> "
                  f"{rec.ckpt_path}")
            if rec.applied:
                print(f"  plan swapped at the iteration boundary: now "
                      f"epoch {rec.epoch}, trainer state carried "
                      f"(wv={trainer.weight_version})")

    # --- invariants the §6 story promises ---
    if any(b < a for a, b in zip(wv_trace, wv_trace[1:])):
        raise RuntimeError(f"weight_version must stay monotone across the "
                           f"swap: {wv_trace}")

    print("\nper plan-epoch measured vs predicted (never straddles a swap):")
    report = trainer.engine.epoch_report()
    for row in report:
        print(f"  epoch {row['epoch']}: {row['iterations']:3d} iters  "
              f"measured {row['measured_iter_s'] * 1e3:8.1f}ms/iter  "
              f"predicted {row['predicted_iter_s'] * 1e3:8.3f}ms/iter")

    swaps = controller.swaps
    print(f"\n{len(controller.records)} drift reaction(s), "
          f"{len(swaps)} applied swap(s)")
    if args.require_switch and not swaps:
        print("FAIL: --require-switch set but no plan swap was applied")
        raise SystemExit(1)
    print("done")
    return {"controller": controller, "metrics": history,
            "wv_trace": wv_trace, "epoch_report": report}


if __name__ == "__main__":
    main()
