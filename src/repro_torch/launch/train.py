"""Training launcher, RL mode: the plan-driven RL path on the card.

Port of the ``--rl`` mode of ``repro.launch.train``: HetRL scheduler
search on the chosen testbed scenario → ``Plan`` → engine execution of
real RL iterations (GEN → INF → TRAIN → weight sync) → measured vs
cost-model iteration time.  Weights are random, drawn from seed 0.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --rl grpo --steps 3 --batch 16

runs at the full width of the architecture (with the task's 16-token
vocabulary and fp32, as the reference launcher sets them); ``--smoke``
takes the reduced config, and ``--device cpu --smoke`` runs the plain
PyTorch path on the CPU.  ``--async`` runs one-step off-policy (the
first iteration prints ``sync=0.0MB``: the pipeline fill), and ``--rl
ppo`` adds the critic's inference and training tasks.

The LM mode (no ``--rl``) is not yet ported and raises
``NotImplementedError``; the reference's ``--drift``, ``--fault``,
``--calibrate`` and ``--spec-k`` flags are not yet ported either
(ROADMAP.md §1), and argparse rejects them.  ``run_rl(args, cfg=...)``
takes a config in place of the one ``--arch`` / ``--smoke`` name
(``chip_smoke.py`` runs the e2e actor that way).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional

import torch

from repro_torch.configs import archs
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.obs import trace as obs_trace


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--rl", choices=["grpo", "ppo"], default=None,
                    help="run the plan-driven RL path")
    ap.add_argument("--async", dest="asynchronous", action="store_true",
                    help="one-step off-policy RL execution (with --rl)")
    ap.add_argument("--scenario", default="single_region",
                    help="testbed scenario the scheduler plans against")
    ap.add_argument("--search-budget", type=int, default=120,
                    help="scheduler budget in cost-model evaluations")
    ap.add_argument("--trace", default=None, metavar="FILE",
                    help="write a Chrome-trace JSON of the run")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    if args.rl is None:
        raise NotImplementedError(
            "the LM mode (no --rl): not yet ported (ROADMAP.md §1, item 5 "
            "(checkpoints and the LM train mode))")
    return args


def run_rl(args: argparse.Namespace, cfg: Optional[ModelConfig] = None
           ) -> Dict[str, object]:
    """Scheduler search -> Plan -> engine-executed RL iterations.  Prints
    the reference launcher's lines and returns the trainer, the searched
    plan, each iteration's metrics and the measured-vs-predicted report.
    ``cfg`` replaces the config ``--arch`` / ``--smoke`` name (its vocab
    and dtype are set as for that one)."""
    from repro_torch.core import topology, workflow
    from repro_torch.core.plan import check_constraints
    from repro_torch.core.sha import HybridScheduler
    from repro_torch.data.synthetic import (AdditionTask, PromptDataset,
                                            VOCAB_SIZE)
    from repro_torch.rl.trainer import RLConfig, RLTrainer

    device = resolve_device(args.device)
    cfg = cfg or archs.get(args.arch, smoke=args.smoke)
    # RL on the verifiable addition task needs its small vocab; fp32 keeps
    # the tiny-model smoke run numerically stable
    cfg = dataclasses.replace(cfg, vocab_size=VOCAB_SIZE, dtype="float32")
    task = AdditionTask(max_operand=9)
    topo = topology.build_testbed(args.scenario,
                                  counts={"A100": 4, "L4": 4})
    spec = workflow.LLMSpec.from_model_config(cfg)
    wf = workflow.make_workflow(args.rl, spec,
                                synchronous=not args.asynchronous,
                                global_batch=args.batch, n_rollouts=4,
                                seq_in=task.prompt_len,
                                seq_out=task.max_answer_len)
    sched = HybridScheduler(topo, wf, max_groupings=8,
                            max_sizes_per_grouping=4)
    r = sched.search(budget=args.search_budget)
    ok, msg = check_constraints(topo, wf, r.plan)
    assert ok, msg
    print(f"plan: grouping={r.grouping} sizes={r.sizes} "
          f"predicted {r.cost * 1e3:.3f}ms/iter ({r.evals} evals)")

    rl = RLConfig(algorithm=args.rl, n_rollouts=4,
                  max_new_tokens=task.max_answer_len, lr=args.lr,
                  asynchronous=args.asynchronous)
    trainer = RLTrainer(cfg, rl, task, seed=0, plan=r.plan, topo=topo,
                        wf=wf, device=device)

    ds = iter(PromptDataset(task, batch=args.batch, seed=1))
    rng = torch.Generator(device=device).manual_seed(42)
    history = []
    for step in range(args.steps):
        prompts, answers = next(ds)
        t0 = time.time()
        m = trainer.iteration(prompts, answers, rng)
        history.append(m)
        print(f"iter {step:4d} reward={m['reward_mean']:.3f} "
              f"kl={m['kl']:.3f} sync={m['sync_gb'] * 1e3:.1f}MB "
              f"({time.time() - t0:.2f}s)")
    cmp = trainer.engine.compare_with_simulator()
    print(f"measured {cmp['measured_iter_s'] * 1e3:.1f}ms/iter vs "
          f"cost-model {cmp['predicted_iter_s'] * 1e3:.3f}ms/iter "
          f"(ratio {cmp['ratio']:.2f})")
    print("done")
    return {"trainer": trainer, "search": r, "metrics": history,
            "compare": cmp, "cfg": cfg}


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    args = parse_args(argv)
    if args.trace:
        obs_trace.enable()
    out = run_rl(args)
    if args.trace:
        obs_trace.export_chrome(args.trace)
        print(f"trace -> {args.trace}")
    return out


if __name__ == "__main__":
    main()
