"""End-to-end RL training example: GRPO (or PPO) on the verifiable
integer-addition task, with the HetRL scheduler choosing the execution
plan for the device pool and the plan-driven engine executing it:

    scheduler search -> Plan -> engine execution -> measured vs predicted

Port of ``examples/train_rl_e2e.py``:

    PYTHONPATH=src python -m repro_torch.examples.train_rl_e2e \\
        --iters 200 --batch 16 --d-model 192 --layers 4

Reward (digit-level correctness) and greedy exact-match accuracy climb
within a few dozen iterations; checkpoints land in ``results/rl_ckpt``
under the working directory, in the JAX package's file format.  At the
end the measured iteration time from the engine's event timeline is
compared against the cost model's prediction (Fig-7 style), and the
genserve wave occupancy against the cost model's.  At the default
batch (16 prompts x 8 rollouts = 128 rows) GEN runs on the genserve
wave decoder.  Runs on ``--device cuda`` (the default; raises without a
card) or ``--device cpu``.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import io as ckpt
from repro_torch.core import topology, workflow
from repro_torch.core.plan import check_constraints
from repro_torch.core.sha import HybridScheduler
from repro_torch.data.synthetic import AdditionTask, PromptDataset, VOCAB_SIZE
from repro_torch.device import resolve_device, synchronize
from repro_torch.models.config import ModelConfig
from repro_torch.rl.trainer import RLConfig, RLTrainer


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--algorithm", default="grpo", choices=["grpo", "ppo"])
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--rollouts", type=int, default=8)
    ap.add_argument("--d-model", type=int, default=192)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--max-operand", type=int, default=9)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--async", dest="asynchronous", action="store_true",
                    help="one-step off-policy double-buffered execution")
    ap.add_argument("--search-budget", type=int, default=120,
                    help="scheduler budget in cost-model evaluations")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = ModelConfig(
        name="rl-actor", n_layers=args.layers, d_model=args.d_model,
        n_heads=max(args.d_model // 48, 2), n_kv_heads=2, head_dim=48,
        d_ff=args.d_model * 3, vocab_size=VOCAB_SIZE, dtype="float32")
    print(f"actor: {cfg.param_count():,} params")

    # --- scheduling phase: search the plan space for the reference pool ---
    task = AdditionTask(max_operand=args.max_operand)
    topo = topology.build_testbed("single_region",
                                  counts={"A100": 4, "L4": 4})
    spec = workflow.LLMSpec.from_model_config(cfg)
    wf = workflow.make_workflow(args.algorithm, spec,
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
    print(f"scheduler: SHA-EA searched {r.evals} evals; best plan "
          f"grouping={r.grouping} estimated at {r.cost * 1e3:.3f}ms/iter "
          f"on the 8-GPU reference pool (executing locally on {dev})")

    # --- RL training, executed by the plan-driven engine ---
    rl = RLConfig(algorithm=args.algorithm, n_rollouts=args.rollouts,
                  max_new_tokens=task.max_answer_len, lr=args.lr,
                  kl_beta=0.002, asynchronous=args.asynchronous)
    trainer = RLTrainer(cfg, rl, task, seed=0, plan=r.plan, topo=topo,
                        wf=wf, device=dev)
    ds = iter(PromptDataset(task, batch=args.batch, seed=1))
    eval_rng = np.random.default_rng(7)
    eval_prompts, eval_answers = task.sample_batch(eval_rng, 64)

    def accuracy():
        return trainer.evaluate(eval_prompts, eval_answers,
                                torch.Generator(device=dev).manual_seed(1))

    rng = torch.Generator(device=dev).manual_seed(42)
    history = []
    t0 = time.time()
    for it in range(args.iters):
        prompts, answers = next(ds)
        m = trainer.iteration(prompts, answers, rng)
        history.append(m)
        if it % 10 == 0 or it == args.iters - 1:
            acc = accuracy()
            synchronize(dev)
            print(f"iter {it:4d} reward={m['reward_mean']:.3f} "
                  f"kl={m['kl']:.3f} acc={acc:.2f} "
                  f"sync={m['sync_gb'] * 1e3:.1f}MB "
                  f"({time.time() - t0:.0f}s)")
        if args.ckpt_every and it and it % args.ckpt_every == 0:
            n = ckpt.save("results/rl_ckpt/actor.msgpack", trainer.actor)
            print(f"  checkpointed actor ({n / 1e6:.1f} MB)")
    acc = accuracy()
    print(f"final greedy exact-match accuracy: {acc:.2f}")

    # --- measured vs cost-model iteration time (Fig-7 style) ---
    cmp = trainer.engine.compare_with_simulator()
    print(f"engine: measured {cmp['measured_iter_s'] * 1e3:.1f}ms/iter "
          f"on this host vs cost-model prediction "
          f"{cmp['predicted_iter_s'] * 1e3:.3f}ms/iter for the reference "
          f"pool (ratio {cmp['ratio']:.2f}; the plan's colocation and "
          f"sync path drive both timelines)")

    # --- decode-wave occupancy: genserve measured vs cost model ---
    occ = trainer.engine.wave_occupancy_summary()
    n_waves = len(trainer.engine.wave_timeline) // 2
    print(f"genserve: {n_waves} wave rounds recorded; measured mean "
          f"slot occupancy {occ['measured_occupancy']:.2f} vs cost-model "
          f"decode-wave prediction {occ.get('predicted_occupancy', 0):.2f} "
          f"(ratio {occ.get('ratio', float('nan')):.2f})")
    return {"trainer": trainer, "metrics": history, "accuracy": acc,
            "compare": cmp, "occupancy": occ}


if __name__ == "__main__":
    main()
