"""Training launcher: LM train steps for an ``--arch``, or with ``--rl`` the
plan-driven RL path, on the card.

Port of ``repro.launch.train``.  Weights are random, drawn from seed 0.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --steps 20 --batch 4 --seq 64

runs LM steps (next-token loss on random tokens, functional Adam with a
cosine schedule over ``--steps``) at the full width of the architecture
in its own dtype; ``--smoke`` takes the reduced config, and ``--device
cpu --smoke`` runs on the CPU.  Feature-frontend architectures take
random features in front of their tokens (``configs.shapes.token_splits``:
hubert-xlarge's whole sequence is audio frames, pixtral-12b's first half
image patches, at most 1024).

With ``--rl {grpo,ppo}`` the launcher instead runs the plan-driven RL
path end-to-end: HetRL scheduler search on the chosen testbed scenario →
``Plan`` → engine execution of real RL iterations (GEN → INF → TRAIN →
weight sync) → measured vs cost-model iteration time, with the task's
16-token vocabulary in fp32 as the reference sets them:

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --rl grpo --steps 3 --batch 16

``--async`` runs one-step off-policy (the first iteration prints
``sync=0.0MB``: the pipeline fill), and ``--rl ppo`` adds the critic's
inference and training tasks.

``--drift <scenario>`` additionally runs the §6 elasticity loop: a named
topology drift (see ``core.topology.DRIFT_SCENARIOS``) fires mid-run, the
elastic controller reschedules with a warm-start budget at the iteration
boundary, checkpoints trainer state, and swaps the plan when the
``RedeployDecision`` says so — reporting measured-vs-predicted iteration
time per plan epoch.  ``--fault <scenario>`` injects a named fault (see
``faults.FAULT_SCENARIOS``) on the engine's iteration clock: undeclared
degradations are detected purely from measured-vs-predicted divergence
(a short calibration warmup arms the monitor), transient crashes are
absorbed by bounded retry, permanent failures escalate to a forced
replan on the survivors, checkpoint faults retry, degrade to
warn-and-continue or fall back to an older file.  ``--require-recover``
exits non-zero unless the scenario's recovery mechanism engaged;
``--calibrate`` fits the cost model to the measured timeline:

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --smoke --rl grpo --steps 8 --batch 4 --fault link_throttle \\
        --require-recover --device cpu

Checkpoints go to ``results/elastic_ckpt`` under the working directory,
as the reference's.  ``--fault slot_failure`` kills two genserve
decode slots mid-wave (GEN then runs on the engine path) and recovers
by requeueing their requests.  ``--spec-k K`` runs GEN through
draft-model speculative decoding on the genserve engine, with the
``--draft-arch`` entry as the draft (the default ``''``: a window-free
copy of the target at a quarter of its depth).  ``run_lm`` /
``run_rl(args, cfg=...)`` take a config in place of the one ``--arch``
/ ``--smoke`` name (``chip_smoke.py`` runs depth cuts that way).

``--rl`` runs sharded under ``torchrun``: one process per device, the
world from the environment (no flag), every task on the ranks its plan
placement folds onto, rank 0 printing (the plan, one ``placement ...:
mesh={...} ranks=[...]`` line per task, the iterations, the report):

    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 8 \\
        -m repro_torch.launch.train --arch qwen3-0.6b --smoke --rl grpo \\
        --async --steps 3 --batch 4 --device cpu

(``--device cuda`` on one card: the ranks share it over gloo.)
``--drift`` and ``--fault`` run on ranks as in a world of one: rank 0
decides each replan and writes each checkpoint (the state gathered from
its owners' ranks), a task's failure reaches every rank, and every rank
judges ``--require-recover`` on the world's counters, so every rank
exits alike; after each plan swap rank 0 prints the placements again.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional

import torch

from repro_torch.configs import archs
from repro_torch.configs.shapes import token_splits
from repro_torch.device import resolve_device, resolve_dtype
from repro_torch.models.config import ModelConfig
from repro_torch.obs import trace as obs_trace

CKPT_DIR = "results/elastic_ckpt"


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--rl", choices=["grpo", "ppo"], default=None,
                    help="run the plan-driven RL path instead of LM steps")
    ap.add_argument("--async", dest="asynchronous", action="store_true",
                    help="one-step off-policy RL execution (with --rl)")
    ap.add_argument("--scenario", default="single_region",
                    help="testbed scenario the scheduler plans against")
    ap.add_argument("--search-budget", type=int, default=120,
                    help="scheduler budget in cost-model evaluations")
    ap.add_argument("--drift", default=None,
                    help="inject a named topology drift mid-run and react "
                         "elastically (with --rl); see "
                         "core.topology.DRIFT_SCENARIOS")
    ap.add_argument("--drift-at", type=int, default=None,
                    help="iteration the drift fires at (default steps//2)")
    ap.add_argument("--fault", default=None,
                    help="inject a named fault scenario mid-run (with "
                         "--rl); see faults.FAULT_SCENARIOS; composes "
                         "with --drift")
    ap.add_argument("--fault-at", type=int, default=None,
                    help="iteration the fault fires at (default steps//2, "
                         "after the calibration warmup)")
    ap.add_argument("--require-recover", action="store_true",
                    help="exit non-zero unless the fault scenario's "
                         "recovery mechanism engaged")
    ap.add_argument("--calibrate", action="store_true",
                    help="fit cost-model calibration from the measured "
                         "timeline and report the corrected measured-vs-"
                         "predicted ratio (with --rl)")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="draft-model speculative decoding in GEN: "
                         "draft tokens per wave round (0 = off; "
                         "forces the genserve engine path)")
    ap.add_argument("--draft-arch", default="",
                    help="configs.archs entry for the speculative "
                         "draft ('' = scaled-down copy of --arch)")
    ap.add_argument("--trace", default=None, metavar="FILE",
                    help="write a Chrome-trace JSON of the run")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap.parse_args(argv)


# ---------------------------------------------------------------------------
# LM mode
# ---------------------------------------------------------------------------

def make_batch(cfg: ModelConfig, gen: torch.Generator, batch: int,
               seq: int) -> Dict[str, torch.Tensor]:
    """The ``token_splits`` of ``seq``: standard-normal features in the
    config's dtype, then random tokens, then labels over all ``seq``
    positions, drawn one after the other from ``gen`` on its device, and
    an all-ones loss mask in the config's dtype.  (The reference draws
    tokens and labels from one JAX key, so its labels begin with its
    tokens; here they are independent.)"""
    dev = gen.device
    dt = resolve_dtype(cfg.dtype)
    n_feat, n_tok = token_splits(cfg, seq)
    out = {}
    if n_feat:
        out["features"] = torch.randn((batch, n_feat, cfg.feature_dim),
                                      generator=gen, dtype=dt, device=dev)
    if n_tok:
        out["tokens"] = torch.randint(0, cfg.vocab_size, (batch, n_tok),
                                      generator=gen, device=dev)
    out["labels"] = torch.randint(0, cfg.vocab_size, (batch, seq),
                                  generator=gen, device=dev)
    out["loss_mask"] = torch.ones((batch, seq), dtype=dt, device=dev)
    return out


def run_lm(args: argparse.Namespace, cfg: Optional[ModelConfig] = None
           ) -> Dict[str, object]:
    """LM train steps; prints the reference's lines and returns the final
    params and optimizer state, each step's loss, grad norm and seconds
    (a step's time ends when its loss reaches the host)."""
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import transformer as T
    from repro_torch.optim import adam

    device = resolve_device(args.device)
    cfg = cfg or archs.get(args.arch, smoke=args.smoke)
    print(f"arch={cfg.name} params~{cfg.param_count():,} device={device} "
          f"dtype={cfg.dtype}")
    params = T.init_params(cfg, seed=0, device=device)
    opt_cfg = adam.AdamConfig(lr=args.lr, total_steps=args.steps)
    opt_state = adam.init_adam_state(params, opt_cfg)
    # the loop owns its state: the step overwrites it (one copy of the
    # moments; the first 8 layers of pixtral-12b need it on one card)
    train_step = steps_mod.make_train_step(cfg, opt_cfg, donate=True)
    gen = torch.Generator(device=device).manual_seed(0)
    losses, gnorms, secs = [], [], []
    for step in range(args.steps):
        batch = make_batch(cfg, gen, args.batch, args.seq)
        t0 = time.time()
        with obs_trace.span("train.step", step=step):
            params, opt_state, metrics = train_step(params, opt_state, batch)
            loss = float(metrics["loss"])
        dt = time.time() - t0
        gnorm = float(metrics["grad_norm"])
        losses.append(loss)
        gnorms.append(gnorm)
        secs.append(dt)
        print(f"step {step:4d} loss={loss:.4f} gnorm={gnorm:.3f} "
              f"({dt:.2f}s)")
    print("done")
    return {"params": params, "opt_state": opt_state, "losses": losses,
            "grad_norms": gnorms, "step_s": secs, "cfg": cfg}


# ---------------------------------------------------------------------------
# RL mode
# ---------------------------------------------------------------------------

def _world_counters() -> Dict[str, float]:
    """This process's counters, or on ranks each counter's largest value
    over the world: a counter is counted alike on every rank of the one
    group that counts it (the failing task's ranks, the GEN ranks, the
    checkpoint's writer) and not at all elsewhere."""
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.parallel import dist
    snap = {k: v for k, v in obs_metrics.snapshot().items()
            if isinstance(v, (int, float))}
    if not dist.multi():
        return snap
    out: Dict[str, float] = {}
    for part in dist.all_gather_object(snap):
        for k, v in part.items():
            out[k] = max(out.get(k, v), v)
    return out


def _load_latest_path(trainer) -> str:
    """The file ``load_latest`` restores from ``CKPT_DIR`` into the whole
    state: rank 0 reads on ranks, and its answer (or its error) is every
    rank's."""
    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.parallel import dist
    if not dist.multi():
        return ckpt_io.load_latest(CKPT_DIR, trainer.state_tree())[1]
    path, err = None, None
    if dist.rank() == 0:
        try:
            path = ckpt_io.load_latest(CKPT_DIR, trainer.state_like())[1]
        except ckpt_io.CheckpointError as e:
            err = str(e)
    path, err = dist.broadcast_object((path, err), 0)
    if err is not None:
        raise ckpt_io.CheckpointError(err)
    return path


def _assert_recovered(scenario: str, trainer, controller, injector) -> str:
    """--require-recover: fail loudly unless the scenario's recovery
    mechanism actually engaged.  Prints (on rank 0) and returns the
    recovery line; on ranks every rank judges the world's counters and
    records alike."""
    from repro_torch.parallel import dist
    snap = _world_counters()
    records = controller.records if controller is not None else []
    if scenario in ("link_throttle", "device_slowdown", "straggler"):
        assert any(r.reactive for r in records), (
            f"{scenario}: divergence monitor never fired a reactive "
            f"replan (records={len(records)})")
        line = (f"recovered: reactive replan at iteration "
                f"{next(r.iteration for r in records if r.reactive)}")
    elif scenario == "transient_crash":
        assert snap.get("engine.task_retries", 0) > 0, \
            "transient_crash: no retries recorded"
        assert not snap.get("engine.task_failures"), \
            "transient_crash: failure escaped the retry budget"
        line = (f"recovered: {int(snap['engine.task_retries'])} retries "
                f"absorbed the crash")
    elif scenario in ("permanent_crash", "device_drop"):
        assert any(r.forced for r in records), \
            f"{scenario}: no forced replan happened"
        rec = next(r for r in records if r.forced)
        line = (f"recovered: forced replan at iteration {rec.iteration} "
                f"-> epoch {rec.epoch}")
    elif scenario == "ckpt_fail":
        assert snap.get("checkpoint.retries", 0) > 0, \
            "ckpt_fail: no checkpoint retries recorded"
        line = (f"recovered: {int(snap['checkpoint.retries'])} checkpoint "
                f"retries")
    elif scenario == "ckpt_flaky":
        assert snap.get("checkpoint.failures", 0) > 0, \
            "ckpt_flaky: warn-and-continue never engaged"
        line = ("recovered: checkpoint degraded to warn-and-continue, "
                "training completed")
    elif scenario == "ckpt_corrupt":
        assert injector.fired("ckpt_corrupt"), \
            "ckpt_corrupt: corruption never fired"
        line = (f"recovered: load_latest fell back to "
                f"{_load_latest_path(trainer)}")
    elif scenario == "slot_failure":
        assert snap.get("gen.slot_failures", 0) > 0, \
            "slot_failure: no slots failed"
        line = (f"recovered: {int(snap['gen.slot_failures'])} slot "
                f"failures requeued")
    else:  # chaos
        assert injector is not None and injector.log, \
            f"{scenario}: no fault events fired"
        line = (f"recovered: completed under {len(injector.log)} "
                f"injected events")
    if dist.rank() == 0:
        print(line)
    return line


def run_rl(args: argparse.Namespace, cfg: Optional[ModelConfig] = None
           ) -> Dict[str, object]:
    """Scheduler search -> Plan -> engine-executed RL iterations, with the
    elastic controller and fault injector when ``--drift`` / ``--fault``
    ask for them.  Prints the reference launcher's lines and returns the
    trainer, the searched plan, each iteration's metrics, the
    measured-vs-predicted report, the elastic controller and the recovery
    line.  ``cfg`` replaces the config ``--arch`` / ``--smoke``
    name (its vocab and dtype are set as for that one)."""
    from repro_torch.core import topology, workflow
    from repro_torch.core.plan import check_constraints
    from repro_torch.core.sha import HybridScheduler
    from repro_torch.data.synthetic import (AdditionTask, PromptDataset,
                                            VOCAB_SIZE)
    from repro_torch.engine.executor import TaskExecutionError
    from repro_torch.rl.trainer import RLConfig, RLTrainer

    from repro_torch.parallel import dist
    device = dist.init_world(resolve_device(args.device))
    # SPMD: every rank runs this launcher; rank 0 alone speaks
    say = print if dist.rank() == 0 else (lambda *a, **k: None)
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
    r = sched.search(budget=args.search_budget) if dist.rank() == 0 \
        else None
    if dist.multi():
        # one plan for the whole world: rank 0's search
        r = dist.broadcast_object(r, 0)
    ok, msg = check_constraints(topo, wf, r.plan)
    assert ok, msg
    say(f"plan: grouping={r.grouping} sizes={r.sizes} "
          f"predicted {r.cost * 1e3:.3f}ms/iter ({r.evals} evals)")

    rl = RLConfig(algorithm=args.rl, n_rollouts=4,
                  max_new_tokens=task.max_answer_len, lr=args.lr,
                  asynchronous=args.asynchronous,
                  spec_k=args.spec_k, draft_arch=args.draft_arch)
    trainer = RLTrainer(cfg, rl, task, seed=0, plan=r.plan, topo=topo,
                        wf=wf, device=device)
    def placements():
        # on ranks: where each task runs (again after every plan swap)
        if dist.multi():
            for t, pl in sorted(trainer.engine.placements.items()):
                dp, tp = pl.mesh_shape
                say(f"placement {wf.task(t).name}: "
                    f"mesh={{'data': {dp}, 'model': {tp}}} "
                    f"ranks={list(pl.ranks)}")
    placements()

    # fault injection (undeclared degradations + crash scenarios)
    injector = None
    warmup = 0
    if args.fault:
        from repro_torch.core import retry
        from repro_torch.core.workflow import TaskKind
        from repro_torch.faults import FaultInjector, fault_scenario
        warmup = min(3, max(args.steps - 2, 1))
        fault_at = args.fault_at if args.fault_at is not None \
            else max(args.steps // 2, warmup + 1)
        gen_task = next(t for t in range(wf.n_tasks)
                        if wf.task(t).kind == TaskKind.GEN)
        train_task = next(t for t in range(wf.n_tasks)
                          if wf.task(t).kind == TaskKind.TRAIN
                          and wf.task(t).name.startswith("actor"))
        fplan = fault_scenario(args.fault, at=fault_at, topo=topo,
                               gen_task=gen_task, train_task=train_task,
                               n_tasks=wf.n_tasks)
        say(f"faults: {fplan.describe()}")
        injector = FaultInjector(fplan)
        trainer.engine.attach_fault_injector(injector)
        trainer.engine.set_task_retry(
            retry.RetryPolicy(max_attempts=3, base_delay_s=0.05))

    controller = None
    if args.drift or args.fault:
        from repro_torch.engine.elastic import (ElasticConfig,
                                                ElasticController)
        if args.drift:
            drift_at = args.drift_at if args.drift_at is not None \
                else max(args.steps // 2, 1)
            feed = topology.drift_scenario(args.drift, topo, at=drift_at)
        else:
            # constant feed: any reaction must come from the divergence
            # monitor or failure escalation, never from a declared drift
            feed = lambda it: topo  # noqa: E731
        controller = ElasticController(
            trainer, feed,
            ElasticConfig(budget=args.search_budget, ckpt_dir=CKPT_DIR))

    ds = iter(PromptDataset(task, batch=args.batch, seed=1))
    rng = torch.Generator(device=device).manual_seed(42)
    history = []
    for step in range(args.steps):
        prompts, answers = next(ds)
        t0 = time.time()
        try:
            m = trainer.iteration(prompts, answers, rng)
        except TaskExecutionError as e:
            if controller is None:
                raise
            say(f"iter {step:4d} TASK FAILURE: {e}")
            rec = controller.handle_failure(step, e)
            say(f"  escalated: dropped dead devices, forced replan -> "
                  f"epoch={rec.epoch} "
                  f"new={rec.decision.new_cost * 1e3:.3f}ms/iter")
            placements()
            m = trainer.iteration(prompts, answers, rng)
        history.append(m)
        say(f"iter {step:4d} reward={m['reward_mean']:.3f} "
              f"kl={m['kl']:.3f} sync={m['sync_gb'] * 1e3:.1f}MB "
              f"({time.time() - t0:.2f}s)")
        if args.fault and step + 1 == warmup:
            # calibration warmup done: arm the divergence monitor and
            # calibrated deadlines — undeclared faults are detectable
            # from here on
            from repro_torch.obs import calibrate as obs_cal
            cal = obs_cal.fit_from_engine(trainer.engine)
            monitor = obs_cal.DivergenceMonitor(threshold=2.0, sustain=2)
            trainer.engine.attach_divergence_monitor(monitor, cal)
            trainer.engine.set_task_deadlines(cal, slack=5.0)
            controller.monitor = monitor
            say(f"  calibrated ({cal.n_samples} samples); divergence "
                  f"monitor + deadlines armed")
        if args.fault and args.fault.startswith("ckpt"):
            controller.checkpoint_now(step)
        if controller is not None:
            rec = controller.poll(step)
            if rec is not None:
                d = rec.decision
                say(f"  drift{' (reactive)' if rec.reactive else ''}: "
                      f"reschedule in {rec.reschedule_s:.1f}s -> "
                      f"switch={d.switch} old={d.old_cost * 1e3:.3f}ms "
                      f"new={d.new_cost * 1e3:.3f}ms "
                      f"trans={d.transition_cost_s * 1e3:.3f}ms "
                      f"epoch={rec.epoch} "
                      f"ckpt={rec.ckpt_bytes / 1e6:.1f}MB")
                if rec.applied:
                    placements()
    if injector is not None:
        fired = [r for r in injector.log if r["what"] != "activate"]
        say(f"faults fired: {len(injector.log)} events "
              f"({len(fired)} raises/corruptions)")
    recovered = None
    if args.fault and args.require_recover:
        recovered = _assert_recovered(args.fault, trainer, controller,
                                      injector)
    if controller is not None:
        for row in trainer.engine.epoch_report():
            say(f"epoch {row['epoch']}: {row['iterations']} iters, "
                  f"measured {row['measured_iter_s'] * 1e3:.1f}ms/iter vs "
                  f"predicted {row['predicted_iter_s'] * 1e3:.3f}ms/iter")
    cmp = trainer.engine.compare_with_simulator()
    say(f"measured {cmp['measured_iter_s'] * 1e3:.1f}ms/iter vs "
          f"cost-model {cmp['predicted_iter_s'] * 1e3:.3f}ms/iter "
          f"(ratio {cmp['ratio']:.2f})")
    if args.calibrate:
        from repro_torch.obs import calibrate as obs_cal
        c = obs_cal.fit_from_engine(trainer.engine)
        ccmp = trainer.engine.compare_with_simulator(
            cost_model=c.cost_model(trainer.engine.topo, trainer.wf))
        say(f"calibrated ({c.n_samples} samples, global scale "
              f"{c.global_scale:.3g}): ratio {ccmp['ratio']:.2f}")
    say("done")
    return {"trainer": trainer, "search": r, "metrics": history,
            "compare": cmp, "cfg": cfg, "controller": controller,
            "recovered": recovered}


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    args = parse_args(argv)
    if args.trace:
        obs_trace.enable()
    out = run_rl(args) if args.rl else run_lm(args)
    if args.trace:
        obs_trace.export_chrome(args.trace)
        print(f"trace -> {args.trace}")
    return out


if __name__ == "__main__":
    main()
