"""Fault injection and self-healing on the port, held against the JAX
package (``repro.faults``, ``core.retry`` and the hardened engine).

- ``core.retry``: bounded backoff, permanent short-circuit, exhaustion;
- ``FaultPlan.generate(seed)`` and every named scenario give the
  reference's ``describe()``;
- the same seeded fault plan on two fresh port engines gives the same
  injected-event log and timeline shape, and a transient crash costs
  retries and no iteration;
- a permanent crash escalates to a forced replan on the survivors and
  heals at the new epoch; checkpoint write faults retry, degrade to
  warn-and-continue or are skipped by ``load_latest``, and a fresh
  trainer restores the surviving checkpoint bitwise;
- an undeclared link throttle is detected by the divergence monitor
  alone; faults raised inside concurrent lanes reach ``retry_call`` and
  ``TaskExecutionError`` and none is lost; injected slot failures are
  refused (genserve's slot failure is not yet ported);
- ``--require-recover`` on the engine-side scenarios reaches the same kind
  of recovery on both launchers (checkpoint, chaos and drift:
  ``tests/test_torch_elastic.py``).

Backoff sleeps go through an injected no-op, and no assertion bounds a
time.  The reactive-replan tests read measured task times, as the
reference's do: the throttle dilates the throttled task's replayed
duration about tenfold, far past the monitor's threshold of 2.
"""
import os
import re

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro import faults as jfaults  # noqa: E402
from repro.core import topology as jtopo  # noqa: E402
from repro.launch import train as jlaunch  # noqa: E402
from repro.obs import metrics as jmetrics  # noqa: E402
from repro_torch.checkpoint import io as ckpt_io  # noqa: E402
from repro_torch.core import enumerate as enum_mod, retry  # noqa: E402
from repro_torch.core import topology, workflow  # noqa: E402
from repro_torch.core.plan import check_constraints  # noqa: E402
from repro_torch.core.workflow import TaskKind  # noqa: E402
from repro_torch.data.synthetic import AdditionTask, VOCAB_SIZE  # noqa: E402
from repro_torch.engine.elastic import ElasticConfig, ElasticController  # noqa: E402
from repro_torch.engine.executor import TaskExecutionError  # noqa: E402
from repro_torch.faults import (FAULT_SCENARIOS, FaultEvent,  # noqa: E402
                                FaultInjector, FaultPlan, fault_scenario)
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.obs import calibrate as obs_cal  # noqa: E402
from repro_torch.obs import metrics as obs_metrics  # noqa: E402
from repro_torch.rl.trainer import RLConfig, RLTrainer  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on the host's
    cores, and torch's default of one thread per core oversubscribes
    them (two launcher tests took 66 s instead of 24 s under a full
    load)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nosleep(_s):
    pass


def tiny_cfg():
    return ModelConfig(name="ft-tiny", n_layers=2, d_model=64, n_heads=2,
                       n_kv_heads=2, head_dim=32, d_ff=128,
                       vocab_size=VOCAB_SIZE, dtype="float32")


def reference_pool():
    return topology.build_testbed("single_region",
                                  counts={"A100": 4, "L4": 4})


def make_trainer(alg="grpo", grouping=None):
    task = AdditionTask(max_operand=9)
    topo = reference_pool()
    wf = workflow.make_workflow(alg, workflow.LLMSpec.from_model_config(
        tiny_cfg()), synchronous=True, n_rollouts=4, seq_in=task.prompt_len,
        seq_out=4, global_batch=1)
    g = grouping or tuple(sorted(((0,), tuple(range(1, wf.n_tasks)))))
    sizes = enum_mod.proportional_sizes(wf, g, topo.n)
    plan = enum_mod.build_plan(topo, wf, g, sizes, list(range(topo.n)))
    ok, msg = check_constraints(topo, wf, plan)
    assert ok, msg
    rl = RLConfig(algorithm=alg, n_rollouts=4, max_new_tokens=4)
    trainer = RLTrainer(tiny_cfg(), rl, task, seed=0, plan=plan, topo=topo,
                        wf=wf, device="cpu")
    return trainer, topo, wf


def run_iters(trainer, n, batch=4, seed=0):
    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(7 + seed)
    return [trainer.iteration(*trainer.task.sample_batch(rng, batch), gen)
            for _ in range(n)]


def task_id(wf, name):
    return next(t for t in range(wf.n_tasks) if wf.task(t).name == name)


def train_task_id(wf):
    return next(t for t in range(wf.n_tasks)
                if wf.task(t).kind == TaskKind.TRAIN)


def attach(trainer, fault_plan):
    inj = FaultInjector(fault_plan)
    trainer.engine.attach_fault_injector(inj)
    trainer.engine.set_task_retry(
        retry.RetryPolicy(max_attempts=3, base_delay_s=0.0), sleep=_nosleep)
    return inj


def leaves(trainer):
    return [t.detach().clone() for t in tree_leaves(trainer.state_tree())]


def assert_equal_leaves(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


# ---------------------------------------------------------------------------
# core/retry and the fault plans
# ---------------------------------------------------------------------------

def test_retry_backoff_and_exhaustion():
    pol = retry.RetryPolicy(max_attempts=3, base_delay_s=0.1, factor=2.0,
                            max_delay_s=0.15)
    assert pol.delay(0) == pytest.approx(0.1)
    assert pol.delay(1) == pytest.approx(0.15)
    calls, slept = [], []

    def flaky(attempt):
        calls.append(attempt)
        if attempt < 2:
            raise retry.TransientError("boom")
        return "ok"

    assert retry.retry_call(flaky, policy=pol, sleep=slept.append) == "ok"
    assert calls == [0, 1, 2]
    assert slept == [pytest.approx(0.1), pytest.approx(0.15)]
    with pytest.raises(retry.RetryExhausted) as ei:
        retry.retry_call(lambda a: (_ for _ in ()).throw(
            retry.TransientError("x")), policy=pol, sleep=_nosleep)
    assert ei.value.attempts == 3
    perm = []

    def dead(attempt):
        perm.append(attempt)
        raise retry.PermanentError("dead")

    with pytest.raises(retry.PermanentError):
        retry.retry_call(dead, policy=pol, sleep=_nosleep)
    assert perm == [0]
    with pytest.raises(ValueError):
        retry.retry_call(flaky, policy=retry.RetryPolicy(max_attempts=0))


@pytest.mark.parametrize("seed", [0, 1, 5, 6, 11])
def test_fault_plan_generate_matches_reference(seed):
    for kw in ({}, {"n_events": 5, "first_iteration": 1, "every": 2,
                    "n_tasks": 6, "window": 3}):
        t = FaultPlan.generate(seed, **kw)
        j = jfaults.FaultPlan.generate(seed, **kw)
        assert t.describe() == j.describe() and t.seed == j.seed
        assert t.describe() == FaultPlan.generate(seed, **kw).describe()


@pytest.mark.parametrize("name", FAULT_SCENARIOS)
def test_fault_scenarios_match_reference(name):
    assert FAULT_SCENARIOS == jfaults.FAULT_SCENARIOS
    kw = dict(at=3, gen_task=0, train_task=2, n_tasks=4)
    t = fault_scenario(name, topo=reference_pool(), **kw)
    j = jfaults.fault_scenario(
        name, topo=jtopo.build_testbed("single_region",
                                       counts={"A100": 4, "L4": 4}), **kw)
    assert t.events and t.describe() == j.describe()


def test_fault_event_validation():
    with pytest.raises(ValueError):
        FaultEvent("meteor_strike", 0)
    e = FaultEvent("straggler", 2, until=4, task=0)
    assert [e.active(i) for i in range(5)] == [False, False, True, True,
                                               False]
    with pytest.raises(ValueError):
        fault_scenario("nope")


# ---------------------------------------------------------------------------
# the port's engine under faults
# ---------------------------------------------------------------------------

def test_fault_determinism_and_transient_retry():
    def run_once():
        trainer, topo, wf = make_trainer()
        tt = train_task_id(wf)
        inj = attach(trainer, FaultPlan([
            FaultEvent("straggler", 1, until=3, task=0, factor=2.5),
            FaultEvent("transient_crash", 2, until=3, task=tt,
                       n_failures=2)], seed=0))
        outs = run_iters(trainer, 4)
        shape = [(e.iteration, e.task, e.kind)
                 for e in trainer.engine.timeline]
        return inj.log, shape, outs

    before = obs_metrics.counter("engine.task_retries").value
    log1, shape1, outs1 = run_once()
    log2, shape2, outs2 = run_once()
    assert log1 == log2 and shape1 == shape2
    assert len(outs1) == 4 and all("reward_mean" in r for r in outs1)
    raises = [r for r in log1 if r["what"] == "raise_transient"]
    assert [r["attempt"] for r in raises] == [0, 1]
    assert obs_metrics.counter("engine.task_retries").value - before == 4


def test_permanent_crash_escalates_to_forced_replan(tmp_path):
    trainer, topo, wf = make_trainer()
    tt = train_task_id(wf)
    inj = attach(trainer, fault_scenario("permanent_crash", at=1,
                                         train_task=tt))
    ctrl = ElasticController(
        trainer, lambda it: topo,
        ElasticConfig(budget=80, amortization_iters=5,
                      ckpt_dir=str(tmp_path)))
    rng = np.random.default_rng(0)
    gen = torch.Generator().manual_seed(7)
    done, step, forced, dead = 0, 0, None, set()
    while done < 3:
        prompts, answers = trainer.task.sample_batch(rng, 4)
        try:
            trainer.iteration(prompts, answers, gen)
        except TaskExecutionError as e:
            assert e.permanent and e.task == tt and e.dead_devices
            dead = set(e.dead_devices)
            forced = ctrl.handle_failure(step, e)
            continue
        done += 1
        step += 1
    assert forced is not None and forced.forced and forced.applied
    assert trainer.engine.epoch == 1
    for t in range(wf.n_tasks):
        assigned = {int(d) for d in trainer.plan.assignment[t].reshape(-1)}
        assert not (assigned & dead)
    assert ckpt_io._checkpoint_files(str(tmp_path))
    assert [r["what"] for r in inj.fired("permanent_crash")] == \
        ["activate", "raise_permanent"]


def test_checkpoint_fault_chain_and_bitwise_resume(tmp_path):
    trainer, topo, wf = make_trainer()
    ctrl = ElasticController(
        trainer, lambda it: topo,
        ElasticConfig(ckpt_dir=str(tmp_path), ckpt_retain=0,
                      ckpt_retry=retry.RetryPolicy(max_attempts=3,
                                                   base_delay_s=0.0)))
    run_iters(trainer, 2)
    path1, nbytes = ctrl.checkpoint_now(1)
    assert path1 and nbytes == os.path.getsize(path1)
    want_a = leaves(trainer)
    run_iters(trainer, 1, seed=1)
    want_b = leaves(trainer)

    inj = FaultInjector(FaultPlan([FaultEvent("ckpt_fail", 0,
                                              n_failures=2)]))
    trainer.engine.attach_fault_injector(inj)
    inj.begin_iteration(3)
    r0 = obs_metrics.counter("checkpoint.retries").value
    path3, _ = ctrl.checkpoint_now(3)
    assert path3 and os.path.exists(path3)
    assert obs_metrics.counter("checkpoint.retries").value - r0 == 2

    inj = FaultInjector(FaultPlan([FaultEvent("ckpt_fail", 0,
                                              n_failures=-1)]))
    trainer.engine.attach_fault_injector(inj)
    inj.begin_iteration(4)
    f0 = obs_metrics.counter("checkpoint.failures").value
    with pytest.warns(RuntimeWarning, match="checkpoint write failed"):
        path4, nbytes4 = ctrl.checkpoint_now(4)
    assert path4 is None and nbytes4 == 0
    assert obs_metrics.counter("checkpoint.failures").value - f0 == 1
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]

    inj = FaultInjector(FaultPlan([FaultEvent("ckpt_corrupt", 0)]))
    trainer.engine.attach_fault_injector(inj)
    inj.begin_iteration(5)
    path5, _ = ctrl.checkpoint_now(5)
    assert path5 and inj.fired("ckpt_corrupt")

    fresh, _, _ = make_trainer()
    with pytest.warns(RuntimeWarning, match="skipping checkpoint"):
        tree, path = ckpt_io.load_latest(str(tmp_path), fresh.state_tree())
    assert path == path3
    fresh.load_state_tree(tree)
    assert_equal_leaves(leaves(fresh), want_b)
    assert_equal_leaves(tree_leaves(ckpt_io.restore(path1,
                                                    fresh.state_tree())),
                        want_a)


def test_link_throttle_reactive_replan():
    trainer, topo, wf = make_trainer()
    inj = attach(trainer, fault_scenario("link_throttle", at=3))
    ctrl = ElasticController(trainer, lambda it: topo,
                             ElasticConfig(budget=80, amortization_iters=5))
    run_iters(trainer, 3)
    cal = obs_cal.fit_from_engine(trainer.engine)
    monitor = obs_cal.DivergenceMonitor(threshold=2.0, sustain=2)
    trainer.engine.attach_divergence_monitor(monitor, cal)
    ctrl.monitor = monitor
    reactive = None
    for step in range(3, 10):
        run_iters(trainer, 1, seed=step)
        rec = ctrl.poll(step)
        if rec is not None:
            reactive = rec
            break
    assert reactive is not None, "divergence monitor never fired"
    assert reactive.reactive and not reactive.forced
    assert reactive.applied and trainer.engine.epoch == 1
    assert inj.fired("link_throttle")
    assert topology.topo_equal(ctrl._observed, topo)


def _lanes_trainer():
    """PPO with every task in a group of its own: the inference stage runs
    three lanes (reward, reference, critic) in threads."""
    trainer, topo, wf = make_trainer(
        "ppo", grouping=tuple((t,) for t in range(6)))
    stage = next(s for s in wf.stages()
                 if any(wf.task(t).name == "reference_inference" for t in s))
    assert len(trainer.engine._lanes(stage)) == 3
    return trainer, wf


def test_fault_in_a_lane_thread_reaches_retry():
    trainer, wf = _lanes_trainer()
    ref = task_id(wf, "reference_inference")
    before = obs_metrics.counter("engine.task_retries").value
    inj = attach(trainer, FaultPlan([FaultEvent(
        "transient_crash", 0, until=1, task=ref, n_failures=2)]))
    m = run_iters(trainer, 1)[0]
    assert "critic_loss" in m
    assert [r["attempt"] for r in inj.log if r["what"] ==
            "raise_transient"] == [0, 1]
    assert obs_metrics.counter("engine.task_retries").value - before == 2


def test_faults_in_two_lanes_raise_the_first_and_note_the_other():
    trainer, wf = _lanes_trainer()
    ref = task_id(wf, "reference_inference")
    critic = task_id(wf, "critic_inference")
    attach(trainer, FaultPlan([
        FaultEvent("transient_crash", 0, task=ref, n_failures=5),
        FaultEvent("permanent_crash", 0, task=critic, devices=(5,))]))
    with pytest.raises(TaskExecutionError) as ei:
        run_iters(trainer, 1)
    first, second = sorted((ref, critic))
    assert ei.value.task == first
    notes = getattr(ei.value, "__notes__", [])
    assert len(notes) == 1 and f"task {second} " in notes[0]
    # a lane's permanent failure alone: escalated with its dead device
    trainer, wf = _lanes_trainer()
    attach(trainer, FaultPlan([FaultEvent("permanent_crash", 0,
                                          task=critic, devices=(5,))]))
    with pytest.raises(TaskExecutionError) as ei:
        run_iters(trainer, 1)
    assert ei.value.permanent and ei.value.dead_devices == (5,)
    assert ei.value.task == critic


def test_slot_failure_is_refused():
    trainer, topo, wf = make_trainer()
    attach(trainer, fault_scenario("slot_failure", at=0))
    with pytest.raises(NotImplementedError, match="item 6"):
        run_iters(trainer, 1)
    with pytest.raises(NotImplementedError, match="item 6"):
        tlaunch.parse_args(["--arch", "qwen3-0.6b", "--rl", "grpo",
                            "--fault", "slot_failure"])


# ---------------------------------------------------------------------------
# the launchers' recovery, scenario by scenario
# ---------------------------------------------------------------------------

def recovery_kind(lines):
    rec = [ln for ln in lines if ln.startswith("recovered:")]
    assert len(rec) == 1, lines
    return re.sub(r"\d+", "N", rec[0])


@pytest.mark.parametrize("scenario", ["link_throttle", "device_slowdown",
                                      "straggler", "transient_crash",
                                      "permanent_crash", "device_drop"])
def test_launcher_recovers_like_reference(scenario, capsys, monkeypatch,
                                          tmp_path):
    monkeypatch.chdir(tmp_path)
    argv = ["--arch", "qwen3-0.6b", "--smoke", "--rl", "grpo", "--steps",
            "8", "--batch", "4", "--search-budget", "40", "--fault",
            scenario, "--require-recover"]
    capsys.readouterr()
    jmetrics.reset()
    import sys
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    jlaunch.main()
    jl = capsys.readouterr().out.splitlines()
    obs_metrics.reset()
    out = tlaunch.main(argv + ["--device", "cpu"])
    tl = capsys.readouterr().out.splitlines()
    assert tl[-1] == jl[-1] == "done"
    assert [ln for ln in tl if ln.startswith("faults:")] == \
        [ln for ln in jl if ln.startswith("faults:")]
    assert recovery_kind(tl) == recovery_kind(jl)
    assert out["recovered"] in tl
    if scenario in ("permanent_crash", "device_drop"):
        assert [ln.split(":")[0] for ln in tl if "TASK FAILURE" in ln] == \
            [ln.split(":")[0] for ln in jl if "TASK FAILURE" in ln]
