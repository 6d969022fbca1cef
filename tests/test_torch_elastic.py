"""Elastic plan swaps (§6 online redeployment) on the port, held against
the JAX package on the same workflow, seed and budget.

- ``transition_cost`` and ``reschedule`` give the reference's
  ``RedeployDecision`` (switch, costs, transition cost) and plan;
- ``Engine.apply_plan`` / ``update_topology`` give the reference's epochs,
  ``ctx_history`` lengths, transition windows and stale flags;
- the port's engine behaves as the reference's tests pin it: epoch
  stamps, the migration window, trainer state untouched, a swap to the
  same plan a bitwise no-op, async staleness across the swap, epoch-aware
  measured-vs-predicted;
- the elastic controller swaps on a drop (checkpointing the state, which
  restores equal to the live state) and stays put on mild drift;
- ``fit_calibration``, ``DivergenceMonitor`` and
  ``infer_drifted_topology`` on one numpy timeline give the reference's
  scales, fires and topology;
- ``--require-recover`` on the checkpoint and chaos fault scenarios, and
  ``--drift drop_tail``, reach the same kind of recovery on both
  launchers (the other scenarios: ``tests/test_torch_faults.py``).

Retries sleep through an injected no-op, and no assertion bounds a
time.
"""
import math
import os
import re

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.core import enumerate as jenum, redeploy as jredeploy  # noqa: E402
from repro.core import simulator as jsim, topology as jtopo  # noqa: E402
from repro.core import workflow as jwf  # noqa: E402
from repro.core.sha import HybridScheduler as JHS  # noqa: E402
from repro.engine import executor as jexec  # noqa: E402
from repro.launch import train as jlaunch  # noqa: E402
from repro.models.config import ModelConfig as JMC  # noqa: E402
from repro.obs import calibrate as jcal, metrics as jmetrics  # noqa: E402
from repro_torch.checkpoint import io as ckpt_io  # noqa: E402
from repro_torch.core import enumerate as tenum, redeploy as tredeploy  # noqa: E402
from repro_torch.core import simulator as tsim, topology as ttopo  # noqa: E402
from repro_torch.core import workflow as twf  # noqa: E402
from repro_torch.core.sha import HybridScheduler as THS  # noqa: E402
from repro_torch.data.synthetic import AdditionTask, VOCAB_SIZE  # noqa: E402
from repro_torch.engine import executor as texec  # noqa: E402
from repro_torch.engine.elastic import ElasticConfig, ElasticController  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models.config import ModelConfig as TMC  # noqa: E402
from repro_torch.obs import calibrate as tcal, metrics as tmetrics  # noqa: E402
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


PKG = {"ref": (jtopo, jwf, jenum, JHS, jredeploy, JMC),
       "port": (ttopo, twf, tenum, THS, tredeploy, TMC)}


def tiny(MC):
    return MC(name="el-tiny", n_layers=2, d_model=64, n_heads=2,
              n_kv_heads=2, head_dim=32, d_ff=128, vocab_size=VOCAB_SIZE,
              dtype="float32")


def pool(topo_m):
    return topo_m.build_testbed("single_region", counts={"A100": 4, "L4": 4})


def make_wf(pkg, *, asynchronous=False, batch=1):
    topo_m, wf_m, _, _, _, MC = PKG[pkg]
    return wf_m.make_workflow("grpo", wf_m.LLMSpec.from_model_config(tiny(MC)),
                              synchronous=not asynchronous, n_rollouts=4,
                              seq_in=AdditionTask(max_operand=9).prompt_len,
                              seq_out=4, global_batch=batch)


def grouped_plan(pkg, topo, wf, grouping):
    enum = PKG[pkg][2]
    sizes = enum.proportional_sizes(wf, grouping, topo.n)
    return enum.build_plan(topo, wf, grouping, sizes, list(range(topo.n)))


def searched(pkg, budget=120):
    topo = pool(PKG[pkg][0])
    wf = make_wf(pkg, batch=8)
    r = PKG[pkg][3](topo, wf, max_groupings=8,
                    max_sizes_per_grouping=4).search(budget=budget)
    return topo, wf, r.plan


def same_plan(a, b):
    assert [(g.tasks, g.devices) for g in a.groups] == \
        [(g.tasks, g.devices) for g in b.groups]
    assert a.parallel == b.parallel
    assert a.assignment.keys() == b.assignment.keys()
    for t in a.assignment:
        np.testing.assert_array_equal(a.assignment[t], b.assignment[t])


def make_trainer(asynchronous=False, grouping="gen|rest", plan=None,
                 batch=1):
    task = AdditionTask(max_operand=9)
    topo = pool(ttopo)
    wf = make_wf("port", asynchronous=asynchronous, batch=batch)
    if plan is None:
        g = (tuple(sorted(((0,), tuple(range(1, wf.n_tasks)))))
             if grouping == "gen|rest" else (tuple(range(wf.n_tasks)),))
        plan = grouped_plan("port", topo, wf, g)
    rl = RLConfig(algorithm="grpo", n_rollouts=4, max_new_tokens=4,
                  asynchronous=asynchronous)
    tr = RLTrainer(tiny(TMC), rl, task, seed=0, plan=plan, topo=topo, wf=wf,
                   device="cpu")
    return tr, topo, wf


def run_iters(trainer, n, batch=4, seed=0):
    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(7 + seed)
    return [trainer.iteration(*trainer.task.sample_batch(rng, batch), gen)
            for _ in range(n)]


def snapshot(trainer):
    return [t.detach().clone() for t in tree_leaves(trainer.state_tree())]


def equal_leaves(a, b):
    return len(a) == len(b) and all(x.dtype == y.dtype and torch.equal(x, y)
                                    for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# redeploy: the port's copy against the reference
# ---------------------------------------------------------------------------

def two_region(topo_m):
    devs = [topo_m.Device(i, topo_m.A100, machine=i // 2, zone=0,
                          region="east" if i < 2 else "west")
            for i in range(4)]
    bw = np.array([[2039., 100., 8.0, 1.0], [100., 2039., 4.0, 2.0],
                   [8.0, 4.0, 2039., 100.], [1.0, 2.0, 100., 2039.]])
    return topo_m.Topology(devs, np.full((4, 4), 1e-3), bw)


def test_transition_cost_matches_reference():
    from repro.core.plan import Plan as JPlan, TaskGroup as JTG
    from repro_torch.core.plan import Plan as TPlan, TaskGroup as TTG
    out = {}
    for pkg, Plan, TG in (("ref", JPlan, JTG), ("port", TPlan, TTG)):
        topo_m, _, _, _, rd, _ = PKG[pkg]
        topo = two_region(topo_m)
        wf = make_wf(pkg)

        def stub(devs_per_task):
            par = {t: (len(d), 1, 1) for t, d in devs_per_task.items()}
            asg = {t: np.array(d).reshape(len(d), 1, 1)
                   for t, d in devs_per_task.items()}
            return Plan((TG(tuple(devs_per_task), tuple(sorted(
                {x for d in devs_per_task.values() for x in d}))),), par, asg)
        old = stub({t: [0, 1] for t in range(wf.n_tasks)})
        new = stub({t: [2, 3] for t in range(wf.n_tasks)})
        half = stub({t: [1, 2] for t in range(wf.n_tasks)})
        small = topo_m.drop_devices(topo, [1])
        out[pkg] = (rd.transition_cost(topo, wf, old, new),
                    rd.transition_cost(topo, wf, old, half),
                    rd.transition_cost(small, wf, old, stub(
                        {t: [0, 2] for t in range(wf.n_tasks)}),
                        topo_old=topo))
    assert out["port"] == out["ref"]
    assert out["port"][0] > 0


@pytest.mark.parametrize("drift", ["unchanged", "drop_two", "degrade",
                                   "drop_tail"])
def test_reschedule_matches_reference(drift):
    got = {}
    for pkg in ("ref", "port"):
        topo_m, rd = PKG[pkg][0], PKG[pkg][4]
        topo, wf, plan = searched(pkg)
        new = {"unchanged": topo,
               "drop_two": topo_m.drop_devices(topo, [topo.n - 2,
                                                      topo.n - 1]),
               "degrade": topo_m.degrade_links(topo, bw_factor=0.05,
                                               lat_factor=10.0),
               "drop_tail": topo_m.drift_scenario(
                   "drop_tail", topo, at=1).topo_at(1)}[drift]
        got[pkg] = (plan, rd.reschedule(new, wf, plan, budget=150,
                                        amortization_iters=20,
                                        topo_old=topo))
    (jp, jd), (tp, td) = got["ref"], got["port"]
    same_plan(tp, jp)
    assert (td.switch, td.old_cost, td.new_cost, td.transition_cost_s,
            td.amortization_iters) == (jd.switch, jd.old_cost, jd.new_cost,
                                       jd.transition_cost_s,
                                       jd.amortization_iters)
    same_plan(td.plan, jd.plan)
    if drift == "unchanged":
        assert not td.switch and td.plan is tp
    if drift.startswith("drop"):
        assert td.old_cost == math.inf and td.switch


class _Stub:
    """An engine state that is never run: plan swaps only touch the
    placements and the replay clock."""
    device = torch.device("cpu")


def test_apply_plan_matches_reference():
    """The same sequence of swaps and topology updates on both engines:
    the same epochs, history, transition windows, stale flags and
    per-epoch predictions."""
    rows = {}
    for pkg, ex in (("ref", jexec), ("port", texec)):
        topo_m = PKG[pkg][0]
        topo, wf, plan = searched(pkg)
        eng = ex.Engine(wf, plan, _Stub(), topo=topo)
        colocated = grouped_plan(pkg, topo, wf, (tuple(range(wf.n_tasks)),))
        log = [eng.apply_plan(colocated, topo=topo)]
        dropped = topo_m.drop_devices(topo, [topo.n - 1])
        eng.update_topology(dropped)
        log.append((eng.epoch, eng.topology_stale, eng.topo.n))
        small = topo_m.drift_scenario("drop_tail", topo, at=1).topo_at(1)
        d = PKG[pkg][4].reschedule(small, wf, eng.plan, budget=100,
                                   topo_old=topo)
        log.append(eng.apply_plan(d.plan, topo=small, carry_pending=False))
        log.append((eng.epoch, len(eng.ctx_history), eng.topology_stale,
                    [c.epoch for c in eng.ctx_history],
                    [c.start_iter for c in eng.ctx_history + [eng.ctx]],
                    eng.ctx.folding.n_collisions,
                    sorted(bool(p.collision)
                           for p in eng.placements.values())))
        log.append([(r["epoch"], r["iterations"], r["predicted_iter_s"])
                    for r in eng.epoch_report()])
        rows[pkg] = log
    assert rows["port"] == rows["ref"]
    assert rows["port"][3][0] == 2 and rows["port"][3][1] == 2


# ---------------------------------------------------------------------------
# the port's engine across a swap
# ---------------------------------------------------------------------------

def test_apply_plan_swaps_context():
    trainer, topo, wf = make_trainer()
    run_iters(trainer, 2)
    old_plan = trainer.plan
    colocated = grouped_plan("port", topo, wf, (tuple(range(wf.n_tasks)),))
    info = trainer.engine.apply_plan(colocated, topo=topo)
    assert trainer.engine.epoch == 1
    assert trainer.plan is colocated
    assert trainer.engine.ctx_history[0].plan is old_plan
    run_iters(trainer, 2, seed=1)
    assert {e.epoch for e in trainer.engine.timeline} == {0, 1}
    mig = [e for e in trainer.engine.timeline
           if e.task == texec.MIGRATION_TASK]
    assert len(mig) == 2
    assert mig[1].time - mig[0].time == pytest.approx(
        info["transition_cost_s"])
    post = [e for e in trainer.engine.timeline
            if e.epoch == 1 and e.task != texec.MIGRATION_TASK]
    assert post and min(e.time for e in post) >= info["migration_end_s"]
    # one device: the colocated plan has one group, so nothing collides
    assert trainer.engine.ctx.folding.n_collisions == 0
    assert trainer.engine.ctx_history[0].folding.n_collisions > 0


def test_apply_plan_preserves_trainer_state():
    trainer, topo, wf = make_trainer()
    before = run_iters(trainer, 2)
    wv, actor = trainer.weight_version, trainer.actor
    state = snapshot(trainer)
    trainer.engine.apply_plan(
        grouped_plan("port", topo, wf, (tuple(range(wf.n_tasks)),)),
        topo=topo)
    assert trainer.weight_version == wv and trainer.actor is actor
    assert equal_leaves(snapshot(trainer), state)
    after = run_iters(trainer, 2, seed=1)
    assert trainer.weight_version == wv + 2
    assert all(math.isfinite(m["loss"]) for m in before + after)


def test_swap_to_identical_plan_is_bitwise_noop():
    ms = {}
    for swap in (False, True):
        trainer, topo, wf = make_trainer()
        out = run_iters(trainer, 1)
        if swap:
            trainer.engine.apply_plan(trainer.plan, topo=topo)
        out += run_iters(trainer, 2, seed=1)
        ms[swap] = (out, snapshot(trainer))
    for m0, m1 in zip(ms[False][0], ms[True][0]):
        assert sorted(m0) == sorted(m1)
        for k in m0:
            assert float(m0[k]) == float(m1[k]), k
    assert equal_leaves(ms[False][1], ms[True][1])


def test_async_staleness_survives_swap_and_drain_refills():
    trainer, topo, wf = make_trainer(asynchronous=True)
    run_iters(trainer, 3)
    colocated = grouped_plan("port", topo, wf, (tuple(range(wf.n_tasks)),))
    assert trainer.engine.apply_plan(colocated, topo=topo)[
        "dropped_bundles"] == 0.0
    run_iters(trainer, 2, seed=1)
    recs = trainer.engine.pipeline.records
    assert (recs[0].gen_version, recs[0].weight_version) == (0, 0)
    assert all(r.weight_version - r.gen_version == 1 for r in recs[1:])
    n = len(recs)
    info = trainer.engine.apply_plan(trainer.plan, topo=topo,
                                     carry_pending=False)
    assert info["dropped_bundles"] == 1.0
    m = run_iters(trainer, 2, seed=2)
    assert m[0].get("pipeline_fill") == 1.0 and "pipeline_fill" not in m[1]
    assert len(trainer.engine.pipeline.records) == n + 1


def test_measured_result_epoch_aware():
    trainer, topo, wf = make_trainer()
    run_iters(trainer, 3)
    pairs = [(i, j) for i in range(topo.n) for j in range(i + 1, topo.n)]
    degraded = ttopo.degrade_links(topo, bw_factor=1e-6, pairs=pairs)
    colocated = grouped_plan("port", topo, wf, (tuple(range(wf.n_tasks)),))
    info = trainer.engine.apply_plan(colocated, topo=degraded)
    assert info["transition_cost_s"] > 10.0
    run_iters(trainer, 2, seed=1)
    meas = trainer.engine.measured_result()
    assert meas.iteration_time < info["transition_cost_s"]
    cmp = trainer.engine.compare_with_simulator()
    assert cmp["epoch"] == 1.0 and np.isfinite(cmp["ratio"])
    rows = trainer.engine.epoch_report()
    assert [(r["epoch"], r["iterations"]) for r in rows] == [(0, 3), (1, 2)]
    assert all(np.isfinite(r["measured_iter_s"]) for r in rows)


def test_update_topology_unfit_incumbent_keeps_old_topo():
    trainer, topo, wf = make_trainer()
    run_iters(trainer, 2)
    eng = trainer.engine
    dropped = ttopo.drop_devices(topo, [topo.n - 1])
    eng.update_topology(dropped)
    assert eng.topology_stale and eng.topo.n == topo.n
    assert np.isfinite(eng.epoch_report()[-1]["predicted_iter_s"])
    assert np.isfinite(eng.compare_with_simulator()["predicted_iter_s"])
    eng.update_topology(topo)
    assert not eng.topology_stale and eng.topo is topo


# ---------------------------------------------------------------------------
# the elastic controller
# ---------------------------------------------------------------------------

def test_controller_swaps_on_drop_and_its_checkpoint_restores(tmp_path):
    trainer, topo, wf = make_trainer()
    ctrl = ElasticController(
        trainer, ttopo.drift_scenario("drop_tail", topo, at=2),
        ElasticConfig(budget=150, ckpt_dir=str(tmp_path)))
    wv, saved = [], None
    for it in range(5):
        run_iters(trainer, 1, seed=it)
        wv.append(trainer.weight_version)
        rec = ctrl.poll(it)
        if rec is not None:
            assert rec.iteration == 2 and rec.decision.switch and rec.applied
            assert rec.ckpt_path and os.path.exists(rec.ckpt_path)
            assert rec.ckpt_bytes == os.path.getsize(rec.ckpt_path)
            saved = snapshot(trainer)       # the swap leaves it untouched
            path = rec.ckpt_path
    assert len(ctrl.swaps) == len(ctrl.records) == 1
    assert trainer.engine.epoch == 1 and wv == sorted(wv) and wv[-1] == 5
    rows = trainer.engine.epoch_report()
    assert [r["epoch"] for r in rows] == [0, 1]
    # the checkpoint written at the swap is the live state of that moment
    restored = ckpt_io.restore(path, trainer.state_tree())
    assert equal_leaves([t for t in tree_leaves(restored)], saved)
    trainer.load_state_tree(restored)
    assert trainer.weight_version == 3
    m = run_iters(trainer, 1, seed=9)[0]
    assert math.isfinite(m["loss"]) and trainer.weight_version == 4


def test_controller_stays_on_mild_drift():
    topo, wf, plan = searched("port")
    trainer, _, _ = make_trainer(plan=plan, batch=8)
    trainer.engine.update_topology(topo)
    run_iters(trainer, 1)
    mild = ttopo.degrade_links(topo, bw_factor=0.5, lat_factor=2.0)
    ctrl = ElasticController(
        trainer, ttopo.DriftSchedule(topo, [ttopo.DriftEvent(1, "mild",
                                                              mild)]),
        ElasticConfig(budget=120))
    rec = ctrl.poll(1)
    assert rec is not None and not rec.applied
    assert trainer.engine.epoch == 0 and trainer.engine.topo is mild


# ---------------------------------------------------------------------------
# calibration on one numpy timeline
# ---------------------------------------------------------------------------

def _timeline(sim, wf, rng, n_iter=5):
    events, t = [], 0.0
    durs = rng.uniform(0.05, 0.5, (n_iter, wf.n_tasks))
    for it in range(n_iter):
        for task in range(wf.n_tasks):
            events.append(sim.Event(t, "start", it, task))
            t += float(durs[it, task])
            events.append(sim.Event(t, "end", it, task))
    events.append(sim.Event(t, "start", n_iter, -1))     # a migration
    events.append(sim.Event(t + 9.0, "end", n_iter, -1))
    return events


def test_calibration_matches_reference():
    out = {}
    for pkg, sim, cal in (("ref", jsim, jcal), ("port", tsim, tcal)):
        topo, wf, plan = searched(pkg)
        tl = _timeline(sim, wf, np.random.default_rng(0))
        c = cal.fit_calibration(topo, wf, plan, tl, skip_iterations=1,
                                sync_s=[0.01, 0.02, 0.015],
                                per_coefficient=True)
        mon = cal.DivergenceMonitor(threshold=2.0, sustain=2)
        rng = np.random.default_rng(1)
        fires = []
        for it in range(8):
            meas = {t: float(rng.uniform(0.5, 1.5)) * (3.0 if it >= 4 and
                                                       t == 1 else 1.0)
                    for t in range(wf.n_tasks)}
            fires.append(mon.observe_iteration(meas, {t: 1.0 for t in
                                                      range(wf.n_tasks)}))
        inferred = cal.infer_drifted_topology(topo, wf, plan, mon)
        out[pkg] = (c.class_scale, c.global_scale, c.sync_scale, c.n_samples,
                    c.class_coeff, fires, mon.drifted_tasks(),
                    [mon.ratio(t) for t in range(wf.n_tasks)],
                    inferred.bandwidth_gbps.tolist(),
                    [(d.spec.name, d.spec.fp16_tflops)
                     for d in inferred.devices],
                    c.cost_model(topo, wf).cost(plan))
    assert out["port"] == out["ref"]
    assert out["port"][6]                      # task 1 drifted


# ---------------------------------------------------------------------------
# the launchers' recovery, scenario by scenario
# ---------------------------------------------------------------------------

def recovery_kind(lines):
    rec = [ln for ln in lines if ln.startswith("recovered:")]
    assert len(rec) == 1, lines
    return re.sub(r"\d+", "N", rec[0])


def run_launcher(pkg, flags, capsys, monkeypatch, tmp_path):
    """One launcher run in a fresh working directory (its checkpoints go to
    ``results/elastic_ckpt`` there) with fresh metrics; returns the lines
    printed and the result dict (None for the reference)."""
    monkeypatch.chdir(tmp_path / pkg)
    argv = ["--arch", "qwen3-0.6b", "--smoke", "--rl", "grpo", "--steps",
            "8", "--batch", "4", "--search-budget", "40",
            "--require-recover"] + flags
    capsys.readouterr()
    if pkg == "ref":
        jmetrics.reset()
        import sys
        monkeypatch.setattr(sys, "argv", ["train"] + argv)
        out = jlaunch.main()
    else:
        tmetrics.reset()
        out = tlaunch.main(argv + ["--device", "cpu"])
    return capsys.readouterr().out.splitlines(), out


@pytest.mark.parametrize("flags", [["--fault", "ckpt_fail"],
                                   ["--fault", "ckpt_flaky"],
                                   ["--fault", "ckpt_corrupt"],
                                   ["--fault", "chaos"],
                                   ["--drift", "drop_tail"]])
def test_launcher_recovers_like_reference(flags, capsys, monkeypatch,
                                          tmp_path):
    got = {}
    for pkg in ("ref", "port"):
        (tmp_path / pkg).mkdir()
        got[pkg] = run_launcher(pkg, flags, capsys, monkeypatch, tmp_path)
    (jl, _), (tl, out) = got["ref"], got["port"]
    assert tl[-1] == jl[-1] == "done"
    if flags[0] == "--fault":
        assert [ln for ln in tl if ln.startswith("faults:")] == \
            [ln for ln in jl if ln.startswith("faults:")]
        assert recovery_kind(tl) == recovery_kind(jl)
        assert out["recovered"] in tl
        return
    # a declared drift (no monitor armed, nothing timed decides): the same
    # swap at the same iteration with the same costs, and two epochs

    def swaps(lines):
        return [re.sub(r"in [\d.]+s", "", ln) for ln in lines
                if ln.lstrip().startswith("drift")]

    assert swaps(tl) == swaps(jl) and len(swaps(tl)) == 1
    assert "switch=True" in swaps(tl)[0]
    assert [ln.split(":")[0] for ln in tl if ln.startswith("epoch ")] == \
        [ln.split(":")[0] for ln in jl if ln.startswith("epoch ")] == \
        ["epoch 0", "epoch 1"]
    assert len(out["controller"].swaps) == 1
