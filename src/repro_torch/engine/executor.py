"""Task-graph executor: runs the RL iteration as the plan dictates.

The engine walks ``wf.stages()`` (topological stages of the workflow
graph) and dispatches the registered per-task executors.  Within a stage,
tasks are partitioned into *lanes* by their plan task group: colocated
tasks (same GPU group) serialize in task order, disjoint groups run
concurrently (one thread per lane — PyTorch ops release the GIL, so
lanes on disjoint devices genuinely overlap).

Every task execution is measured, and the measured durations are replayed
through the same device-availability logic as ``core.simulator.simulate``
— producing an ``Event`` timeline on the *plan's* device ids that shares
the ``Event``/``SimResult`` dataclasses with the simulator, so a Fig-7
style measured-vs-predicted comparison is ``compare_with_simulator()``.

Everything the engine derives from the scheduler's ``Plan`` lives in a
``PlanContext`` (plan epoch 0: the port does not swap plans yet).

Port of ``repro.engine.executor``.  A task's measured duration ends at a
CUDA event recorded on the current stream after the task and waited on
(``device.wait_for``), and the weight sync ends at a device synchronize,
so the ``Event`` timeline times the card's work, not the launch queue
(both are no-ops on the CPU).  Lanes of disjoint plan groups still run
in threads; on one card they share its stream, so a lane's wait also
covers the other lane's earlier work — the folding's collision flags
(every group collides on one card) mark those events.

Not yet ported (ROADMAP.md §1 item 8): plan swaps (``apply_plan``,
``update_topology``), the fault injector, task retries and deadlines,
and the divergence monitor; and (item 9) the gen/train wall-clock
overlap, which needs GEN on devices of its own.
"""
from __future__ import annotations

import dataclasses
import math
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.costmodel import CostModel
from repro_torch.core.plan import Plan, predicted_occupancy
from repro_torch.core.simulator import Event, SimResult, simulate
from repro_torch.core.topology import Topology
from repro_torch.core.workflow import RLWorkflow, TaskKind
from repro_torch.device import resolve_device, synchronize, wait_for
from repro_torch.engine import tasks as tasks_mod
from repro_torch.engine.pipeline import AsyncPipeline, sync_actor_weights
from repro_torch.engine.placement import build_placement, fold_plan
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

@dataclasses.dataclass
class EngineResult:
    metrics: Dict[str, float]
    events: List[Event]          # this iteration's replayed timeline
    iteration: int
    epoch: int = 0               # plan epoch the iteration executed under


@dataclasses.dataclass
class PlanContext:
    """Everything the engine derives from one ``Plan``."""
    epoch: int
    plan: Plan
    topo: Optional[Topology]
    placements: Dict[int, Any]            # task -> TaskPlacement
    gen_task: int
    actor_train: int
    dev_free: Dict[int, float]            # plan-device availability (replay)
    folding: Any = None                   # placement.DeviceFolding


class Engine:
    def __init__(self, wf: RLWorkflow, plan: Plan, state,
                 *, topo: Optional[Topology] = None,
                 asynchronous: Optional[bool] = None,
                 devices: Optional[Sequence] = None):
        self.wf = wf
        self.state = state
        self._devices = list(devices) if devices is not None else None
        if asynchronous is None:
            asynchronous = not wf.synchronous
        self.pipeline = AsyncPipeline(asynchronous)
        self.ctx = self._make_context(plan, topo)
        self._done_at: Dict[tuple, float] = {}
        self._sync_done = 0.0
        self._iter = 0
        self._samples = 0
        self.timeline: List[Event] = []
        # decode-wave sub-timeline (genserve): one start/end Event pair
        # per wave round, annotated with measured slot occupancy.  Kept
        # separate from `timeline` so task-level measured-vs-simulated
        # parity is unaffected; times are host-monotonic relative to
        # engine construction.
        self.wave_timeline: List[Event] = []
        self._wave_slot_steps = 0
        self._wave_decode_steps = 0
        self._wave_pred_sum = 0.0
        self._wave_calls = 0
        self._t0 = time.monotonic()
        # measured weight-sync wall-clock per trained iteration
        self.sync_durations: List[float] = []

    # -- plan context ---------------------------------------------------
    def _make_context(self, plan: Plan,
                      topo: Optional[Topology]) -> PlanContext:
        missing = set(range(self.wf.n_tasks)) - set(plan.parallel)
        if missing:
            raise ValueError(f"plan does not cover workflow tasks {missing}")
        devices = list(self._devices) if self._devices is not None \
            else [getattr(self.state, "device", None) or resolve_device()]
        folding = fold_plan(plan, devices)
        placements = {t: build_placement(plan, t, devices, folding)
                      for t in range(self.wf.n_tasks)}
        gen_task = next(t for t in range(self.wf.n_tasks)
                        if self.wf.task(t).kind == TaskKind.GEN)
        actor_train = next(
            t for t in range(self.wf.n_tasks)
            if self.wf.task(t).kind == TaskKind.TRAIN
            and self.wf.task(t).name.startswith("actor"))
        dev_free = {int(d): 0.0 for t in range(self.wf.n_tasks)
                    for d in plan.assignment[t].reshape(-1)}
        # commit each task's state onto its owning placement (no-op on
        # one device)
        install = getattr(self.state, "install_placements", None)
        if install is not None:
            install(placements, self.wf)
        # per-placement gauges: which device group / realized tp each
        # task actually got, and whether folding collided at all
        obs_metrics.gauge("placement.collisions").set(
            float(folding.n_collisions))
        for t, pl in placements.items():
            name = self.wf.task(t).name
            obs_metrics.gauge(f"placement.devices.{name}").set(
                float(pl.n_devices))
            obs_metrics.gauge(f"placement.tp_realized.{name}").set(
                float(pl.tp_eff))
        return PlanContext(0, plan, topo, placements, gen_task,
                           actor_train, dev_free, folding=folding)

    @property
    def plan(self) -> Plan:
        return self.ctx.plan

    @property
    def topo(self) -> Optional[Topology]:
        return self.ctx.topo

    @property
    def placements(self) -> Dict[int, Any]:
        return self.ctx.placements

    @property
    def epoch(self) -> int:
        return self.ctx.epoch

    @property
    def _gen_task(self) -> int:
        return self.ctx.gen_task

    @property
    def _actor_train(self) -> int:
        return self.ctx.actor_train

    @property
    def _dev_free(self) -> Dict[int, float]:
        return self.ctx.dev_free

    # -- stage dispatch ------------------------------------------------
    def _lanes(self, stage: Sequence[int]) -> List[List[int]]:
        """Partition a stage's tasks by plan task group (colocated tasks
        share a lane and serialize; lanes run concurrently)."""
        lanes: Dict[tuple, List[int]] = {}
        for t in sorted(stage):
            lanes.setdefault(self.plan.group_of(t).devices, []).append(t)
        return list(lanes.values())

    def _run_stage(self, stage: Sequence[int], bb: Dict[str, Any],
                   durations: Dict[int, float],
                   meta: Dict[int, tuple]) -> None:
        def run_lane(lane: List[int]) -> None:
            for t in lane:
                task = self.wf.task(t)
                fn = tasks_mod.executor_for(task)
                pl = self.placements[t]
                mesh_attr = "x".join(str(s) for s in pl.mesh_shape) + "@" \
                    + ",".join(str(getattr(d, "id", d))
                               for d in pl.local_devices)
                with obs_trace.span(f"task.{task.name}", task=t,
                                    iteration=self._iter,
                                    epoch=self.ctx.epoch,
                                    mesh=mesh_attr) as sp:
                    t0 = time.monotonic()
                    out = fn(self.state, bb, pl)
                    if out is not None:
                        wait_for(out)
                    t1 = time.monotonic()
                durations[t] = t1 - t0
                meta[t] = (t0 - self._t0, sp.id)

        lanes = self._lanes(stage)
        if len(lanes) == 1:
            run_lane(lanes[0])
            return
        with ThreadPoolExecutor(max_workers=len(lanes)) as pool:
            for f in [pool.submit(run_lane, lane) for lane in lanes]:
                f.result()

    # -- measured-timeline replay --------------------------------------
    def _replay_iteration(self, durations: Dict[int, float],
                          sync_dur: float, trained: bool,
                          meta: Optional[Dict[int, tuple]] = None
                          ) -> List[Event]:
        """Replay measured durations through the simulator's scheduling
        rules on the plan's device ids (same event ordering semantics).
        ``meta`` carries each task's host wall-clock start (relative to
        engine construction) and obs.trace span id, stamped onto the
        replayed events for calibration/trace correlation."""
        it = self._iter
        epoch = self.ctx.epoch
        events: List[Event] = []
        for t in sorted(durations):
            task = self.wf.task(t)
            dep_ready = max([self._done_at.get((it, d), 0.0)
                             for d in task.depends_on], default=0.0)
            if task.kind == TaskKind.GEN:
                dep_ready = max(dep_ready, self._sync_done)
            devs = [int(d) for d in self.plan.assignment[t].reshape(-1)]
            start = max([dep_ready] + [self._dev_free[d] for d in devs])
            end = start + durations[t]
            for d in devs:
                self._dev_free[d] = end
            wall0, sid = (meta or {}).get(t, (None, 0))
            wall1 = wall0 + durations[t] if wall0 is not None else None
            # honest overlap accounting: tag events of tasks whose plan
            # group folded onto a device shared with another group
            coll = True if self.placements[t].collision else None
            events.append(Event(start, "start", it, t, epoch=epoch,
                                t_wall=wall0, span=sid or None,
                                collision=coll))
            events.append(Event(end, "end", it, t, epoch=epoch,
                                t_wall=wall1, span=sid or None,
                                collision=coll))
            self._done_at[(it, t)] = end
        if trained:
            train_end = self._done_at[(it, self._actor_train)]
            self._sync_done = train_end + sync_dur
            if self.wf.synchronous:
                for d in self._dev_free:
                    self._dev_free[d] = max(self._dev_free[d],
                                            self._sync_done)
            else:
                for d in self.plan.assignment[self._gen_task].reshape(-1):
                    d = int(d)
                    self._dev_free[d] = max(self._dev_free[d],
                                            self._sync_done)
        events.sort(key=lambda e: e.time)
        self.timeline.extend(events)
        self._iter += 1
        return events

    # -- one iteration --------------------------------------------------
    def run_iteration(self, prompts, answers, rng) -> EngineResult:
        t_iter0 = time.monotonic()
        with obs_trace.span("engine.iteration", iteration=self._iter,
                            epoch=self.ctx.epoch):
            result = self._run_iteration(prompts, answers, rng)
        obs_metrics.histogram("engine.iter_wall_s").observe(
            time.monotonic() - t_iter0)
        obs_metrics.gauge("engine.plan_epoch").set(self.ctx.epoch)
        if self.pipeline.records:
            rec = self.pipeline.records[-1]
            obs_metrics.gauge("engine.staleness").set(
                rec.weight_version - rec.gen_version)
        return result

    def _run_iteration(self, prompts, answers, rng) -> EngineResult:
        bb: Dict[str, Any] = {"lock": threading.Lock(), "metrics": {}}
        bb.update(self.state.prepare_inputs(prompts, answers, rng))
        self._samples = int(bb["prompts_rep"].shape[0])
        durations: Dict[int, float] = {}
        meta: Dict[int, tuple] = {}
        before_stage = getattr(self.state, "before_stage", None)
        for stage in self.wf.stages():
            has_gen = any(self.wf.task(t).kind == TaskKind.GEN
                          for t in stage)
            if before_stage is not None:
                # shared cross-task prep (e.g. advantages) runs outside
                # the per-task timers so lane measurements stay honest
                before_stage([self.wf.task(t) for t in stage], bb)
            with obs_trace.span("engine.stage", tasks=len(stage)):
                self._run_stage(stage, bb, durations, meta)
            if has_gen:
                self._record_gen_stats(bb)
                bundle = self.pipeline.push(bb.pop("fresh"))
                if bundle is None:
                    # pipeline fill: nothing to train on yet, no sync
                    events = self._replay_iteration(durations, 0.0,
                                                    trained=False,
                                                    meta=meta)
                    return EngineResult(self.state.fill_metrics(),
                                        events, self._iter - 1,
                                        self.ctx.epoch)
                bb["bundle"] = bundle
                self.pipeline.record(self._iter, bundle,
                                     self.state.weight_version)

        t0 = time.monotonic()
        with obs_trace.span("engine.sync", iteration=self._iter):
            nbytes = sync_actor_weights(
                self.state, self.placements[self._gen_task],
                self.placements[self._actor_train])
            synchronize(self.placements[self._gen_task].local_devices[0])
        sync_dur = time.monotonic() - t0
        self.sync_durations.append(sync_dur)
        obs_metrics.histogram("engine.sync_s").observe(sync_dur)
        metrics = dict(bb["metrics"])
        metrics["sync_gb"] = nbytes / 1e9
        events = self._replay_iteration(durations, sync_dur, trained=True,
                                        meta=meta)
        return EngineResult(metrics, events, self._iter - 1, self.ctx.epoch)

    # -- decode-wave telemetry -------------------------------------------
    def _record_gen_stats(self, bb: Dict[str, Any]) -> None:
        """Fold the GEN executor's wave stats into metrics + the per-wave
        Event sub-timeline (each wave round annotated with its measured
        slot occupancy, comparable against the cost model's decode_wave
        prediction)."""
        stats = bb.pop("gen_stats", None)
        if stats is None:
            return
        # busy accounting: decode slot-steps plus prefill-chunk slot-
        # rounds (chunked admission) over all device rounds — for the
        # one-shot admission path prefill_slot_steps is 0 and this
        # reduces to the pure decode occupancy
        self._wave_slot_steps += int(stats["slot_steps"]) \
            + int(stats.get("prefill_slot_steps", 0))
        self._wave_decode_steps += int(stats["decode_steps"])
        # ideal occupancy for the batch this executor actually ran (the
        # engine folds all plan replicas onto the host, so the per-call
        # request count — not the cost model's per-replica batch — is the
        # like-for-like prediction baseline); chunked admission charges
        # each request its prefill rounds instead of free admission
        self._wave_pred_sum += predicted_occupancy(
            stats["admitted"], wave=stats["wave"],
            prefill_rounds=stats.get("prefill_rounds_per_req", 0.0),
            max_new_tokens=stats.get("max_new_tokens"))
        self._wave_calls += 1
        bb["metrics"].update({
            "gen_wave": float(stats["wave"]),
            "gen_wave_occupancy": float(stats["mean_occupancy"]),
            "gen_decode_steps": float(stats["decode_steps"]),
        })
        if stats.get("prefill_rounds", 0):
            bb["metrics"]["gen_prefill_rounds"] = \
                float(stats["prefill_rounds"])
            bb["metrics"]["gen_busy_occupancy"] = \
                float(stats["busy_occupancy"])
        rounds = stats.get("rounds") or []
        if not rounds and stats["decode_steps"]:
            # single-wave fast path: one synthesized zero-length wave
            # round stamped now, keeping the sub-timeline monotonic
            now = time.monotonic()
            rounds = [(now, now, stats["mean_occupancy"], 0)]
        for w, (t0, t1, occ, _adm) in enumerate(rounds):
            self.wave_timeline.append(Event(
                t0 - self._t0, "start", self._iter, self._gen_task,
                wave=w, occupancy=occ, epoch=self.ctx.epoch))
            self.wave_timeline.append(Event(
                t1 - self._t0, "end", self._iter, self._gen_task,
                wave=w, occupancy=occ, epoch=self.ctx.epoch))

    def wave_occupancy_summary(self) -> Dict[str, float]:
        """Measured mean *busy* slot occupancy (over all iterations) vs
        the ideal occupancy for the batches the engine actually ran —
        under chunked admission both sides count prefill-chunk rounds
        (a slot mid-prefill is busy, and admission is priced, not free;
        with one-shot admission both reduce to pure decode occupancy).

        ``predicted_occupancy`` is the engine-view ideal (whole rollout
        batch, since the engine folds every plan replica onto the host);
        ``predicted_occupancy_plan`` is the cost model's per-replica
        figure for the GEN task on the reference pool — the two differ
        exactly when the plan shards generation over dp > 1 replicas."""
        measured = self._wave_slot_steps / max(self._wave_decode_steps, 1)
        pred = self._wave_pred_sum / max(self._wave_calls, 1)
        out = {"measured_occupancy": measured,
               "measured_decode_steps": float(self._wave_decode_steps),
               "predicted_occupancy": pred,
               "ratio": measured / max(pred, 1e-9)}
        # honest overlap accounting: when folding collided, the lanes the
        # replay timeline shows as concurrent actually serialized on a
        # shared real device — flag it next to the occupancy figures
        folding = self.ctx.folding
        if folding is not None:
            out["folding_collisions"] = float(folding.n_collisions)
            out["overlap_honest"] = float(folding.n_collisions == 0)
        if self.topo is not None:
            cm = CostModel(self.topo, self.wf)
            out["predicted_occupancy_plan"] = \
                cm.gen_wave_occupancy(self.plan, self._gen_task)
        return out

    # -- measured vs predicted -------------------------------------------
    def _gen_starts(self) -> List[float]:
        return sorted(e.time for e in self.timeline
                      if e.task == self.ctx.gen_task and e.kind == "start")

    def measured_result(self) -> SimResult:
        """Measured timeline in the simulator's SimResult shape; the
        steady-state iteration time is the delta of the last two
        generation starts."""
        if not self.timeline:
            return SimResult(0.0, 0.0, 0.0, [])
        makespan = max(e.time for e in self.timeline)
        gen_starts = self._gen_starts()
        # the first delta absorbs the kernel builds, so demand a third
        # start; with fewer, average over the timeline's span
        if len(gen_starts) >= 3:
            iter_time = gen_starts[-1] - gen_starts[-2]
        else:
            times = [e.time for e in self.timeline]
            iter_time = (max(times) - min(times)) / max(self._iter, 1)
        iter_time = max(iter_time, 1e-9)
        return SimResult(iter_time, makespan, self._samples / iter_time,
                         sorted(self.timeline, key=lambda e: e.time))

    def realized_plan(self) -> Plan:
        """The plan as the host actually executed it after folding: each
        task's parallelization shrinks to its folded device count — tp to
        ``gcd(tp, n)``, pp collapses to 1, dp takes the rest — and the
        assignment keeps one representative plan id per real device, so
        the cost model prices the submeshes that really ran.  Identical
        to ``plan`` when the host has every planned device.  Layer/batch
        splits are dropped (they describe the planned pp/dp)."""
        parallel: Dict[int, tuple] = {}
        assignment: Dict[int, np.ndarray] = {}
        for t, pl in self.placements.items():
            reps = list(pl.rep_plan_devices) or \
                [int(self.plan.assignment[t].reshape(-1)[0])]
            n = len(reps)
            tp_eff = math.gcd(pl.tp, n)
            parallel[t] = (n // tp_eff, 1, tp_eff)
            assignment[t] = np.array(reps, dtype=int).reshape(
                n // tp_eff, 1, tp_eff)
        return dataclasses.replace(self.plan, parallel=parallel,
                                   assignment=assignment,
                                   layers_per_stage={}, batch_fraction={})

    def compare_with_simulator(self, cost_model: Optional[CostModel] = None,
                               n_iterations: Optional[int] = None
                               ) -> Dict[str, float]:
        """Fig-7 style: measured iteration time vs the cost model's
        event-driven prediction for the same (wf, plan) on `topo`.

        When gcd-folding shrank a task's parallelization (the host has
        fewer devices than the plan assumed), the planned-plan prediction
        prices submeshes that never ran; the ``*_realized`` keys re-price
        against ``realized_plan()`` so the parity figure accounts for the
        realized tp/dp."""
        if self.topo is None:
            raise ValueError("engine was built without a Topology")
        n_it = n_iterations or max(self._iter, 4)
        sim = simulate(self.topo, self.wf, self.plan,
                       n_iterations=n_it, cost_model=cost_model)
        meas = self.measured_result()
        out = {"measured_iter_s": meas.iteration_time,
               "predicted_iter_s": sim.iteration_time,
               "ratio": meas.iteration_time / sim.iteration_time,
               "measured_makespan_s": meas.makespan,
               "predicted_makespan_s": sim.makespan,
               "epoch": float(self.ctx.epoch)}
        rplan = self.realized_plan()
        shrunk = any(rplan.parallel[t] != tuple(self.plan.parallel[t])
                     for t in rplan.parallel)
        out["tp_shrunk"] = float(shrunk)
        if shrunk and rplan.fits_topology(self.topo):
            rsim = simulate(self.topo, self.wf, rplan,
                            n_iterations=n_it, cost_model=cost_model)
            out["predicted_iter_realized_s"] = rsim.iteration_time
            out["ratio_realized"] = \
                meas.iteration_time / rsim.iteration_time
        else:
            out["predicted_iter_realized_s"] = sim.iteration_time
            out["ratio_realized"] = out["ratio"]
        return out

    def epoch_report(self, cost_model: Optional[CostModel] = None
                     ) -> List[Dict[str, float]]:
        """Per plan-epoch measured-vs-predicted iteration time, in the
        reference's row format: one row, since the port runs one plan
        epoch (measured from the last two gen starts, predicted by
        simulating the plan on its topology)."""
        ctx = self.ctx
        starts = self._gen_starts()
        measured = float("nan")
        if len(starts) >= 2:
            measured = starts[-1] - starts[-2]
        predicted = float("nan")
        if ctx.topo is not None and ctx.plan.fits_topology(ctx.topo):
            predicted = simulate(
                ctx.topo, self.wf, ctx.plan,
                n_iterations=max(len(starts), 4),
                cost_model=cost_model).iteration_time
        return [{"epoch": ctx.epoch, "iterations": len(starts),
                 "measured_iter_s": measured,
                 "predicted_iter_s": predicted,
                 "ratio": measured / predicted
                 if predicted and np.isfinite(predicted)
                 else float("nan")}]
