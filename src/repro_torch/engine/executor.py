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

Plan epochs (§6 online redeployment): everything the engine derives from
the scheduler's ``Plan`` lives in a swappable ``PlanContext``; a running
session swaps plans at an iteration boundary through ``apply_plan`` —
trainer/optimizer state is untouched, a weight-migration event priced by
``core.redeploy.transition_cost`` is replayed onto the timeline, and all
subsequent events carry the new plan epoch so steady-state estimates
never straddle a swap.  On one card every plan's groups fold onto it, so
a swap moves no weights; the new context's folding records the
collisions.

Fault hardening, as the reference: an attached ``faults.FaultInjector``
raises its scheduled faults before each task attempt and dilates the
replayed durations, transient failures retry under ``core.retry``, a
failure beyond the budget (or a permanent one) raises
``TaskExecutionError``, calibrated per-task deadlines count misses, and
an attached ``obs.calibrate.DivergenceMonitor`` sees every iteration's
measured against predicted task times.

Port of ``repro.engine.executor``.  A task's measured duration ends at a
CUDA event recorded on the current stream after the task and waited on
(``device.wait_for``), and the weight sync ends at a device synchronize,
so the ``Event`` timeline times the card's work, not the launch queue
(both are no-ops on the CPU).  In a world of one rank, lanes of disjoint
plan groups run in threads; on one card they share its stream, so a
lane's wait also covers the other lane's earlier work — the folding's
collision flags (every group collides on one card) mark those events.
A stage waits for every lane before it raises, so a fault in one lane
is never lost behind another's.

Sharded execution (a ``parallel.dist`` world: one process per device,
every rank running this engine, SPMD): the plan folds onto the world's
ranks, each rank runs the tasks whose placement holds it and skips the
others, and after each stage the lead rank of each task's group
broadcasts what the task wrote to ``bb`` (rollouts, log-probs, values,
scores, metrics) as host arrays (``_exchange``); the measured durations
are all-gathered before the replay, so every rank replays the same
``Event`` timeline.  ``overlap_active`` (asynchronous, and the GEN
ranks disjoint from every other task's) switches to the SPMD form of the
reference's overlapped walk: the GEN ranks decode iteration t+1 while
the other ranks train on t's bundle — the two lanes are different
processes, so the overlap is real — and the bundle, the metrics and the
weights cross at the iteration boundary.

A failure on ranks reaches every rank.  A sharded task's ranks agree
after each attempt (the worst outcome over the placement's mesh), so
they retry or stop together; a task that fails for good sends its
failure through the exchange in place of its payload, and every rank
raises the same ``TaskExecutionError`` after it, as a stage raises in a
world of one.  The overlapped walk's two sides reach the iteration
boundary whatever befell them and raise there, after both broadcasts.
What the fault injector recorded on a task's ranks travels with the
task's payload (``FaultInjector.since`` / ``absorb``), so every rank's
injector holds the world's record.  Not covered: an exception raised
inside a collective, which leaves its peers waiting in it.
"""
from __future__ import annotations

import dataclasses
import math
import threading
import time
from concurrent.futures import ThreadPoolExecutor, wait
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core import retry as retry_mod
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
from repro_torch.parallel import dist

# pseudo task id for the weight-migration event a plan swap replays onto
# the timeline (real workflow tasks are 0..n_tasks-1)
MIGRATION_TASK = -1


class TaskExecutionError(Exception):
    """A task executor failed beyond the engine's retry budget (or
    permanently).  Carries enough context for the elastic controller to
    escalate: the task, its assigned plan devices, and — for permanent
    faults — the device ids presumed dead."""

    def __init__(self, task: int, name: str, devices, attempts: int,
                 cause: BaseException, *, permanent: bool = False,
                 dead_devices=()):
        super().__init__(
            f"task {task} ({name}) failed "
            f"{'permanently' if permanent else f'after {attempts} attempts'}"
            f": {cause!r}")
        self.task = task
        self.task_name = name
        self.devices = tuple(int(d) for d in devices)
        self.attempts = attempts
        self.cause = cause
        self.permanent = permanent
        self.dead_devices = tuple(int(d) for d in dead_devices)


@dataclasses.dataclass
class EngineResult:
    metrics: Dict[str, float]
    events: List[Event]          # this iteration's replayed timeline
    iteration: int
    epoch: int = 0               # plan epoch the iteration executed under


@dataclasses.dataclass
class PlanContext:
    """Everything the engine derives from one ``Plan`` — the swappable
    unit of the plan-epoch model.  ``apply_plan`` builds a fresh context;
    nothing in it survives a swap except through the explicit transition
    (device availability is re-seeded at the migration end time)."""
    epoch: int
    plan: Plan
    topo: Optional[Topology]
    placements: Dict[int, Any]            # task -> TaskPlacement
    gen_task: int
    actor_train: int
    dev_free: Dict[int, float]            # plan-device availability (replay)
    start_iter: int = 0                   # first engine iteration in epoch
    folding: Any = None                   # placement.DeviceFolding
    # process groups of a multi-rank world: the ranks of the non-GEN
    # tasks (the overlapped walk's exchanges) and the weight sync's
    # (the training lead and the GEN ranks)
    rest_group: Any = None
    sync_group: Any = None


class Engine:
    def __init__(self, wf: RLWorkflow, plan: Plan, state,
                 *, topo: Optional[Topology] = None,
                 asynchronous: Optional[bool] = None,
                 devices: Optional[Sequence] = None,
                 overlap: Optional[bool] = None):
        self.wf = wf
        # gen/train wall-clock overlap: None = auto (on when async and
        # the GEN ranks are disjoint from the rest), False = never
        self._overlap_opt = overlap
        self.state = state
        self._devices = list(devices) if devices is not None else None
        if asynchronous is None:
            asynchronous = not wf.synchronous
        self.pipeline = AsyncPipeline(asynchronous)
        self.ctx = self._make_context(plan, topo, epoch=0, start_iter=0)
        self.ctx_history: List[PlanContext] = []   # retired epochs, oldest first
        # set when a topology drift could not be adopted because the
        # incumbent plan references dropped devices (predictions keep
        # pricing the old environment until a feasible plan lands)
        self.topology_stale = False
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
        # measured weight-sync wall-clock per trained iteration — the
        # sample obs.calibrate fits the reshard/sync coefficient from
        self.sync_durations: List[float] = []
        # optional reactive-drift hook (obs.calibrate.DivergenceMonitor)
        self.divergence_monitor = None
        self._div_cost_model = None
        self._pred_cache: Optional[tuple] = None
        # fault hardening: optional injector (faults), bounded retry for
        # transient task failures, calibrated per-task deadlines
        # (predicted × slack; post-hoc — a launched task is not
        # preempted, so a miss is a signal, not an abort)
        self.fault_injector = None
        self.task_retry = retry_mod.RetryPolicy(max_attempts=3,
                                                base_delay_s=0.02)
        self._retry_sleep = time.sleep
        self._deadline_slack: Optional[float] = None
        self._deadline_cm = None
        self._deadline_cache: Optional[tuple] = None

    # -- plan context ---------------------------------------------------
    def _make_context(self, plan: Plan, topo: Optional[Topology],
                      epoch: int, start_iter: int) -> PlanContext:
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
        # one device; rebuilt on every elastic plan swap)
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
        rest_group = sync_group = None
        if dist.multi():
            # collective: every rank creates the groups, in this order
            rest = sorted({r for t, pl in placements.items()
                           if t != gen_task for r in pl.ranks})
            rest_group = dist.new_group(rest)
            sync_group = dist.new_group(
                {placements[actor_train].lead}
                | set(placements[gen_task].ranks))
        return PlanContext(epoch, plan, topo, placements, gen_task,
                           actor_train, dev_free, start_iter,
                           folding=folding, rest_group=rest_group,
                           sync_group=sync_group)

    # back-compat accessors: the live context is authoritative
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

    def update_topology(self, topo: Topology) -> None:
        """Adopt a drifted topology *without* swapping plans (the elastic
        controller stays on the incumbent): predictions now price the new
        environment; no epoch bump, no migration, no placement rebuild.

        If the incumbent plan no longer fits the drifted topology (a
        device drop re-indexed the survivors and ``reschedule`` found no
        feasible challenger), the old topology is kept for prediction —
        simulating the incumbent on the shrunken device list would index
        out of range — and the epoch is marked unpredictable
        (``topology_stale``): ``epoch_report`` rows show it explicitly
        instead of crashing, and ``compare_with_simulator`` keeps
        pricing the environment the plan actually describes."""
        if self.ctx.plan is not None and topo is not None \
                and not self.ctx.plan.fits_topology(topo):
            self.topology_stale = True
            return
        self.topology_stale = False
        self.ctx = dataclasses.replace(self.ctx, topo=topo)

    def apply_plan(self, plan: Plan, *, topo: Optional[Topology] = None,
                   carry_pending: bool = True) -> Dict[str, float]:
        """Swap the execution plan at an iteration boundary (§6 online
        redeployment) without losing trainer/optimizer state.

        On one card every plan's groups fold onto it: the swap moves no
        weights and rebuilds the placements only.  The swap replays a
        weight-migration event priced by
        ``core.redeploy.transition_cost`` (old plan -> new plan on the
        new topology): it starts once every device of the outgoing plan
        is quiesced, occupies the transition window, and re-seeds the new
        plan's device availability at its end — so the replayed timeline
        accounts for the §6 "applied immediately after checkpointing"
        pause.  Generation additionally waits for the migrated weights
        the way it waits for a weight sync.

        The async one-step-staleness invariant is preserved explicitly:
        with ``carry_pending`` (default) the in-flight rollout bundle
        generated under the old plan is carried across the swap and
        trained next iteration (still exactly one sync behind); with
        ``carry_pending=False`` the bundle is drained and the pipeline
        refills, making the first post-swap iteration a fill iteration.

        Returns transition telemetry (seconds, epoch, migration window).
        """
        from repro_torch.core import redeploy
        old = self.ctx
        with obs_trace.span("engine.swap", iteration=self._iter,
                            epoch=old.epoch + 1) as sp:
            topo = topo if topo is not None else old.topo
            trans_s = 0.0
            if topo is not None:
                trans_s = redeploy.transition_cost(topo, self.wf, old.plan,
                                                   plan, topo_old=old.topo)
            # migration window on the replay clock: begins when the
            # outgoing plan's devices are all idle (iteration boundary +
            # in-flight sync)
            t0 = max(list(old.dev_free.values()) + [self._sync_done])
            t1 = t0 + trans_s
            new_epoch = old.epoch + 1
            # the replay window [t0, t1) is priced, not measured — the
            # host observes the swap as one instant
            wall = time.monotonic() - self._t0
            self.timeline.append(Event(t0, "start", self._iter,
                                       MIGRATION_TASK, epoch=new_epoch,
                                       t_wall=wall, span=sp.id or None))
            self.timeline.append(Event(t1, "end", self._iter,
                                       MIGRATION_TASK, epoch=new_epoch,
                                       t_wall=wall, span=sp.id or None))
            ctx = self._make_context(plan, topo, epoch=new_epoch,
                                     start_iter=self._iter)
            for d in ctx.dev_free:
                ctx.dev_free[d] = t1
            self._sync_done = max(self._sync_done, t1)
            dropped = 0
            if not carry_pending:
                dropped = int(self.pipeline.drain() is not None)
            self.ctx_history.append(old)
            self.ctx = ctx
            self.topology_stale = False  # the new plan fits its topology
            sp.set("transition_cost_s", trans_s)
        obs_metrics.counter("engine.swaps").inc()
        obs_metrics.gauge("engine.plan_epoch").set(new_epoch)
        return {"transition_cost_s": trans_s, "epoch": float(new_epoch),
                "migration_start_s": t0, "migration_end_s": t1,
                "dropped_bundles": float(dropped)}

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
                   meta: Dict[int, tuple], group=None,
                   exchange: bool = True) -> Dict[int, dict]:
        """Run a stage's tasks.  In a multi-rank world this rank runs the
        tasks of its placements, in lane order, and then (``exchange``)
        every rank of ``group`` (the world when None) takes part in the
        exchange of what each task wrote; returns what this rank's tasks
        wrote."""
        inj = self.fault_injector

        def attempt_task(t, fn, attempt):
            pl = self.placements[t]
            err = None
            try:
                if inj is not None:
                    inj.before_task(t, attempt)
                out = fn(self.state, bb, pl)
                if out is not None:
                    wait_for(out)
            except Exception as e:
                err = e
            if pl.sharded:
                # the group's ranks agree on the attempt's outcome, so
                # that none retries (or goes on) alone
                worst = _agree(pl, _severity(err))
                if err is None and worst:
                    err = _peer_failed(worst)
            if err is not None:
                raise err

        def run_lane(lane: List[int]) -> None:
            for t in lane:
                task = self.wf.task(t)
                fn = tasks_mod.executor_for(task)
                devs = [int(d) for d in self.plan.assignment[t].reshape(-1)]
                pl = self.placements[t]
                mesh_attr = "x".join(str(s) for s in pl.mesh_shape) + "@" \
                    + ",".join(str(getattr(d, "id", d))
                               for d in pl.local_devices)
                with obs_trace.span(f"task.{task.name}", task=t,
                                    iteration=self._iter,
                                    epoch=self.ctx.epoch,
                                    mesh=mesh_attr) as sp:
                    t0 = time.monotonic()
                    try:
                        retry_mod.retry_call(
                            lambda a, t=t, fn=fn: attempt_task(t, fn, a),
                            policy=self.task_retry,
                            on_retry=lambda a, e, t=t, sp=sp:
                                self._on_task_retry(t, a, e, sp),
                            sleep=self._retry_sleep)
                    except retry_mod.RetryExhausted as e:
                        obs_metrics.counter("engine.task_failures").inc()
                        sp.set("failed", True)
                        raise TaskExecutionError(
                            t, task.name, devs, e.attempts, e.last) from e
                    except retry_mod.PermanentError as e:
                        obs_metrics.counter("engine.task_failures").inc()
                        sp.set("failed", True)
                        raise TaskExecutionError(
                            t, task.name, devs, 1, e, permanent=True,
                            dead_devices=getattr(e, "devices", ())) from e
                    t1 = time.monotonic()
                dur = t1 - t0
                if inj is not None:
                    # undeclared degradations stretch the replay clock,
                    # never the host clock — this is what the divergence
                    # monitor "measures"
                    dur *= inj.dilation(t)
                durations[t] = dur
                meta[t] = (t0 - self._t0, sp.id)
                deadline = self._task_deadline(t)
                if deadline is not None and dur > deadline:
                    obs_metrics.counter("engine.deadline_misses").inc()
                    sp.set("deadline_s", deadline)
                    sp.set("deadline_exceeded", True)

        lanes = self._lanes(stage)
        if dist.multi():
            # a task that fails here ends its lane (as a lane thread ends
            # in a world of one) and its failure travels in place of its
            # payload; every rank raises after the exchange
            payloads = {}
            for lane in lanes:
                for t in lane:
                    if not self.placements[t].here:
                        continue
                    before = (set(bb), dict(bb["metrics"]))
                    mark = inj.mark() if inj is not None else None
                    try:
                        run_lane([t])
                        payloads[t] = _written(bb, before)
                    except Exception as e:      # carried to every rank
                        payloads[t] = {"failure": _failure_fields(e)}
                    if inj is not None:
                        payloads[t]["faults"] = inj.since(mark)
                    if "failure" in payloads[t]:
                        break
            if exchange:
                failures, _ = self._exchange(bb, stage, payloads, group)
                if failures:
                    raise _failure_error(failures)
            return payloads
        if len(lanes) == 1:
            run_lane(lanes[0])
            return {}
        with ThreadPoolExecutor(max_workers=len(lanes)) as pool:
            futs = [pool.submit(run_lane, lane) for lane in lanes]
            wait(futs)
        # every lane has ended: raise the first failure in lane order, the
        # others noted on it (none is left unread in a future)
        errors = [f.exception() for f in futs if f.exception() is not None]
        if errors:
            for other in errors[1:]:
                errors[0].add_note(f"another lane of this stage also "
                                   f"failed: {other!r}")
            raise errors[0]
        return {}

    def _exchange(self, bb: Dict[str, Any], tasks: Sequence[int],
                  payloads: Dict[int, dict], group=None):
        """What each task wrote to ``bb``, from its group's lead rank to
        every rank of ``group`` (the world when None), as host arrays:
        the counterpart of the reference's ``multidev`` host pulls.  A
        task that failed sends its failure instead (one that its lane's
        failure skipped, nothing); what the fault injector recorded on
        the task's ranks reaches the others.  Returns (the failures in
        lane order, the injector's records of the tasks)."""
        me = dist.rank()
        inj = self.fault_injector
        lane_of = {t: i for i, lane in enumerate(self._lanes(tasks))
                   for t in lane}
        failures, faults = [], []
        for t in sorted(tasks):
            pl = self.placements[t]
            got = dist.broadcast_object(
                dist.to_host(payloads.get(t, {"skipped": True}))
                if me == pl.lead else None, pl.lead, group)
            if "faults" in got:
                faults.append(got["faults"])
                if inj is not None and not pl.here:
                    inj.absorb(got["faults"])
            if "failure" in got:
                failures.append((lane_of[t], got["failure"]))
            elif "bb" in got and me != pl.lead:
                bb.update(dist.to_device(got["bb"], self.state.device))
                bb["metrics"].update(got["metrics"])
        return [f for _, f in sorted(failures, key=lambda x: x[0])], faults

    def _gather_timing(self, durations: Dict[int, float],
                       meta: Dict[int, tuple], sync_dur: float):
        """Every rank's measured durations -> each task's from its lead
        rank (the same on every rank); the sync's is the slowest rank's."""
        recs = dist.all_gather_object((dict(durations), dict(meta),
                                       sync_dur))
        out_d, out_m = {}, {}
        for t, pl in self.placements.items():
            d, m, _ = recs[pl.lead]
            if t in d:
                out_d[t] = d[t]
                out_m[t] = meta.get(t, m.get(t))
        return out_d, out_m, max(r[2] for r in recs)

    # -- measured-timeline replay --------------------------------------
    def _replay_iteration(self, durations: Dict[int, float],
                          sync_dur: float, trained: bool,
                          meta: Optional[Dict[int, tuple]] = None
                          ) -> List[Event]:
        """Replay measured durations through the simulator's scheduling
        rules on the plan's device ids (same event ordering semantics).
        ``meta`` carries each task's host wall-clock start (relative to
        engine construction) and obs.trace span id, stamped onto the
        replayed events for calibration/trace correlation.  In a
        multi-rank world every rank replays the gathered durations."""
        if dist.multi():
            durations, meta, sync_dur = self._gather_timing(
                durations, meta or {}, sync_dur)
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

    # -- fault hardening -------------------------------------------------
    def attach_fault_injector(self, injector) -> None:
        """Bind a ``faults.FaultInjector`` to this engine: it is
        clocked at the top of every ``run_iteration``, consulted before
        each task attempt (raising injected faults), and its dilation
        stretches measured durations on the replay timeline."""
        self.fault_injector = injector.bind(self)

    def set_task_retry(self, policy, *, sleep=None) -> None:
        """Override the transient-failure retry policy (and, for tests,
        the backoff sleep)."""
        self.task_retry = policy
        if sleep is not None:
            self._retry_sleep = sleep

    def set_task_deadlines(self, cost_model=None, *,
                           slack: float = 3.0) -> None:
        """Arm per-task deadlines at predicted × ``slack``.  Only
        meaningful with a calibrated model (``obs.calibrate.Calibration``
        or a ``CostModel`` built from one) — the uncalibrated analytical
        model is orders of magnitude off wall clock.  Misses are counted
        (``engine.deadline_misses``) and stamped on the task span; the
        task is never aborted (a launched task is not preempted)."""
        self._deadline_slack = slack
        self._deadline_cm = cost_model
        self._deadline_cache = None

    def _task_deadline(self, t: int) -> Optional[float]:
        if self._deadline_slack is None or self.topo is None \
                or self.topology_stale:
            return None
        if self._deadline_cache is None \
                or self._deadline_cache[0] != self.ctx.epoch:
            src = self._deadline_cm
            if src is None:
                return None
            cm = src.cost_model(self.topo, self.wf) \
                if hasattr(src, "cost_model") else src
            self._deadline_cache = (
                self.ctx.epoch,
                {tt: cm.task_cost(self.plan, tt).total
                 * self._deadline_slack
                 for tt in range(self.wf.n_tasks)})
        return self._deadline_cache[1].get(t)

    def _on_task_retry(self, t: int, attempt: int,
                       exc: BaseException, sp) -> None:
        obs_metrics.counter("engine.task_retries").inc()
        sp.set("retries", attempt + 1)
        sp.set("retry_error", type(exc).__name__)

    # -- one iteration --------------------------------------------------
    def run_iteration(self, prompts, answers, rng) -> EngineResult:
        t_iter0 = time.monotonic()
        if self.fault_injector is not None:
            self.fault_injector.begin_iteration(self._iter)
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
        self._observe_divergence(result)
        return result

    def overlap_active(self) -> bool:
        """Whether this epoch runs generation wall-clock concurrent with
        the inference/training stages: asynchronous pipeline and the GEN
        ranks disjoint from every other task's (which a collision-free
        group-aware folding guarantees for disjoint plan groups).  Only
        a multi-rank world has disjoint ranks: in a world of one every
        task folds onto its one device and the stage walk serializes,
        which is the honest execution there."""
        if self._overlap_opt is False or not self.pipeline.asynchronous:
            return False
        ctx = self.ctx
        gen = set(ctx.placements[ctx.gen_task].local_devices)
        rest = {d for t, pl in ctx.placements.items()
                if t != ctx.gen_task for d in pl.local_devices}
        return bool(rest) and not (gen & rest)

    def _run_iteration(self, prompts, answers, rng) -> EngineResult:
        bb: Dict[str, Any] = {"lock": threading.Lock(), "metrics": {}}
        if self.fault_injector is not None:
            bb["fault"] = self.fault_injector
        bb.update(self.state.prepare_inputs(prompts, answers, rng))
        self._samples = int(bb["prompts_rep"].shape[0])
        durations: Dict[int, float] = {}
        meta: Dict[int, tuple] = {}
        before_stage = getattr(self.state, "before_stage", None)
        if self.overlap_active():
            bundle = self._run_stages_overlapped(bb, durations, meta,
                                                 before_stage)
            if bundle is None:
                events = self._replay_iteration(durations, 0.0,
                                                trained=False, meta=meta)
                return EngineResult(self.state.fill_metrics(), events,
                                    self._iter - 1, self.ctx.epoch)
        else:
            for stage in self.wf.stages():
                has_gen = any(self.wf.task(t).kind == TaskKind.GEN
                              for t in stage)
                if before_stage is not None:
                    # shared cross-task prep (e.g. advantages) runs
                    # outside the per-task timers so lane measurements
                    # stay honest
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
                self.placements[self._actor_train],
                group=self.ctx.sync_group)
            synchronize(self.state.device if dist.multi() else
                        self.placements[self._gen_task].local_devices[0])
        sync_dur = time.monotonic() - t0
        self.sync_durations.append(sync_dur)
        obs_metrics.histogram("engine.sync_s").observe(sync_dur)
        metrics = dict(bb["metrics"])
        metrics["sync_gb"] = nbytes / 1e9
        events = self._replay_iteration(durations, sync_dur, trained=True,
                                        meta=meta)
        return EngineResult(metrics, events, self._iter - 1, self.ctx.epoch)

    def _run_stages_overlapped(self, bb: Dict[str, Any],
                               durations: Dict[int, float],
                               meta: Dict[int, tuple],
                               before_stage) -> Optional[Dict[str, Any]]:
        """Disjoint-group execution, SPMD: the GEN ranks decode iteration
        t+1's rollouts while the other ranks run the INF/TRAIN stages on
        iteration t's bundle (their exchanges stay within the rest
        group) — the async pipeline's one-step staleness realized as
        wall-clock overlap of different processes.  At the boundary the
        GEN lead broadcasts the fresh bundle and the training lead the
        iteration's metrics to every rank.  Returns the bundle trained
        on (None on the pipeline-fill iteration).

        Safe because overlap_active() guarantees disjoint rank sets and
        the weight sync at the end of the previous iteration gave the
        GEN ranks their own copy of the weights."""
        stages = self.wf.stages()
        gen_tasks = [t for stage in stages for t in stage
                     if self.wf.task(t).kind == TaskKind.GEN]
        rest_stages = [[t for t in stage
                        if self.wf.task(t).kind != TaskKind.GEN]
                       for stage in stages]
        # take the pending bundle *before* generation pushes a new one
        bundle = self.pipeline.drain()
        if bundle is not None:
            bb["bundle"] = bundle
            self.pipeline.record(self._iter, bundle,
                                 self.state.weight_version)
        gen_pl = self.placements[self._gen_task]
        payloads: Dict[int, dict] = {}
        rest = {"failures": [], "faults": []}
        if gen_pl.here:
            with obs_trace.span("engine.stage", tasks=len(gen_tasks),
                                overlapped=True):
                payloads = self._run_stage(gen_tasks, bb, durations, meta,
                                           exchange=False)
        elif bundle is not None:
            for stage in rest_stages:
                if not stage:
                    continue
                if before_stage is not None:
                    before_stage([self.wf.task(t) for t in stage], bb)
                with obs_trace.span("engine.stage", tasks=len(stage),
                                    overlapped=True):
                    got = self._run_stage(stage, bb, durations, meta,
                                          exchange=False)
                    failures, faults = self._exchange(
                        bb, stage, got, self.ctx.rest_group)
                rest["faults"] += faults
                if failures:
                    rest["failures"] = failures
                    break
        # the iteration boundary, which both sides reach whatever befell
        # them: the GEN lead's payload (the fresh bundle, or GEN's
        # failure) to every rank, then the training lead's outcome (the
        # trained bundle's metrics, or the rest stages' failures, and
        # what the injector recorded there); then every rank raises alike
        failures, _ = self._exchange(bb, [self._gen_task], payloads)
        if bundle is not None:
            lead = self.placements[self._actor_train].lead
            me = dist.rank()
            got = dist.broadcast_object(
                {**rest, "metrics": dict(bb["metrics"])} if me == lead
                else None, lead)
            bb["metrics"].update(got["metrics"])
            if self.fault_injector is not None and me in gen_pl.ranks:
                for delta in got["faults"]:
                    self.fault_injector.absorb(delta)
            failures += got["failures"]
        if "fresh" in bb:
            self._record_gen_stats(bb)
            self.pipeline.push(bb.pop("fresh"))
        if failures:
            raise _failure_error(failures)
        return bundle

    # -- reactive drift hook ---------------------------------------------
    def attach_divergence_monitor(self, monitor,
                                  cost_model=None) -> None:
        """Feed every iteration's measured vs predicted task durations
        into an ``obs.calibrate.DivergenceMonitor``.  ``cost_model`` may
        be a ``CostModel`` instance or an ``obs.calibrate.Calibration``
        (rebuilt against the live topology at each plan epoch); omitted,
        the uncalibrated analytical model is used — only meaningful if
        the monitor's threshold accounts for the wall-clock offset."""
        self.divergence_monitor = monitor
        self._div_cost_model = cost_model
        self._pred_cache = None

    def _observe_divergence(self, result: EngineResult) -> None:
        mon = self.divergence_monitor
        if mon is None or self.topo is None or self.topology_stale:
            return
        if self._pred_cache is None \
                or self._pred_cache[0] != self.ctx.epoch:
            src = self._div_cost_model
            if src is None:
                cm = CostModel(self.topo, self.wf)
            elif hasattr(src, "cost_model"):     # a Calibration
                cm = src.cost_model(self.topo, self.wf)
            else:
                cm = src
            self._pred_cache = (
                self.ctx.epoch,
                {t: cm.task_cost(self.plan, t).total
                 for t in range(self.wf.n_tasks)})
        starts: Dict[int, float] = {}
        measured: Dict[int, float] = {}
        for e in result.events:
            if e.task < 0:
                continue
            if e.kind == "start":
                starts[e.task] = e.time
            elif e.kind == "end" and e.task in starts:
                measured[e.task] = e.time - starts.pop(e.task)
        mon.observe_iteration(measured, self._pred_cache[1])

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
    def _epoch_gen_starts(self, ctx: PlanContext) -> List[float]:
        return sorted(e.time for e in self.timeline
                      if e.task == ctx.gen_task and e.kind == "start"
                      and e.epoch == ctx.epoch)

    def measured_result(self) -> SimResult:
        """Measured timeline in the simulator's SimResult shape.

        The steady-state iteration time is derived from generation-start
        deltas *within the current plan epoch* — a swap between the last
        two generation starts would otherwise fold the migration window
        (and the old plan's cadence) into the estimate."""
        if not self.timeline:
            return SimResult(0.0, 0.0, 0.0, [])
        makespan = max(e.time for e in self.timeline)
        gen_starts = self._epoch_gen_starts(self.ctx)
        # epoch 0's first delta absorbs the kernel builds, so demand one
        # extra start there; post-swap epochs run warm
        need = 3 if self.ctx.epoch == 0 else 2
        if len(gen_starts) >= need:
            iter_time = gen_starts[-1] - gen_starts[-2]
        else:
            # too few starts for a delta: average over the live epoch's
            # own span (post-migration), never over retired epochs or
            # the migration window
            span = [e.time for e in self.timeline
                    if e.epoch == self.ctx.epoch
                    and e.task != MIGRATION_TASK]
            epoch_iters = max(self._iter - self.ctx.start_iter, 1)
            if span:
                iter_time = (max(span) - min(span)) / epoch_iters
            else:
                iter_time = makespan / max(self._iter, 1)
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
        event-driven prediction for the same (wf, plan) on `topo` —
        plan-epoch aware, so both sides describe the *current* plan.

        When gcd-folding shrank a task's parallelization (the host has
        fewer devices than the plan assumed), the planned-plan prediction
        prices submeshes that never ran; the ``*_realized`` keys re-price
        against ``realized_plan()`` so the parity figure accounts for the
        realized tp/dp."""
        if self.topo is None:
            raise ValueError("engine was built without a Topology")
        epoch_iters = self._iter - self.ctx.start_iter
        n_it = n_iterations or max(epoch_iters, 4)
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
        """Per plan-epoch measured-vs-predicted iteration time: one row
        per epoch (retired and live), each measured from gen-start deltas
        strictly inside that epoch and predicted by simulating that
        epoch's own plan on that epoch's own topology."""
        rows = []
        for ctx in self.ctx_history + [self.ctx]:
            starts = self._epoch_gen_starts(ctx)
            measured = float("nan")
            if len(starts) >= 2:
                measured = starts[-1] - starts[-2]
            predicted = float("nan")
            if ctx.topo is not None and ctx.plan.fits_topology(ctx.topo):
                predicted = simulate(
                    ctx.topo, self.wf, ctx.plan,
                    n_iterations=max(len(starts), 4),
                    cost_model=cost_model).iteration_time
            rows.append({"epoch": ctx.epoch,
                         "iterations": len(starts),
                         "measured_iter_s": measured,
                         "predicted_iter_s": predicted,
                         "ratio": measured / predicted
                         if predicted and np.isfinite(predicted)
                         else float("nan")})
        return rows


class _Reported(Exception):
    """An exception as the rank that raised it reported it: its repr."""

    def __init__(self, text: str):
        super().__init__(text)
        self.text = text

    def __repr__(self) -> str:
        return self.text


def _severity(err: Optional[BaseException]) -> int:
    """0 none, 1 transient, 2 permanent, 3 any other error."""
    if err is None:
        return 0
    if isinstance(err, retry_mod.TransientError):
        return 1
    return 2 if isinstance(err, retry_mod.PermanentError) else 3


def _agree(placement, severity: int) -> int:
    """The worst severity over the placement's ranks (every rank of its
    mesh calls it)."""
    import torch
    x = torch.tensor([severity], dtype=torch.int64)
    mesh = placement.mesh
    for d in range(mesh.ndim):
        torch.distributed.all_reduce(x, op=torch.distributed.ReduceOp.MAX,
                                     group=mesh.get_group(d))
    return int(x.item())


def _peer_failed(severity: int) -> BaseException:
    """What a rank whose attempt went through raises when a peer's
    failed: the same kind, so that the group retries or stops together."""
    msg = "the attempt failed on another rank of the task's group"
    if severity == 1:
        return retry_mod.TransientError(msg)
    if severity == 2:
        return retry_mod.PermanentError(msg)
    return RuntimeError(msg)


def _failure_fields(e: BaseException) -> dict:
    """A task's failure as host values every rank can rebuild it from."""
    if isinstance(e, TaskExecutionError):
        return {"task": e.task, "name": e.task_name, "devices": e.devices,
                "attempts": e.attempts, "cause": repr(e.cause),
                "permanent": e.permanent, "dead_devices": e.dead_devices}
    return {"error": repr(e), "rank": dist.rank()}


def _failure_error(failures: List[dict]) -> Exception:
    """The first failure (in lane order) as every rank raises it, the
    others noted on it, as a stage raises in a world of one."""
    errs = []
    for f in failures:
        if "error" in f:
            errs.append(RuntimeError(f"rank {f['rank']}: {f['error']}"))
        else:
            errs.append(TaskExecutionError(
                f["task"], f["name"], f["devices"], f["attempts"],
                _Reported(f["cause"]), permanent=f["permanent"],
                dead_devices=f["dead_devices"]))
    for other in errs[1:]:
        errs[0].add_note(f"another lane of this stage also failed: "
                         f"{other!r}")
    return errs[0]


def _written(bb: Dict[str, Any], before) -> dict:
    """What a task wrote to ``bb`` since ``before`` = (keys, metrics):
    its new keys and its new or changed metrics."""
    keys, metrics = before
    return {"bb": {k: v for k, v in bb.items()
                   if k not in keys and k != "lock"},
            "metrics": {k: v for k, v in bb["metrics"].items()
                        if k not in metrics or metrics[k] != v}}
