"""Cost-model calibration from measured ``Event`` timelines + the
reactive-drift divergence monitor (HetRL §4.1 profiling, §6 loop).

The analytical ``core.costmodel.CostModel`` prices the *declared*
topology — fictional A100/L4/TPU specs — while execution folds every
plan device onto the local host, so raw measured-vs-predicted iteration
ratios sit at ~10⁴–10⁵×: internally consistent (plans rank correctly)
but not in wall-clock units.  Calibration closes the gap the way the
paper's profiler does — measure a few real task executions per device
class, fit one scale factor per class (geometric mean of
measured/predicted per-task ratios), and return a
``CalibratedCostModel`` that plugs straight into ``simulate`` /
``Engine.compare_with_simulator(cost_model=...)``.

``DivergenceMonitor`` consumes per-iteration (measured, predicted) task
durations and flags tasks whose EWMA log-ratio stays beyond a threshold
for ``sustain`` consecutive iterations — the reactive topology-drift
signal ``engine.elastic`` can poll instead of (or alongside) a declared
``DriftSchedule``.

Port of ``repro.obs.calibrate``; the local microbench behind
``measure_local`` (``core.profiler``) times torch work on a device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.costmodel import CostModel, TaskCost
from repro_torch.core.plan import Plan
from repro_torch.core.topology import Topology
from repro_torch.core.workflow import RLWorkflow

from repro_torch.obs import metrics

# pseudo-task id plan swaps replay (engine.executor.MIGRATION_TASK);
# excluded from fitting — migrations are priced by transition_cost, not
# task_cost
_MIGRATION_TASK = -1


# ---------------------------------------------------------------------------
# Measured durations out of an Event timeline
# ---------------------------------------------------------------------------

def measured_task_durations(timeline: Sequence,
                            ) -> Dict[Tuple[int, int], float]:
    """Per-(iteration, task) durations from matched start/end events.

    Replayed engine timelines and simulated timelines share the
    ``Event`` dataclass, so this works on either; migration
    pseudo-events are skipped."""
    starts: Dict[Tuple[int, int, int], float] = {}
    out: Dict[Tuple[int, int], float] = {}
    for e in timeline:
        if e.task == _MIGRATION_TASK:
            continue
        key = (e.iteration, e.task, e.epoch)
        if e.kind == "start":
            starts[key] = e.time
        elif e.kind == "end" and key in starts:
            out[(e.iteration, e.task)] = e.time - starts.pop(key)
    return out


def _geomean(vals: Sequence[float]) -> float:
    vals = [v for v in vals if v > 0]
    if not vals:
        return 1.0
    return math.exp(sum(math.log(v) for v in vals) / len(vals))


# ---------------------------------------------------------------------------
# Calibration fit
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Calibration:
    """Per-device-class scale factors measured / predicted.

    ``scale_for(cls)`` falls back to the global scale for classes never
    measured (every class folds onto the same local host here, so the
    global geomean is the right prior)."""
    class_scale: Dict[str, float]
    global_scale: float
    sync_scale: float
    n_samples: int
    local_tflops: float = 0.0
    local_hbm_gbps: float = 0.0
    # per-coefficient fit (opt-in): device class -> separate scale
    # factors for the compute, communication and HBM components of a
    # task cost; absent classes fall back to the uniform class scale
    class_coeff: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)

    def scale_for(self, device_class: str) -> float:
        return self.class_scale.get(device_class, self.global_scale)

    def coeff_for(self, device_class: str) -> Dict[str, float]:
        """(comp, comm, hbm) scale factors for a class — the
        per-coefficient fit when one exists, else the uniform class
        scale applied to all three."""
        c = self.class_coeff.get(device_class)
        if c:
            return c
        s = self.scale_for(device_class)
        return {"comp": s, "comm": s, "hbm": s}

    def cost_model(self, topo: Topology, wf: RLWorkflow
                   ) -> "CalibratedCostModel":
        return CalibratedCostModel(topo, wf, self)

    def to_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)

    def publish_metrics(self) -> None:
        for cls, s in self.class_scale.items():
            metrics.gauge(f"calib.scale.{cls}").set(s)
        for cls, c in self.class_coeff.items():
            for name, s in c.items():
                metrics.gauge(f"calib.coeff.{cls}.{name}").set(s)
        metrics.gauge("calib.global_scale").set(self.global_scale)
        metrics.gauge("calib.sync_scale").set(self.sync_scale)
        if self.local_tflops:
            metrics.gauge("calib.local_tflops").set(self.local_tflops)
        if self.local_hbm_gbps:
            metrics.gauge("calib.local_hbm_gbps").set(self.local_hbm_gbps)


def device_class_of(topo: Topology, plan: Plan, t: int) -> str:
    """Device class a task's measurement calibrates: the spec name of
    its first assigned device (groups are homogeneous in the testbeds;
    mixed groups calibrate their leading device's class)."""
    d = int(plan.assignment[t].reshape(-1)[0])
    return topo.devices[d].spec.name


def fit_calibration(topo: Topology, wf: RLWorkflow, plan: Plan,
                    timeline: Sequence, *, skip_iterations: int = 1,
                    sync_s: Optional[Sequence[float]] = None,
                    measure_local: bool = False,
                    per_coefficient: bool = False,
                    device=None) -> Calibration:
    """Fit per-device-class scales from a measured timeline.

    ``skip_iterations`` drops the first iterations (jit compilation
    dominates them); ``sync_s`` is the engine's measured weight-sync
    durations, fitting the reshard/sync coefficient separately;
    ``measure_local=True`` additionally microbenches the local device
    (matmul TFLOP/s + HBM GB/s via ``core.profiler``) and records the
    numbers on the result — the ground truth a physical deployment
    would feed per-class into ``GPUSpec`` directly.  ``device`` is the
    one microbenched (``cuda`` when None).

    ``per_coefficient=True`` additionally fits *separate* comp / comm /
    HBM scale factors per class (nonnegative least squares of measured
    totals against the predicted component split) — one uniform scale
    cannot capture a class whose links degraded but whose FLOPs didn't.
    Classes whose observations are degenerate (all from one component
    mix, or a component never exercised) keep the uniform scale for
    the unidentifiable coefficients."""
    cm = CostModel(topo, wf)
    pred_tc = {t: cm.task_cost(plan, t) for t in range(wf.n_tasks)}
    predicted = {t: tc.total for t, tc in pred_tc.items()}
    measured = measured_task_durations(timeline)
    by_class: Dict[str, List[float]] = {}
    all_ratios: List[float] = []
    for (it, t), dur in measured.items():
        if it < skip_iterations or t not in predicted:
            continue
        pred = predicted[t]
        if pred <= 0 or dur <= 0:
            continue
        ratio = dur / pred
        by_class.setdefault(device_class_of(topo, plan, t),
                            []).append(ratio)
        all_ratios.append(ratio)
    class_scale = {cls: _geomean(rs) for cls, rs in by_class.items()}
    global_scale = _geomean(all_ratios)

    class_coeff: Dict[str, Dict[str, float]] = {}
    if per_coefficient:
        rows: Dict[str, List[Tuple[List[float], float]]] = {}
        for (it, t), dur in measured.items():
            if it < skip_iterations or t not in pred_tc or dur <= 0:
                continue
            tc = pred_tc[t]
            row = [tc.comp + tc.bubble, tc.tp + tc.pp + tc.dp, tc.hbm]
            if sum(row) <= 0:
                continue
            rows.setdefault(device_class_of(topo, plan, t),
                            []).append((row, dur))
        for cls, obs in rows.items():
            A = np.array([r for r, _ in obs], dtype=float)
            y = np.array([d for _, d in obs], dtype=float)
            coeff, *_ = np.linalg.lstsq(A, y, rcond=None)
            coeff = np.maximum(coeff, 0.0)
            if float(coeff.sum()) <= 0.0:
                continue        # degenerate: keep the uniform scale
            # a component the class never exercises (zero column)
            # carries no signal — pin it to the uniform scale
            uni = class_scale.get(cls, global_scale)
            coeff = np.where(A.sum(axis=0) <= 0.0, uni, coeff)
            class_coeff[cls] = {"comp": float(coeff[0]),
                                "comm": float(coeff[1]),
                                "hbm": float(coeff[2])}

    sync_scale = global_scale
    if sync_s:
        actor_train = _actor_train_task(wf)
        pred_sync = (cm.c_reshard(plan, actor_train) if wf.synchronous
                     else cm.c_sync(plan, actor_train, 0))
        meas = [s for s in sync_s if s > 0]
        if meas and pred_sync > 0:
            sync_scale = _geomean(meas) / pred_sync

    local_tflops = local_hbm = 0.0
    if measure_local:
        from repro_torch.core import profiler
        local_tflops = profiler.calibrate_local_device(device=device)
        local_hbm = profiler.calibrate_local_hbm(device=device)

    cal = Calibration(class_scale, global_scale, sync_scale,
                      n_samples=len(all_ratios),
                      local_tflops=local_tflops,
                      local_hbm_gbps=local_hbm,
                      class_coeff=class_coeff)
    cal.publish_metrics()
    return cal


def fit_from_engine(engine, *, skip_iterations: int = 1,
                    measure_local: bool = False,
                    per_coefficient: bool = False) -> Calibration:
    """Fit from a live engine's replayed timeline (current epoch's plan
    and topology; the engine records wall-clock sync durations)."""
    if engine.topo is None:
        raise ValueError("engine was built without a Topology")
    return fit_calibration(engine.topo, engine.wf, engine.plan,
                           engine.timeline, skip_iterations=skip_iterations,
                           sync_s=getattr(engine, "sync_durations", None),
                           measure_local=measure_local,
                           per_coefficient=per_coefficient,
                           device=getattr(engine.state, "device", None))


def _actor_train_task(wf: RLWorkflow) -> int:
    from repro_torch.core.workflow import TaskKind
    return next(t for t in range(wf.n_tasks)
                if wf.task(t).kind == TaskKind.TRAIN
                and wf.task(t).name.startswith("actor"))


class CalibratedCostModel(CostModel):
    """CostModel with measured per-device-class scale factors applied.

    Drop-in for every ``cost_model=`` parameter (``simulate``,
    ``Engine.compare_with_simulator``, ``Engine.epoch_report``): task
    costs scale by their device class's factor, reshard/sync by the
    separately fitted sync scale."""

    def __init__(self, topo: Topology, wf: RLWorkflow,
                 calibration: Calibration):
        super().__init__(topo, wf)
        self.calibration = calibration

    def task_cost(self, plan: Plan, t: int) -> TaskCost:
        tc = super().task_cost(plan, t)
        cls = device_class_of(self.topo, plan, t)
        if cls in self.calibration.class_coeff:
            c = self.calibration.class_coeff[cls]
            out = TaskCost(total=0.0, comp=tc.comp * c["comp"],
                           tp=tc.tp * c["comm"], pp=tc.pp * c["comm"],
                           dp=tc.dp * c["comm"], hbm=tc.hbm * c["hbm"],
                           bubble=tc.bubble * c["comp"])
            out.total = (out.comp + out.tp + out.pp + out.dp
                         + out.hbm + out.bubble)
            return out
        s = self.calibration.scale_for(cls)
        return TaskCost(total=tc.total * s, comp=tc.comp * s,
                        tp=tc.tp * s, pp=tc.pp * s, dp=tc.dp * s,
                        hbm=tc.hbm * s, bubble=tc.bubble * s)

    def c_reshard(self, plan: Plan, actor_train: int) -> float:
        return super().c_reshard(plan, actor_train) \
            * self.calibration.sync_scale

    def c_sync(self, plan: Plan, actor_train: int,
               actor_gen: int) -> float:
        return super().c_sync(plan, actor_train, actor_gen) \
            * self.calibration.sync_scale


# ---------------------------------------------------------------------------
# Divergence monitor (reactive drift signal)
# ---------------------------------------------------------------------------

class DivergenceMonitor:
    """Flags tasks whose measured/predicted ratio drifts and stays
    drifted.

    Per task, an EWMA of the log-ratio is kept; once ``|ewma| >
    log(threshold)`` for ``sustain`` consecutive observations the task
    is *drifted* and the monitor arms its fire latch.  ``consume()``
    reads-and-clears the latch — the elastic controller polls it once
    per iteration and treats a fire like observed topology drift
    (re-run the scheduler against reality instead of waiting for a
    declared ``DriftSchedule`` entry).

    A calibrated cost model should produce the predictions fed in:
    against uncalibrated predictions the constant 10⁴× offset saturates
    the threshold immediately and the signal is meaningless.
    """

    def __init__(self, threshold: float = 3.0, sustain: int = 3,
                 alpha: float = 0.5):
        assert threshold > 1.0 and sustain >= 1 and 0 < alpha <= 1
        self.threshold = threshold
        self.sustain = sustain
        self.alpha = alpha
        self._ewma: Dict[int, float] = {}
        self._streak: Dict[int, int] = {}
        self._drifted: Dict[int, bool] = {}
        self._fired = False
        self.fire_count = 0

    def observe(self, task: int, measured_s: float,
                predicted_s: float) -> bool:
        """Feed one task measurement; returns True when this observation
        newly pushed the task into the drifted state."""
        if measured_s <= 0 or predicted_s <= 0:
            return False
        lr = math.log(measured_s / predicted_s)
        prev = self._ewma.get(task)
        ewma = lr if prev is None \
            else self.alpha * lr + (1 - self.alpha) * prev
        self._ewma[task] = ewma
        if abs(ewma) > math.log(self.threshold):
            self._streak[task] = self._streak.get(task, 0) + 1
        else:
            self._streak[task] = 0
            self._drifted[task] = False
        newly = (self._streak[task] >= self.sustain
                 and not self._drifted.get(task, False))
        if newly:
            self._drifted[task] = True
            self._fired = True
            self.fire_count += 1
            metrics.counter("elastic.drift_events").inc()
        return newly

    def observe_iteration(self, measured: Dict[int, float],
                          predicted: Dict[int, float]) -> List[int]:
        """Feed a whole iteration's task durations; returns the tasks
        that newly drifted."""
        return [t for t, m in sorted(measured.items())
                if t in predicted and self.observe(t, m, predicted[t])]

    def drifted_tasks(self) -> List[int]:
        return sorted(t for t, d in self._drifted.items() if d)

    def ratio(self, task: int) -> float:
        """Current EWMA measured/predicted ratio for a task (1.0 when
        unobserved)."""
        return math.exp(self._ewma.get(task, 0.0))

    def consume(self) -> bool:
        """Read-and-clear the fire latch."""
        fired, self._fired = self._fired, False
        return fired


# ---------------------------------------------------------------------------
# Measured-topology inference (reactive replan target)
# ---------------------------------------------------------------------------

def infer_drifted_topology(topo: Topology, wf: RLWorkflow, plan: Plan,
                           monitor: DivergenceMonitor, *,
                           min_ratio: float = 1.5) -> Optional[Topology]:
    """Turn a fired ``DivergenceMonitor`` into the *measured* topology
    the scheduler should replan against.

    The believed topology is wrong somewhere — the monitor tells us
    which tasks run slower than predicted, and the cost model tells us
    how much of each task is communication vs compute.  Attribution per
    drifted task with EWMA ratio ``r``:

    * communication-bound drift (the task moves bytes across machines):
      assume the slowdown lives on the links.  A bandwidth scale ``f``
      satisfying ``comm / f = comm + (r - 1) * total`` (extra time goes
      to the comm term) is applied to every cross-machine link between
      the task's machines, latency scaled by ``1/f``.
    * compute-bound drift (no cross-machine communication): the task's
      device class lost throughput; its compute/HBM scales by ``1/r``.

    This is deliberately coarse — it does not recover the exact hidden
    degradation, only a topology under which the scheduler prices the
    observed slowdown and routes around it.  Returns None when nothing
    is drifted beyond ``min_ratio``."""
    from repro_torch.core import topology as topo_mod

    cm = CostModel(topo, wf)
    out = topo
    changed = False
    for t in monitor.drifted_tasks():
        r = monitor.ratio(t)
        if r < min_ratio:
            continue
        tc = cm.task_cost(plan, t)
        comm = tc.tp + tc.pp + tc.dp
        devs = [int(d) for d in plan.assignment[t].reshape(-1)]
        cross_pairs = [(a, b) for i, a in enumerate(devs)
                       for b in devs[i + 1:]
                       if topo.devices[a].machine != topo.devices[b].machine]
        if comm > 0 and cross_pairs and tc.total > 0:
            extra = (r - 1.0) * tc.total
            f = comm / (comm + extra)
            out = topo_mod.degrade_links(out, bw_factor=f,
                                         lat_factor=1.0 / f,
                                         pairs=cross_pairs)
            changed = True
        else:
            cls = device_class_of(topo, plan, t)
            out = topo_mod.scale_compute(out, 1.0 / r, device_class=cls)
            changed = True
    return out if changed else None
