"""Deterministic fault injection on the engine's iteration clock.

A ``FaultPlan`` is a seeded, sorted list of ``FaultEvent``s; a
``FaultInjector`` binds one to a running ``Engine`` and fires each event
at its iteration.  Two families:

*Undeclared degradations* (the environment silently gets worse — the
topology the scheduler believes in is deliberately NOT updated):

- ``link_throttle``   selected links lose bandwidth / gain latency.
  Measured task durations are dilated by the cost-model ratio of the
  *hidden* degraded topology over the believed one, for the live plan —
  so only tasks whose communication actually crosses the throttled
  links slow down, and a replanned placement that avoids them runs at
  full speed again.  Detection must come from the
  ``DivergenceMonitor``, exactly the ROADMAP's reactive-elasticity
  remainder.
- ``device_slowdown`` a device class loses compute/HBM throughput
  (same hidden-cost-ratio dilation).
- ``straggler``       one task dilates by a flat factor for a window.

*Hard failures* (the execution path must retry / escalate / recover):

- ``transient_crash`` a task raises ``TransientTaskFault`` on its first
  ``n_failures`` attempts of the fire iteration, then succeeds —
  exercising the engine's bounded retry.
- ``permanent_crash`` a task raises ``PermanentTaskFault`` every
  attempt; carries the device ids presumed dead so the caller can
  escalate to ``drop_devices`` → forced replan.  Cleared automatically
  once the engine moves to a new plan epoch (the replan "replaced" the
  dead worker).
- ``device_drop``     like ``permanent_crash`` but keyed on explicit
  device ids: any task scheduled on them fails permanently.
- ``slot_failure``    genserve decode slots die mid-wave at given round
  indices; the decoder requeues the in-flight requests.
- ``ckpt_fail``       checkpoint writes raise ``TransientError`` for
  the first ``n_failures`` attempts (or every attempt if
  ``n_failures < 0``), exercising elastic checkpoint retry and the
  warn-and-continue degradation.
- ``ckpt_corrupt``    the next checkpoint file written is corrupted
  in place after the write, exercising the crc32 + ``load_latest``
  fallback chain.

Every fired event appends to ``FaultInjector.log`` — the deterministic
record the fault-determinism tests compare across seeded runs.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import retry
from repro_torch.core import topology as topo_mod
from repro_torch.core.costmodel import CostModel
from repro_torch.obs import metrics as obs_metrics

FAULT_KINDS = ("link_throttle", "device_slowdown", "straggler",
               "transient_crash", "permanent_crash", "device_drop",
               "slot_failure", "ckpt_fail", "ckpt_corrupt")


class TransientTaskFault(retry.TransientError):
    """An injected task failure expected to succeed on retry."""

    def __init__(self, task: int, name: str, attempt: int):
        super().__init__(f"injected transient fault: task {task} "
                         f"({name}), attempt {attempt}")
        self.task = task
        self.task_name = name
        self.attempt = attempt


class PermanentTaskFault(retry.PermanentError):
    """An injected task failure retrying cannot fix; ``devices`` names
    the workers presumed dead (escalate to drop + replan)."""

    def __init__(self, task: int, name: str,
                 devices: Tuple[int, ...]):
        super().__init__(f"injected permanent fault: task {task} "
                         f"({name}), devices {list(devices)} presumed dead")
        self.task = task
        self.task_name = name
        self.devices = devices


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault.  ``at`` is the first engine iteration it is
    active; ``until`` the first iteration it is no longer active (None =
    forever).  Which other fields matter depends on ``kind`` (see module
    docstring)."""
    kind: str
    at: int
    until: Optional[int] = None
    task: Optional[int] = None            # crash/straggler target
    devices: Tuple[int, ...] = ()         # device_drop / permanent_crash
    device_class: Optional[str] = None    # device_slowdown
    factor: float = 1.0                   # severity (dilation / slowdown)
    bw_factor: float = 1.0                # link_throttle
    lat_factor: float = 1.0
    regions: Optional[Tuple[str, ...]] = None
    pairs: Optional[Tuple[Tuple[int, int], ...]] = None
    fraction: float = 1.0
    n_failures: int = 1                   # transient/ckpt failure count
    slot_rounds: Tuple[Tuple[int, Tuple[int, ...]], ...] = ()
    note: str = ""

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"options: {list(FAULT_KINDS)}")

    def active(self, iteration: int) -> bool:
        return self.at <= iteration and \
            (self.until is None or iteration < self.until)

    def describe(self) -> Dict[str, Any]:
        d = {"kind": self.kind, "at": self.at}
        if self.until is not None:
            d["until"] = self.until
        for k in ("task", "device_class", "note"):
            v = getattr(self, k)
            if v not in (None, ""):
                d[k] = v
        if self.devices:
            d["devices"] = list(self.devices)
        if self.kind in ("straggler", "device_slowdown"):
            d["factor"] = self.factor
        if self.kind == "link_throttle":
            d["bw_factor"] = self.bw_factor
            d["lat_factor"] = self.lat_factor
        if self.kind in ("transient_crash", "ckpt_fail"):
            d["n_failures"] = self.n_failures
        if self.slot_rounds:
            d["slot_rounds"] = [[r, list(s)] for r, s in self.slot_rounds]
        return d


@dataclasses.dataclass
class FaultPlan:
    """A deterministic, iteration-sorted fault schedule."""
    events: List[FaultEvent]
    seed: int = 0

    def __post_init__(self):
        self.events = sorted(self.events, key=lambda e: (e.at, e.kind))

    def describe(self) -> List[Dict[str, Any]]:
        return [e.describe() for e in self.events]

    @classmethod
    def generate(cls, seed: int, *, n_events: int = 3,
                 first_iteration: int = 2, every: int = 3,
                 n_tasks: int = 4, window: int = 2) -> "FaultPlan":
        """Seeded chaos mix: ``n_events`` draws over the recoverable
        fault kinds with random targets/severities.  Same seed ⇒ same
        plan, byte for byte — the determinism contract the fault tests
        pin down."""
        rng = np.random.default_rng(seed)
        kinds = ["link_throttle", "device_slowdown", "straggler",
                 "transient_crash"]
        events = []
        it = first_iteration
        for _ in range(n_events):
            kind = kinds[int(rng.integers(len(kinds)))]
            task = int(rng.integers(n_tasks))
            if kind == "link_throttle":
                events.append(FaultEvent(
                    kind, it, until=it + window,
                    bw_factor=float(rng.uniform(0.02, 0.2)),
                    lat_factor=float(rng.uniform(5.0, 20.0)),
                    fraction=float(rng.uniform(0.5, 1.0)),
                    note="chaos"))
            elif kind == "device_slowdown":
                events.append(FaultEvent(
                    kind, it, until=it + window,
                    device_class=["A100", "L4", "L40S"][
                        int(rng.integers(3))],
                    factor=float(rng.uniform(0.2, 0.6)), note="chaos"))
            elif kind == "straggler":
                events.append(FaultEvent(
                    kind, it, until=it + 1, task=task,
                    factor=float(rng.uniform(1.5, 4.0)), note="chaos"))
            else:
                events.append(FaultEvent(
                    kind, it, until=it + 1, task=task,
                    n_failures=int(rng.integers(1, 3)), note="chaos"))
            it += every
        return cls(events, seed=seed)


class FaultInjector:
    """Binds a ``FaultPlan`` to an ``Engine`` and fires its events on
    the engine's iteration clock.  All state is derived from the plan +
    the engine's public iteration/epoch counters, so two runs with the
    same seed produce the same ``log``."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.engine = None
        self.log: List[Dict[str, Any]] = []
        self._iter = -1
        self._active: List[FaultEvent] = []
        self._announced: set = set()
        self._consumed: set = set()        # permanent events already healed
        self._fired_perm: Dict[int, int] = {}  # event idx -> epoch fired in
        self._dilation_cache: Optional[tuple] = None
        self._ckpt_attempts: Dict[int, int] = {}

    # -- lifecycle -----------------------------------------------------
    def bind(self, engine) -> "FaultInjector":
        self.engine = engine
        return self

    def begin_iteration(self, iteration: int) -> None:
        """Advance the fault clock; called by the engine at the top of
        every ``run_iteration``."""
        self._iter = iteration
        epoch = self.engine.ctx.epoch if self.engine is not None else 0
        # a plan swap heals fired permanent faults: the dead worker is no
        # longer part of the plan, so the event stops firing
        for idx, fired_epoch in list(self._fired_perm.items()):
            if epoch != fired_epoch:
                self._consumed.add(idx)
                del self._fired_perm[idx]
        self._active = [e for i, e in enumerate(self.plan.events)
                        if e.active(iteration) and i not in self._consumed]
        for i, e in enumerate(self.plan.events):
            if e.active(iteration) and i not in self._announced:
                self._announced.add(i)
                self._record("activate", e)

    def _record(self, what: str, event: FaultEvent, **extra) -> None:
        entry = {"what": what, "iteration": self._iter}
        entry.update(event.describe())
        entry.update(extra)
        self.log.append(entry)
        obs_metrics.counter(f"faults.{event.kind}").inc()

    # -- hidden environment (undeclared degradations) ------------------
    def hidden_topology(self, base) -> Any:
        """The environment's TRUE topology: ``base`` with every active
        undeclared degradation applied.  The engine/scheduler never see
        this directly — it exists to price dilation and to let
        benchmarks evaluate plans against ground truth."""
        topo = base
        for e in self._active:
            if e.kind == "link_throttle":
                topo = topo_mod.degrade_links(
                    topo, bw_factor=e.bw_factor, lat_factor=e.lat_factor,
                    pairs=list(e.pairs) if e.pairs else None,
                    regions=list(e.regions) if e.regions else None,
                    fraction=e.fraction, seed=self.plan.seed)
            elif e.kind == "device_slowdown":
                topo = topo_mod.scale_compute(
                    topo, e.factor, device_class=e.device_class,
                    ids=list(e.devices) if e.devices else None)
        return topo

    def dilation(self, task: int) -> float:
        """Replay-time dilation factor (≥ 1) for ``task`` under the
        currently active undeclared degradations.  Link throttles and
        device slowdowns dilate by the cost-model ratio hidden/believed
        for the live plan (so a post-replan placement that avoids the
        damage stops dilating); stragglers dilate by their flat factor."""
        d = 1.0
        for e in self._active:
            if e.kind == "straggler" and (e.task is None or e.task == task):
                d *= max(e.factor, 1.0)
        if self.engine is None or self.engine.topo is None:
            return d
        if any(e.kind in ("link_throttle", "device_slowdown")
               for e in self._active):
            d *= self._cost_ratio(task)
        return d

    def _cost_ratio(self, task: int) -> float:
        eng = self.engine
        key = (eng.ctx.epoch,
               tuple(id(e) for e in self._active
                     if e.kind in ("link_throttle", "device_slowdown")))
        if self._dilation_cache is None or self._dilation_cache[0] != key:
            believed = eng.topo
            hidden = self.hidden_topology(believed)
            cm_b = CostModel(believed, eng.wf)
            cm_h = CostModel(hidden, eng.wf)
            ratios = {}
            for t in range(eng.wf.n_tasks):
                base = cm_b.task_cost(eng.plan, t).total
                degr = cm_h.task_cost(eng.plan, t).total
                ratios[t] = max(degr / base, 1.0) if base > 0 else 1.0
            self._dilation_cache = (key, ratios)
        return self._dilation_cache[1].get(task, 1.0)

    # -- hard failures --------------------------------------------------
    def before_task(self, task: int, attempt: int) -> None:
        """Raise the scheduled fault for ``task`` (if any) just before
        the engine runs its executor on ``attempt`` (0-based)."""
        eng = self.engine
        name = eng.wf.task(task).name if eng is not None else str(task)
        for i, e in enumerate(self.plan.events):
            if i in self._consumed or not e.active(self._iter):
                continue
            if e.kind == "transient_crash" and e.task == task:
                if attempt < e.n_failures:
                    self._record("raise_transient", e, attempt=attempt)
                    raise TransientTaskFault(task, name, attempt)
            elif e.kind == "permanent_crash" and e.task == task:
                devices = e.devices or self._default_dead_devices(task)
                self._fired_perm[i] = eng.ctx.epoch if eng else 0
                self._record("raise_permanent", e,
                             dead_devices=list(devices))
                raise PermanentTaskFault(task, name, tuple(devices))
            elif e.kind == "device_drop":
                assigned = set()
                if eng is not None:
                    assigned = {int(d) for d in
                                eng.plan.assignment[task].reshape(-1)}
                dead = tuple(sorted(assigned & set(e.devices)))
                if dead:
                    self._fired_perm[i] = eng.ctx.epoch if eng else 0
                    self._record("raise_permanent", e,
                                 dead_devices=list(dead))
                    raise PermanentTaskFault(task, name, dead)

    def _default_dead_devices(self, task: int) -> Tuple[int, ...]:
        """A permanent crash with no explicit devices kills the highest-
        id worker assigned to the task (one dead replica, the smallest
        escalation that still forces a replan)."""
        if self.engine is None:
            return ()
        devs = [int(d) for d in
                self.engine.plan.assignment[task].reshape(-1)]
        return (max(devs),) if devs else ()

    # -- genserve slot failures -----------------------------------------
    def gen_slot_failures(self) -> Optional[Dict[int, List[int]]]:
        """Decode-round -> slot-ids map for active slot_failure events
        (consumed by ``genserve.serve``); None when none are active."""
        out: Dict[int, List[int]] = {}
        for i, e in enumerate(self.plan.events):
            if e.kind != "slot_failure" or i in self._consumed \
                    or not e.active(self._iter):
                continue
            for rnd, slots in e.slot_rounds:
                out.setdefault(int(rnd), []).extend(int(s) for s in slots)
            self._consumed.add(i)          # fire once per activation
            self._record("slot_failure", e)
        return out or None

    # -- checkpoint faults ----------------------------------------------
    def maybe_fail_checkpoint(self, attempt: int) -> None:
        """Raise ``retry.TransientError`` for active ckpt_fail events:
        the first ``n_failures`` attempts fail (every attempt when
        ``n_failures < 0`` — the persistently-broken path)."""
        for i, e in enumerate(self.plan.events):
            if e.kind != "ckpt_fail" or i in self._consumed \
                    or not e.active(self._iter):
                continue
            seen = self._ckpt_attempts.get(i, 0)
            self._ckpt_attempts[i] = seen + 1
            if e.n_failures < 0 or seen < e.n_failures:
                self._record("ckpt_fail", e, attempt=attempt)
                raise retry.TransientError(
                    f"injected checkpoint write failure (attempt {attempt})")

    def maybe_corrupt_checkpoint(self, path: str) -> bool:
        """Corrupt the just-written checkpoint at ``path`` in place (one
        active ckpt_corrupt event fires once).  Returns True if the file
        was damaged."""
        import os
        for i, e in enumerate(self.plan.events):
            if e.kind != "ckpt_corrupt" or i in self._consumed \
                    or not e.active(self._iter):
                continue
            self._consumed.add(i)
            try:
                size = os.path.getsize(path)
                with open(path, "r+b") as f:
                    # flip bytes in the middle of the payload
                    f.seek(size // 2)
                    chunk = f.read(16)
                    f.seek(size // 2)
                    f.write(bytes(b ^ 0xFF for b in chunk))
            except OSError:
                return False
            self._record("ckpt_corrupt", e, path=path)
            return True
        return False

    # -- a world of ranks -------------------------------------------------
    # Every rank runs its own injector on the same plan and clock; a
    # fault fires on the ranks that run its task (or write the
    # checkpoint), and what it recorded there reaches the other ranks
    # through ``since`` / ``absorb``, so every rank's log and consumed
    # events stay those of the world.

    def mark(self) -> tuple:
        """Where this injector's record stands now (for ``since``)."""
        return (len(self.log), frozenset(self._consumed),
                dict(self._fired_perm))

    def since(self, mark: tuple) -> Dict[str, Any]:
        """What this injector recorded after ``mark``: log entries, and
        events consumed or fired."""
        n, consumed, fired = mark
        return {"log": [dict(r) for r in self.log[n:]],
                "consumed": sorted(self._consumed - consumed),
                "fired_perm": {i: ep for i, ep in self._fired_perm.items()
                               if fired.get(i) != ep}}

    def absorb(self, delta: Dict[str, Any]) -> None:
        """Take what another rank's injector recorded (``since``), and
        count it as this injector counts its own records."""
        for entry in delta["log"]:
            self.log.append(dict(entry))
            obs_metrics.counter(f"faults.{entry['kind']}").inc()
        self._consumed.update(delta["consumed"])
        self._fired_perm.update(delta["fired_perm"])

    # -- reporting -------------------------------------------------------
    def fired(self, kind: Optional[str] = None) -> List[Dict[str, Any]]:
        return [r for r in self.log
                if kind is None or r["kind"] == kind]
