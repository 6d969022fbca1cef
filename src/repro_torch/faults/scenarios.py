"""Named fault scenarios for the launcher / benchmarks / CI.

``fault_scenario(name, ...)`` returns a ``FaultPlan``; compose with a
declared ``--drift`` schedule freely — the injector only dilates /
raises, the drift schedule only feeds topologies, and both key on the
same engine iteration clock.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.topology import Topology
from repro_torch.faults.injector import FaultEvent, FaultPlan

FAULT_SCENARIOS = ["link_throttle", "device_slowdown", "straggler",
                   "transient_crash", "permanent_crash", "device_drop",
                   "slot_failure", "ckpt_fail", "ckpt_flaky",
                   "ckpt_corrupt", "chaos"]


def fault_scenario(name: str, *, at: int = 3, until: Optional[int] = None,
                   seed: int = 0, topo: Optional[Topology] = None,
                   gen_task: int = 0, train_task: int = 1,
                   n_tasks: int = 4) -> FaultPlan:
    """Build the named ``FaultPlan``:

      link_throttle   — undeclared: cross-machine links /20 bw, ×10 lat
                        from ``at`` on (detected only via divergence);
      device_slowdown — undeclared: L4-class compute/HBM ×0.3 from
                        ``at``;
      straggler       — GEN task dilates ×3 for two iterations;
      transient_crash — train task fails twice at ``at`` then succeeds
                        (bounded retry absorbs it);
      permanent_crash — train task fails every attempt at ``at``; the
                        highest-id assigned worker is presumed dead
                        (escalate: drop + forced replan);
      device_drop     — the last device dies at ``at``: any task
                        scheduled on it fails permanently;
      slot_failure    — two decode slots die at round 2 of the GEN wave
                        at iteration ``at`` (requests requeue);
      ckpt_fail       — checkpoint writes fail twice then succeed;
      ckpt_flaky      — checkpoint writes fail persistently (warn-and-
                        continue degradation);
      ckpt_corrupt    — the next checkpoint written at/after ``at`` is
                        corrupted on disk (load_latest must fall back);
      chaos           — seeded mix via ``FaultPlan.generate``.
    """
    if name == "link_throttle":
        return FaultPlan([FaultEvent(
            "link_throttle", at, until=until, bw_factor=0.05,
            lat_factor=10.0, note="undeclared cross-machine throttle")],
            seed=seed)
    if name == "device_slowdown":
        return FaultPlan([FaultEvent(
            "device_slowdown", at, until=until, device_class="L4",
            factor=0.3, note="undeclared L4 thermal throttle")], seed=seed)
    if name == "straggler":
        return FaultPlan([FaultEvent(
            "straggler", at, until=until if until is not None else at + 2,
            task=gen_task, factor=3.0, note="GEN straggler")], seed=seed)
    if name == "transient_crash":
        return FaultPlan([FaultEvent(
            "transient_crash", at, until=at + 1, task=train_task,
            n_failures=2, note="train step crashes twice")], seed=seed)
    if name == "permanent_crash":
        return FaultPlan([FaultEvent(
            "permanent_crash", at, task=train_task,
            note="train worker dies")], seed=seed)
    if name == "device_drop":
        devices = (topo.n - 1,) if topo is not None else ()
        return FaultPlan([FaultEvent(
            "device_drop", at, devices=devices,
            note=f"device {list(devices)} dies")], seed=seed)
    if name == "slot_failure":
        return FaultPlan([FaultEvent(
            "slot_failure", at, until=at + 1,
            slot_rounds=((2, (0, 1)),),
            note="two decode slots die at round 2")], seed=seed)
    if name == "ckpt_fail":
        return FaultPlan([FaultEvent(
            "ckpt_fail", at, until=until, n_failures=2,
            note="checkpoint write fails twice")], seed=seed)
    if name == "ckpt_flaky":
        return FaultPlan([FaultEvent(
            "ckpt_fail", at, until=until, n_failures=-1,
            note="checkpoint path persistently broken")], seed=seed)
    if name == "ckpt_corrupt":
        return FaultPlan([FaultEvent(
            "ckpt_corrupt", at, until=until,
            note="checkpoint corrupted on disk")], seed=seed)
    if name == "chaos":
        return FaultPlan.generate(seed, first_iteration=at,
                                  n_tasks=n_tasks)
    raise ValueError(f"unknown fault scenario {name!r}; "
                     f"options: {FAULT_SCENARIOS}")
