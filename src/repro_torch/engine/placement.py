"""Plan → device placement: map each task's (dp, pp, tp) + tasklet
assignment onto the host's real devices.

Port of ``repro.engine.placement`` over a list of torch devices, with
the same group-aware, deterministic folding:

  1. collect the distinct plan device ids used by the whole plan, sorted
     ascending.  When they fit on the host (``#ids <= L`` real devices)
     the i-th smallest plan id folds onto ``local_devices[i]`` — an
     *injective* map, so disjoint plan groups land on disjoint real
     device sets.
  2. only when the host is oversubscribed (``#ids > L``) does folding
     fall back to ``d % L``; distinct groups can then collide on a real
     device.  Every such collision is recorded in
     ``DeviceFolding.collisions`` so the engine can tag the affected
     events instead of reporting fake concurrency.  On one card every
     plan group folds onto it, and every pair of groups collides.
  3. per task, duplicates collapse (first plan-order occurrence wins),
     giving ``n`` distinct real devices; the task's mesh shape is
     ``(data=n/tp', model=tp')`` with ``tp' = gcd(tp, n)``.

``TaskPlacement`` keeps the mesh shape, ``tp_eff``, ``dp_eff``,
``rep_plan_devices`` and the collision flag.  Its ``mesh`` is a no-op
context (``with placement.mesh:`` in the task executors) that holds the
folded devices in mesh shape.  Sharded execution over several devices
(parameter and batch shardings) is not yet ported: those calls raise
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.plan import Plan

NOT_PORTED = ("sharded execution over several devices is not yet ported "
              "(ROADMAP.md §1 item 9)")


class DeviceMesh:
    """Folded devices in ``("data", "model")`` mesh shape.  Entering it
    does nothing: on one device there is nothing to shard over."""

    def __init__(self, devices: np.ndarray):
        self.devices = devices

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@dataclasses.dataclass(frozen=True)
class DeviceFolding:
    """Plan-wide folding decision: plan device id -> local device index.

    ``collisions`` lists real devices shared by *distinct* plan groups
    (only possible when ``oversubscribed``): tuples of
    ``(local_index, group_indices)``.  Within-group many-to-one folding
    is not a collision — it shrinks dp/tp, which placement accounts for.
    """
    mapping: Dict[int, int]
    oversubscribed: bool
    collisions: Tuple[Tuple[int, Tuple[int, ...]], ...]
    colliding_groups: frozenset

    @property
    def n_collisions(self) -> int:
        return len(self.collisions)


@dataclasses.dataclass
class TaskPlacement:
    task: int
    dp: int                       # plan-level parallelization
    pp: int
    tp: int
    plan_devices: Tuple[int, ...]   # plan device ids, tasklet order
    local_devices: Tuple            # distinct folded torch devices
    mesh: DeviceMesh                # ("data", "model") over local_devices
    rep_plan_devices: Tuple[int, ...] = ()  # plan id per distinct device
    collision: bool = False       # group shares a real device with another

    @property
    def mesh_shape(self) -> Tuple[int, int]:
        return tuple(self.mesh.devices.shape)

    @property
    def n_devices(self) -> int:
        return len(self.local_devices)

    @property
    def tp_eff(self) -> int:
        """Realized tensor parallelism after folding (mesh model dim)."""
        return self.mesh.devices.shape[1]

    @property
    def dp_eff(self) -> int:
        """Realized data parallelism after folding (mesh data dim)."""
        return self.mesh.devices.shape[0]

    @property
    def sharded(self) -> bool:
        """True when this task actually spans several real devices."""
        return len(self.local_devices) > 1

    def activation_rules(self):
        raise NotImplementedError(NOT_PORTED)

    def param_shardings(self, params):
        raise NotImplementedError(NOT_PORTED)

    def replicated_sharding(self):
        raise NotImplementedError(NOT_PORTED)

    def batch_shardings(self, tree):
        raise NotImplementedError(NOT_PORTED)

    def shard_batch(self, tree):
        raise NotImplementedError(NOT_PORTED)


def fold_plan(plan: Plan, local_devices) -> DeviceFolding:
    """Group-aware folding for a whole plan.

    Injective (rank-ordered) when every distinct plan device id fits on
    the host; ``d % L`` with a collision report otherwise."""
    L = len(local_devices)
    ids = sorted({int(d) for g in plan.groups for d in g.devices}
                 | {int(d) for a in plan.assignment.values()
                    for d in np.asarray(a).reshape(-1)})
    oversubscribed = len(ids) > L
    if oversubscribed:
        mapping = {d: d % L for d in ids}
    else:
        mapping = {d: i for i, d in enumerate(ids)}

    # collision report: real devices claimed by >= 2 distinct groups
    claims: Dict[int, set] = {}
    for gi, g in enumerate(plan.groups):
        for d in g.devices:
            if int(d) in mapping:
                claims.setdefault(mapping[int(d)], set()).add(gi)
    collisions = tuple(
        (li, tuple(sorted(gs))) for li, gs in sorted(claims.items())
        if len(gs) > 1)
    colliding = frozenset(g for _, gs in collisions for g in gs)
    return DeviceFolding(mapping, oversubscribed, collisions, colliding)


def fold_devices(plan_devices: Sequence[int], local_devices,
                 mapping: Optional[Dict[int, int]] = None) -> List:
    """Fold one task's plan device ids onto distinct local devices.

    With ``mapping`` (from :func:`fold_plan`) the plan-wide group-aware
    rule applies; without it, the ``d % L`` rule.  Devices are told
    apart by their position in ``local_devices``."""
    L = len(local_devices)
    if mapping is None:
        idx = [int(d) % L for d in plan_devices]
    else:
        idx = [mapping[int(d)] for d in plan_devices]
    distinct, seen = [], set()
    for i in idx:
        if i not in seen:
            seen.add(i)
            distinct.append(local_devices[i])
    return distinct


def build_placement(plan: Plan, t: int, devices: Sequence,
                    folding: Optional[DeviceFolding] = None
                    ) -> TaskPlacement:
    devices = list(devices)
    if folding is None:
        folding = fold_plan(plan, devices)
    dp, pp, tp = plan.parallel[t]
    plan_devs = tuple(int(d) for d in plan.assignment[t].reshape(-1))
    distinct = fold_devices(plan_devs, devices, folding.mapping)
    # representative plan id per distinct real device (first claimant)
    reps, seen = [], set()
    for d in plan_devs:
        li = folding.mapping[int(d)]
        if li not in seen:
            seen.add(li)
            reps.append(int(d))
    n = len(distinct)
    tp_eff = math.gcd(tp, n)
    grid = np.empty((n,), dtype=object)
    grid[:] = distinct
    mesh = DeviceMesh(grid.reshape(n // tp_eff, tp_eff))
    group = plan.group_of(t)
    gi = plan.groups.index(group) if group in plan.groups else -1
    return TaskPlacement(t, dp, pp, tp, plan_devs, tuple(distinct), mesh,
                         rep_plan_devices=tuple(reps),
                         collision=gi in folding.colliding_groups)


def build_placements(plan: Plan, tasks: Sequence[int], devices: Sequence
                     ) -> Dict[int, TaskPlacement]:
    devices = list(devices)
    folding = fold_plan(plan, devices)
    return {t: build_placement(plan, t, devices, folding) for t in tasks}
