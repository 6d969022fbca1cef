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

``TaskPlacement`` carries what the execution path needs to shard for
real.  The folded devices are the world's ranks (``parallel.dist``:
one process per device, a ``RankDevice`` each): a placement over more
than one rank owns a torch ``DeviceMesh`` over them, shaped ``("data",
"model")``, so the reference's ``parallel.sharding`` rules apply
unchanged; ``param_shardings`` / ``batch_shardings`` give the DTensor
placements, ``distribute_params`` / ``shard_batch`` make the DTensors,
and ``here`` says whether this rank runs the task.  Every rank builds
every placement's mesh, in task order: sub-groups are collective.  A
placement of one device (every placement in a world of one) keeps a
no-op ``LocalMesh`` and plain tensors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.plan import Plan
from repro_torch.parallel import dist
from repro_torch.parallel import sharding as sh

ONE_RANK = ("a placement over several devices runs one process per device "
            "(parallel.dist: torchrun or dist.spawn); this world has one "
            "rank, so its devices cannot be sharded over")


class LocalMesh:
    """Folded devices in ``("data", "model")`` mesh shape, for a
    placement that needs no process group (one device, or devices of a
    world of one).  Entering it does nothing."""

    def __init__(self, devices: np.ndarray):
        self.devices = devices

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


# (device type, rank grid) -> DeviceMesh: placements with the same ranks
# in the same shape share one mesh (and its process groups)
_MESHES: Dict[tuple, Any] = {}


def _device_mesh(grid: np.ndarray):
    """The DeviceMesh over the grid's ranks, laid out in ascending rank
    order: a process group numbers its members in that order, and DTensor
    reads a mesh dimension's group in coordinate order, so an unsorted
    grid (an oversubscribed fold gives one) would mix up the shards.  Any
    assignment of ranks to coordinates is as good; the grid's shape
    stays."""
    from torch.distributed.device_mesh import DeviceMesh
    import torch
    ranks = np.sort(np.vectorize(lambda d: d.rank, otypes=[int])(grid),
                    axis=None).reshape(grid.shape)
    dtype = grid.flat[0].device.type
    key = (dtype, ranks.shape, tuple(ranks.reshape(-1)))
    mesh = _MESHES.get(key)
    if mesh is None:
        mesh = _MESHES[key] = DeviceMesh(
            dtype, torch.as_tensor(ranks), mesh_dim_names=sh.AXES)
    return mesh


@dataclasses.dataclass(frozen=True)
class ParamShardings:
    """Where a parameter tree goes: the placement and each leaf's
    partition spec (a tree like the parameters)."""
    placement: "TaskPlacement"
    specs: Any


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
    local_devices: Tuple            # distinct folded devices / rank handles
    mesh: Any                       # DeviceMesh over the ranks, or LocalMesh
    rep_plan_devices: Tuple[int, ...] = ()  # plan id per distinct device
    collision: bool = False       # group shares a real device with another
    grid: Any = None              # local_devices in ("data", "model") shape

    @property
    def mesh_shape(self) -> Tuple[int, int]:
        return tuple(self.grid.shape)

    @property
    def n_devices(self) -> int:
        return len(self.local_devices)

    @property
    def tp_eff(self) -> int:
        """Realized tensor parallelism after folding (mesh model dim)."""
        return self.grid.shape[1]

    @property
    def dp_eff(self) -> int:
        """Realized data parallelism after folding (mesh data dim)."""
        return self.grid.shape[0]

    @property
    def sharded(self) -> bool:
        """True when this task actually spans several real devices."""
        return len(self.local_devices) > 1

    @property
    def ranks(self) -> Tuple[int, ...]:
        """The world ranks of the folded devices (``(0,)`` for plain
        devices: a world of one)."""
        if isinstance(self.local_devices[0], dist.RankDevice):
            return tuple(d.rank for d in self.local_devices)
        return (0,)

    @property
    def lead(self) -> int:
        """The rank that speaks for the task's group (its first)."""
        return self.ranks[0]

    @property
    def here(self) -> bool:
        """Whether this rank runs the task."""
        return dist.rank() in self.ranks

    def _mesh(self):
        if isinstance(self.mesh, LocalMesh):
            raise RuntimeError(ONE_RANK)
        return self.mesh

    def activation_rules(self):
        """Activation-sharding rules for this placement's (dp, tp).

        Sequence sharding stays off: RL batches are short and ragged, and
        the decode path keeps B on ``data`` only."""
        return sh.default_activation_rules(seq_shard=False)

    def param_shardings(self, params) -> ParamShardings:
        """The parameter tree's partition specs on this placement, each
        sanitized so non-dividing axes drop to replication (a tuple of
        trees takes each tree's own specs); no specs on one device (the
        tree lies whole there)."""
        if not self.sharded:
            return ParamShardings(self, None)
        mesh = self._mesh()
        if isinstance(params, tuple):
            return ParamShardings(self, tuple(
                self.param_shardings(p).specs for p in params))
        specs = sh.param_tree_specs(params)
        return ParamShardings(self, sh.map_with_path(
            lambda path, x: sh.sanitize_spec(_at(specs, path),
                                             tuple(x.shape), mesh), params))

    def replicated_sharding(self) -> Tuple:
        """DTensor placements of a replicated value on this mesh."""
        from torch.distributed.tensor import Replicate
        return (Replicate(),) * self._mesh().ndim

    def batch_shardings(self, tree):
        """Leading-dim ``data`` placements for a batch tree (replicated
        when the batch dim does not divide the data axis)."""
        mesh = self._mesh()
        from repro_torch.tree import tree_map
        return tree_map(lambda x: sh.tensor_placements(
            sh.P(sh.DATA), tuple(np.shape(x)), mesh), tree)

    def shard_batch(self, tree):
        """A batch tree (the same full tensors on every rank of the mesh)
        as DTensors split over ``data``; other leaves pass through (and
        the whole tree on one device)."""
        if not self.sharded:
            return tree
        mesh = self._mesh()
        import torch
        from repro_torch.tree import tree_map
        return tree_map(lambda x: sh.distribute(x, mesh, sh.P(sh.DATA))
                        if torch.is_tensor(x) else x, tree)

    def distribute_params(self, params, shardings: ParamShardings = None):
        """A parameter tree (full on every rank of the mesh) as DTensors
        laid out by its specs (a tuple of trees: each by its own)."""
        mesh = self._mesh()
        shardings = shardings or self.param_shardings(params)
        from repro_torch.tree import tree_leaves, tree_unflatten
        leaves = [sh.distribute(x, mesh, s) for x, s in zip(
            tree_leaves(params), spec_leaves(shardings.specs))]
        return tree_unflatten(params, leaves)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def spec_leaves(specs) -> List:
    """The partition specs of a spec tree, in ``tree_leaves`` order (a
    spec is itself a tuple, so the tree helpers would walk into it)."""
    if isinstance(specs, sh.P):
        return [specs]
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in spec_leaves(specs[k])]
    if isinstance(specs, (tuple, list)):
        return [s for x in specs for s in spec_leaves(x)]
    return []


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
    grid = grid.reshape(n // tp_eff, tp_eff)
    ranked = isinstance(distinct[0], dist.RankDevice) and dist.multi()
    mesh = _device_mesh(grid) if ranked and n > 1 else LocalMesh(grid)
    group = plan.group_of(t)
    gi = plan.groups.index(group) if group in plan.groups else -1
    return TaskPlacement(t, dp, pp, tp, plan_devs, tuple(distinct), mesh,
                         rep_plan_devices=tuple(reps),
                         collision=gi in folding.colliding_groups,
                         grid=grid)


def build_placements(plan: Plan, tasks: Sequence[int], devices: Sequence
                     ) -> Dict[int, TaskPlacement]:
    devices = list(devices)
    folding = fold_plan(plan, devices)
    return {t: build_placement(plan, t, devices, folding) for t in tasks}
