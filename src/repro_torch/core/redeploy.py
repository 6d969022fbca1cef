"""Online redeployment (§6): medium-granularity adaptation to network /
fleet changes by re-scheduling at checkpoint boundaries.

The paper: "HetRL can accommodate medium-granularity network variability
by performing scheduling before the end of the current iteration and
during model checkpointing ... the updated plan is applied immediately
after checkpointing."  `reschedule` warm-starts the hybrid scheduler from
the incumbent plan's Level-1/2 decisions so a short budget suffices, and
reports whether switching is worthwhile (new cost + amortized transition
cost vs staying).

When does ``switch`` fire?
--------------------------
``reschedule`` prices the incumbent on the *new* topology (infinite when
the incumbent no longer fits — devices gone, memory constraints broken)
and searches for a challenger under a short warm-started budget.  The
decision is an amortization inequality::

    switch  <=>  (old_cost - new_cost) * amortization_iters > transition
                 and new_cost < old_cost

i.e. the per-iteration gain, accumulated over the horizon the new plan is
expected to live (`amortization_iters`, the paper's checkpoint interval),
must pay for the one-off weight migration.  Because the warm start seeds
the incumbent's grouping, group sizes, parallelizations and device order
into the scheduler's arms, the challenger is never worse than the
incumbent on the new topology — so an undisturbed topology re-evaluates
the incumbent at equal cost and keeps it (``switch=False`` with zero
transition).  The engine applies a ``switch=True`` decision at the next
iteration boundary through ``engine.Engine.apply_plan``; the elasticity
loop around both lives in ``engine.elastic``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

from repro_torch.core.costmodel import CostModel
from repro_torch.core.plan import BYTES_BF16, Plan, check_constraints
from repro_torch.core.sha import HybridScheduler, SearchResult
from repro_torch.core.topology import Topology
from repro_torch.core.workflow import RLWorkflow, TaskKind


@dataclasses.dataclass
class RedeployDecision:
    switch: bool
    plan: Plan
    old_cost: float               # incumbent plan on the NEW topology
    new_cost: float
    transition_cost_s: float      # weight movement at the checkpoint
    amortization_iters: int


def _surviving_ids(topo_new: Topology,
                   topo_old: Optional[Topology]) -> Optional[set]:
    """Device ids whose identity is unchanged between the two topologies.

    ``drop_devices`` densely re-indexes survivors, so an id below the new
    ``n`` may alias a *different* physical device after a non-suffix
    drop.  With the old topology in hand we can tell: an id survives only
    when both topologies agree on its (spec, machine, zone, region).
    Returns None when no old topology is available (ids taken at face
    value, valid for pure link drift)."""
    if topo_old is None:
        return None
    keep = set()
    for d in range(min(topo_new.n, topo_old.n)):
        a, b = topo_old.devices[d], topo_new.devices[d]
        if (a.spec, a.machine, a.zone, a.region) == \
                (b.spec, b.machine, b.zone, b.region):
            keep.add(d)
    return keep


def transition_cost(topo: Topology, wf: RLWorkflow, old: Plan,
                    new: Plan, *,
                    topo_old: Optional[Topology] = None) -> float:
    """Weights that must move to devices not previously holding them:
    approximated as full bf16 weights of every task whose device set
    changed, routed over the bottleneck link of the task's chosen paths.

    Each destination device pulls its shard from the best-connected
    source that still holds the weights (max over sources); the task's
    transfer completes when the slowest such chosen link finishes (min
    over destinations) — the bottleneck between the old and new sets.
    Sources that no longer exist on `topo` (dropped or re-indexed
    devices, detected against `topo_old` when given) cannot serve; a
    task with no surviving source moves for free here, because its
    weights must be restored from the checkpoint that §6 takes at the
    swap boundary anyway."""
    survivors = _surviving_ids(topo, topo_old)
    total = 0.0
    for t in range(wf.n_tasks):
        devs_old = {int(d) for d in old.assignment[t].reshape(-1)} \
            if t in old.assignment else set()
        devs_old = {d for d in devs_old if d < topo.n
                    and (survivors is None or d in survivors)}
        devs_new = {int(d) for d in new.assignment[t].reshape(-1)}
        moved = devs_new - devs_old
        if not moved or not devs_old:
            continue
        nbytes = BYTES_BF16 * wf.task(t).model.total_weight_count \
            * len(moved) / max(len(devs_new), 1)
        bottleneck = min(max(topo.beta(a, b) for a in devs_old)
                         for b in moved)
        total += nbytes / (bottleneck * 1e9)
    return total


# historical name, kept for callers of the private spelling
_transition_cost = transition_cost


def _incumbent_cost(topo_new: Topology, wf: RLWorkflow, cm: CostModel,
                    incumbent: Plan,
                    topo_old: Optional[Topology] = None) -> float:
    """Incumbent plan priced on the new topology; infinite when it no
    longer fits — it references dropped devices, ids whose identity
    changed under re-indexing (detected against `topo_old` when given),
    or violates constraints."""
    used = {int(d) for asg in incumbent.assignment.values()
            for d in asg.reshape(-1)}
    if any(d >= topo_new.n for d in used):
        return math.inf
    survivors = _surviving_ids(topo_new, topo_old)
    if survivors is not None and not used <= survivors:
        return math.inf
    ok, _ = check_constraints(topo_new, wf, incumbent)
    return cm.cost(incumbent) if ok else math.inf


def reschedule(topo_new: Topology, wf: RLWorkflow, incumbent: Plan, *,
               budget: int = 150, amortization_iters: int = 20,
               seed: int = 0,
               topo_old: Optional[Topology] = None) -> RedeployDecision:
    """`topo_old` (the environment the incumbent was planned for, when
    the caller has it — the elastic controller always does) lets the
    decision detect device re-indexing after a fleet shrink rather than
    trusting raw device ids."""
    cm = CostModel(topo_new, wf)
    old_cost = _incumbent_cost(topo_new, wf, cm, incumbent, topo_old)

    sched = HybridScheduler(topo_new, wf, seed=seed, max_groupings=8,
                            max_sizes_per_grouping=4)
    # warm start (Level 1/2/4/5): incumbent grouping first among the
    # arms, its exact group sizes first within that arm, and its device
    # order + parallelizations injected into the matching EA population,
    # so a short budget re-evaluates the incumbent before exploring
    sched.seed_incumbent(incumbent)
    result = sched.search(budget=budget)
    if result.plan is None:
        return RedeployDecision(False, incumbent, old_cost, math.inf, 0.0,
                                amortization_iters)

    trans = transition_cost(topo_new, wf, incumbent, result.plan,
                            topo_old=topo_old)
    gain_per_iter = old_cost - result.cost
    switch = gain_per_iter * amortization_iters > trans and \
        result.cost < old_cost
    return RedeployDecision(switch, result.plan if switch else incumbent,
                            old_cost, result.cost, trans,
                            amortization_iters)
