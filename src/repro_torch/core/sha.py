"""Hybrid scheduling algorithm: nested Successive Halving + EA (Algorithm 1).

Level-1 arms: task groupings; Level-2 arms: GPU group-size vectors.  Each
(tg, gg) pair owns a persistent EvolutionarySearch whose best-found cost is
the arm's loss; halving discards the worse half at each level and doubles
the per-arm budget, exactly as in Algorithm 1.  The budget is counted in
cost-model evaluations (deterministic; a wall-clock budget wrapper is
provided for the paper's Figure-5 style experiments).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Tuple

from repro_torch.core import enumerate as enum_mod
from repro_torch.core.ea import EvolutionarySearch
from repro_torch.core.plan import Plan
from repro_torch.core.topology import Topology
from repro_torch.core.workflow import RLWorkflow


@dataclasses.dataclass
class SearchResult:
    plan: Optional[Plan]
    cost: float
    evals: int
    grouping: Optional[tuple] = None
    sizes: Optional[tuple] = None
    trace: List[Tuple[int, float]] = dataclasses.field(default_factory=list)


class HybridScheduler:
    """HetRL (SHA-EA)."""

    def __init__(self, topo: Topology, wf: RLWorkflow, *, seed: int = 0,
                 max_groupings: Optional[int] = None,
                 max_sizes_per_grouping: int = 8,
                 use_load_balance: bool = True,
                 eta: Optional[float] = None):
        self.topo, self.wf = topo, wf
        self.seed = seed
        self.use_load_balance = use_load_balance
        self.eta = eta
        groupings = enum_mod.task_groupings(wf)
        priority = enum_mod.priority_groupings(wf)
        if max_groupings is not None and len(groupings) > max_groupings:
            rest = [g for g in sorted(groupings, key=lambda g: (len(g), g))
                    if g not in priority]
            n_rest = max(max_groupings - len(priority), 0)
            step = len(rest) / max(n_rest, 1)
            sampled = [rest[int(i * step)] for i in range(n_rest)]
            groupings = priority + sampled
        else:
            groupings = priority + [g for g in groupings
                                    if g not in priority]
        self.groupings = groupings
        self.max_sizes = max_sizes_per_grouping
        self._searchers: Dict[tuple, EvolutionarySearch] = {}
        self._seeded_sizes: Dict[tuple, tuple] = {}

    def _sizes_for(self, tg) -> List[tuple]:
        sizes = [tuple(s) for s in enum_mod.candidate_group_sizes(
            self.wf, tg, self.topo.n, self.max_sizes, seed=self.seed)]
        seeded = self._seeded_sizes.get(tg)
        if seeded is not None:
            sizes = [seeded] + [s for s in sizes if s != seeded]
        return sizes

    def seed_incumbent(self, plan: Plan) -> None:
        """Warm-start the search from an incumbent plan (§6 reschedule):
        its task grouping becomes the first Level-1 arm, its exact group
        sizes the first Level-2 arm of that grouping, and its device
        order / parallelizations / tasklet mapping are injected into the
        corresponding EA population — so a short budget re-evaluates the
        incumbent itself before exploring, and an unchanged topology
        reliably rediscovers it.  Incumbents that no longer fit the
        topology (dropped devices, size mismatch) seed only what still
        applies."""
        grouping = tuple(sorted(tuple(sorted(g.tasks)) for g in plan.groups))
        self.groupings = [grouping] + [g for g in self.groupings
                                       if g != grouping]
        size_of = {tuple(sorted(g.tasks)): len(g.devices)
                   for g in plan.groups}
        sizes = tuple(size_of[b] for b in grouping)
        if sum(sizes) != self.topo.n or \
                any(int(d) >= self.topo.n for g in plan.groups
                    for d in g.devices):
            return
        self._seeded_sizes[grouping] = sizes
        self._searcher(grouping, sizes).inject_plan(plan)

    def _searcher(self, tg, gg) -> EvolutionarySearch:
        key = (tg, gg)
        if key not in self._searchers:
            self._searchers[key] = EvolutionarySearch(
                self.topo, self.wf, tg, list(gg),
                seed=self.seed + hash(key) % 65536,
                use_load_balance=self.use_load_balance, eta=self.eta)
        return self._searchers[key]

    def search(self, budget: int) -> SearchResult:
        """Nested SHA per Algorithm 1. `budget` = cost-model evaluations."""
        TG = list(self.groupings)
        GG: Dict[tuple, List[tuple]] = {tg: self._sizes_for(tg) for tg in TG}
        best = SearchResult(None, math.inf, 0)
        rounds_l1 = max(math.ceil(math.log2(max(len(TG), 2))), 1)
        TG_m = TG
        spent = 0
        for m in range(rounds_l1):
            if not TG_m or spent >= budget:
                break
            b_m = max(budget // (len(TG_m) * rounds_l1), 1)
            tg_costs: Dict[tuple, float] = {}
            for tg in TG_m:
                gg_list = GG[tg]
                rounds_l2 = max(math.ceil(math.log2(max(len(gg_list), 2))), 1)
                gg_n = list(gg_list)
                for n in range(rounds_l2):
                    if not gg_n:
                        break
                    b_mn = max(b_m // (len(gg_n) * rounds_l2), 1)
                    for gg in gg_n:
                        se = self._searcher(tg, gg)
                        plan, cost = se.run(b_mn)
                        spent += b_mn
                        if cost < best.cost:
                            best = SearchResult(plan, cost, spent, tg, gg,
                                                list(best.trace))
                        best.trace.append((spent, best.cost))
                    gg_n = sorted(
                        gg_n, key=lambda g: self._searcher(tg, g).best_cost
                    )[:max(len(gg_n) // 2, 1)]
                GG[tg] = gg_n
                tg_costs[tg] = min(
                    (self._searcher(tg, g).best_cost for g in gg_list),
                    default=math.inf)
            TG_m = sorted(TG_m, key=lambda tg: tg_costs.get(tg, math.inf)) \
                [:max(len(TG_m) // 2, 1)]
        best.evals = spent
        return best

    def search_timed(self, seconds: float,
                     chunk: int = 64) -> SearchResult:
        """Wall-clock budgeted variant (Figure 5).

        Resumes with *incremental* budget: each round grants a doubled
        chunk of fresh evaluations to the persistent per-arm searchers
        (EvolutionarySearch state carries over), so evaluations are
        counted once instead of re-running the whole search from
        scratch at every doubling."""
        t0 = time.monotonic()
        best = SearchResult(None, math.inf, 0)
        trace: List[Tuple[int, float]] = []
        spent = 0
        increment = chunk
        while time.monotonic() - t0 < seconds:
            r = self.search(increment)
            trace.extend((spent + e, min(c, best.cost)) for e, c in r.trace)
            spent += r.evals
            if r.cost < best.cost:
                best = SearchResult(r.plan, r.cost, spent,
                                    r.grouping, r.sizes)
            best.evals = spent
            increment *= 2
        best.trace = trace
        return best
