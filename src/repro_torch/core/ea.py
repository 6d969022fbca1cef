"""Evolutionary algorithm for low-level plan generation (§3.4, Levels 3–5).

Genome (under a fixed Level-1 task grouping and Level-2 group sizes):
  * ``device_perm`` — permutation of all device ids; split by sizes gives
    the medium-grained group assignment (Level 3).
  * ``par`` — per-task (dp, pp, tp) from the feasible set (Level 4).
  * ``order`` — per-task device ordering within its group (Level 5 tasklet
    mapping; the first dp*pp*tp devices are used, dp-major).

Custom mutation (paper): with some probability, replace a GPU in a
*training* task group with a higher-TFLOPS GPU from a non-training group.

Baldwinian local search (paper): greedy cross-group swaps maximizing a
machine/zone/region locality score; the improved *phenotype* is evaluated,
but improvements are not written back to the genotype.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import enumerate as enum_mod
from repro_torch.core import loadbalance
from repro_torch.core.costmodel import CostModel, apply_speculative_best_response
from repro_torch.core.plan import Plan, check_constraints, \
    feasible_parallelizations
from repro_torch.core.topology import Topology
from repro_torch.core.workflow import RLWorkflow, TaskKind


@dataclasses.dataclass
class Individual:
    device_perm: np.ndarray
    par: Dict[int, Tuple[int, int, int]]
    order: Dict[int, np.ndarray]     # task -> permutation of its group devs
    fitness: float = math.inf        # cost of the locally-improved phenotype


class EvolutionarySearch:
    def __init__(self, topo: Topology, wf: RLWorkflow, grouping,
                 sizes: Sequence[int], *, seed: int = 0,
                 pop_size: int = 12, mutate_upgrade_p: float = 0.3,
                 use_load_balance: bool = True,
                 eta: Optional[float] = None):
        self.topo, self.wf = topo, wf
        self.grouping, self.sizes = grouping, list(sizes)
        self.rng = np.random.default_rng(seed)
        self.pop_size = pop_size
        self.mutate_upgrade_p = mutate_upgrade_p
        self.use_load_balance = use_load_balance
        self.cm = CostModel(topo, wf, eta=eta)
        self.population: List[Individual] = []
        self.best_plan: Optional[Plan] = None
        self.best_cost = math.inf
        self.evals = 0
        self._train_groups = {gi for gi, g in enumerate(grouping)
                              if any(wf.task(t).kind == TaskKind.TRAIN
                                     for t in g)}
        # GEN tasks eligible for the speculative-decode gene (the verify
        # step needs attention; cache.supports_speculative_target)
        self._spec_tasks = [t for t in range(wf.n_tasks)
                            if wf.task(t).kind == TaskKind.GEN
                            and not wf.task(t).model.attention_free]
        self._ranked_cache: Dict[Tuple[int, int], List[Tuple[int, int, int]]] = {}

    # -- genome <-> plan -------------------------------------------------
    def _group_slices(self) -> List[slice]:
        out, off = [], 0
        for s in self.sizes:
            out.append(slice(off, off + s))
            off += s
        return out

    def decode(self, ind: Individual) -> Plan:
        order = {t: ind.order[t] for t in ind.order}
        plan = enum_mod.build_plan(
            self.topo, self.wf, self.grouping, self.sizes,
            ind.device_perm.tolist(), parallel=dict(ind.par),
            tasklet_order={t: o.tolist() for t, o in order.items()})
        # speculative decoding is a best response, not a gene: given the
        # assignment the genome proposes, pick the draft-k the cost
        # model prices cheapest per GEN task (0 = off) — deterministic,
        # so re-searching an unchanged topology cannot "discover" spec
        # late and flip the incumbent (the ILP refines identically)
        return apply_speculative_best_response(self.cm, plan)

    # -- init --------------------------------------------------------------
    def _random_individual(self) -> Individual:
        perm = self.rng.permutation(self.topo.n)
        par: Dict[int, Tuple[int, int, int]] = {}
        order: Dict[int, np.ndarray] = {}
        sl = self._group_slices()
        for gi, g in enumerate(self.grouping):
            devs = perm[sl[gi]]
            for t in g:
                par[t] = enum_mod.default_parallelization(
                    self.topo, self.wf, t, devs.tolist())
                order[t] = devs.copy()
        return Individual(perm, par, order)

    def _seeded_individual(self) -> Individual:
        """Locality-contiguous device order + feasibility-aware rank-walk
        parallelization (memory-heavy tasks pushed to deeper pp*tp)."""
        devs_sorted = sorted(
            range(self.topo.n),
            key=lambda d: (self.topo.devices[d].region,
                           -self.topo.devices[d].spec.fp16_tflops,
                           self.topo.devices[d].machine, d))
        # training groups get the fastest devices first
        order_groups = sorted(
            range(len(self.grouping)),
            key=lambda gi: 0 if gi in self._train_groups else 1)
        perm = np.empty(self.topo.n, dtype=int)
        sl = self._group_slices()
        taken = 0
        chosen: Dict[int, List[int]] = {}
        for gi in order_groups:
            chosen[gi] = devs_sorted[taken:taken + self.sizes[gi]]
            taken += self.sizes[gi]
        for gi in range(len(self.grouping)):
            perm[sl[gi]] = chosen[gi]
        par: Dict[int, Tuple[int, int, int]] = {}
        order: Dict[int, np.ndarray] = {}
        for gi, g in enumerate(self.grouping):
            devs = perm[sl[gi]]
            n_g = len(devs)
            for t in g:
                ranked = self._ranked_pars(t, n_g, devs.tolist())
                par[t] = ranked[0]
                order[t] = devs.copy()
        ind = Individual(perm, par, order)
        # rank-walk toward feasibility
        from repro_torch.core.plan import check_constraints as chk
        for _ in range(24):
            plan = self.decode(ind)
            ok, msg = chk(self.topo, self.wf, plan)
            if ok or not msg.startswith("OOM"):
                break
            t_heavy = max(
                range(self.wf.n_tasks),
                key=lambda t: self.wf.task(t).model.total_weight_count
                * (16 if self.wf.task(t).kind == TaskKind.TRAIN else 2)
                / max(ind.par[t][1] * ind.par[t][2], 1))
            gi = next(i for i, g in enumerate(self.grouping)
                      if t_heavy in g)
            ranked = self._ranked_pars(
                t_heavy, self.sizes[gi],
                ind.device_perm[self._group_slices()[gi]].tolist())
            cur = ranked.index(ind.par[t_heavy]) \
                if ind.par[t_heavy] in ranked else -1
            if cur + 1 >= len(ranked):
                break
            ind.par[t_heavy] = ranked[cur + 1]
        return ind

    def _ranked_pars(self, t: int, n_g: int,
                     devs: List[int]) -> List[Tuple[int, int, int]]:
        cands = enum_mod.full_group_factorizations(
            n_g, self.wf.task(t).model.n_layers)
        if not cands:
            cands = [enum_mod.default_parallelization(
                self.topo, self.wf, t, devs)]
        # rank by the task's actual cost-model estimate on a trial plan
        # (one-time per searcher; far better seeds than the dp-max proxy)
        scored = []
        for p in cands:
            try:
                trial = enum_mod.build_plan(
                    self.topo, self.wf, self.grouping, self.sizes,
                    self._seed_order(), parallel={t: p})
                scored.append((self.cm.task_cost(trial, t).total, p))
            except Exception:
                scored.append((float("inf"), p))
        scored.sort(key=lambda x: x[0])
        return [p for _, p in scored]

    def _seed_order(self) -> List[int]:
        if not hasattr(self, "_seed_order_cache"):
            self._seed_order_cache = sorted(
                range(self.topo.n),
                key=lambda d: (self.topo.devices[d].region,
                               -self.topo.devices[d].spec.fp16_tflops,
                               self.topo.devices[d].machine, d))
        return self._seed_order_cache

    # -- mutation ----------------------------------------------------------
    def mutate(self, ind: Individual) -> Individual:
        perm = ind.device_perm.copy()
        par = dict(ind.par)
        order = {t: o.copy() for t, o in ind.order.items()}
        sl = self._group_slices()
        op = self.rng.random()

        if op < self.mutate_upgrade_p and self._train_groups:
            # paper's custom mutation: pull a higher-TFLOPS GPU into a
            # training group from a non-training group
            gi = int(self.rng.choice(sorted(self._train_groups)))
            others = [i for i in range(len(self.sizes))
                      if i not in self._train_groups]
            if others:
                gj = int(self.rng.choice(others))
                di = sl[gi].start + int(self.rng.integers(self.sizes[gi]))
                tf = lambda d: self.topo.devices[int(perm[d])].spec.fp16_tflops
                cand = [sl[gj].start + k for k in range(self.sizes[gj])
                        if tf(sl[gj].start + k) > tf(di)]
                if cand:
                    dj = int(self.rng.choice(cand))
                    perm[di], perm[dj] = perm[dj], perm[di]
        elif op < 0.55:
            # random cross-group swap
            a, b = self.rng.integers(self.topo.n, size=2)
            perm[a], perm[b] = perm[b], perm[a]
        elif op < 0.8:
            # change a task's parallelization: half the moves walk the
            # cost-model ranking of that task's candidates (geometric
            # bias toward the top — directed search, cached per
            # (task, group size)), half stay uniform for exploration
            t = int(self.rng.integers(self.wf.n_tasks))
            gi = next(i for i, g in enumerate(self.grouping) if t in g)
            n = self.sizes[gi]
            key = (t, n)
            if key not in self._ranked_cache:
                self._ranked_cache[key] = self._ranked_pars(
                    t, n, self._seed_order()[:n])
            ranked = self._ranked_cache[key]
            if ranked and self.rng.random() < 0.5:
                idx = min(int(self.rng.geometric(0.45)) - 1,
                          len(ranked) - 1)
                par[t] = ranked[idx]
            else:
                feas = feasible_parallelizations(
                    n, self.wf.task(t).model.n_layers)
                par[t] = feas[int(self.rng.integers(len(feas)))]
        else:
            # shuffle a task's tasklet order
            t = int(self.rng.integers(self.wf.n_tasks))
            if t in order and len(order[t]) > 1:
                i, j = self.rng.integers(len(order[t]), size=2)
                order[t][i], order[t][j] = order[t][j], order[t][i]

        # re-sync orders with (possibly changed) group membership
        for gi, g in enumerate(self.grouping):
            devs = perm[sl[gi]]
            dev_set = set(devs.tolist())
            for t in g:
                if t not in order or set(order[t].tolist()) != dev_set:
                    order[t] = devs.copy()
        return Individual(perm, par, order)

    # -- incumbent injection (§6 reschedule warm start) ---------------------
    def inject_plan(self, plan: Plan) -> bool:
        """Seed the search with a known-good plan: score the plan itself
        (one evaluation, straight into best) and add its genome — device
        order, parallelizations, tasklet mapping — to the population so
        mutation explores around it.  Returns False when the plan's
        groups don't match this searcher's (grouping, sizes) arm."""
        devs_of = {tuple(sorted(g.tasks)): [int(d) for d in g.devices]
                   for g in plan.groups}
        perm: List[int] = []
        par: Dict[int, Tuple[int, int, int]] = {}
        order: Dict[int, np.ndarray] = {}
        for gi, g in enumerate(self.grouping):
            devs = devs_of.get(tuple(sorted(g)))
            if devs is None or len(devs) != self.sizes[gi]:
                return False
            perm.extend(devs)
            for t in g:
                par[t] = tuple(plan.parallel[t])
                flat = [int(d) for d in plan.assignment[t].reshape(-1)]
                rest = [d for d in devs if d not in set(flat)]
                order[t] = np.array(flat + rest, dtype=int)
        if sorted(perm) != list(range(self.topo.n)):
            return False
        ok, _ = check_constraints(self.topo, self.wf, plan)
        self.evals += 1
        cost = self.cm.cost(plan) if ok else math.inf
        if ok and cost < self.best_cost:
            self.best_cost, self.best_plan = cost, plan
        self.population.append(
            Individual(np.array(perm, dtype=int), par, order, cost))
        return True

    # -- Baldwinian local search (locality) ---------------------------------
    def local_search(self, ind: Individual, max_steps: int = 20) -> Individual:
        """Greedy cross-group swaps maximizing locality gain, vectorized:
        gain(a in ga, b in gb) = S[a,gb] + S[b,ga] - S[a,ga] - S[b,gb]
                                 - 2*loc(a,b),
        where S[x, g] = sum_{d in g} loc(x, d)."""
        perm = ind.device_perm.copy()
        sl = self._group_slices()
        G = len(self.sizes)
        loc = self.topo.locality_matrix()
        if G > 1:
            npos = len(perm)
            group_of_pos = np.concatenate(
                [np.full(self.sizes[g], g) for g in range(G)])
            pos_idx = np.arange(npos)
            for _ in range(max_steps):
                member = np.zeros((self.topo.n, G))
                member[perm, group_of_pos] = 1.0
                S = loc @ member                       # [N_dev, G]
                Sa = S[perm]                           # [N_pos, G]
                ga = group_of_pos                      # [N_pos]
                cross = Sa[:, ga]                      # [pa,pb]=S[a, g(b)]
                self_aff = Sa[pos_idx, ga]             # S[a, g(a)]
                # gain[pa, pb] of swapping devices at positions pa, pb
                gain = (cross + cross.T
                        - self_aff[:, None] - self_aff[None, :]
                        - 2.0 * loc[perm[:, None], perm[None, :]])
                gain[ga[:, None] == ga[None, :]] = -np.inf
                idx = int(np.argmax(gain))
                pa, pb = divmod(idx, npos)
                if gain[pa, pb] <= 1e-12:
                    break
                perm[pa], perm[pb] = perm[pb], perm[pa]
        out = Individual(perm, dict(ind.par),
                         {t: o.copy() for t, o in ind.order.items()},
                         ind.fitness)
        # re-sync tasklet orders to new group membership
        for gi, g in enumerate(self.grouping):
            devs = perm[sl[gi]]
            for t in g:
                out.order[t] = devs.copy()
        return out

    # -- evaluation -------------------------------------------------------
    def evaluate(self, ind: Individual) -> float:
        from repro_torch.core.plan import memory_overflow
        phenotype = self.local_search(ind)
        plan = self.decode(phenotype)
        if self.use_load_balance:
            plan = loadbalance.balance(self.topo, self.wf, plan)
        ok, msg = check_constraints(self.topo, self.wf, plan)
        self.evals += 1
        if not ok and not msg.startswith("OOM"):
            return math.inf
        cost = self.cm.cost(plan)
        if not ok:
            # graded penalty keeps the EA's gradient toward feasibility
            over = memory_overflow(self.topo, self.wf, plan)
            return cost * (1.0 + 10.0 * over) + 1e6 * over
        if cost < self.best_cost:
            self.best_cost = cost
            self.best_plan = plan
        return cost

    # -- main loop ----------------------------------------------------------
    def run(self, budget: int) -> Tuple[Optional[Plan], float]:
        """Spend `budget` cost-model evaluations; resumable."""
        if not self.population and budget > 0:
            seed = self._seeded_individual()
            seed.fitness = self.evaluate(seed)
            self.population.append(seed)
            budget -= 1
        while len(self.population) < self.pop_size and budget > 0:
            ind = self._random_individual()
            ind.fitness = self.evaluate(ind)
            self.population.append(ind)
            budget -= 1
        while budget > 0:
            k = min(3, len(self.population))
            idxs = self.rng.choice(len(self.population), k, replace=False)
            parent = min((self.population[i] for i in idxs),
                         key=lambda x: x.fitness)
            child = self.mutate(parent)
            child.fitness = self.evaluate(child)
            budget -= 1
            worst = max(range(len(self.population)),
                        key=lambda i: self.population[i].fitness)
            if child.fitness < self.population[worst].fitness:
                self.population[worst] = child
        return self.best_plan, self.best_cost
