"""Baseline schedulers the paper compares against (§5.1, §5.4, §6).

* verl-like   — SoTA homogeneous RL scheduler: colocates all tasks on all
  GPUs, enumerates uniform parallelizations with a homogeneity-assuming
  cost model (device/network heterogeneity invisible: it sees mean TFLOPS
  and mean bandwidth), contiguous device order.
* StreamRL-like — two groups: actor generation | everything else, each
  group required to be "homogeneous and in one data center": devices are
  grouped by (region, spec) and the split picks whole homogeneous islands.
* DEAP-like pure EA — standard EA over the full space: random init, generic
  mutation, no SHA statistics, no custom upgrade mutation, no Baldwinian
  local search.
* Pure SHA — SHA over Levels 1-2 with random (not EA) low-level sampling.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import enumerate as enum_mod
from repro_torch.core.costmodel import CostModel
from repro_torch.core.ea import EvolutionarySearch, Individual
from repro_torch.core.plan import Plan, check_constraints, \
    feasible_parallelizations
from repro_torch.core.sha import SearchResult
from repro_torch.core.topology import Device, GPUSpec, Topology
from repro_torch.core.workflow import RLWorkflow, TaskKind


# ---------------------------------------------------------------------------
# verl-like
# ---------------------------------------------------------------------------

def _homogenized(topo: Topology) -> Topology:
    """What a homogeneity-assuming scheduler believes the cluster is."""
    mean_tflops = float(np.mean([d.spec.fp16_tflops for d in topo.devices]))
    mean_mem = float(np.mean([d.spec.mem_gb for d in topo.devices]))
    mean_hbm = float(np.mean([d.spec.hbm_gbps for d in topo.devices]))
    spec = GPUSpec("uniform", mean_tflops, mean_mem, mean_hbm, 64.0 / 8)
    devices = [Device(d.id, spec, d.machine, 0, "uniform")
               for d in topo.devices]
    off = topo.latency_s[~np.eye(topo.n, dtype=bool)]
    bwo = topo.bandwidth_gbps[~np.eye(topo.n, dtype=bool)]
    lat = np.full_like(topo.latency_s, float(np.mean(off)))
    np.fill_diagonal(lat, 0.0)
    bw = np.full_like(topo.bandwidth_gbps, float(np.mean(bwo)))
    np.fill_diagonal(bw, 1e9)
    return Topology(devices, lat, bw)


def _full_cluster_factorizations(n: int, n_layers: int):
    out = []
    for tp in (1, 2, 4, 8):
        if n % tp:
            continue
        rest = n // tp
        for pp in range(1, min(n_layers, rest) + 1):
            if rest % pp:
                continue
            out.append((rest // pp, pp, tp))
    return out


def verl_scheduler(topo: Topology, wf: RLWorkflow, budget: int = 256,
                   eta: Optional[float] = None) -> SearchResult:
    """verl-like: colocate every task on ALL GPUs (time-shared) and pick
    each task's (dp, pp, tp) independently with a homogenized view of the
    cluster; evaluated on the real topology."""
    fake = _homogenized(topo)
    cm_fake = CostModel(fake, wf, eta=eta)
    cm_real = CostModel(topo, wf, eta=eta)
    grouping = (tuple(range(wf.n_tasks)),)
    sizes = [topo.n]
    order = list(range(topo.n))
    evals = 0

    # rank each task's full-cluster factorizations by homogenized cost
    ranked: Dict[int, List[Tuple[int, int, int]]] = {}
    for t in range(wf.n_tasks):
        cands = _full_cluster_factorizations(
            topo.n, wf.task(t).model.n_layers)
        scored = []
        for par_t in cands:
            par = {u: par_t if u == t else (topo.n, 1, 1)
                   for u in range(wf.n_tasks)}
            plan = enum_mod.build_plan(fake, wf, grouping, sizes, order,
                                       parallel=par)
            evals += 1
            scored.append((cm_fake.task_cost(plan, t).total, par_t))
        scored.sort(key=lambda x: x[0])
        ranked[t] = [p for _, p in scored]

    # combine per-task bests; walk down ranks until memory-feasible
    best_plan, best_cost = None, math.inf
    depth = [0] * wf.n_tasks
    for trial in range(budget):
        par = {t: ranked[t][min(depth[t], len(ranked[t]) - 1)]
               for t in range(wf.n_tasks)}
        plan = enum_mod.build_plan(topo, wf, grouping, sizes, order,
                                   parallel=par)
        evals += 1
        ok, msg = check_constraints(topo, wf, plan)
        if ok:
            c = cm_real.cost(plan)
            if c < best_cost:
                best_cost, best_plan = c, plan
            break
        # bump the rank of the task contributing most memory (more pp/tp)
        t_heavy = max(
            range(wf.n_tasks),
            key=lambda t: wf.task(t).model.total_weight_count
            * (16 if wf.task(t).kind == TaskKind.TRAIN else 2)
            / max(par[t][1] * par[t][2], 1))
        if depth[t_heavy] + 1 >= len(ranked[t_heavy]):
            break
        depth[t_heavy] += 1
    if best_plan is None:
        # fall back to the most memory-sharded factorization per task
        par = {}
        for t in range(wf.n_tasks):
            cands = _full_cluster_factorizations(
                topo.n, wf.task(t).model.n_layers)
            par[t] = max(cands, key=lambda p: (p[1] * p[2], p[2]))
        plan = enum_mod.build_plan(topo, wf, grouping, sizes, order,
                                   parallel=par)
        evals += 1
        if check_constraints(topo, wf, plan)[0]:
            best_plan, best_cost = plan, cm_real.cost(plan)
    return SearchResult(best_plan, best_cost, evals, grouping, tuple(sizes))


# ---------------------------------------------------------------------------
# StreamRL-like
# ---------------------------------------------------------------------------

def streamrl_scheduler(topo: Topology, wf: RLWorkflow, budget: int = 256,
                       eta: Optional[float] = None) -> SearchResult:
    """Two groups (gen | rest), each a homogeneous same-region island."""
    cm = CostModel(topo, wf, eta=eta)
    gen_tasks = tuple(t for t in range(wf.n_tasks)
                      if wf.task(t).kind == TaskKind.GEN)
    rest = tuple(t for t in range(wf.n_tasks) if t not in gen_tasks)
    grouping = (gen_tasks, rest)
    # homogeneous islands: (region, spec) -> device ids
    islands: Dict[Tuple[str, str], List[int]] = {}
    for d in topo.devices:
        islands.setdefault((d.region, d.spec.name), []).append(d.id)
    island_list = sorted(islands.values(), key=len, reverse=True)
    best = SearchResult(None, math.inf, 0, grouping)
    evals = 0
    # pick one subset of islands for gen, the rest for training
    for r in range(1, len(island_list)):
        for combo in itertools.combinations(range(len(island_list)), r):
            if evals >= budget:
                break
            gen_devs = [d for i in combo for d in island_list[i]]
            rest_devs = [d for i in range(len(island_list))
                         if i not in combo for d in island_list[i]]
            if not gen_devs or not rest_devs:
                continue
            order = gen_devs + rest_devs
            sizes = [len(gen_devs), len(rest_devs)]
            # rank each task's parallelizations within its group, then walk
            # down ranks until the combined plan is memory-feasible
            ranked: Dict[int, List[Tuple[int, int, int]]] = {}
            for gi, g in enumerate(grouping):
                n_g = sizes[gi]
                for t in g:
                    cands = _full_cluster_factorizations(
                        n_g, wf.task(t).model.n_layers) or \
                        [enum_mod.default_parallelization(
                            topo, wf, t, order[:n_g] if gi == 0
                            else order[n_g:])]
                    scored = []
                    for p_t in cands:
                        plan = enum_mod.build_plan(
                            topo, wf, grouping, sizes, order,
                            parallel={t: p_t})
                        evals += 1
                        scored.append((cm.task_cost(plan, t).total, p_t))
                    scored.sort(key=lambda x: x[0])
                    ranked[t] = [p for _, p in scored]
            depth = [0] * wf.n_tasks
            for _ in range(96):
                par = {t: ranked[t][min(depth[t], len(ranked[t]) - 1)]
                       for t in range(wf.n_tasks)}
                plan = enum_mod.build_plan(topo, wf, grouping, sizes, order,
                                           parallel=par)
                evals += 1
                ok, _ = check_constraints(topo, wf, plan)
                if ok:
                    c = cm.cost(plan)
                    if c < best.cost:
                        best = SearchResult(plan, c, evals, grouping,
                                            tuple(sizes))
                    break
                t_heavy = max(
                    range(wf.n_tasks),
                    key=lambda t: wf.task(t).model.total_weight_count
                    * (16 if wf.task(t).kind == TaskKind.TRAIN else 2)
                    / max(par[t][1] * par[t][2], 1))
                if depth[t_heavy] + 1 >= len(ranked[t_heavy]):
                    break
                depth[t_heavy] += 1
    best.evals = evals
    return best


# ---------------------------------------------------------------------------
# DEAP-like pure EA
# ---------------------------------------------------------------------------

class PureEA(EvolutionarySearch):
    """Standard EA: no upgrade mutation, no Baldwinian local search."""

    def __init__(self, topo, wf, grouping, sizes, **kw):
        kw.setdefault("mutate_upgrade_p", 0.0)
        kw.setdefault("use_load_balance", False)
        super().__init__(topo, wf, grouping, sizes, **kw)

    def local_search(self, ind: Individual, max_steps: int = 0) -> Individual:
        return ind


def deap_scheduler(topo: Topology, wf: RLWorkflow, budget: int,
                   seed: int = 0, eta: Optional[float] = None) -> SearchResult:
    """Pure EA over a random-but-fixed task grouping and proportional
    sizes (it has no SHA statistics to pick high-level decisions)."""
    rng = np.random.default_rng(seed)
    groupings = enum_mod.task_groupings(wf)
    grouping = groupings[int(rng.integers(len(groupings)))]
    sizes = enum_mod.proportional_sizes(wf, grouping, topo.n)
    ea = PureEA(topo, wf, grouping, sizes, seed=seed, eta=eta)
    plan, cost = ea.run(budget)
    return SearchResult(plan, cost, ea.evals, grouping, tuple(sizes))


# ---------------------------------------------------------------------------
# Pure SHA (random low-level sampling instead of EA)
# ---------------------------------------------------------------------------

def pure_sha_scheduler(topo: Topology, wf: RLWorkflow, budget: int,
                       seed: int = 0,
                       eta: Optional[float] = None) -> SearchResult:
    from repro_torch.core.sha import HybridScheduler

    class RandomSampler(EvolutionarySearch):
        def run(self, b):
            while b > 0:
                ind = self._random_individual()
                cost = EvolutionarySearch.evaluate(self, ind)
                b -= 1
            return self.best_plan, self.best_cost

        def local_search(self, ind, max_steps: int = 0):
            return ind

    sched = HybridScheduler(topo, wf, seed=seed, eta=eta)
    sched._searchers = {}
    orig = sched._searcher

    def patched(tg, gg):
        key = (tg, gg)
        if key not in sched._searchers:
            sched._searchers[key] = RandomSampler(
                topo, wf, tg, list(gg), seed=seed + hash(key) % 65536,
                mutate_upgrade_p=0.0, use_load_balance=False, eta=eta)
        return sched._searchers[key]

    sched._searcher = patched
    return sched.search(budget)
