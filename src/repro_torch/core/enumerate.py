"""Search-space enumeration for the multi-level framework (§3.2).

Level 1: task groupings — set partitions of the task set (Bell number B_T).
Level 2: GPU group sizes — compositions of N into |grouping| positive parts;
         candidates are generated load-proportionally + perturbations.
Level 4: intra-model parallelizations — (dp, pp, tp) with dp*pp*tp <= n_t.
Plan construction helpers turn (grouping, sizes, device order, par) into a
full Plan with contiguous tasklet mapping (Level 3/5 defaults the EA mutates).
"""
from __future__ import annotations

import itertools
import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.plan import Plan, TaskGroup, feasible_parallelizations
from repro_torch.core.topology import Topology
from repro_torch.core.workflow import RLWorkflow, TaskKind
from repro_torch.core.costmodel import flops_per_layer


def set_partitions(items: Sequence[int]) -> List[Tuple[Tuple[int, ...], ...]]:
    """All set partitions (B_|items| of them), each sorted canonically."""
    items = list(items)
    if not items:
        return [()]
    first, rest = items[0], items[1:]
    out = []
    for part in set_partitions(rest):
        # put `first` into each existing block, or into its own block
        for i in range(len(part)):
            blocks = [tuple(sorted((first,) + part[i])) if j == i else part[j]
                      for j in range(len(part))]
            out.append(tuple(sorted(blocks)))
        out.append(tuple(sorted(part + ((first,),))))
    return sorted(set(out))


def task_groupings(wf: RLWorkflow) -> List[Tuple[Tuple[int, ...], ...]]:
    return set_partitions(range(wf.n_tasks))


def priority_groupings(wf: RLWorkflow) -> List[Tuple[Tuple[int, ...], ...]]:
    """Canonical groupings worth always trying first: colocate-all,
    fully-disaggregated, gen|rest (StreamRL's), by-kind, train|rest."""
    all_t = tuple(range(wf.n_tasks))
    gen = tuple(t for t in all_t if wf.task(t).kind == TaskKind.GEN)
    inf = tuple(t for t in all_t if wf.task(t).kind == TaskKind.INF)
    train = tuple(t for t in all_t if wf.task(t).kind == TaskKind.TRAIN)
    non_gen = tuple(t for t in all_t if t not in gen)
    non_train = tuple(t for t in all_t if t not in train)
    cands = [
        (all_t,),
        tuple((t,) for t in all_t),
        tuple(sorted((gen, non_gen))),
        tuple(sorted(g for g in (gen, inf, train) if g)),
        tuple(sorted((train, non_train))),
    ]
    out = []
    for c in cands:
        c = tuple(sorted(tuple(sorted(b)) for b in c if b))
        if c not in out:
            out.append(c)
    return out


def full_group_factorizations(n: int, n_layers: int,
                              max_tp: int = 8) -> List[Tuple[int, int, int]]:
    """(dp, pp, tp) with dp*pp*tp == n exactly (every device used)."""
    out = []
    for tp in (1, 2, 4, 8):
        if tp > max_tp or n % tp:
            continue
        rest = n // tp
        for pp in range(1, min(n_layers, rest) + 1):
            if rest % pp:
                continue
            out.append((rest // pp, pp, tp))
    return out


def task_load(wf: RLWorkflow, tasks: Sequence[int]) -> float:
    """Relative FLOP load of a set of tasks (drives proportional sizing)."""
    tot = 0.0
    for t in tasks:
        task = wf.task(t)
        seq = wf.seq_in if task.kind == TaskKind.GEN \
            else wf.seq_in + wf.seq_out
        f = flops_per_layer(task, seq) * task.model.n_layers \
            * wf.samples_per_iter
        if task.kind == TaskKind.TRAIN:
            f *= 3
        if task.kind == TaskKind.GEN:
            f *= 3  # decode passes dominate wall-clock despite low FLOPs
        tot += f
    return tot


def proportional_sizes(wf: RLWorkflow, grouping, n_devices: int) -> List[int]:
    loads = np.array([task_load(wf, g) for g in grouping], float)
    raw = loads / loads.sum() * n_devices
    sizes = np.maximum(np.floor(raw).astype(int), 1)
    while sizes.sum() > n_devices:
        sizes[int(np.argmax(sizes))] -= 1
    while sizes.sum() < n_devices:
        sizes[int(np.argmax(raw - sizes))] += 1
    return sizes.tolist()


def candidate_group_sizes(wf: RLWorkflow, grouping, n_devices: int,
                          max_candidates: int = 16,
                          seed: int = 0) -> List[Tuple[int, ...]]:
    """Level-2 candidates: proportional + perturbations + random."""
    G = len(grouping)
    if G > n_devices:
        # more groups than devices: no composition of n_devices into G
        # positive parts exists (small pools after a fleet shrink)
        return []
    rng = np.random.default_rng(seed)
    base = proportional_sizes(wf, grouping, n_devices)
    cands = {tuple(base)}
    # single-device transfers between group pairs at several magnitudes
    for delta in (1, 2, 4, 8):
        for a in range(G):
            for b in range(G):
                if a == b or base[a] - delta < 1:
                    continue
                s = list(base)
                s[a] -= delta
                s[b] += delta
                cands.add(tuple(s))
    # random compositions
    tries = 0
    while len(cands) < max_candidates * 2 and tries < 200:
        tries += 1
        cuts = sorted(rng.choice(np.arange(1, n_devices), G - 1,
                                 replace=False)) if G > 1 else []
        sizes = np.diff([0] + list(cuts) + [n_devices])
        if (sizes >= 1).all():
            cands.add(tuple(int(x) for x in sizes))
    ordered = sorted(cands, key=lambda s: sum(
        abs(x - y) for x, y in zip(s, base)))
    return ordered[:max_candidates]


# ---------------------------------------------------------------------------
# Plan construction
# ---------------------------------------------------------------------------

def default_parallelization(topo: Topology, wf: RLWorkflow, t: int,
                            devices: Sequence[int],
                            max_tp: int = 8) -> Tuple[int, int, int]:
    """Heuristic (dp,pp,tp) for a task on a device set: use all devices,
    prefer TP within machines, PP only when memory demands it."""
    n = len(devices)
    task = wf.task(t)
    # max co-located devices on one machine within the set
    by_machine: Dict[int, int] = {}
    for d in devices:
        m = topo.devices[d].machine
        by_machine[m] = by_machine.get(m, 0) + 1
    tp = 1
    for cand in (8, 4, 2):
        if cand <= max_tp and cand <= max(by_machine.values()) \
                and n % cand == 0:
            tp = cand
            break
    # rough memory need per device at pp=1
    bytes_pp = task.model.total_weight_count * \
        (16 if task.kind == TaskKind.TRAIN else 2)
    if task.kind == TaskKind.GEN:
        from repro_torch.core.plan import MAX_DECODE_WAVE
        m = task.model
        h_kv = (m.n_kv_heads * m.head_dim) if m.n_kv_heads else m.h1
        bytes_pp += 4 * m.n_layers * h_kv * (wf.seq_in + wf.seq_out) \
            * MAX_DECODE_WAVE
    mem_min = min(topo.mem(d) for d in devices)
    pp = 1
    while bytes_pp / (tp * pp) > 0.6 * mem_min and pp < task.model.n_layers:
        pp += 1
    while (n // tp) % pp != 0 and pp < n // tp:
        pp += 1
    if (n // tp) % pp != 0:
        pp = 1
    dp = max(n // (tp * pp), 1)
    return dp, pp, tp


def build_plan(topo: Topology, wf: RLWorkflow, grouping,
               sizes: Sequence[int], device_order: Sequence[int],
               parallel: Optional[Dict[int, Tuple[int, int, int]]] = None,
               tasklet_order: Optional[Dict[int, Sequence[int]]] = None,
               ) -> Plan:
    """Contiguous plan: device_order is split by sizes into groups; each
    task maps tasklets onto its group's devices in order (dp-major)."""
    groups = []
    off = 0
    dev_of_group = {}
    for gi, g in enumerate(grouping):
        devs = tuple(int(d) for d in device_order[off:off + sizes[gi]])
        off += sizes[gi]
        groups.append(TaskGroup(tuple(g), devs))
        dev_of_group[gi] = devs
    parallel = dict(parallel or {})
    assignment = {}
    for gi, g in enumerate(grouping):
        devs = dev_of_group[gi]
        for t in g:
            if t not in parallel:
                parallel[t] = default_parallelization(topo, wf, t, devs)
            dp, pp, tp = parallel[t]
            need = dp * pp * tp
            order = list(tasklet_order[t]) if tasklet_order and \
                t in tasklet_order else list(devs)
            if len(order) < need:
                # parallelization larger than group: shrink dp
                dp = max(len(order) // (pp * tp), 1)
                while dp * pp * tp > len(order):
                    if pp > 1:
                        pp -= 1
                    elif tp > 1:
                        tp //= 2
                    else:
                        dp = 1
                        break
                parallel[t] = (dp, pp, tp)
                need = dp * pp * tp
            assignment[t] = np.array(order[:need]).reshape(dp, pp, tp)
    return Plan(tuple(groups), parallel, assignment)
