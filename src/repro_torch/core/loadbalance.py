"""Load balancing (§4.2): data-level and layer-level strategies.

Data-level: skew per-replica batch fractions toward faster DP replicas for
the actor rollout (and, for fixed-length tasks, assign longer sequences to
faster GPUs — here expressed through the same fraction knob since the cost
model is sequence-homogeneous per iteration).

Layer-level: apportion pipeline-stage layer counts proportionally to each
stage's effective compute speed.

Both operate as plan post-processing, enlarging the search space exactly as
the paper describes (no invasive engine changes).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

from repro_torch.core.plan import Plan
from repro_torch.core.topology import Topology
from repro_torch.core.workflow import RLWorkflow, TaskKind


def _replica_speed(topo: Topology, plan: Plan, t: int, i: int,
                   kind: TaskKind) -> float:
    """Effective speed of DP replica i (bottleneck tasklet).

    Generation is HBM-bandwidth bound (C_hbm dominates decode), so its
    replicas are balanced by HBM bandwidth; training/inference by TFLOPS."""
    devs = plan.assignment[t][i].reshape(-1)
    if kind == TaskKind.GEN:
        return min(topo.devices[int(d)].spec.hbm_gbps for d in devs)
    return min(topo.devices[int(d)].spec.fp16_tflops for d in devs)


def _stage_speed(topo: Topology, plan: Plan, t: int, j: int) -> float:
    dp, pp, tp = plan.parallel[t]
    speeds = []
    for i in range(dp):
        for d in plan.assignment[t][i, j]:
            speeds.append(topo.devices[int(d)].spec.fp16_tflops)
    return min(speeds)


def balance_data(topo: Topology, wf: RLWorkflow, plan: Plan) -> Plan:
    """Set batch fractions proportional to replica speed (GEN + TRAIN)."""
    fractions = dict(plan.batch_fraction)
    for t in range(wf.n_tasks):
        kind = wf.task(t).kind
        if kind not in (TaskKind.GEN, TaskKind.TRAIN, TaskKind.INF):
            continue
        dp = plan.parallel[t][0]
        if dp == 1:
            continue
        speeds = np.array([_replica_speed(topo, plan, t, i, kind)
                           for i in range(dp)], float)
        frac = speeds / speeds.sum()
        fractions[t] = tuple(float(f) for f in frac)
    return dataclasses.replace(plan, batch_fraction=fractions)


def balance_layers(topo: Topology, wf: RLWorkflow, plan: Plan) -> Plan:
    """Apportion layers per pipeline stage ∝ stage speed (Hamilton)."""
    layers = dict(plan.layers_per_stage)
    for t in range(wf.n_tasks):
        dp, pp, tp = plan.parallel[t]
        if pp == 1:
            continue
        nl = wf.task(t).model.n_layers
        speeds = np.array([_stage_speed(topo, plan, t, j)
                           for j in range(pp)], float)
        quota = speeds / speeds.sum() * nl
        alloc = np.maximum(np.floor(quota).astype(int), 1)
        while alloc.sum() > nl:
            alloc[int(np.argmax(alloc))] -= 1
        while alloc.sum() < nl:
            alloc[int(np.argmax(quota - alloc))] += 1
        layers[t] = tuple(int(a) for a in alloc)
    return dataclasses.replace(plan, layers_per_stage=layers)


def balance(topo: Topology, wf: RLWorkflow, plan: Plan,
            data: bool = True, layer: bool = True,
            guard: bool = True) -> Plan:
    """Apply both strategies; with `guard`, keep each only if the cost
    model confirms it does not regress (the knob-gating a real deployment
    would do)."""
    if not guard:
        if data:
            plan = balance_data(topo, wf, plan)
        if layer:
            plan = balance_layers(topo, wf, plan)
        return plan
    from repro_torch.core.costmodel import CostModel
    cm = CostModel(topo, wf)
    cand = plan
    if data:
        cand = balance_data(topo, wf, cand)
    if layer:
        cand = balance_layers(topo, wf, cand)
    if cand is plan:
        return plan
    return cand if cm.cost(cand) <= cm.cost(plan) else plan
