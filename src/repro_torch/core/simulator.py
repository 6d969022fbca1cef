"""Discrete-event execution simulator.

Executes an RL workflow plan on the device-topology graph: tasks become
ready when their dependencies complete; a task occupies its GPU group's
devices for its cost-model duration; colocated tasks serialize on their
shared devices; asynchronous workflows overlap next-iteration generation
with current-iteration training (one-step off-policy, §2.1) after weight
sync.

Used (a) to cross-check the closed-form Appendix-B composition against an
event-driven timeline (Fig 7 analogue) and (b) by benchmarks to report
steady-state throughput of multi-iteration schedules.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Tuple

from repro_torch.core.costmodel import CostModel
from repro_torch.core.plan import Plan
from repro_torch.core.topology import Topology
from repro_torch.core.workflow import RLWorkflow, TaskKind


@dataclasses.dataclass
class Event:
    time: float
    kind: str           # "start" | "end"
    iteration: int
    task: int
    # decode-wave annotations (engine-measured GEN sub-events only): the
    # wave round index and its mean active-slot occupancy.  None for
    # task-level events — the simulator never fills these.
    wave: Optional[int] = None
    occupancy: Optional[float] = None
    # plan epoch (§6 online redeployment): which execution plan was live
    # when the event happened.  The simulator always predicts a single
    # plan, so simulated events stay at epoch 0; the engine bumps the
    # epoch at every ``apply_plan`` swap so steady-state estimates never
    # straddle a plan transition.
    epoch: int = 0
    # host wall-clock (seconds since engine construction) at which the
    # measured execution behind this event really started/ended, and the
    # id of the obs.trace span that recorded it.  Replay times (`time`)
    # follow the simulator's scheduling rules on the plan's devices;
    # `t_wall` is what the host actually observed — the pair is what
    # obs.calibrate fits scale factors from.  None on simulated events.
    t_wall: Optional[float] = None
    span: Optional[int] = None
    # device-folding collision flag (engine-measured events only): True
    # when the task's plan group shared a real device with another group
    # after folding — its replayed concurrency with other lanes is
    # nominal, the host actually serialized them.  None on simulated
    # events and on collision-free engine runs.
    collision: Optional[bool] = None


@dataclasses.dataclass
class SimResult:
    iteration_time: float     # steady-state seconds per iteration
    makespan: float
    throughput: float         # samples / s
    timeline: List[Event]


def simulate(topo: Topology, wf: RLWorkflow, plan: Plan,
             n_iterations: int = 4,
             cost_model: Optional[CostModel] = None) -> SimResult:
    cm = cost_model or CostModel(topo, wf)
    durations = {t: cm.task_cost(plan, t).total for t in range(wf.n_tasks)}
    actor_train = 4 if wf.algorithm == "ppo" else 3
    reshard = cm.c_reshard(plan, actor_train) if wf.synchronous \
        else cm.c_sync(plan, actor_train, 0)

    # device availability: devices of each group free at time x
    dev_free: Dict[int, float] = {d: 0.0 for d in range(topo.n)}
    done_at: Dict[Tuple[int, int], float] = {}   # (iter, task) -> end time
    timeline: List[Event] = []

    def devices_of(t: int) -> Tuple[int, ...]:
        return tuple(int(d) for d in plan.assignment[t].reshape(-1))

    def run_task(it: int, t: int, ready: float) -> float:
        devs = devices_of(t)
        start = max([ready] + [dev_free[d] for d in devs])
        end = start + durations[t]
        for d in devs:
            dev_free[d] = end
        timeline.append(Event(start, "start", it, t))
        timeline.append(Event(end, "end", it, t))
        done_at[(it, t)] = end
        return end

    sync_done = 0.0  # when generation weights for next iter are available
    for it in range(n_iterations):
        for t in range(wf.n_tasks):
            task = wf.task(t)
            dep_ready = max(
                [done_at.get((it, d), 0.0) for d in task.depends_on],
                default=0.0)
            if task.kind == TaskKind.GEN:
                # generation needs the *previous* iteration's synced weights
                dep_ready = max(dep_ready, sync_done)
            run_task(it, t, dep_ready)
        train_end = done_at[(it, actor_train)]
        if wf.synchronous:
            # reshard blocks everything (iteration barrier)
            sync_done = train_end + reshard
            for d in dev_free:
                dev_free[d] = max(dev_free[d], sync_done)
        else:
            # async: only the generation group waits for the weight sync
            sync_done = train_end + reshard
            for d in devices_of(0):
                dev_free[d] = max(dev_free[d], sync_done)

    makespan = max(e.time for e in timeline)
    if n_iterations >= 3:
        # steady state: time between the last two generation starts
        gen_starts = sorted(e.time for e in timeline
                            if e.task == 0 and e.kind == "start")
        iter_time = gen_starts[-1] - gen_starts[-2]
    else:
        iter_time = makespan / n_iterations
    iter_time = max(iter_time, 1e-9)
    return SimResult(iter_time, makespan,
                     wf.samples_per_iter / iter_time,
                     sorted(timeline, key=lambda e: e.time))
