"""Quickstart: schedule an RL workflow on a heterogeneous cluster.

Port of ``examples/quickstart.py``:

    PYTHONPATH=src python -m repro_torch.examples.quickstart

Builds the paper's 64-GPU testbed (24xA100 + 24xL40S + 16xL4) under the
multi-country network scenario, searches for an execution plan with the
HetRL hybrid scheduler (nested SHA + EA), and compares it against the
verl-like and StreamRL-like baselines.  Host only: no device work.
"""
from __future__ import annotations

import argparse
from typing import List, Optional

from repro_torch.core import baselines, simulator, topology, workflow
from repro_torch.core.sha import HybridScheduler


def main(argv: Optional[List[str]] = None):
    argparse.ArgumentParser(description=__doc__.splitlines()[0]) \
        .parse_args(argv)
    topo = topology.build_testbed("multi_country")
    wf = workflow.make_ppo(workflow.QWEN_8B)
    print(f"cluster: {topo.n} GPUs, "
          f"{len({d.region for d in topo.devices})} regions; "
          f"workflow: {wf.algorithm} x{wf.n_tasks} tasks, "
          f"{wf.samples_per_iter} samples/iter")

    sched = HybridScheduler(topo, wf, max_groupings=16,
                            max_sizes_per_grouping=4)
    result = sched.search(budget=300)
    print(f"\nHetRL plan: {result.cost:.1f}s per iteration "
          f"({wf.samples_per_iter / result.cost:.2f} samples/s)")
    print(f"  task grouping: {result.grouping}")
    print(f"  GPU group sizes: {result.sizes}")
    for g in result.plan.groups:
        names = [wf.task(t).name for t in g.tasks]
        specs = {}
        for d in g.devices:
            specs[topo.devices[d].spec.name] = \
                specs.get(topo.devices[d].spec.name, 0) + 1
        print(f"  {names} -> {specs}")
    for t in range(wf.n_tasks):
        dp, pp, tp = result.plan.parallel[t]
        print(f"  {wf.task(t).name:22s} dp={dp:2d} pp={pp} tp={tp}")

    sim = simulator.simulate(topo, wf, result.plan)
    print(f"\nevent-driven simulator: {sim.iteration_time:.1f}s/iter "
          f"({sim.throughput:.2f} samples/s)")

    r_verl = baselines.verl_scheduler(topo, wf)
    r_srl = baselines.streamrl_scheduler(topo, wf, budget=1024)
    print(f"\nbaselines: verl {r_verl.cost:.1f}s "
          f"({r_verl.cost / result.cost:.2f}x slower), "
          f"StreamRL {r_srl.cost:.1f}s "
          f"({r_srl.cost / result.cost:.2f}x slower)")
    return {"search": result}


if __name__ == "__main__":
    main()
