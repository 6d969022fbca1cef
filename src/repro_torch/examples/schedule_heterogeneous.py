"""Scheduling deep-dive: all four network scenarios + the TPU-native pool,
HetRL SHA-EA vs ILP vs baselines, with async overlap and the event
timeline of the winning plan.

Port of ``examples/schedule_heterogeneous.py``:

    PYTHONPATH=src python -m repro_torch.examples.schedule_heterogeneous \\
        [--fast]

Host only: no device work.  The TPU pool's line is the cost model's
prediction for a modelled pool (``topology.build_tpu_pool``), not a
measurement.  The 8-GPU ILP runs to the reference's 60 s wall clock.
"""
from __future__ import annotations

import argparse
from typing import List, Optional

from repro_torch.core import baselines, simulator, topology, workflow
from repro_torch.core.ilp import ilp_scheduler
from repro_torch.core.sha import HybridScheduler


def schedule(topo, wf, budget):
    sched = HybridScheduler(topo, wf, max_groupings=12,
                            max_sizes_per_grouping=4)
    return sched.search(budget=budget)


def main(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true")
    args = ap.parse_args(argv)
    budget = 150 if args.fast else 400

    wf_sync = workflow.make_ppo(workflow.QWEN_8B, synchronous=True)
    wf_async = workflow.make_ppo(workflow.QWEN_8B, synchronous=False)

    print(f"{'scenario':22s} {'verl':>8s} {'streamrl':>9s} "
          f"{'hetrl':>8s} {'hetrl-async':>12s}")
    for scen in topology.SCENARIOS:
        topo = topology.build_testbed(scen)
        r_v = baselines.verl_scheduler(topo, wf_sync)
        r_s = baselines.streamrl_scheduler(topo, wf_sync, budget=1024)
        r_h = schedule(topo, wf_sync, budget)
        r_a = schedule(topo, wf_async, budget)
        print(f"{scen:22s} {r_v.cost:8.1f} {r_s.cost:9.1f} "
              f"{r_h.cost:8.1f} {r_a.cost:12.1f}")

    # TPU-native heterogeneous pool (the cost model's TPU device specs)
    tpu = topology.build_tpu_pool(n_v5e=32, n_v4=16)
    r_tpu = schedule(tpu, wf_sync, budget)
    print(f"\nTPU pool (32x v5e + 16x v4 over DCN): {r_tpu.cost:.1f}s/iter, "
          f"grouping={r_tpu.grouping}")

    # small-instance exact optimum
    small = topology.build_testbed("single_region",
                                   counts={"A100": 4, "L4": 4})
    wf_small = workflow.make_grpo(workflow.QWEN_1_7B, global_batch=64)
    r_ilp = ilp_scheduler(small, wf_small, max_seconds=60)
    r_sha = schedule(small, wf_small, budget)
    print(f"\n8-GPU exact ILP optimum: {r_ilp.cost:.2f}s; SHA-EA: "
          f"{r_sha.cost:.2f}s (gap {100 * (r_sha.cost / r_ilp.cost - 1):.1f}%)")

    # timeline of the winning multi-country plan
    topo = topology.build_testbed("multi_country")
    r = schedule(topo, wf_async, budget)
    sim = simulator.simulate(topo, wf_async, r.plan, n_iterations=3)
    print(f"\nasync timeline (multi-country, 3 iterations, "
          f"steady-state {sim.iteration_time:.1f}s/iter):")
    for ev in sim.timeline:
        if ev.kind == "start":
            print(f"  t={ev.time:8.1f}s iter{ev.iteration} start "
                  f"{wf_async.task(ev.task).name}")
    return {"ilp": r_ilp}


if __name__ == "__main__":
    main()
