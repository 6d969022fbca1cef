"""Plan-driven execution engine (port of ``repro.engine``).

Consumes ``(RLWorkflow, Plan, Topology)`` and executes the real RL
iteration as the scheduler's plan dictates: per-task executors dispatched
stage by stage, colocated tasks serialized, disjoint GPU groups run
concurrently, async one-step off-policy double-buffering, and a measured
``Event`` timeline that shares dataclasses with ``core.simulator`` so
measured-vs-predicted comparison is one function call.  On one card
every plan group folds onto that card.
"""
from repro_torch.engine.executor import (Engine, EngineResult,  # noqa: F401
                                         PlanContext)
from repro_torch.engine.pipeline import AsyncPipeline  # noqa: F401
from repro_torch.engine.placement import (TaskPlacement,  # noqa: F401
                                          build_placements)
