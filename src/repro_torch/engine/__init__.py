"""Plan-driven execution engine (port of ``repro.engine``).

Consumes ``(RLWorkflow, Plan, Topology)`` and executes the real RL
iteration as the scheduler's plan dictates: per-task executors dispatched
stage by stage, colocated tasks serialized, disjoint GPU groups run
concurrently, async one-step off-policy double-buffering, and a measured
``Event`` timeline that shares dataclasses with ``core.simulator`` so
measured-vs-predicted comparison is one function call.  On one card
every plan group folds onto that card; in a world of ranks
(``parallel.dist``, one process per device) the plan folds onto the
ranks and each task runs sharded on its own (``placement``: a DeviceMesh
and DTensors per task).  ``Engine.apply_plan`` swaps plans
at an iteration boundary (a new plan epoch; trainer state untouched), and
``engine.elastic.ElasticController`` builds the §6 loop on top: watch a
topology feed, ``reschedule`` with a warm-start budget, checkpoint
through ``checkpoint.io``, and apply or reject the decision.
"""
from repro_torch.engine.executor import (Engine, EngineResult,  # noqa: F401
                                         MIGRATION_TASK, PlanContext)
from repro_torch.engine.pipeline import AsyncPipeline  # noqa: F401
from repro_torch.engine.placement import (TaskPlacement,  # noqa: F401
                                          build_placements)
