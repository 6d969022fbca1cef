"""Observability for the port: span tracing, metrics, calibration.

Port of ``repro.obs``; each submodule is the port's own copy (the two
packages share no code), all host-side and cheap enough to leave on:

``repro_torch.obs.trace``
    Structured span tracer.  ``with trace.span("gen.round", wave=i):``
    records a nestable, exception-safe span on the current thread;
    spans export as Chrome-trace/Perfetto JSON (``export_chrome``) or a
    human summary table (``report``).  Disabled spans cost one attribute
    read.  ``trace.device_span(name, device)`` also times the span on a
    CUDA device (events read after the caller synchronises, on the
    host's clock: ``device_spans()``).  ``REPRO_TRACE=<path>`` enables
    tracing at import and dumps the trace at interpreter exit; ``python
    -m repro_torch.obs.trace FILE.json`` validates a dump.

``repro_torch.obs.metrics``
    Process-wide registry of counters / gauges / histograms:
    ``metrics.counter("gen.tokens").inc(n)``, ``metrics.histogram(
    "gen.ttft_s").observe(dt)``, ``with metrics.timer(name):``.
    ``snapshot()`` returns a JSON-able dict (histograms fold to count/
    sum/mean/p50/p95/p99/max).  ``REPRO_METRICS=<path>`` dumps a
    snapshot at interpreter exit.

``repro_torch.obs.calibrate``
    Fits per-device-class ``CostModel`` scale factors from a measured
    ``Event`` timeline, plus a ``DivergenceMonitor`` that turns
    sustained measured/predicted drift per task into the reactive
    elasticity signal.

Span names the port emits (dotted, category = first segment; [dev]:
a device span, timed on the card too):

    engine.iteration       one Engine.run_iteration call
    engine.stage           one workflow stage dispatch
    task.<name>            one task executor (task.generation, ...)
    engine.sync            post-train weight sync to the GEN replica
    engine.swap            Engine.apply_plan plan transition
    gen.round              one genserve host round (admit+decode)
    gen.admit              [dev] one-shot admission program (args
                           admitted, rows: the rows its prefill ran)
    gen.install            chunked-admission install (+ prefix match)
    gen.mixed              [dev] mixed wave-step (decode + prefill chunk)
    gen.decode             [dev] pure decode steps (arg steps)
    gen.read               a blocking device-to-host read of the loop
    gen.sample             sampling and the slot writes after it
    rollout.prefill        [dev] single-wave GEN: the prompt's forward
    rollout.step           [dev] single-wave GEN: one decode step
    model.mixer            one layer's norm, mixer and residual
    model.ffn              one layer's norm, FFN and residual
    model.head             the final norm and the LM head
    elastic.poll           ElasticController drift reaction
    elastic.reschedule     scheduler warm-start search
    elastic.checkpoint     pre-swap checkpoint write
    elastic.checkpoint_gather   on ranks: the state gathered to rank 0
    train.step             one RLTrainer.train_step

Metric names the port emits (dotted namespaces):

    gen.*        tokens, requests, prompt_tokens, prefix_hit_tokens,
                 ttft_s, queue_wait_s, wave_occupancy,
                 sjf_skips, sjf_aged_admissions, spec_proposed,
                 spec_accepted, spec_accept_rate, slot_failures,
                 cancelled
    pagepool.*   utilization, leaked_pages
    engine.*     iter_wall_s, sync_s, plan_epoch, staleness, swaps,
                 task_retries, task_failures, deadline_misses
    placement.*  collisions, devices.<task>, tp_realized.<task>
    elastic.*    reschedule_s, checkpoint_bytes, drift_events,
                 forced_replans, ckpt_gather_s, ckpt_write_s
    checkpoint.* retries, failures
    faults.*     <kind>: injected events fired, per fault kind
    calib.*      scale.<device-class>, coeff.<device-class>.<coeff>,
                 global_scale, sync_scale, local_tflops, local_hbm_gbps

``REPRO_OBS_STRICT=1`` upgrades observability warnings (page-pool
refcount leaks at decoder teardown) to hard errors.
"""
from __future__ import annotations

__all__ = ["metrics", "trace", "calibrate"]

# submodules import on first attribute access, keeping ``python -m
# repro_torch.obs.trace`` free of the runpy double-import warning
_SUBMODULES = ("metrics", "trace", "calibrate")


def __getattr__(name: str):
    if name in _SUBMODULES:
        import importlib
        return importlib.import_module(f"repro_torch.obs.{name}")
    raise AttributeError(
        f"module 'repro_torch.obs' has no attribute {name!r}")
