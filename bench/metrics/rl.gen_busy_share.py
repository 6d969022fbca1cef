"""rl.gen_busy_share: the card's busy time (any kernel, copy or memset
under ``torch.profiler``) inside the device intervals of the window's
single-wave GEN (``rollout.prefill`` and ``rollout.step`` device spans
of ``rl/rollout.py``), over their length, in %."""
from bench.metrics import layer_spans


def read(run):
    spans = layer_spans.device_spans(run, ("rollout.prefill",
                                           "rollout.step"))
    if spans is None:
        return None
    return 100.0 * layer_spans.busy_inside(run.trace, spans) \
        / layer_spans.seconds(spans)
