"""gen.decode_busy_share: the card's busy time (any kernel, copy or
memset under ``torch.profiler``) inside the device intervals of the
window's ``gen.decode`` spans, over their length, in %: how much of a
decode step the card works rather than waits for the host."""
from bench.metrics import layer_spans


def read(run):
    spans = layer_spans.device_spans(run, ("gen.decode",))
    if spans is None:
        return None
    return 100.0 * layer_spans.busy_inside(run.trace, spans) \
        / layer_spans.seconds(spans)
