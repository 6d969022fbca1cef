"""gen.decode_kernels_per_step: the device operations (kernels, copies,
memsets under ``torch.profiler``) that start inside the device intervals
of the window's ``gen.decode`` spans, over their steps: the launches the
host issues for one wave decode step."""
from bench.metrics import layer_spans


def read(run):
    spans = layer_spans.device_spans(run, ("gen.decode",))
    if spans is None:
        return None
    return layer_spans.starts_inside(run.trace, spans) / sum(
        a["steps"] for _, _, a in spans)
