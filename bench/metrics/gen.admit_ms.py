"""gen.admit_ms: the mean device interval of the window's one-shot
admits (``gen.admit`` device spans of ``genserve/decoder.py``: the
whole-wave prefill, the slots' install and first tokens), in ms."""
from bench.metrics import layer_spans


def read(run):
    spans = layer_spans.device_spans(run, ("gen.admit",))
    if spans is None:
        return None
    return 1e3 * sum(d1 - d0 for d0, d1, _ in spans) / len(spans)
