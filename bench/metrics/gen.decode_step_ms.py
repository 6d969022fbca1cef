"""gen.decode_step_ms: the device time of the window's pure decode
rounds (``gen.decode`` device spans of ``genserve/decoder.py``, each
``steps`` wave decode steps and the read of their counts) over their
steps, in ms."""
from bench.metrics import layer_spans


def read(run):
    spans = layer_spans.device_spans(run, ("gen.decode",))
    if spans is None:
        return None
    return 1e3 * sum(d1 - d0 for d0, d1, _ in spans) / sum(
        a["steps"] for _, _, a in spans)
