"""rl.gen_decode_step_ms: the mean device interval of the window's
single-wave GEN decode steps (``rollout.step`` device spans of
``rl/rollout.py``: the model's step and sampling), in ms."""
from bench.metrics import layer_spans


def read(run):
    spans = layer_spans.device_spans(run, ("rollout.step",))
    if spans is None:
        return None
    return 1e3 * sum(d1 - d0 for d0, d1, _ in spans) / len(spans)
