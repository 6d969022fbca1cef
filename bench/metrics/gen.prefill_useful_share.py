"""gen.prefill_useful_share: the requests the window's one-shot admits
took in over the rows their prefills ran (``gen.admit``'s ``admitted``
and ``rows``: the whole wave for each admit), in %."""
from bench.metrics import layer_spans


def read(run):
    spans = layer_spans.device_spans(run, ("gen.admit",))
    if spans is None:
        return None
    return 100.0 * sum(a["admitted"] for _, _, a in spans) / sum(
        a["rows"] for _, _, a in spans)
