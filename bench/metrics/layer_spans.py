"""The port's device spans in the traced window, for the readers of the
time inside a GEN step.

``repro_torch.obs.trace.device_span`` times a span on the card too: its
device interval runs from the card reaching the span's first work to its
finishing the last, on the host's ``perf_counter`` clock, the clock of the
profiler's intervals (``harness/devtrace.py``).  A program that records
no device spans gives the readers nothing to read.
"""
from __future__ import annotations

import numpy as np

from bench.harness import stats


def device_spans(run, names):
    """(device t0, device t1, args) of the traced window's device spans
    named in ``names``; None without a trace or without such spans."""
    if run.trace is None:
        return None
    from repro_torch.obs import trace
    read = getattr(trace.TRACER, "device_spans", None)
    if read is None:
        return None
    got = [(d0, d1, args) for name, _, _, d0, d1, args in read()
           if name in names]
    return got or None


def _union(spans):
    return stats.merge([s[0] for s in spans], [s[1] for s in spans])


def seconds(spans) -> float:
    """Length of the union of the spans' device intervals."""
    s, e = _union(spans)
    return float((e - s).sum())


def busy_inside(trace, spans) -> float:
    """Seconds in which the card was busy (any kernel, copy or memset of
    the trace) inside the union of the spans' device intervals."""
    bs, be = stats.merge(trace.starts, trace.ends)
    if not len(bs):
        return 0.0
    cum = np.concatenate([[0.0], np.cumsum(be - bs)])

    def before(t):
        k = np.searchsorted(bs, t, side="right")
        m = np.maximum(k - 1, 0)
        return np.where(k > 0, cum[m] + np.clip(t - bs[m], 0.0, be[m] - bs[m]),
                        0.0)
    s, e = _union(spans)
    return float((before(e) - before(s)).sum())


def starts_inside(trace, spans) -> int:
    """Device operations of the trace that start inside the union of the
    spans' device intervals."""
    starts = np.sort(trace.starts)
    s, e = _union(spans)
    return int((np.searchsorted(starts, e, side="left")
                - np.searchsorted(starts, s, side="left")).sum())
