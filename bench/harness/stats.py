"""The arithmetic of the end-to-end and per-layer numbers."""
from __future__ import annotations

import math
from typing import Dict, Iterable, Sequence, Tuple

import numpy as np


def p95(values: Sequence[float]) -> float:
    """Nearest-rank 95th percentile: the smallest value with at least 95%
    of the values at or below it."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    return v[max(math.ceil(0.95 * len(v)) - 1, 0)]


def rate(work: Iterable[float], spans: Iterable[Tuple[float, float]]
         ) -> float:
    """All the work of back-to-back units over all their time, from the
    first one's start to the last one's end."""
    spans = list(spans)
    return sum(work) / (max(e for _, e in spans) - min(s for s, _ in spans))


def merge(starts, ends):
    """The union of [start, end) intervals as sorted disjoint ones
    (two arrays)."""
    starts, ends = np.asarray(starts, float), np.asarray(ends, float)
    if not len(starts):
        return starts, ends
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], np.maximum.accumulate(ends[order])
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > e[:-1]
    block = np.cumsum(new) - 1
    return s[new], np.maximum.reduceat(e, np.flatnonzero(new))[
        :block[-1] + 1]


def busy(starts, ends, t0: float, t1: float) -> float:
    """Length of the union of the intervals inside [t0, t1)."""
    s, e = merge(starts, ends)
    return float(np.clip(np.minimum(e, t1) - np.maximum(s, t0), 0, None)
                 .sum())


def gaps(starts, ends, t0: float, t1: float):
    """The idle stretches of [t0, t1) that no interval covers (two
    arrays)."""
    s, e = merge(starts, ends)
    keep = (e > t0) & (s < t1)
    s, e = s[keep], e[keep]
    gs = np.concatenate([[t0], e])
    ge = np.concatenate([s, [t1]])
    gs = np.maximum(gs, t0)
    ge = np.minimum(ge, t1)
    ok = ge > gs
    return gs[ok], ge[ok]


def innermost(spans: Sequence[Tuple[float, float, str]]):
    """The nested host spans as a step function: (segment starts, the
    innermost open span's name in each, "outside spans" where none is)."""
    edges = sorted([(t0, 1, -(t1 - t0), name) for t0, t1, name in spans]
                   + [(t1, 0, 0.0, name) for t0, t1, name in spans])
    starts, names, stack = [], [], []
    for t, is_open, _, name in edges:
        if is_open:
            stack.append(name)
        elif name in stack:
            # the innermost open span of that name closes
            del stack[len(stack) - 1 - stack[::-1].index(name)]
        starts.append(t)
        names.append(stack[-1] if stack else "outside spans")
    return np.asarray(starts, float), names


def label_gaps(gs, ge, spans) -> Dict[str, float]:
    """Idle seconds by what the host was doing: each idle stretch goes to
    the innermost span open at its start."""
    seg, names = innermost(spans)
    out: Dict[str, float] = {}
    if not len(gs):
        return out
    idx = np.searchsorted(seg, gs, side="right") - 1
    for i, length in zip(idx, np.asarray(ge) - np.asarray(gs)):
        key = names[i] if i >= 0 else "outside spans"
        out[key] = out.get(key, 0.0) + float(length)
    return out
