"""Process-wide metrics registry: counters, gauges, histograms.

Replaces the ad-hoc stats dicts scattered through the engine and
launchers with one queryable registry::

    from repro_torch.obs import metrics
    metrics.counter("gen.tokens").inc(n)
    metrics.gauge("pagepool.utilization").set(pool.utilization())
    metrics.histogram("gen.ttft_s").observe(dt)
    snap = metrics.snapshot()

``snapshot()`` returns a flat JSON-able dict: counters and gauges fold
to their value, histograms to ``{count, sum, mean, min, max, p50, p95,
p99}``.  All instruments are create-on-first-use and live for the
process; ``reset()`` clears them (tests, repeated benchmark phases).

Thread safety: counter increments take a per-counter lock; histogram
``observe`` appends to a list (atomic under the GIL); gauge ``set`` is
a plain assignment.  Histograms keep a bounded reservoir
(``_HIST_CAP`` most-recent values) so a long-running server cannot grow
without bound.

``REPRO_METRICS=<path>`` registers an atexit hook dumping a snapshot as
JSON (the CI smokes upload it as a workflow artifact).

``timer(name)`` times a block into ``histogram(name)`` in seconds.

The port keeps its own copy of ``repro.obs.metrics`` (the two packages
share no code); the instrument names are the same, and
``repro_torch.obs`` lists those the port emits.
"""
from __future__ import annotations

import atexit
import contextlib
import json
import os
import threading
import time
from typing import Dict, List, Union

__all__ = ["counter", "gauge", "histogram", "snapshot", "reset", "timer",
           "dump",
           "Counter", "Gauge", "Histogram", "Registry", "REGISTRY"]

_HIST_CAP = 65536


class Counter:
    """Monotonically increasing count."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: Union[int, float] = 1) -> None:
        with self._lock:
            self.value += n


class Gauge:
    """Last-set value."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: Union[int, float]) -> None:
        self.value = float(v)


class Histogram:
    """Value distribution with quantile summaries."""

    __slots__ = ("name", "_values", "count", "sum")

    def __init__(self, name: str):
        self.name = name
        self._values: List[float] = []
        self.count = 0
        self.sum = 0.0

    def observe(self, v: Union[int, float]) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        self._values.append(v)
        if len(self._values) > _HIST_CAP:
            del self._values[:len(self._values) - _HIST_CAP]

    def quantile(self, q: float) -> float:
        """Linear-interpolated quantile over the retained reservoir."""
        vals = sorted(self._values)
        if not vals:
            return 0.0
        if len(vals) == 1:
            return vals[0]
        pos = q * (len(vals) - 1)
        lo = int(pos)
        hi = min(lo + 1, len(vals) - 1)
        frac = pos - lo
        return vals[lo] * (1 - frac) + vals[hi] * frac

    def summary(self) -> Dict[str, float]:
        if not self._values:
            return {"count": 0, "sum": 0.0, "mean": 0.0, "min": 0.0,
                    "max": 0.0, "p50": 0.0, "p95": 0.0, "p99": 0.0}
        return {"count": self.count, "sum": self.sum,
                "mean": self.sum / max(self.count, 1),
                "min": min(self._values), "max": max(self._values),
                "p50": self.quantile(0.50), "p95": self.quantile(0.95),
                "p99": self.quantile(0.99)}


class Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: Dict[str, object] = {}

    def _get(self, name: str, cls):
        inst = self._instruments.get(name)
        if inst is None:
            with self._lock:
                inst = self._instruments.get(name)
                if inst is None:
                    inst = cls(name)
                    self._instruments[name] = inst
        if not isinstance(inst, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(inst).__name__}, not {cls.__name__}")
        return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def snapshot(self) -> Dict[str, object]:
        out: Dict[str, object] = {}
        with self._lock:
            items = list(self._instruments.items())
        for name, inst in sorted(items):
            if isinstance(inst, Histogram):
                out[name] = inst.summary()
            else:
                out[name] = inst.value
        return out

    def reset(self) -> None:
        with self._lock:
            self._instruments.clear()


REGISTRY = Registry()


def counter(name: str) -> Counter:
    return REGISTRY.counter(name)


def gauge(name: str) -> Gauge:
    return REGISTRY.gauge(name)


def histogram(name: str) -> Histogram:
    return REGISTRY.histogram(name)


@contextlib.contextmanager
def timer(name: str):
    """Time a block into ``histogram(name)`` (seconds): the recovery
    benchmarks wrap detection/replan/restore windows with it."""
    t0 = time.monotonic()
    try:
        yield
    finally:
        histogram(name).observe(time.monotonic() - t0)


def snapshot() -> Dict[str, object]:
    return REGISTRY.snapshot()


def reset() -> None:
    REGISTRY.reset()


def dump(path: str) -> str:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(snapshot(), f, indent=2, sort_keys=True)
    return path


def _env_setup() -> None:
    path = os.environ.get("REPRO_METRICS", "")
    if path in ("", "0"):
        return

    def _dump():
        if REGISTRY._instruments:
            dump(path if path not in ("1", "true", "yes")
                 else "metrics.json")

    atexit.register(_dump)


_env_setup()
