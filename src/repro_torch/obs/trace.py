"""Structured span tracer with Chrome-trace export.

Spans are nestable per thread and exception-safe::

    from repro_torch.obs import trace
    with trace.span("gen.round", wave=i) as sp:
        ...
        sp.set("admitted", n)

When tracing is disabled (the default) ``span`` returns a shared no-op
span: the cost is one attribute read and one method call, so
instrumentation can stay unconditionally in hot host loops.  Enabled
spans cost two ``perf_counter_ns`` reads and two list appends on a
per-thread buffer (no lock on the hot path).

``device_span(name, device)`` is a ``span`` that, with tracing on and a
CUDA ``device``, also records a timing event on the device's current
stream at enter and at exit: the interval in which the card ran the
span's work.  The events are read only when ``device_spans()`` (or the
export) asks, after the caller has synchronised; ``DeviceClock`` puts
them on the host's ``perf_counter`` clock.  Elsewhere it is a plain
``span``.  The module imports ``torch`` only when a device span is taken
with tracing on.

Export formats:

* ``export_chrome(path)`` — Chrome-trace/Perfetto JSON (``ph: B/E``
  duration events, microsecond timestamps; each device span's device
  interval an ``X`` event on one track per device, on the same clock).
  Load in ``chrome://tracing`` or https://ui.perfetto.dev.
* ``report()`` — human summary table aggregated per span name.

``validate_chrome`` schema-checks a trace object (required fields,
per-thread monotonic timestamps, matched B/E nesting); ``python -m
repro_torch.obs.trace <file>`` runs it from the command line, with the
reference's output and exit codes (0 valid, 1 invalid, 2 no file named).

A copy of ``repro.obs.trace``: the two packages share no code.

Environment: ``REPRO_TRACE=<path>`` enables tracing at import time and
registers an atexit hook exporting to ``<path>`` (``REPRO_TRACE=1``
exports to ``trace.json``); ``REPRO_TRACE=0`` / unset leaves tracing
off.
"""
from __future__ import annotations

import atexit
import itertools
import json
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["span", "device_span", "enable", "disable", "reset",
           "is_enabled", "export_chrome", "report", "validate_chrome",
           "Tracer", "DeviceClock"]

# Chrome-trace thread id of device ``i``'s track (far from the host
# threads' ``threading.get_ident()`` values)
_DEVICE_TID = 2 ** 31 - 1


class _NullSpan:
    """Shared do-nothing span handed out while tracing is disabled."""

    __slots__ = ()
    id = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, key: str, value) -> None:
        pass


_NULL_SPAN = _NullSpan()


class Span:
    """One live span: a context manager recording [t0, t1) on exit."""

    __slots__ = ("name", "args", "id", "parent_id", "_tracer", "_buf",
                 "t0_ns", "t1_ns", "seq_b")

    def __init__(self, tracer: "Tracer", name: str, args: Dict[str, Any]):
        self.name = name
        self.args = args
        self._tracer = tracer
        self.id = next(tracer._ids)
        self.parent_id = 0
        self.t0_ns = 0
        self.t1_ns = 0
        self.seq_b = 0

    def set(self, key: str, value) -> None:
        self.args[key] = value

    def __enter__(self) -> "Span":
        tr = self._tracer
        buf = tr._thread_buffer()
        stack = buf.stack
        self.parent_id = stack[-1].id if stack else 0
        stack.append(self)
        self._buf = buf
        self.seq_b = next(tr._seq)
        self.t0_ns = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.t1_ns = time.perf_counter_ns()
        seq_e = next(self._tracer._seq)
        if exc_type is not None:
            self.args["error"] = exc_type.__name__
        buf = self._buf
        # pop self even if a child span leaked (exception unwound past it)
        while buf.stack and buf.stack[-1] is not self:
            buf.stack.pop()
        if buf.stack:
            buf.stack.pop()
        buf.records.append((self.name, self.id, self.parent_id,
                            self.t0_ns, self.t1_ns, self.seq_b, seq_e,
                            self.args))
        return False


class DeviceClock:
    """CUDA event times on the host's ``perf_counter`` clock.

    One anchor: a synchronise, a host clock read, and an event recorded
    right after on the device's current stream, which the idle card
    passes at once (late by the launch latency, some microseconds).  The
    anchor event is recorded once before the synchronise too, so that its
    timed record does no set-up work.
    ``record()`` marks the current stream; ``at(event)`` reads a marked
    event as absolute ``perf_counter`` seconds.  Read events only once
    the work before them has run (``at`` waits for the event, so a read
    in a hot loop would stall the host)."""

    def __init__(self, device):
        import torch
        self._torch = torch
        self.device = torch.device(device)
        stream = torch.cuda.current_stream(self.device)
        self.anchor = torch.cuda.Event(enable_timing=True)
        self.anchor.record(stream)
        torch.cuda.synchronize(self.device)
        self.host = time.perf_counter()
        self.anchor.record(stream)

    def record(self):
        ev = self._torch.cuda.Event(enable_timing=True)
        ev.record(self._torch.cuda.current_stream(self.device))
        return ev

    def at(self, event) -> float:
        event.synchronize()
        return self.host + 1e-3 * self.anchor.elapsed_time(event)


class DeviceSpan(Span):
    """A span that also marks the device's stream at enter and exit."""

    __slots__ = ("_clock", "_ev0")

    def __init__(self, tracer: "Tracer", name: str, args: Dict[str, Any],
                 clock: DeviceClock):
        super().__init__(tracer, name, args)
        self._clock = clock

    def __enter__(self) -> "DeviceSpan":
        super().__enter__()
        self._ev0 = self._clock.record()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self._buf.device.append([self.id, self._clock.device.index,
                                 self._clock, self._ev0,
                                 self._clock.record()])
        return super().__exit__(exc_type, exc, tb)


class _ThreadBuffer:
    __slots__ = ("tid", "stack", "records", "device")

    def __init__(self, tid: int):
        self.tid = tid
        self.stack: List[Span] = []
        self.records: List[tuple] = []
        # [span id, device index, clock, start event, end event]; the
        # clock is None and the events are perf_counter seconds once read
        self.device: List[list] = []


class Tracer:
    """Span recorder.  One process-wide instance (``repro_torch.obs.trace``
    module functions) is the normal entry point; tests may instantiate
    their own."""

    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self._ids = itertools.count(1)
        self._seq = itertools.count(1)
        self._lock = threading.Lock()
        self._local = threading.local()
        self._buffers: List[_ThreadBuffer] = []
        self._epoch_ns = time.perf_counter_ns()
        self._clocks: Dict[int, DeviceClock] = {}

    # -- recording -------------------------------------------------------
    def _thread_buffer(self) -> _ThreadBuffer:
        buf = getattr(self._local, "buf", None)
        if buf is None:
            buf = _ThreadBuffer(threading.get_ident())
            self._local.buf = buf
            with self._lock:
                self._buffers.append(buf)
        return buf

    def span(self, name: str, **args):
        if not self.enabled:
            return _NULL_SPAN
        return Span(self, name, args)

    def device_span(self, name: str, device, **args):
        """``span``, timed on ``device`` too when it is a CUDA device."""
        if not self.enabled:
            return _NULL_SPAN
        kind = device if isinstance(device, str) else device.type
        if kind.split(":")[0] != "cuda":
            return Span(self, name, args)
        return DeviceSpan(self, name, args, self._clock(device))

    def _clock(self, device) -> DeviceClock:
        """The device's clock: the anchor that ``enable`` or ``reset``
        took, else one taken now (a synchronise, once)."""
        import torch
        dev = torch.device(device)
        index = torch.cuda.current_device() if dev.index is None \
            else dev.index
        clock = self._clocks.get(index)
        if clock is None:
            clock = self._clocks[index] = DeviceClock(
                torch.device("cuda", index))
        return clock

    def _anchor(self) -> None:
        """A clock for the current CUDA device, where CUDA is already
        initialised (never imports torch, never initialises CUDA)."""
        torch = sys.modules.get("torch")
        self._clocks = {}
        if torch is not None and torch.cuda.is_initialized():
            index = torch.cuda.current_device()
            self._clocks[index] = DeviceClock(torch.device("cuda", index))

    def current_span_id(self) -> int:
        """Id of the innermost live span on this thread (0 when none)."""
        if not self.enabled:
            return 0
        buf = getattr(self._local, "buf", None)
        if buf is None or not buf.stack:
            return 0
        return buf.stack[-1].id

    # -- control ---------------------------------------------------------
    def enable(self) -> None:
        if not self.enabled:
            self._anchor()
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        with self._lock:
            for buf in self._buffers:
                buf.records.clear()
                buf.stack.clear()
                buf.device.clear()
        self._epoch_ns = time.perf_counter_ns()
        self._anchor()

    # -- export ----------------------------------------------------------
    def _all_records(self) -> List[Tuple[int, tuple]]:
        """(tid, record) for every finished span, across threads."""
        with self._lock:
            return [(buf.tid, rec) for buf in self._buffers
                    for rec in list(buf.records)]

    def n_spans(self) -> int:
        return len(self._all_records())

    def _device_records(self) -> List[Tuple[int, int, tuple, float,
                                            float]]:
        """(device index, span id, host record, device t0, device t1) of
        every finished device span; reads each span's events (waiting for
        them) once."""
        host = {rec[1]: rec for _, rec in self._all_records()}
        with self._lock:
            dev = [d for buf in self._buffers for d in list(buf.device)]
        out = []
        for d in dev:
            sid, index, clock, t0, t1 = d
            if clock is not None:
                d[2:] = [None, clock.at(t0), clock.at(t1)]
            if sid in host:
                out.append((index, sid, host[sid], d[3], d[4]))
        return out

    def device_spans(self) -> List[Tuple[str, float, float, float, float,
                                         Dict[str, Any]]]:
        """(name, host t0, host t1, device t0, device t1, args) of every
        finished device span, in absolute ``perf_counter`` seconds.  The
        device interval runs from the card reaching the span's first work
        to its finishing the last.  Call after synchronising: reading an
        event waits for it."""
        return [(rec[0], rec[3] * 1e-9, rec[4] * 1e-9, t0, t1, dict(rec[7]))
                for _, _, rec, t0, t1 in self._device_records()]

    def chrome_events(self) -> List[Dict[str, Any]]:
        """Chrome-trace B/E duration events.  Events are ordered by the
        global begin/end sequence numbers taken while recording, which
        reproduces the true push/pop interleaving — per-thread nesting
        is valid by construction and timestamps are non-decreasing per
        thread (perf_counter is monotonic)."""
        pid = os.getpid()
        epoch = self._epoch_ns
        seq_events: List[Tuple[int, Dict[str, Any]]] = []
        for tid, (name, sid, parent, t0, t1, seq_b, seq_e, args) in \
                self._all_records():
            common = {"name": name, "cat": name.split(".")[0],
                      "pid": pid, "tid": tid}
            ev_args = {"span_id": sid}
            if parent:
                ev_args["parent_id"] = parent
            for k, v in args.items():
                ev_args[k] = v if isinstance(v, (int, float, str, bool,
                                                 type(None))) else repr(v)
            seq_events.append((seq_b, dict(common, ph="B",
                                           ts=(t0 - epoch) / 1e3,
                                           args=ev_args)))
            seq_events.append((seq_e, dict(common, ph="E",
                                           ts=(t1 - epoch) / 1e3)))
        seq_events.sort(key=lambda p: p[0])
        return [ev for _, ev in seq_events]

    def _device_events(self) -> List[Dict[str, Any]]:
        """The device intervals as Chrome ``X`` events on one track a
        device, each track named by an ``M`` thread-name event."""
        pid = os.getpid()
        epoch = self._epoch_ns * 1e-9
        recs = sorted(self._device_records(), key=lambda r: r[3])
        events: List[Dict[str, Any]] = [
            {"name": "thread_name", "ph": "M", "pid": pid,
             "tid": _DEVICE_TID - i, "args": {"name": f"cuda:{i}"}}
            for i in sorted({r[0] for r in recs})]
        for index, sid, rec, t0, t1 in recs:
            events.append({"name": rec[0], "cat": rec[0].split(".")[0],
                           "ph": "X", "pid": pid, "tid": _DEVICE_TID - index,
                           "ts": (t0 - epoch) * 1e6,
                           "dur": max(t1 - t0, 0.0) * 1e6,
                           "args": {"span_id": sid}})
        return events

    def export_chrome(self, path: str) -> str:
        obj = {"traceEvents": self.chrome_events() + self._device_events(),
               "displayTimeUnit": "ms"}
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(obj, f)
        return path

    def report(self) -> str:
        """Per-span-name aggregate: count, total/mean/max milliseconds."""
        agg: Dict[str, List[float]] = {}
        for _tid, (name, *_rest) in self._all_records():
            t0, t1 = _rest[2], _rest[3]
            agg.setdefault(name, []).append((t1 - t0) / 1e6)
        if not agg:
            return "(no spans recorded)"
        rows = sorted(((sum(v), name, v) for name, v in agg.items()),
                      reverse=True)
        w = max(len(name) for _, name, _ in rows)
        out = [f"{'span':<{w}}  {'count':>6}  {'total_ms':>10}  "
               f"{'mean_ms':>9}  {'max_ms':>9}"]
        for total, name, v in rows:
            out.append(f"{name:<{w}}  {len(v):>6}  {total:>10.2f}  "
                       f"{total / len(v):>9.3f}  {max(v):>9.3f}")
        return "\n".join(out)


# ---------------------------------------------------------------------------
# Module-level singleton
# ---------------------------------------------------------------------------

TRACER = Tracer()


def span(name: str, **args):
    return TRACER.span(name, **args)


def device_span(name: str, device, **args):
    return TRACER.device_span(name, device, **args)


def current_span_id() -> int:
    return TRACER.current_span_id()


def enable() -> None:
    TRACER.enable()


def disable() -> None:
    TRACER.disable()


def reset() -> None:
    TRACER.reset()


def is_enabled() -> bool:
    return TRACER.enabled


def export_chrome(path: str) -> str:
    return TRACER.export_chrome(path)


def report() -> str:
    return TRACER.report()


# ---------------------------------------------------------------------------
# Validation (schema check for CI and tests)
# ---------------------------------------------------------------------------

_VALID_PH = {"B", "E", "X", "M", "C", "i", "I"}


def validate_chrome(obj) -> List[str]:
    """Schema-check a Chrome-trace object; returns a list of problems
    (empty = valid).  Checks: traceEvents list present, required fields
    per event, known phase, per-(pid, tid) non-decreasing timestamps and
    matched B/E pairs with identical names."""
    errors: List[str] = []
    if isinstance(obj, list):
        events = obj
    elif isinstance(obj, dict) and isinstance(obj.get("traceEvents"), list):
        events = obj["traceEvents"]
    else:
        return ["trace must be a list or a dict with a traceEvents list"]
    stacks: Dict[Tuple[Any, Any], List[str]] = {}
    last_ts: Dict[Tuple[Any, Any], float] = {}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            errors.append(f"event {i}: not an object")
            continue
        missing = [k for k in ("name", "ph", "ts", "pid", "tid")
                   if k not in ev]
        if ev.get("ph") == "M":
            missing = [k for k in ("name", "ph", "pid") if k not in ev]
        if missing:
            errors.append(f"event {i}: missing fields {missing}")
            continue
        if ev["ph"] not in _VALID_PH:
            errors.append(f"event {i}: unknown phase {ev['ph']!r}")
            continue
        if ev["ph"] not in ("B", "E"):
            continue
        key = (ev["pid"], ev["tid"])
        ts = float(ev["ts"])
        if ts < last_ts.get(key, float("-inf")):
            errors.append(f"event {i}: ts {ts} decreases on tid {key}")
        last_ts[key] = ts
        stack = stacks.setdefault(key, [])
        if ev["ph"] == "B":
            stack.append(ev["name"])
        else:
            if not stack:
                errors.append(f"event {i}: E without matching B "
                              f"({ev['name']!r})")
            elif stack[-1] != ev["name"]:
                errors.append(f"event {i}: E {ev['name']!r} closes "
                              f"B {stack[-1]!r}")
                stack.pop()
            else:
                stack.pop()
    for key, stack in stacks.items():
        if stack:
            errors.append(f"tid {key}: unclosed spans {stack}")
    return errors


def validate_file(path: str) -> List[str]:
    try:
        with open(path) as f:
            obj = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        return [f"{path}: {e}"]
    return validate_chrome(obj)


def _main(argv: List[str]) -> int:
    import sys
    if not argv:
        sys.stderr.write(
            "usage: python -m repro_torch.obs.trace <trace.json>\n")
        return 2
    status = 0
    for path in argv:
        errors = validate_file(path)
        if errors:
            status = 1
            sys.stdout.write(f"{path}: INVALID\n")
            for e in errors[:20]:
                sys.stdout.write(f"  {e}\n")
        else:
            with open(path) as f:
                n = len(json.load(f).get("traceEvents", []))
            sys.stdout.write(f"{path}: valid chrome trace ({n} events, "
                             f"{n // 2} spans)\n")
    return status


# ---------------------------------------------------------------------------
# Environment hookup
# ---------------------------------------------------------------------------

def _env_setup() -> None:
    val = os.environ.get("REPRO_TRACE", "")
    if val in ("", "0"):
        return
    TRACER.enable()
    path = val if val not in ("1", "true", "yes") else "trace.json"

    def _dump():
        if TRACER.n_spans():
            TRACER.export_chrome(path)

    atexit.register(_dump)


_env_setup()


if __name__ == "__main__":
    import sys
    sys.exit(_main(sys.argv[1:]))
