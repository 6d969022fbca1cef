"""The traced window: the card's activity under ``torch.profiler`` and
the port's host spans (``repro_torch.obs.trace``) over the same time.

The profiler records CUDA activity only (kernels, copies, memsets): no
host operator events, so a window of many thousands of launches stays
cheap to read.  Its events are read straight from the profiler's result
(``kineto_results.events()``), never exported to a file.  Device
timestamps are put on the host's ``perf_counter`` clock, the clock of the
port's spans, by a marker: after a synchronise the host reads its clock
and launches one ``torch.cuda._sleep`` spin kernel, whose recorded start
gives the offset (off by the launch latency, some microseconds).
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from bench.harness import stats

MARK = "spin_kernel"


@dataclasses.dataclass
class Trace:
    t0: float                      # traced window, host perf_counter s
    t1: float
    starts: np.ndarray             # device activity, host perf_counter s
    ends: np.ndarray
    names: List[str]
    spans: List[Tuple[float, float, str]]   # the port's host spans

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    @property
    def busy_s(self) -> float:
        return stats.busy(self.starts, self.ends, self.t0, self.t1)

    def seconds_by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = collections.defaultdict(float)
        for n, d in zip(self.names, self.ends - self.starts):
            out[n] += float(d)
        return dict(out)

    def kernel_seconds(self, patterns) -> float:
        """Device seconds of the kernels whose name holds any pattern."""
        return sum(d for n, d in self.seconds_by_name().items()
                   if any(p in n for p in patterns))

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.seconds_by_name().items(), key=lambda kv: -kv[1])
        gs, ge = stats.gaps(self.starts, self.ends, self.t0, self.t1)
        idle = sorted(stats.label_gaps(gs, ge, self.spans).items(),
                      key=lambda kv: -kv[1])
        return {"device_ops": [[n[:200], s] for n, s in ops[:top]],
                "idle_gaps": [[n, s] for n, s in idle[:top]]}


class Tracer:
    """``start()`` before the window's first unit, ``stop()`` after its
    last; both on the thread that runs the units."""

    def __init__(self, device):
        self.device = device
        self.prof = None

    def start(self) -> None:
        from repro_torch.obs import trace as obs_trace
        obs_trace.reset()
        obs_trace.enable()
        self._span_epoch = time.perf_counter()
        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        self.prof.start()
        torch.cuda.synchronize(self.device)
        self._mark = time.perf_counter()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize(self.device)
        self.t0 = time.perf_counter()

    def stop(self) -> Trace:
        from repro_torch.obs import trace as obs_trace
        torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()
        self.prof.stop()
        obs_trace.disable()
        events = [e for e in self.prof.profiler.kineto_results.events()
                  if e.device_type() == torch.autograd.DeviceType.CUDA]
        mark = [e for e in events if MARK in e.name()]
        if not mark:
            raise RuntimeError("the profiler recorded no marker kernel: "
                               "no device activity was traced")
        offset = mark[0].start_ns() * 1e-9 - self._mark
        starts = np.array([e.start_ns() for e in events]) * 1e-9 - offset
        ends = starts + np.array([e.duration_ns() for e in events]) * 1e-9
        keep = (ends > self.t0) & (starts < t1)
        names = [e.name() for e, k in zip(events, keep) if k]
        return Trace(self.t0, t1, starts[keep], ends[keep], names,
                     host_spans(obs_trace.TRACER, self._span_epoch))


def host_spans(tracer, epoch: float) -> List[Tuple[float, float, str]]:
    """The tracer's finished spans as (start, end, name) on the
    ``perf_counter`` clock (its events count from its reset)."""
    out, open_ = [], collections.defaultdict(list)
    for ev in tracer.chrome_events():
        key = (ev["tid"], ev["name"])
        if ev["ph"] == "B":
            open_[key].append(ev["ts"])
        elif ev["ph"] == "E" and open_[key]:
            t0 = open_[key].pop()
            out.append((epoch + t0 * 1e-6, epoch + ev["ts"] * 1e-6,
                        ev["name"]))
    return out
