"""The idle union, the rate and the 95th percentile, and the trace's
breakdown, on hand-made numbers."""
import numpy as np
import pytest

from bench.tests import smallcells  # noqa: F401  (paths)
from bench.harness import devtrace, stats


def test_p95_is_nearest_rank():
    assert stats.p95(range(1, 101)) == 95
    assert stats.p95([3.0]) == 3.0
    assert stats.p95(list(range(20, 0, -1))) == 19
    with pytest.raises(ValueError):
        stats.p95([])


def test_rate_is_all_work_over_all_time():
    assert stats.rate([10, 30], [(1.0, 2.0), (2.5, 5.0)]) == 10.0


def test_union_busy_and_gaps():
    s, e = [0, 1, 5, 6, 2], [2, 3, 6, 7, 2.5]
    ms, me = stats.merge(s, e)
    assert list(ms) == [0, 5] and list(me) == [3, 7]
    assert stats.busy(s, e, 1, 10) == 2 + 2
    gs, ge = stats.gaps(s, e, -1, 10)
    assert list(zip(gs, ge)) == [(-1, 0), (3, 5), (7, 10)]
    assert stats.busy([], [], 0, 1) == 0


def test_gaps_take_the_innermost_open_span():
    spans = [(0, 10, "a"), (3.5, 4, "b"), (5, 6, "c"), (7, 9, "d")]
    gs, ge = stats.gaps([1, 4.5], [3, 7.5], 0, 10)
    got = stats.label_gaps(gs, ge, spans)
    assert got == {"a": 1 + 1.5, "d": 2.5}
    assert stats.label_gaps(np.array([11.0]), np.array([12.0]), spans) \
        == {"outside spans": 1.0}


def test_trace_breakdown_and_kernel_time():
    tr = devtrace.Trace(0.0, 10.0, np.array([0.0, 2.0, 2.5, 6.0]),
                        np.array([1.0, 3.0, 4.0, 7.0]),
                        ["decode_kernel<bf16>", "gemm", "decode_kernel<f>",
                         "gemm"], [(0.0, 10.0, "gen.round")])
    assert tr.busy_s == pytest.approx(1 + 2 + 1)
    assert tr.kernel_seconds(("decode_kernel",)) == pytest.approx(2.5)
    bd = tr.breakdown()
    assert bd["device_ops"][0] == ["gemm", pytest.approx(2.0)]
    assert bd["idle_gaps"] == [["gen.round", pytest.approx(6.0)]]


def test_host_spans_from_the_ports_tracer():
    from repro_torch.obs import trace as obs_trace
    tr = obs_trace.Tracer(enabled=True)
    with tr.span("outer"):
        with tr.span("inner"):
            pass
    spans = devtrace.host_spans(tr, 100.0)
    names = sorted(n for _, _, n in spans)
    assert names == ["inner", "outer"]
    outer = [s for s in spans if s[2] == "outer"][0]
    inner = [s for s in spans if s[2] == "inner"][0]
    assert 100.0 <= outer[0] <= inner[0] <= inner[1] <= outer[1]
