"""The port's trace tooling, ``metrics.timer`` and hardware profile
against the JAX package's: ``validate_chrome`` gives the reference's
verdict lists on a good trace and on each corruption of it, ``report``
the reference's table on the same spans and clock, the trace CLI the
reference's output and exit codes; ``profile_topology`` the reference's
``HardwareInfo`` field for field."""
import itertools
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import profiler as jprof, topology as jtopo  # noqa: E402
from repro.obs import metrics as jmetrics, trace as jtrace  # noqa: E402
from repro_torch.core import profiler as tprof  # noqa: E402
from repro_torch.core import topology as ttopo  # noqa: E402
from repro_torch.obs import metrics as tmetrics  # noqa: E402
from repro_torch.obs import trace as ttrace  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.fixture(autouse=True)
def _clean_obs():
    for m in (ttrace, jtrace):
        m.disable()
        m.reset()
    tmetrics.reset()
    jmetrics.reset()
    yield
    for m in (ttrace, jtrace):
        m.disable()
        m.reset()
    tmetrics.reset()


def _good(mod):
    tr = mod.Tracer(enabled=True)
    with tr.span("ok"):
        pass
    return tr.chrome_events()


def _corruptions(good):
    bad = [dict(good[0]), dict(good[1])]
    del bad[0]["ts"]
    return {
        "good": good,
        "unmatched_b": good[:1],
        "e_without_b": good[1:],
        "missing_field": bad,
        "name_mismatch": [dict(good[0]), dict(good[1], name="other")],
        "ts_decreases": [dict(good[0], ts=5.0), dict(good[1], ts=1.0)],
        "unknown_phase": [dict(good[0], ph="Q")],
        "not_an_object": [good[0], 3, good[1]],
        "not_a_trace": {"events": good},
        "metadata_event": [{"name": "process_name", "ph": "M", "pid": 1},
                           *good],
    }


def test_validate_chrome_gives_the_reference_verdicts():
    # one event list for both validators: pid, tid and timestamps match
    cases = _corruptions(_good(ttrace))
    for name, obj in cases.items():
        got, want = ttrace.validate_chrome(obj), jtrace.validate_chrome(obj)
        assert got == want, name
        assert (got == []) == (name in ("good", "metadata_event")), name
    # the port's own export validates in the reference's checker
    assert jtrace.validate_chrome(_good(ttrace)) == []


def _spans(mod, monkeypatch):
    ticks = itertools.count(0, 1_250_000)          # 1.25 ms a clock read
    monkeypatch.setattr(time, "perf_counter_ns", lambda: next(ticks))
    mod.enable()
    mod.reset()
    for i in range(3):
        with mod.span("loop.iter", i=i):
            with mod.span("loop.work"):
                pass
    with mod.span("tail"):
        pass
    rep = mod.report()
    mod.disable()
    mod.reset()
    return rep


def test_report_has_the_reference_table(monkeypatch):
    assert ttrace.report() == jtrace.report() == "(no spans recorded)"
    got, want = _spans(ttrace, monkeypatch), _spans(jtrace, monkeypatch)
    assert got == want
    assert got.splitlines()[0].split() == ["span", "count", "total_ms",
                                           "mean_ms", "max_ms"]
    assert [ln.split()[:2] for ln in got.splitlines()[1:]] == \
        [["loop.iter", "3"], ["loop.work", "3"], ["tail", "1"]]


def test_cli_gives_the_reference_output_and_exit_codes(tmp_path, capsys):
    tr = ttrace.Tracer(enabled=True)
    for i in range(4):
        with tr.span("a.b", i=i):
            with tr.span("a.c"):
                pass
    good = tr.export_chrome(str(tmp_path / "good.json"))
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"traceEvents": tr.chrome_events()[:-1]}))
    missing = str(tmp_path / "none.json")
    for argv in ([good], [str(bad)], [missing], [good, str(bad)], []):
        got = ttrace._main(argv)
        out_t = capsys.readouterr()
        want = jtrace._main(argv)
        out_j = capsys.readouterr()
        assert got == want, argv
        assert out_t.out == out_j.out, argv
        assert out_t.err == out_j.err.replace("repro.", "repro_torch."), argv
    r = subprocess.run([sys.executable, "-m", "repro_torch.obs.trace", good,
                        str(bad)], capture_output=True, text=True, timeout=60,
                       env={**os.environ, "PYTHONPATH": str(SRC)})
    assert r.returncode == 1, r.stderr
    assert r.stdout.splitlines()[0] == \
        f"{good}: valid chrome trace (16 events, 8 spans)"
    assert r.stdout.splitlines()[1] == f"{bad}: INVALID"
    assert "RuntimeWarning" not in r.stderr


def test_current_span_id_inside_and_outside_spans():
    assert ttrace.current_span_id() == 0            # disabled
    ttrace.enable()
    assert ttrace.current_span_id() == 0            # no live span
    with ttrace.span("outer") as outer:
        assert ttrace.current_span_id() == outer.id
        with ttrace.span("inner") as inner:
            assert ttrace.current_span_id() == inner.id != outer.id
        assert ttrace.current_span_id() == outer.id
    assert ttrace.current_span_id() == 0


def test_timer_observes_into_a_histogram():
    for _ in range(3):
        with tmetrics.timer("recover.replan_s"):
            pass
    with pytest.raises(ValueError):
        with tmetrics.timer("recover.replan_s"):
            raise ValueError("the block's failure still records")
    snap = tmetrics.snapshot()["recover.replan_s"]
    assert snap["count"] == 4 and 0.0 <= snap["min"] <= snap["max"] < 5.0


def test_profile_topology_equals_the_reference():
    got = tprof.profile_topology(ttopo.build_testbed("multi_country"))
    want = jprof.profile_topology(jtopo.build_testbed("multi_country"))
    for f in ("tflops", "mem_gb", "hbm_gbps"):
        assert getattr(got, f) == getattr(want, f)
    for f in ("latency_s", "bandwidth_gbps"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


def test_profile_local_on_the_cpu_only_on_request():
    prof = tprof.profile_local(device="cpu")
    assert set(prof) == {"tflops", "hbm_gbps"}
    assert prof["tflops"] > 0 and prof["hbm_gbps"] > 0
    import torch
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tprof.profile_local()
