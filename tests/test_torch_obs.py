"""The port's trace tooling, ``metrics.timer`` and hardware profile
against the JAX package's: ``validate_chrome`` gives the reference's
verdict lists on a good trace and on each corruption of it, ``report``
the reference's table on the same spans and clock, the trace CLI the
reference's output and exit codes; ``profile_topology`` the reference's
``HardwareInfo`` field for field.  Then the port's own device spans (the
reference has none): a plain span on the CPU, nothing while disabled,
absolute times, the device tracks of the export, and the spans of an
engine batch and a single-wave rollout inside their parents."""
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


# -- device spans ----------------------------------------------------------

class _FakeClock:
    """``DeviceClock`` with host stamps for events: a CPU test of the
    tracer's bookkeeping (the card's own clock is tested under ``-m
    cuda``)."""

    def __init__(self):
        import torch
        self.device = torch.device("cuda", 0)

    def record(self):
        return time.perf_counter()

    def at(self, event):
        return event


def _fake_cuda_tracer():
    tr = ttrace.Tracer(enabled=True)
    tr._clocks[0] = _FakeClock()
    return tr


def _cuda0():
    import torch
    return torch.device("cuda", 0)


def test_device_span_on_the_cpu_is_a_host_span():
    import torch
    tr = ttrace.Tracer(enabled=True)
    with tr.device_span("gen.decode", torch.device("cpu"), steps=2) as sp:
        sp.set("extra", 1)
    ev = tr.chrome_events()
    assert [(e["name"], e["ph"]) for e in ev] == [("gen.decode", "B"),
                                                  ("gen.decode", "E")]
    assert ev[0]["args"]["steps"] == 2 and ev[0]["args"]["extra"] == 1
    assert tr.device_spans() == []


def test_disabled_device_span_records_nothing(monkeypatch):
    import torch

    def refuse(*a, **k):
        raise AssertionError("a disabled device span made an event")
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    for tr in (ttrace.Tracer(), ttrace.TRACER):
        with tr.device_span("gen.decode", _cuda0(), steps=1) as sp:
            sp.set("k", 1)
        assert sp is ttrace._NULL_SPAN
        assert tr.n_spans() == 0 and tr.device_spans() == []
    with ttrace.device_span("rollout.step", "cuda") as sp:
        pass
    assert sp is ttrace._NULL_SPAN


def test_device_spans_are_absolute_perf_counter_seconds():
    tr = _fake_cuda_tracer()
    before = time.perf_counter()
    with tr.span("gen.round"):
        with tr.device_span("gen.decode", _cuda0(), steps=3):
            time.sleep(0.002)
        with tr.device_span("gen.admit", "cuda:0", rows=4) as sp:
            sp.set("admitted", 2)
    after = time.perf_counter()
    got = tr.device_spans()
    assert [(n, a) for n, *_, a in got] == [
        ("gen.decode", {"steps": 3}), ("gen.admit", {"rows": 4,
                                                     "admitted": 2})]
    for _, h0, h1, d0, d1, _ in got:
        assert before <= h0 <= d0 <= d1 <= h1 <= after
    assert got[0][4] - got[0][3] >= 0.002
    assert tr.device_spans() == got            # read once, kept
    tr.reset()
    assert tr.device_spans() == [] and tr.n_spans() == 0


def test_export_adds_device_tracks_that_validate(tmp_path):
    tr = _fake_cuda_tracer()
    with tr.span("gen.round"):
        with tr.device_span("gen.decode", _cuda0(), steps=1):
            with tr.span("gen.read"):
                pass
        with tr.device_span("gen.decode", _cuda0(), steps=1):
            pass
    host = tr.chrome_events()
    assert {e["ph"] for e in host} == {"B", "E"} and len(host) == 8
    path = tr.export_chrome(str(tmp_path / "t.json"))
    obj = json.loads(Path(path).read_text())
    assert ttrace.validate_chrome(obj) == []
    assert jtrace.validate_chrome(obj) == []
    ev = obj["traceEvents"]
    assert ev[:len(host)] == host
    meta = [e for e in ev if e["ph"] == "M"]
    xs = [e for e in ev if e["ph"] == "X"]
    assert len(meta) == 1 and meta[0]["args"] == {"name": "cuda:0"}
    assert [e["name"] for e in xs] == ["gen.decode"] * 2
    assert {e["tid"] for e in xs} == {meta[0]["tid"]} != {host[0]["tid"]}
    # the X events sit on the host events' clock, inside their spans
    b = [e for e in host if e["name"] == "gen.decode"]
    for x, (e0, e1) in zip(xs, zip(b[0::2], b[1::2])):
        assert e0["ts"] <= x["ts"] <= x["ts"] + x["dur"] <= e1["ts"]
        assert x["args"]["span_id"] == e0["args"]["span_id"]


def _parents():
    """span id -> (name, parent name) from the global tracer's events."""
    begins = [e for e in ttrace.TRACER.chrome_events() if e["ph"] == "B"]
    names = {e["args"]["span_id"]: e["name"] for e in begins}
    return [(e["name"], names.get(e["args"].get("parent_id")))
            for e in begins]


def test_serve_spans_on_the_cpu():
    """A tiny one-shot engine run with tracing on: ``gen.admit`` carries
    the admitted requests and the rows its prefill ran (the admitted ones
    alone), and the reads, sampling and model spans open inside their
    parents."""
    import torch
    from repro_torch.configs import archs as tarchs
    from repro_torch.genserve.decoder import GenServeConfig, serve
    from repro_torch.models import transformer as TT
    cfg = tarchs.SMOKE["qwen3-0.6b"]
    params = TT.init_params(cfg, seed=0, device="cpu")
    W, B = 2, 5
    prompts = torch.randint(0, cfg.vocab_size, (B, 6),
                            generator=torch.Generator().manual_seed(0))
    ttrace.enable()
    _, stats = serve(params, cfg, prompts, None, GenServeConfig(
        wave=W, max_new_tokens=4, decode_chunk=2, greedy=True,
        measure_ttft=True), gen_lens=[4, 1, 3, 2, 4])
    ttrace.disable()
    pairs = _parents()
    admits = [e["args"] for e in ttrace.TRACER.chrome_events()
              if e["ph"] == "B" and e["name"] == "gen.admit"]
    assert len(admits) == stats["prefills"] >= 3
    assert all(a["rows"] == a["admitted"] for a in admits)
    assert sum(a["rows"] for a in admits) == stats["prefill_rows"]
    assert sum(a["admitted"] for a in admits) == stats["admitted"] == B
    assert sorted(stats["ttft"]) == list(range(B))
    parents = {}
    for name, parent in pairs:
        parents.setdefault(name, set()).add(parent)
    assert parents["gen.admit"] == parents["gen.decode"] == {"gen.round"}
    assert parents["gen.read"] == {"gen.decode", "gen.round"}
    assert parents["gen.sample"] == {"gen.admit", "gen.decode"}
    assert parents["model.mixer"] == parents["model.ffn"] == \
        parents["model.head"] == {"gen.admit", "gen.decode"}
    n = lambda s: sum(1 for name, _ in pairs if name == s)  # noqa: E731
    assert n("model.mixer") == n("model.ffn") == \
        cfg.n_layers * n("model.head")
    assert n("gen.sample") == n("model.head")
    assert "gen.queue_depth" not in tmetrics.snapshot()


def test_rollout_spans_on_the_cpu():
    import torch
    from repro_torch.configs import archs as tarchs
    from repro_torch.models import transformer as TT
    from repro_torch.rl.rollout import SamplerConfig, generate
    cfg = tarchs.SMOKE["qwen3-0.6b"]
    params = TT.init_params(cfg, seed=0, device="cpu")
    prompts = torch.randint(0, cfg.vocab_size, (3, 5),
                            generator=torch.Generator().manual_seed(1))
    ttrace.enable()
    generate(params, cfg, prompts, None,
             SamplerConfig(max_new_tokens=4, greedy=True))
    ttrace.disable()
    pairs = _parents()
    outer = [(n, p) for n, p in pairs if n.startswith("rollout.")]
    assert outer == [("rollout.prefill", None)] + [("rollout.step", None)] * 3
    inner = {(n, p) for n, p in pairs if not n.startswith("rollout.")}
    assert inner == {(n, p) for n in ("gen.sample", "model.mixer",
                                      "model.ffn", "model.head")
                     for p in ("rollout.prefill", "rollout.step")}
