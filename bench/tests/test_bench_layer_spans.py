"""The readers of the time inside a GEN step on hand-made numbers: the
card's intervals of a synthetic trace and the port's device spans as its
tracer hands them out.  Each gives its value by hand, and nothing
without a trace or from a program that records no device spans."""
import numpy as np
import pytest

from bench.tests import smallcells  # noqa: F401  (paths)
from bench.harness import cli, devtrace, spec

BENCH = smallcells.ROOT / "bench"

# the card: busy [0.5, 1.0) [1.2, 1.8) [2.0, 3.0) [3.5, 4.0) [6.0, 6.2)
# [6.5, 9.0)
STARTS = np.array([0.5, 1.2, 2.0, 3.5, 6.0, 6.5])
ENDS = np.array([1.0, 1.8, 3.0, 4.0, 6.2, 9.0])
# (name, device t0, device t1, args) as the program's tracer gives them
SPANS = [("gen.admit", 0.0, 1.5, {"rows": 8, "admitted": 2}),
         ("gen.decode", 1.5, 4.5, {"steps": 2, "spec_k": 0}),
         ("gen.admit", 5.5, 6.5, {"rows": 8, "admitted": 1}),
         ("gen.decode", 7.0, 8.0, {"steps": 2, "spec_k": 0}),
         ("gen.mixed", 8.0, 9.0, {"subrounds": 4, "spec_k": 0}),
         ("rollout.prefill", 0.0, 1.1, {}),
         ("rollout.step", 1.1, 2.5, {}),
         ("rollout.step", 6.1, 7.0, {})]

BY_HAND = {
    "gen.admit_ms": 1e3 * (1.5 + 1.0) / 2,
    "gen.decode_step_ms": 1e3 * (3.0 + 1.0) / 4,
    # busy inside [1.5, 4.5): 0.3 + 1.0 + 0.5; inside [7, 8): 1.0
    "gen.decode_busy_share": 100.0 * 2.8 / 4.0,
    # starts at 2.0 and 3.5
    "gen.decode_kernels_per_step": 2 / 4,
    "gen.prefill_useful_share": 100.0 * 3 / 16,
    "rl.gen_decode_step_ms": 1e3 * (1.4 + 0.9) / 2,
    # busy inside [0, 2.5): 0.5 + 0.6 + 0.5; inside [6.1, 7): 0.1 + 0.5
    "rl.gen_busy_share": 100.0 * 2.2 / 3.4,
}


def reader(name):
    return spec.load_file(BENCH / "metrics" / f"{name}.py",
                          "test_reader_" + name.replace(".", "_"))


def run_with(trace):
    return cli.Run(cell=None, family=None, units=[], setup_s=0.0,
                   trace=trace)


def synthetic_trace():
    return devtrace.Trace(0.0, 10.0, STARTS, ENDS, ["k"] * len(STARTS),
                          [(0.0, 10.0, "gen.round")])


@pytest.fixture
def tracer_spans(monkeypatch):
    from repro_torch.obs import trace as obs_trace
    # host times are the program's own and no reader takes them
    monkeypatch.setattr(obs_trace.TRACER, "device_spans", lambda: [
        (n, d0 - 0.01, d1, d0, d1, dict(a)) for n, d0, d1, a in SPANS])


@pytest.mark.parametrize("name", sorted(BY_HAND))
def test_reader_by_hand(name, tracer_spans):
    assert reader(name).read(run_with(synthetic_trace())) == \
        pytest.approx(BY_HAND[name], rel=1e-12)


@pytest.mark.parametrize("name", sorted(BY_HAND))
def test_reader_without_a_trace(name, tracer_spans):
    assert reader(name).read(run_with(None)) is None


@pytest.mark.parametrize("name", sorted(BY_HAND))
def test_reader_on_a_program_without_device_spans(name, monkeypatch):
    """A program whose tracer has no ``device_spans``, or whose window
    recorded none of the reader's spans, gives nothing to read."""
    from repro_torch.obs import trace as obs_trace
    run = run_with(synthetic_trace())
    monkeypatch.setattr(obs_trace.TRACER, "device_spans", lambda: [])
    assert reader(name).read(run) is None
    monkeypatch.setattr(obs_trace, "TRACER", object())
    assert reader(name).read(run) is None
