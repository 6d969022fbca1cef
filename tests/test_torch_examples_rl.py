"""The three RL examples of ``repro_torch.examples`` against the JAX
package's scripts on the CPU.

``trace_obs`` and ``train_rl_e2e`` run greedy in both packages
(``RLConfig`` substituted by one with ``greedy=True`` in both modules)
from the reference's initial state, bridged into the port's trainer
(``RLTrainer`` substituted in both: the reference's records its initial
state and each iteration's metrics, the port's loads that state).  Then
rewards and KL agree within 1e-4 (``train_rl_e2e`` over all iterations
under ``--algorithm ppo``; greedy GRPO trains on rounding noise, see
its test), accuracies, the span report's names and counts, the
metric names and the calibrated device classes are identical, the
port's Chrome trace passes both packages' ``validate_file``, and its checkpoint, read by ``repro.checkpoint.io``,
equals its actor leaf for leaf.  ``train_rl_elastic`` runs as shipped
(sampled) at the verify recipe's settings: its drift decision, swap,
weight versions, per-epoch iterations and predictions and swap count
are the reference's.  Each example also runs as shipped, sampled, on
``--device cpu``: rewards finite and within [0, 1].  Sampled tokens are
not compared: torch cannot draw JAX's threefry streams."""
import functools
import math
import os
import re

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from torch_examples_ref import (bridged_trainer, load,  # noqa: E402
                                recording_trainer, run_port, run_ref)

from repro.checkpoint import io as jio  # noqa: E402
from repro.obs import metrics as jmetrics, trace as jtrace  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.examples import (trace_obs, train_rl_e2e,  # noqa: E402
                                  train_rl_elastic)
from repro_torch.obs import metrics as tmetrics, trace as ttrace  # noqa: E402

E2E = ["--iters", "6", "--batch", "8", "--d-model", "96", "--layers", "2",
       "--search-budget", "60", "--ckpt-every", "3"]
ELASTIC = ["--iters", "9", "--drift", "drop_tail", "--drift-at", "3",
           "--search-budget", "80", "--reschedule-budget", "100",
           "--require-switch"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on the host's
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_obs():
    """Both packages' tracer and metrics registry empty before the test
    (other tests of the worker fill them) and tracing off after it."""
    for m in (jtrace, jmetrics, ttrace, tmetrics):
        m.reset()
    yield
    for m in (jtrace, ttrace):
        m.disable()
        m.reset()
    for m in (jmetrics, tmetrics):
        m.reset()


def _greedy_pair(ref_mod, port_mod, monkeypatch):
    """Greedy in both modules, the port starting from the reference's
    initial state; returns the reference's record."""
    rec = {}
    for mod in (ref_mod, port_mod):
        monkeypatch.setattr(mod, "RLConfig",
                            functools.partial(mod.RLConfig, greedy=True))
    monkeypatch.setattr(ref_mod, "RLTrainer",
                        recording_trainer(ref_mod.RLTrainer, rec))
    monkeypatch.setattr(port_mod, "RLTrainer",
                        bridged_trainer(port_mod.RLTrainer, rec))
    return rec


def _in(path, monkeypatch):
    os.makedirs(path, exist_ok=True)
    monkeypatch.chdir(path)


def _section(out: str, title: str):
    """The lines of ``out`` under ``-- title ---`` up to a blank line."""
    lines = out.splitlines()
    i = next(i for i, ln in enumerate(lines) if ln.startswith(f"-- {title}"))
    sec = []
    for ln in lines[i + 1:]:
        if not ln.strip():
            break
        sec.append(ln)
    return sec


def test_trace_obs_greedy_matches_the_reference(tmp_path, capsys,
                                                monkeypatch):
    ref_mod = load("trace_obs")
    rec = _greedy_pair(ref_mod, trace_obs, monkeypatch)
    _in(tmp_path / "ref", monkeypatch)
    ref = run_ref(ref_mod, [], capsys, monkeypatch)
    ttrace.reset()
    tmetrics.reset()
    _in(tmp_path / "port", monkeypatch)
    out, got = run_port(trace_obs, ["--device", "cpu"], capsys)

    iters = lambda s: re.findall(r"^iter \d reward=\S+$", s, re.M)  # noqa
    assert iters(got) == iters(ref) and len(iters(got)) == 4
    np.testing.assert_allclose(
        out["rewards"], [m["reward_mean"] for m in rec["metrics"]],
        rtol=0, atol=1e-4)
    spans = lambda s: sorted(  # noqa: E731
        tuple(ln.split()[:2]) for ln in _section(s, "span report")[1:])
    # the reference's spans, named and counted alike; the port's report
    # adds its own spans inside GEN, INF and TRAIN, which the reference
    # does not have
    ref_names = {n for n, _ in spans(ref)}
    assert [s for s in spans(got) if s[0] in ref_names] == spans(ref)
    assert len(spans(ref)) == 8
    mine = dict(s for s in spans(got) if s[0] not in ref_names)
    assert set(mine) == {"gen.sample", "model.mixer", "model.ffn",
                         "model.head", "rollout.prefill", "rollout.step"}
    assert mine["rollout.prefill"] == dict(spans(ref))[
        "task.actor_generation"]
    names = lambda s: [ln.split(":")[0]  # noqa: E731
                       for ln in _section(s, "metrics snapshot")]
    assert names(got) == names(ref) == sorted(out["snapshot"])
    classes = lambda s: re.findall(  # noqa: E731
        r"'(\w+)':", _section(s, "calibration")[0])
    assert classes(got) == classes(ref) == sorted(
        out["calibration"].class_scale)
    assert "schema check: OK" in got
    path = tmp_path / "port" / "results" / "trace_obs.json"
    assert out["trace"] == "results/trace_obs.json" and path.exists()
    assert jtrace.validate_file(str(path)) == []
    assert ttrace.validate_file(str(path)) == []


def _iter_lines(out: str):
    return re.findall(r"^iter +(\d+) reward=(\S+) kl=(\S+) acc=(\S+) "
                      r"sync=(\S+)MB", out, re.M)


@pytest.mark.parametrize("algorithm", ["grpo", "ppo"])
def test_train_rl_e2e_greedy_matches_the_reference(algorithm, tmp_path,
                                                   capsys, monkeypatch):
    """The plan line, parameter count, sync MB, checkpoint MB and the
    checkpoint file under both algorithms; rewards, KL and accuracies
    under PPO.  Greedy GRPO is degenerate: the rollouts of a group are
    identical, so their advantages are the rounding noise of the group
    mean (which XLA and torch sum in different orders), whitened to O(1)
    and made a full step by Adam; its rewards part from the reference's
    once that noise has moved a greedy token (iteration 4 here), so
    GRPO is held on the first iteration's, before any update."""
    argv = E2E + ["--algorithm", algorithm]
    ref_mod = load("train_rl_e2e")
    rec = _greedy_pair(ref_mod, train_rl_e2e, monkeypatch)
    saved, real = [], train_rl_e2e.ckpt

    class Recorded:                    # the port's checkpoint writer
        @staticmethod
        def save(path, tree, **kw):
            saved.append((path, bridge.to_numpy_params(tree)))
            return real.save(path, tree, **kw)
    _in(tmp_path / "ref", monkeypatch)
    ref = run_ref(ref_mod, argv, capsys, monkeypatch)
    _in(tmp_path / "port", monkeypatch)
    monkeypatch.setattr(train_rl_e2e, "ckpt", Recorded)
    out, got = run_port(train_rl_e2e, argv + ["--device", "cpu"], capsys)
    g, r = got.splitlines(), ref.splitlines()

    assert g[0] == r[0] and g[0].startswith("actor: ")
    cut = "(executing locally on "
    assert g[1].split(cut)[0] == r[1].split(cut)[0]
    assert g[1].endswith(f"{cut}cpu)")
    gi, ri = _iter_lines(got), _iter_lines(ref)
    assert [x[0] for x in gi] == [x[0] for x in ri] == ["0", "5"]
    assert [x[4] for x in gi] == [x[4] for x in ri]        # sync MB
    ck = lambda s: re.findall(r"checkpointed actor \(\S+ MB\)", s)  # noqa
    assert ck(got) == ck(ref) and len(ck(got)) == 1
    tm, jm = out["metrics"], rec["metrics"]
    assert len(tm) == len(jm) == 6
    n = len(tm) if algorithm == "ppo" else 1
    for key in ("reward_mean", "kl"):
        np.testing.assert_allclose([m[key] for m in tm[:n]],
                                   [m[key] for m in jm[:n]], rtol=0,
                                   atol=1e-4)
    if algorithm == "ppo":
        assert [x[3] for x in gi] == [x[3] for x in ri]    # acc
        final = lambda s: re.findall(r"^final greedy.*$", s, re.M)  # noqa
        assert final(got) == final(ref)
        occ = lambda s: re.findall(r"^genserve: .*$", s, re.M)  # noqa
        assert occ(got) == occ(ref)

    (path, at_save), = saved
    assert path == "results/rl_ckpt/actor.msgpack"
    back = jio.restore(str(tmp_path / "port" / path), at_save)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(at_save)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(np.asarray(a), b)


def _drift_line(out: str) -> str:
    line = re.findall(r"^  drift detected.*$", out, re.M)
    assert len(line) == 1, out
    return re.sub(r"\(\S+s wall\)", "", line[0])


def test_train_rl_elastic_matches_the_reference(tmp_path, capsys,
                                                monkeypatch):
    _in(tmp_path / "ref", monkeypatch)
    ref = run_ref(load("train_rl_elastic"), ELASTIC, capsys, monkeypatch)
    _in(tmp_path / "port", monkeypatch)
    out, got = run_port(train_rl_elastic, ELASTIC + ["--device", "cpu"],
                        capsys)

    assert got.splitlines()[0] == ref.splitlines()[0]     # the plan
    assert _drift_line(got) == _drift_line(ref)
    assert "switch=True" in _drift_line(got)
    swap = lambda s: re.findall(r"^  plan swapped.*$", s, re.M)  # noqa
    assert swap(got) == swap(ref) and len(swap(got)) == 1
    epochs_wv = lambda s: re.findall(  # noqa: E731
        r"^iter +(\d+) epoch=(\d+) .* wv=(\d+) ", s, re.M)
    assert epochs_wv(got) == epochs_wv(ref)
    assert out["wv_trace"] == list(range(1, 10))
    report = lambda s: re.findall(  # noqa: E731
        r"^  epoch (\d+): +(\d+) iters .* predicted +(\S+)ms/iter$", s,
        re.M)
    assert report(got) == report(ref) and len(report(got)) == 2
    tail = lambda s: s.splitlines()[-2:]  # noqa: E731
    assert tail(got) == tail(ref) == ["1 drift reaction(s), 1 applied "
                                      "swap(s)", "done"]
    assert (tmp_path / "port" / "results" / "elastic_ckpt"
            / "elastic_iter00003.msgpack").exists()
    rewards = [m["reward_mean"] for m in out["metrics"]]
    assert all(math.isfinite(x) and 0.0 <= x <= 1.0 for x in rewards)


def test_examples_run_as_shipped_on_the_cpu(tmp_path, capsys, monkeypatch):
    """Sampled, as shipped, ``--device cpu``: trace_obs at its own
    settings, train_rl_e2e at small flags."""
    _in(tmp_path, monkeypatch)
    out, got = run_port(trace_obs, ["--device", "cpu"], capsys)
    assert all(math.isfinite(x) and 0.0 <= x <= 1.0 for x in out["rewards"])
    assert out["trace_errors"] == [] and "schema check: OK" in got
    assert ttrace.validate_file(out["trace"]) == []
    ttrace.disable()
    out, got = run_port(train_rl_e2e, E2E + ["--device", "cpu"], capsys)
    rewards = [m["reward_mean"] for m in out["metrics"]]
    assert len(rewards) == 6
    assert all(math.isfinite(x) and 0.0 <= x <= 1.0 for x in rewards)
    assert 0.0 <= out["accuracy"] <= 1.0
    assert (tmp_path / "results" / "rl_ckpt" / "actor.msgpack").exists()
    assert got.splitlines()[-1].startswith("genserve: ")
