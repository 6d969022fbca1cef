"""``repro_torch.examples.serve_batched`` against
``examples/serve_batched.py`` on the CPU, and the head dims the examples
reach against those the attention kernels take.

The reference's seeded params and prompts are bridged into the port's
run (``genserve`` substituted in both modules: the reference's records
what it was given, the port's serves the bridged copies in place of its
own draws).  Greedy tokens, the arch/wave line, the occupancy and the
sample line are identical, one-shot and with ``--prefill-chunk 16``, on
the default mixtral-8x7b smoke (sliding window, MoE) and on rwkv6-3b's;
tokens/s and TTFT are timings and are not compared."""
import re

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from torch_examples_ref import load, run_port, run_ref  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import archs  # noqa: E402
from repro_torch.examples import serve_batched  # noqa: E402
from repro_torch.kernels.decode_attention import ops as t_decode  # noqa: E402
from repro_torch.kernels.flash_attention import ops as t_flash  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ops as t_rwkv  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on the host's
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Recording:
    """The reference's ``genserve``: each call's params, prompts and
    rollout kept."""

    def __init__(self, real):
        self.real, self.calls = real, []

    def generate(self, params, cfg, prompts, *a, **k):
        ro, st = self.real.generate(params, cfg, prompts, *a, **k)
        self.calls.append((params, np.asarray(prompts), ro))
        return ro, st


class _Bridged:
    """The port's ``genserve``: serves the reference's params and prompts
    (bridged) in place of the ones it was given."""

    def __init__(self, real, ref: _Recording):
        self.real, self.ref, self.calls = real, ref, []

    def generate(self, params, cfg, prompts, *a, **k):
        jparams, jprompts, _ = self.ref.calls[0]
        params = bridge.from_numpy_params(
            jax.tree_util.tree_map(np.asarray, jparams), cfg, prompts.device)
        prompts = torch.tensor(jprompts, dtype=torch.int64,
                                  device=prompts.device)
        ro, st = self.real.generate(params, cfg, prompts, *a, **k)
        self.calls.append(ro)
        return ro, st


def _occupancy(line: str) -> str:
    return re.search(r"(mean|busy) occupancy [0-9.]+", line).group(0)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "rwkv6-3b"])
@pytest.mark.parametrize("chunk", [0, 16])
def test_serve_batched_tokens_and_stats_match_the_reference(
        arch, chunk, capsys, monkeypatch):
    argv = ["--arch", arch] + (["--prefill-chunk", str(chunk)] if chunk
                               else [])
    ref_mod = load("serve_batched")
    rec = _Recording(ref_mod.genserve)
    monkeypatch.setattr(ref_mod, "genserve", rec)
    br = _Bridged(serve_batched.genserve, rec)
    monkeypatch.setattr(serve_batched, "genserve", br)
    ref = run_ref(ref_mod, argv, capsys, monkeypatch).splitlines()
    out, got = run_port(serve_batched, argv + ["--device", "cpu"], capsys)
    got = got.splitlines()
    assert len(rec.calls) == len(br.calls) == 3     # warm-up, timed, TTFT
    for (_, _, jro), tro in zip(rec.calls, br.calls):
        np.testing.assert_array_equal(tro["sequences"].numpy(),
                                      np.asarray(jro["sequences"]))
    assert got[0] == ref[0]                # arch, windows, batch, wave
    assert _occupancy(got[1]) == _occupancy(ref[1])
    assert got[2] == ref[2]                # sample: the first row's tokens
    assert out["rollout"] is br.calls[1]
    label = "busy" if chunk else "mean"
    assert f"{label} occupancy" in got[1] and "ttft p50=" in got[1]


def _attention_free(cfg) -> bool:
    return all(s.mixer.value != "attention" for s in cfg.pattern)


def _example_configs(monkeypatch):
    """The ModelConfigs the RL examples build (``main`` stopped there:
    their ``ModelConfig`` substituted by one that records and stops)."""
    import importlib
    from repro_torch.models.config import ModelConfig

    class Built(Exception):
        pass
    out = []
    for name in ("trace_obs", "train_rl_e2e", "train_rl_elastic"):
        mod = importlib.import_module(f"repro_torch.examples.{name}")

        def build(*a, **k):
            out.append(ModelConfig(*a, **k))
            raise Built
        monkeypatch.setattr(mod, "ModelConfig", build)
        with pytest.raises(Built):
            mod.main(["--device", "cpu"])
    return out


def test_every_head_dim_the_examples_and_archs_reach_has_a_kernel(
        monkeypatch):
    """Each attention model of ``configs.archs`` (full and smoke) and of
    the examples (serve_batched serves the smokes) has its head dim
    within both attention wrappers' ``MAX_HEAD_DIM``, and each RWKV6 model
    its head size within ``rwkv6_scan``'s ``MAX_HEAD_SIZE``: on the card
    none of them raises.  The examples' actors are trace_obs's (hd 16)
    and the RL examples' (48)."""
    cfgs = [archs.get(n, smoke=s) for n in archs.ARCHS for s in (False,
                                                                 True)]
    ex = _example_configs(monkeypatch)
    assert sorted(c.resolved_head_dim for c in ex) == [16, 48, 48]
    for cfg in cfgs + ex:
        if not _attention_free(cfg):
            assert cfg.resolved_head_dim <= t_flash.MAX_HEAD_DIM, cfg.name
            assert cfg.resolved_head_dim <= t_decode.MAX_HEAD_DIM, cfg.name
        if any(s.mixer.value == "rwkv6" for s in cfg.pattern):
            assert cfg.rwkv_head_dim <= t_rwkv.MAX_HEAD_SIZE, cfg.name


@pytest.mark.parametrize("hd", [1, 7, 12, 16, 40, 100, 136, 200, 256])
def test_decode_wrapper_takes_its_head_dims_and_refuses_others(hd):
    """The decode wrapper's checks (run on the card before a launch; the
    flash wrapper's are held in ``test_torch_kernels.py``) take every head
    dim up to ``MAX_HEAD_DIM`` (256), odd ones and 16 among them, in both
    dtypes, and refuse any above it: a refusal never falls back to the
    plain version."""
    assert t_decode.MAX_HEAD_DIM == 256
    for dt in t_decode.DTYPES:
        for d, ok in ((hd, True), (hd + t_decode.MAX_HEAD_DIM, False)):
            q = torch.zeros((1, 2, d), dtype=dt)
            k = torch.zeros((1, 5, 2, d), dtype=dt)
            if ok:
                t_decode._check(q, k, k, torch.zeros((1, 5)))
            else:
                with pytest.raises(ValueError, match="head dim"):
                    t_decode._check(q, k, k, torch.zeros((1, 5)))


def test_serve_batched_runs_as_shipped_on_the_cpu(capsys):
    """Its own params and prompts (seeded torch draws), ``--device cpu``:
    every request served to its budget, the report's three lines."""
    out, got = run_port(serve_batched, ["--device", "cpu"], capsys)
    seq = out["rollout"]["sequences"]
    assert tuple(seq.shape) == (8, 48 + 32)
    assert int(seq.min()) >= 0 and int(seq.max()) < out["cfg"].vocab_size
    lines = got.splitlines()
    assert len(lines) == 3 and lines[0].startswith("arch=mixtral-8x7b")
    assert lines[2].startswith("sample: ")


def test_serve_batched_refuses_an_encoder_only_arch():
    assert archs.get("hubert-xlarge", smoke=True).is_encoder_only
    with pytest.raises(SystemExit, match="encoder-only"):
        serve_batched.main(["--arch", "hubert-xlarge", "--device", "cpu"])
