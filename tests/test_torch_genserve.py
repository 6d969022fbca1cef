"""The serving slice as a whole: the port's genserve engine against the
JAX engine on bridged weights (greedy: identical tokens, masks and
slot-table stats; logprobs within 2e-4), sampled mode by distribution,
and the device rule of the entry points."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.archs import SMOKE  # noqa: E402
from repro.genserve import adapter as jadapter  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.rl.rollout import SamplerConfig as JSampler  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import archs as tarchs  # noqa: E402
from repro_torch.genserve import adapter as tadapter  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import sampling as tsampling  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.rl.rollout import SamplerConfig as TSampler  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on the host's
    cores, and torch's default of one thread per core oversubscribes
    them (two launcher tests took 66 s instead of 24 s under a full
    load)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


STATS = ("decode_steps", "slot_steps", "prefills", "admitted", "retired",
         "occupancy_trace")


def _jax_generate(jp, cfg, prompts, N, eos, gen_lens):
    return jadapter.generate(
        jp, cfg, jnp.asarray(prompts), jax.random.PRNGKey(1),
        JSampler(max_new_tokens=N, eos_token=eos, greedy=True),
        wave=4, decode_chunk=3, gen_lens=gen_lens, fast_path=False)


@pytest.mark.parametrize("impl", ["plain", "kernel"])
@pytest.mark.parametrize("name", ["qwen3-0.6b", "gemma2-27b", "rwkv6-3b",
                                  "jamba-1.5-large-398b"])
def test_slice_matches_jax_engine(name, impl):
    """B=6 requests through a wave of 4 (slots recycled), prompt 12, N=10,
    greedy, an EOS token the model really emits (plus one prompt that
    already ends in it) and ragged budgets.  Jamba's smoke (attention +
    SwiGLU, Mamba + MoE) recycles slots whose conv / ssm state must be
    replaced whole at admission."""
    cfg = SMOKE[name]
    jp = JT.init_params(jax.random.PRNGKey(2), cfg)
    rng = np.random.default_rng(9)
    B, P, N = 6, 12, 10
    prompts = rng.integers(0, cfg.vocab_size, (B, P))
    gen_lens = [10, 3, 7, 1, 10, 6]
    jattn.set_attention_impl("jnp")
    probe, _ = _jax_generate(jp, cfg, prompts, N, None, None)
    eos = int(np.asarray(probe["gen_tokens"])[0, 4])
    prompts[4, -1] = eos
    ref, rstats = _jax_generate(jp, cfg, prompts, N, eos, gen_lens)

    tp = bridge.from_numpy_params(jax.tree_util.tree_map(np.asarray, jp),
                                  tarchs.SMOKE[name], "cpu")
    tattn.set_attention_impl(impl)
    try:
        out, stats = tadapter.generate(
            tp, tarchs.SMOKE[name], torch.as_tensor(prompts), None,
            TSampler(max_new_tokens=N, eos_token=eos, greedy=True),
            wave=4, decode_chunk=3, gen_lens=gen_lens, fast_path=False,
            device="cpu")
    finally:
        tattn.set_attention_impl("kernel")
    mask = np.asarray(ref["mask"])
    assert 0 < mask.sum() < B * N                 # EOS and budgets bite
    np.testing.assert_array_equal(out["gen_tokens"].numpy(),
                                  np.asarray(ref["gen_tokens"]))
    np.testing.assert_array_equal(out["mask"].numpy(), mask)
    np.testing.assert_array_equal(out["sequences"].numpy(),
                                  np.asarray(ref["sequences"]))
    np.testing.assert_allclose(out["logprobs"].numpy(),
                               np.asarray(ref["logprobs"]),
                               rtol=2e-4, atol=2e-4)
    for k in STATS:
        assert stats[k] == rstats[k], k
    assert stats["prefills"] >= 2                 # slots were recycled


def test_single_wave_fast_path_matches_engine():
    cfg = tarchs.SMOKE["qwen3-0.6b"]
    tp = TT.init_params(cfg, seed=3)
    prompts = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (4, 9)))
    sampler = TSampler(max_new_tokens=7, greedy=True, eos_token=5)
    fast, fstats = tadapter.generate(tp, cfg, prompts, None, sampler,
                                     device="cpu")
    eng, _ = tadapter.generate(tp, cfg, prompts, None, sampler,
                               fast_path=False, device="cpu")
    assert fstats["engine"] == "single-wave"
    for k in ("gen_tokens", "mask"):
        assert torch.equal(fast[k], eng[k]), k
    torch.testing.assert_close(fast["logprobs"] * fast["mask"],
                               eng["logprobs"] * eng["mask"])


def test_sampled_tokens_follow_the_softmax():
    """Categorical sampling from a torch.Generator, held by distribution
    (TV < 0.03), the way tests/test_speculative.py holds resampling."""
    rng = np.random.default_rng(0)
    V, n = 12, 40_000
    logits = torch.as_tensor(rng.standard_normal(V) * 1.5, dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    toks = tsampling.sample_tokens(gen, logits.expand(n, V),
                                   temperature=0.7)
    emp = np.bincount(toks.numpy(), minlength=V) / n
    p = torch.softmax(logits / 0.7, -1).numpy()
    assert 0.5 * np.abs(emp - p).sum() < 0.03
    lp = tsampling.token_logprobs(logits.expand(3, V), toks[:3])
    torch.testing.assert_close(lp, torch.log_softmax(logits, -1)[toks[:3]])


def test_sampled_engine_runs_and_masks():
    cfg = tarchs.SMOKE["gemma2-27b"]
    tp = TT.init_params(cfg, seed=4)
    prompts = torch.randint(0, cfg.vocab_size, (5, 8),
                            generator=torch.Generator().manual_seed(0))
    out, stats = tadapter.generate(
        tp, cfg, prompts, torch.Generator().manual_seed(1),
        TSampler(max_new_tokens=6, temperature=0.9), wave=2,
        fast_path=False, device="cpu", gen_lens=[6, 2, 4, 6, 1])
    assert out["mask"].sum(1).tolist() == [6, 2, 4, 6, 1]
    assert stats["retired"] == 5 and stats["admitted"] == 5


def test_entry_points_need_the_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tarchs.SMOKE["qwen3-0.6b"]
    tp = TT.init_params(cfg)
    prompts = torch.zeros((2, 4), dtype=torch.int64)
    with pytest.raises(RuntimeError, match="CUDA"):
        tadapter.generate(tp, cfg, prompts, None, TSampler(greedy=True))
    for arch in ("qwen3-0.6b", "rwkv6-3b", "jamba-1.5-large-398b"):
        with pytest.raises(RuntimeError, match="CUDA"):
            tserve.main(["--arch", arch, "--smoke"])
    out, _ = tadapter.generate(tp, cfg, prompts, None,
                               TSampler(max_new_tokens=2, greedy=True),
                               device="cpu")
    assert out["gen_tokens"].shape == (2, 2)


@pytest.mark.parametrize("flag", [["--prefill-chunk", "8"],
                                  ["--page-size", "8"], ["--prefix-cache"],
                                  ["--spec-k", "2"]])
def test_unported_options_raise(flag, capsys):
    """The launcher's engine flags (refused before genserve was ported)
    now serve on the CPU, and the report has each mode's line: chunked
    admission's busy occupancy, the paged admission line (a page size
    implies --prefill-chunk min(P, 16); --prefix-cache implies --page-size
    8), the prefix cache's hit rate, the speculative accept rate with
    the parity gate."""
    extra = {"--spec-k": ["--draft-arch", "qwen3-0.6b",
                          "--check-spec-parity"],
             "--prefix-cache": ["--shared-prompts", "10",
                                "--expect-prefix-hits"]}.get(flag[0], [])
    rep = tserve.main(["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu",
                       "--batch", "6", "--wave", "3", "--prompt-len", "12",
                       "--new-tokens", "5", *flag, *extra])
    out = capsys.readouterr().out
    assert rep["gen_tokens"].shape == (6, 5)
    assert float(rep["mask"].sum()) == 30
    if flag[0] == "--prefill-chunk":
        assert "admission=chunked (C=8)" in out
        assert "busy wave occupancy" in out and rep["prefill_rounds"] > 0
    elif flag[0] == "--page-size":
        assert "admission=chunked (C=12) paged (page=8)" in out
    elif flag[0] == "--prefix-cache":
        assert "paged (page=8) +prefix-cache" in out
        assert "prefix cache:" in out and rep["prefix_hit_rate"] > 0
    else:
        assert "speculative: k=2 draft=qwen3-0.6b accept rate" in out
        assert "spec parity: speculative == non-speculative" in out
        assert 0 <= rep["accept_rate"] <= 1 and rep["spec_proposed"] > 0


def test_unported_engine_arguments_raise():
    """Every engine argument of the JAX adapter is taken now; only
    ``mesh`` (sharded serving) is refused, naming ROADMAP.md §1 item 9."""
    cfg = tarchs.SMOKE["qwen3-0.6b"]
    tp = TT.init_params(cfg)
    prompts = torch.zeros((2, 4), dtype=torch.int64)
    with pytest.raises(NotImplementedError, match="item 9"):
        tadapter.generate(tp, cfg, prompts, None, TSampler(greedy=True),
                          fast_path=False, device="cpu", mesh=object())
    dcfg = dataclasses.replace(cfg, name="draft", n_layers=1)
    for kw in ({"slot_failures": {1: [0]}}, {"cancels": {1: [0]}},
               {"prefill_chunk": 4}, {"prefill_chunk": 2, "page_size": 2,
                                      "prefix_cache": True, "pool_pages": 8},
               {"spec_k": 2, "draft_params": TT.init_params(dcfg),
                "draft_cfg": dcfg},
               {"admission": "sjf", "sjf_aging": 2},
               {"decode_path": "vmapped", "prompt_lens": [4, 2]}):
        out, stats = tadapter.generate(
            tp, cfg, prompts, None, TSampler(max_new_tokens=3, greedy=True),
            fast_path=False, device="cpu", **kw)
        assert stats["engine"] == "genserve", kw
        assert out["gen_tokens"].shape == (2, 3), kw


def test_serve_launcher_on_cpu(capsys, tmp_path):
    """The launcher's report, Chrome trace (checked by the JAX package's
    schema validator) and metrics snapshot."""
    import json
    from repro.obs.trace import validate_chrome
    trace, metrics = tmp_path / "t.json", tmp_path / "m.json"
    try:
        rep = tserve.main(["--arch", "qwen3-0.6b", "--smoke", "--device",
                           "cpu", "--batch", "6", "--wave", "4",
                           "--prompt-len", "8", "--new-tokens", "5",
                           "--eos-token", "3", "--trace", str(trace),
                           "--metrics", str(metrics)])
    finally:
        tserve.obs_trace.disable()
    out = capsys.readouterr().out
    assert "valid tok/s" in out and "cost-model ideal" in out
    assert rep["prefills"] >= 2 and rep["gen_tokens"].shape == (6, 5)
    events = json.loads(trace.read_text())
    assert validate_chrome(events) == []
    names = {e["name"] for e in events["traceEvents"]}
    assert {"gen.round", "gen.admit", "gen.decode"} <= names
    snap = json.loads(metrics.read_text())
    assert snap["gen.requests"] == 6 and snap["gen.ttft_s"]["count"] == 6


def test_serve_launcher_serves_a_depth_cut():
    """``run(args, cfg=)`` serves the given config in place of --arch's:
    the first 2 layers of the Jamba smoke's pattern, as chip_smoke.py
    serves the first 4 of the full-width model."""
    import dataclasses
    base = tarchs.reduced(tarchs.JAMBA_1_5_LARGE, n_layers=3)
    cut = dataclasses.replace(base, n_layers=2, pattern=base.pattern[:2])
    rep = tserve.run(tserve.parse_args(
        ["--arch", "jamba-1.5-large-398b", "--device", "cpu", "--batch",
         "5", "--wave", "2", "--prompt-len", "6", "--new-tokens", "4"]),
        cfg=cut)
    assert rep["arch"] == cut.name and rep["gen_tokens"].shape == (5, 4)
    assert float(rep["mask"].sum()) == 20 and rep["prefills"] >= 3


def test_profile_serve_busy_time_and_device_rule():
    """The profiler report's busy time is the union of the card's
    activity intervals; the script measures the card only."""
    from repro_torch.launch import profile_serve
    assert profile_serve._busy_us([(0, 10), (5, 12), (20, 25),
                                   (21, 22)]) == 17
    with pytest.raises(SystemExit, match="measures the card"):
        profile_serve.main(["--arch", "qwen3-0.6b", "--smoke",
                            "--device", "cpu"])
