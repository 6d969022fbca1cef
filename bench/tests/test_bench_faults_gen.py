"""A whole run of each serving cell on the CPU at a small size, past the
harness's look for a card: sound, it is correct; with the timed path
broken underneath (a token altered where it is sampled, the cache or
state left unwritten, half of the requests cut short) it is not."""
import pytest
import torch

from bench.tests import smallcells
from bench.harness import cli, spec

SEED = 2**31 + 99


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return smallcells.make_root(tmp_path_factory.mktemp("gen"))


def run(root, workload):
    cell = spec.load_cell(workload, root=root)
    return cli.run(cell, SEED, 0.0, False, torch.device("cpu"), 0.0)


def altered_token(monkeypatch):
    from repro_torch.models import sampling
    real = sampling.sample_with_logprobs

    def bad(gen, logits, **kw):
        tok, lp = real(gen, logits, **kw)
        return (tok + 1) % logits.shape[-1], lp
    monkeypatch.setattr(sampling, "sample_with_logprobs", bad)


def state_unchanged(monkeypatch):
    from repro_torch.models import cache, transformer
    monkeypatch.setattr(cache, "write_kv", lambda *a, **k: None)
    real = transformer._masked_copy
    monkeypatch.setattr(transformer, "_masked_copy",
                        lambda leaf, new, mask: None if mask is not None
                        else real(leaf, new, mask))
    monkeypatch.setattr(transformer, "_layer_decode",
                        _frozen_decode(transformer._layer_decode))


def _frozen_decode(real):
    def step(p, cfg, spec_, x, entry, *a, **k):
        saved = {n: t.clone() for n, t in entry.items()}
        out = real(p, cfg, spec_, x, entry, *a, **k)
        for n, t in saved.items():
            entry[n].copy_(t)
        return out
    return step


def half_cut_short(monkeypatch):
    from repro_torch.genserve import adapter
    real = adapter.serve

    def bad(params, cfg, prompts, gen, gcfg, gen_lens=None, **kw):
        gen_lens = [1 if i % 2 else n for i, n in enumerate(gen_lens)]
        return real(params, cfg, prompts, gen, gcfg, gen_lens=gen_lens, **kw)
    monkeypatch.setattr(adapter, "serve", bad)


@pytest.mark.parametrize("workload", ["qwen3-0.6b.gen_decode",
                                      "rwkv6-3b.gen_prefill"])
def test_sound_run_is_correct(root, workload):
    out = run(root, workload)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {"gen_tokens_per_s", "ttft_p95_ms",
                                   "setup_s"}


@pytest.mark.parametrize("fault", [altered_token, state_unchanged,
                                   half_cut_short])
@pytest.mark.parametrize("workload", ["qwen3-0.6b.gen_decode",
                                      "rwkv6-3b.gen_prefill"])
def test_broken_run_is_not_correct(root, workload, fault, monkeypatch):
    fault(monkeypatch)
    out = run(root, workload)
    assert not out["correct"], out["checks"]
