"""A whole run of the RL cell on the CPU at a small size, past the
harness's look for a card: sound, it is correct; with the timed path
broken underneath it is not: Adam returning the state unchanged, the
policy loss's mean over half of the rows, a token altered where it is
sampled (after its log-prob)."""
import pytest
import torch

from bench.tests import smallcells
from bench.harness import cli, spec

SEED = 2**31 + 5


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return smallcells.make_root(tmp_path_factory.mktemp("rl"))


def run(root):
    cell = spec.load_cell("qwen3-0.6b.rl_grpo", root=root)
    return cli.run(cell, SEED, 0.0, False, torch.device("cpu"), 0.0)


def state_unchanged(monkeypatch):
    from repro_torch.optim import adam
    real = adam.adam_update

    def bad(params, grads, state, cfg, **kw):
        _, _, metrics = real(params, grads, state, cfg, **kw)
        return params, state, metrics
    monkeypatch.setattr(adam, "adam_update", bad)


def half_the_rows(monkeypatch):
    from repro_torch.rl import losses
    real = losses.ppo_policy_loss

    def bad(lp_new, lp_old, adv, mask, **kw):
        return real(lp_new[::2], lp_old[::2], adv[::2], mask[::2], **kw)
    monkeypatch.setattr(losses, "ppo_policy_loss", bad)


def altered_token(monkeypatch):
    from repro_torch.models import sampling
    real = sampling.sample_with_logprobs

    def bad(gen, logits, **kw):
        tok, lp = real(gen, logits, **kw)
        return (tok + 1) % logits.shape[-1], lp
    monkeypatch.setattr(sampling, "sample_with_logprobs", bad)


def test_sound_run_is_correct(root):
    out = run(root)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"rl_samples_per_s", "setup_s"}
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("fault", [state_unchanged, half_the_rows,
                                   altered_token])
def test_broken_run_is_not_correct(root, fault, monkeypatch):
    fault(monkeypatch)
    out = run(root)
    assert not out["correct"], out["checks"]
