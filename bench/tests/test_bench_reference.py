"""The plain references against the port at small sizes on the CPU (the
benchmark's own weights, float32), and the reference's chunked RWKV6 scan
against its per-token recurrence."""
import json

import pytest
import torch

from bench.tests.smallcells import ROOT, SMALL_CONFIGS
from bench.families import qwen3 as fam_qwen3, rwkv6 as fam_rwkv6
from bench.harness import weights
from bench.reference import grpo, qwen3, rwkv6
from bench.reference.common import mm


def config(name):
    c = json.loads((ROOT / f"bench/configs/{name}.json").read_text())
    c.update(SMALL_CONFIGS[name])
    return c


def test_chunked_scan_is_the_recurrence():
    g = torch.Generator().manual_seed(0)
    B, S, H, N = 2, 37, 3, 8
    r, k, v = (torch.randn(B, S, H, N, generator=g) for _ in range(3))
    logw = -torch.exp(torch.randn(B, S, H, N, generator=g) - 1.5)
    u = torch.randn(H, N, generator=g)
    y1, s1 = rwkv6.scan(r, k, v, logw, u)
    y2, s2 = rwkv6.scan_stepwise(r, k, v, logw, u)
    assert torch.allclose(y1, y2, atol=1e-4, rtol=1e-4)
    assert torch.allclose(s1, s2, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name,fam,ref", [("qwen3-0.6b", fam_qwen3, qwen3),
                                          ("rwkv6-3b", fam_rwkv6, rwkv6)])
def test_reference_logits_are_the_ports(name, fam, ref):
    from repro_torch.models import transformer as T
    c = config(name)
    params = weights.make_params(fam.param_specs(c), 3, torch.float32, "cpu")
    tokens = torch.randint(0, c["vocab_size"], (2, 21),
                           generator=torch.Generator().manual_seed(1))
    port = T.forward(params, fam.port_config(c, "float32"),
                     {"tokens": tokens}, attn_impl="plain")["logits"]
    with torch.no_grad():
        mine = ref.logits(params, c, ref.hidden(params, c, tokens))
    assert (port - mine).abs().max() < 1e-4 * port.abs().max()
    lower = ref.logits(params, c, ref.hidden(params, c, tokens, "fp8"),
                       "fp8")
    assert (lower - mine).abs().max() > 1e-3 * port.abs().max()


def test_fp8_rounds_both_operands():
    g = torch.Generator().manual_seed(2)
    x, w = torch.randn(4, 64, generator=g), torch.randn(64, 8, generator=g)
    exact, low = mm(x, w), mm(x, w, "fp8")
    err = (exact - low).abs().max() / exact.abs().max()
    assert 1e-3 < err < 0.1


def test_grpo_reference_is_the_ports_arithmetic():
    from repro_torch.rl import gae, losses
    g = torch.Generator().manual_seed(4)
    B, T, G = 8, 6, 4
    mask = (torch.rand(B, T, generator=g) > 0.2).float()
    scores = torch.rand(B, generator=g)
    lp_old, lp_ref, lp_new = (-torch.rand(B, T, generator=g)
                              for _ in range(3))
    tok, _ = losses.kl_penalised_rewards(scores, lp_old, lp_ref, mask,
                                         kl_beta=0.02)
    want = gae.whiten(gae.grpo_advantages(tok.sum(1), G, mask), mask)
    got = grpo.advantages(scores, lp_old, lp_ref, mask, G, 0.02, True)
    assert torch.allclose(got, want, atol=1e-5)
    pl = losses.ppo_policy_loss(lp_new, lp_old, got, mask, clip_eps=0.2)
    mine = grpo.policy_loss_sum(lp_new, lp_old, got, mask, 0.2) / mask.sum()
    assert torch.allclose(mine, pl["loss"], atol=1e-6)
    gen = torch.tensor([[3, 12, 5], [12, 1, 2], [4, 4, 4]])
    assert grpo.alive_mask(torch.tensor([1, 1, 12]), gen, 12).tolist() == [
        [1, 1, 0], [1, 0, 0], [0, 0, 0]]
