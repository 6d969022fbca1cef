"""The frozen work counts against hand counts at small sizes, and the
families' parameter counts against the port's."""
import json

import pytest

from bench.tests.smallcells import ROOT
from bench.harness import spec
from bench.metrics import work
from bench.families import qwen3, rwkv6

QWEN = json.loads((ROOT / "bench/configs/qwen3-0.6b.json").read_text())
RWKV = json.loads((ROOT / "bench/configs/rwkv6-3b.json").read_text())
TINY = {"num_hidden_layers": 2, "num_attention_heads": 4,
        "num_key_value_heads": 2, "head_dim": 8}


def test_decode_bytes_by_hand():
    # 2 layers x (5 rows x 2 (k, v) x 2 heads x 8 + q and out 2 x 4 x 8) x 2 B
    assert work.decode_bytes(TINY, 5, 2) == 2 * (160 + 64) * 2


def test_flash_bound_by_hand():
    # S 3: 6 visible pairs x 4 heads x 8 x 4 FLOPs; bytes 3 x 12 x 8 x 2 B
    flops, nbytes = 6 * 4 * 8 * 4, 3 * 12 * 8 * 2
    assert work.flash_bound_s(TINY, 3, 2) == pytest.approx(
        2 * max(flops / work.PEAK_BF16, nbytes / work.HBM))


def test_rwkv_work_by_hand():
    # one chunk of 3 positions, one sub-chunk, N 2, one head, one row
    nbytes, flops, exps = work.rwkv_work(1, 3, 1, 2, 64)
    assert nbytes == 4 * (5 * 3 * 2 + 2 + 4)
    pairs = 3
    assert flops == (pairs * 2 * 4 + 3 * 2 * 3 + 3 * 2 * 5 + 6 * 2 * 2
                     + 3 * 2 * 6 + 4)
    assert exps == (pairs + 2 * 3) * 2 + 2
    # two sub-chunks: the cross pairs cost 2 N, not 4 N and an exponential
    b2, f2, e2 = work.rwkv_work(1, 20, 1, 1, 64)
    diag = 16 * 15 // 2 + 4 * 3 // 2
    cross = 20 * 19 // 2 - diag
    decayed = (20 - 16) + 16
    assert e2 == diag + decayed + 2 * 20 + 1
    assert f2 == (diag * 4 + cross * 2 + decayed * 2 + 20 * 3 + 20 * 3
                  + 210 * 2 + 20 * 4 + 1)
    assert work.rwkv_work(2, 20, 3, 1, 64)[1] == 6 * f2


@pytest.mark.parametrize("fam,c", [(qwen3, QWEN), (rwkv6, RWKV)])
def test_matmul_params_against_the_ports_count(fam, c):
    cfg = fam.port_config(dict(c), "float32")
    L, d = c["num_hidden_layers"], c["hidden_size"]
    norms = L * 2 * d + d
    if fam is qwen3:
        norms += L * 2 * c["head_dim"]
        assert fam.matmul_params(c) == cfg.param_count() - norms
    else:
        # the port's count gives the mixes, decay base, bonus and out
        # norm 9 d a layer, and the embedding V d beside the head's
        assert fam.matmul_params(c) == cfg.param_count() - norms \
            - L * 9 * d - c["vocab_size"] * d


def test_param_specs_are_the_ports_layout():
    import torch
    from repro_torch.models import transformer as T
    from bench.harness import weights
    for fam, c, small in ((qwen3, QWEN, {"hidden_size": 32,
                                         "intermediate_size": 64,
                                         "num_hidden_layers": 2,
                                         "num_attention_heads": 4,
                                         "num_key_value_heads": 2,
                                         "head_dim": 8, "vocab_size": 64}),
                          (rwkv6, RWKV, {"hidden_size": 64,
                                         "attention_hidden_size": 64,
                                         "head_size": 16,
                                         "intermediate_size": 96,
                                         "num_hidden_layers": 2,
                                         "vocab_size": 64})):
        c = dict(c, **small)
        cfg = fam.port_config(c, "float32")
        ours = weights.make_params(fam.param_specs(c), 5, torch.float32,
                                   "cpu")
        theirs = T.init_params(cfg, seed=0, device="cpu")

        def shapes(t, pre=""):
            out = {}
            for k, v in t.items():
                out.update(shapes(v, pre + k + "/") if isinstance(v, dict)
                           else {pre + k: tuple(v.shape)})
            return out
        assert shapes(ours) == shapes(theirs)


def test_rl_and_gen_flops_by_hand():
    mfu = spec.load_file(ROOT / "bench/metrics/rl.mfu.py", "rl_mfu")
    gmfu = spec.load_file(ROOT / "bench/metrics/gen.mfu.py", "gen_mfu")
    c = dict(QWEN, **TINY, hidden_size=16, intermediate_size=32,
             vocab_size=10)
    n2 = 2.0 * qwen3.matmul_params(c)
    att = lambda S: 4.0 * 2 * 4 * 8 * S * (S + 1) / 2      # noqa: E731
    dec = lambda ctx: 4.0 * 2 * 4 * 8 * ctx                 # noqa: E731
    P, N = 3, 2
    gen = P * n2 + att(P) + (n2 + dec(P + 1))
    fwd = (P + N) * n2 + att(P + N)
    mix = {"prompts": 2, "rollouts": 2, "prompt_len": P, "max_new_tokens": N}
    assert mfu.iteration_flops(qwen3, c, mix) == pytest.approx(
        4 * (gen + 4 * fwd))
    assert gmfu.request_flops(qwen3, c, P, 3) == pytest.approx(
        P * n2 + att(P) + 2 * n2 + dec(P + 1) + dec(P + 2))
