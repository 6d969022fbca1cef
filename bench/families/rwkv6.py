"""The rwkv6 family: RWKV6 ("Finch") time mix with data-dependent decay
and the RWKV channel mix, untied embeddings.

The same interface as ``families/qwen3.py``.  The time mix's scan is
counted as the port's sub-chunked algorithm computes it
(``bench.metrics.work.rwkv_work``, frozen from the port's
``chip_smoke.py``), in chunks of ``SCAN_CHUNK`` positions.
"""
from __future__ import annotations

from bench.metrics import work

SCAN_CHUNK = 64
DECAY_LORA = 64


def _dims(c):
    d = c["hidden_size"]
    return (c["num_hidden_layers"], d, d // c["head_size"], c["head_size"],
            c["intermediate_size"], c["vocab_size"], c["time_decay_lora_dim"])


def param_specs(c):
    L, d, H, N, f, V, r = _dims(c)
    fan = lambda n: ("normal", 0.0, n ** -0.5)       # noqa: E731
    near_one = ("normal", 1.0, 0.1)
    mix = ("uniform", 0.0, 1.0)
    b = "blocks/layer0/"
    return {
        "embed/tokens": ((V, d), ("normal", 0.0, 0.02)),
        "embed/lm_head": ((d, V), fan(d)),
        b + "norm1/scale": ((L, d), near_one),
        b + "norm2/scale": ((L, d), near_one),
        b + "rwkv/mu": ((L, 5, d), mix),
        b + "rwkv/w_r": ((L, d, d), fan(d)),
        b + "rwkv/w_k": ((L, d, d), fan(d)),
        b + "rwkv/w_v": ((L, d, d), fan(d)),
        b + "rwkv/w_g": ((L, d, d), fan(d)),
        b + "rwkv/w_o": ((L, d, d), fan(d)),
        b + "rwkv/decay_w1": ((L, d, r), fan(d)),
        b + "rwkv/decay_w2": ((L, r, d), fan(r)),
        # per-step decay exp(-exp(base + lora)) between about 0.99 and 0.6
        b + "rwkv/decay_base": ((L, d), ("uniform", -6.0, -3.0)),
        b + "rwkv/bonus_u": ((L, H, N), ("normal", 0.0, 0.5)),
        b + "rwkv/out_norm/scale": ((L, d), near_one),
        b + "ffn/w_key": ((L, d, f), fan(d)),
        b + "ffn/w_value": ((L, f, d), fan(f)),
        b + "ffn/w_recept": ((L, d, d), fan(d)),
        b + "ffn/mu_k": ((L, d), mix),
        b + "ffn/mu_r": ((L, d), mix),
        "final_norm/scale": ((d,), near_one),
    }


def port_config(c, dtype: str):
    from repro_torch.models.config import FFN, LayerSpec, Mixer, ModelConfig
    L, d, H, N, f, V, r = _dims(c)
    if r != DECAY_LORA:
        raise ValueError(f"the port's RWKV6 decay LoRA is {DECAY_LORA}, "
                         f"the file states {r}")
    return ModelConfig(
        name=c["name"], n_layers=L, d_model=d, n_heads=0, n_kv_heads=0,
        d_ff=f, vocab_size=V,
        pattern=(LayerSpec(Mixer.RWKV6, FFN.RWKV_CHANNEL),),
        rwkv_head_dim=N, rope=False,
        tie_embeddings=bool(c["tie_word_embeddings"]),
        norm_eps=float(c["layer_norm_epsilon"]), dtype=dtype,
        source=c["source"])


def matmul_params(c) -> int:
    L, d, H, N, f, V, r = _dims(c)
    per = 5 * d * d + 2 * d * r + 2 * d * f + d * d
    return L * per + V * d


def prefill_mixer_flops(c, S: int) -> float:
    """The scan's operations over one sequence of S tokens, every layer."""
    L, d, H, N, f, V, r = _dims(c)
    return float(L * work.rwkv_work(1, S, H, N, SCAN_CHUNK)[1])


def decode_mixer_flops(c, ctx: int) -> float:
    """One recurrence step a head: the state's decay, k v^T, the bonus
    and r . S (about 6 N^2 operations), every layer."""
    L, d, H, N, f, V, r = _dims(c)
    return 6.0 * L * H * N * N
