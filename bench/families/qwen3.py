"""The qwen3 family: a dense decoder of GQA attention (qk-norm, RoPE)
and SwiGLU, with tied embeddings.

What the benchmark needs of a family, from the configuration file's keys:
  * ``param_specs``: every weight leaf in the port's parameter layout
    (block leaves stacked over the layers) with the distribution the
    benchmark draws it from;
  * ``port_config``: the port's ``ModelConfig`` for the file (imports the
    port, so only the harness calls it);
  * the work counts: matrix-product parameters (2 N FLOPs a token, the LM
    head included) and the attention FLOPs of a prefill and of a decode
    token.
"""
from __future__ import annotations


def _dims(c):
    return (c["num_hidden_layers"], c["hidden_size"],
            c["num_attention_heads"], c["num_key_value_heads"],
            c["head_dim"], c["intermediate_size"], c["vocab_size"])


def param_specs(c):
    """path -> (shape, (kind, a, b)): kind "normal" draws a + b * N(0, 1),
    "uniform" draws U(a, b)."""
    L, d, H, KV, hd, f, V = _dims(c)
    fan = lambda n: ("normal", 0.0, n ** -0.5)       # noqa: E731
    near_one = ("normal", 1.0, 0.1)
    b = "blocks/layer0/"
    return {
        "embed/tokens": ((V, d), ("normal", 0.0, 0.02)),
        b + "norm1/scale": ((L, d), near_one),
        b + "norm2/scale": ((L, d), near_one),
        b + "attn/wq": ((L, d, H * hd), fan(d)),
        b + "attn/wkv": ((L, d, 2 * KV * hd), fan(d)),
        b + "attn/wo": ((L, H * hd, d), fan(H * hd)),
        b + "attn/q_norm/scale": ((L, hd), near_one),
        b + "attn/k_norm/scale": ((L, hd), near_one),
        b + "ffn/w_gate": ((L, d, f), fan(d)),
        b + "ffn/w_up": ((L, d, f), fan(d)),
        b + "ffn/w_down": ((L, f, d), fan(f)),
        "final_norm/scale": ((d,), near_one),
    }


def port_config(c, dtype: str):
    from repro_torch.models.config import FFN, LayerSpec, Mixer, ModelConfig
    L, d, H, KV, hd, f, V = _dims(c)
    return ModelConfig(
        name=c["name"], n_layers=L, d_model=d, n_heads=H, n_kv_heads=KV,
        head_dim=hd, d_ff=f, vocab_size=V,
        pattern=(LayerSpec(Mixer.ATTENTION, FFN.SWIGLU),),
        qk_norm=True, rope=True, rope_theta=float(c["rope_theta"]),
        tie_embeddings=bool(c["tie_word_embeddings"]),
        norm_eps=float(c["rms_norm_eps"]), dtype=dtype, source=c["source"])


def matmul_params(c) -> int:
    L, d, H, KV, hd, f, V = _dims(c)
    per = d * H * hd + d * 2 * KV * hd + H * hd * d + 3 * d * f
    return L * per + V * d


def prefill_mixer_flops(c, S: int) -> float:
    """Causal attention of one sequence of S tokens: QK^T and PV over the
    S (S + 1) / 2 visible pairs, 2 FLOPs a multiply-add, every layer."""
    L, d, H, KV, hd, f, V = _dims(c)
    return 4.0 * L * H * hd * S * (S + 1) / 2


def decode_mixer_flops(c, ctx: int) -> float:
    """Attention of one decode token over ``ctx`` cached positions."""
    L, d, H, KV, hd, f, V = _dims(c)
    return 4.0 * L * H * hd * ctx
