"""The 10 assigned architectures (exact full configs + reduced smoke
variants).  Every entry cites its source in ``source``.
"""
from __future__ import annotations

from repro_torch.models.config import FFN, LayerSpec, Mixer, ModelConfig, reduced

A = Mixer.ATTENTION
M = Mixer.MAMBA
R6 = Mixer.RWKV6


PHI3_MEDIUM_14B = ModelConfig(
    name="phi3-medium-14b",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=10, head_dim=128,
    d_ff=17920, vocab_size=100352,
    pattern=(LayerSpec(A, FFN.SWIGLU),),
    rope=True, rope_theta=10_000.0,
    source="arXiv:2404.14219 (Phi-3 technical report)",
)

GRANITE_MOE_3B = ModelConfig(
    name="granite-moe-3b-a800m",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, head_dim=64,
    d_ff=512, vocab_size=49155,
    pattern=(LayerSpec(A, FFN.SWIGLU, moe=True),),
    n_experts=40, top_k=8,
    rope=True, rope_theta=10_000.0,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base (scaled per assignment)",
)

MIXTRAL_8X7B = ModelConfig(
    name="mixtral-8x7b",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=32000,
    pattern=(LayerSpec(A, FFN.SWIGLU, moe=True, window=4096),),
    n_experts=8, top_k=2,
    rope=True, rope_theta=1_000_000.0,
    source="arXiv:2401.04088 (Mixtral of Experts; SWA per Mistral-7B base)",
)

QWEN3_0_6B = ModelConfig(
    name="qwen3-0.6b",
    n_layers=28, d_model=1024, n_heads=16, n_kv_heads=8, head_dim=128,
    d_ff=3072, vocab_size=151936,
    pattern=(LayerSpec(A, FFN.SWIGLU),),
    qk_norm=True, rope=True, rope_theta=1_000_000.0, tie_embeddings=True,
    source="hf:Qwen/Qwen3-8B family (0.6B variant)",
)

NEMOTRON_4_15B = ModelConfig(
    name="nemotron-4-15b",
    n_layers=32, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=24576, vocab_size=256000,
    pattern=(LayerSpec(A, FFN.SQUARED_RELU),),
    rope=True, rope_theta=10_000.0,
    source="arXiv:2402.16819 (Nemotron-4 15B; squared-ReLU MLP)",
)

HUBERT_XLARGE = ModelConfig(
    name="hubert-xlarge",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16, head_dim=80,
    d_ff=5120, vocab_size=504,
    pattern=(LayerSpec(A, FFN.GELU),),
    causal=False, rope=False,
    frontend="features", feature_dim=512,
    source="arXiv:2106.07447 (HuBERT X-Large; conv frontend stubbed per spec)",
)

# Jamba: attention every 8th layer (1:7 attn:mamba), MoE every other layer.
_JAMBA_PATTERN = tuple(
    LayerSpec(A if j == 0 else M, FFN.SWIGLU, moe=(j % 2 == 1))
    for j in range(8))
JAMBA_1_5_LARGE = ModelConfig(
    name="jamba-1.5-large-398b",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=24576, vocab_size=65536,
    pattern=_JAMBA_PATTERN,
    n_experts=16, top_k=2,
    mamba_d_state=16, mamba_d_conv=4, mamba_expand=2,
    rope=False,  # Jamba uses no positional encoding in attention layers
    source="arXiv:2403.19887 (Jamba; 1.5-Large scale per assignment)",
)

RWKV6_3B = ModelConfig(
    name="rwkv6-3b",
    n_layers=32, d_model=2560, n_heads=0, n_kv_heads=0,
    d_ff=8960, vocab_size=65536,
    pattern=(LayerSpec(R6, FFN.RWKV_CHANNEL),),
    rwkv_head_dim=64,
    rope=False,
    source="arXiv:2404.05892 (RWKV6 'Finch'; data-dependent decay)",
)

PIXTRAL_12B = ModelConfig(
    name="pixtral-12b",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=131072,
    pattern=(LayerSpec(A, FFN.SWIGLU),),
    rope=True, rope_theta=1_000_000.0,
    frontend="features", feature_dim=1024,  # Pixtral-ViT patch embeds (stub)
    source="hf:mistralai/Pixtral-12B-2409 (mistral-nemo decoder + ViT stub)",
)

GEMMA2_27B = ModelConfig(
    name="gemma2-27b",
    n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16, head_dim=128,
    d_ff=36864, vocab_size=256000,
    pattern=(LayerSpec(A, FFN.GEGLU, window=4096),   # local
             LayerSpec(A, FFN.GEGLU, window=None)),  # global
    attn_softcap=50.0, final_softcap=30.0,
    rope=True, rope_theta=10_000.0, tie_embeddings=True,
    long_mode_window=32768,  # long-context variant: global layers -> 32k SWA
    source="arXiv:2408.00118 (Gemma 2; local/global alternating + softcap)",
)


ARCHS = {
    c.name: c for c in [
        PHI3_MEDIUM_14B, GRANITE_MOE_3B, MIXTRAL_8X7B, QWEN3_0_6B,
        NEMOTRON_4_15B, HUBERT_XLARGE, JAMBA_1_5_LARGE, RWKV6_3B,
        PIXTRAL_12B, GEMMA2_27B,
    ]
}

SMOKE = {name: reduced(cfg) for name, cfg in ARCHS.items()}


def get(name: str, smoke: bool = False) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return SMOKE[name] if smoke else ARCHS[name]
