"""Model configuration covering all assigned architecture families.

One `ModelConfig` dataclass expresses dense GQA transformers, MoE, SSM
(Mamba), linear attention (RWKV6), hybrid interleaves, encoder-only audio
backbones, and VLM decoders with a stubbed modality frontend.

The layer stack is described by a repeating *pattern* of `LayerSpec`s: the
full model is ``pattern`` repeated ``n_layers / len(pattern)`` times. This
lets us scan over homogeneous super-blocks (jamba's 1:7 attn:mamba period,
gemma2's local/global alternation) while keeping the HLO small.
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import Optional, Sequence, Tuple


class Mixer(str, enum.Enum):
    """Sequence-mixing block type."""

    ATTENTION = "attention"
    MAMBA = "mamba"
    RWKV6 = "rwkv6"


class FFN(str, enum.Enum):
    """Channel-mixing block type."""

    SWIGLU = "swiglu"        # gated SiLU (llama/phi3/mixtral/jamba/pixtral)
    GEGLU = "geglu"          # gated GELU (gemma2)
    SQUARED_RELU = "squared_relu"  # nemotron-4
    GELU = "gelu"            # hubert / vanilla
    RWKV_CHANNEL = "rwkv_channel"  # rwkv6 channel mix (squared relu + recept.)


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer in the repeating pattern."""

    mixer: Mixer = Mixer.ATTENTION
    ffn: FFN = FFN.SWIGLU
    moe: bool = False
    # attention-only knobs
    window: Optional[int] = None  # sliding-window size; None = full attention


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int               # 0 for attention-free architectures
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    # pattern of layer specs, repeated to n_layers
    pattern: Tuple[LayerSpec, ...] = (LayerSpec(),)
    # attention knobs
    rope: bool = True
    rope_theta: float = 10_000.0
    qk_norm: bool = False
    attn_softcap: Optional[float] = None     # gemma2: 50.0
    final_softcap: Optional[float] = None    # gemma2: 30.0
    causal: bool = True                      # False for encoder-only (hubert)
    # MoE knobs
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # Mamba knobs
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    # RWKV6 knobs
    rwkv_head_dim: int = 64
    # embedding frontend: "tokens" (LM), "features" (audio/vlm stub input)
    frontend: str = "tokens"
    feature_dim: int = 0        # dim of precomputed frame/patch embeddings
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    # long-context mode: replaces full-attention layers' window (see DESIGN §3)
    long_mode_window: Optional[int] = None
    dtype: str = "bfloat16"
    # citation for the config source
    source: str = ""

    # ---- derived ----
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def n_pattern_repeats(self) -> int:
        assert self.n_layers % len(self.pattern) == 0, (
            f"{self.name}: n_layers={self.n_layers} not divisible by "
            f"pattern length {len(self.pattern)}")
        return self.n_layers // len(self.pattern)

    @property
    def is_encoder_only(self) -> bool:
        return not self.causal

    @property
    def attention_free(self) -> bool:
        return all(s.mixer != Mixer.ATTENTION for s in self.pattern)

    @property
    def has_moe(self) -> bool:
        return any(s.moe for s in self.pattern)

    @property
    def has_mamba(self) -> bool:
        return any(s.mixer == Mixer.MAMBA for s in self.pattern)

    @property
    def has_rwkv(self) -> bool:
        return any(s.mixer == Mixer.RWKV6 for s in self.pattern)

    @property
    def rwkv_n_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    @property
    def mamba_d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    def supports_long_context(self) -> bool:
        """Sub-quadratic (per-token decode O(window) / O(1)) variant exists."""
        if self.attention_free or self.has_mamba:
            return True
        # dense archs qualify only with a sliding-window variant
        all_windowed = all(
            s.window is not None or s.mixer != Mixer.ATTENTION
            for s in self.pattern)
        return all_windowed or self.long_mode_window is not None

    def param_count(self) -> int:
        """Analytic parameter count (matches init_params within emb ties)."""
        d, hd = self.d_model, self.resolved_head_dim
        total = self.vocab_size * d  # embedding
        if not self.tie_embeddings:
            total += self.vocab_size * d  # lm head
        if self.frontend == "features":
            total += self.feature_dim * d
        for spec in self.pattern:
            per = 2 * d  # two rmsnorm scales
            if spec.mixer == Mixer.ATTENTION:
                q = d * self.n_heads * hd
                kv = 2 * d * self.n_kv_heads * hd
                o = self.n_heads * hd * d
                per += q + kv + o
                if self.qk_norm:
                    per += 2 * hd
            elif spec.mixer == Mixer.MAMBA:
                di, ds = self.mamba_d_inner, self.mamba_d_state
                r = max(d // 16, 8)            # dt_rank
                per += d * 2 * di              # in_proj (x and z)
                per += (self.mamba_d_conv + 1) * di  # depthwise conv + bias
                per += di * (r + 2 * ds)       # x_proj -> dt, B, C
                per += r * di + di             # dt_proj + bias
                per += di * ds + di            # A_log + D
                per += di * d                  # out_proj
            elif spec.mixer == Mixer.RWKV6:
                # r,k,v,g,o projections + decay lora + mixes/bonus/norm
                per += 5 * d * d + 2 * 64 * d + 9 * d
            if spec.moe:
                per += d * self.n_experts  # router
                per += self.n_experts * self._ffn_params(spec.ffn)
            else:
                per += self._ffn_params(spec.ffn)
            total += per * self.n_pattern_repeats
        total += d  # final norm
        return total

    def _ffn_params(self, ffn: FFN) -> int:
        d, f = self.d_model, self.d_ff
        if ffn in (FFN.SWIGLU, FFN.GEGLU):
            return 3 * d * f
        if ffn == FFN.RWKV_CHANNEL:
            return 2 * d * f + d * d  # key, value, receptance
        return 2 * d * f

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only top_k experts)."""
        if not self.has_moe:
            return self.param_count()
        total = self.param_count()
        for spec in self.pattern:
            if spec.moe:
                inactive = (self.n_experts - self.top_k) * \
                    self._ffn_params(spec.ffn)
                total -= inactive * self.n_pattern_repeats
        return total

    def validate(self) -> None:
        assert self.d_model > 0 and self.n_layers > 0
        assert self.n_layers % len(self.pattern) == 0
        if not self.attention_free:
            assert self.n_heads > 0 and self.n_kv_heads > 0
            assert self.n_heads % self.n_kv_heads == 0
        if self.has_moe:
            assert 0 < self.top_k <= self.n_experts
        if self.has_rwkv:
            assert self.d_model % self.rwkv_head_dim == 0
        if self.frontend == "features":
            assert self.feature_dim > 0


def reduced(cfg: ModelConfig, *, n_layers: int = 2, d_model: int = 256,
            n_experts: int = 4, vocab: int = 512) -> ModelConfig:
    """Smoke-test variant of the same family: ≤2 layers, d_model ≤ 512,
    ≤4 experts, smaller ffn/vocab, same pattern structure."""
    pat_len = len(cfg.pattern)
    # keep the pattern but shrink repeats; if pattern longer than n_layers,
    # truncate the pattern itself (keeping at least one of each mixer kind).
    if pat_len > n_layers:
        kinds = []
        seen = set()
        for s in cfg.pattern:
            key = (s.mixer, s.moe, s.window is not None)
            if key not in seen:
                seen.add(key)
                kinds.append(s)
        pattern = tuple(kinds[:n_layers])
        if len(pattern) < n_layers and n_layers % len(pattern) != 0:
            n_layers = len(pattern)
    else:
        pattern = cfg.pattern
        n_layers = max(pat_len, (n_layers // pat_len) * pat_len)
    n_heads = 0 if cfg.attention_free else min(cfg.n_heads, 4)
    n_kv = 0 if cfg.attention_free else min(cfg.n_kv_heads, max(1, n_heads // 2))
    if n_heads and n_heads % max(n_kv, 1):
        n_kv = 1
    # shrink windows so smoke seqs exercise the masking path
    pattern = tuple(
        dataclasses.replace(s, window=(16 if s.window is not None else None))
        for s in pattern)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=n_layers,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=(64 if not cfg.attention_free else 0),
        d_ff=d_model * 2,
        vocab_size=vocab,
        pattern=pattern,
        n_experts=min(cfg.n_experts, n_experts) if cfg.has_moe else 0,
        top_k=min(cfg.top_k, 2) if cfg.has_moe else 0,
        rwkv_head_dim=32,
        feature_dim=(64 if cfg.frontend == "features" else 0),
        long_mode_window=(16 if cfg.long_mode_window is not None else None),
        dtype="float32",
    )
