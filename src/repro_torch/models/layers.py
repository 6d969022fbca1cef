"""Shared neural-net building blocks (plain functions on tensors).

Port of ``repro.models.layers``.  Parameters are nested dicts of tensors
with the JAX package's names and layouts; every block has an
``init_*(gen, cfg, ...) -> params`` (same distributions as the JAX
inits, drawn from an explicit ``torch.Generator``) and an apply function.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.config import FFN, ModelConfig
from repro_torch.parallel.sharding import (P, is_dtensor, kernel_specs,
                                          local_call,
                                          vocab_parallel_embedding)


# fp32 elements drawn at a time for a leaf of another dtype (512 MB)
DRAW_CHUNK = 1 << 27
_TRUNC = math.erf(2.0 / math.sqrt(2.0))    # 2 Φ(2) - 1


def _trunc_normal_(w: torch.Tensor, gen: torch.Generator, scale: float):
    """In place: N(0, scale²) truncated at ±2σ by the inverse CDF (one
    uniform draw per element, consumed in memory order, so drawing a
    tensor in leading-axis slices gives the same values on the CPU)."""
    w.uniform_(-_TRUNC, _TRUNC, generator=gen)
    w.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0).mul_(scale)
    return w


def dense_init(gen: torch.Generator, shape, scale: Optional[float] = None,
               dtype=torch.float32):
    """Truncated-normal (±2σ) fan-in init, drawn in fp32.

    The leaf is allocated once, in ``dtype``.  An fp32 leaf is drawn in
    place; any other is drawn in fp32 slices of at most ``DRAW_CHUNK``
    elements along the leading axis (one expert of an ``[E, d, f]``
    leaf) and cast into place, so no leaf ever has a whole fp32 copy
    beside it.  (``torch.nn.init.trunc_normal_`` resamples with two
    more full-size temporaries in recent PyTorch, and its draws change
    between versions.)"""
    if scale is None:
        scale = 1.0 / math.sqrt(shape[0])
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    if dtype == torch.float32 or out.numel() == 0:
        return _trunc_normal_(out, gen, scale)
    rows = max(1, DRAW_CHUNK // max(1, out[0].numel()))
    tmp = torch.empty((min(rows, shape[0]),) + tuple(shape[1:]),
                      dtype=torch.float32, device=gen.device)
    for i in range(0, shape[0], rows):
        n = min(rows, shape[0] - i)
        out[i:i + n].copy_(_trunc_normal_(tmp[:n], gen, scale))
    return out


# ---------------------------------------------------------------------------
# Normalization
# ---------------------------------------------------------------------------

def init_rmsnorm(d: int, dtype, device):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params, x, eps: float = 1e-5):
    """fp32 inside, cast back to the input dtype."""
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * params["scale"].float()).to(dtype)


def softcap(x, cap: Optional[float]):
    """Gemma2-style logit soft capping."""
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None):
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=device) / half
    return torch.pow(float(theta), exps)        # fp32, as the JAX version


def apply_rope(x, positions, theta: float):
    """x: [..., S, H, hd]; positions: [..., S] int.  Split halves (not
    interleaved), computed in fp32, cast back."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)             # [hd/2]
    angles = positions[..., None].float() * freqs             # [..., S, hd/2]
    cos = torch.cos(angles)[..., None, :]                     # [..., S, 1, hd/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq_len: int, d_model: int, dtype=torch.float32,
                         device=None):
    """[S, d] sin | cos table of the encoder-only models, computed in fp32
    (as the JAX version) and cast to ``dtype`` at the end."""
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)[:, None]
    half = d_model // 2
    freq = torch.exp(-math.log(10_000.0)
                     * torch.arange(half, dtype=torch.float32, device=device)
                     / half)[None, :]
    ang = pos * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def init_embeddings(gen, cfg: ModelConfig, dtype):
    """Token table, the feature projection of the features frontend, and
    the untied head, drawn in that order.  ``feature_proj`` is drawn only
    for ``frontend == "features"``, so a tokens model's draws are the
    same as without it."""
    p = {"tokens": dense_init(gen, (cfg.vocab_size, cfg.d_model),
                              scale=0.02, dtype=dtype)}
    if cfg.frontend == "features":
        p["feature_proj"] = dense_init(gen, (cfg.feature_dim, cfg.d_model),
                                       dtype=dtype)
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                  dtype=dtype)
    return p


def take_rows(x, idx):
    """``x[b, idx[b]]`` for x [B, S, ...] and idx [B]: each row's entry
    at its own index.  A DTensor ``x``: each rank picks its own rows
    (over ``data``) with its rows of ``idx``."""
    def pick(x, idx):
        return x[torch.arange(x.shape[0], device=x.device), idx]
    if not is_dtensor(x):
        return pick(x, idx)
    b, _ = kernel_specs(x.device_mesh, x.shape[0], 1)
    rest = (None,) * (x.ndim - 2)
    return local_call(pick, (x, idx), (P(b, None, *rest), P(b)),
                      P(b, *rest))


def embed_tokens(params, cfg: ModelConfig, tokens):
    """Token rows, scaled by √d_model for the tokens frontend only (the
    features frontend's tokens, pixtral-12b's, are not).  A DTensor table
    (vocab over ``model``) takes the vocab-parallel lookup
    (``sharding.vocab_parallel_embedding``): the same rows."""
    table = params["tokens"]
    emb = vocab_parallel_embedding(table, tokens) if is_dtensor(table) \
        else table[tokens]
    if cfg.frontend == "tokens":
        # the √d_model factor is rounded to the param dtype first (on the
        # host: a device scalar would cost a blocking copy every step)
        emb = emb * float(torch.tensor(math.sqrt(cfg.d_model),
                                       dtype=emb.dtype))
    return emb


def embed_features(params, cfg: ModelConfig, features):
    """[B, S_f, feature_dim] frames / patches -> [B, S_f, d] in the
    projection's dtype."""
    proj = params["feature_proj"]
    return features.to(proj.dtype) @ proj


def unembed(params, cfg: ModelConfig, x):
    if cfg.tie_embeddings:
        logits = x @ params["tokens"].T
    else:
        logits = x @ params["lm_head"]
    return softcap(logits, cfg.final_softcap)


# ---------------------------------------------------------------------------
# Feed-forward variants
# ---------------------------------------------------------------------------

def init_ffn(gen, cfg: ModelConfig, kind: FFN, dtype):
    d, f = cfg.d_model, cfg.d_ff
    if kind in (FFN.SWIGLU, FFN.GEGLU):
        return {"w_gate": dense_init(gen, (d, f), dtype=dtype),
                "w_up": dense_init(gen, (d, f), dtype=dtype),
                "w_down": dense_init(gen, (f, d), dtype=dtype)}
    if kind == FFN.RWKV_CHANNEL:
        return {"w_key": dense_init(gen, (d, f), dtype=dtype),
                "w_value": dense_init(gen, (f, d), dtype=dtype),
                "w_recept": dense_init(gen, (d, d), dtype=dtype),
                "mu_k": torch.full((d,), 0.5, dtype=dtype, device=gen.device),
                "mu_r": torch.full((d,), 0.5, dtype=dtype, device=gen.device)}
    if kind in (FFN.SQUARED_RELU, FFN.GELU):
        return {"w_up": dense_init(gen, (d, f), dtype=dtype),
                "w_down": dense_init(gen, (f, d), dtype=dtype)}
    raise NotImplementedError(f"FFN {kind.value} is not yet ported")


def apply_ffn(params, cfg: ModelConfig, kind: FFN, x, *, shifted=None):
    """The dense FFNs and the RWKV channel mix
    (``repro.models.layers.apply_ffn:136-156``).  ``shifted``: the
    previous-token tensor the RWKV channel mix needs."""
    if kind == FFN.SWIGLU:
        return (F.silu(x @ params["w_gate"]) * (x @ params["w_up"])) \
            @ params["w_down"]
    if kind == FFN.GEGLU:
        return (F.gelu(x @ params["w_gate"], approximate="tanh")
                * (x @ params["w_up"])) @ params["w_down"]
    if kind == FFN.SQUARED_RELU:
        h = F.relu(x @ params["w_up"])
        return (h * h) @ params["w_down"]
    if kind == FFN.GELU:
        return F.gelu(x @ params["w_up"], approximate="tanh") \
            @ params["w_down"]
    if kind == FFN.RWKV_CHANNEL:
        if shifted is None:
            raise ValueError("the rwkv_channel FFN needs shifted=")
        xk = x + (shifted - x) * params["mu_k"]
        xr = x + (shifted - x) * params["mu_r"]
        k = F.relu(xk @ params["w_key"])
        return torch.sigmoid(xr @ params["w_recept"]) * \
            ((k * k) @ params["w_value"])
    raise NotImplementedError(f"FFN {kind.value} is not yet ported")


def token_shift(x):
    """RWKV-style shift: x[t] -> x[t-1] (zeros at t=0). x: [B, S, d]."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1, :]
