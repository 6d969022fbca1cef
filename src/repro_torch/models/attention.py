"""Attention: GQA, RoPE, sliding windows, logit softcap, qk-norm.

Port of ``repro.models.attention``.  ``multihead_attention`` dispatch:

  impl     shape       path
  ------   ---------   -----------------------------------------------
  plain    small       ``plain_attention`` — the full score matrix
                       (Sq * Sk <= _CHUNK_THRESHOLD**2).
  plain    large       ``chunked_attention`` — blockwise online softmax
                       over q/k chunks; never more than
                       [B, H, q_chunk, k_chunk] scores at once.
  kernel   Sq > 1      ``kernels.ops.flash_attention`` — the hand-written
                       CUDA flash kernel for contiguous self-attention
                       (the routing rule sends anything else to the
                       plain paths).
  kernel   Sq == 1     ``kernels.ops.flash_decode_attention`` — the CUDA
                       flash-decode kernel over a per-row additive bias.

``"kernel"`` (the default) mirrors the JAX package's ``"pallas"``.  On
CPU tensors each kernel wrapper takes its plain version, so the CPU
tests exercise the kernel routing with plain arithmetic.

Positions are shared 1-D tensors ([Sq] / [Sk]) or per-row 2-D tensors
([B, Sq] / [B, Sk]) — the latter is what the batched wave decode uses.
Masked scores use the finite ``NEG_INF`` everywhere, so a fully masked
row gives a uniform average, never NaN.

On DTensors (a sharded step) every path runs on each rank's local rows
and heads (``local_map``: batch over ``data``, heads over ``model``;
attention is independent per row and per head), so the kernels launch
on local shards and the plain paths' reshapes never meet a sharded dim.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_rope, dense_init, rmsnorm, softcap
from repro_torch.parallel import sharding as sh

_IMPL = "kernel"  # "plain" | "kernel"
_CHUNK_THRESHOLD = 2048
_Q_CHUNK = 1024
_K_CHUNK = 1024

NEG_INF = -1e30


def set_attention_impl(impl: str) -> None:
    global _IMPL
    if impl not in ("plain", "kernel"):
        raise ValueError(f"attention impl must be 'plain' or 'kernel', "
                         f"got {impl!r}")
    _IMPL = impl


def get_attention_impl() -> str:
    return _IMPL


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def init_attention(gen, cfg: ModelConfig, dtype):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    p = {
        "wq": dense_init(gen, (d, cfg.n_heads * hd), dtype=dtype),
        "wkv": dense_init(gen, (d, 2 * cfg.n_kv_heads * hd), dtype=dtype),
        "wo": dense_init(gen, (cfg.n_heads * hd, d), dtype=dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = {"scale": torch.ones((hd,), dtype=dtype,
                                           device=gen.device)}
        p["k_norm"] = {"scale": torch.ones((hd,), dtype=dtype,
                                           device=gen.device)}
    return p


def qkv_project(params, cfg: ModelConfig, x, positions):
    """x: [B, S, d] -> q [B,S,H,hd], k,v [B,S,KV,hd] (qk-normed, then
    roped)."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = sh.even_heads(x @ params["wq"], cfg.n_heads)
    kv = sh.even_heads(x @ params["wkv"], 2 * cfg.n_kv_heads)
    q = q.reshape(B, S, cfg.n_heads, hd)
    kv = kv.reshape(B, S, 2 * cfg.n_kv_heads, hd)
    k, v = kv[:, :, :cfg.n_kv_heads], kv[:, :, cfg.n_kv_heads:]
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(params["k_norm"], k, cfg.norm_eps)
    if cfg.rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k.contiguous(), v.contiguous()


# ---------------------------------------------------------------------------
# Score-level helpers
# ---------------------------------------------------------------------------

def _mask_bias(q_pos, k_pos, *, causal: bool, window: Optional[int],
               k_valid=None):
    """Additive fp32 bias [..., Sq, Sk] from absolute positions."""
    diff = q_pos[..., :, None] - k_pos[..., None, :]
    ok = torch.ones(diff.shape, dtype=torch.bool, device=diff.device)
    if causal:
        ok &= diff >= 0
    if window is not None:
        ok &= diff < window
    if k_valid is not None:
        ok &= k_valid[..., None, :]
    zero = torch.zeros((), dtype=torch.float32, device=diff.device)
    return torch.where(ok, zero, torch.full_like(zero, NEG_INF))


def _gqa_scores(q, k, scale):
    """q: [B,Sq,H,hd], k: [B,Sk,KV,hd] -> [B,H,Sq,Sk] fp32."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    g = H // KV
    qg = q.reshape(B, Sq, KV, g, hd).float()
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float()) * scale
    return s.reshape(B, KV * g, Sq, -1)


def _gqa_values(probs, v):
    """probs: [B,H,Sq,Sk] fp32, v: [B,Sk,KV,hd] -> [B,Sq,H,hd] fp32."""
    B, H, Sq, Sk = probs.shape
    KV = v.shape[2]
    g = H // KV
    pg = probs.reshape(B, KV, g, Sq, Sk)
    o = torch.einsum("bkgqs,bskh->bqkgh", pg, v.float())
    return o.reshape(B, Sq, H, -1)


# ---------------------------------------------------------------------------
# Plain attention (small sequences)
# ---------------------------------------------------------------------------

def plain_attention(q, k, v, q_pos, k_pos, *, causal, window,
                    cap: Optional[float], k_valid=None):
    hd = q.shape[-1]
    scores = _gqa_scores(q, k, 1.0 / math.sqrt(hd))
    scores = softcap(scores, cap)
    bias = _mask_bias(q_pos, k_pos, causal=causal, window=window,
                      k_valid=k_valid)
    if bias.ndim == 2:          # shared positions: [Sq, Sk]
        bias = bias[None, None]
    elif bias.ndim == 3:        # per-row positions: [B, Sq, Sk]
        bias = bias[:, None]
    probs = torch.softmax(scores + bias, dim=-1)
    return _gqa_values(probs, v).to(q.dtype)


# ---------------------------------------------------------------------------
# Chunked (flash-style) attention
# ---------------------------------------------------------------------------

def chunked_attention(q, k, v, q_pos, k_pos, *, causal, window,
                      cap: Optional[float], q_chunk=_Q_CHUNK,
                      k_chunk=_K_CHUNK, k_valid=None):
    """Blockwise online-softmax attention over shared 1-D positions.

    Shapes as plain_attention.  Chunks past the end are padded the way
    the JAX version pads them: padded keys are invalid, padded query
    rows are computed and dropped."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    g = H // KV
    q_chunk = min(q_chunk, Sq)
    k_chunk = min(k_chunk, Sk)
    if k_valid is None:
        k_valid = torch.ones((Sk,), dtype=torch.bool, device=q.device)
    scale = 1.0 / float(hd) ** 0.5
    nq, nk = -(-Sq // q_chunk), -(-Sk // k_chunk)
    outs = []
    for i in range(nq):
        qi = q[:, i * q_chunk:(i + 1) * q_chunk]
        qp = q_pos[i * q_chunk:(i + 1) * q_chunk]
        qg = qi.reshape(B, qi.shape[1], KV, g, hd).float()
        m = torch.full((B, KV, g, qi.shape[1]), NEG_INF,
                       dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, KV, g, qi.shape[1], hd), dtype=torch.float32,
                          device=q.device)
        for j in range(nk):
            sl = slice(j * k_chunk, (j + 1) * k_chunk)
            n = k[:, sl].shape[1]
            s = torch.einsum("bqkgh,bskh->bkgqs", qg, k[:, sl].float()) \
                * scale
            s = softcap(s, cap)
            bias = _mask_bias(qp, k_pos[sl], causal=causal, window=window,
                              k_valid=k_valid[sl])
            s = s + bias[None, None, None]
            if n < k_chunk:     # padded keys of the last chunk: invalid
                pad = torch.full(s.shape[:-1] + (k_chunk - n,), NEG_INF,
                                 dtype=torch.float32, device=q.device)
                s = torch.cat([s, pad], dim=-1)
            m_new = torch.maximum(m, s.max(dim=-1).values)
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqs,bskh->bkgqh", p[..., :n], v[:, sl].float())
            m = m_new
        o = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(o.permute(0, 3, 1, 2, 4).reshape(B, -1, H, hd)
                    .to(q.dtype))
    return torch.cat(outs, dim=1)


# ---------------------------------------------------------------------------
# Top-level dispatch
# ---------------------------------------------------------------------------

def decode_bias(q_pos, k_pos, *, causal=True, window=None, k_valid=None,
                batch=None):
    """Per-slot additive [B, Sk] bias for single-token (Sq == 1) decode:
    causal / window / slot-validity masking against the cache positions
    collapsed into the flash-decode kernel's bias operand."""
    bias = _mask_bias(q_pos, k_pos, causal=causal, window=window,
                      k_valid=k_valid)                 # [..., 1, Sk]
    bias = bias[..., 0, :]
    if batch is not None:
        bias = bias.expand(batch, bias.shape[-1])
    return bias


def multihead_attention(q, k, v, q_pos, k_pos, *, causal=True, window=None,
                        cap=None, k_valid=None, bias=None, force_impl=None):
    """Dispatch per the module table.  `bias` is an optional precomputed
    ``decode_bias`` [B, Sk] for the Sq == 1 kernel path (``decode_step``
    builds one per step and shares it across layers); the other paths
    build their masks from the positions."""
    if sh.is_dtensor(q):
        return _local_attention(q, k, v, q_pos, k_pos, causal=causal,
                                window=window, cap=cap, k_valid=k_valid,
                                bias=bias, force_impl=force_impl)
    impl = force_impl or _IMPL
    Sq, Sk = q.shape[1], k.shape[1]
    if impl == "kernel" and Sq == 1:
        if bias is None:
            bias = decode_bias(q_pos, k_pos, causal=causal, window=window,
                               k_valid=k_valid, batch=q.shape[0])
        out = kernel_ops.flash_decode_attention(q[:, 0], k, v, bias,
                                                cap=cap)
        return out[:, None]
    if impl == "kernel" and Sq > 1:
        return kernel_ops.flash_attention(
            q, k, v, q_pos, k_pos, causal=causal, window=window, cap=cap,
            k_valid=k_valid)
    per_row = (q_pos.ndim > 1 or k_pos.ndim > 1
               or (k_valid is not None and k_valid.ndim > 1))
    if per_row or Sq * Sk <= _CHUNK_THRESHOLD ** 2:
        return plain_attention(q, k, v, q_pos, k_pos, causal=causal,
                               window=window, cap=cap, k_valid=k_valid)
    return chunked_attention(q, k, v, q_pos, k_pos, causal=causal,
                             window=window, cap=cap, k_valid=k_valid)


def _local_attention(q, k, v, q_pos, k_pos, *, k_valid, bias, **kw):
    """``multihead_attention`` on DTensor q/k/v, each rank on its local
    rows and heads.  Per-row operands ([B, ...] positions, validity,
    the decode bias) follow the rows; shared ones pass through."""
    b, m = sh.head_specs(q.device_mesh, q.shape[0],
                         math.gcd(q.shape[2], k.shape[2]))
    heads = sh.P(b, None, m, None)

    def rows(x):
        return None if x is None or x.ndim < 2 else sh.P(b, None)

    def local(q, k, v, q_pos, k_pos, k_valid, bias):
        return multihead_attention(q, k, v, q_pos, k_pos, k_valid=k_valid,
                                   bias=bias, **kw)
    args = (q, k, v, q_pos, k_pos, k_valid, bias)
    return sh.local_call(local, args,
                         (heads, heads, heads) + tuple(map(rows, args[3:])),
                         heads)

