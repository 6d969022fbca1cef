"""Plain PyTorch reference of the qwen3 configuration: float32, the full
causal score matrix, no kernels, no cache, no batching across layers.

It reads the benchmark's weights by their paths (the layout of
``families/qwen3.py``) and works everything else out itself.  Each layer:
RMSNorm; q = h Wq, [k | v] = h Wkv split into the KV heads; RMSNorm over
each head of q and k; RoPE on split halves (frequencies theta^(-i / half));
softmax(q k^T / sqrt(hd)) v with each KV head shared by H / KV query heads
and a causal mask; x += y Wo; RMSNorm; x += (silu(h Wg) * (h Wu)) Wd.
Then the final RMSNorm and the tied head (logits = h E^T).  Departure from
the published Qwen3, as the port's tokens frontend: the embedding rows are
scaled by sqrt(hidden_size).  Imports nothing of the program.
"""
from __future__ import annotations

import math

import torch

from bench.reference.common import leaf, mm, rmsnorm

B = "blocks/layer0/"


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x [B, S, heads, hd], pos [S]."""
    half = x.shape[-1] // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float32,
                                  device=x.device) / half)
    ang = pos.float()[:, None] * inv[None, :]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def hidden(params: dict, c: dict, tokens: torch.Tensor,
           prec: str = "fp32") -> torch.Tensor:
    """Final normed hidden states [B, S, d] (float32) of ``tokens`` [B, S]."""
    L, d = c["num_hidden_layers"], c["hidden_size"]
    H, KV, hd = (c["num_attention_heads"], c["num_key_value_heads"],
                 c["head_dim"])
    eps, theta = float(c["rms_norm_eps"]), float(c["rope_theta"])
    Bsz, S = tokens.shape
    pos = torch.arange(S, device=tokens.device)
    x = leaf(params, "embed/tokens")[tokens].float() * math.sqrt(d)
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    for r in range(L):
        w = lambda p: leaf(params, B + p)[r]      # noqa: E731
        h = rmsnorm(x, w("norm1/scale"), eps)
        q = mm(h, w("attn/wq"), prec).view(Bsz, S, H, hd)
        kv = mm(h, w("attn/wkv"), prec).view(Bsz, S, 2 * KV, hd)
        k, v = kv[:, :, :KV], kv[:, :, KV:]
        q = rope(rmsnorm(q, w("attn/q_norm/scale"), eps), pos, theta)
        k = rope(rmsnorm(k, w("attn/k_norm/scale"), eps), pos, theta)
        k = k.repeat_interleave(H // KV, dim=2)
        v = v.repeat_interleave(H // KV, dim=2)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        s = s.masked_fill(~causal, float("-inf"))
        y = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)
        x = x + mm(y.reshape(Bsz, S, H * hd), w("attn/wo"), prec)
        h = rmsnorm(x, w("norm2/scale"), eps)
        g = torch.nn.functional.silu(mm(h, w("ffn/w_gate"), prec))
        x = x + mm(g * mm(h, w("ffn/w_up"), prec), w("ffn/w_down"), prec)
    return rmsnorm(x, leaf(params, "final_norm/scale"), eps)


def logits(params: dict, c: dict, h: torch.Tensor,
           prec: str = "fp32") -> torch.Tensor:
    """Logits [..., V] of final hidden states ``h`` [..., d]."""
    return mm(h, leaf(params, "embed/tokens").T, prec)
