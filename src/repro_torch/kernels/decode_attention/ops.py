"""Flash-decode: one query token per row against a (ring) KV cache.

``decode_attention`` is the wrapper of the hand-written CUDA kernel
``csrc/decode_attention.cu`` (the port of ``_decode_kernel`` in
``repro/kernels/decode_attention/kernel.py``);
``decode_attention_plain`` beside it is the plain PyTorch version (the
port of ``repro/kernels/decode_attention/ref.py``).  On a CUDA tensor
the wrapper launches the kernel or raises; it takes the plain version
only for tensors that lie on the CPU.

q ``[B, H, hd]``, k/v ``[B, L, KV, hd]``, bias ``[B, L]`` fp32 additive
(0 = attend, ``NEG_INF`` = masked) -> ``[B, H, hd]`` in q's dtype:
``softmax(cap*tanh((q.k/sqrt(hd))/cap) + bias) . v`` over kv head
``h // (H // KV)``.

The kernel splits L across blocks (flash-decoding): the wrapper picks the
split length so that B*KV*splits blocks fill the card, allocates the
per-split partial (max, denominator, accumulator) buffers, and one C
call launches the split pass and the combine pass.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

NEG_INF = -1e30
DTYPES = (torch.float32, torch.bfloat16)
TILE = 64            # keys per shared-memory tile in the kernel
TARGET_BLOCKS = 264  # two blocks per SM on a 132-SM H100

launches = 0        # kernel launches since the last reset (chip_smoke reads)

_fn = None


def decode_attention_plain(q, k, v, bias, *, cap: Optional[float] = None):
    """fp32 einsum + bias, softmax, cast back."""
    B, H, hd = q.shape
    KV = k.shape[2]
    g = H // KV
    qg = q.reshape(B, KV, g, hd).float()
    s = torch.einsum("bkgh,blkh->bkgl", qg, k.float()) / math.sqrt(hd)
    if cap is not None:
        s = cap * torch.tanh(s / cap)
    s = s + bias.float()[:, None, None, :]
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgl,blkh->bkgh", p, v.float())
    return o.reshape(B, H, hd).to(q.dtype)


def split_len(B: int, KV: int, L: int) -> int:
    """Keys per split: a multiple of TILE, so that B*KV*splits is about
    TARGET_BLOCKS (never more splits than tiles)."""
    n_tiles = -(-L // TILE)
    splits = max(1, min(n_tiles, -(-TARGET_BLOCKS // max(B * KV, 1))))
    return TILE * (-(-n_tiles // splits))


def _kernel():
    global _fn
    if _fn is None:
        from repro_torch.kernels import build
        fn = build.load("decode_attention").repro_decode_attention
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(q, k, v, bias):
    if not (q.device == k.device == v.device == bias.device):
        raise ValueError("q, k, v, bias must be on one device")
    if q.dtype not in DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"decode_attention takes float32 or bfloat16 q/k/v "
                        f"of one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if bias.dtype != torch.float32:
        raise TypeError(f"bias must be float32, got {bias.dtype}")
    if q.ndim != 3 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    B, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} "
                         "disagree on B or hd")
    if tuple(bias.shape) != (B, k.shape[1]):
        raise ValueError(f"bias {tuple(bias.shape)} != [B, L] = "
                         f"{(B, k.shape[1])}")
    if H % k.shape[2]:
        raise ValueError(f"H={H} is not a multiple of KV={k.shape[2]}")
    if not all(t.is_contiguous() for t in (q, k, v, bias)):
        raise ValueError("decode_attention takes contiguous q, k, v, bias")


def decode_attention(q, k, v, bias, *, cap: Optional[float] = None):
    """q: [B, H, hd]; k/v: [B, L, KV, hd]; bias: [B, L] -> [B, H, hd]."""
    global launches
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, bias, cap=cap)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check(q, k, v, bias)
    B, H, hd = q.shape
    L, KV = k.shape[1], k.shape[2]
    if L == 0:
        raise ValueError("decode_attention needs L >= 1")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    chunk = split_len(B, KV, L)
    n_splits = -(-L // chunk)
    f32 = dict(dtype=torch.float32, device=q.device)
    m_part = torch.empty((B, H, n_splits), **f32)
    l_part = torch.empty((B, H, n_splits), **f32)
    acc_part = torch.empty((B, H, n_splits, hd), **f32)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        bias.data_ptr(), out.data_ptr(), m_part.data_ptr(),
                        l_part.data_ptr(), acc_part.data_ptr(),
                        B, H, KV, L, hd, chunk, n_splits,
                        0.0 if cap is None else float(cap),
                        int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: "
                           f"CUDA error {err}")
    launches += 1
    return out
