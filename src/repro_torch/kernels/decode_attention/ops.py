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
``h // (H // KV)``.  Every head dim from 1 to ``MAX_HEAD_DIM`` (256) is
read in place at its own row stride (the cache is never copied; rows
that are no multiple of 16 bytes are copied into shared memory element
by element), with the scale of the native head dim; a larger one raises
before any launch.

The kernel splits L across blocks (flash-decoding) and combines the
splits in the same launch: ``plan`` picks the splits so that the blocks
fill the card's SMs and sizes the one fp32 scratch buffer the wrapper
allocates per call (none with one split); the combine's atomic tickets
live in a zeroed int32 buffer kept per device, which the kernel leaves
zeroed.
"""
from __future__ import annotations

import ctypes
import math
import threading
from typing import Dict, NamedTuple, Optional

import torch

from repro_torch.kernels.guard import refuse_grad
from repro_torch.parallel import sharding as sh

NEG_INF = -1e30
DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 256
TILE = 32            # keys per split come in multiples of this (one bf16
                     # shared-memory tile, two fp32 ones)
GROUP = 4            # query heads per block at most

launches = 0        # kernel launches since the last reset (chip_smoke reads)

_fn = None
_count_lock = threading.Lock()
_tickets: Dict[torch.device, torch.Tensor] = {}
_sms: Dict[torch.device, int] = {}


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


class Plan(NamedTuple):
    splits: int        # blocks along L per (b, kv head, head group)
    chunk: int         # keys per split, a multiple of TILE
    head_groups: int   # ceil((H / KV) / GROUP)
    scratch: int       # fp32 elements of the per-call scratch (0: none)
    tickets: int       # int32 tickets the combine needs (0: none)


def plan(B: int, H: int, KV: int, L: int, hd: int, sms: int) -> Plan:
    """Launch plan of one call on a card of ``sms`` SMs: as many splits as
    keep the B*KV*head_groups*splits blocks within one block per SM (so
    one split once the blocks alone fill the SMs), never more splits than
    TILE-key tiles; with more than one split, scratch holds each split's
    (max, denominator, accumulator[hd]) per query head,
    ``[B, H, splits, hd + 2]``."""
    hg = -(-(H // KV) // GROUP)
    n_tiles = -(-L // TILE)
    want = max(1, min(n_tiles, sms // max(B * KV * hg, 1)))
    chunk = TILE * -(-n_tiles // want)
    splits = -(-L // chunk)
    if splits == 1:
        return Plan(1, chunk, hg, 0, 0)
    return Plan(splits, chunk, hg, B * H * splits * (hd + 2), B * KV * hg)


def _ticket_buffer(device, n: int) -> torch.Tensor:
    """A zeroed int32 buffer of at least n tickets, kept per device: the
    kernel's combining block resets each ticket it used to 0."""
    buf = _tickets.get(device)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _tickets[device] = buf
    return buf


def _sm_count(device) -> int:
    n = _sms.get(device)
    if n is None:
        n = torch.cuda.get_device_properties(device).multi_processor_count
        _sms[device] = n
    return n


def _kernel():
    global _fn
    if _fn is None:
        from repro_torch.kernels import build
        fn = build.load("decode_attention").repro_decode_attention
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
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
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd} outside the kernel's 1-"
                         f"{MAX_HEAD_DIM}")
    if not all(t.is_contiguous() for t in (q, k, v, bias)):
        raise ValueError("decode_attention takes contiguous q, k, v, bias")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("decode_attention takes q, k, v aligned to 16 bytes")


def decode_attention(q, k, v, bias, *, cap: Optional[float] = None):
    """q: [B, H, hd]; k/v: [B, L, KV, hd]; bias: [B, L] -> [B, H, hd].
    On DTensors each rank runs on its local rows and heads
    (``local_map``: batch over ``data``, heads over ``model``)."""
    global launches
    if sh.is_dtensor(q):
        b, m = sh.kernel_specs(q.device_mesh, q.shape[0],
                               math.gcd(q.shape[1], k.shape[2]))
        return sh.local_call(
            decode_attention, (q, k, v, bias),
            (sh.P(b, m, None), sh.P(b, None, m, None),
             sh.P(b, None, m, None), sh.P(b, None)),
            sh.P(b, m, None), cap=cap)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, bias, cap=cap)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    refuse_grad("decode_attention", q, k, v, bias)
    _check(q, k, v, bias)
    B, H, hd = q.shape
    L, KV = k.shape[1], k.shape[2]
    if L == 0:
        raise ValueError("decode_attention needs L >= 1")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    p = plan(B, H, KV, L, hd, _sm_count(q.device))
    scratch = tickets = None
    if p.splits > 1:
        scratch = torch.empty(p.scratch, dtype=torch.float32,
                              device=q.device)
        tickets = _ticket_buffer(q.device, p.tickets)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        bias.data_ptr(), out.data_ptr(),
                        None if scratch is None else scratch.data_ptr(),
                        None if tickets is None else tickets.data_ptr(),
                        B, H, KV, L, hd, p.chunk, p.splits,
                        0.0 if cap is None else float(cap),
                        1.0 / math.sqrt(hd), int(q.dtype == torch.bfloat16),
                        stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: "
                           f"CUDA error {err}")
    with _count_lock:          # RL engine lanes launch from threads
        launches += 1
    return out
