"""Flash attention over contiguous positions (prefill / forward).

``flash_attention`` is the wrapper of the hand-written CUDA kernel
``csrc/flash_attention.cu`` (the port of ``_attn_kernel`` in
``repro/kernels/flash_attention/kernel.py``); ``flash_attention_plain``
beside it is the plain PyTorch version (the port of
``repro/kernels/flash_attention/ref.py``).  On a CUDA tensor the wrapper
launches the kernel or raises; it takes the plain version only for
tensors that lie on the CPU.

Layouts are the JAX package's: q ``[B, S, H, hd]``, k/v ``[B, S, KV, hd]``
(GQA: head h reads kv head ``h // (H // KV)``), out ``[B, S, H, hd]`` in
q's dtype.  Scale ``1/sqrt(hd)`` on the native head dim.

The source holds two kernels and the dtype alone chooses between them
(``tensor_core_path``): bfloat16 runs the tensor-core kernel (``wgmma``
on bf16 tiles that TMA loads into shared memory, each head dim padded to
64 or 128 columns there, with zeros that leave the products unchanged);
float32 runs the CUDA-core kernel, whose fp32 products hold the 2e-4
parity that TF32 would not.  Neither is a fallback for the other: a
failed launch raises.  ``launches`` counts every launch,
``launches_tc`` the ones that the CUDA source reports it sent to the
tensor-core kernel.
"""
from __future__ import annotations

import ctypes
import math
import threading
from typing import Optional

import torch

from repro_torch.kernels.guard import refuse_grad

NEG_INF = -1e30
HEAD_DIMS = (32, 48, 64, 80, 96, 128)   # instantiated in the CUDA source
DTYPES = (torch.float32, torch.bfloat16)

launches = 0        # kernel launches since the last reset (chip_smoke reads)
launches_tc = 0     # of which on the tensor-core (bf16) kernel

_fn = None
_count_lock = threading.Lock()


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: Optional[int] = None,
                          cap: Optional[float] = None):
    """fp32 einsum, ``where(ok, s, NEG_INF)``, softmax, cast back."""
    B, Sq, H, hd = q.shape
    KV, Sk = k.shape[2], k.shape[1]
    g = H // KV
    qg = q.reshape(B, Sq, KV, g, hd).float()
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float()) / math.sqrt(hd)
    if cap is not None:
        s = cap * torch.tanh(s / cap)
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= qpos >= kpos
    if window is not None:
        ok &= (qpos - kpos) < window
    s = s.masked_fill(~ok, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskh->bqkgh", p, v.float())
    return o.reshape(B, Sq, H, hd).to(q.dtype)


def tensor_core_path(dtype) -> bool:
    """True when ``dtype`` runs the tensor-core kernel (bf16), False for
    the CUDA-core one (fp32)."""
    if dtype not in DTYPES:
        raise TypeError(f"flash_attention takes {DTYPES}, got {dtype}")
    return dtype == torch.bfloat16


def _kernel():
    global _fn
    if _fn is None:
        from repro_torch.kernels import build
        fn = build.load("flash_attention").repro_flash_attention
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(q, k, v):
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    if q.dtype not in DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attention takes float32 or bfloat16 q/k/v of "
                        f"one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    B, S, H, hd = q.shape
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != hd:
        raise ValueError("the kernel takes Sq == Sk and matching B, hd: "
                         f"q {tuple(q.shape)} k {tuple(k.shape)}")
    if H % k.shape[2]:
        raise ValueError(f"H={H} is not a multiple of KV={k.shape[2]}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in the kernel's {HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention takes contiguous q, k, v")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention takes q, k, v aligned to 16 bytes")


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    cap: Optional[float] = None):
    """q: [B, S, H, hd], k/v: [B, S, KV, hd] -> [B, S, H, hd]."""
    global launches, launches_tc
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     cap=cap)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    refuse_grad("flash_attention", q, k, v)
    _check(q, k, v)
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    B, S, H, hd = q.shape
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    tensor_cores = ctypes.c_int(0)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), B, S, H, k.shape[2], hd, int(causal),
                        0 if window is None else int(window),
                        0.0 if cap is None else float(cap),
                        int(tensor_core_path(q.dtype)), stream,
                        ctypes.byref(tensor_cores))
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"CUDA error {err}")
    with _count_lock:          # RL engine lanes launch from threads
        launches += 1
        launches_tc += tensor_cores.value
    return out
