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
q's dtype.  Scale ``1/sqrt(hd)`` on the native head dim, passed to the
kernel.  Every head dim from 1 to ``MAX_HEAD_DIM`` (256) is taken, as
the JAX package's wrapper takes it; a larger one raises before any
launch.

The source holds two kernels and the dtype alone chooses between them
(``tensor_core_path``): bfloat16 runs the tensor-core kernel (``wgmma``
on bf16 tiles that TMA loads into shared memory, each head dim padded to
1-4 panels of 64 columns there, with zeros that leave the products
unchanged); float32 runs the CUDA-core kernel, whose fp32 products hold
the 2e-4 parity that TF32 would not, on every head dim in place.
Neither is a fallback for the other: a failed launch raises.  TMA reads
rows of a multiple of 16 bytes, so a bf16 head dim that is no multiple
of 8 is zero-padded to the next one in a copy (``read_width``,
``pad_head_dim``) and the output sliced back; no other input is copied.
``launches`` counts every launch, ``launches_tc`` the ones that the CUDA
source reports it sent to the tensor-core kernel,
``launches_noncausal`` those with ``causal=False`` (the encoder-only
models' attention), ``launches_padded`` those on a padded copy.
"""
from __future__ import annotations

import ctypes
import math
import threading
from typing import Optional

import torch

from repro_torch.kernels.guard import refuse_grad
from repro_torch.parallel import sharding as sh

NEG_INF = -1e30
MAX_HEAD_DIM = 256
TMA_ELEMS = 8       # bf16 elements in 16 bytes: TMA's row granule
DTYPES = (torch.float32, torch.bfloat16)

launches = 0        # kernel launches since the last reset (chip_smoke reads)
launches_tc = 0     # of which on the tensor-core (bf16) kernel
launches_noncausal = 0   # of which with causal=False
launches_padded = 0      # of which on a zero-padded copy of q, k, v

_fn = None
_count_lock = threading.Lock()


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: Optional[int] = None,
                          cap: Optional[float] = None,
                          scale: Optional[float] = None):
    """fp32 einsum, ``where(ok, s, NEG_INF)``, softmax, cast back.
    ``scale`` defaults to ``1/sqrt(hd)``."""
    B, Sq, H, hd = q.shape
    KV, Sk = k.shape[2], k.shape[1]
    g = H // KV
    qg = q.reshape(B, Sq, KV, g, hd).float()
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float())
    s = s / math.sqrt(hd) if scale is None else s * scale
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


def read_width(hd: int, dtype) -> int:
    """The head dim the kernel reads for a native ``hd``: bf16 rows are
    padded to the next multiple of ``TMA_ELEMS``, fp32 ones read as they
    are."""
    if dtype == torch.bfloat16:
        return -(-hd // TMA_ELEMS) * TMA_ELEMS
    return hd


def pad_head_dim(x, width: int):
    """``x`` with its last dim zero-padded to ``width`` (a copy; ``x``
    itself where it is that wide).  Zero columns leave every product
    q . k unchanged and give zero output columns."""
    pad = width - x.shape[-1]
    return x if pad == 0 else torch.nn.functional.pad(x, (0, pad))


def _kernel():
    global _fn
    if _fn is None:
        from repro_torch.kernels import build
        fn = build.load("flash_attention").repro_flash_attention
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
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
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd} outside the kernel's 1-"
                         f"{MAX_HEAD_DIM}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention takes contiguous q, k, v")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention takes q, k, v aligned to 16 bytes")


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    cap: Optional[float] = None):
    """q: [B, S, H, hd], k/v: [B, S, KV, hd] -> [B, S, H, hd].  On
    DTensors each rank runs on its local rows and heads (``local_map``:
    batch over ``data``, heads over ``model``; attention is independent
    per head)."""
    global launches, launches_tc, launches_noncausal, launches_padded
    if sh.is_dtensor(q):
        b, m = sh.kernel_specs(q.device_mesh, q.shape[0],
                               math.gcd(q.shape[2], k.shape[2]))
        spec = sh.P(b, None, m, None)
        return sh.local_call(flash_attention, (q, k, v), (spec,) * 3, spec,
                             causal=causal, window=window, cap=cap)
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
    if q.numel() == 0:
        return torch.empty_like(q)
    width = read_width(hd, q.dtype)
    if width != hd:
        q, k, v = (pad_head_dim(t, width) for t in (q, k, v))
    out = torch.empty_like(q)
    tensor_cores = ctypes.c_int(0)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), B, S, H, k.shape[2], width,
                        int(causal), 0 if window is None else int(window),
                        0.0 if cap is None else float(cap),
                        1.0 / math.sqrt(hd),
                        int(tensor_core_path(q.dtype)), stream,
                        ctypes.byref(tensor_cores))
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"CUDA error {err}")
    with _count_lock:          # RL engine lanes launch from threads
        launches += 1
        launches_tc += tensor_cores.value
        launches_noncausal += not causal
        launches_padded += width != hd
    return out if width == hd else out[..., :hd].contiguous()
