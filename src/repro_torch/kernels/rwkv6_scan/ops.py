"""RWKV6 linear-attention scan from a zero state.

``rwkv6_scan`` is the wrapper of the hand-written CUDA kernel
``csrc/rwkv6_scan.cu`` (the port of ``_rwkv_kernel`` in
``repro/kernels/rwkv6_scan/kernel.py``); ``rwkv6_scan_plain`` beside it
is the plain PyTorch version, the explicit per-token recurrence (the
port of ``repro/kernels/rwkv6_scan/ref.py``), which shares nothing with
the kernel's chunked form.  On a CUDA tensor the wrapper launches the
kernel or raises; it takes the plain version only for tensors that lie
on the CPU.

r, k, v, logw ``[B, S, H, N]`` fp32 (logw < 0 is the log decay), u
``[H, N]`` fp32 -> y ``[B, S, H, N]`` and the final state ``[B, H, N, N]``,
both fp32:
    S_t = diag(exp(logw_t)) S_{t-1} + k_t v_t^T ;
    y_t = r_t (diag(u) k_t v_t^T + S_{t-1}),      S_0 = 0.
The kernel walks S in chunks of ``chunk`` positions; the result does not
depend on the chunk.  The
ragged last chunk is masked in the kernel (k = v = 0, decay 1), so the
wrapper pads nothing.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.guard import refuse_grad

HEAD_DIMS = (32, 64, 128)          # instantiated in the CUDA source
CHUNKS = (16, 32, 64)

launches = 0        # kernel launches since the last reset (chip_smoke reads)

_fn = None


def rwkv6_scan_plain(r, k, v, logw, u):
    """The per-token recurrence in fp32: (y [B,S,H,N], state [B,H,N,N])."""
    B, S, H, N = r.shape
    r, k, v, logw = (t.float() for t in (r, k, v, logw))
    u = u.float()[None, :, :, None]
    state = torch.zeros((B, H, N, N), dtype=torch.float32, device=r.device)
    ys = []
    for t in range(S):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]       # [B,H,N,N]
        ys.append(torch.einsum("bhn,bhnm->bhm", r[:, t], u * kv + state))
        state = torch.exp(logw[:, t])[..., None] * state + kv
    y = torch.stack(ys, dim=1) if ys else torch.zeros_like(r)
    return y, state


def _kernel():
    global _fn
    if _fn is None:
        from repro_torch.kernels import build
        fn = build.load("rwkv6_scan").repro_rwkv6_scan
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(r, k, v, logw, u):
    ts = (r, k, v, logw, u)
    if not all(t.device == r.device for t in ts):
        raise ValueError("r, k, v, logw, u must be on one device")
    if not all(t.dtype == torch.float32 for t in ts):
        raise TypeError("rwkv6_scan takes float32 r/k/v/logw/u, got "
                        + "/".join(str(t.dtype) for t in ts))
    if r.ndim != 4 or not (r.shape == k.shape == v.shape == logw.shape):
        raise ValueError(f"shapes r {tuple(r.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} logw {tuple(logw.shape)}")
    B, S, H, N = r.shape
    if tuple(u.shape) != (H, N):
        raise ValueError(f"u {tuple(u.shape)} != [H, N] = {(H, N)}")
    if N not in HEAD_DIMS:
        raise ValueError(f"head dim {N} not in the kernel's {HEAD_DIMS}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("rwkv6_scan takes contiguous r, k, v, logw, u")
    if any(t.data_ptr() % 16 for t in ts[:4]):
        raise ValueError("rwkv6_scan takes 16-byte aligned r, k, v, logw "
                         "(the kernel loads float4)")


def rwkv6_scan(r, k, v, logw, u, *, chunk: int = 64):
    """r/k/v/logw: [B, S, H, N]; u: [H, N] -> (y [B,S,H,N], state
    [B,H,N,N]), both fp32, from a zero state."""
    global launches
    if r.device.type == "cpu":
        return rwkv6_scan_plain(r, k, v, logw, u)
    if r.device.type != "cuda":
        raise ValueError(f"unsupported device {r.device}")
    refuse_grad("rwkv6_scan", r, k, v, logw, u)
    _check(r, k, v, logw, u)
    if chunk not in CHUNKS:
        raise ValueError(f"rwkv6_scan chunk {chunk} not in the kernel's "
                         f"{CHUNKS}")
    B, S, H, N = r.shape
    y = torch.empty_like(r)
    state = torch.empty((B, H, N, N), dtype=torch.float32, device=r.device)
    if B * H == 0:
        return y, state
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = _kernel()(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                        logw.data_ptr(), u.data_ptr(), y.data_ptr(),
                        state.data_ptr(), B, S, H, N, chunk, stream)
    if err != 0:
        raise RuntimeError(f"rwkv6_scan kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return y, state
