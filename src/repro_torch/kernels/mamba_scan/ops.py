"""Mamba selective scan from a zero state.

``mamba_scan`` is the wrapper of the hand-written CUDA kernel
``csrc/mamba_scan.cu`` (the port of ``_mamba_kernel`` in
``repro/kernels/mamba_scan/kernel.py``); ``mamba_scan_plain`` beside it
is the plain PyTorch version, the explicit per-token recurrence (the
port of ``repro/kernels/mamba_scan/ref.py``).  On a CUDA tensor the
wrapper launches the kernel or raises; it takes the plain version only
for tensors that lie on the CPU.

dt, x ``[B, S, di]``, Bm, Cm ``[B, S, ds]`` and A ``[di, ds]``, all fp32
-> y ``[B, S, di]`` and the final state h_end ``[B, di, ds]``, both fp32:
    h_t = exp(dt_t A) * h_{t-1} + (dt_t x_t) B_t ;  y_t = h_t . C_t,
    h_0 = 0.
No ``D x`` skip: ``models.mamba.apply_mamba`` adds it.  Ragged S and di
are masked in the kernel.  The kernel is instantiated at state sizes ds
8, 16 and 32; any ds up to ``MAX_STATE_DIM`` (32) runs on the first at
or above it, the wrapper zero-padding a copy of Bm, Cm and A
(``state_width``, ``pad_state``: A = 0 decays by 1 and B = 0 feeds
nothing, so the padded state stays 0) and slicing h_end back;
``launches_padded`` counts those launches.  A larger ds raises before
any launch (a thread holds its channel's state and A's row in
registers).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.guard import refuse_grad
from repro_torch.parallel import sharding as sh

STATE_DIMS = (8, 16, 32)           # instantiated in the CUDA source
MAX_STATE_DIM = STATE_DIMS[-1]

launches = 0        # kernel launches since the last reset (chip_smoke reads)
launches_padded = 0     # of which on a zero-padded copy

_fn = None


def mamba_scan_plain(dt, x, Bm, Cm, A, h0=None):
    """The per-token recurrence in fp32: (y [B,S,di], h_end [B,di,ds]).
    ``h0`` [B,di,ds] replaces the zero initial state (the model's decode
    steps carry one; the kernel takes none)."""
    B, S, di = x.shape
    dt, x, Bm, Cm, A = (t.float() for t in (dt, x, Bm, Cm, A))
    h = (torch.zeros((B, di, A.shape[1]), dtype=torch.float32,
                     device=x.device) if h0 is None else h0.float())
    ys = []
    for t in range(S):
        h = torch.exp(dt[:, t, :, None] * A) * h \
            + (dt[:, t] * x[:, t])[..., None] * Bm[:, t, None, :]
        ys.append(torch.einsum("bds,bs->bd", h, Cm[:, t]))
    y = torch.stack(ys, dim=1) if ys else torch.zeros_like(x)
    return y, h


def state_width(ds: int) -> int:
    """The instantiated state size that a state size of ds runs on."""
    for w in STATE_DIMS:
        if ds <= w:
            return w
    raise ValueError(f"state dim {ds} above the kernel's largest "
                     f"{MAX_STATE_DIM}: a thread holds its channel's state "
                     f"and A's row in registers")


def pad_state(Bm, Cm, A, width: int):
    """Bm, Cm ``[B, S, ds]`` and A ``[di, ds]`` with ds zero-padded to
    ``width``: a padded state element decays by exp(0) = 1 from 0 and is
    fed B = 0, so it stays 0 and adds nothing to y."""
    pad = width - A.shape[-1]
    return tuple(torch.nn.functional.pad(t, (0, pad)) for t in (Bm, Cm, A))


def _kernel():
    global _fn
    if _fn is None:
        from repro_torch.kernels import build
        fn = build.load("mamba_scan").repro_mamba_scan
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(dt, x, Bm, Cm, A):
    ts = (dt, x, Bm, Cm, A)
    if not all(t.device == x.device for t in ts):
        raise ValueError("dt, x, Bm, Cm, A must be on one device")
    if not all(t.dtype == torch.float32 for t in ts):
        raise TypeError("mamba_scan takes float32 dt/x/Bm/Cm/A, got "
                        + "/".join(str(t.dtype) for t in ts))
    if x.ndim != 3 or dt.shape != x.shape:
        raise ValueError(f"shapes dt {tuple(dt.shape)} x {tuple(x.shape)}")
    B, S, di = x.shape
    if Bm.ndim != 3 or Bm.shape[:2] != (B, S) or Cm.shape != Bm.shape:
        raise ValueError(f"shapes Bm {tuple(Bm.shape)} Cm {tuple(Cm.shape)}"
                         f" for x {tuple(x.shape)}")
    ds = Bm.shape[2]
    if tuple(A.shape) != (di, ds):
        raise ValueError(f"A {tuple(A.shape)} != [di, ds] = {(di, ds)}")
    state_width(ds)
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("mamba_scan takes contiguous dt, x, Bm, Cm, A")


def mamba_scan(dt, x, Bm, Cm, A):
    """dt/x: [B, S, di]; Bm/Cm: [B, S, ds]; A: [di, ds] -> (y [B,S,di],
    h_end [B,di,ds]), both fp32, from a zero state.  On DTensors each
    rank runs on its local rows and channels (``local_map``: batch over
    ``data``, channels over ``model``; the recurrence is elementwise in
    di)."""
    global launches, launches_padded
    if sh.is_dtensor(x):
        b, m = sh.kernel_specs(x.device_mesh, x.shape[0], x.shape[2])
        chan, st = sh.P(b, None, m), sh.P(b, None, None)
        return sh.local_call(mamba_scan, (dt, x, Bm, Cm, A),
                             (chan, chan, st, st, sh.P(m, None)),
                             (chan, sh.P(b, m, None)))
    if x.device.type == "cpu":
        return mamba_scan_plain(dt, x, Bm, Cm, A)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    refuse_grad("mamba_scan", dt, x, Bm, Cm, A)
    _check(dt, x, Bm, Cm, A)
    B, S, di = x.shape
    ds = Bm.shape[2]
    width = state_width(ds)
    y = torch.empty_like(x)
    if B * di == 0:
        return y, torch.empty((B, di, ds), dtype=torch.float32,
                              device=x.device)
    if width != ds:
        Bm, Cm, A = pad_state(Bm, Cm, A, width)
    h_end = torch.empty((B, di, width), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _kernel()(dt.data_ptr(), x.data_ptr(), Bm.data_ptr(),
                        Cm.data_ptr(), A.data_ptr(), y.data_ptr(),
                        h_end.data_ptr(), B, S, di, width, stream)
    if err != 0:
        raise RuntimeError(f"mamba_scan kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    if width == ds:
        return y, h_end
    launches_padded += 1
    return y, h_end[..., :ds].contiguous()
