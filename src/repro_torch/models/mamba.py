"""Mamba (selective SSM) mixer, the Jamba-style block.

Port of ``repro.models.mamba``.  Recurrence per channel d and state s:
    h_t = exp(dt_t A) * h_{t-1} + dt_t B_t x_t ;   y_t = C_t . h_t + D x_t
with input-dependent dt, B, C (selectivity) after a depthwise causal
convolution.  Decode keeps per-layer ``conv`` (the last d_conv - 1
inputs) and ``ssm`` (h) states and takes one recurrence step.

``ssm_scan`` runs the recurrence as the JAX package's does: an
associative scan inside chunks of 64 tokens (``lax.associative_scan``'s
odd/even recursion, written out), the state carried across chunks.  The
kernel's plain version (``kernels.mamba_scan.ops.mamba_scan_plain``)
walks the tokens one by one: the same recurrence, summed in another
order (fp32 agrees to rounding).

Which calls reach the CUDA kernel: under the ``"kernel"`` implementation
(``models.attention.set_attention_impl``), ``apply_mamba`` sends the scan
to ``kernels.ops.mamba_scan`` whenever it starts from a zero state
(``state is None``), which is every one-shot prefill, and adds the
``D x`` skip after it; that is the kernel's contract
(``csrc/mamba_scan.cu``).  A carried state (every decode step, S = 1)
takes ``ssm_scan`` under either implementation, and ``"plain"`` always
takes ``ssm_scan``.  So does every chunk of chunked admission: it
carries the slot's state (zeroed at install) and ``valid=``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import attention as attn_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init
from repro_torch.parallel import sharding as sh

_CHUNK = 64


def dt_rank(cfg: ModelConfig) -> int:
    return max(cfg.d_model // 16, 8)


def init_mamba(gen, cfg: ModelConfig, dtype):
    d, di, ds = cfg.d_model, cfg.mamba_d_inner, cfg.mamba_d_state
    dc, r = cfg.mamba_d_conv, dt_rank(cfg)
    full = lambda shape, val: torch.full(shape, val, dtype=dtype,
                                         device=gen.device)
    # S4D-real init for A: A_log[d, s] = log(s + 1)
    a = torch.arange(1, ds + 1, dtype=torch.float32, device=gen.device)
    return {
        "in_proj": dense_init(gen, (d, 2 * di), dtype=dtype),
        "conv_w": dense_init(gen, (dc, di), dtype=dtype),
        "conv_b": full((di,), 0.0),
        "x_proj": dense_init(gen, (di, r + 2 * ds), dtype=dtype),
        "dt_proj": dense_init(gen, (r, di), dtype=dtype),
        "dt_bias": full((di,), -4.6),       # softplus^-1(~0.01)
        "A_log": torch.log(a).expand(di, ds).to(dtype).contiguous(),
        "D": full((di,), 1.0),
        "out_proj": dense_init(gen, (di, d), dtype=dtype),
    }


def _causal_conv(x, w, b, state=None, n_valid=None):
    """Depthwise causal conv. x: [B,S,di], w: [dc,di].  Returns (y,
    new_state): the state is the trailing dc-1 inputs, in x's dtype.
    ``n_valid`` ([B] int) ends each row's state window at its last
    *valid* input instead of the chunk end (partial chunked-prefill
    chunks: trailing invalid tokens must not enter the carried state)."""
    dc = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, dc - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    if dc <= 1:
        new_state = None
    elif n_valid is None:
        new_state = xp[:, xp.shape[1] - (dc - 1):, :]
    else:
        # xp rows: [dc-1 carried inputs | chunk]; the dc-1 inputs ending
        # at the last valid token start at index n_valid
        idx = n_valid.to(torch.int64)[:, None] + torch.arange(
            dc - 1, device=x.device)
        new_state = torch.gather(
            xp, 1, idx[..., None].expand(-1, -1, xp.shape[2]))
    y = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(dc)) + b
    return y, new_state


def _ssm_params(params, cfg: ModelConfig, u):
    """u: [B,S,di] -> dt [B,S,di] fp32, Bm/Cm [B,S,ds] (u's dtype),
    A [di,ds] fp32."""
    r, ds = dt_rank(cfg), cfg.mamba_d_state
    dbc = u @ params["x_proj"]
    dt = F.softplus((dbc[..., :r] @ params["dt_proj"]).float()
                    + params["dt_bias"].float())
    Bm = dbc[..., r:r + ds]
    Cm = dbc[..., r + ds:]
    A = -torch.exp(params["A_log"].float())
    return dt, Bm, Cm, A


def _assoc_scan(a, b):
    """Inclusive scan along dim 1 of the affine steps h -> a h + b (the
    composition of an earlier (a1, b1) and a later (a2, b2) is (a1 a2,
    a2 b1 + b2)), by ``lax.associative_scan``'s odd/even recursion:
    combine adjacent pairs, scan the pairs, fill in the even positions."""
    n = a.shape[1]
    if n < 2:
        return a, b
    a_p = a[:, 0:n - 1:2] * a[:, 1::2]
    b_p = a[:, 1::2] * b[:, 0:n - 1:2] + b[:, 1::2]
    a_odd, b_odd = _assoc_scan(a_p, b_p)            # prefixes at 1, 3, ...
    m = (n - 1) // 2                                # even positions >= 2
    a_ev = torch.cat([a[:, :1], a_odd[:, :m] * a[:, 2::2]], dim=1)
    b_ev = torch.cat([b[:, :1], a[:, 2::2] * b_odd[:, :m] + b[:, 2::2]],
                     dim=1)

    def weave(ev, odd):
        k = odd.shape[1]
        out = torch.stack([ev[:, :k], odd], dim=2).flatten(1, 2)
        return torch.cat([out, ev[:, k:]], dim=1) if ev.shape[1] > k \
            else out
    return weave(a_ev, a_odd), weave(b_ev, b_odd)


def _chunk_scan(dt_c, B_c, x_c, A, h0):
    """One chunk of the recurrence by associative scan: dt_c, x_c
    [B,c,di], B_c [B,c,ds], h0 [B,di,ds] -> (hidden states [B,c,di,ds],
    the last)."""
    da = torch.exp(dt_c[..., None] * A)                     # [B,c,di,ds]
    dbx = (dt_c * x_c)[..., None] * B_c[:, :, None, :]      # [B,c,di,ds]
    # h0 folds into the first step's additive term
    dbx = torch.cat([dbx[:, :1] + da[:, :1] * h0[:, None], dbx[:, 1:]],
                    dim=1)
    _, hs = _assoc_scan(da, dbx)
    return hs, hs[:, -1]


def ssm_scan(dt, Bm, Cm, x, A, D, h0, chunk=_CHUNK):
    """Selective scan in fp32, as the JAX package's: chunks of ``chunk``
    tokens, each an associative scan, the state carried from chunk to
    chunk.  dt, x [B,S,di]; Bm, Cm [B,S,ds]; A [di,ds]; D [di]; h0
    [B,di,ds] or None (zeros).  Returns (y [B,S,di] with the D x skip,
    h_end [B,di,ds]).  On DTensors each rank scans its local rows and
    channels (as ``kernels.ops.mamba_scan``: the recurrence is elementwise
    in di)."""
    if sh.is_dtensor(x):
        b, m = sh.kernel_specs(x.device_mesh, x.shape[0], x.shape[2])
        chan, st, state = sh.P(b, None, m), sh.P(b, None, None), \
            sh.P(b, m, None)
        return sh.local_call(ssm_scan, (dt, Bm, Cm, x, A, D, h0),
                             (chan, st, st, chan, sh.P(m, None), sh.P(m),
                              None if h0 is None else state),
                             (chan, state), chunk=chunk)
    B, S, di = x.shape
    pad = (-S) % chunk
    # padded steps have dt 0: decay 1, input 0, so the state passes
    pad3 = lambda t: F.pad(t.float(), (0, 0, 0, pad))  # noqa: E731
    dt_p, B_p, C_p, x_p = pad3(dt), pad3(Bm), pad3(Cm), pad3(x)
    h = (torch.zeros((B, di, A.shape[1]), dtype=torch.float32,
                     device=x.device) if h0 is None else h0.float())
    ys = []
    for c0 in range(0, S + pad, chunk):
        sl = slice(c0, c0 + chunk)
        hs, h = _chunk_scan(dt_p[:, sl], B_p[:, sl], x_p[:, sl], A, h)
        ys.append(torch.einsum("bcds,bcs->bcd", hs, C_p[:, sl]))
    y = torch.cat(ys, dim=1)[:, :S]
    return y + x.float() * D, h


def apply_mamba(params, cfg: ModelConfig, x, state: Optional[dict] = None,
                return_state: bool = False, valid=None):
    """x: [B,S,d]. state: {"conv": [B,dc-1,di], "ssm": [B,di,ds]}.

    ``valid`` ([B,S] bool) marks real tokens in a chunked-prefill chunk:
    invalid (trailing) tokens freeze the recurrence — dt is zeroed so
    the SSM state passes through unchanged, and the conv window ends at
    each row's last valid input.  Outputs at invalid positions are
    garbage and must be discarded by the caller."""
    di = cfg.mamba_d_inner
    xz = x @ params["in_proj"]
    u, z = xz[..., :di], xz[..., di:]
    n_valid = valid.sum(dim=1) if valid is not None else None
    u, new_conv = _causal_conv(u, params["conv_w"], params["conv_b"],
                               None if state is None else state["conv"],
                               n_valid=n_valid)
    u = F.silu(u)
    dt, Bm, Cm, A = _ssm_params(params, cfg, u)
    if valid is not None:
        dt = dt * valid[..., None]     # exp(0*A)=1, 0*B*x=0: state frozen
    D = params["D"].float()
    if state is None and attn_mod.get_attention_impl() == "kernel":
        y, h_end = kernel_ops.mamba_scan(
            dt, u.float().contiguous(), Bm.float().contiguous(),
            Cm.float().contiguous(), A)
        y = y + u.float() * D
    else:
        y, h_end = ssm_scan(dt, Bm, Cm, u, A, D,
                            None if state is None else state["ssm"],
                            chunk=min(_CHUNK, x.shape[1]))
    y = (y.to(x.dtype) * F.silu(z)) @ params["out_proj"]
    if return_state:
        return y, {"conv": new_conv, "ssm": h_end}
    return y


def init_mamba_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device="cpu"):
    di = cfg.mamba_d_inner
    return {
        "conv": torch.zeros((batch, cfg.mamba_d_conv - 1, di), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, di, cfg.mamba_d_state),
                           dtype=torch.float32, device=device),
    }
