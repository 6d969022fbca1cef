"""Mamba (selective SSM) mixer, the Jamba-style block.

Port of ``repro.models.mamba``.  Recurrence per channel d and state s:
    h_t = exp(dt_t A) * h_{t-1} + dt_t B_t x_t ;   y_t = C_t . h_t + D x_t
with input-dependent dt, B, C (selectivity) after a depthwise causal
convolution.  Decode keeps per-layer ``conv`` (the last d_conv - 1
inputs) and ``ssm`` (h) states and takes one recurrence step.

The JAX package's ``ssm_scan`` runs the recurrence as an associative
scan inside chunks of 64 tokens; PyTorch has no associative scan, so
the port's ``ssm_scan`` walks the tokens one by one through the kernel's
plain version (the same recurrence, summed in another order: fp32
agrees to rounding).

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
from repro_torch.kernels.mamba_scan.ops import mamba_scan_plain
from repro_torch.models import attention as attn_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init


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


def ssm_scan(dt, Bm, Cm, x, A, D, h0):
    """Selective scan, token by token in fp32. dt, x [B,S,di]; Bm, Cm
    [B,S,ds]; A [di,ds]; D [di]; h0 [B,di,ds] or None (zeros).  Returns
    (y [B,S,di] with the D x skip, h_end [B,di,ds])."""
    y, h_end = mamba_scan_plain(dt, x, Bm, Cm, A, h0)
    return y + x.float() * D, h_end


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
                            None if state is None else state["ssm"])
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
