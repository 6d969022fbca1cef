"""RWKV6 ("Finch") time-mix with data-dependent decay.

Port of ``repro.models.rwkv``.  Per head (key dim N = head_dim):
    S_t = diag(w_t) S_{t-1} + k_t v_t^T          (state: [N, N])
    y_t = r_t . (diag(u) k_t v_t^T + S_{t-1})
with per-channel per-token decay w_t in (0,1) produced by a low-rank MLP
of the token-shifted input.

Prefill uses the chunked linear-attention algorithm (``rwkv_scan``):
within a chunk the quadratic form with cumulative-decay ratios, across
chunks a recurrent state update, all in log-decay space.  Decode is one
recurrence step (S = 1, chunk 1, carried state).

Which calls reach the CUDA kernel: under the ``"kernel"`` implementation
(``models.attention.set_attention_impl``, the switch that mirrors the JAX
package's ``"pallas"``), ``apply_rwkv`` sends the scan to
``kernels.ops.rwkv6_scan`` whenever it starts from a zero state
(``state is None``), which is every one-shot prefill; that is the
kernel's contract (``csrc/rwkv6_scan.cu``).  A carried state (decode)
takes ``rwkv_scan`` under either implementation, and ``"plain"`` always
takes ``rwkv_scan``.  So does every chunk of chunked admission: it
carries the slot's state (zeroed at install) and ``valid=``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import attention as attn_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init, token_shift

_CHUNK = 64
_DECAY_LORA = 64


def init_rwkv(gen, cfg: ModelConfig, dtype):
    d = cfg.d_model
    H, hd = cfg.rwkv_n_heads, cfg.rwkv_head_dim
    full = lambda shape, val: torch.full(shape, val, dtype=dtype,
                                         device=gen.device)
    return {
        "mu": full((5, d), 0.5),  # r,k,v,g,w token-shift mixes
        "w_r": dense_init(gen, (d, d), dtype=dtype),
        "w_k": dense_init(gen, (d, d), dtype=dtype),
        "w_v": dense_init(gen, (d, d), dtype=dtype),
        "w_g": dense_init(gen, (d, d), dtype=dtype),
        "w_o": dense_init(gen, (d, d), dtype=dtype),
        "decay_w1": dense_init(gen, (d, _DECAY_LORA), dtype=dtype),
        "decay_w2": dense_init(gen, (_DECAY_LORA, d), dtype=dtype),
        "decay_base": full((d,), -6.0),
        "bonus_u": dense_init(gen, (H, hd), scale=0.5, dtype=dtype),
        "out_norm": {"scale": full((d,), 1.0)},
    }


def _project(params, cfg: ModelConfig, x, shifted):
    """Returns r,k,v,g [B,S,H,hd] and log-decay logw [B,S,H,hd] (<0, fp32)."""
    B, S, d = x.shape
    H, hd = cfg.rwkv_n_heads, cfg.rwkv_head_dim
    mu = params["mu"]
    mix = lambda i: x + (shifted - x) * mu[i]
    heads = lambda t: t.reshape(B, S, H, hd)
    r = heads(mix(0) @ params["w_r"])
    k = heads(mix(1) @ params["w_k"])
    v = heads(mix(2) @ params["w_v"])
    g = F.silu(mix(3) @ params["w_g"])
    dlora = torch.tanh(mix(4) @ params["decay_w1"]) @ params["decay_w2"]
    logw = -torch.exp((params["decay_base"] + dlora).float())  # [B,S,d] < 0
    return r, k, v, g, heads(logw)


def _chunk_form(r, k, v, logw, u, S0):
    """One chunk, all heads. r,k,v,logw: [B,c,H,N] fp32; S0: [B,H,N,N].

    Returns (y [B,c,H,N], S_end)."""
    c = r.shape[1]
    cum = torch.cumsum(logw, dim=1)                   # inclusive cumsum
    cum_ex = cum - logw                               # exclusive
    total = cum[:, -1]                                # [B,H,N]

    # inter-chunk: y_inter[t] = (r_t * exp(cum_ex_t)) @ S0
    r_dec = r * torch.exp(cum_ex)
    y_inter = torch.einsum("bchn,bhnm->bchm", r_dec, S0)

    # intra-chunk: scores[t,s] = sum_n r[t,n] k[s,n] exp(cum_ex_t - cum_s)
    #   valid s < t; the diagonal uses the bonus u instead of decay.
    ratio = cum_ex[:, :, None] - cum[:, None, :]      # [B,t,s,H,N]
    idx = torch.arange(c, device=r.device)
    mask = idx[:, None] > idx[None, :]
    att = (r[:, :, None] * k[:, None, :]
           * torch.exp(torch.clamp(ratio, max=0.0))).sum(-1)
    att = att * mask[None, :, :, None]
    y_intra = torch.einsum("btsh,bshm->bthm", att, v)
    diag = (r * u * k).sum(-1)
    y_intra = y_intra + diag[..., None] * v

    # state: S_end = diag(exp(total)) S0 + sum_s exp(total-cum_s) k_s v_s^T
    k_dec = k * torch.exp(total[:, None] - cum)
    S_end = torch.exp(total)[..., None] * S0 + \
        torch.einsum("bshn,bshm->bhnm", k_dec, v)
    return y_inter + y_intra, S_end


def rwkv_scan(r, k, v, logw, u, state0, chunk=_CHUNK):
    """r,k,v,logw: [B,S,H,N]; u: [H,N]; state0: [B,H,N,N] or None."""
    B, S, H, N = r.shape
    pad = (-S) % chunk
    if pad:
        padt = lambda t: F.pad(t, (0, 0, 0, 0, 0, pad))
        r, k, v, logw = padt(r), padt(k), padt(v), padt(logw)
    if state0 is None:
        state0 = torch.zeros((B, H, N, N), dtype=torch.float32,
                             device=r.device)
    S_c, ys = state0, []
    for c0 in range(0, S + pad, chunk):
        sl = slice(c0, c0 + chunk)
        y, S_c = _chunk_form(r[:, sl], k[:, sl], v[:, sl], logw[:, sl], u,
                             S_c)
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :S], S_c


def apply_rwkv(params, cfg: ModelConfig, x, state: Optional[dict] = None,
               return_state: bool = False, valid=None):
    """x: [B,S,d]. state: {"tm_shift": [B,d], "wkv": [B,H,N,N]}.

    ``valid`` ([B,S] bool) marks real tokens in a chunked-prefill chunk:
    invalid (trailing) tokens freeze the recurrence — their decay is
    forced to 1 and their key contribution to 0, so the wkv state passes
    through unchanged, and ``tm_shift`` carries each row's last *valid*
    token.  Outputs at invalid positions are garbage and must be
    discarded by the caller."""
    B, S, d = x.shape
    if state is not None:
        shifted = torch.cat(
            [state["tm_shift"][:, None, :].to(x.dtype), x[:, :-1]], dim=1)
        wkv0 = state["wkv"]
    else:
        shifted = token_shift(x)
        wkv0 = None
    r, k, v, g, logw = _project(params, cfg, x, shifted)
    if valid is not None:
        vm = valid[:, :, None, None]
        k = k * vm                       # no state / attention contribution
        logw = torch.where(vm, logw, 0.0)   # decay 1: state passes through
    u = params["bonus_u"].float()
    if wkv0 is None and attn_mod.get_attention_impl() == "kernel":
        y, wkv_end = kernel_ops.rwkv6_scan(r.float(), k.float(), v.float(),
                                           logw, u)
    else:
        y, wkv_end = rwkv_scan(r.float(), k.float(), v.float(), logw, u,
                               wkv0, chunk=min(_CHUNK, S))
    # per-head group norm (population variance, as jnp.var)
    mean = y.mean(-1, keepdim=True)
    var = y.var(-1, keepdim=True, correction=0)
    y = (y - mean) * torch.rsqrt(var + 64e-5)
    y = y.reshape(B, S, d) * params["out_norm"]["scale"].to(y.dtype)
    y = (y.to(x.dtype) * g) @ params["w_o"]
    if return_state:
        if valid is None:
            tm = x[:, -1, :]
        else:
            idx = (valid.sum(dim=1) - 1).clamp(0, S - 1)
            tm = x[torch.arange(B, device=x.device), idx]
        return y, {"tm_shift": tm, "wkv": wkv_end}
    return y


def init_rwkv_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                    device="cpu"):
    H, N = cfg.rwkv_n_heads, cfg.rwkv_head_dim
    return {
        "tm_shift": torch.zeros((batch, cfg.d_model), dtype=dtype,
                                device=device),
        "cm_shift": torch.zeros((batch, cfg.d_model), dtype=dtype,
                                device=device),
        "wkv": torch.zeros((batch, H, N, N), dtype=torch.float32,
                           device=device),
    }
