"""Mixture-of-Experts FFN: GShard-style grouped one-hot dispatch.

Port of ``repro.models.moe`` in plain PyTorch (the JAX package has no
Pallas kernel here: its products are einsums).  Tokens are split into
groups of at most ``_GROUP``; within a group the top-k routing builds a
[g, E, C] one-hot dispatch tensor by cumulative position counting:

    buf = einsum('zgec,zgd->zecd', dispatch, x)
    out = expert_ffn(buf)                    # one batched product per expert
    y   = einsum('zgec,zecd->zgd', combine, out)

Tokens past an expert's per-group capacity C are dropped (GShard); the
Switch-style aux loss is returned beside y.  A single-token step
(S == 1) evaluates every expert and masks by the top-k gates instead.

The experts' products run as ``[E, T, d] @ [E, d, f]`` batched matmuls
over the stored ``[E, d, f]`` leaves, so no weight is ever copied.  The
top-k keeps ``jax.lax.top_k``'s order on ties (lower expert first)
through a stable sort.  The JAX package's sharding hints sit at its
points (``parallel.sharding.hint``: the identity on plain tensors); the
expert-major buffers take the reference's group-major rules through a
transposed view.  On DTensors (a mesh) the routing runs on each rank's
local groups (``sharding.local_call``), the dispatch and combine
products flatten the (expert, slot) pairs expert-major, and the decode
step's gate mask is a sum of one-hots: DTensor propagates all three.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import FFN, ModelConfig
from repro_torch.models.layers import dense_init
from repro_torch.parallel.sharding import (P, hint, is_dtensor,
                                          kernel_specs, local_call,
                                          tensor_placements)

_GROUP = 512


def groups_within_rows(seq_len: int) -> bool:
    """Whether ``apply_moe``'s routing groups over rows of ``seq_len``
    tokens lie inside single rows, so that each row routes alone."""
    return seq_len % min(_GROUP, seq_len) == 0


def init_moe(gen, cfg: ModelConfig, kind: FFN, dtype):
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    names = (("w_gate", "w_up", "w_down") if kind in (FFN.SWIGLU, FFN.GEGLU)
             else ("w_up", "w_down"))
    experts = {n: dense_init(gen, (E, f, d) if n == "w_down" else (E, d, f),
                             dtype=dtype) for n in names}
    return {"router": dense_init(gen, (d, E), scale=0.02, dtype=dtype),
            "experts": experts}


def _capacity(group_tokens: int, cfg: ModelConfig) -> int:
    cap = int(group_tokens * cfg.top_k / cfg.n_experts
              * cfg.capacity_factor)
    return max(cap, cfg.top_k)


def _hint_ez(t, name: str, groups=None):
    """``hint`` of an expert-major ``[E, Gn, ...]`` tensor (``[E, Gn*C,
    ...]`` with ``groups = (Gn, C)``) under the reference's group-major
    ``[Gn, E, C, ...]`` rule of the same name."""
    if not is_dtensor(t):
        return t
    shape = t.shape
    if groups is not None:
        t = t.reshape(shape[0], *groups, *shape[2:])
    t = hint(t.transpose(0, 1), name).transpose(0, 1)
    return t.reshape(shape)


def _expert_ffn(experts, kind: FFN, h, groups=None, sfx: str = ""):
    """h: [E, T, d] -> [E, T, d], one batched product per expert.
    ``groups`` = (Gn, C) when T is Gn capacity buffers of C tokens (the
    hidden activations then take the ``moe_hidden`` hint)."""
    up = _hint_ez(h @ experts["w_up"], "moe_hidden" + sfx, groups)
    if kind in (FFN.SWIGLU, FFN.GEGLU):
        gate = h @ experts["w_gate"]
        act = F.silu(gate) if kind == FFN.SWIGLU else \
            F.gelu(gate, approximate="tanh")
        mid = act * up
    elif kind == FFN.SQUARED_RELU:
        mid = torch.square(F.relu(up))
    else:
        mid = F.gelu(up, approximate="tanh")
    mid = _hint_ez(mid, "moe_hidden" + sfx, groups)
    return mid @ experts["w_down"]


def _route(x, router, K: int):
    """Softmax gates [..., E] (fp32) and the top-K renormalised weights
    and experts [..., K], ties to the lower expert as ``lax.top_k``."""
    return _top_k(x @ router, K)


def _top_k(logits, K: int):
    """``_route`` of router ``logits`` [..., E]."""
    gates = torch.softmax(logits.float(), dim=-1)
    top_w, top_e = torch.sort(gates, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[..., :K], top_e[..., :K]
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    return gates, top_w, top_e


def _dense_decode_moe(params, cfg: ModelConfig, kind: FFN, x):
    """Single-token decode: every expert on every row, masked by the
    top-k gates (weight-read bound either way at S == 1)."""
    B, S, d = x.shape
    E = cfg.n_experts
    xt = x.reshape(B, d)
    _, top_w, top_e = _route(xt, params["router"], cfg.top_k)
    w_mask = sum(top_w[:, k, None] * F.one_hot(top_e[:, k], E).float()
                 for k in range(cfg.top_k))
    out = _expert_ffn(params["experts"], kind, xt.expand(E, B, d))
    y = torch.einsum("ebd,be->bd", out, w_mask.to(out.dtype))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return y.reshape(B, S, d).to(x.dtype), aux


def _dispatch_tensors(logits, *, K: int, C: int, dtype):
    """Router logits [Gn, g, E] -> (gates [Gn, g, E] fp32, first choices
    [Gn, g], dispatch [Gn, g, E, C] in ``dtype``, combine [Gn, g, E, C]
    fp32): each token's position in its experts' capacity buffers by
    cumulative counting over the K slots, tokens past C dropped."""
    E = logits.shape[-1]
    gates, top_w, top_e = _top_k(logits, K)
    dispatch = combine = counts = None
    for k in range(K):
        oh = F.one_hot(top_e[..., k], E).float()                # [Gn,g,E]
        pos = torch.cumsum(oh, dim=1) - oh
        if counts is not None:
            pos = pos + counts[:, None, :]
        within = (pos < C).float() * oh
        # positions past capacity are dropped by `within`; clamp them so
        # one_hot takes them (jax.nn.one_hot gives zeros there)
        pos_oh = F.one_hot(torch.clamp(pos, max=C - 1).long(), C).float()
        sel = within[..., None] * pos_oh                        # [Gn,g,E,C]
        wsel = top_w[..., k, None, None] * sel
        if counts is None:
            dispatch, combine, counts = sel.to(dtype), wsel, oh.sum(dim=1)
        else:
            dispatch = dispatch + sel.to(dtype)
            combine = combine + wsel
            counts = counts + oh.sum(dim=1)
    return gates, top_e[..., 0], dispatch, combine


def apply_moe(params, cfg: ModelConfig, kind: FFN, x):
    """x: [B, S, d] -> (y, aux_loss)."""
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    if S == 1:
        return _dense_decode_moe(params, cfg, kind, x)
    g = min(_GROUP, S)
    if (B * S) % g:
        raise ValueError(f"apply_moe: {B}x{S} tokens do not split into "
                         f"groups of {g}")
    Gn = B * S // g
    C = _capacity(g, cfg)
    xg = x.reshape(Gn, g, d)
    logits = xg @ params["router"]                           # [Gn, g, E]
    rows = None
    if is_dtensor(logits):
        # per group on each rank's local groups: the routing is
        # independent per group, and the one-hots' cumulative counts
        # and the top-k's backward stay off DTensor's propagation
        b, _ = kernel_specs(logits.device_mesh, Gn, 1)
        rows = P(b, None, None)
        gates, top_e0, dispatch, combine = local_call(
            _dispatch_tensors, (logits,), (rows,),
            (rows, P(b, None), P(b, None, None, None),
             P(b, None, None, None)), K=K, C=C, dtype=x.dtype)
    else:
        gates, top_e0, dispatch, combine = _dispatch_tensors(
            logits, K=K, C=C, dtype=x.dtype)

    # expert-parallel when E can cover the model axis; TP-on-ffn otherwise
    sfx = "_ep" if E >= 16 else ""
    experts = {n: hint(w, ("moe_w_out" if n in ("w_down", "w_value")
                           else "moe_w_in") + sfx)
               for n, w in params["experts"].items()}
    if sfx:
        dispatch = hint(dispatch, "moe_onehot_ep")
        combine = hint(combine, "moe_onehot_ep")
    # the einsums 'zgec,zgd->ezcd' and 'zgec,ezcd->zgd' as products over
    # the flattened (e, c) pairs, e outermost: expert-sharded operands
    # flatten to plain shards (an einsum may flatten (c, e), whose strided
    # shard DTensor cannot multiply on fake tensors)
    buf = (dispatch.reshape(Gn, g, E * C).transpose(1, 2) @ xg)
    buf = buf.reshape(Gn, E, C, d).transpose(0, 1)           # [E,Gn,C,d]
    buf = _hint_ez(buf, "moe_buffer" + sfx)
    out = _expert_ffn(experts, kind, buf.reshape(E, Gn * C, d), (Gn, C),
                      sfx)
    out = out.reshape(E, Gn, C, d).transpose(0, 1).reshape(Gn, E * C, d)
    y = combine.to(x.dtype).reshape(Gn, g, E * C) @ out
    if rows is not None:
        # groups over the data axes only, as the rows they unflatten to
        # (DTensor may split them over ``model`` too, more ways than the
        # rows divide)
        y = y.redistribute(y.device_mesh, tensor_placements(
            rows, tuple(y.shape), y.device_mesh))

    # aux load-balancing loss (Switch-style)
    me = gates.reshape(-1, E).mean(dim=0)
    ce = F.one_hot(top_e0.reshape(-1), E).float().mean(dim=0)
    aux = cfg.router_aux_coef * E * torch.sum(me * ce)
    return y.reshape(B, S, d), aux
