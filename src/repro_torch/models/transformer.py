"""Model assembly: init, forward (prefill) and single-token decode.

Port of ``repro.models.transformer`` for attention, RWKV6 and Mamba
mixers with dense FFNs, MoE FFNs and the RWKV channel mix.  Block params
are stacked over a leading ``[R]`` repeats dim as in the JAX package; its
``lax.scan`` over the stack becomes a Python loop over ``R``, and each
layer writes its cache entry in place into the ``[R, ...]`` leaves' slice
``r``.  The MoE aux loss is computed and dropped, as the JAX decode and
serving paths drop it.  Feature frontends and encoder-only models are not
yet ported and raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch

from repro_torch.device import resolve_dtype
from repro_torch.models import attention as attn_mod
from repro_torch.models import cache as cache_mod
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models.config import FFN, Mixer, ModelConfig
from repro_torch.models.layers import (apply_ffn, embed_tokens,
                                       init_embeddings, init_ffn,
                                       init_rmsnorm, rmsnorm, token_shift,
                                       unembed)


def check_supported(cfg: ModelConfig) -> None:
    """Raise for the parts of the model zoo the port does not run yet."""
    if cfg.frontend != "tokens" or cfg.is_encoder_only:
        raise NotImplementedError(
            f"{cfg.name}: feature frontends / encoder-only models are not "
            "yet ported")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

# mixer -> (params key, init, apply of the recurrent mixers)
_MIXERS = {
    Mixer.ATTENTION: ("attn", attn_mod.init_attention, None),
    Mixer.MAMBA: ("mamba", mamba_mod.init_mamba, mamba_mod.apply_mamba),
    Mixer.RWKV6: ("rwkv", rwkv_mod.init_rwkv, rwkv_mod.apply_rwkv),
}


def _init_layer(gen, cfg: ModelConfig, spec, dtype) -> Dict[str, Any]:
    key, init, _ = _MIXERS[spec.mixer]
    p = {"norm1": init_rmsnorm(cfg.d_model, dtype, gen.device),
         "norm2": init_rmsnorm(cfg.d_model, dtype, gen.device),
         key: init(gen, cfg, dtype)}
    if spec.moe:
        p["moe"] = moe_mod.init_moe(gen, cfg, spec.ffn, dtype)
    else:
        p["ffn"] = init_ffn(gen, cfg, spec.ffn, dtype)
    return p


def init_params(cfg: ModelConfig, seed: int = 0,
                device: Union[str, torch.device] = "cpu",
                dtype: Optional[Union[str, torch.dtype]] = None
                ) -> Dict[str, Any]:
    """Seeded weights with the JAX package's distributions and layout
    (``{"embed", "blocks" (stacked [R, ...]), "final_norm"}``).  The
    draws differ from the JAX init's (different generators): parity
    tests carry JAX weights across with ``bridge`` instead.

    Every block weight is held once: with one repeat (R == 1) the
    layers' leaves become the ``[1, ...]`` leaves as views; otherwise
    each ``[R, ...]`` leaf is allocated once and repeat ``r`` is copied
    into it as soon as it is drawn, so at most one repeat's layers are
    held beside the stack."""
    cfg.validate()
    check_supported(cfg)
    dt = resolve_dtype(dtype or cfg.dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    embed = init_embeddings(gen, cfg, dt)
    R = cfg.n_pattern_repeats
    blocks = None
    for r in range(R):
        layers = {f"layer{j}": _init_layer(gen, cfg, spec, dt)
                  for j, spec in enumerate(cfg.pattern)}
        if R == 1:
            blocks = cache_mod.tree_map(lambda t: t.unsqueeze(0), layers)
            break
        if blocks is None:
            blocks = cache_mod.tree_map(
                lambda t: t.new_empty((R,) + tuple(t.shape)), layers)
        cache_mod.tree_map(lambda dst, src: dst[r].copy_(src), blocks,
                           layers)
        del layers
    return {"embed": embed, "blocks": blocks,
            "final_norm": init_rmsnorm(cfg.d_model, dt, gen.device)}


def _tree_index(tree, r: int):
    if isinstance(tree, dict):
        return {k: _tree_index(v, r) for k, v in tree.items()}
    return tree[r]


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------

def _layer_forward(p, cfg: ModelConfig, spec, x, positions, *, long_mode,
                   cache_entry):
    """One mixer + FFN layer over a whole sequence.  With ``cache_entry``
    (this layer's cache views at one repeat: {"k", "v"} [B, L, KV, hd],
    {"tm_shift", "wkv", "cm_shift"} or {"conv", "ssm"}) the layer's
    decode state is written into it."""
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    if spec.mixer == Mixer.ATTENTION:
        window = cache_mod.effective_window(cfg, spec, long_mode)
        q, k, v = attn_mod.qkv_project(p["attn"], cfg, h, positions)
        y = attn_mod.multihead_attention(
            q, k, v, positions, positions, causal=cfg.causal, window=window,
            cap=cfg.attn_softcap)
        B, S = h.shape[:2]
        x = x + y.reshape(B, S, -1) @ p["attn"]["wo"]
        if cache_entry is not None:
            cache_mod.prefill_kv(cache_entry["k"], cache_entry["v"], k, v,
                                 window)
    else:
        key, _, apply = _MIXERS[spec.mixer]
        y, st = apply(p[key], cfg, h, return_state=True)
        x = x + y
        if cache_entry is not None:
            for name, t in st.items():
                cache_entry[name].copy_(t)
    h = rmsnorm(p["norm2"], x, cfg.norm_eps)
    if spec.moe:
        return x + moe_mod.apply_moe(p["moe"], cfg, spec.ffn, h)[0]
    if spec.ffn == FFN.RWKV_CHANNEL:
        y = apply_ffn(p["ffn"], cfg, spec.ffn, h, shifted=token_shift(h))
        if cache_entry is not None:
            cache_entry["cm_shift"].copy_(h[:, -1, :])
        return x + y
    return x + apply_ffn(p["ffn"], cfg, spec.ffn, h)


def _entry(leaf: Dict[str, torch.Tensor], r: int) -> Dict[str, torch.Tensor]:
    """A layer's cache views at repeat ``r`` (writes land in the leaves)."""
    return {n: t[r] for n, t in leaf.items()}


def forward(params, cfg: ModelConfig, inputs: Dict[str, Any], *,
            long_mode: bool = False, return_cache: bool = False,
            max_cache_len: Optional[int] = None) -> Dict[str, Any]:
    """Full-sequence forward over ``inputs["tokens"]`` [B, S].  Returns
    {"logits" [B, S, V], "hidden"} and, with ``return_cache``, a decode
    cache primed with the sequence (``{"blocks", "pos": S}``)."""
    check_supported(cfg)
    tokens = inputs["tokens"]
    x = embed_tokens(params["embed"], cfg, tokens)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)
    max_cache_len = max_cache_len or S
    cache = None
    if return_cache:
        cache = cache_mod.init_cache(cfg, B, max_cache_len,
                                     long_mode=long_mode,
                                     dtype=params["final_norm"]["scale"].dtype,
                                     device=x.device)
    for r in range(cfg.n_pattern_repeats):
        bp = _tree_index(params["blocks"], r)
        for j, spec in enumerate(cfg.pattern):
            entry = (None if cache is None
                     else _entry(cache["blocks"][f"layer{j}"], r))
            x = _layer_forward(bp[f"layer{j}"], cfg, spec, x, positions,
                               long_mode=long_mode, cache_entry=entry)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    out = {"logits": unembed(params["embed"], cfg, x), "hidden": x}
    if cache is not None:
        cache["pos"] = S
        out["cache"] = cache
    return out


# ---------------------------------------------------------------------------
# Decode (single token)
# ---------------------------------------------------------------------------

def _decode_mask(pos, q_pos, cache_len: int, window: Optional[int],
                 batch: int):
    """Key positions, slot validity and the flash-decode bias [B, L] of
    one decode step over a cache of ``cache_len`` slots.  Every layer
    with the same cache length and window shares them, so
    ``decode_step`` builds them once per step."""
    k_pos, valid = cache_mod.ring_slot_positions(cache_len, window, pos,
                                                 device=q_pos.device)
    bias = attn_mod.decode_bias(q_pos, k_pos, causal=True, window=window,
                                k_valid=valid, batch=batch).contiguous()
    return k_pos, valid, bias


def _layer_decode(p, cfg: ModelConfig, spec, x, entry, pos, q_pos, window,
                  mask):
    """x: [B, 1, d]; ``entry``: this layer's cache views at one repeat,
    updated in place.  Attention writes k/v at `pos` (an int, or a [B]
    tensor of per-row positions: every slot keeps its own RoPE phase,
    ring offset and validity mask) and reads `mask`, this step's
    ``_decode_mask`` for the layer's cache; RWKV6 advances its
    ``tm_shift`` / ``wkv`` state and Mamba its ``conv`` / ``ssm`` state
    by one token."""
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    if spec.mixer == Mixer.ATTENTION:
        q, k, v = attn_mod.qkv_project(p["attn"], cfg, h, q_pos)
        ck, cv = entry["k"], entry["v"]
        cache_mod.write_kv(ck, cv, k, v, pos, window)
        k_pos, valid, bias = mask
        y = attn_mod.multihead_attention(
            q, ck, cv, q_pos, k_pos, causal=True, window=window,
            cap=cfg.attn_softcap, k_valid=valid, bias=bias)
        x = x + y.reshape(x.shape[0], 1, -1) @ p["attn"]["wo"]
    else:
        key, _, apply = _MIXERS[spec.mixer]
        y, st_new = apply(p[key], cfg, h, state=entry, return_state=True)
        for name, t in st_new.items():
            entry[name].copy_(t)
        x = x + y
    h = rmsnorm(p["norm2"], x, cfg.norm_eps)
    if spec.moe:
        return x + moe_mod.apply_moe(p["moe"], cfg, spec.ffn, h)[0]
    if spec.ffn == FFN.RWKV_CHANNEL:
        shifted = entry["cm_shift"][:, None, :].to(h.dtype)
        y = apply_ffn(p["ffn"], cfg, spec.ffn, h, shifted=shifted)
        entry["cm_shift"].copy_(h[:, -1, :])
        return x + y
    return x + apply_ffn(p["ffn"], cfg, spec.ffn, h)


def decode_step(params, cfg: ModelConfig, tokens, cache, *,
                long_mode: bool = False):
    """tokens: [B, 1].  Returns (logits [B, V], cache).

    ``cache["pos"]`` is an int (every row at the same position) or a [B]
    tensor of per-row positions — the batched path the genserve wave
    decode uses.  The cache leaves are updated in place; the returned
    cache holds the same leaves with ``pos + 1``."""
    check_supported(cfg)
    pos = cache["pos"]
    x = embed_tokens(params["embed"], cfg, tokens)
    per_slot = torch.is_tensor(pos) and pos.ndim > 0
    q_pos = (pos[:, None] if per_slot
             else torch.full((1,), int(pos), dtype=torch.int64,
                             device=x.device))
    masks = {}                  # (cache_len, window) -> _decode_mask
    for r in range(cfg.n_pattern_repeats):
        bp = _tree_index(params["blocks"], r)
        for j, spec in enumerate(cfg.pattern):
            entry = _entry(cache["blocks"][f"layer{j}"], r)
            window = mask = None
            if spec.mixer == Mixer.ATTENTION:
                window = cache_mod.effective_window(cfg, spec, long_mode)
                key = (entry["k"].shape[1], window)
                if key not in masks:
                    masks[key] = _decode_mask(pos, q_pos, *key, x.shape[0])
                mask = masks[key]
            x = _layer_decode(bp[f"layer{j}"], cfg, spec, x, entry, pos,
                              q_pos, window, mask)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = unembed(params["embed"], cfg, x)[:, 0]
    return logits, {"blocks": cache["blocks"], "pos": pos + 1}
