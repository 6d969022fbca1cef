"""Decode-time state: KV caches (full and ring-buffer windowed), RWKV6 and
Mamba recurrent state, contiguous layout.

Port of the contiguous part of ``repro.models.cache`` (lines 46-239).
Every block-cache leaf carries the repeats dim ``[R]`` first and the
batch (decode *slot*) dim at axis 1:

  mixer / FFN     leaf        shape               dtype
  -------------   ---------   -----------------   ------------
  attention       k, v        [R, B, L, KV, hd]   cache dtype
  rwkv6           tm_shift    [R, B, d]           fp32
  rwkv6           wkv         [R, B, H, N, N]     fp32
  mamba           conv        [R, B, dc-1, di]    fp32
  mamba           ssm         [R, B, di, ds]      fp32
  rwkv_channel    cm_shift    [R, B, d]           cache dtype

``gather_slots`` / ``scatter_slots`` / ``zero_slots`` work on any such
tree: they move whole per-slot rows in and out, which is how the
continuous-batching engine recycles decode slots.

Unlike the JAX functions, which return new arrays, the writers here
update the cache **in place** (and return it): ``write_kv``,
``prefill_kv``, ``scatter_slots`` and ``zero_slots`` would otherwise copy
the whole cache on every decode step.  Callers that need the old
contents keep a clone.

Positions are python ints (one shared position) or int tensors ([B]
per-row positions).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import mamba as mamba_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models.config import FFN, Mixer, ModelConfig


def effective_window(cfg: ModelConfig, spec, long_mode: bool) -> Optional[int]:
    """Window for an attention layer; long mode caps global layers."""
    if spec.window is not None:
        return spec.window
    if long_mode and cfg.long_mode_window is not None:
        return cfg.long_mode_window
    return None


def kv_cache_len(cfg: ModelConfig, spec, max_seq: int,
                 long_mode: bool) -> int:
    w = effective_window(cfg, spec, long_mode)
    return min(w, max_seq) if w is not None else max_seq


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, *,
               long_mode: bool = False, dtype=torch.bfloat16, device="cpu"):
    """Cache: {"blocks": {"layer{j}": leaves [R, B, ...]}, "pos": 0}
    (the leaves of the module docstring's table)."""
    R = cfg.n_pattern_repeats
    hd = cfg.resolved_head_dim
    zeros = lambda shape, dt: torch.zeros(shape, dtype=dt, device=device)
    blocks = {}
    for j, spec in enumerate(cfg.pattern):
        if spec.mixer == Mixer.ATTENTION:
            L = kv_cache_len(cfg, spec, max_seq, long_mode)
            shape = (R, batch, L, cfg.n_kv_heads, hd)
            layer = {"k": zeros(shape, dtype), "v": zeros(shape, dtype)}
        else:
            init = (rwkv_mod.init_rwkv_state if spec.mixer == Mixer.RWKV6
                    else mamba_mod.init_mamba_state)
            st = init(cfg, R * batch, device=device)
            layer = {n: t.reshape((R, batch) + t.shape[1:])
                     for n, t in st.items()}
        if spec.ffn == FFN.RWKV_CHANNEL:
            layer["cm_shift"] = zeros((R, batch, cfg.d_model), dtype)
        blocks[f"layer{j}"] = layer
    return {"blocks": blocks, "pos": 0}


def tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def gather_slots(blocks, idx):
    """Per-slot cache rows: leaves [R, B, ...] -> [R, len(idx), ...]."""
    return tree_map(lambda l: l.index_select(1, idx), blocks)


def scatter_slots(dst_blocks, src_blocks, slot_mask):
    """Overwrite (in place) the slot rows of ``dst_blocks`` with
    ``src_blocks`` where ``slot_mask`` [B] is True — the whole-row
    replacement at prefill injection, so no stale KV from a previous
    occupant leaks into a recycled slot."""
    idx = torch.nonzero(slot_mask, as_tuple=True)[0]

    def put(dst, src):
        dst[:, idx] = src[:, idx].to(dst.dtype)
        return dst

    return tree_map(put, dst_blocks, src_blocks)


def zero_slots(blocks, slot_mask):
    """Zero (in place) the cache rows of slots where ``slot_mask`` [B]."""
    idx = torch.nonzero(slot_mask, as_tuple=True)[0]

    def zero(l):
        l[:, idx] = 0
        return l

    return tree_map(zero, blocks)


def ring_slot_positions(cache_len: int, window: Optional[int], pos,
                        device=None):
    """Absolute position stored in each cache slot at decode step `pos`.

    Full cache (window None): slot i holds position i (valid if i <= pos).
    Ring cache: slot i holds the largest p' <= pos with p' % W == i.
    `pos` is an int (returns [L]) or a [B] tensor (returns [B, L])."""
    if torch.is_tensor(pos):
        device = pos.device
    idx = torch.arange(cache_len, device=device)
    p = torch.as_tensor(pos, device=device).to(torch.int64)[..., None]
    if window is None:
        valid = idx <= p
        k_pos = idx.expand(valid.shape)
    else:
        k_pos = p - torch.remainder(p - idx, cache_len)
        valid = k_pos >= 0
    return k_pos, valid


def write_kv(cache_k, cache_v, k_new, v_new, pos, window: Optional[int],
             valid=None):
    """Write (in place) a chunk of C consecutive tokens' k/v starting at
    `pos`; returns (cache_k, cache_v).

    cache_k: [B, L, KV, hd]; k_new: [B, C, KV, hd].  `pos` is an int (all
    rows start at the same position) or a [B] tensor of per-row starts
    (token j of row b lands at pos[b] + j).  `valid` [B, C] optionally
    masks chunk tokens: invalid tokens leave the cache untouched.

    Ring caches (window not None) wrap at slot p % L; when a chunk spans
    more than one lap only the latest token per slot survives.  Full
    caches clamp out-of-range positions to the last slot, keeping the
    first such token (the keep-first-L truncation of a one-shot prefill).
    Dropped tokens are never written: the scatter goes through the kept
    (row, slot) pairs only, which are unique, so no out-of-range slot can
    wrap around and no write order matters."""
    B, C = k_new.shape[:2]
    L = cache_k.shape[1]
    if not torch.is_tensor(pos) or pos.ndim == 0:
        start = int(pos)
        if valid is None:
            if window is None and start + C <= L:
                slot0 = start
            elif window is not None and start % L + C <= L:
                slot0 = start % L
            elif C == 1:          # single-token decode past the end: clamp
                slot0 = L - 1
            else:
                slot0 = None
            if slot0 is not None:
                cache_k[:, slot0:slot0 + C] = k_new.to(cache_k.dtype)
                cache_v[:, slot0:slot0 + C] = v_new.to(cache_v.dtype)
                return cache_k, cache_v
        pos = torch.full((B,), start, dtype=torch.int64,
                         device=cache_k.device)
    pos = pos.to(torch.int64)
    rows = torch.arange(B, device=cache_k.device)
    if C == 1 and valid is None:
        # per-row single-token decode: every row writes exactly one slot
        slot = (torch.remainder(pos, L) if window is not None
                else torch.clamp(pos, max=L - 1))
        cache_k[rows, slot] = k_new[:, 0].to(cache_k.dtype)
        cache_v[rows, slot] = v_new[:, 0].to(cache_v.dtype)
        return cache_k, cache_v
    positions = pos[:, None] + torch.arange(C, device=cache_k.device)
    keep = (torch.ones((B, C), dtype=torch.bool, device=cache_k.device)
            if valid is None else valid.to(torch.bool))
    if window is not None:
        last = torch.where(keep, positions,
                           torch.full_like(positions, -1)).max(
            dim=1, keepdim=True).values
        keep = keep & (positions + L > last)
        slot = torch.remainder(positions, L)
    else:
        over = keep & (positions >= L - 1)
        first_over = torch.where(over, positions,
                                 torch.full_like(positions, 2 ** 30)).min(
            dim=1, keepdim=True).values
        keep = keep & ((positions < L - 1) | (positions == first_over))
        slot = torch.clamp(positions, max=L - 1)
    r = rows[:, None].expand(B, C)[keep]
    s = slot[keep]
    cache_k[r, s] = k_new[keep].to(cache_k.dtype)
    cache_v[r, s] = v_new[keep].to(cache_v.dtype)
    return cache_k, cache_v


def prefill_kv(cache_k, cache_v, k, v, window: Optional[int]):
    """Fill a cache from a one-shot prefill pass (k: [B, S, KV, hd]):
    a chunk write at position 0 — full caches keep the first L tokens,
    ring caches the last L, as writing the sequence token by token."""
    return write_kv(cache_k, cache_v, k, v, 0, window)
