"""Decode-time state: KV caches (full and ring-buffer windowed), RWKV6 and
Mamba recurrent state, in the contiguous and the paged layout.

Port of ``repro.models.cache``.  Every block-cache leaf carries the
repeats dim ``[R]`` first and the batch (decode *slot*) dim at axis 1:

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

Paged layout (``init_paged_cache`` and the ``paged_*`` functions):
attention k/v leaves become a page pool ``[R, n_pages + 2, page_size,
KV, hd]`` shared by all slots and addressed through a per-slot block
table ``[B, max_pages]`` (entry j maps positions ``[j*page_size,
(j+1)*page_size)``; the sentinel ``n_pages`` marks an unmapped entry).
The two pages past ``n_pages`` stand in for JAX's out-of-range modes:
the sentinel page reads zeros (``mode="fill"``) and the last takes the
writes that JAX drops (``mode="drop"``).  ``paged_view`` gives each
slot's pages as the contiguous ``[R, B, L, KV, hd]`` view the decode and
prefill-chunk steps consume; ``paged_update_decode`` /
``paged_update_chunk`` scatter the freshly written tokens back.
Recurrent state and ``cm_shift`` stay per slot.  Refcounts, copy-on-write
and prefix matching live on the host (``genserve.pagepool``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.models import mamba as mamba_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models.config import FFN, Mixer, ModelConfig
from repro_torch.tree import tree_map


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
    A dropped token's slot keeps its value (or takes the token that
    finally lands there), so every write is exact, no write order
    matters and nothing waits for the device."""
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
    if C == 1:
        # per-row single-token decode: every row writes exactly one slot;
        # a masked row writes back the value its slot already holds
        slot = (torch.remainder(pos, L) if window is not None
                else torch.clamp(pos, max=L - 1))
        kn = k_new[:, 0].to(cache_k.dtype)
        vn = v_new[:, 0].to(cache_v.dtype)
        if valid is not None:
            keep = valid[:, 0].to(torch.bool).view(B, 1, 1)
            kn = torch.where(keep, kn, cache_k[rows, slot])
            vn = torch.where(keep, vn, cache_v[rows, slot])
        cache_k[rows, slot] = kn
        cache_v[rows, slot] = vn
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
    # kept (row, slot) pairs are unique; the chunk token that finally
    # lands in each slot (or -1) is their max.  Every chunk token then
    # writes that final value (or the slot's old one) to its slot, so
    # duplicate targets carry identical payloads: no host sync, and no
    # write order matters
    tok = torch.arange(C, device=cache_k.device).expand(B, C)
    src = torch.full((B, L), -1, dtype=torch.int64, device=cache_k.device)
    src.scatter_reduce_(1, slot, torch.where(keep, tok, -1), "amax")
    w = src.gather(1, slot)
    take = (w >= 0)[..., None, None]
    r = rows[:, None].expand(B, C)
    wc = w.clamp(min=0)
    cache_k[r, slot] = torch.where(take, k_new[r, wc].to(cache_k.dtype),
                                   cache_k[r, slot])
    cache_v[r, slot] = torch.where(take, v_new[r, wc].to(cache_v.dtype),
                                   cache_v[r, slot])
    return cache_k, cache_v


def prefill_kv(cache_k, cache_v, k, v, window: Optional[int]):
    """Fill a cache from a one-shot prefill pass (k: [B, S, KV, hd]):
    a chunk write at position 0 — full caches keep the first L tokens,
    ring caches the last L, as writing the sequence token by token."""
    return write_kv(cache_k, cache_v, k, v, 0, window)


# ---------------------------------------------------------------------------
# Paged KV layout: page pools + per-slot block tables
# ---------------------------------------------------------------------------

# A pool leaf holds the allocator's ``n_pages`` pages and two scratch pages
# past them: page ``n_pages`` (the block tables' sentinel) always reads as
# zeros, page ``n_pages + 1`` takes every write that is dropped.  Torch
# indexing has no out-of-range "fill" or "drop" mode.
SCRATCH_PAGES = 2


def pool_pages(pool) -> int:
    """The allocator's page count of a pool leaf [R, NP + 2, ps, KV, hd]."""
    return pool.shape[1] - SCRATCH_PAGES


def supports_prefix_sharing(cfg: ModelConfig, *,
                            long_mode: bool = False) -> bool:
    """Whether prompt-prefix pages may be shared between slots: only when
    every layer is full-window attention.  A ring layer keeps wrapping new
    tokens onto old slots (a shared page would be clobbered), and
    recurrent layers fold the prefix into O(1) state that cannot be
    snapshotted at a prompt boundary.  The paged *layout* works for every
    config; only cross-slot reuse is gated on this."""
    return all(
        spec.mixer == Mixer.ATTENTION
        and effective_window(cfg, spec, long_mode) is None
        for spec in cfg.pattern)


def supports_speculative_target(cfg: ModelConfig, *,
                                long_mode: bool = False) -> bool:
    """Whether `cfg` can be a speculative-decoding target: the verify step
    commits only the accepted prefix (a validity-masked ``write_kv``), so
    every layer's state must be positional KV (ring windows included);
    recurrent mixers and the rwkv_channel ``cm_shift`` cannot roll back a
    rejected token."""
    return all(
        spec.mixer == Mixer.ATTENTION and spec.ffn != FFN.RWKV_CHANNEL
        for spec in cfg.pattern)


def supports_speculative_draft(cfg: ModelConfig, *,
                               long_mode: bool = False) -> bool:
    """Whether `cfg` can be a speculative-decoding draft: its cache takes
    writes before acceptance is known, which only a full (non-ring)
    attention cache masks out after a rollback of the position cursor."""
    return supports_speculative_target(cfg, long_mode=long_mode) and all(
        effective_window(cfg, spec, long_mode) is None
        for spec in cfg.pattern)


def max_pages_per_slot(cfg: ModelConfig, max_seq: int, page_size: int, *,
                       long_mode: bool = False) -> int:
    """Block-table width: pages needed by the largest attention cache."""
    mps = [-(-kv_cache_len(cfg, spec, max_seq, long_mode) // page_size)
           for spec in cfg.pattern if spec.mixer == Mixer.ATTENTION]
    return max(mps, default=0)


def identity_block_table(n_slots: int, max_pages: int) -> np.ndarray:
    """Block table mapping slot b's page j to pool page b*max_pages + j:
    over a pool of exactly ``n_slots * max_pages`` pages the paged layout
    is a reshape of the contiguous one (the no-sharing parity fallback)."""
    return np.arange(n_slots * max_pages, dtype=np.int32).reshape(
        n_slots, max_pages)


def init_paged_cache(cfg: ModelConfig, n_slots: int, max_seq: int, *,
                     page_size: int, n_pages: int = 0,
                     long_mode: bool = False, dtype=torch.bfloat16,
                     device="cpu"):
    """Paged cache: as ``init_cache`` except that attention k/v leaves are
    page pools ``[R, n_pages + 2, page_size, KV, hd]`` shared by all
    slots (the two scratch pages of ``SCRATCH_PAGES``); recurrent state
    and cm_shift stay per slot ``[R, n_slots, ...]``.  ``n_pages=0``
    sizes the pool for the identity block table."""
    if n_pages <= 0:
        n_pages = n_slots * max_pages_per_slot(
            cfg, max_seq, page_size, long_mode=long_mode)
    cache = init_cache(cfg, n_slots, 1, long_mode=long_mode, dtype=dtype,
                       device=device)
    R, hd = cfg.n_pattern_repeats, cfg.resolved_head_dim
    shape = (R, n_pages + SCRATCH_PAGES, page_size, cfg.n_kv_heads, hd)
    for j, spec in enumerate(cfg.pattern):
        if spec.mixer == Mixer.ATTENTION:
            layer = cache["blocks"][f"layer{j}"]
            layer["k"] = torch.zeros(shape, dtype=dtype, device=device)
            layer["v"] = torch.zeros(shape, dtype=dtype, device=device)
    return cache


def paged_view(cfg: ModelConfig, blocks, btab, max_seq: int, *,
               page_size: int, long_mode: bool = False,
               identity: bool = False):
    """Each slot's pages as the contiguous blocks view (attention leaves
    ``[R, B, L, KV, hd]``) the decode / prefill-chunk steps consume;
    ``btab`` is ``[B, max_pages]`` and unmapped entries (the sentinel
    ``n_pages``) read zeros.  Per-slot leaves are the pool's own tensors.

    ``identity=True`` (a pool of exactly ``B * MP`` pages addressed by
    ``identity_block_table`` forever) returns a view of the pool: the
    steps then write the pool in place.  Otherwise the pages are gathered
    into a new tensor, which ``paged_update_decode`` /
    ``paged_update_chunk`` scatter back."""
    out = {}
    B, MP = btab.shape
    for j, spec in enumerate(cfg.pattern):
        name = f"layer{j}"
        layer = blocks[name]
        if spec.mixer != Mixer.ATTENTION:
            out[name] = layer
            continue
        L = kv_cache_len(cfg, spec, max_seq, long_mode)
        mp = -(-L // page_size)

        def g(pool):
            R, tail = pool.shape[0], pool.shape[3:]
            if identity:
                if pool_pages(pool) != B * MP:
                    raise ValueError("identity view needs a pool of exactly "
                                     "B*MP pages")
                return pool[:, :B * MP].view(R, B, MP * page_size,
                                             *tail)[:, :, :L]
            t = pool[:, btab[:, :mp].long()]
            return t.view(R, B, mp * page_size, *tail)[:, :, :L].contiguous()

        new = dict(layer)
        new["k"] = g(layer["k"])
        new["v"] = g(layer["v"])
        out[name] = new
    return out


def _merge_per_slot(layer, new, mask) -> None:
    """Emit-masked per-slot merge (in place) of a layer's non-pool leaves
    that the step wrote into other tensors."""
    for kk, leaf in layer.items():
        if kk in ("k", "v") or new[kk] is leaf:
            continue
        m = mask.view((1, -1) + (1,) * (leaf.ndim - 2))
        leaf.copy_(torch.where(m, new[kk].to(leaf.dtype), leaf))


def _scatter_tokens(pool, view, page, off, slot) -> None:
    """pool[:, page, off] = view[:, row, slot] for [B] or [B, C] indices
    (dropped entries carry the sink page)."""
    rows = torch.arange(view.shape[1], device=view.device)
    if slot.ndim == 2:
        rows = rows[:, None].expand_as(slot)
    pool[:, page, off] = view[:, rows, slot].to(pool.dtype)


def _live_page(btab, slot, page_size: int, live, n_pool: int):
    """Pool page of each (row, slot); dropped (not live, or unmapped)
    entries go to the sink page."""
    rows = torch.arange(btab.shape[0], device=btab.device)
    if slot.ndim == 2:
        rows = rows[:, None].expand_as(slot)
    page = btab[rows, slot // page_size].to(torch.int64)
    return torch.where(live & (page < n_pool), page, n_pool + 1)


def paged_update_decode(cfg: ModelConfig, blocks, new_blocks, btab, pos,
                        emit, max_seq: int, *, page_size: int,
                        long_mode: bool = False):
    """Scatter (in place) a decode step's per-row token k/v from the view
    ``new_blocks`` (after ``decode_step`` ran on it) back into the pools
    of ``blocks``; returns ``blocks``.  ``pos`` [B] is the pre-increment
    position the token was written at (ring slot pos % L, full-cache slot
    min(pos, L-1), as ``write_kv``).  Rows where ``emit`` is False write
    nothing, so a retired slot's stale block-table row never corrupts a
    reused page."""
    p = torch.as_tensor(pos, device=btab.device).to(torch.int64)
    emit = emit.to(torch.bool)
    for j, spec in enumerate(cfg.pattern):
        name = f"layer{j}"
        layer, new = blocks[name], new_blocks[name]
        if spec.mixer != Mixer.ATTENTION:
            _merge_per_slot(layer, new, emit)
            continue
        L = kv_cache_len(cfg, spec, max_seq, long_mode)
        w = effective_window(cfg, spec, long_mode)
        slot = torch.remainder(p, L) if w is not None else p.clamp(max=L - 1)
        page = _live_page(btab, slot, page_size, emit,
                          pool_pages(layer["k"]))
        for kk in ("k", "v"):
            _scatter_tokens(layer[kk], new[kk], page, slot % page_size, slot)
        _merge_per_slot(layer, new, emit)
    return blocks


def paged_update_chunk(cfg: ModelConfig, blocks, new_blocks, btab, pcur,
                       n_valid, chunk: int, max_seq: int, *,
                       page_size: int, long_mode: bool = False):
    """Scatter (in place) a chunk's token k/v back into the pools: chunk
    token c of row b sits at position ``pcur[b] + c`` and is live when
    ``c < n_valid[b]``.  Values are read from the view at the slot each
    position maps to, so ring-wrap duplicates and full-cache clamps all
    carry the *final* value ``write_kv`` left there: duplicate targets
    hold identical payloads.  Returns ``blocks``."""
    dev = btab.device
    positions = torch.as_tensor(pcur, device=dev).to(torch.int64)[:, None] \
        + torch.arange(chunk, device=dev)
    n_valid = torch.as_tensor(n_valid, device=dev)
    valid = torch.arange(chunk, device=dev)[None, :] < n_valid[:, None]
    for j, spec in enumerate(cfg.pattern):
        name = f"layer{j}"
        layer, new = blocks[name], new_blocks[name]
        if spec.mixer != Mixer.ATTENTION:
            _merge_per_slot(layer, new, n_valid > 0)
            continue
        L = kv_cache_len(cfg, spec, max_seq, long_mode)
        w = effective_window(cfg, spec, long_mode)
        slot = (torch.remainder(positions, L) if w is not None
                else positions.clamp(max=L - 1))
        page = _live_page(btab, slot, page_size, valid,
                          pool_pages(layer["k"]))
        for kk in ("k", "v"):
            _scatter_tokens(layer[kk], new[kk], page, slot % page_size, slot)
        _merge_per_slot(layer, new, n_valid > 0)
    return blocks


def copy_pages(cfg: ModelConfig, blocks, src, dst):
    """``pool[dst[i]] = pool[src[i]]`` (in place) in every attention
    layer's k and v pool — the copy-on-write step of prefix-cache
    admission.  A sentinel source writes zeros, a sentinel destination is
    dropped.  Returns ``blocks``."""
    for j, spec in enumerate(cfg.pattern):
        if spec.mixer != Mixer.ATTENTION:
            continue
        layer = blocks[f"layer{j}"]
        for kk in ("k", "v"):
            pool = layer[kk]
            n = pool_pages(pool)
            s = torch.as_tensor(src, device=pool.device).to(torch.int64)
            d = torch.as_tensor(dst, device=pool.device).to(torch.int64)
            s = s.clamp(max=n)                 # sentinel: the zero page
            d = torch.where(d >= n, n + 1, d)  # sentinel: the sink page
            pool[:, d] = pool[:, s]
    return blocks


def zero_paged_slots(cfg: ModelConfig, blocks, slot_mask):
    """Paged ``zero_slots``: zero (in place) only the *per-slot* leaves
    (recurrent state, cm_shift) of slots where ``slot_mask`` is True.
    Pool pages are left alone: stale contents are masked by position
    validity, and a recycled slot's block-table row may still point at
    pages a live sharer reads.  Returns ``blocks``."""
    idx = torch.nonzero(torch.as_tensor(slot_mask), as_tuple=True)[0]
    for j, spec in enumerate(cfg.pattern):
        for kk, leaf in blocks[f"layer{j}"].items():
            if not (spec.mixer == Mixer.ATTENTION and kk in ("k", "v")):
                leaf[:, idx.to(leaf.device)] = 0
    return blocks
