"""Wave-stepped continuous-batching decode loop with chunked prefill, the
paged KV cache with radix prefix reuse, and speculative decoding.

Port of ``repro.genserve.decoder``.  The device side is a small set of
programs, plain functions that update a state dict of device tensors in
place:

  program   inputs (beyond params/state)      what it does
  -------   -------------------------------   ---------------------------
  admit     prompts [n,P], slots [n],         one-shot path
            rows [n], limits [n]              (``prefill_chunk == 0``):
                                              prefill the n admitted
                                              prompts (the whole wave on
                                              a mesh or where MoE groups
                                              span rows), sample each
                                              one's first token, write
                                              the fresh cache rows into
                                              their slots only.
  install   prompts [W,P], admit_mask [W],    chunked path: stage request
            rows [W], limits [W], plens [W]   metadata and prompt rows,
            (+ pstarts [W], btab [W,MP]       zero the admitted slots'
            when paged)                       cache rows (paged: only the
                                              per-slot leaves, and map
                                              their block-table rows; the
                                              prefill cursor starts after
                                              the cached prefix).
  mixed     k sub-rounds (k <=                each sub-round ONE batched
            ``decode_chunk``)                 decode step over decoding
                                              slots plus ONE
                                              ``prefill_chunk_step`` (up
                                              to ``prefill_chunk`` prompt
                                              tokens) over admitting
                                              slots; a slot whose final
                                              chunk lands samples its
                                              first token and decodes
                                              from the next sub-round.
  chunk     decode_chunk                      ``decode_chunk`` batched
                                              wave decode steps (no slot
                                              mid-prefill): decode,
                                              sample, record, retire on
                                              EOS / budget.
  copy      src [W], dst [W]                  paged + prefix cache: the
                                              copy-on-write page copies
                                              the host schedules when an
                                              admission diverges mid-page
                                              from a cached prefix.

With ``spec_k > 0`` the decode half of every sub-round (``chunk`` and
``mixed``) is the draft/verify sub-round: k+1 draft ``decode_step``s
propose d_1..d_k per live slot (the last step's proposal is dropped: it
runs so that d_k's draft k/v lands for the full-accept-plus-bonus case;
the draft keeps its own full-window contiguous cache ``st["dcache"]`` at
the target's position), then ONE target ``verify_chunk_step`` over the
[W, k+1] candidates scores them without writing the cache.  Greedy
accepts the longest prefix matching the target argmax; sampled mode
rejection-resamples (``sampling.speculative_accept``).  The accepted
prefix plus the bonus token lands through ``cache.write_kv(valid=)`` at
per-row cursors (``paged_update_chunk`` into the pool when the view is a
gathered copy).  Under chunked admission the draft ingests the full
prompt at its own cursor (``st["dcur"]``) while a prefix-cache target
skips ahead; ``st["pdelay"]`` idles the target's prefill so that both
cursors land on the same sub-round.

Paged KV (``page_size > 0``, chunked admission only): attention k/v live
in per-layer page pools addressed through ``st["btab"]``
(``models.cache.init_paged_cache``).  Without prefix sharing the block
table is the identity forever and ``paged_view`` is a view of the pool,
so the steps write the pool in place; otherwise the view is a gathered
copy and the freshly written tokens are scattered back
(``paged_update_decode`` / ``paged_update_chunk``, emit-masked).  With
``prefix_cache=True`` the host runs a radix prefix tree and refcounted
page allocator (``genserve.pagepool``): an admitted prompt maps its
whole cached pages copy-free, copies at most one partially matching page
(COW), and prefills only the uncached suffix (the hit is capped at
plen-1 so that the landing chunk always runs); landed prompts insert
their complete pages, retired slots decref.

What differs from the JAX engine, and why:
  * The steps write the cache in place (the JAX programs return new
    arrays and merge rows back).  Wherever the reference keeps only the
    emitting rows (``scatter_slots(..., emit)``), the port passes
    ``decode_step(write_mask=emit)``; ``prefill_chunk_step`` leaves rows
    with ``n_valid == 0`` untouched and ``verify_chunk_step`` writes
    nothing.
  * One-shot admission prefills only the admitted rows, and samples
    their first tokens from those rows alone; the JAX program prefills
    and samples the whole wave.
  * Randomness: one ``torch.Generator`` in event order (greedy decoding
    is token-exact against the JAX engine; sampled modes are held by
    distribution).  A mixed sub-round samples first tokens only when the
    host's prefill mirror says a slot lands there, and skips its decode
    half while no slot can emit; the JAX programs run both masked.
  * ``decode_path="vmapped"`` is a per-slot loop of B=1 ``decode_step``
    calls over slot views (the torch counterpart of the W-way vmap); on
    a mesh whose ``data`` axis splits the slots, step i decodes every
    shard's i-th slot at once, one row per rank.
  * On a mesh (``serve(mesh=)``) the programs run on DTensors: the
    caches are written in place shard by shard (``models.cache``), and
    every sampling point gathers the logits first.

The host loop owns membership: it reads back ``occupied`` after every
round, retires finished requests through ``scheduler.SlotTable``,
back-fills freed slots from the queue (FIFO, or ``admission="sjf"``:
shortest known budget first, with optional aging), mirrors each slot's
prefill progress (every mixed sub-round advances every prefilling slot
by one chunk) so that it knows landings without a device sync, and
applies injected slot failures (requeue from scratch) and cancels.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.genserve.pagepool import PagePool, RadixCache
from repro_torch.genserve.scheduler import (FREE, Request, RequestQueue,
                                            SlotTable)
from repro_torch.models import cache as cache_mod
from repro_torch.models import moe, sampling
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.parallel import sharding as sh
from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class GenServeConfig:
    """Engine knobs (the JAX package's fields)."""

    wave: int                        # max concurrently decoding slots (W)
    max_new_tokens: int              # global budget N (output buffer width)
    decode_chunk: int = 1            # decode steps per host round
    temperature: float = 1.0
    eos_token: Optional[int] = None
    greedy: bool = False
    decode_path: str = "batched"     # "batched" | "vmapped" wave decode
    admission: str = "fifo"          # "fifo" | "sjf" queue policy
    prefill_chunk: int = 0           # tokens per mixed-round prefill chunk
    #                                  (0 = one-shot whole-prompt admit)
    measure_ttft: bool = False       # stamp per-request time-to-first-token
    #                                  (on a CUDA device one-shot admission
    #                                  records an event per admit batch,
    #                                  read after the loop)
    page_size: int = 0               # paged KV: tokens per pool page
    #                                  (0 = contiguous per-slot cache)
    prefix_cache: bool = False       # radix prefix reuse across slots
    pool_pages: int = 0              # page-pool size override (0 = W*MP,
    #                                  2*W*MP with the prefix cache)
    sjf_aging: int = 0               # sjf anti-starvation (0 = pure sjf)
    spec_k: int = 0                  # speculative decoding: draft tokens
    #                                  proposed per wave sub-round (0 = off)

    def validate(self) -> None:
        def need(ok: bool, msg: str) -> None:
            if not ok:
                raise ValueError(f"bad engine config {self}: {msg}")
        need(self.wave >= 1 and self.max_new_tokens >= 1
             and self.decode_chunk >= 1, "wave, budget and decode_chunk >= 1")
        need(self.decode_path in ("batched", "vmapped"), "decode_path")
        need(self.admission in ("fifo", "sjf"), "admission")
        need(self.prefill_chunk >= 0 and self.page_size >= 0
             and self.pool_pages >= 0 and self.sjf_aging >= 0
             and self.spec_k >= 0, "negative knob")
        if self.spec_k > 0:
            need(self.decode_path == "batched",
                 "spec_k > 0 requires the batched decode path")
        if self.page_size > 0:
            need(self.prefill_chunk > 0, "page_size > 0 requires chunked "
                 "admission (prefill_chunk > 0)")
        if self.prefix_cache:
            need(self.page_size > 0,
                 "prefix_cache requires a paged cache (page_size > 0)")


# ---------------------------------------------------------------------------
# Engine programs
# ---------------------------------------------------------------------------

def _admit_whole_wave(cfgs, prompt_len: int, mesh) -> bool:
    """Whether a one-shot admit prefills the whole wave, not only its
    admitted rows: on a mesh (the rows split evenly over the ranks only
    at the wave's width), and where an MoE layer's routing groups span
    rows (a row's output then depends on its neighbours).  Every other
    row's prefill is independent of the others."""
    return mesh is not None or any(
        c is not None and c.has_moe
        and not moe.groups_within_rows(prompt_len) for c in cfgs)


class _Programs:
    """The engine programs for one (cfg, gcfg, P, n_reqs, draft cfg)."""

    def __init__(self, cfg: ModelConfig, gcfg: GenServeConfig,
                 prompt_len: int, n_reqs: int,
                 draft_cfg: Optional[ModelConfig] = None, mesh=None):
        self.cfg, self.gcfg, self.dcfg = cfg, gcfg, draft_cfg
        self.P, self.N = prompt_len, gcfg.max_new_tokens
        self.max_seq = prompt_len + gcfg.max_new_tokens
        self.dummy_row = n_reqs         # output buffers carry a scratch row
        self.ps = gcfg.page_size
        self.paged = self.ps > 0
        self.k = gcfg.spec_k
        self.spec = self.k > 0
        self.C = max(gcfg.prefill_chunk, 1)
        # without prefix sharing the block table is the identity forever,
        # so the pool view is a view: the steps write the pool in place
        # (on a mesh the view is each rank's own slots' copy)
        self.identity = (self.paged and not gcfg.prefix_cache
                         and gcfg.pool_pages == 0 and mesh is None)
        self.whole_wave = _admit_whole_wave((cfg, draft_cfg), prompt_len,
                                            mesh)

    # -- shared pieces -----------------------------------------------------
    def view_of(self, st):
        """The contiguous per-slot blocks the model steps consume."""
        if not self.paged:
            return st["cache"]
        return cache_mod.paged_view(self.cfg, st["cache"], st["btab"],
                                    self.max_seq, page_size=self.ps,
                                    identity=self.identity)

    @property
    def gathered(self) -> bool:
        """The view is a copy whose writes must be scattered back."""
        return self.paged and not self.identity

    # logits of a sharded step are gathered first: every rank draws and
    # decides on the full batch, so the slot table stays the same
    # (plain, replicated) on every rank
    def sample(self, gen, logits):
        return sampling.sample_tokens(gen, sh.full(logits),
                                      temperature=self.gcfg.temperature,
                                      greedy=self.gcfg.greedy)

    def sample_lp(self, gen, logits):
        return sampling.sample_with_logprobs(
            gen, sh.full(logits), temperature=self.gcfg.temperature,
            greedy=self.gcfg.greedy)

    def wave_decode(self, params, tok, pos, blocks, write_mask):
        """One decode step of the wave: [W] logits rows."""
        if self.gcfg.decode_path == "batched":
            logits, _ = T.decode_step(params, self.cfg, tok[:, None],
                                      {"blocks": blocks, "pos": pos},
                                      write_mask=write_mask)
            return logits
        leaf = tree_leaves(blocks)[0]
        n = sh.row_shards(leaf, 1) if sh.is_dtensor(leaf) else 1
        if n > 1:
            return self._local_slot_loop(params, tok, pos, blocks,
                                         write_mask, n)
        rows = []
        for w in range(tok.shape[0]):
            sl = slice(w, w + 1)
            logits, _ = T.decode_step(
                params, self.cfg, tok[sl, None],
                {"blocks": tree_map(lambda l: l[:, sl], blocks),
                 "pos": pos[sl]},
                write_mask=None if write_mask is None else write_mask[sl])
            rows.append(sh.full(logits))
        return torch.cat(rows)

    def _local_slot_loop(self, params, tok, pos, blocks, write_mask,
                         n: int):
        """The per-slot loop on a cache whose slots lie over ``n`` data
        shards: step i decodes every shard's i-th slot at once (one row
        per rank, a view of its shard), so each slot still decodes
        alone."""
        W = tok.shape[0]
        per = W // n
        order, out = [], []
        for i in range(per):
            rows = torch.arange(n, device=tok.device) * per + i
            logits, _ = T.decode_step(
                params, self.cfg, tok[rows, None],
                {"blocks": tree_map(lambda l: sh.local_rows(l, 1, i),
                                    blocks),
                 "pos": pos[rows]},
                write_mask=None if write_mask is None else write_mask[rows])
            order.append(rows)
            out.append(sh.full(logits))
        logits = torch.cat(out)
        res = torch.empty_like(logits)
        res[torch.cat(order)] = logits
        return res

    # -- one-shot admission ------------------------------------------------
    def admit(self, params, dparams, st, prompts, slots, rows, limits, gen):
        """Prefill the admitted prompts [n, P] into ``slots`` ([n] int64,
        on the host); install them and sample each one's token 0.  Returns
        the rows the prefill ran: n, or W where ``whole_wave``."""
        eos, W = self.gcfg.eos_token, self.gcfg.wave
        idx = slots.to(prompts.device)
        if self.whole_wave:
            # slots that admit nothing carry a copy of the first admitted
            # prompt; only the admitted rows are kept
            run = prompts[:1].repeat(W, 1)
            run[idx] = prompts
            mask = torch.zeros((W,), dtype=torch.bool)
            mask[slots] = True
            put = lambda dst, src: cache_mod.scatter_slots(dst, src, mask)
        else:
            run = prompts
            put = lambda dst, src: cache_mod.put_slot_rows(dst, src, idx)
        out = T.forward(params, self.cfg, {"tokens": run},
                        return_cache=True, max_cache_len=self.max_seq)
        put(st["cache"], out["cache"]["blocks"])
        with obs_trace.span("gen.sample"):
            tok0, lp0 = self.sample_lp(gen, out["logits"][:, -1])
            if self.whole_wave:
                tok0, lp0 = tok0[idx], lp0[idx]
            alive0 = sampling.initial_alive(prompts, eos)
            finished0 = limits <= 1
            if eos is not None:
                finished0 |= tok0 == eos
            st["gen"][rows, 0] = tok0
            st["lp"][rows, 0] = lp0
            st["mask"][rows, 0] = alive0.float()
            st["pos"] = st["pos"].index_fill(0, idx, self.P)
            st["tok"] = st["tok"].index_copy(0, idx, tok0)
            st["ngen"] = st["ngen"].index_fill(0, idx, 1)
            st["req"] = st["req"].index_copy(0, idx, rows)
            st["limit"] = st["limit"].index_copy(0, idx, limits)
            st["occupied"] = st["occupied"].index_copy(
                0, idx, alive0 & ~finished0)
        if self.spec:
            # prime the draft's own cache on the same rows: its cursor
            # stays the target's
            dout = T.forward(dparams, self.dcfg, {"tokens": run},
                             return_cache=True, max_cache_len=self.max_seq)
            put(st["dcache"], dout["cache"]["blocks"])
        return run.shape[0]

    # -- decode sub-rounds -------------------------------------------------
    def decode_substep(self, params, st, gen, protect: bool):
        """One batched wave decode step.  With ``protect`` (slots may be
        mid-prefill: the mixed program) only emitting rows write the
        cache; the pure decode path lets free rows write their own rows,
        which re-admission replaces or zeroes.  Paged caches always write
        emit-masked, so a retired slot never touches a reused page."""
        eos = self.gcfg.eos_token
        emit = st["occupied"]
        pos = st["pos"]
        view = self.view_of(st)
        logits = self.wave_decode(params, st["tok"], pos, view,
                                  emit if protect or self.paged else None)
        if self.gathered:
            cache_mod.paged_update_decode(
                self.cfg, st["cache"], view, st["btab"], pos, emit,
                self.max_seq, page_size=self.ps)
        with obs_trace.span("gen.sample"):
            nxt, lp = self.sample_lp(gen, logits)
            buf_rows = torch.where(emit, st["req"], self.dummy_row)
            cols = torch.where(emit, st["ngen"], 0)
            alive_after = sampling.next_alive(emit, nxt, eos)
            finished = emit & (~alive_after
                               | (st["ngen"] + 1 >= st["limit"]))
            st["gen"][buf_rows, cols] = nxt
            st["lp"][buf_rows, cols] = lp
            st["mask"][buf_rows, cols] = emit.float()
            st["pos"] = torch.where(emit, pos + 1, pos)
            st["tok"] = torch.where(emit, nxt, st["tok"])
            st["ngen"] = torch.where(emit, st["ngen"] + 1, st["ngen"])
            st["occupied"] = emit & ~finished
            return (emit.sum(),)

    def _commit_accepted(self, view, deltas, pos, n_valid) -> None:
        """Write the accepted prefix of a verify chunk into the (view of
        the) cache: validity-masked ``write_kv`` at per-row cursors; rows
        with ``n_valid == 0`` take no writes."""
        cfg = self.cfg
        valid = torch.arange(self.k + 1, device=pos.device)[None, :] \
            < n_valid[:, None]
        for j, spec_l in enumerate(cfg.pattern):
            w = cache_mod.effective_window(cfg, spec_l, False)
            lk = f"layer{j}"
            for r in range(cfg.n_pattern_repeats):
                cache_mod.write_kv(view[lk]["k"][r], view[lk]["v"][r],
                                   deltas[lk]["k"][r], deltas[lk]["v"][r],
                                   pos, w, valid=valid)

    def spec_substep(self, params, dparams, st, gen, protect: bool):
        """The draft/verify sub-round: k+1 draft steps propose d_1..d_k per
        live slot, ONE target step over the [W, k+1] candidates verifies
        them, and up to k+1 tokens land at once.  The commit is
        emit-masked by construction, so ``protect`` is moot.  Returns
        (active, emitted tokens, proposed, accepted) counts."""
        eos, N, k = self.gcfg.eos_token, self.N, self.k
        k1 = k + 1
        emit = st["occupied"]
        pos = st["pos"]
        tok_c, dpos = st["tok"], pos
        drafts, dlogits = [], []
        for j in range(k1):
            logits, _ = T.decode_step(dparams, self.dcfg, tok_c[:, None],
                                      {"blocks": st["dcache"], "pos": dpos},
                                      write_mask=emit)
            if j == k:
                break       # this step only writes d_k's draft k/v
            logits = sh.full(logits)
            tok_c = self.sample(gen, logits)
            drafts.append(tok_c)
            dlogits.append(logits)
            dpos = dpos + 1
        drafts = torch.stack(drafts, dim=1)                  # [W, k]
        dlogits = torch.stack(dlogits, dim=1)                # [W, k, V]

        view = self.view_of(st)
        cand_in = torch.cat([st["tok"][:, None], drafts], dim=1)
        vlogits, deltas = T.verify_chunk_step(
            params, self.cfg, cand_in, {"blocks": view, "pos": pos})
        vlogits = sh.full(vlogits)
        a, cand = sampling.speculative_accept(
            gen, vlogits, drafts, dlogits, temperature=self.gcfg.temperature,
            greedy=self.gcfg.greedy)

        # emitted count e: accepted + bonus, cut at the remaining budget
        # and at the first emitted EOS (the EOS itself is valid)
        ar = torch.arange(k1, device=pos.device)[None, :]
        e = torch.minimum(a + 1, (st["limit"] - st["ngen"]).clamp(min=0))
        hit_eos = torch.zeros_like(emit)
        if eos is not None:
            first_eos = torch.where(cand == eos, ar, k1 + N).min(dim=1).values
            e = torch.minimum(e, first_eos + 1)
        e = torch.where(emit, e, 0)
        if eos is not None:
            hit_eos = first_eos < e
        finished = emit & (hit_eos | (st["ngen"] + e >= st["limit"]))

        val = (ar < e[:, None]) & emit[:, None]              # [W, k+1]
        buf_rows = torch.where(val, st["req"][:, None], self.dummy_row)
        cols = torch.where(val, st["ngen"][:, None] + ar, 0)
        lp_all = sampling.token_logprobs(vlogits, cand)
        st["gen"][buf_rows, cols] = torch.where(val, cand, 0)
        st["lp"][buf_rows, cols] = torch.where(val, lp_all, 0.0)
        st["mask"][buf_rows, cols] = val.float()

        self._commit_accepted(view, deltas, pos, e)
        if self.gathered:
            cache_mod.paged_update_chunk(
                self.cfg, st["cache"], view, st["btab"], pos, e, k1,
                self.max_seq, page_size=self.ps)
        new_tok = cand.gather(1, (e - 1).clamp(0, k)[:, None])[:, 0]
        st["tok"] = torch.where(emit, new_tok, st["tok"])
        st["pos"] = pos + e
        st["ngen"] = st["ngen"] + e
        st["occupied"] = emit & ~finished
        emit_n = emit.sum()
        return (emit_n, e.sum(), emit_n * k, torch.where(emit, a, 0).sum())

    def decode_half(self, params, dparams, st, gen, protect: bool):
        if self.spec:
            return self.spec_substep(params, dparams, st, gen, protect)
        return self.decode_substep(params, st, gen, protect)

    def chunk(self, params, dparams, st, steps: int, gen):
        """``steps`` wave decode sub-rounds; per-step count tuples."""
        return [self.decode_half(params, dparams, st, gen, protect=False)
                for _ in range(steps)]

    # -- chunked admission -------------------------------------------------
    def install(self, st, prompts, admit_mask, admit_cpu, rows, limits,
                plens, pstarts=None, btab_new=None):
        """Stage request metadata into the admitted slots and zero their
        cache rows — no model compute; ``mixed`` rounds ingest the prompt
        chunk by chunk.  Paged: map the admitted slots' block-table rows,
        start each cursor at ``pstarts`` and zero only the per-slot
        leaves (pool pages may be shared with live slots)."""
        m = admit_mask
        st["prompt"] = torch.where(m[:, None], prompts, st["prompt"])
        st["plen"] = torch.where(m, plens, st["plen"])
        st["prefilling"] = st["prefilling"] | m
        st["req"] = torch.where(m, rows, st["req"])
        st["limit"] = torch.where(m, limits, st["limit"])
        st["ngen"] = torch.where(m, 0, st["ngen"])
        st["occupied"] = st["occupied"] & ~m
        if self.paged:
            st["pcur"] = torch.where(m, pstarts, st["pcur"])
            st["btab"] = torch.where(m[:, None], btab_new, st["btab"])
            cache_mod.zero_paged_slots(self.cfg, st["cache"], admit_cpu)
        else:
            st["pcur"] = torch.where(m, 0, st["pcur"])
            cache_mod.zero_slots(st["cache"], admit_cpu)
        if self.spec:
            # the draft has no radix cache: it ingests the full prompt
            # from cursor 0; the target idles for the chunk-count
            # difference so that both land on the same sub-round
            C = self.C
            st["dcur"] = torch.where(m, 0, st["dcur"])
            cache_mod.zero_slots(st["dcache"], admit_cpu)
            ncd = (st["plen"] + C - 1) // C
            nct = (st["plen"] - st["pcur"] + C - 1) // C
            st["pdelay"] = torch.where(m, ncd - nct, st["pdelay"])

    def copy(self, st, src, dst) -> None:
        """COW page copies: pool[dst] = pool[src] in every attention
        layer; sentinel-padded entries are dropped."""
        cache_mod.copy_pages(self.cfg, st["cache"], src, dst)

    def prefill_substep(self, params, dparams, st, gen, landing: bool):
        """The prefill half of one mixed sub-round: one [W, C] prompt chunk
        over the admitting slots (masked).  ``landing`` (from the host's
        prefill mirror) says whether a slot's final chunk arrives here;
        then the landing slots sample their first token.  Speculative
        engines also advance the draft's own cursor and hold the target
        idle while ``pdelay > 0``."""
        eos, C, P = self.gcfg.eos_token, self.C, self.P
        pf, pcur, plen = st["prefilling"], st["pcur"], st["plen"]
        ar = torch.arange(C, device=pcur.device)
        idle = (st["pdelay"] > 0) if self.spec else torch.zeros_like(pf)
        n_valid = torch.where(pf & ~idle, (plen - pcur).clamp(0, C), 0)
        chunk_tok = st["prompt"].gather(
            1, (pcur[:, None] + ar).clamp(0, P - 1))
        view = self.view_of(st)
        last_logits, _ = T.prefill_chunk_step(
            params, self.cfg, chunk_tok, {"blocks": view, "pos": pcur},
            n_valid=n_valid)
        prow = n_valid > 0
        if self.gathered:
            cache_mod.paged_update_chunk(
                self.cfg, st["cache"], view, st["btab"], pcur, n_valid, C,
                self.max_seq, page_size=self.ps)
        land = pf & (pcur + n_valid >= plen)
        if self.spec:
            dcur = st["dcur"]
            n_valid_d = torch.where(pf, (plen - dcur).clamp(0, C), 0)
            dtok = st["prompt"].gather(
                1, (dcur[:, None] + ar).clamp(0, P - 1))
            T.prefill_chunk_step(dparams, self.dcfg, dtok,
                                 {"blocks": st["dcache"], "pos": dcur},
                                 n_valid=n_valid_d)
            st["dcur"] = dcur + n_valid_d
            st["pdelay"] = torch.where(pf & idle, st["pdelay"] - 1,
                                       st["pdelay"])
            land = land & (st["dcur"] >= plen)
            prow = prow | (n_valid_d > 0)
        if landing:
            tok0, lp0 = self.sample_lp(gen, last_logits)
            last_prompt_tok = st["prompt"].gather(
                1, (plen - 1).clamp(min=0)[:, None])[:, 0]
            alive0 = land if eos is None else land & (last_prompt_tok != eos)
            finished0 = st["limit"] <= 1
            if eos is not None:
                finished0 = finished0 | (tok0 == eos)
            buf0 = torch.where(land, st["req"], self.dummy_row)
            st["gen"][buf0, 0] = tok0
            st["lp"][buf0, 0] = lp0
            st["mask"][buf0, 0] = alive0.float()
            st["pos"] = torch.where(land, plen, st["pos"])
            st["tok"] = torch.where(land, tok0, st["tok"])
            st["ngen"] = torch.where(land, 1, st["ngen"])
            st["occupied"] = torch.where(land, alive0 & ~finished0,
                                         st["occupied"])
        st["pcur"] = torch.where(pf, pcur + n_valid, pcur)
        st["prefilling"] = pf & ~land
        return prow.sum()

    def mixed(self, params, dparams, st, gen, k_len: int, decode_from: int,
              lands: Sequence[bool]):
        """The mixed wave-step: ``k_len`` sub-rounds, each one decode half
        (rows mid-prefill protected) and one prefill chunk, so a long
        prompt never stalls the wave; a slot landing at sub-round j
        decodes from j+1 on.  Sub-rounds before ``decode_from`` have no
        slot that can emit and skip the decode half (count 0).  Returns
        (per-sub-round decode count tuples, prefill counts)."""
        zero = torch.zeros((), dtype=torch.int64, device=st["pos"].device)
        d_counts, p_counts = [], []
        for j in range(k_len):
            if j >= decode_from:
                d = self.decode_half(params, dparams, st, gen, protect=True)
            else:
                d = (zero,) * (4 if self.spec else 1)
            d_counts.append(d)
            p_counts.append(self.prefill_substep(params, dparams, st, gen,
                                                 lands[j]))
        return d_counts, p_counts


def _pool_pages(cfg: ModelConfig, gcfg: GenServeConfig,
                prompt_len: int) -> Tuple[int, int]:
    """(max pages per slot, pool size) of a paged engine config: ``W*MP``
    without prefix caching (the contiguous footprint), ``2*W*MP`` with it,
    so that a full admission wave always fits after LRU eviction (live
    slots pin at most ``W*MP`` distinct pages)."""
    MP = cache_mod.max_pages_per_slot(cfg, prompt_len + gcfg.max_new_tokens,
                                      gcfg.page_size)
    if gcfg.pool_pages > 0:
        NP = gcfg.pool_pages
    else:
        NP = gcfg.wave * MP * (2 if gcfg.prefix_cache else 1)
    return MP, NP


def _init_state(cfg: ModelConfig, gcfg: GenServeConfig, prompt_len: int,
                n_reqs: int, dtype: torch.dtype, device: torch.device,
                draft_cfg: Optional[ModelConfig] = None,
                draft_dtype: Optional[torch.dtype] = None, mesh=None
                ) -> Dict[str, object]:
    """The engine's device state.  On a mesh only the caches are
    DTensors (``cache.distribute_cache`` / ``distribute_paged_cache``);
    the slot table and the output buffers are plain tensors, the same on
    every rank, so the host loop reads the same values everywhere."""
    W, N = gcfg.wave, gcfg.max_new_tokens
    i64 = dict(dtype=torch.int64, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    btab = None
    if gcfg.page_size > 0:
        MP, NP = _pool_pages(cfg, gcfg, prompt_len)
        cache = cache_mod.init_paged_cache(cfg, W, prompt_len + N,
                                           page_size=gcfg.page_size,
                                           n_pages=NP, dtype=dtype,
                                           device=device)
        # with sharing the host maps rows at admission: start unmapped
        btab = (torch.full((W, MP), NP, **i64) if gcfg.prefix_cache
                else torch.as_tensor(cache_mod.identity_block_table(W, MP),
                                     **i64))
    else:
        cache = cache_mod.init_cache(cfg, W, prompt_len + N, dtype=dtype,
                                     device=device)
    if mesh is not None:
        cache["blocks"] = (
            cache_mod.distribute_paged_cache(cfg, cache["blocks"], mesh)
            if gcfg.page_size > 0
            else cache_mod.distribute_cache(cache["blocks"], mesh))
    st = {
        "tok": torch.zeros((W,), **i64),
        "pos": torch.zeros((W,), **i64),
        "occupied": torch.zeros((W,), dtype=torch.bool, device=device),
        "req": torch.full((W,), n_reqs, **i64),
        "ngen": torch.zeros((W,), **i64),
        "limit": torch.ones((W,), **i64),
        "cache": cache["blocks"],
        "gen": torch.zeros((n_reqs + 1, N), **i64),
        "lp": torch.zeros((n_reqs + 1, N), **f32),
        "mask": torch.zeros((n_reqs + 1, N), **f32),
    }
    if gcfg.prefill_chunk > 0:
        st.update({
            "prompt": torch.zeros((W, prompt_len), **i64),
            "pcur": torch.zeros((W,), **i64),
            "plen": torch.full((W,), prompt_len, **i64),
            "prefilling": torch.zeros((W,), dtype=torch.bool, device=device),
        })
    if btab is not None:
        st["btab"] = btab
    if gcfg.spec_k > 0:
        # the draft's small contiguous full-window cache (never paged),
        # and under chunked admission its cursor and the target's idle
        # counter
        st["dcache"] = cache_mod.init_cache(
            draft_cfg, W, prompt_len + N, dtype=draft_dtype,
            device=device)["blocks"]
        if mesh is not None:
            st["dcache"] = cache_mod.distribute_cache(st["dcache"], mesh)
        if gcfg.prefill_chunk > 0:
            st["dcur"] = torch.zeros((W,), **i64)
            st["pdelay"] = torch.zeros((W,), **i64)
    return st


# ---------------------------------------------------------------------------
# Host-driven engine loop
# ---------------------------------------------------------------------------

def _check_spec(cfg: ModelConfig, draft_params, draft_cfg) -> None:
    if draft_params is None or draft_cfg is None:
        raise ValueError("spec_k > 0 requires draft_params and draft_cfg")
    if not cache_mod.supports_speculative_target(cfg):
        raise ValueError(
            "speculative decoding requires an attention-only target "
            "without rwkv_channel FFNs: recurrent state cannot roll back "
            "rejected tokens")
    if not cache_mod.supports_speculative_draft(draft_cfg):
        raise ValueError(
            "the draft must be full-window attention-only: its cache takes "
            "pre-acceptance writes that only a full (non-ring) layout can "
            "mask out after rollback")
    if draft_cfg.vocab_size != cfg.vocab_size:
        raise ValueError("draft and target must share a vocabulary")


def serve(params, cfg: ModelConfig, prompts, gen: Optional[torch.Generator],
          gcfg: GenServeConfig, gen_lens: Optional[Sequence[int]] = None,
          prompt_lens: Optional[Sequence[int]] = None,
          slot_failures: Optional[Dict[int, Sequence[int]]] = None,
          cancels: Optional[Dict[int, Sequence[int]]] = None,
          draft_params=None, draft_cfg: Optional[ModelConfig] = None,
          mesh=None) -> Tuple[Dict[str, torch.Tensor], Dict[str, object]]:
    """Generate for all `prompts` [B, P] with continuous batching.

    Runs on the device the params live on.  Returns (rollout dict — the
    ``rl.rollout.generate`` contract — and an engine-stats dict: the
    per-round wave timeline, occupancy and prefill traces, per-request
    time-to-first-token, prefix-cache and speculative counters).
    `gen_lens` caps each request's budget.  `prompt_lens` marks each
    request's real prompt length inside the padded [B, P] array: chunked
    admission ingests only the real tokens and lands each slot at its own
    length; one-shot admission prefills the padded width
    (padding-as-content, as the reference).

    Fault / cancel hooks, keyed on the 1-based host round and applied at
    the top of that round:

    * ``slot_failures``: round -> decode-slot ids that die there.  The
      in-flight request is requeued from scratch (slot freed, occupancy
      and prefill flags cleared, partial output rows zeroed, pages
      decrefed — shared prefix pages survive in the radix tree) and runs
      again like any other request.
    * ``cancels``: round -> request ids to retire without EOS or budget:
      dequeued if pending, evicted and zeroed if in flight; their output
      rows are all zero with an all-zero mask.

    ``mesh`` (a ``("data", "model")`` DeviceMesh over ranks that all call
    ``serve`` with the same arguments) runs the engine sharded over it,
    as the reference's ``serve(mesh=)``: the params and draft params are
    committed to the mesh by ``param_tree_specs`` (DTensor leaves come
    as they are) and gathered to their use layout once, the caches are
    DTensors (slots over ``data``, kv heads over ``model``; page pools
    whole over ``data``), and every program runs under
    ``default_activation_rules(seq_shard=False)`` with plain tensors
    taken as replicated.  The slot table, the host loop and the outputs
    are every rank's same full values: sampling gathers the logits and
    draws for the whole wave (``gen`` seeded alike on every rank), so
    the ranks admit, retire and page alike.  A mesh of one device serves
    as ``mesh=None``."""
    if mesh is not None and sh.mesh_size(mesh) <= 1:
        mesh = None
    args = (cfg, prompts, gen, gcfg, gen_lens, prompt_lens, slot_failures,
            cancels, draft_cfg)
    if mesh is None:
        return _serve(params, *args, draft_params=draft_params)
    if not hasattr(mesh, "mesh_dim_names"):
        raise ValueError("serve(mesh=...) shards over a torch DeviceMesh "
                         "of ranks (parallel.dist); a mesh of several "
                         "devices in a world of one cannot be sharded over")
    from torch.distributed.tensor.experimental import implicit_replication
    commit = lambda p: None if p is None else sh.for_use(
        sh.distribute_params(p, mesh))
    # DTensor views refuse inference tensors: no_grad, never inference
    with torch.inference_mode(False), torch.no_grad(), \
            sh.use_hints(sh.default_activation_rules(seq_shard=False)), \
            implicit_replication():
        return _serve(commit(params), *args,
                      draft_params=commit(draft_params), mesh=mesh)


def _serve(params, cfg: ModelConfig, prompts, gen: Optional[torch.Generator],
           gcfg: GenServeConfig, gen_lens: Optional[Sequence[int]] = None,
           prompt_lens: Optional[Sequence[int]] = None,
           slot_failures: Optional[Dict[int, Sequence[int]]] = None,
           cancels: Optional[Dict[int, Sequence[int]]] = None,
           draft_cfg: Optional[ModelConfig] = None, draft_params=None,
           mesh=None) -> Tuple[Dict[str, torch.Tensor], Dict[str, object]]:
    """The engine loop of ``serve``, on ``mesh`` when one is given."""
    gcfg.validate()
    spec = gcfg.spec_k > 0
    if spec:
        _check_spec(cfg, draft_params, draft_cfg)
    device = params["final_norm"]["scale"].device
    dtype = params["final_norm"]["scale"].dtype
    prompts_np = np.asarray(torch.as_tensor(prompts).cpu(), np.int64)
    B, P = prompts_np.shape
    N, W = gcfg.max_new_tokens, gcfg.wave
    K = min(gcfg.decode_chunk, N)
    C = gcfg.prefill_chunk
    chunked = C > 0
    if chunked and prompt_lens is not None:
        plens_np = np.clip(np.asarray(prompt_lens, np.int64), 1, P)
    else:
        plens_np = np.full((B,), P, np.int64)
    nchunks = -(-P // C) if chunked else 0
    limits = np.full((B,), N, np.int64) if gen_lens is None \
        else np.clip(np.asarray(gen_lens, np.int64), 1, N)
    queue = RequestQueue([Request(i, int(limits[i])) for i in range(B)],
                         policy=gcfg.admission, aging=gcfg.sjf_aging)
    table = SlotTable(W)
    ps = gcfg.page_size
    paged = ps > 0
    sharing = gcfg.prefix_cache
    if sharing and not cache_mod.supports_prefix_sharing(cfg):
        raise ValueError(
            "prefix_cache requires every layer to be full-window "
            "attention: ring windows would clobber shared pages and "
            "recurrent state cannot be snapshotted at a prompt boundary "
            "(use page_size without prefix_cache for those configs)")
    if paged:
        MP, NP = _pool_pages(cfg, gcfg, P)
        identity_rows = cache_mod.identity_block_table(W, MP)
    pool = radix = None
    if sharing:
        pool = PagePool(NP, ps)
        radix = RadixCache(pool)
        slot_pages: List[List[int]] = [[] for _ in range(W)]
        slot_tokens: Dict[int, List[int]] = {}
    progs = _Programs(cfg, gcfg, P, B, draft_cfg if spec else None, mesh)
    state = _init_state(cfg, gcfg, P, B, dtype, device,
                        draft_cfg if spec else None,
                        draft_params["final_norm"]["scale"].dtype
                        if spec else None, mesh)
    as_dev = lambda a: torch.as_tensor(a, device=device)
    spec_tokens = spec_proposed = spec_accepted = 0

    rounds: List[Tuple[float, float, float, int]] = []
    ttft: Dict[int, float] = {}
    queue_wait: Dict[int, float] = {}    # request admission wait (host)
    n_prefills = 0
    prefill_rows = 0                     # rows the one-shot prefills ran
    round_idx = 0
    occupied = np.zeros((W,), bool)      # device occupancy, host view
    # host mirror of each slot's remaining prefill chunks — every mixed
    # sub-round advances every prefilling slot by exactly one chunk, so
    # landings are known without a device sync
    prefill_left = np.zeros((W,), np.int64)
    # one-shot admission on the card stamps TTFT by an event after the
    # admit's last launch, read once the loop is over: no sync per admit
    clock = (obs_trace.DeviceClock(device) if gcfg.measure_ttft
             and not chunked and device.type == "cuda" else None)
    ttft_events: List[Tuple[object, List[int]]] = []
    # TTFT and queue waits count from here on the clock the events are
    # put on; the rounds keep the executor's ``time.monotonic``
    t_start = time.perf_counter()

    def evict_slot(s: int) -> None:
        """Clear slot ``s``'s device and host residue after a failure or
        cancel (the caller has fixed the table's books)."""
        state["occupied"][s] = False
        if chunked:
            state["prefilling"][s] = False
            prefill_left[s] = 0
        occupied[s] = False
        if sharing and slot_pages[s]:
            pool.decref(slot_pages[s])
            slot_pages[s] = []
            slot_tokens.pop(s, None)

    def zero_request_rows(rid: int) -> None:
        """Wipe a request's partial output so a requeued regeneration
        leaves no stale columns and a cancelled request reads as
        all-masked."""
        for k in ("gen", "lp", "mask"):
            state[k][rid] = 0

    def read(t) -> np.ndarray:
        """A blocking device-to-host read of the loop, into a host copy
        (on the CPU too: ``occupied`` must not alias the state)."""
        with obs_trace.span("gen.read"):
            return t.to("cpu", copy=True).numpy()

    def round_counts(counts) -> np.ndarray:
        """Per-sub-round active counts; speculative engines also add up
        the emitted, proposed and accepted tokens."""
        nonlocal spec_tokens, spec_proposed, spec_accepted
        c = read(torch.stack([torch.stack(t) for t in counts]))
        if spec:
            spec_tokens += int(c[:, 1].sum())
            spec_proposed += int(c[:, 2].sum())
            spec_accepted += int(c[:, 3].sum())
        return c[:, 0]

    while len(queue) or table.active:
        round_idx += 1
        # requeued requests extend the round budget: each re-admission
        # costs at most one more full request lifetime
        budget_reqs = B + table.requeued
        if round_idx > 2 * budget_reqs * (N + 1) \
                + budget_reqs * (nchunks + 1):
            raise RuntimeError("genserve loop did not converge")
        t0 = time.monotonic()
        rspan = obs_trace.span("gen.round", round=round_idx)
        rspan.__enter__()
        if slot_failures and round_idx in slot_failures:
            for s in slot_failures[round_idx]:
                rid = table.fail_slot(int(s))
                if rid == FREE:
                    continue
                evict_slot(int(s))
                zero_request_rows(rid)
                queue.push(Request(rid, int(limits[rid])))
        if cancels and round_idx in cancels:
            for rid in cancels[round_idx]:
                rid = int(rid)
                if queue.cancel(rid):
                    # never admitted: only the cancel is counted
                    table.cancelled += 1
                    obs_metrics.counter("gen.cancelled").inc()
                    continue
                if rid in table.slot_req:
                    s = table.slot_req.index(rid)
                    table.cancel_slot(s)
                    evict_slot(s)
                    zero_request_rows(rid)
        admitted = 0
        may_live = False
        free = table.free_slots()
        if free and len(queue):
            aspan = obs_trace.span("gen.install") if chunked else \
                obs_trace.device_span("gen.admit", device)
            aspan.__enter__()
            reqs = queue.pop(len(free))
            slots = free[:len(reqs)]
            if chunked:
                # slots that admit nothing carry a broadcast of the first
                # admitted prompt; only admitted rows are used
                pb = np.broadcast_to(prompts_np[reqs[0].rid], (W, P)).copy()
                admit_mask = np.zeros((W,), bool)
                rows = np.full((W,), B, np.int64)
                lim = np.ones((W,), np.int64)
                pl = np.full((W,), P, np.int64)
                for s, rq in zip(slots, reqs):
                    pb[s] = prompts_np[rq.rid]
                    admit_mask[s] = True
                    rows[s] = rq.rid
                    lim[s] = rq.max_new_tokens
                    pl[s] = plens_np[rq.rid]
                admit_cpu = torch.as_tensor(admit_mask)
                pstarts = np.zeros((W,), np.int64)
                btab_new = np.full((W, MP), NP, np.int64) if paged else None
                if sharing:
                    copy_src: List[int] = []
                    copy_dst: List[int] = []
                    cow_srcs: List[int] = []
                    for s, rq in zip(slots, reqs):
                        p = int(plens_np[rq.rid])
                        toks = prompts_np[rq.rid, :p].tolist()
                        # cap the hit at p-1 tokens: the landing chunk
                        # must run so that first-token logits come from a
                        # real forward pass
                        full, part = radix.match(toks, p - 1)
                        pool.incref(full)          # the slot's refs
                        if part is not None:
                            # keep the COW source alive across eviction
                            # until its copy is scheduled
                            pool.incref([part[0]])
                            cow_srcs.append(part[0])
                        need = MP - len(full)
                        if pool.available() < need:
                            radix.evict(need - pool.available())
                        fresh = pool.alloc(need)
                        if fresh is None:
                            raise RuntimeError("page pool exhausted")
                        row = full + fresh
                        btab_new[s, :len(row)] = row
                        pstart = len(full) * ps
                        if part is not None:
                            copy_src.append(part[0])
                            copy_dst.append(fresh[0])
                            pstart += part[1]
                        pstarts[s] = pstart
                        slot_pages[s] = row
                        slot_tokens[s] = toks
                        table.record_prefix(pstart, p)
                        # speculative: the draft ingests the full prompt,
                        # so its chunk count paces the slot
                        prefill_left[s] = -(-p // C) if spec \
                            else -(-(p - pstart) // C)
                    if copy_src:
                        src = np.full((W,), NP, np.int64)
                        dst = np.full((W,), NP, np.int64)
                        src[:len(copy_src)] = copy_src
                        dst[:len(copy_dst)] = copy_dst
                        progs.copy(state, as_dev(src), as_dev(dst))
                    if cow_srcs:
                        pool.decref(cow_srcs)
                else:
                    for s, rq in zip(slots, reqs):
                        p = int(plens_np[rq.rid])
                        if paged:
                            btab_new[s] = identity_rows[s]
                        table.record_prefix(0, p)
                        prefill_left[s] = -(-p // C)
                progs.install(state, as_dev(pb), as_dev(admit_mask),
                              admit_cpu, as_dev(rows), as_dev(lim),
                              as_dev(pl),
                              as_dev(pstarts) if paged else None,
                              as_dev(btab_new) if paged else None)
            else:
                rids = [rq.rid for rq in reqs]
                n_rows = progs.admit(
                    params, draft_params, state, as_dev(prompts_np[rids]),
                    torch.as_tensor(slots, dtype=torch.int64), as_dev(rids),
                    as_dev([rq.max_new_tokens for rq in reqs]), gen)
                prefill_rows += n_rows
                aspan.set("rows", n_rows)
                if clock is not None:
                    ttft_events.append((clock.record(), rids))
                elif gcfg.measure_ttft:
                    # the CPU has run the admit by now
                    now = time.perf_counter()
                    for rq in reqs:
                        ttft[rq.rid] = now - t_start
                # host-side liveness bound (no device sync here)
                may_live = any(
                    rq.max_new_tokens > 1
                    and (gcfg.eos_token is None
                         or prompts_np[rq.rid, -1] != gcfg.eos_token)
                    for rq in reqs)
            table.admit(slots, reqs)
            n_prefills += 1
            admitted = len(reqs)
            now_adm = time.perf_counter()
            for rq in reqs:
                queue_wait[rq.rid] = now_adm - t_start
            aspan.set("admitted", admitted)
            aspan.__exit__(None, None, None)

        counts = np.zeros((0,), np.int64)
        if chunked and prefill_left.any():
            # mixed wave-step, sized to the outstanding prefill work
            # (slots landing mid-scan decode for the remaining sub-rounds)
            active_left = prefill_left[prefill_left > 0]
            k_len = int(min(K, active_left.max()))
            lands = [bool((prefill_left == j + 1).any())
                     for j in range(k_len)]
            decode_from = 0 if occupied.any() else \
                int(active_left.min())       # first landing + 1
            with obs_trace.device_span("gen.mixed", device,
                                       subrounds=k_len, spec_k=gcfg.spec_k):
                d, p = progs.mixed(params, draft_params, state, gen, k_len,
                                   decode_from, lands)
                counts = round_counts(d)            # device sync
            table.record_round(counts, read(torch.stack(p)))
            occupied = read(state["occupied"])
            landed = (prefill_left > 0) & (prefill_left <= k_len)
            if gcfg.measure_ttft:
                # free here: the reads above already synced
                now = time.perf_counter()
                for s in np.nonzero(landed)[0]:
                    ttft[table.slot_req[s]] = now - t_start
            if sharing:
                # a landed prompt's complete pages enter the radix tree
                # (insert at landing: earlier matches can never map pages
                # whose KV is not written yet); the trailing partial page
                # stays private
                for s in np.nonzero(landed)[0]:
                    toks = slot_tokens[s]
                    radix.insert(toks, slot_pages[s][:len(toks) // ps])
            prefill_left = np.maximum(prefill_left - k_len, 0)
        elif occupied.any() or may_live:
            # decode only when a slot can be occupied: requests that
            # finished at admission never burn wave steps
            with obs_trace.device_span("gen.decode", device, steps=K,
                                       spec_k=gcfg.spec_k):
                counts = round_counts(progs.chunk(params, draft_params,
                                                 state, K, gen))
            table.record_step(counts)
            occupied = read(state["occupied"])

        if sharing:
            prev_slot_req = list(table.slot_req)
        table.retire_finished(occupied | (prefill_left > 0))
        if sharing:
            # retired slots drop their page references; pages shared with
            # the radix tree or other slots survive the decref
            for s in range(W):
                if prev_slot_req[s] != FREE and table.slot_req[s] == FREE:
                    pool.decref(slot_pages[s])
                    slot_pages[s] = []
                    slot_tokens.pop(s, None)
        t1 = time.monotonic()
        occ = float(np.mean(counts)) if len(counts) else 0.0
        rounds.append((t0, t1, occ, admitted))
        rspan.set("occupancy", occ)
        rspan.__exit__(None, None, None)

    for ev, rids in ttft_events:
        # from the batch's start until the first token is on the card
        t = clock.at(ev) - t_start
        for rid in rids:
            ttft[rid] = t
    prompts_dev = torch.as_tensor(prompts_np, device=device)
    gen_out = state["gen"][:B]
    res = {"sequences": torch.cat([prompts_dev, gen_out], dim=1),
           "gen_tokens": gen_out,
           "logprobs": state["lp"][:B],
           "mask": state["mask"][:B]}
    stats = {"engine": "genserve", "wave": W,
             "decode_steps": table.decode_steps,
             "slot_steps": table.slot_steps,
             "mean_occupancy": table.mean_occupancy(),
             "busy_occupancy": table.busy_occupancy(),
             "occupancy_trace": list(table.occupancy_trace),
             "prefill_trace": list(table.prefill_trace),
             "prefill_rounds": table.prefill_rounds,
             "prefill_slot_steps": table.prefill_slot_steps,
             "prefill_chunk": C, "prompt_len": P,
             "max_new_tokens": N,
             "prefill_rounds_per_req":
                 float(np.mean(np.ceil(plens_np / C))) if chunked else 0.0,
             "ttft": ttft, "queue_wait": queue_wait,
             "rounds": rounds, "prefills": n_prefills,
             "prefill_rows": prefill_rows,
             "admitted": table.admitted, "retired": table.retired,
             "requeued": table.requeued, "cancelled": table.cancelled,
             "page_size": ps, "prefix_cache": sharing,
             "prefix_hit_rate": table.prefix_hit_rate(),
             "prefill_tokens_skipped": table.prefix_hit_tokens,
             "prompt_tokens": table.prompt_tokens,
             "spec_k": gcfg.spec_k,
             "spec_proposed": spec_proposed,
             "spec_accepted": spec_accepted,
             "spec_tokens": spec_tokens,
             "accept_rate": (spec_accepted / spec_proposed)
                 if spec_proposed else 0.0}
    # registry metrics: one batch of updates per serve() call
    obs_metrics.counter("gen.tokens").inc(
        spec_tokens if spec else table.slot_steps)
    if spec:
        obs_metrics.counter("gen.spec_proposed").inc(spec_proposed)
        obs_metrics.counter("gen.spec_accepted").inc(spec_accepted)
        obs_metrics.histogram("gen.spec_accept_rate").observe(
            stats["accept_rate"])
    obs_metrics.counter("gen.requests").inc(table.retired)
    obs_metrics.histogram("gen.wave_occupancy").observe(
        table.mean_occupancy())
    obs_metrics.counter("gen.prefix_hit_tokens").inc(table.prefix_hit_tokens)
    obs_metrics.counter("gen.prompt_tokens").inc(table.prompt_tokens)
    ttft_h = obs_metrics.histogram("gen.ttft_s")
    for v in ttft.values():
        ttft_h.observe(v)
    qw_h = obs_metrics.histogram("gen.queue_wait_s")
    for v in queue_wait.values():
        qw_h.observe(v)
    if sharing:
        # teardown invariants: every slot is retired, so the remaining
        # page references must be exactly the radix tree's — anything
        # beyond is a leak (warned and counted; raises under
        # REPRO_OBS_STRICT=1)
        obs_metrics.gauge("pagepool.utilization").set(pool.utilization())
        pool.leak_check(expected_refs=radix.page_refs())
        stats["_pagepool"] = pool
        stats["_radix"] = radix
    return res, stats
