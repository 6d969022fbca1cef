"""Wave-stepped continuous-batching decode loop (one-shot admission).

Port of the one-shot, contiguous-cache, batched-decode subset of
``repro.genserve.decoder`` (lines 159-1250).  The device side is two
programs, plain functions on the state dict of device tensors:

  program   inputs (beyond params/state)      what it does
  -------   -------------------------------   ---------------------------
  admit     prompts [W,P], admit_mask [W],    prefill the whole [W, P]
            rows [W], limits [W]              prompt batch (rows of slots
                                              that admit nothing are the
                                              first admitted prompt,
                                              broadcast), sample each
                                              admitted request's first
                                              token, scatter the fresh
                                              cache rows of admitted
                                              slots only.
  chunk     decode_chunk                      ``decode_chunk`` batched
                                              wave decode steps: one
                                              ``decode_step`` over all W
                                              slots at per-slot positions,
                                              sample, record, retire on
                                              EOS / budget.

The cache leaves (``[R, W, L, KV, hd]`` k/v for attention, ``[R, W, ...]``
recurrent state for RWKV6) are exactly ``decode_step``'s batch layout,
and per-slot positions ([W] ``pos``) carry each recycled slot's own RoPE
phase and validity, so the whole wave shares one flash-decode launch per
attention layer.  Free slots decode too, unmasked: their k/v writes and
their recurrent state (``tm_shift``, ``wkv``, ``cm_shift``, which drift
as a free slot keeps feeding its last token) land only in that slot's
own rows, and admission replaces whole slot rows (``scatter_slots``), so
no stale state reaches the next occupant.  A free slot's KV cache still
holds a valid entry 0, so no attention row is fully masked.

The host loop owns membership: it reads back the ``occupied`` vector
after every round (the round's one device sync), retires finished
requests via the ``scheduler.SlotTable`` and back-fills freed slots from
the admission queue in arrival order.

Not yet ported: chunked admission, the paged cache and prefix reuse,
speculative decoding, the vmapped decode path, shortest-job-first
admission, meshes, slot failures and cancels (``adapter.generate`` and
the launcher refuse them with ``NotImplementedError``).

Sampling draws from one ``torch.Generator`` in event order; greedy
decoding is token-exact against the JAX engine.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import synchronize
from repro_torch.genserve.scheduler import Request, RequestQueue, SlotTable
from repro_torch.models import cache as cache_mod
from repro_torch.models import sampling
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

NOT_PORTED = "not yet ported"


@dataclasses.dataclass(frozen=True)
class GenServeConfig:
    """Engine knobs: the JAX package's fields that the port runs."""

    wave: int                        # max concurrently decoding slots (W)
    max_new_tokens: int              # global budget N (output buffer width)
    decode_chunk: int = 1            # decode steps per host round
    temperature: float = 1.0
    eos_token: Optional[int] = None
    greedy: bool = False
    measure_ttft: bool = False       # stamp per-request time-to-first-token
    #                                  (a device sync per admit batch)

    def validate(self) -> None:
        if self.wave < 1 or self.max_new_tokens < 1 or self.decode_chunk < 1:
            raise ValueError(f"bad engine config {self}")


# ---------------------------------------------------------------------------
# Engine programs
# ---------------------------------------------------------------------------

class _Programs:
    """The ``admit`` and ``chunk`` programs for one (cfg, gcfg, P, n_reqs)."""

    def __init__(self, cfg: ModelConfig, gcfg: GenServeConfig,
                 prompt_len: int, n_reqs: int):
        self.cfg, self.gcfg = cfg, gcfg
        self.P, self.N = prompt_len, gcfg.max_new_tokens
        self.dummy_row = n_reqs         # output buffers carry a scratch row

    def sample_lp(self, gen, logits):
        return sampling.sample_with_logprobs(
            gen, logits, temperature=self.gcfg.temperature,
            greedy=self.gcfg.greedy)

    def admit(self, params, st, prompts, admit_mask, rows, limits, gen):
        """Prefill [W, P] prompts; install admitted slots; sample token 0."""
        eos = self.gcfg.eos_token
        out = T.forward(params, self.cfg, {"tokens": prompts},
                        return_cache=True, max_cache_len=self.P + self.N)
        tok0, lp0 = self.sample_lp(gen, out["logits"][:, -1])
        alive0 = sampling.initial_alive(prompts, eos) & admit_mask
        finished0 = limits <= 1
        if eos is not None:
            finished0 |= tok0 == eos
        buf_rows = torch.where(admit_mask, rows, self.dummy_row)
        st["gen"][buf_rows, 0] = tok0
        st["lp"][buf_rows, 0] = lp0
        st["mask"][buf_rows, 0] = alive0.float()
        cache_mod.scatter_slots(st["cache"], out["cache"]["blocks"],
                                admit_mask)
        st["pos"] = torch.where(admit_mask, self.P, st["pos"])
        st["tok"] = torch.where(admit_mask, tok0, st["tok"])
        st["ngen"] = torch.where(admit_mask, 1, st["ngen"])
        st["req"] = torch.where(admit_mask, rows, st["req"])
        st["limit"] = torch.where(admit_mask, limits, st["limit"])
        st["occupied"] = torch.where(admit_mask, alive0 & ~finished0,
                                     st["occupied"])

    def decode_substep(self, params, st, gen):
        """One batched wave decode step over all W slots.  The cache is
        written in place for every row (free rows included): their
        clobbered rows are replaced wholesale at re-admission."""
        eos = self.gcfg.eos_token
        logits, _ = T.decode_step(params, self.cfg, st["tok"][:, None],
                                  {"blocks": st["cache"], "pos": st["pos"]})
        nxt, lp = self.sample_lp(gen, logits)
        emit = st["occupied"]
        buf_rows = torch.where(emit, st["req"], self.dummy_row)
        cols = torch.where(emit, st["ngen"], 0)
        alive_after = sampling.next_alive(emit, nxt, eos)
        finished = emit & (~alive_after | (st["ngen"] + 1 >= st["limit"]))
        st["gen"][buf_rows, cols] = nxt
        st["lp"][buf_rows, cols] = lp
        st["mask"][buf_rows, cols] = emit.float()
        st["pos"] = torch.where(emit, st["pos"] + 1, st["pos"])
        st["tok"] = torch.where(emit, nxt, st["tok"])
        st["ngen"] = torch.where(emit, st["ngen"] + 1, st["ngen"])
        st["occupied"] = emit & ~finished
        return emit.sum()

    def chunk(self, params, st, steps: int, gen):
        """``steps`` wave decode steps; per-step active counts [steps]."""
        return torch.stack([self.decode_substep(params, st, gen)
                            for _ in range(steps)])


def _init_state(cfg: ModelConfig, gcfg: GenServeConfig, prompt_len: int,
                n_reqs: int, dtype: torch.dtype, device: torch.device
                ) -> Dict[str, object]:
    W, N = gcfg.wave, gcfg.max_new_tokens
    cache = cache_mod.init_cache(cfg, W, prompt_len + N, dtype=dtype,
                                 device=device)
    i64 = dict(dtype=torch.int64, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return {
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


# ---------------------------------------------------------------------------
# Host-driven engine loop
# ---------------------------------------------------------------------------

def serve(params, cfg: ModelConfig, prompts, gen: Optional[torch.Generator],
          gcfg: GenServeConfig, gen_lens: Optional[Sequence[int]] = None
          ) -> Tuple[Dict[str, torch.Tensor], Dict[str, object]]:
    """Generate for all `prompts` [B, P] with continuous batching.

    Runs on the device the params live on.  Returns (rollout dict — the
    ``rl.rollout.generate`` contract — and an engine-stats dict with the
    per-round wave timeline, occupancy trace and per-request
    time-to-first-token).  `gen_lens` optionally caps each request's
    budget.  One-shot admission prefills the padded prompt width
    (padding-as-content, as the reference)."""
    gcfg.validate()
    T.check_supported(cfg)
    device = params["final_norm"]["scale"].device
    dtype = params["final_norm"]["scale"].dtype
    prompts_np = np.asarray(torch.as_tensor(prompts).cpu(), np.int64)
    B, P = prompts_np.shape
    N, W = gcfg.max_new_tokens, gcfg.wave
    K = min(gcfg.decode_chunk, N)
    limits = np.full((B,), N, np.int64) if gen_lens is None \
        else np.clip(np.asarray(gen_lens, np.int64), 1, N)
    queue = RequestQueue([Request(i, int(limits[i])) for i in range(B)])
    table = SlotTable(W)
    progs = _Programs(cfg, gcfg, P, B)
    state = _init_state(cfg, gcfg, P, B, dtype, device)
    prompts_dev = torch.as_tensor(prompts_np, device=device)

    rounds: List[Tuple[float, float, float, int]] = []
    ttft: Dict[int, float] = {}
    queue_wait: Dict[int, float] = {}
    n_prefills = 0
    round_idx = 0
    occupied = np.zeros((W,), bool)      # device occupancy, host view
    t_start = time.monotonic()

    while len(queue) or table.active:
        round_idx += 1
        if round_idx > 2 * B * (N + 1) + B:
            raise RuntimeError("genserve loop did not converge")
        t0 = time.monotonic()
        rspan = obs_trace.span("gen.round", round=round_idx)
        rspan.__enter__()
        obs_metrics.gauge("gen.queue_depth").set(len(queue))
        admitted = 0
        may_live = False
        free = table.free_slots()
        if free and len(queue):
            aspan = obs_trace.span("gen.admit")
            aspan.__enter__()
            reqs = queue.pop(len(free))
            slots = free[:len(reqs)]
            # slots that admit nothing prefill a broadcast of the first
            # admitted prompt; only admitted rows are scattered back
            pb = np.broadcast_to(prompts_np[reqs[0].rid], (W, P)).copy()
            admit_mask = np.zeros((W,), bool)
            rows = np.full((W,), B, np.int64)
            lim = np.ones((W,), np.int64)
            for s, rq in zip(slots, reqs):
                pb[s] = prompts_np[rq.rid]
                admit_mask[s] = True
                rows[s] = rq.rid
                lim[s] = rq.max_new_tokens
            progs.admit(params, state, torch.as_tensor(pb, device=device),
                        torch.as_tensor(admit_mask, device=device),
                        torch.as_tensor(rows, device=device),
                        torch.as_tensor(lim, device=device), gen)
            if gcfg.measure_ttft:
                synchronize(device)
                now = time.monotonic()
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
            now_adm = time.monotonic()
            for rq in reqs:
                queue_wait[rq.rid] = now_adm - t_start
            aspan.set("admitted", admitted)
            aspan.__exit__(None, None, None)

        counts = np.zeros((0,), np.int64)
        if occupied.any() or may_live:
            with obs_trace.span("gen.decode", steps=K, spec_k=0):
                counts = progs.chunk(params, state, K, gen).cpu().numpy()
            table.record_step(counts)
            occupied = state["occupied"].cpu().numpy()

        table.retire_finished(occupied)
        t1 = time.monotonic()
        occ = float(np.mean(counts)) if len(counts) else 0.0
        rounds.append((t0, t1, occ, admitted))
        rspan.set("occupancy", occ)
        rspan.__exit__(None, None, None)

    gen_np = state["gen"][:B]
    res = {"sequences": torch.cat([prompts_dev, gen_np], dim=1),
           "gen_tokens": gen_np,
           "logprobs": state["lp"][:B],
           "mask": state["mask"][:B]}
    stats = {"engine": "genserve", "wave": W,
             "decode_steps": table.decode_steps,
             "slot_steps": table.slot_steps,
             "mean_occupancy": table.mean_occupancy(),
             "occupancy_trace": list(table.occupancy_trace),
             "prompt_len": P, "max_new_tokens": N,
             "ttft": ttft, "queue_wait": queue_wait,
             "rounds": rounds, "prefills": n_prefills,
             "admitted": table.admitted, "retired": table.retired}
    obs_metrics.counter("gen.tokens").inc(table.slot_steps)
    obs_metrics.counter("gen.requests").inc(table.retired)
    obs_metrics.histogram("gen.wave_occupancy").observe(
        table.mean_occupancy())
    ttft_h = obs_metrics.histogram("gen.ttft_s")
    for v in ttft.values():
        ttft_h.observe(v)
    qw_h = obs_metrics.histogram("gen.queue_wait_s")
    for v in queue_wait.values():
        qw_h.observe(v)
    return res, stats
