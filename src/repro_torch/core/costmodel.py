"""Analytical cost model (§3.3 + Appendix B) — faithful implementation.

All costs in seconds, volumes in bytes, bandwidths in GB/s.  The α–β terms
follow Appendix B exactly: TP/DP all-reduce costs minimize over ring graphs
of the participating devices (exact for ≤8 devices, nearest-neighbour +
2-opt beyond); PP costs minimize over inter-stage device pairs.

Deviations (documented in DESIGN.md):
  * ``min over all feasible ring graphs`` is TSP-hard; exact enumeration for
    ≤8 devices, heuristic beyond (the paper is necessarily heuristic too).
  * MoE / attention-free archs (our assigned pool; the paper evaluates dense
    Qwen only) use generalized per-layer weight/FLOP counts from LLMSpec.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.plan import (BYTES_BF16, MAX_DECODE_WAVE, PREFILL_CHUNK,
                             Plan, decode_wave)
from repro_torch.core.topology import Topology
from repro_torch.core.workflow import LLMSpec, RLWorkflow, Task, TaskKind


# ---------------------------------------------------------------------------
# Ring / pair primitives
# ---------------------------------------------------------------------------

def _edge_cost(topo: Topology, a: int, b: int, cv: float) -> float:
    beta = topo.beta(a, b)
    if beta <= 0:
        return 1e9
    return topo.alpha(a, b) + cv / (beta * 1e9)


_EXACT_RING_N = 6


def _ring_order_heuristic(topo: Topology, devices: Sequence[int],
                          cv: float) -> Tuple[int, ...]:
    """Nearest-neighbour construction + bounded 2-opt, cached per set."""
    key = (tuple(sorted(devices)),)
    cache = getattr(topo, "_ring_cache", None)
    if cache is None:
        cache = topo._ring_cache = {}
    if key in cache:
        return cache[key]

    def ring_max(order):
        return max(_edge_cost(topo, order[i], order[(i + 1) % len(order)], cv)
                   for i in range(len(order)))

    remaining = list(devices[1:])
    order = [devices[0]]
    while remaining:
        cur = order[-1]
        nxt = min(remaining, key=lambda d: _edge_cost(topo, cur, d, cv))
        order.append(nxt)
        remaining.remove(nxt)
    best = ring_max(order)
    for _ in range(2):
        improved = False
        for i in range(1, len(order) - 1):
            for j in range(i + 1, len(order)):
                cand = order[:i] + order[i:j + 1][::-1] + order[j + 1:]
                c = ring_max(cand)
                if c < best - 1e-12:
                    best, order = c, cand
                    improved = True
        if not improved:
            break
    cache[key] = tuple(order)
    return cache[key]


def ring_cost(topo: Topology, devices: Sequence[int], cv: float) -> float:
    """min over ring graphs of max over ring edges (alpha + cv/beta).

    Exact for <= _EXACT_RING_N devices; NN + 2-opt heuristic beyond (the
    optimal ring order is cached per device set — it is cv-independent up
    to ties for the bottleneck-ring objective on a fixed edge metric)."""
    n = len(devices)
    if n <= 1:
        return 0.0
    if n == 2:
        return _edge_cost(topo, devices[0], devices[1], cv)

    def ring_max(order):
        return max(_edge_cost(topo, order[i], order[(i + 1) % len(order)], cv)
                   for i in range(len(order)))

    if n <= _EXACT_RING_N:
        first = devices[0]
        best = math.inf
        for perm in itertools.permutations(devices[1:]):
            if perm[0] > perm[-1]:   # skip mirrored rings
                continue
            best = min(best, ring_max((first,) + perm))
        return best

    order = _ring_order_heuristic(topo, devices, cv)
    return ring_max(order)


def pair_min_cost(topo: Topology, devs_a: Sequence[int],
                  devs_b: Sequence[int], cv: float) -> float:
    return min(_edge_cost(topo, a, b, cv)
               for a in devs_a for b in devs_b)


# ---------------------------------------------------------------------------
# Per-layer volumes and FLOPs
# ---------------------------------------------------------------------------

# attention-free recurrent state width per channel (matches the linear-
# time state-update FLOP term below and the decode state read in c_hbm)
_STATE_DIM = 64


def flops_per_layer(task: Task, seq: int) -> float:
    """Per-sample per-layer forward FLOPs (Appendix B 'Computation')."""
    return model_flops_per_layer(task.model, seq)


def model_flops_per_layer(m: LLMSpec, seq: int) -> float:
    if m.attention_free:
        proj = 2 * 5 * seq * m.h1 * m.h1          # r,k,v,g,o projections
        attn = 2 * seq * m.h1 * _STATE_DIM        # linear-time state update
        mlp = 2 * 2 * seq * m.h1 * m.h2 + 2 * seq * m.h1 * m.h1
        return proj + attn + mlp
    qkvo = 2 * 4 * seq * m.h1 * m.h1
    attn = 2 * 2 * seq * seq * m.h1
    mult = m.top_k if m.n_experts else 1
    mlp = 2 * 3 * seq * m.h1 * m.h2 * mult
    return qkvo + attn + mlp


def speculative_expected_tokens(spec_k: int, accept_rate: float) -> float:
    """Expected tokens emitted per draft/verify round: one bonus token
    plus a geometric run of accepted drafts — ``(1 - a^(k+1)) / (1 - a)``
    for per-token accept rate a, saturating at k+1."""
    a = min(max(float(accept_rate), 0.0), 1.0)
    k1 = int(spec_k) + 1
    if a >= 1.0:
        return float(k1)
    return (1.0 - a ** k1) / (1.0 - a)


def default_draft_spec(m: LLMSpec, ratio: int = 4) -> LLMSpec:
    """Conventional draft for target `m`: same family, ``ratio`` x fewer
    layers at half width (~1/16 the weight volume) — the shape of the
    configs/archs tiny<->large pairs the serve path pairs up."""
    return dataclasses.replace(
        m, name=f"{m.name}-draft", n_layers=max(m.n_layers // ratio, 1),
        h1=max(m.h1 // 2, 64), h2=max(m.h2 // 2, 64),
        n_heads=max(m.n_heads // 2, 1) if m.n_heads else 0,
        n_kv_heads=max(m.n_kv_heads // 2, 1) if m.n_kv_heads else 0)


SPEC_K_CHOICES = (0, 2, 4, 8)


def apply_speculative_best_response(cm: "CostModel", plan,
                                    ks: Sequence[int] = SPEC_K_CHOICES):
    """Pick the cheapest draft-k per GEN task and write it into
    ``plan.gen_spec`` (0 = plain wave decode, left absent).

    Speculative decoding is a *best response*, not a search dimension:
    given any assignment, the cost model prices each k deterministically,
    so every scheduler (SHA-EA decode, the ILP's leaf evaluation, a
    hand-built plan) refines plans the same way — searches over the same
    topology cannot disagree about spec and flip an incumbent."""
    for t in range(cm.wf.n_tasks):
        task = cm.wf.task(t)
        if task.kind != TaskKind.GEN or task.model.attention_free:
            continue
        k = min(ks, key=lambda k: cm.gen_speculative_wave(plan, t, 0, 0,
                                                          spec_k=k))
        if k > 0:
            plan.gen_spec[t] = k
    return plan


# ---------------------------------------------------------------------------
# Cost model
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TaskCost:
    total: float
    comp: float = 0.0
    tp: float = 0.0
    pp: float = 0.0
    dp: float = 0.0
    hbm: float = 0.0
    bubble: float = 0.0


class CostModel:
    """Estimates per-task and end-to-end iteration time for a plan."""

    def __init__(self, topo: Topology, wf: RLWorkflow,
                 eta: Optional[float] = None,
                 spec_accept_rate: float = 0.7,
                 draft_specs: Optional[Dict[int, LLMSpec]] = None):
        self.topo = topo
        self.wf = wf
        self.eta = eta  # None -> derive task parallelism from the plan
        # speculative-decode operating point: per-token draft accept
        # rate (calibrate from measured gen.spec_accept_rate) and the
        # draft spec per GEN task (default: scaled-down target)
        self.spec_accept_rate = spec_accept_rate
        self.draft_specs = draft_specs or {}

    # -- per-replica micro-batching ------------------------------------
    def _nm_mbs(self, plan: Plan, t: int, i: int) -> Tuple[int, int]:
        local = self.wf.samples_per_iter * plan.replica_fraction(t, i)
        mbs = min(self.wf.micro_batch, max(int(local), 1))
        nm = max(int(math.ceil(local / mbs)), 1)
        return nm, mbs

    def _seq_comm(self) -> int:
        return self.wf.seq_in + self.wf.seq_out

    def _seq_comp(self, task: Task) -> int:
        # actor generation: seq_out := 0 (decode is covered by C_hbm)
        if task.kind == TaskKind.GEN:
            return self.wf.seq_in
        return self.wf.seq_in + self.wf.seq_out

    # -- component costs (Appendix B.2) --------------------------------
    def c_tp(self, plan: Plan, t: int, i: int, j: int) -> float:
        dp, pp, tp = plan.parallel[t]
        if tp == 1:
            return 0.0
        task = self.wf.task(t)
        nm, mbs = self._nm_mbs(plan, t, i)
        cv = BYTES_BF16 * mbs * self._seq_comm() * task.model.h1 \
            * 2 * (tp - 1) / tp
        devs = list(plan.assignment[t][i, j])
        factor = 6 if task.kind == TaskKind.TRAIN else 2
        nl = plan.stage_layers(self.wf, t, j)
        return factor * nm * nl * ring_cost(self.topo, devs, cv)

    def c_pp(self, plan: Plan, t: int, i: int, j: int) -> float:
        dp, pp, tp = plan.parallel[t]
        if j >= pp - 1:
            return 0.0
        task = self.wf.task(t)
        nm, mbs = self._nm_mbs(plan, t, i)
        cv = BYTES_BF16 * mbs * self._seq_comm() * task.model.h1
        cost = pair_min_cost(self.topo, plan.assignment[t][i, j],
                             plan.assignment[t][i, j + 1], cv)
        factor = 2 if task.kind == TaskKind.TRAIN else 1
        return factor * nm * cost

    def c_dp(self, plan: Plan, t: int) -> float:
        task = self.wf.task(t)
        if task.kind != TaskKind.TRAIN:
            return 0.0
        dp, pp, tp = plan.parallel[t]
        if dp == 1:
            return 0.0
        worst = 0.0
        for j in range(pp):
            nl = plan.stage_layers(self.wf, t, j)
            for k in range(tp):
                devs = [int(plan.assignment[t][i, j, k]) for i in range(dp)]
                cv = BYTES_BF16 * nl * task.model.layer_weight_count \
                    * 2 * (dp - 1) / (dp * tp)
                worst = max(worst, ring_cost(self.topo, devs, cv))
        return worst

    def c_comp(self, plan: Plan, t: int, i: int, j: int) -> float:
        task = self.wf.task(t)
        dp, pp, tp = plan.parallel[t]
        nm, mbs = self._nm_mbs(plan, t, i)
        nl = plan.stage_layers(self.wf, t, j)
        fl = flops_per_layer(task, self._seq_comp(task))
        factor = 3 if task.kind == TaskKind.TRAIN else 1
        worst = 0.0
        for k in range(tp):
            d = int(plan.assignment[t][i, j, k])
            worst = max(worst,
                        factor * nm * mbs * nl * fl / (self.topo.comp(d) * tp))
        return worst

    def gen_decode_wave(self, plan: Plan, t: int, i: int = 0) -> int:
        """Decode-wave width the C_hbm term assumes for GEN replica i —
        the bound the genserve engine enforces at execution time."""
        nm, mbs = self._nm_mbs(plan, t, i)
        return decode_wave(nm * mbs)

    def gen_prefill_chunk(self, plan: Plan, t: int, i: int = 0,
                          j: int = 0, chunk: Optional[int] = None,
                          prefix_hit_rate: float = 0.0) -> float:
        """Price of the prefill half of one *mixed wave-step* round for
        GEN replica i, stage j: a fixed-shape ``[W, C]`` prompt chunk
        through the stage's layers (chunked admission never stalls the
        wave, but each round pays this alongside the decode step).

        Compute term: C-token chunk FLOPs for the whole wave — the
        chunk-local attention from ``flops_per_layer`` plus the C x
        resident-cache cross-attention at the mean prefill cursor
        (seq_in / 2).  HBM term: one weight stream per round plus each
        slot's resident KV (or recurrent-state) read, exactly like the
        decode half's roofline.  Total prompt ingestion cost of a
        request is ``ceil(P / C)`` of these rounds, which is what
        ``plan.predicted_occupancy(prefill_rounds=...)`` charges slots
        for.

        ``prefix_hit_rate`` prices paged prefix-cache admission: the
        expected fraction of prompt tokens found cached never runs a
        prefill chunk, so the *amortized* per-round price scales by
        ``(1 - h)`` — the per-request round count shrinks by the same
        factor in :func:`repro.core.plan.prefill_rounds`, and scaling
        here keeps single-round comparisons (benchmark Fig-7 axes)
        honest without re-deriving the round count."""
        task = self.wf.task(t)
        if task.kind != TaskKind.GEN:
            return 0.0
        h = min(max(float(prefix_hit_rate), 0.0), 1.0)
        C = int(chunk) if chunk else PREFILL_CHUNK
        dp, pp, tp = plan.parallel[t]
        nl = plan.stage_layers(self.wf, t, j)
        dbs = self.gen_decode_wave(plan, t, i)
        m = task.model
        fl = flops_per_layer(task, C)
        cache_len = self.wf.seq_in / 2.0       # mean prefill cursor
        if m.attention_free:
            kv_tok, kv_len = 2.0 * _STATE_DIM * m.h1 * BYTES_BF16, 1.0
        else:
            fl += 2 * 2 * C * cache_len * m.h1     # cache cross-attention
            kv_dim = (m.n_kv_heads * m.head_dim
                      if m.n_kv_heads and m.head_dim else m.h1)
            kv_tok, kv_len = 2.0 * kv_dim * BYTES_BF16, cache_len
        worst = 0.0
        for k in range(tp):
            d = int(plan.assignment[t][i, j, k])
            comp = dbs * nl * fl / (self.topo.comp(d) * tp)
            weights = BYTES_BF16 * nl * m.layer_active_count \
                / (self.topo.hbm(d) * tp)
            kv = dbs * nl * kv_tok * kv_len / (self.topo.hbm(d) * tp)
            worst = max(worst, comp + weights + kv)
        return worst * (1.0 - h)

    def gen_wave_occupancy(self, plan: Plan, t: int) -> float:
        """Predicted mean decode-slot occupancy for GEN task t,
        aggregated over dp replicas (total requests / total waves, since
        every wave decodes the same seq_out under the cost model) —
        comparable against the measured slot-table trace of
        ``repro.genserve`` (cost-model parity on the decode-wave axis)."""
        task = self.wf.task(t)
        if task.kind != TaskKind.GEN:
            return 0.0
        dp, _, _ = plan.parallel[t]
        requests, waves = 0.0, 0.0
        for i in range(dp):
            nm, mbs = self._nm_mbs(plan, t, i)
            n = max(nm * mbs, 1)
            requests += n
            waves += math.ceil(n / MAX_DECODE_WAVE)
        return requests / max(waves, 1.0)

    def c_hbm(self, plan: Plan, t: int, i: int, j: int) -> float:
        """Decode HBM roofline priced the way the wave actually executes
        (flash-decode over a batched wave):

          * weights stream once per *wave* step, amortized over the
            ``dbs`` occupied slots — ``n / dbs`` waves of ``seq_out``
            steps each;
          * each occupied slot additionally reads its own KV cache every
            step — KV bytes do NOT amortize across the wave (``n *
            seq_out`` slot-steps at mean cache length ``seq_in +
            seq_out / 2``); attention-free models read a fixed-size
            recurrent state instead (O(1) in sequence length).
        """
        task = self.wf.task(t)
        if task.kind != TaskKind.GEN:
            return 0.0
        m = task.model
        dp, pp, tp = plan.parallel[t]
        nm, mbs = self._nm_mbs(plan, t, i)
        nl = plan.stage_layers(self.wf, t, j)
        dbs = self.gen_decode_wave(plan, t, i)  # bounded-wave batching
        n = nm * mbs
        if m.attention_free:
            # recurrent state read+write per layer-step (matches the
            # h1 x 64 state the flops model assumes), length-independent
            kv_tok, kv_len = 2.0 * _STATE_DIM * m.h1 * BYTES_BF16, 1.0
        else:
            # k + v per layer-token: GQA stores n_kv_heads * head_dim
            # channels (the flash-decode kernel reads KV heads only);
            # h1 fallback when the spec has no head geometry
            kv_dim = (m.n_kv_heads * m.head_dim
                      if m.n_kv_heads and m.head_dim else m.h1)
            kv_tok = 2.0 * kv_dim * BYTES_BF16
            kv_len = self.wf.seq_in + self.wf.seq_out / 2.0
        worst = 0.0
        for k in range(tp):
            d = int(plan.assignment[t][i, j, k])
            weights = self.wf.seq_out * n * BYTES_BF16 * nl \
                * m.layer_active_count / (dbs * self.topo.hbm(d) * tp)
            kv = self.wf.seq_out * n * nl * kv_tok * kv_len \
                / (self.topo.hbm(d) * tp)
            worst = max(worst, weights + kv)
        return worst

    def gen_speculative_wave(self, plan: Plan, t: int, i: int = 0,
                             j: int = 0, *, spec_k: Optional[int] = None,
                             accept_rate: Optional[float] = None,
                             draft: Optional[LLMSpec] = None) -> float:
        """Decode cost of GEN replica i / stage j under draft-model
        speculative decoding — the drop-in replacement for ``c_hbm``
        when ``plan.gen_spec[t] > 0``.

        One draft/verify round emits ``E = (1 - a^(k+1)) / (1 - a)``
        tokens in expectation (per-token accept rate ``a``), so a slot
        needs ``seq_out / E`` rounds instead of ``seq_out`` sequential
        decode steps.  Per round, per tp shard:

          * k+1 draft decode steps (k proposals plus the trailing step
            that lands d_k's draft k/v for the bonus-token case) — the
            draft's weight stream and its (small) per-slot KV read, HBM
            roofline like ``c_hbm``, plus its (tiny) decode FLOPs;
          * ONE target step over the ``[W, k+1]`` candidate chunk —
            target weights stream once (the amortization that buys the
            speedup), the resident KV is read once, and the chunk pays
            (k+1)-token FLOPs including cache cross-attention (priced
            like ``gen_prefill_chunk``'s chunk compute).

        Draft terms scale by ``nl / n_layers`` so a pp-split target
        charges the (replicated, unsplit) draft exactly once across its
        stages.  Attention-free targets cannot run the verify step
        (``cache.supports_speculative_target``) and fall back to
        ``c_hbm``."""
        task = self.wf.task(t)
        if task.kind != TaskKind.GEN:
            return 0.0
        m = task.model
        k = int(spec_k if spec_k is not None else plan.gen_spec.get(t, 0))
        if k <= 0 or m.attention_free:
            return self.c_hbm(plan, t, i, j)
        a = float(accept_rate if accept_rate is not None
                  else self.spec_accept_rate)
        d = draft or self.draft_specs.get(t) or default_draft_spec(m)
        E = speculative_expected_tokens(k, a)
        dp, pp, tp = plan.parallel[t]
        nm, mbs = self._nm_mbs(plan, t, i)
        nl = plan.stage_layers(self.wf, t, j)
        dbs = self.gen_decode_wave(plan, t, i)
        n = nm * mbs
        rounds = self.wf.seq_out * n / (dbs * E)   # waves x rounds/wave
        kv_len = self.wf.seq_in + self.wf.seq_out / 2.0
        kv_dim = (m.n_kv_heads * m.head_dim
                  if m.n_kv_heads and m.head_dim else m.h1)
        dkv_dim = (d.n_kv_heads * d.head_dim
                   if d.n_kv_heads and d.head_dim else d.h1)
        # draft replicated alongside each target stage: charge its cost
        # proportionally so the stage sum pays the full draft once
        dnl = d.n_layers * nl / max(m.n_layers, 1)
        fl_chunk = model_flops_per_layer(m, k + 1) \
            + 2 * 2 * (k + 1) * kv_len * m.h1      # cache cross-attention
        dfl = model_flops_per_layer(d, 1) + 2 * 2 * kv_len * d.h1
        worst = 0.0
        for s in range(tp):
            dev = int(plan.assignment[t][i, j, s])
            hbm, comp = self.topo.hbm(dev), self.topo.comp(dev)
            tgt_w = BYTES_BF16 * nl * m.layer_active_count / (hbm * tp)
            tgt_kv = dbs * nl * 2.0 * kv_dim * BYTES_BF16 * kv_len \
                / (hbm * tp)
            tgt_c = dbs * nl * fl_chunk / (comp * tp)
            drf_w = (k + 1) * BYTES_BF16 * dnl * d.layer_active_count \
                / (hbm * tp)
            drf_kv = (k + 1) * dbs * dnl * 2.0 * dkv_dim * BYTES_BF16 \
                * kv_len / (hbm * tp)
            drf_c = (k + 1) * dbs * dnl * dfl / (comp * tp)
            worst = max(worst, tgt_w + tgt_kv + tgt_c
                        + drf_w + drf_kv + drf_c)
        return rounds * worst

    def c_bubble(self, plan: Plan, t: int, i: int) -> float:
        task = self.wf.task(t)
        if task.kind != TaskKind.TRAIN:
            return 0.0
        dp, pp, tp = plan.parallel[t]
        if pp == 1:
            return 0.0
        nm, _ = self._nm_mbs(plan, t, i)
        tot = 0.0
        for j in range(1, pp):
            tot += (self.c_comp(plan, t, i, j) + self.c_tp(plan, t, i, j)
                    + self.c_pp(plan, t, i, j))
        return tot / nm

    # -- task-level (Appendix B.3) --------------------------------------
    def task_cost(self, plan: Plan, t: int) -> TaskCost:
        task = self.wf.task(t)
        dp, pp, tp = plan.parallel[t]
        worst_total = 0.0
        agg = TaskCost(0.0)
        for i in range(dp):
            stage_max = 0.0
            for j in range(pp):
                comp = self.c_comp(plan, t, i, j)
                ctp = self.c_tp(plan, t, i, j)
                cpp = self.c_pp(plan, t, i, j)
                if plan.gen_spec.get(t, 0) > 0:
                    chbm = self.gen_speculative_wave(plan, t, i, j)
                else:
                    chbm = self.c_hbm(plan, t, i, j)
                s = comp + ctp + cpp + chbm
                if s > stage_max:
                    stage_max = s
                    agg.comp, agg.tp, agg.pp, agg.hbm = comp, ctp, cpp, chbm
            bub = self.c_bubble(plan, t, i)
            total_i = stage_max + bub
            if total_i > worst_total:
                worst_total = total_i
                agg.bubble = bub
        cdp = self.c_dp(plan, t)
        agg.dp = cdp
        agg.total = worst_total + cdp
        return agg

    # -- resharding / weight sync (Appendix B.2) ------------------------
    def c_reshard(self, plan: Plan, actor_train: int) -> float:
        t = actor_train
        task = self.wf.task(t)
        dp, pp, tp = plan.parallel[t]
        n_shards = pp * tp
        if n_shards == 1:
            return 0.0
        cv = BYTES_BF16 * task.model.n_layers \
            * task.model.layer_weight_count * (n_shards - 1) / n_shards
        worst = 0.0
        for i in range(dp):
            devs = list(plan.assignment[t][i].reshape(-1))
            worst = max(worst, ring_cost(self.topo, devs, cv))
        return worst

    def c_sync(self, plan: Plan, actor_train: int, actor_gen: int) -> float:
        """all-gather at train + p2p across + broadcast at gen."""
        t, tg = actor_train, actor_gen
        m = self.wf.task(t).model
        full = BYTES_BF16 * m.n_layers * m.layer_weight_count
        # all-gather within the fastest training replica
        dp, pp, tp = plan.parallel[t]
        n_sh = pp * tp
        ag = 0.0
        if n_sh > 1:
            cv = full * (n_sh - 1) / n_sh
            ag = min(ring_cost(self.topo, list(plan.assignment[t][i]
                                               .reshape(-1)), cv)
                     for i in range(dp))
        # p2p train -> gen
        p2p = pair_min_cost(self.topo,
                            plan.assignment[t].reshape(-1),
                            plan.assignment[tg].reshape(-1), full)
        # broadcast within gen replicas (worst replica)
        dpg, ppg, tpg = plan.parallel[tg]
        n_shg = ppg * tpg
        bc = 0.0
        if n_shg * dpg > 1:
            cvb = full * (n_shg - 1) / max(n_shg, 1) if n_shg > 1 else full
            bc = max(ring_cost(self.topo,
                               list(plan.assignment[tg][i].reshape(-1)),
                               max(cvb, full / max(n_shg, 1)))
                     for i in range(dpg))
        return ag + p2p + bc

    # -- end-to-end (Appendix B.4) ---------------------------------------
    def _phi(self, plan: Plan, costs: Dict[int, float]) -> float:
        """Φ over independent tasks: colocated tasks serialize, disjoint
        GPU groups run in parallel (derived η); scalar η override."""
        if self.eta is not None:
            vals = list(costs.values())
            return self.eta * max(vals) + (1 - self.eta) * sum(vals)
        by_group: Dict[Tuple[int, ...], float] = {}
        for t, c in costs.items():
            key = plan.group_of(t).devices
            by_group[key] = by_group.get(key, 0.0) + c
        return max(by_group.values())

    def iteration_cost(self, plan: Plan) -> Dict[str, float]:
        wf = self.wf
        costs = {t: self.task_cost(plan, t).total for t in range(wf.n_tasks)}
        if wf.algorithm == "ppo":
            gen, inf, train = costs[0], \
                self._phi(plan, {1: costs[1], 2: costs[2], 3: costs[3]}), \
                self._phi(plan, {4: costs[4], 5: costs[5]})
            actor_train, actor_gen = 4, 0
        else:  # grpo
            gen = costs[0]
            inf = self._phi(plan, {1: costs[1], 2: costs[2]})
            train = costs[3]
            actor_train, actor_gen = 3, 0
        if wf.synchronous:
            extra = self.c_reshard(plan, actor_train)
            total = gen + inf + train + extra
        else:
            extra = self.c_sync(plan, actor_train, actor_gen)
            total = max(gen, inf + train) + extra
        return {"total": total, "gen": gen, "inf": inf, "train": train,
                "reshard_or_sync": extra,
                "throughput": wf.samples_per_iter / total,
                **{f"task{t}": c for t, c in costs.items()}}

    def cost(self, plan: Plan) -> float:
        return self.iteration_cost(plan)["total"]
