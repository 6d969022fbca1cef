"""Host-side request queue + decode-slot table for continuous batching.

Copy of ``repro.genserve.scheduler`` (the port keeps its own copies of
framework-free modules).  The scheduler owns no device state: it tracks
which request occupies which of the ``wave`` decode slots, admits queued
requests into freed slots (FIFO by default; shortest-job-first when
per-request budgets are known — ``policy="sjf"`` drains short requests
early, which lowers mean completion latency without changing which
tokens each request produces), and records the per-step occupancy trace
that the cost-model parity checks consume.  The decoder
(``genserve.decoder``) drives it: one ``admit``/``install`` batch per
host round when slots are free, retirements after every decode chunk
from the device's ``occupied`` vector (a slot mid-chunked-prefill counts
as occupied until it lands).  Under chunked admission the table
additionally records each mixed sub-round's prefilling-slot count
(``prefill_trace``), keeping both the decode occupancy
(``mean_occupancy`` — prefill-only sub-rounds are explicit zero-decode
entries, not missing ones) and the busy occupancy (``busy_occupancy`` —
decode or prefill work per round) honest against
``core.plan.predicted_occupancy``.

Paged prefix-cache admission (``decoder`` with ``prefix_cache=True``)
adds one more accounting stream: at each admission the decoder matches
the prompt against the radix tree (``genserve.pagepool.RadixCache``),
maps the shared pages into the slot's block table and starts the
prefill cursor *after* the cached prefix — the table records the
skipped tokens via ``record_prefix`` and reports the token
``prefix_hit_rate()`` alongside occupancy, so the benchmark and
``launch/serve.py`` can show how much prefill the cache elided.

Invariants (asserted):
  * a slot is FREE or holds exactly one in-flight request;
  * a request is admitted at most once (FIFO order from the queue);
  * every admitted request is eventually retired — the engine's outer
    loop terminates because each occupied slot emits at least one token
    per decode round and per-request budgets are finite.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

from repro_torch.obs import metrics as obs_metrics

FREE = -1


@dataclasses.dataclass(frozen=True)
class Request:
    """One generation request (prompts are equal-length, padded upstream)."""

    rid: int                     # row in the caller's prompt/output arrays
    max_new_tokens: int          # per-request budget (<= engine-wide cap)


class RequestQueue:
    """Admission queue.  ``policy``:

    * ``"fifo"`` — arrival order (the default; matches the reference
      rollout's request numbering);
    * ``"sjf"``  — shortest-job-first by ``max_new_tokens``, arrival
      order breaking ties (stable), for when budgets are known upfront
      (the ROADMAP non-FIFO admission follow-on).

    ``aging`` (sjf only) bounds starvation: every ``pop`` a passed-over
    request accrues one skip, and once a request has been skipped
    ``aging`` times it jumps ahead of every shorter newcomer (starved
    requests drain in arrival order).  ``aging=0`` (default) disables
    the knob and reproduces the pure static shortest-first order.
    """

    def __init__(self, requests: Sequence[Request], policy: str = "fifo",
                 aging: int = 0):
        assert policy in ("fifo", "sjf"), policy
        assert aging >= 0
        self.policy = policy
        self.aging = aging
        # [arrival order, skip count, request] per pending request, kept
        # in the static policy order (sjf: shortest-first, stable)
        self._pending: List[List] = [[i, 0, r]
                                     for i, r in enumerate(requests)]
        if policy == "sjf":
            self._pending.sort(key=lambda e: (e[2].max_new_tokens, e[0]))

    def __len__(self) -> int:
        return len(self._pending)

    def pop(self, n: int) -> List[Request]:
        n = min(n, len(self._pending))
        if n == 0:
            return []
        if self.policy == "sjf" and self.aging > 0:
            # starved requests (skips >= aging) first, in arrival order;
            # the rest keep shortest-first order.  Selection is dynamic
            # so a request's skip count can promote it between pops.
            starved = sorted((e for e in self._pending
                              if e[1] >= self.aging), key=lambda e: e[0])
            rest = [e for e in self._pending if e[1] < self.aging]
            order = starved + rest
            take = order[:n]
            if len(order) > n:
                obs_metrics.counter("gen.sjf_skips").inc(len(order) - n)
            aged = sum(1 for e in take if e[1] >= self.aging)
            if aged:
                obs_metrics.counter("gen.sjf_aged_admissions").inc(aged)
            for e in order[n:]:
                e[1] += 1
            taken = {id(e) for e in take}
            self._pending = [e for e in self._pending
                             if id(e) not in taken]
        else:
            take, self._pending = self._pending[:n], self._pending[n:]
        return [e[2] for e in take]

    def push(self, request: Request) -> None:
        """Re-admit a request (slot-failure requeue).  It rejoins with a
        fresh arrival number — after everything currently pending under
        fifo, in budget order under sjf (stable re-sort)."""
        order = (self._pending[-1][0] + 1) if self._pending else 0
        self._pending.append([order, 0, request])
        if self.policy == "sjf":
            self._pending.sort(key=lambda e: (e[2].max_new_tokens, e[0]))

    def cancel(self, rid: int) -> bool:
        """Drop a pending request by id; True if it was queued."""
        before = len(self._pending)
        self._pending = [e for e in self._pending if e[2].rid != rid]
        return len(self._pending) != before


class SlotTable:
    """Tracks occupancy of the ``wave`` decode slots + engine statistics."""

    def __init__(self, wave: int):
        assert wave >= 1
        self.wave = wave
        self.slot_req: List[int] = [FREE] * wave
        self.admitted = 0
        self.retired = 0
        self.requeued = 0                      # slot-failure re-admissions
        self.cancelled = 0                     # explicit cancels
        self.occupancy_trace: List[int] = []   # active slots per decode step
        self.prefill_trace: List[int] = []     # prefilling slots per mixed
        #                                        round (chunked admission)
        self.prefix_hit_tokens = 0             # prompt tokens served from
        self.prompt_tokens = 0                 # the prefix cache / admitted

    # -- state ----------------------------------------------------------
    @property
    def active(self) -> int:
        return sum(1 for r in self.slot_req if r != FREE)

    def free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_req) if r == FREE]

    # -- transitions ----------------------------------------------------
    def admit(self, slots: Sequence[int], requests: Sequence[Request]) -> None:
        assert len(slots) == len(requests)
        for s, req in zip(slots, requests):
            assert self.slot_req[s] == FREE, f"slot {s} already occupied"
            self.slot_req[s] = req.rid
            self.admitted += 1

    def fail_slot(self, s: int) -> int:
        """A decode slot died mid-flight: free it and return the request
        id that was in it (FREE if it was empty).  The caller owns page
        decref + requeue; this only fixes the table's books."""
        rid = self.slot_req[s]
        if rid != FREE:
            self.slot_req[s] = FREE
            self.requeued += 1
            obs_metrics.counter("gen.slot_failures").inc()
        return rid

    def cancel_slot(self, s: int) -> int:
        """Explicitly retire a slot's request without EOS/budget: free
        the slot, count the cancel, return the evicted request id."""
        rid = self.slot_req[s]
        if rid != FREE:
            self.slot_req[s] = FREE
            self.retired += 1
            self.cancelled += 1
            obs_metrics.counter("gen.cancelled").inc()
        return rid

    def retire_finished(self, occupied: np.ndarray) -> List[int]:
        """Reconcile with the device's occupied vector after a decode
        round; returns the request ids that finished this round."""
        done = []
        for s in range(self.wave):
            if self.slot_req[s] != FREE and not bool(occupied[s]):
                done.append(self.slot_req[s])
                self.slot_req[s] = FREE
                self.retired += 1
        return done

    # -- statistics -----------------------------------------------------
    def record_step(self, active_counts: Sequence[int]) -> None:
        """Pure decode rounds: one trace entry per wave decode step."""
        self.occupancy_trace.extend(int(c) for c in active_counts)

    def record_round(self, decode_counts: Sequence[int],
                     prefill_counts: Sequence[int]) -> None:
        """Mixed wave-step round (chunked admission): records each
        sub-round's decode count *and* prefill count explicitly, so a
        prefill-only sub-round shows up as zero decode progress instead
        of silently not existing — this keeps ``mean_occupancy`` vs the
        cost model's ``predicted_occupancy`` an honest comparison under
        mixed rounds (and ``busy_occupancy`` credits the prefill
        work)."""
        assert len(decode_counts) == len(prefill_counts)
        self.occupancy_trace.extend(int(c) for c in decode_counts)
        self.prefill_trace.extend(int(c) for c in prefill_counts)

    def record_prefix(self, hit_tokens: int, prompt_tokens: int) -> None:
        """One admission's prefix-cache outcome: ``hit_tokens`` of the
        ``prompt_tokens``-token prompt were found cached (prefill starts
        after them).  Zero hits are recorded too — the denominator must
        cover every admission or the rate flatters the cache."""
        assert 0 <= hit_tokens < max(prompt_tokens, 1)
        self.prefix_hit_tokens += int(hit_tokens)
        self.prompt_tokens += int(prompt_tokens)

    def prefix_hit_rate(self) -> float:
        """Fraction of admitted prompt tokens served from the prefix
        cache (0.0 when prefix caching is off or nothing was
        admitted)."""
        if self.prompt_tokens == 0:
            return 0.0
        return self.prefix_hit_tokens / self.prompt_tokens

    @property
    def decode_steps(self) -> int:
        """Device rounds with a decode half (every round under mixed
        wave-stepping — prefill-only rounds count, with zero decode)."""
        return len(self.occupancy_trace)

    @property
    def slot_steps(self) -> int:
        return int(sum(self.occupancy_trace))

    @property
    def prefill_rounds(self) -> int:
        return len(self.prefill_trace)

    @property
    def prefill_slot_steps(self) -> int:
        """Total per-slot prefill-chunk executions across mixed rounds."""
        return int(sum(self.prefill_trace))

    def mean_occupancy(self) -> float:
        if not self.occupancy_trace:
            return 0.0
        return self.slot_steps / self.decode_steps

    def busy_occupancy(self) -> float:
        """Mean slots doing *any* work (decode step or prefill chunk)
        per device round — the occupancy figure comparable against
        ``core.plan.predicted_occupancy(..., prefill_rounds=...)``,
        which prices admission instead of assuming it free."""
        if not self.occupancy_trace:
            return 0.0
        return (self.slot_steps + self.prefill_slot_steps) \
            / self.decode_steps
