"""Host-side request queue + decode-slot table for continuous batching.

Copy of the part of ``repro.genserve.scheduler`` that one-shot FIFO
serving uses.  The scheduler owns no device state: it tracks which
request occupies which of the ``wave`` decode slots, admits queued
requests into freed slots in arrival order, and records the per-step
occupancy trace that the cost-model comparison consumes.  The decoder
(``genserve.decoder``) drives it: one ``admit`` batch per host round
when slots are free, retirements after every decode chunk from the
device's ``occupied`` vector.

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

FREE = -1


@dataclasses.dataclass(frozen=True)
class Request:
    """One generation request (prompts are equal-length, padded upstream)."""

    rid: int                     # row in the caller's prompt/output arrays
    max_new_tokens: int          # per-request budget (<= engine-wide cap)


class RequestQueue:
    """FIFO admission queue (arrival order matches the reference
    rollout's request numbering)."""

    def __init__(self, requests: Sequence[Request]):
        self._pending: List[Request] = list(requests)

    def __len__(self) -> int:
        return len(self._pending)

    def pop(self, n: int) -> List[Request]:
        take, self._pending = self._pending[:n], self._pending[n:]
        return take


class SlotTable:
    """Tracks occupancy of the ``wave`` decode slots + engine statistics."""

    def __init__(self, wave: int):
        assert wave >= 1
        self.wave = wave
        self.slot_req: List[int] = [FREE] * wave
        self.admitted = 0
        self.retired = 0
        self.occupancy_trace: List[int] = []   # active slots per decode step

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
        """One trace entry per wave decode step."""
        self.occupancy_trace.extend(int(c) for c in active_counts)

    @property
    def decode_steps(self) -> int:
        return len(self.occupancy_trace)

    @property
    def slot_steps(self) -> int:
        return int(sum(self.occupancy_trace))

    def mean_occupancy(self) -> float:
        if not self.occupancy_trace:
            return 0.0
        return self.slot_steps / self.decode_steps
