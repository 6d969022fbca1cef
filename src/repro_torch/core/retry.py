"""Bounded retry with exponential backoff.

Shared by the engine's per-task execution path (transient task crashes
injected by ``repro_torch.faults`` or raised by real runtime failures) and by
elastic checkpointing (flaky filesystem writes).  Policy semantics:

- ``TransientError`` (or any type listed in ``retry_on``) is retried up
  to ``max_attempts`` total attempts with exponential backoff;
- ``PermanentError`` is never retried — it propagates immediately so the
  caller can escalate (drop the device, force a replan);
- exhausting the budget raises ``RetryExhausted`` chaining the last
  transient cause.

Backoff sleeps are injectable (``sleep=``) so tests and the simulator-
clocked engine never block wall time.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional, Tuple, Type


class TransientError(Exception):
    """A failure that is expected to succeed on retry."""


class PermanentError(Exception):
    """A failure retrying cannot fix; escalate instead."""


class RetryExhausted(Exception):
    """All ``max_attempts`` attempts failed with transient errors."""

    def __init__(self, attempts: int, last: BaseException):
        super().__init__(
            f"retry exhausted after {attempts} attempts: {last!r}")
        self.attempts = attempts
        self.last = last


@dataclass(frozen=True)
class RetryPolicy:
    max_attempts: int = 3
    base_delay_s: float = 0.05
    factor: float = 2.0
    max_delay_s: float = 2.0

    def delay(self, attempt: int) -> float:
        """Backoff before attempt ``attempt+1`` (attempts are 0-based)."""
        return min(self.base_delay_s * (self.factor ** attempt),
                   self.max_delay_s)


def retry_call(fn: Callable[[int], object], *,
               policy: RetryPolicy = RetryPolicy(),
               retry_on: Tuple[Type[BaseException], ...] = (TransientError,),
               on_retry: Optional[Callable[[int, BaseException], None]] = None,
               sleep: Callable[[float], None] = time.sleep):
    """Call ``fn(attempt)`` until it succeeds or the policy is exhausted.

    ``fn`` receives the 0-based attempt index (so injectors and loggers
    can key behaviour on it).  ``on_retry(attempt, exc)`` fires after
    each transient failure, before the backoff sleep.
    """
    if policy.max_attempts < 1:
        raise ValueError("max_attempts must be >= 1")
    last: Optional[BaseException] = None
    for attempt in range(policy.max_attempts):
        try:
            return fn(attempt)
        except PermanentError:
            raise
        except retry_on as e:  # noqa: B030 - tuple of types
            last = e
            if on_retry is not None:
                on_retry(attempt, e)
            if attempt + 1 < policy.max_attempts:
                sleep(policy.delay(attempt))
    assert last is not None
    raise RetryExhausted(policy.max_attempts, last) from last
