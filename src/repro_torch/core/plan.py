"""Decode-wave sizing and the continuous-batching occupancy model.

The part of ``repro.core.plan`` the serving path reads: the wave cap a
generation replica decodes in, and the ideal mean wave occupancy the
measured slot-table trace is compared against.  The port keeps its own
copy (``repro.core.plan`` lines 28-119); the scheduler and cost model
stay in the JAX package until the trainer is ported.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

# generation engines (vLLM-style continuous batching) decode in waves of at
# most this many sequences per replica; bounds KV working memory and C_hbm.
MAX_DECODE_WAVE = 32


def decode_wave(local_batch: float) -> int:
    return max(min(int(local_batch), MAX_DECODE_WAVE), 1)


def prefill_rounds(prompt_len: int, prefill_chunk: int,
                   prefix_hit_rate: float = 0.0) -> int:
    """Mixed wave-step rounds a request's prompt ingestion occupies a
    decode slot for under chunked admission (0 = one-shot admission,
    which the occupancy model prices as free).

    ``prefix_hit_rate`` is the expected fraction of prompt tokens served
    from the paged prefix cache (genserve ``prefix_cache=True``): only
    the uncached suffix is prefilled, floored at one round — even a
    fully cached prompt runs its landing chunk (the hit is capped at
    plen-1 so first-token logits come from a real forward pass)."""
    if prefill_chunk <= 0:
        return 0
    h = min(max(float(prefix_hit_rate), 0.0), 1.0)
    suffix = max(int(prompt_len), 1) * (1.0 - h)
    return max(math.ceil(suffix / int(prefill_chunk)), 1)


def predicted_occupancy(n_requests: float,
                        wave: Optional[int] = None,
                        gen_lens: Optional[Sequence[int]] = None,
                        prefill_rounds: float = 0.0,
                        max_new_tokens: Optional[int] = None,
                        prefix_hit_rate: float = 0.0) -> float:
    """Predicted mean decode-slot occupancy under continuous batching.

    This is the occupancy the cost model's ``C_hbm`` wave term assumes
    and the number the genserve engine's measured slot-table trace is
    compared against (Fig-7 style parity, decode-wave axis).

    With uniform generation lengths every wave is full except the last
    partial one: occupancy = n / ceil(n / W).  Given per-request lengths,
    ideal continuous batching is bounded by the longest request and by
    total work: steps >= max(max_len, ceil(sum_len / W)), and occupancy
    is total tokens over that lower bound.

    ``prefill_rounds`` > 0 prices *chunked admission* instead of
    assuming prompt ingestion free: each request additionally occupies a
    slot for that many mixed wave-step rounds before its first token
    (see :func:`prefill_rounds`), the work bound grows accordingly, and
    the returned figure is the *busy* occupancy (slots doing a decode
    step or a prefill chunk per round) — comparable against the slot
    table's ``busy_occupancy()``.  A scalar applies to every request;
    a sequence gives per-request rounds (aligned with ``gen_lens`` —
    required for the chain bound to stay a true upper bound under
    heterogeneous prompt lengths).  Uniform lengths then need
    ``max_new_tokens`` (the per-request decode length).

    ``prefix_hit_rate`` scales the admission price for paged
    prefix-cache serving: each request's prefill rounds shrink to the
    expected uncached fraction ``(1 - h)``, floored at one round per
    admitted request (the landing chunk always runs)."""
    W = wave if wave is not None else MAX_DECODE_WAVE
    W = max(int(W), 1)
    n = max(float(n_requests), 1.0)
    scalar_c = not hasattr(prefill_rounds, "__len__")
    if scalar_c and max(float(prefill_rounds), 0.0) == 0.0 \
            and gen_lens is None:
        return n / math.ceil(n / W)
    if gen_lens is None:
        assert max_new_tokens is not None, \
            "uniform-length occupancy with prefill rounds needs " \
            "max_new_tokens"
        lens = [max(int(max_new_tokens), 1)] * int(n)
    else:
        lens = [max(int(l), 1) for l in gen_lens]
    if scalar_c:
        cs = [max(float(prefill_rounds), 0.0)] * len(lens)
    else:
        cs = [max(float(c), 0.0) for c in prefill_rounds]
        assert len(cs) == len(lens), \
            "per-request prefill_rounds must align with gen_lens"
    h = min(max(float(prefix_hit_rate), 0.0), 1.0)
    if h > 0.0:
        cs = [max(c * (1.0 - h), 1.0) if c > 0.0 else 0.0 for c in cs]
    total = sum(lens) + sum(cs)
    chain = max(l + c for l, c in zip(lens, cs))
    steps = max(chain, math.ceil(total / W))
    return total / steps
