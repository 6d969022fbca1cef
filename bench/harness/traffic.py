"""The one generator of every traffic mix: a mix file's parameters and
``--seed`` in, the unit's inputs out.

Sizes are a fixed set in a fixed order: ``n`` sizes at the midpoints
of ``n`` equal slices of the distribution's quantiles (``fixed_set``),
interleaved by one permutation that no seed changes.  The engine's
schedule follows the sizes alone (greedy, no EOS), so every seed and
every unit does the same work, and the spread between runs is the
system's, not the draw's (a shuffle per seed moved a batch's decode
steps by 3%).  Tokens are drawn from the seed, per unit (an RL
iteration, an engine batch), from ``numpy``'s generator seeded with
(seed, stream, unit).

Distributions: ``{"dist": "uniform" | "loguniform", "lo", "hi"}`` over
whole numbers, both ends included.  Serving prompts are padded on the
left to the mix's ``pad_to``: one-shot admission prefills the whole row
(padding as content) and the response follows the prompt's last real
token.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np


def fixed_set(dist: dict, n: int) -> np.ndarray:
    lo, hi = int(dist["lo"]), int(dist["hi"])
    q = (np.arange(n) + 0.5) / n
    if dist["dist"] == "uniform":
        v = lo + np.floor(q * (hi - lo + 1))
    elif dist["dist"] == "loguniform":
        v = np.round(np.exp(math.log(lo) + q * (math.log(hi) - math.log(lo))))
    else:
        raise ValueError(f"unknown distribution {dist['dist']!r}")
    return np.clip(v, lo, hi).astype(np.int64)


def rng(seed: int, unit: int, stream: int = 0) -> np.random.Generator:
    """The draws of one unit; ``stream`` keeps apart what is not a unit's
    feed (the warm-up batch 1, the checked sample 2, the sizes' order
    3)."""
    return np.random.default_rng([int(seed) % (1 << 64), stream, unit])


@dataclasses.dataclass
class GenBatch:
    prompts: np.ndarray       # [n, pad_to] int64, left-padded
    prompt_lens: np.ndarray   # [n] real prompt tokens (last of each row)
    gen_lens: np.ndarray      # [n] response budgets
    max_new_tokens: int       # the engine's output width (the mix's hi)


def gen_batch(mix: dict, vocab: int, seed: int, unit: int) -> GenBatch:
    n, P = int(mix["requests"]), int(mix["pad_to"])
    order = rng(0, 0, stream=3)
    plens = order.permutation(fixed_set(mix["prompt_len"], n))
    glens = order.permutation(fixed_set(mix["gen_len"], n))
    g = rng(seed, unit)
    prompts = np.full((n, P), int(mix["pad_token"]), np.int64)
    toks = g.integers(1, vocab, size=(n, P))
    for i, p in enumerate(plens):
        prompts[i, P - p:] = toks[i, P - p:]
    return GenBatch(prompts, plens, glens, int(mix["gen_len"]["hi"]))


def warm_batch(mix: dict, vocab: int, seed: int) -> GenBatch:
    """One request more than the wave, budgets of 2 and 9 tokens, at the
    mix's shapes: both engine programs (the [wave, pad_to] admission and
    the wave decode over the full cache) run once, recycling included."""
    W, P = int(mix["wave"]), int(mix["pad_to"])
    n = W + 1
    g = rng(seed, 0, stream=1)
    prompts = g.integers(1, vocab, size=(n, P)).astype(np.int64)
    glens = np.full((n,), 2, np.int64)
    glens[-1] = 9
    return GenBatch(prompts, np.full((n,), P, np.int64), glens,
                    int(mix["gen_len"]["hi"]))


@dataclasses.dataclass
class RLBatch:
    prompts: np.ndarray       # [prompts, prompt_len] int64
    answers: np.ndarray       # [prompts] the reward rule's target per prompt


def rl_batch(mix: dict, vocab: int, seed: int, unit: int) -> RLBatch:
    """Prompt tokens never hold EOS (ids above it), so every response
    starts alive; answers are residue classes of the reward rule."""
    g = rng(seed, unit)
    n, P = int(mix["prompts"]), int(mix["prompt_len"])
    prompts = g.integers(int(mix["eos_token"]) + 1, vocab, size=(n, P))
    answers = g.integers(0, int(mix["reward"]["classes"]), size=(n,))
    return RLBatch(prompts.astype(np.int64), answers.astype(np.int64))
