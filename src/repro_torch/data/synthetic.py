"""Synthetic RL task + data pipeline (numpy).

Port of the numpy part of ``repro.data.synthetic``: integer addition.
Prompts are "a+b=" over a small digit vocabulary; the programmatic
reward scores generated completions by digit-level correctness of the
sum (1.0 for exact, partial credit per digit).  Prompts drawn from the
same seed are identical to the reference's.  ``random_lm_batch`` (the
LM mode's random-token stream) is not yet ported.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Tuple

import numpy as np

# vocabulary: 0-9 digits, '+', '=', PAD, BOS, EOS
PAD, BOS, EOS, PLUS, EQ = 10, 11, 12, 13, 14
VOCAB_SIZE = 16


def encode_number(n: int) -> List[int]:
    return [int(c) for c in str(n)]


@dataclasses.dataclass
class AdditionTask:
    max_operand: int = 99
    seed: int = 0

    @property
    def prompt_len(self) -> int:
        return 2 * len(str(self.max_operand)) + 3  # BOS a + b =

    @property
    def max_answer_len(self) -> int:
        return len(str(2 * self.max_operand)) + 1  # digits + EOS

    def sample_batch(self, rng: np.random.Generator,
                     batch: int) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (prompts [B, P] int32 padded-left, answers list)."""
        P = self.prompt_len
        prompts = np.full((batch, P), PAD, np.int32)
        answers = np.zeros(batch, np.int64)
        for i in range(batch):
            a = int(rng.integers(0, self.max_operand + 1))
            b = int(rng.integers(0, self.max_operand + 1))
            toks = [BOS] + encode_number(a) + [PLUS] + encode_number(b) + [EQ]
            prompts[i, -len(toks):] = toks
            answers[i] = a + b
        return prompts, answers

    def reward(self, answer: int, generated: np.ndarray) -> float:
        """Digit-level partial credit; 1.0 iff exact answer then EOS."""
        want = encode_number(int(answer)) + [EOS]
        got = list(generated[:len(want)])
        if len(got) < len(want):
            got = got + [PAD] * (len(want) - len(got))
        hits = sum(1 for w, g in zip(want, got) if w == g)
        return hits / len(want)

    def reward_batch(self, answers: np.ndarray,
                     generated: np.ndarray) -> np.ndarray:
        return np.array([self.reward(a, g)
                         for a, g in zip(answers, generated)], np.float32)


class PromptDataset:
    """Iterable prompt stream with epoch shuffling."""

    def __init__(self, task: AdditionTask, batch: int, seed: int = 0):
        self.task = task
        self.batch = batch
        self.rng = np.random.default_rng(seed)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        while True:
            yield self.task.sample_batch(self.rng, self.batch)
