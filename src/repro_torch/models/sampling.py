"""Shared token-sampling and EOS/aliveness helpers.

Port of ``repro.models.sampling`` (lines 22-50, 116-134).  Randomness
comes from an explicit ``torch.Generator``; it cannot reproduce the JAX
package's threefry streams, so sampled modes are held to the reference
by distribution, and greedy decoding (``argmax``, first maximum on
ties, as ``jnp.argmax``) token for token.

Aliveness contract (shared by rollout and genserve):
  * a sequence starts alive unless its prompt already ends with EOS;
  * the first emitted EOS token is itself *valid* (mask 1) — the
    sequence dies after emitting it.
"""
from __future__ import annotations

from typing import Optional

import torch


def sample_tokens(gen: Optional[torch.Generator], logits, *,
                  temperature: float = 1.0, greedy: bool = False):
    """logits [..., V] -> int64 token ids (argmax or categorical)."""
    if greedy or temperature <= 0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    tok = torch.multinomial(flat, 1, generator=gen)[:, 0]
    return tok.reshape(probs.shape[:-1])


def token_logprobs(logits, tokens):
    """Log-probabilities (fp32) of `tokens` [...] under `logits` [..., V]."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return torch.gather(logp, -1, tokens[..., None])[..., 0]


def sample_with_logprobs(gen, logits, *, temperature: float = 1.0,
                         greedy: bool = False):
    """Sample tokens and score them: (tokens, logprobs).  Logprobs are
    the *untempered* model logprobs of the chosen token."""
    tokens = sample_tokens(gen, logits, temperature=temperature,
                           greedy=greedy)
    return tokens, token_logprobs(logits, tokens)


def initial_alive(prompts, eos_token: Optional[int]):
    """[B] bool: alive at generation start (prompt not ending in EOS)."""
    if eos_token is None:
        return torch.ones((prompts.shape[0],), dtype=torch.bool,
                          device=prompts.device)
    return prompts[:, -1] != eos_token


def next_alive(alive, emitted, eos_token: Optional[int]):
    """Aliveness after emitting `emitted` [B]: dies on (its own) EOS."""
    if eos_token is None:
        return alive
    return alive & (emitted != eos_token)
