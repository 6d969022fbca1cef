"""Shared token-sampling and EOS/aliveness helpers.

Port of ``repro.models.sampling``.  Randomness comes from an explicit
``torch.Generator``; it cannot reproduce the JAX package's threefry
streams, so sampled modes (speculative rejection resampling included)
are held to the reference by distribution, and greedy decoding
(``argmax``, first maximum on ties, as ``jnp.argmax``) token for token.

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


def speculative_accept(gen: Optional[torch.Generator], target_logits,
                       drafts, draft_logits, *, temperature: float = 1.0,
                       greedy: bool = False):
    """Batched draft-token acceptance for speculative decoding.

    target_logits: [B, k+1, V], one target step over the candidate chunk
      [t0, d_1..d_k] (position j scores the token after [t0, d_1..d_j]);
    drafts: [B, k] — the proposals d_1..d_k;
    draft_logits: [B, k, V] — the distributions they were sampled from
      (unused on the greedy path).

    Returns (accept_len [B] in [0, k], cand [B, k+1]): cand[:, j] ==
    d_{j+1} for j < accept_len, and cand[:, accept_len] is the bonus /
    corrected token t* — greedy: the target argmax at the first mismatch
    (or after all k accepts); sampled: rejection resampling (accept d_j
    iff u_j < p_j(d_j) / q_j(d_j); on rejection t* is drawn from the
    residual ``max(p - q, 0)``, after all k accepts from p itself), so
    the emitted tokens follow the target's distribution exactly.  The
    uniforms, then t*, are drawn from ``gen``."""
    B, k1, V = target_logits.shape
    k = k1 - 1
    dev = target_logits.device
    tl = target_logits.float()
    if greedy or temperature <= 0:
        tgt = torch.argmax(tl, dim=-1)                          # [B, k+1]
        match = drafts == tgt[:, :k]
        a = torch.cumprod(match.to(torch.int64), dim=1).sum(dim=1)
        tstar = tgt.gather(1, a[:, None])[:, 0]
    else:
        p = torch.softmax(tl / temperature, dim=-1)             # [B,k+1,V]
        q = torch.softmax(draft_logits.float() / temperature, dim=-1)
        p_d = p[:, :k].gather(-1, drafts[..., None])[..., 0]     # [B, k]
        q_d = q.gather(-1, drafts[..., None])[..., 0]
        u = torch.rand((B, k), generator=gen, device=dev)
        ok = u * q_d.clamp(min=1e-30) < p_d
        a = torch.cumprod(ok.to(torch.int64), dim=1).sum(dim=1)
        # residual at the rejection point; q is padded with zeros at
        # position k so the all-accepted bonus draw is from p_k itself
        q_ext = torch.cat([q, torch.zeros((B, 1, V), device=dev)], dim=1)
        at = a[:, None, None].expand(B, 1, V)
        p_a = p.gather(1, at)[:, 0]
        q_a = q_ext.gather(1, at)[:, 0]
        resid = (p_a - q_a).clamp(min=0.0)
        # a degenerate residual (p <= q everywhere although a rejection
        # fired, numerically possible) falls back to the target
        resid = torch.where(resid.sum(dim=-1, keepdim=True) > 0.0, resid,
                            p_a)
        tstar = torch.multinomial(resid, 1, generator=gen)[:, 0]
    drafts_ext = torch.cat(
        [drafts, torch.zeros((B, 1), dtype=drafts.dtype, device=dev)], dim=1)
    cand = torch.where(torch.arange(k1, device=dev)[None, :] < a[:, None],
                       drafts_ext, tstar[:, None].to(drafts.dtype))
    return a, cand


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
