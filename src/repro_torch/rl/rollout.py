"""Actor generation: autoregressive sampling with a KV cache.

Port of ``repro.rl.rollout`` lines 28-72 — the *single-wave* reference
path: prefill the prompt once (``forward(return_cache=True)``), then one
``decode_step`` per new token over the whole batch; every sequence
decodes all ``max_new_tokens`` steps and dead rows are masked, not
retired.  The continuous-batching engine (``repro_torch.genserve``)
produces the same masked outputs when the batch fits one wave.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.models import sampling
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    max_new_tokens: int = 16
    temperature: float = 1.0
    eos_token: Optional[int] = None
    greedy: bool = False


def _sample(gen, logits, cfg: SamplerConfig):
    return sampling.sample_with_logprobs(
        gen, logits, temperature=cfg.temperature, greedy=cfg.greedy)


def generate(params, cfg: ModelConfig, prompts, gen: Optional[torch.Generator],
             sampler: SamplerConfig) -> Dict[str, torch.Tensor]:
    """prompts: [B, P] int.  Returns sequences [B, P+N], gen_tokens [B, N],
    logprobs [B, N] and mask [B, N] (float)."""
    B, P = prompts.shape
    N = sampler.max_new_tokens
    out = T.forward(params, cfg, {"tokens": prompts}, return_cache=True,
                    max_cache_len=P + N)
    cache = out["cache"]
    tok, lp = _sample(gen, out["logits"][:, -1], sampler)
    del out
    alive = sampling.initial_alive(prompts, sampler.eos_token)
    toks, lps, alives = [tok], [lp], [alive]
    for _ in range(N - 1):
        logits, cache = T.decode_step(params, cfg, tok[:, None], cache)
        nxt, lp = _sample(gen, logits, sampler)
        alive = sampling.next_alive(alive, tok, sampler.eos_token)
        tok = nxt
        toks.append(nxt)
        lps.append(lp)
        alives.append(alive)
    gen_tokens = torch.stack(toks, dim=1)
    return {"sequences": torch.cat([prompts, gen_tokens], dim=1),
            "gen_tokens": gen_tokens,
            "logprobs": torch.stack(lps, dim=1),
            "mask": torch.stack(alives, dim=1).float()}
