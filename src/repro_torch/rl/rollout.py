"""Actor generation: autoregressive sampling with a KV cache, and the
teacher-forced log-probs of a generated sequence.

Port of ``repro.rl.rollout``.  ``generate`` is the *single-wave* reference
path: prefill the prompt once (``forward(return_cache=True)``), then one
``decode_step`` per new token over the whole batch; every sequence
decodes all ``max_new_tokens`` steps and dead rows are masked, not
retired.  The continuous-batching engine (``repro_torch.genserve``)
produces the same masked outputs when the batch fits one wave.
``sequence_logprobs`` scores the generated part under teacher forcing:
the INF reference forward and the actor's training loss.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.models import sampling
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.obs import trace as obs_trace


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
    logprobs [B, N] and mask [B, N] (float).  Spans (device-timed):
    ``rollout.prefill``, the prompt's forward and first token, then one
    ``rollout.step`` per decode step."""
    B, P = prompts.shape
    N = sampler.max_new_tokens
    with obs_trace.device_span("rollout.prefill", prompts.device):
        out = T.forward(params, cfg, {"tokens": prompts}, return_cache=True,
                        max_cache_len=P + N)
        cache = out["cache"]
        with obs_trace.span("gen.sample"):
            tok, lp = _sample(gen, out["logits"][:, -1], sampler)
            alive = sampling.initial_alive(prompts, sampler.eos_token)
        del out
    toks, lps, alives = [tok], [lp], [alive]
    for _ in range(N - 1):
        with obs_trace.device_span("rollout.step", prompts.device):
            logits, cache = T.decode_step(params, cfg, tok[:, None], cache)
            with obs_trace.span("gen.sample"):
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


def sequence_logprobs(params, cfg: ModelConfig, sequences, gen_start: int,
                      attn_impl: Optional[str] = None):
    """Teacher-forced logprobs of the generated part.  sequences [B, S].

    Returns (logprobs [B, S - gen_start] for tokens at positions
    gen_start..S-1, each predicted from the previous position; the
    forward's output dict).  ``attn_impl`` as in ``T.forward``: the
    training loss passes ``"plain"``, inference keeps the default."""
    out = T.forward(params, cfg, {"tokens": sequences}, attn_impl=attn_impl)
    logits = out["logits"][:, gen_start - 1:-1]
    targets = sequences[:, gen_start:].long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    return torch.gather(logp, -1, targets[..., None])[..., 0], out
