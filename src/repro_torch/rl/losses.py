"""PPO / GRPO objectives (paper §3.3 PPO formulation).

Port of ``repro.rl.losses``.
"""
from __future__ import annotations

from typing import Dict

import torch


def ppo_policy_loss(logp_new, logp_old, advantages, mask, *,
                    clip_eps: float = 0.2) -> Dict[str, torch.Tensor]:
    """Clipped surrogate. All inputs [B, T] (per generated token)."""
    ratio = torch.exp(logp_new - logp_old)
    unclipped = ratio * advantages
    clipped = torch.clamp(ratio, 1 - clip_eps, 1 + clip_eps) * advantages
    per_tok = -torch.minimum(unclipped, clipped)
    n = torch.clamp(mask.sum(), min=1.0)
    loss = (per_tok * mask).sum() / n
    clip_frac = (((ratio - 1).abs() > clip_eps) * mask).sum() / n
    approx_kl = ((logp_old - logp_new) * mask).sum() / n
    return {"loss": loss, "clip_frac": clip_frac, "approx_kl": approx_kl,
            "ratio_mean": (ratio * mask).sum() / n}


def value_loss(values_new, values_old, returns, mask, *,
               clip_eps: float = 0.2):
    """Clipped value loss (PPO2 style). [B, T]."""
    v_clip = values_old + torch.clamp(values_new - values_old,
                                      -clip_eps, clip_eps)
    l1 = torch.square(values_new - returns)
    l2 = torch.square(v_clip - returns)
    n = torch.clamp(mask.sum(), min=1.0)
    return 0.5 * (torch.maximum(l1, l2) * mask).sum() / n


def entropy_bonus(logits, mask):
    """Mean token entropy over valid positions. logits [B, T, V]."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ent = -(torch.exp(logp) * logp).sum(-1)
    n = torch.clamp(mask.sum(), min=1.0)
    return (ent * mask).sum() / n


def kl_penalised_rewards(score, logp_actor, logp_ref, mask, *,
                         kl_beta: float = 0.02):
    """Token-level rewards: sequence score at the last valid token minus
    per-token KL penalty (paper's r_tau formulation)."""
    kl = logp_actor - logp_ref
    rewards = -kl_beta * kl * mask
    # add the scalar score at each sequence's final valid position
    last = torch.clamp(mask.sum(dim=1).long() - 1, min=0)
    rows = torch.arange(rewards.shape[0], device=rewards.device)
    rewards = rewards.index_put((rows, last), score.to(rewards.dtype),
                                accumulate=True)
    return rewards, (kl * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def gather_logprobs(logits, tokens):
    """log p(tokens) under logits. logits [B,T,V], tokens [B,T]."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return torch.gather(logp, -1, tokens.long()[..., None])[..., 0]
