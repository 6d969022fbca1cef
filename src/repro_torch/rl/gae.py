"""Advantage estimation: GAE (PPO, Schulman et al. 2016) and
group-relative advantages (GRPO, Shao et al. 2024).

Port of ``repro.rl.gae``: the reference's ``lax.scan`` over reversed
time is a reverse loop over T.
"""
from __future__ import annotations

import torch


def gae_advantages(rewards, values, mask, *, gamma: float = 1.0,
                   lam: float = 0.95):
    """rewards, values, mask: [B, T] (mask 0 after EOS).

    values[:, t] = V(s_t); bootstrap value after the last step is 0.
    Returns (advantages [B, T], returns [B, T])."""
    B, T = rewards.shape
    values_next = torch.cat(
        [values[:, 1:], torch.zeros((B, 1), dtype=values.dtype,
                                    device=values.device)], dim=1)
    deltas = rewards + gamma * values_next * mask - values
    carry = torch.zeros((B,), dtype=rewards.dtype, device=rewards.device)
    adv = [None] * T
    for t in range(T - 1, -1, -1):
        carry = deltas[:, t] + gamma * lam * mask[:, t] * carry
        adv[t] = carry
    adv = torch.stack(adv, dim=1) * mask
    returns = adv + values * mask
    return adv, returns


def grpo_advantages(rewards, group_size: int, mask):
    """rewards: [B] sequence-level; groups of `group_size` share a prompt.

    A_i = (r_i - mean_group) / (std_group + eps), broadcast over tokens;
    the population std, as ``jnp.std`` computes it."""
    B = rewards.shape[0]
    g = rewards.reshape(B // group_size, group_size)
    mean = g.mean(dim=1, keepdim=True)
    std = g.std(dim=1, keepdim=True, unbiased=False)
    adv = ((g - mean) / (std + 1e-4)).reshape(B)
    return adv[:, None] * mask


def whiten(adv, mask):
    """Normalize advantages over valid tokens (standard PPO trick)."""
    n = torch.clamp(mask.sum(), min=1.0)
    mean = (adv * mask).sum() / n
    var = (torch.square(adv - mean) * mask).sum() / n
    return (adv - mean) * torch.rsqrt(var + 1e-8) * mask
