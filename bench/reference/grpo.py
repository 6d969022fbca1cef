"""Plain PyTorch reference of one synchronous GRPO iteration's arithmetic,
after the repro's RL workflow: the aliveness mask, the rule-based reward,
KL-penalised sequence rewards, group-relative advantages whitened over
the valid tokens, the PPO-clip policy loss, the gradient clipped by its
global norm, and Adam with bias correction.  The model's forward is the
family reference's (``hidden`` / ``logits``).  Imports nothing of the
program.
"""
from __future__ import annotations

import torch


def alive_mask(prompt_last: torch.Tensor, gen: torch.Tensor,
               eos: int) -> torch.Tensor:
    """[B, N] float: a token is valid while no earlier token of the
    response was EOS (the first EOS itself is valid), and none is when the
    prompt ends in EOS."""
    alive = prompt_last != eos
    cols = []
    for t in range(gen.shape[1]):
        cols.append(alive)
        alive = alive & (gen[:, t] != eos)
    return torch.stack(cols, 1).float()


def reward(rule: dict, answers: torch.Tensor, gen: torch.Tensor,
           mask: torch.Tensor) -> torch.Tensor:
    """"residue_share": the share of valid response tokens t with
    t mod classes == the prompt's answer."""
    if rule["rule"] != "residue_share":
        raise ValueError(f"unknown reward rule {rule['rule']!r}")
    hit = (gen % rule["classes"] == answers[:, None]).float() * mask
    return hit.sum(1) / mask.sum(1).clamp(min=1.0)


def token_logprobs(logits: torch.Tensor, tokens: torch.Tensor):
    return torch.log_softmax(logits.float(), -1).gather(
        -1, tokens[..., None])[..., 0]


def advantages(scores, lp_old, lp_ref, mask, group: int, kl_beta: float,
               whiten: bool):
    """Sequence reward = score - kl_beta * sum of (lp_old - lp_ref) over
    the valid tokens; A = (R - group mean) / (group population std +
    1e-4) on every valid token; then whitened over the valid tokens."""
    seq = scores - kl_beta * ((lp_old - lp_ref) * mask).sum(1)
    g = seq.view(-1, group)
    a = ((g - g.mean(1, keepdim=True))
         / (g.std(1, keepdim=True, unbiased=False) + 1e-4)).reshape(-1)
    adv = a[:, None] * mask
    if whiten:
        n = mask.sum().clamp(min=1.0)
        mean = (adv * mask).sum() / n
        var = ((adv - mean) ** 2 * mask).sum() / n
        adv = (adv - mean) * torch.rsqrt(var + 1e-8) * mask
    return adv


def policy_loss_sum(lp_new, lp_old, adv, mask, clip_eps: float):
    """Sum over the valid tokens of the clipped surrogate's per-token
    loss (divide by the valid-token count for the mean)."""
    ratio = torch.exp(lp_new - lp_old)
    per = -torch.minimum(ratio * adv,
                         ratio.clamp(1 - clip_eps, 1 + clip_eps) * adv)
    return (per * mask).sum()


def clip_by_global_norm(grads, max_norm: float):
    norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
    scale = torch.clamp(max_norm / norm.clamp(min=1e-9), max=1.0)
    return [g * scale for g in grads]


def adam(params, grads, m, v, step: int, lr: float, beta1: float,
         beta2: float, eps: float):
    """One Adam step (no weight decay) on lists of tensors; returns the
    new params, m and v."""
    bc1, bc2 = 1 - beta1 ** step, 1 - beta2 ** step
    out_p, out_m, out_v = [], [], []
    for p, g, m0, v0 in zip(params, grads, m, v):
        m1 = beta1 * m0 + (1 - beta1) * g
        v1 = beta2 * v0 + (1 - beta2) * g * g
        out_p.append(p - lr * (m1 / bc1) / (torch.sqrt(v1 / bc2) + eps))
        out_m.append(m1)
        out_v.append(v1)
    return out_p, out_m, out_v
