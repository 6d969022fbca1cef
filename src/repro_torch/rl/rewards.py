"""Reward computation: programmatic verifier (the runnable example's path)
and a learned reward-model head (separate LLM + scalar head, frozen during
RL, as in the paper's PPO workflow).

Port of ``repro.rl.rewards``.  The heads draw from an explicit
``torch.Generator``; parity tests carry the reference's heads across
with ``bridge`` instead of comparing inits.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init


def init_reward_head(gen: torch.Generator, cfg: ModelConfig,
                     dtype=torch.float32):
    return {"w": dense_init(gen, (cfg.d_model, 1), dtype=dtype)}


def reward_model_scores(params, head, cfg: ModelConfig, sequences, mask_last,
                        attn_impl: Optional[str] = None):
    """Scalar score per sequence = head(last hidden state).

    sequences: [B, S]; mask_last: [B] index of final valid token."""
    out = T.forward(params, cfg, {"tokens": sequences}, attn_impl=attn_impl)
    h = out["hidden"]                                   # [B, S, d]
    idx = mask_last.long()[:, None, None].expand(h.shape[0], 1, h.shape[2])
    last_h = torch.gather(h, 1, idx)[:, 0]
    return (last_h @ head["w"])[:, 0].float()


def init_value_head(gen: torch.Generator, cfg: ModelConfig,
                    dtype=torch.float32):
    return {"w": dense_init(gen, (cfg.d_model, 1), dtype=dtype)}


def critic_values(params, head, cfg: ModelConfig, sequences, gen_start: int,
                  attn_impl: Optional[str] = None):
    """Per-generated-token values V(s_t). Returns [B, S - gen_start]."""
    out = T.forward(params, cfg, {"tokens": sequences}, attn_impl=attn_impl)
    h = out["hidden"][:, gen_start - 1:-1]  # state BEFORE each gen token
    return (h @ head["w"])[..., 0].float()
