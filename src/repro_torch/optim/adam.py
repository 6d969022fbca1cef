"""Adam/AdamW + gradient clipping + LR schedules, from scratch.

Port of ``repro.optim.adam``.  ``adam_update`` is functional, as the
reference: it returns new parameter and moment tensors and never writes
the old ones.  The trainer relies on that — the generation replica is a
zero-copy alias of the actor between weight syncs (``rl.sync``), and an
in-place step would change it under the asynchronous pipeline's feet.
A caller that owns its state alone (the LM launcher) may pass
``donate=True`` instead, the counterpart of JAX's donated buffers: the
same numbers are written into the old parameter and moment tensors, so
the step never holds two copies of the moments.  Moments can be stored
in a reduced dtype (``moment_dtype``) for memory-constrained configs;
the update itself runs in fp32.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.device import resolve_dtype
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip_norm: Optional[float] = 1.0
    moment_dtype: str = "float32"   # "bfloat16" to halve optimizer memory
    warmup_steps: int = 0
    total_steps: Optional[int] = None  # enables cosine decay
    min_lr_frac: float = 0.1


def init_adam_state(params, cfg: AdamConfig):
    mdt = resolve_dtype(cfg.moment_dtype)
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else torch.device("cpu")
    zeros = lambda p: torch.zeros_like(p, dtype=mdt)  # noqa: E731
    return {
        "step": torch.zeros((), dtype=torch.int32, device=device),
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
    }


def schedule_lr(cfg: AdamConfig, step):
    """fp32 learning rate at ``step`` (an int32 tensor)."""
    lr = torch.tensor(cfg.lr, dtype=torch.float32, device=step.device)
    if cfg.warmup_steps > 0:
        lr = lr * torch.clamp((step + 1) / cfg.warmup_steps, max=1.0)
    if cfg.total_steps:
        t = torch.clamp((step - cfg.warmup_steps)
                        / max(cfg.total_steps - cfg.warmup_steps, 1),
                        0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * t))
        lr = lr * (cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos)
    return lr


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


def adam_update(params, grads, state, cfg: AdamConfig, *,
                donate: bool = False):
    """Returns (new_params, new_state, metrics).  With ``donate`` the new
    parameters and moments are the old tensors, overwritten."""
    step = state["step"] + 1
    if cfg.grad_clip_norm is not None:
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip_norm)
    else:
        gnorm = global_norm(grads)
    lr = schedule_lr(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    stepf = step.float()
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                     device=step.device), stepf)
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                     device=step.device), stepf)
    mdt = resolve_dtype(cfg.moment_dtype)

    def upd(p, g, m, v):
        g32 = g.float()
        m32 = m.float() * b1 + (1 - b1) * g32
        v32 = v.float() * b2 + (1 - b2) * torch.square(g32)
        mhat = m32 / bc1
        vhat = v32 / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if cfg.weight_decay:
            delta = delta + cfg.weight_decay * p.float()
        new_p = p.float() - lr * delta
        if donate:
            return p.copy_(new_p), m.copy_(m32), v.copy_(v32)
        return new_p.to(p.dtype), m32.to(mdt), v32.to(mdt)

    outs = [upd(p, g, m, v) for p, g, m, v in zip(
        tree_leaves(params), tree_leaves(grads), tree_leaves(state["m"]),
        tree_leaves(state["v"]))]
    unf = lambda i: tree_unflatten(params, [o[i] for o in outs])  # noqa
    new_state = {"step": step.to(torch.int32), "m": unf(1), "v": unf(2)}
    return unf(0), new_state, {"lr": lr, "grad_norm": gnorm}
