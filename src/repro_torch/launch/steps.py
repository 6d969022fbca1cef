"""The LM train step: next-token loss and one functional Adam step.

Port of ``lm_loss`` and ``make_train_step`` of ``repro.launch.steps``.
The gradient is ``torch.autograd.grad`` over the flat parameter leaves
(the stacked ``[R, ...]`` block leaves accumulate their repeats'
gradients), through the plain attention (``attn_impl="plain"``): the
CUDA kernels compute forward values only, and the reference trains on
its jnp attention too.  No activation recomputation: the reference's
``remat`` changes memory, not the numbers.  The LM mode runs on one
device: sharded execution (``parallel``) serves the RL engine's plan
placements, and the reference module's host-mesh sharding trees are
not taken over.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels.guard import TRAIN_ATTN
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adam
from repro_torch.tree import tree_leaves, tree_unflatten


def lm_loss(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor], *,
            long_mode: bool = False) -> torch.Tensor:
    """Mean masked next-token NLL (fp32 logits) plus the MoE aux loss.
    ``batch`` holds the model inputs (``tokens`` and / or ``features``,
    see ``T.embed_inputs``), ``labels`` [B, S] over the whole sequence
    and an optional ``loss_mask``."""
    out = T.forward(params, cfg, batch, long_mode=long_mode,
                    attn_impl=TRAIN_ATTN)
    logits = out["logits"].float()
    labels = batch["labels"]
    mask = batch.get("loss_mask")
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None].long())[..., 0]
    if mask is not None:
        nll = nll * mask
        denom = torch.clamp(mask.sum(), min=1.0)
    else:
        denom = float(nll.numel())
    return nll.sum() / denom + out["aux_loss"]


def make_train_step(cfg: ModelConfig,
                    opt_cfg: Optional[adam.AdamConfig] = None, *,
                    donate: bool = False):
    """``train_step(params, opt_state, batch) -> (new_params, new_opt,
    {"loss", "lr", "grad_norm"})``; functional, as the reference's, or
    with ``donate`` writing the same values into ``params`` and
    ``opt_state`` (``adam.adam_update``)."""
    opt_cfg = opt_cfg or adam.AdamConfig()

    def train_step(params, opt_state, batch):
        with torch.enable_grad():
            flat = [p.detach().requires_grad_(True)
                    for p in tree_leaves(params)]
            loss = lm_loss(tree_unflatten(params, flat), cfg, batch)
            gs = torch.autograd.grad(loss, flat, allow_unused=True)
        grads = tree_unflatten(params, [torch.zeros_like(p) if g is None
                                        else g for p, g in zip(flat, gs)])
        new_params, new_opt, om = adam.adam_update(params, grads, opt_state,
                                                   opt_cfg, donate=donate)
        return new_params, new_opt, {"loss": loss.detach(), **om}

    return train_step
