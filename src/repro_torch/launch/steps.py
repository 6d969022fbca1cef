"""train_step / prefill_step / serve_step builders and their mesh
shardings.

Port of ``repro.launch.steps``: the functions the dry-run counts for
every (arch x shape x mesh) (``launch.dryrun``), and that the drivers
run on one card (``launch.train``'s LM mode, chip_smoke).

The gradient is ``torch.autograd.grad`` over the flat parameter leaves
(the stacked ``[R, ...]`` block leaves accumulate their repeats'
gradients), through the plain attention (``attn_impl="plain"``): the
CUDA kernels compute forward values only, and the reference trains on
its jnp attention too.  ``remat=True`` recomputes each repeat's layers
in the backward pass (``transformer.forward``), as the reference's
default does: the dry-run counts that step, and a long sequence needs
it to fit.  It is off by default here, where the LM mode's short
sequences fit without it and the recomputation is a third more work.

The sharding trees are DTensor placement trees (a tuple of placements,
one per mesh dimension, per leaf) on a torch ``DeviceMesh`` with the
reference's axes (``launch.mesh``): each leaf's partition spec is the
reference's, sanitized where an axis does not divide its dimension
(``parallel.sharding``).  A step given DTensor parameters first
redistributes them to their use placements (``sharding.for_use``: the
FSDP all-gather GSPMD inserts); a train step's gradients come back in
the parameters' placements.  Run a step on DTensors under
``sharding.use_hints(activation_rules(...))`` and DTensor's
``implicit_replication`` (plain tensors such as Adam's scalars taken as
replicated), as ``launch.dryrun`` does.
"""
from __future__ import annotations

import re
from typing import Dict, Optional

import torch

from repro_torch.configs.shapes import InputShape
from repro_torch.kernels.guard import TRAIN_ATTN
from repro_torch.launch.mesh import batch_spec, data_axes
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adam
from repro_torch.parallel import sharding as sh
from repro_torch.tree import tree_leaves, tree_unflatten


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def lm_loss(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor], *,
            long_mode: bool = False, remat: bool = False) -> torch.Tensor:
    """Mean masked next-token NLL (fp32 logits) plus the MoE aux loss.
    ``batch`` holds the model inputs (``tokens`` and / or ``features``,
    see ``T.embed_inputs``), ``labels`` [B, S] over the whole sequence
    and an optional ``loss_mask``."""
    out = T.forward(sh.for_use(params), cfg, batch, long_mode=long_mode,
                    attn_impl=TRAIN_ATTN, remat=remat)
    logits = out["logits"].float()
    labels = batch["labels"]
    mask = batch.get("loss_mask")
    if sh.is_dtensor(logits):
        nll = _vocab_parallel_nll(logits, labels)
    else:
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, labels[..., None].long())[..., 0]
    if mask is not None:
        nll = nll * mask
        denom = torch.clamp(mask.sum(), min=1.0)
    else:
        denom = float(nll.numel())
    return nll.sum() / denom + out["aux_loss"]


def _vocab_parallel_nll(logits, labels):
    """The NLL of DTensor ``logits`` [B, S, V], the vocabulary left where
    the ``logits`` hint split it (over ``model``): a log-sum-exp whose
    max and sum reduce across the shards, and the label's logit picked in
    its shard (Megatron's vocab-parallel cross-entropy).  A log-softmax
    over a split vocabulary gathers it whole on every device, and the
    gather's backward allocates its zeros at the global batch's shape
    (DTensor's ``new_zeros`` of a replicated output): 637 GB a device for
    qwen3-0.6b's train_4k on the production mesh."""
    mesh = logits.device_mesh
    rows = sh.tensor_placements(batch_spec(mesh), tuple(logits.shape[:2]),
                                mesh)

    def reduced(x):
        # the sums over the vocabulary shards, split by rows as the batch
        # is (DTensor would otherwise reduce-scatter them over the tokens)
        return x.redistribute(mesh, rows)
    m = reduced(logits.detach().amax(dim=-1, keepdim=True)[..., 0])
    lse = torch.log(reduced(torch.exp(logits - m[..., None]).sum(dim=-1)))
    return lse + m - reduced(sh.vocab_parallel_pick(logits, labels))


# ---------------------------------------------------------------------------
# Step builders
# ---------------------------------------------------------------------------

def make_train_step(cfg: ModelConfig,
                    opt_cfg: Optional[adam.AdamConfig] = None, *,
                    remat: bool = False, donate: bool = False):
    """``train_step(params, opt_state, batch) -> (new_params, new_opt,
    {"loss", "lr", "grad_norm"})``; functional, as the reference's, or
    with ``donate`` writing the same values into ``params`` and
    ``opt_state`` (``adam.adam_update``)."""
    opt_cfg = opt_cfg or adam.AdamConfig()

    def train_step(params, opt_state, batch):
        with torch.enable_grad():
            flat = [p.detach().requires_grad_(True)
                    for p in tree_leaves(params)]
            loss = lm_loss(tree_unflatten(params, flat), cfg, batch,
                           remat=remat)
            gs = torch.autograd.grad(loss, flat, allow_unused=True)
        gs = [torch.zeros_like(p) if g is None
              else sh.redistribute_like(g, p) if sh.is_dtensor(g) else g
              for p, g in zip(flat, gs)]
        new_params, new_opt, om = adam.adam_update(
            params, tree_unflatten(params, gs), opt_state, opt_cfg,
            donate=donate)
        return new_params, new_opt, {"loss": loss.detach(), **om}

    return train_step


def make_prefill_step(cfg: ModelConfig, *, long_mode: bool = False,
                      max_cache_len: Optional[int] = None):
    """``prefill_step(params, batch) -> (last logits [B, V], cache)``:
    the forward over the prompt with a decode cache of ``max_cache_len``
    positions (default: the prompt's) primed by it, on the module's
    attention (``models.attention.set_attention_impl``: the kernels on
    the card)."""
    def prefill_step(params, batch):
        with torch.no_grad():
            out = T.forward(sh.for_use(params), cfg, batch,
                            long_mode=long_mode, return_cache=True,
                            max_cache_len=max_cache_len)
        return out["logits"][:, -1], out["cache"]
    return prefill_step


def make_serve_step(cfg: ModelConfig, *, long_mode: bool = False):
    """``serve_step(params, {"tokens" [B, 1], "cache"}) -> (logits [B, V],
    cache)``: one decode step, the cache written in place."""
    def serve_step(params, batch):
        with torch.no_grad():
            return T.decode_step(sh.for_use(params), cfg, batch["tokens"],
                                 batch["cache"], long_mode=long_mode)
    return serve_step


# ---------------------------------------------------------------------------
# Sharding trees
# ---------------------------------------------------------------------------

def _placement_tree(mesh, specs, tree):
    return sh.map_with_path(
        lambda path, x: sh.tensor_placements(_at(specs, path),
                                             tuple(x.shape), mesh), tree)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def param_shardings(mesh, params_shape):
    """The parameter tree's placements: ``param_tree_specs`` (TP over
    ``model``, FSDP over ``data``; params replicated over ``pod``)."""
    return _placement_tree(mesh, sh.param_tree_specs(params_shape),
                           params_shape)


def opt_shardings(mesh, params_shape):
    """Adam's state: moments as their parameters, the step replicated."""
    from torch.distributed.tensor import Replicate
    mk = lambda: param_shardings(mesh, params_shape)
    return {"step": (Replicate(),) * mesh.ndim, "m": mk(), "v": mk()}


def _cache_spec(name: str, shape, bspec, data) -> sh.P:
    r = len(shape)
    if name.endswith("pos"):
        return sh.P()
    if re.search(r"/(k|v)$", name):              # [R, B, L, KV, hd]
        # sequence-shard large caches over ``model`` (flash-decoding
        # style); small ring caches stay replicated over ``model``;
        # batch 1 also shards the sequence over ``data``
        L = shape[2]
        if L <= 8192:
            return sh.P(None, bspec, None, None, None)
        if bspec is None:
            seq = ((data,) if isinstance(data, str) else tuple(data)) \
                + (sh.MODEL,)
            return sh.P(None, None, seq, None, None)
        return sh.P(None, data, sh.MODEL, None, None)
    if name.endswith("wkv"):                      # [R, B, H, N, N]
        return sh.P(None, bspec, sh.MODEL, None, None)
    if name.endswith("ssm"):                      # [R, B, di, ds]
        return sh.P(None, bspec, sh.MODEL, None)
    if name.endswith("conv"):                     # [R, B, dc-1, di]
        return sh.P(None, bspec, None, sh.MODEL)
    if r == 3:                                    # shift states [R, B, d]
        return sh.P(None, bspec, None)
    return sh.P(*([None] * r))


def batch_shardings(mesh, batch_tree, shape: InputShape):
    """tokens / labels / masks: batch over the data axes; cache and state
    leaves by the reference's name rules (KV cache, RWKV wkv state,
    Mamba conv / ssm state), leaf for leaf.  Non-tensor leaves (the
    cache's ``pos``) map to None."""
    da = data_axes(mesh)
    data = da if len(da) > 1 else da[0]
    bspec = None if shape.global_batch == 1 else data

    def place(path, x):
        if not torch.is_tensor(x):
            return None
        name = sh.path_str(path)
        if "cache" in name:
            spec = _cache_spec(name, tuple(x.shape), bspec, data)
        else:
            spec = sh.P() if x.ndim == 0 else \
                sh.P(*([bspec] + [None] * (x.ndim - 1)))
        return sh.tensor_placements(spec, tuple(x.shape), mesh)
    return sh.map_with_path(place, batch_tree)


def activation_rules(mesh, shape: InputShape):
    return sh.default_activation_rules(
        data_axes=data_axes(mesh), model_axis=sh.MODEL,
        seq_shard=(shape.phase == "train"))


def distribute_tree(tree, mesh, placements):
    """A tree of full tensors (the same on every rank, fake tensors
    included) as DTensors laid out by a placement tree; leaves with no
    placements pass through.  No communication."""
    from torch.distributed.tensor import distribute_tensor
    return sh.map_with_path(
        lambda path, x: x if _at(placements, path) is None else
        distribute_tensor(x, mesh, _at(placements, path),
                          src_data_rank=None), tree)
