"""Weights carried across between the JAX package and the port.

The JAX param pytree (``repro.models.transformer.init_params``) is nested
dicts of arrays with the per-block leaves stacked over a leading ``[R]``
repeats dim.  The port keeps exactly that nesting and layout, so a
parity test converts once and compares like with like.  The bridge
talks numpy on the JAX side (the caller does
``jax.tree_util.tree_map(np.asarray, params)``); it never imports JAX.

``from_numpy_state_tree`` / ``to_numpy_state_tree`` carry the RL
trainer's whole ``state_tree()`` (``repro.rl.trainer``) across: the
actor, reference and generation params, the Adam states (``m`` and
``v`` shaped as the params they follow, the critic's as the
``(critic, value_head)`` tuple), PPO's critic and value head, and the
weight version.

bfloat16 travels bit for bit: ``np.asarray`` of a JAX bf16 array has the
``ml_dtypes`` ``bfloat16`` dtype, which ``torch.from_numpy`` refuses, so
the bits go through ``uint16`` views in both directions (a float32 detour
would round on the way back).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from repro_torch.device import resolve_dtype
from repro_torch.models.config import ModelConfig


def _to_torch(arr: np.ndarray, device, dtype: Optional[torch.dtype]):
    arr = np.array(arr)   # a writable copy: JAX hands out read-only views
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes   # the JAX side's bf16 numpy dtype
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def from_numpy_params(tree: Dict[str, Any], cfg: ModelConfig,
                      device: Union[str, torch.device],
                      dtype: Union[str, torch.dtype, None] = None
                      ) -> Dict[str, Any]:
    """JAX param pytree (numpy leaves) -> the port's params (same nesting,
    stacked ``[R, ...]`` block leaves kept).  ``dtype`` optionally casts
    the floating leaves; by default each leaf keeps its own dtype."""
    tdt = None if dtype is None else resolve_dtype(dtype)
    R = cfg.n_pattern_repeats

    def conv(node, path):
        if isinstance(node, dict):
            return {k: conv(v, path + (k,)) for k, v in node.items()}
        arr = np.asarray(node)
        if path[0] == "blocks" and arr.shape[:1] != (R,):
            raise ValueError(f"{'/'.join(path)}: expected a leading repeats "
                             f"dim {R}, got shape {arr.shape}")
        return _to_torch(arr, device, tdt)

    return conv(tree, ())


def to_numpy_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """Inverse of ``from_numpy_params``: the port's params -> numpy leaves
    (bf16 as ``ml_dtypes.bfloat16``), ready for ``jnp.asarray``."""
    if isinstance(params, dict):
        return {k: to_numpy_params(v) for k, v in params.items()}
    return _to_numpy(params)


def _tree_to_torch(node, device):
    """Any dict / tuple / list tree of numpy leaves -> torch leaves."""
    if isinstance(node, dict):
        return {k: _tree_to_torch(v, device) for k, v in node.items()}
    if isinstance(node, (tuple, list)):
        return type(node)(_tree_to_torch(v, device) for v in node)
    return _to_torch(np.asarray(node), device, None)


def _tree_to_numpy(node):
    if isinstance(node, dict):
        return {k: _tree_to_numpy(v) for k, v in node.items()}
    if isinstance(node, (tuple, list)):
        return type(node)(_tree_to_numpy(v) for v in node)
    return _to_numpy(node)


def _same_leaves(a, b) -> bool:
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_same_leaves(a[k], b[k]) for k in a))
    a, b = np.asarray(a), np.asarray(b)
    return (a.shape == b.shape and a.dtype == b.dtype
            and a.tobytes() == b.tobytes())


def _opt_to_torch(opt, params_like, cfg, device):
    """Adam state {"step", "m", "v"}: moments shaped as ``params_like``
    (a params tree, or the critic's ``(params, value_head)`` tuple)."""
    def moments(tree):
        if isinstance(params_like, tuple):
            return (from_numpy_params(tree[0], cfg, device),
                    _tree_to_torch(tree[1], device))
        return from_numpy_params(tree, cfg, device)
    return {"step": _to_torch(np.asarray(opt["step"]), device, None),
            "m": moments(opt["m"]), "v": moments(opt["v"])}


def from_numpy_state_tree(tree: Dict[str, Any], cfg: ModelConfig,
                          device: Union[str, torch.device]
                          ) -> Dict[str, Any]:
    """The reference trainer's ``state_tree()`` (numpy leaves) -> the
    port's ``RLTrainer.load_state_tree`` input, every leaf in its own
    dtype.  ``gen_params`` is the actor itself when its leaves are
    bit-identical to the actor's (the reference's zero-copy replica
    between syncs); otherwise its own tensors."""
    out: Dict[str, Any] = {
        "actor": from_numpy_params(tree["actor"], cfg, device),
        "ref": from_numpy_params(tree["ref"], cfg, device),
        "weight_version": _to_torch(np.asarray(tree["weight_version"]),
                                    device, None),
    }
    out["actor_opt"] = _opt_to_torch(tree["actor_opt"], out["actor"], cfg,
                                     device)
    out["gen_params"] = (out["actor"]
                         if _same_leaves(tree["gen_params"], tree["actor"])
                         else from_numpy_params(tree["gen_params"], cfg,
                                                device))
    if "critic" in tree:
        out["critic"] = from_numpy_params(tree["critic"], cfg, device)
        out["value_head"] = _tree_to_torch(tree["value_head"], device)
        out["critic_opt"] = _opt_to_torch(
            tree["critic_opt"], (out["critic"], out["value_head"]), cfg,
            device)
    return out


def to_numpy_state_tree(tree: Dict[str, Any]) -> Dict[str, Any]:
    """Inverse of ``from_numpy_state_tree``: the port's ``state_tree()``
    -> numpy leaves (bf16 as ``ml_dtypes.bfloat16``, tuples kept)."""
    return _tree_to_numpy(tree)
