"""Weights carried across between the JAX package and the port.

The JAX param pytree (``repro.models.transformer.init_params``) is nested
dicts of arrays with the per-block leaves stacked over a leading ``[R]``
repeats dim.  The port keeps exactly that nesting and layout, so a
parity test converts once and compares like with like.  The bridge
talks numpy on the JAX side (the caller does
``jax.tree_util.tree_map(np.asarray, params)``); it never imports JAX.

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
