"""Refusal of autograd through the hand-written CUDA kernels.

The kernels compute forward values only: a wrapper writes its output
through ctypes into a fresh tensor with no ``grad_fn``, so a loss built
on it would give every weight in front of the kernel no gradient, with
no error.  Each wrapper calls ``refuse_grad`` before it launches: under
grad mode, an input that requires grad raises.  Training runs the plain
attention explicitly (``transformer.forward(attn_impl="plain")``, which
reaches ``multihead_attention(force_impl="plain")``).
"""
from __future__ import annotations

import torch


def refuse_grad(name: str, *tensors) -> None:
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward, and an input requires "
            f"grad under grad mode; training runs on force_impl='plain' "
            f"(transformer.forward(attn_impl='plain')), inference under "
            f"torch.inference_mode() or torch.no_grad()")
