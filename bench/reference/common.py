"""Plain float32 building blocks of the references, and the lower
precision that a control computes in.

``mm(x, w, prec)``: every matrix product of a reference goes through it.
``prec`` "fp32" is the reference itself; "fp8" is the control of a
bfloat16 configuration: both operands rounded to float8 e4m3 with a scale
per row of ``x`` and per column of ``w`` (absolute maximum to 448), the
products summed in float32, as an fp8 GEMM with per-token and
per-channel scales computes them.  A float32 configuration's control is
TF32, which the caller turns on around the reference
(``torch.backends.cuda.matmul.allow_tf32``), so ``mm`` needs no mode for
it.  Imports nothing of the program.
"""
from __future__ import annotations

import torch

E4M3_MAX = 448.0


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    scale = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def mm(x: torch.Tensor, w: torch.Tensor, prec: str = "fp32") -> torch.Tensor:
    x, w = x.float(), w.float()
    if prec == "fp32":
        return x @ w
    if prec == "fp8":
        return _fp8(x, -1) @ _fp8(w, 0)
    raise ValueError(f"unknown precision {prec!r}")


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.float()
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) \
        * scale.float()


def leaf(params: dict, path: str) -> torch.Tensor:
    """The leaf at ``path`` ("blocks/layer0/attn/wq"); a block leaf is
    stacked over the layers."""
    t = params
    for k in path.split("/"):
        t = t[k]
    return t
