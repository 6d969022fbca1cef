"""Device and dtype policy of the port.

Entry points run on the card: ``resolve_device()`` with no argument gives
``cuda`` and raises when no CUDA device is present, so a missing card
never turns into a silent CPU run.  The CPU is taken only when the caller
names it (``device="cpu"``), as the CPU tests do.

Float32 means float32: ``resolve_device`` turns TF32 off for matmuls and
cuDNN, so an fp32 run on the card is held to the same tolerances as the
JAX reference (TF32 keeps about three decimal digits).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_device(device: Union[str, torch.device, None] = "cuda"
                   ) -> torch.device:
    """``cuda`` (the default) or an explicit ``cpu``; raises when CUDA is
    asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def resolve_dtype(name: Optional[Union[str, torch.dtype]]) -> torch.dtype:
    """Config dtype string (``ModelConfig.dtype``) -> torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    if name not in DTYPES:
        raise ValueError(f"unsupported dtype {name!r}; have {sorted(DTYPES)}")
    return DTYPES[name]


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
