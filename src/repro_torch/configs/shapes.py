"""Assigned input shapes, and how a sequence splits between the feature
and the token frontends.

A copy of the framework-free part of ``repro.configs.shapes``:

    train_4k     seq_len=4096    global_batch=256   (training)
    prefill_32k  seq_len=32768   global_batch=32    (inference-prefill)
    decode_32k   seq_len=32768   global_batch=128   (inference-decode)
    long_500k    seq_len=524288  global_batch=1     (long-context-decode)

``long_500k`` runs only for architectures with a sub-quadratic long
mode; encoder-only architectures have no decode step.  The JAX module's
``input_specs`` (``ShapeDtypeStruct`` stand-ins that the dry-run lowers
through XLA) has no counterpart yet: it comes with the port's dry-run
and roofline reports (ROADMAP.md §1 item 10).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    phase: str                      # "train" | "prefill" | "decode"
    long_mode: bool = False


SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode", long_mode=True),
}

# number of stubbed modality-frontend positions for feature-input archs
N_PATCHES = 1024


def skip_reason(cfg: ModelConfig, shape: InputShape) -> Optional[str]:
    """None if the (arch, shape) pair runs; otherwise a documented skip."""
    if shape.phase == "decode" and cfg.is_encoder_only:
        return "encoder-only architecture has no decode step"
    if shape.long_mode and not cfg.supports_long_context():
        return ("pure full-attention architecture: long_500k requires a "
                "sub-quadratic variant (none configured)")
    return None


def token_splits(cfg: ModelConfig, seq_len: int):
    """(n_feature_positions, n_token_positions) summing to seq_len."""
    if cfg.frontend != "features":
        return 0, seq_len
    if cfg.is_encoder_only:
        return seq_len, 0
    n_feat = min(N_PATCHES, seq_len // 2)
    return n_feat, seq_len - n_feat
