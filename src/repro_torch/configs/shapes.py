"""Assigned input shapes, and input specs for the dry-run.

Port of ``repro.configs.shapes``:

    train_4k     seq_len=4096    global_batch=256   (training)
    prefill_32k  seq_len=32768   global_batch=32    (inference-prefill)
    decode_32k   seq_len=32768   global_batch=128   (inference-decode)
    long_500k    seq_len=524288  global_batch=1     (long-context-decode)

Decode shapes run ``serve_step`` (one new token + KV cache of seq_len).
``long_500k`` runs only for architectures with a sub-quadratic long
mode; encoder-only architectures have no decode step.

``input_specs`` builds every model input as a fake tensor (``torch.
_subclasses.fake_tensor.FakeTensorMode``): shape, dtype and device with
no memory behind them, the counterpart of the reference's
``ShapeDtypeStruct`` stand-ins.  Every leaf, the decode cache's
included, builds under fake mode.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.models import cache as cache_mod
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


def input_specs(cfg: ModelConfig, shape: InputShape,
                param_dtype=torch.bfloat16, fake_mode=None
                ) -> Dict[str, object]:
    """Fake-tensor stand-ins for every model input (no allocation), in
    ``fake_mode`` (a ``FakeTensorMode``; a new one when None): the
    parameters and the inputs of one step must share a mode.  Token ids
    are int64 (the reference's int32: torch indexes with int64)."""
    if fake_mode is None:
        from torch._subclasses.fake_tensor import FakeTensorMode
        fake_mode = FakeTensorMode()
    B, S = shape.global_batch, shape.seq_len
    n_feat, n_tok = token_splits(cfg, S)
    with fake_mode:
        if shape.phase in ("train", "prefill"):
            specs = {}
            if n_feat:
                specs["features"] = torch.empty((B, n_feat, cfg.feature_dim),
                                                dtype=param_dtype)
            if n_tok:
                specs["tokens"] = torch.empty((B, n_tok), dtype=torch.int64)
            if shape.phase == "train":
                specs["labels"] = torch.empty((B, S), dtype=torch.int64)
                specs["loss_mask"] = torch.empty((B, S), dtype=param_dtype)
            return specs
        # decode: one token + cache of seq_len
        cache = cache_mod.init_cache(cfg, B, S, long_mode=shape.long_mode,
                                     dtype=param_dtype)
        return {"tokens": torch.empty((B, 1), dtype=torch.int64),
                "cache": cache}
