"""Weights made on the device from the seed, in a few large calls.

A family's ``param_specs`` gives every leaf's shape and distribution.  All
normal leaves are views into one buffer filled by one ``randn`` call, and
all uniform leaves into one ``rand`` buffer; each leaf is then scaled and
shifted in place.  The draws come from a ``torch.Generator`` on the
device, in the dtype the configuration serves in, so the same seed gives
the same tensors on the same kind of card, and the port and the reference
are handed these same tensors.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch


def _nest(flat: Dict[str, torch.Tensor]) -> dict:
    out: dict = {}
    for path, t in flat.items():
        node = out
        *parents, last = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = t
    return out


def make_params(specs: Dict[str, Tuple[tuple, tuple]], seed: int,
                dtype: torch.dtype, device) -> dict:
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    numel = lambda shape: int(torch.Size(shape).numel())    # noqa: E731
    by_kind = {"normal": [], "uniform": []}
    for path, (shape, init) in specs.items():
        by_kind[init[0]].append((path, shape, init))
    flat = {}
    for kind, leaves in by_kind.items():
        total = sum(numel(s) for _, s, _ in leaves)
        if not total:
            continue
        draw = torch.randn if kind == "normal" else torch.rand
        buf = draw(total, generator=gen, dtype=dtype, device=device)
        off = 0
        for path, shape, (_, a, b) in leaves:
            n = numel(shape)
            t = buf[off:off + n].view(shape)
            off += n
            if kind == "normal":
                t.mul_(b).add_(a)
            else:
                t.mul_(b - a).add_(a)
            flat[path] = t
    return _nest(flat)
