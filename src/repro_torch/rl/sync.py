"""Weight resharding / synchronization between training and generation
replicas (the C_reshard / C_sync terms of the cost model).

Port of ``repro.rl.sync``.  When the generation replica lives on the
training replica's device the handoff is zero-copy: the generation
params *are* the trained params (the optimizer is functional, so the
next step makes new tensors and never writes the replica in place).  A
target placement on other devices (a sharded or cross-group reshard) is
not yet ported.  Transfer volume is returned so the caller can account
the synchronization cost."""
from __future__ import annotations

from typing import Tuple

from repro_torch.tree import tree_leaves

NOT_PORTED = ("multi-device weight sync is not yet ported (ROADMAP.md "
              "§1 item 9: sharded execution)")


def tree_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def sync_weights(train_params, target_shardings=None) -> Tuple[object, int]:
    """Returns (generation_params, bytes_transferred)."""
    nbytes = tree_bytes(train_params)
    if target_shardings is not None:
        raise NotImplementedError(NOT_PORTED)
    return train_params, nbytes   # same device: zero-copy handoff
