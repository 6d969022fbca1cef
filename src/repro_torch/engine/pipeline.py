"""Async one-step off-policy pipeline (§2.1) + weight-sync routing.

``AsyncPipeline`` owns the generation/training double buffer: generation
for iteration t+1 overlaps training on iteration t's rollouts.  ``push``
swaps the freshly-generated bundle for the previous one (synchronous mode
is a pass-through); the first asynchronous call returns ``None`` — the
pipeline-fill iteration with nothing to train on yet.

Each bundle carries the ``gen_version`` (weight-sync counter at generation
time), so staleness is observable: in steady-state async execution the
bundle being trained is exactly one sync behind the current weights.

``sync_actor_weights`` routes the trained actor to the generation replica
through ``rl.sync`` with the target sharding taken from the generation
task's placement, and accounts both actual bytes moved and the plan's
predicted reshard/sync seconds from the cost model.

Port of ``repro.engine.pipeline``.  On one device the generation and
training placements fold onto the same device and the handoff is
zero-copy; a cross-device reshard raises ``NotImplementedError`` from
the placement (sharded execution is not yet ported).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from repro_torch.rl.sync import sync_weights


@dataclasses.dataclass
class PipelineRecord:
    iteration: int
    gen_version: int       # weight version the trained rollouts came from
    weight_version: int    # current version when training started


class AsyncPipeline:
    def __init__(self, asynchronous: bool):
        self.asynchronous = asynchronous
        self._pending: Optional[Dict[str, Any]] = None
        self.records: List[PipelineRecord] = []

    def push(self, fresh: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """Submit this iteration's rollouts; get back the bundle to train
        on (the previous one when asynchronous, the same one when not)."""
        if not self.asynchronous:
            return fresh
        pending, self._pending = self._pending, fresh
        return pending

    def drain(self) -> Optional[Dict[str, Any]]:
        """Explicitly give up the pending bundle (plan swap with drain
        semantics): the in-flight rollouts generated under the outgoing
        plan are discarded and the pipeline refills, so the first
        iteration after the swap is a fill iteration.  Returns the
        dropped bundle (None when nothing was pending)."""
        pending, self._pending = self._pending, None
        return pending

    def record(self, iteration: int, bundle: Dict[str, Any],
               weight_version: int) -> None:
        self.records.append(PipelineRecord(
            iteration, bundle["gen_version"], weight_version))

    @property
    def filling(self) -> bool:
        return self.asynchronous and self._pending is None


def sync_actor_weights(st, gen_placement,
                       train_placement=None) -> float:
    """Trained actor -> generation replica through the plan's reshard path.

    Weight publication is an explicit ``device_put`` onto the generation
    placement's shardings whenever the gen group is sharded *or* lives on
    different real devices than the training group — the cross-group
    reshard the cost model prices (``c_sync`` / the redeploy transition
    term).  Identity handoff (zero copy) only when both tasks fold to the
    same device set and no sharding is involved.  Bumps the weight
    version the pipeline uses to verify one-step staleness.  Returns
    bytes moved."""
    target = None
    if gen_placement is not None:
        same_devices = train_placement is not None and \
            tuple(id(d) for d in gen_placement.local_devices) == \
            tuple(id(d) for d in train_placement.local_devices)
        if len(gen_placement.local_devices) > 1 or \
                (train_placement is not None and not same_devices):
            target = gen_placement.param_shardings(st.actor)
    st.gen_params, nbytes = sync_weights(st.actor, target)
    st.sync_bytes += nbytes
    st.weight_version += 1
    return nbytes
