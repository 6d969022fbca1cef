"""Execution plans: partitioning strategy ρ + assignment strategy σ (§3.1).

A plan fixes, per the multi-level framework (§3.2):
  L1  task grouping            — disjoint sets of tasks sharing GPUs
  L2  GPU group sizes          — implicit in the device lists
  L3  task-group → device set  — ``TaskGroup.devices``
  L4  intra-model parallelization — (dp, pp, tp) per task
  L5  tasklet → device mapping — ``assignment[t][i, j, k] -> device id``
plus the load-balancing knobs (§4.2): per-stage layer counts and per-replica
batch fractions.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.topology import Topology
from repro_torch.core.workflow import RLWorkflow, Task, TaskKind

BYTES_BF16 = 2
BYTES_FP32 = 4
# mixed-precision Adam: bf16 weights + fp32 master + fp32 m,v + bf16 grads
TRAIN_BYTES_PER_PARAM = 16
INFER_BYTES_PER_PARAM = 2
# generation engines (vLLM-style continuous batching) decode in waves of at
# most this many sequences per replica; bounds KV working memory and C_hbm.
MAX_DECODE_WAVE = 32
# default prompt tokens ingested per mixed wave-step round under chunked
# admission (genserve prefill_chunk); bounds how long admission of a long
# prompt can delay the decode half of a round.
PREFILL_CHUNK = 16


def decode_wave(local_batch: float) -> int:
    return max(min(int(local_batch), MAX_DECODE_WAVE), 1)


def prefill_rounds(prompt_len: int, prefill_chunk: int,
                   prefix_hit_rate: float = 0.0) -> int:
    """Mixed wave-step rounds a request's prompt ingestion occupies a
    decode slot for under chunked admission (0 = one-shot admission,
    which the occupancy model prices as free).

    ``prefix_hit_rate`` is the expected fraction of prompt tokens served
    from the paged prefix cache (genserve ``prefix_cache=True``): only
    the uncached suffix is prefilled, floored at one round — even a
    fully cached prompt runs its landing chunk (the hit is capped at
    plen-1 so first-token logits come from a real forward pass)."""
    if prefill_chunk <= 0:
        return 0
    h = min(max(float(prefix_hit_rate), 0.0), 1.0)
    suffix = max(int(prompt_len), 1) * (1.0 - h)
    return max(math.ceil(suffix / int(prefill_chunk)), 1)


def predicted_occupancy(n_requests: float,
                        wave: Optional[int] = None,
                        gen_lens: Optional[Sequence[int]] = None,
                        prefill_rounds: float = 0.0,
                        max_new_tokens: Optional[int] = None,
                        prefix_hit_rate: float = 0.0) -> float:
    """Predicted mean decode-slot occupancy under continuous batching.

    This is the occupancy the cost model's ``C_hbm`` wave term assumes
    and the number the genserve engine's measured slot-table trace is
    compared against (Fig-7 style parity, decode-wave axis).

    With uniform generation lengths every wave is full except the last
    partial one: occupancy = n / ceil(n / W).  Given per-request lengths,
    ideal continuous batching is bounded by the longest request and by
    total work: steps >= max(max_len, ceil(sum_len / W)), and occupancy
    is total tokens over that lower bound.

    ``prefill_rounds`` > 0 prices *chunked admission* instead of
    assuming prompt ingestion free: each request additionally occupies a
    slot for that many mixed wave-step rounds before its first token
    (see :func:`prefill_rounds`), the work bound grows accordingly, and
    the returned figure is the *busy* occupancy (slots doing a decode
    step or a prefill chunk per round) — comparable against the slot
    table's ``busy_occupancy()``.  A scalar applies to every request;
    a sequence gives per-request rounds (aligned with ``gen_lens`` —
    required for the chain bound to stay a true upper bound under
    heterogeneous prompt lengths).  Uniform lengths then need
    ``max_new_tokens`` (the per-request decode length).

    ``prefix_hit_rate`` scales the admission price for paged
    prefix-cache serving: each request's prefill rounds shrink to the
    expected uncached fraction ``(1 - h)``, floored at one round per
    admitted request (the landing chunk always runs)."""
    W = wave if wave is not None else MAX_DECODE_WAVE
    W = max(int(W), 1)
    n = max(float(n_requests), 1.0)
    scalar_c = not hasattr(prefill_rounds, "__len__")
    if scalar_c and max(float(prefill_rounds), 0.0) == 0.0 \
            and gen_lens is None:
        return n / math.ceil(n / W)
    if gen_lens is None:
        assert max_new_tokens is not None, \
            "uniform-length occupancy with prefill rounds needs " \
            "max_new_tokens"
        lens = [max(int(max_new_tokens), 1)] * int(n)
    else:
        lens = [max(int(l), 1) for l in gen_lens]
    if scalar_c:
        cs = [max(float(prefill_rounds), 0.0)] * len(lens)
    else:
        cs = [max(float(c), 0.0) for c in prefill_rounds]
        assert len(cs) == len(lens), \
            "per-request prefill_rounds must align with gen_lens"
    h = min(max(float(prefix_hit_rate), 0.0), 1.0)
    if h > 0.0:
        cs = [max(c * (1.0 - h), 1.0) if c > 0.0 else 0.0 for c in cs]
    total = sum(lens) + sum(cs)
    chain = max(l + c for l, c in zip(lens, cs))
    steps = max(chain, math.ceil(total / W))
    return total / steps


@dataclasses.dataclass(frozen=True)
class TaskGroup:
    tasks: Tuple[int, ...]
    devices: Tuple[int, ...]


@dataclasses.dataclass
class Plan:
    groups: Tuple[TaskGroup, ...]
    parallel: Dict[int, Tuple[int, int, int]]      # task -> (dp, pp, tp)
    assignment: Dict[int, np.ndarray]              # task -> [dp, pp, tp] dev
    layers_per_stage: Dict[int, Tuple[int, ...]] = dataclasses.field(
        default_factory=dict)
    batch_fraction: Dict[int, Tuple[float, ...]] = dataclasses.field(
        default_factory=dict)
    # GEN task -> draft-k for speculative decoding (absent/0 = plain
    # wave decode); an alternative GEN parallelization the EA can toggle
    # per device class — priced by CostModel.gen_speculative_wave.
    gen_spec: Dict[int, int] = dataclasses.field(default_factory=dict)

    def group_of(self, task: int) -> TaskGroup:
        for g in self.groups:
            if task in g.tasks:
                return g
        raise KeyError(task)

    def stage_layers(self, wf: RLWorkflow, t: int, j: int) -> int:
        if t in self.layers_per_stage:
            return self.layers_per_stage[t][j]
        nl = wf.task(t).model.n_layers
        pp = self.parallel[t][1]
        base = nl // pp
        return base + (1 if j < nl % pp else 0)

    def replica_fraction(self, t: int, i: int) -> float:
        dp = self.parallel[t][0]
        if t in self.batch_fraction:
            return self.batch_fraction[t][i]
        return 1.0 / dp

    def devices_of_stage(self, t: int, i: int, j: int) -> np.ndarray:
        return self.assignment[t][i, j]

    def max_device(self) -> int:
        """Largest device id any tasklet is assigned to (-1 if none)."""
        ids = [int(a.max()) for a in self.assignment.values() if a.size]
        return max(ids, default=-1)

    def fits_topology(self, topo) -> bool:
        """Whether every assigned device id exists in ``topo`` — false
        after a device drop re-indexed the survivors under an incumbent
        plan that still references the old ids (the no-feasible-
        challenger elastic case); simulating such a pair would index
        past the device list."""
        return self.max_device() < topo.n

    def task_grouping_key(self) -> Tuple[Tuple[int, ...], ...]:
        return tuple(sorted(g.tasks for g in self.groups))

    def gpu_sizes_key(self) -> Tuple[int, ...]:
        return tuple(len(g.devices) for g in self.groups)


# ---------------------------------------------------------------------------
# Memory model (constraint C3) — coarse, following verl/Alpa conventions
# ---------------------------------------------------------------------------

def model_memory(wf: RLWorkflow, plan: Plan, t: int, j: int) -> float:
    """M_model for one tasklet of task t in pipeline stage j (bytes)."""
    task = wf.task(t)
    dp, pp, tp = plan.parallel[t]
    nl_j = plan.stage_layers(wf, t, j)
    per_layer = task.model.layer_weight_count
    w = per_layer * nl_j
    if j in (0, pp - 1):  # embedding / lm head
        w += task.model.vocab * task.model.h1
    bpp = TRAIN_BYTES_PER_PARAM if task.kind == TaskKind.TRAIN \
        else INFER_BYTES_PER_PARAM
    return w * bpp / tp


def working_memory(wf: RLWorkflow, plan: Plan, t: int, i: int, j: int) -> float:
    """M_working for tasklets of (t, i, j) (bytes)."""
    task = wf.task(t)
    dp, pp, tp = plan.parallel[t]
    nl_j = plan.stage_layers(wf, t, j)
    seq = wf.seq_in + wf.seq_out
    local_batch = wf.samples_per_iter * plan.replica_fraction(t, i)
    m = task.model
    if task.kind == TaskKind.GEN:
        h_kv = (m.n_kv_heads * m.head_dim) if m.n_kv_heads else m.h1
        if m.attention_free:
            h_kv = m.h1 // 8  # recurrent state, not seq-proportional
            seq_eff = 1
        else:
            seq_eff = seq
        wave = decode_wave(local_batch)
        return 2 * BYTES_BF16 * nl_j * h_kv * seq_eff * wave / tp
    mbs = min(wf.micro_batch, max(local_batch, 1))
    if task.kind == TaskKind.TRAIN:
        # full remat: saved block inputs + transient working set + logits
        act = BYTES_BF16 * mbs * seq * m.h1 * (nl_j + 8) / tp
        act += BYTES_BF16 * mbs * seq * m.vocab / tp * (1 if j == pp - 1 else 0)
        return act
    return BYTES_BF16 * mbs * seq * m.h1 * 8 / tp


def check_constraints(topo: Topology, wf: RLWorkflow, plan: Plan,
                      verbose: bool = False) -> Tuple[bool, str]:
    """C1 (tasklet count), C2 (cover/validity), C3 (memory)."""
    seen_tasks = set()
    for g in plan.groups:
        for t in g.tasks:
            if t in seen_tasks:
                return False, f"task {t} in two groups"
            seen_tasks.add(t)
    if seen_tasks != set(range(wf.n_tasks)):
        return False, "task grouping does not cover all tasks"

    dev_seen = set()
    for g in plan.groups:
        for d in g.devices:
            if d in dev_seen:
                return False, f"device {d} in two groups"
            dev_seen.add(d)

    mem_use = np.zeros(topo.n)          # sum of M_model per device
    mem_peak = np.zeros(topo.n)         # max M_working per device
    for t in range(wf.n_tasks):
        if t not in plan.parallel or t not in plan.assignment:
            return False, f"task {t} missing parallelization/assignment"
        dp, pp, tp = plan.parallel[t]
        asg = plan.assignment[t]
        if asg.shape != (dp, pp, tp):
            return False, f"task {t} assignment shape {asg.shape}"
        n_tasklets = dp * pp * tp
        if n_tasklets > topo.n:
            return False, f"task {t}: C1 violated ({n_tasklets} > {topo.n})"
        group = plan.group_of(t)
        gset = set(group.devices)
        flat = asg.reshape(-1)
        if len(set(flat.tolist())) != len(flat):
            return False, f"task {t}: tasklet devices not distinct"
        if not set(flat.tolist()) <= gset:
            return False, f"task {t}: devices outside its group"
        for i in range(dp):
            for j in range(pp):
                mm = model_memory(wf, plan, t, j)
                wm = working_memory(wf, plan, t, i, j)
                for d in asg[i, j]:
                    mem_use[d] += mm
                    mem_peak[d] = max(mem_peak[d], wm)
        if t in plan.layers_per_stage:
            if sum(plan.layers_per_stage[t]) != wf.task(t).model.n_layers:
                return False, f"task {t}: layer split does not sum"
        if t in plan.batch_fraction:
            if abs(sum(plan.batch_fraction[t]) - 1.0) > 1e-6:
                return False, f"task {t}: batch fractions do not sum to 1"

    for d in range(topo.n):
        if mem_use[d] + mem_peak[d] > topo.mem(d):
            return False, (f"OOM device {d} ({topo.devices[d].spec.name}): "
                           f"{mem_use[d] + mem_peak[d]:.2e} > "
                           f"{topo.mem(d):.2e}")
    return True, "ok"


def memory_overflow(topo: Topology, wf: RLWorkflow, plan: Plan) -> float:
    """max over devices of (required / capacity - 1), 0 if all fit.

    Assumes the plan is structurally valid (check_constraints covers that);
    used by the EA to grade infeasible-but-close candidates."""
    mem_use = np.zeros(topo.n)
    mem_peak = np.zeros(topo.n)
    for t in range(wf.n_tasks):
        dp, pp, tp = plan.parallel[t]
        asg = plan.assignment[t]
        for i in range(dp):
            for j in range(pp):
                mm = model_memory(wf, plan, t, j)
                wm = working_memory(wf, plan, t, i, j)
                for d in asg[i, j]:
                    mem_use[d] += mm
                    mem_peak[d] = max(mem_peak[d], wm)
    ratios = (mem_use + mem_peak) / np.array(
        [topo.mem(d) for d in range(topo.n)])
    return max(float(ratios.max()) - 1.0, 0.0)


def feasible_parallelizations(n_devices: int, n_layers: int,
                              max_tp: int = 8) -> List[Tuple[int, int, int]]:
    """All (dp, pp, tp) with dp*pp*tp <= n_devices, pp <= n_layers."""
    out = []
    for tp in [1, 2, 4, 8]:
        if tp > max_tp or tp > n_devices:
            continue
        for pp in range(1, min(n_layers, n_devices // tp) + 1):
            rem = n_devices // (tp * pp)
            for dp in range(1, rem + 1):
                out.append((dp, pp, tp))
    return out
