"""Dry-run counts of every (arch x shape x mesh): per-device FLOPs, bytes
and collective bytes of one step, for the roofline analysis.

Port of ``repro.launch.dryrun``.  The reference lowers and compiles the
jitted step on 512 forced host devices and reads the HLO; here the step
runs on fake tensors (no memory, no device) sharded as DTensors over
the production mesh on a fake process group (``launch.mesh``), under
``op_analysis.OpCounter``, which counts each device's local ops.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
        --shape decode_32k [--multi-pod] [--out results/dryrun_torch]

Writes one JSON per combination, with the reference's record keys where
a counterpart exists: ``n_devices``, ``flops_per_device``,
``bytes_per_device``, ``collective_bytes_per_device``, ``params``,
``active_params``, ``seq_len``, ``global_batch``, ``phase``,
``argument_size_in_bytes`` / ``output_size_in_bytes`` /
``alias_size_in_bytes`` from the local shard sizes, and the peak:
``peak_bytes_per_device``, the most memory live at once on a device over
the step (``op_analysis``), and ``temp_size_in_bytes``, XLA's field, that
peak less the arguments and the outputs that are not the arguments'
storage (the in-place cache of a decode step).  ``counted_by`` is
``"torch dispatch"``; keys with no meaning here (``flops_xla_raw``,
``compile_s``, ``generated_code_size_in_bytes``) are left out.
``bytes_per_device`` counts every aten op as its own kernel, so it bounds
the reference's fused count from above; the peak is an eager step's,
each op's output live until its last reference goes.  The residual
stream is not sequence-parallel in a train step (``_rules``).  Attention
runs the plain path (full QK^T and PV, ``attn_impl="plain"``), as the
reference's dry-run counts its jnp attention; so do the RWKV6 and Mamba
scans (their chunk forms; Mamba's chunks of associative scans, as the
reference's).  This is the count,
not the card's path.  ``repro_torch.launch.roofline`` reads the JSONs.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
from typing import Dict

import torch

from repro_torch.configs import archs
from repro_torch.configs.shapes import (SHAPES, InputShape, input_specs,
                                        skip_reason)
from repro_torch.device import resolve_dtype
from repro_torch.launch import op_analysis
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import production_world
from repro_torch.models import attention as attn_mod
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adam
from repro_torch.parallel import sharding as sh
from repro_torch.tree import tree_leaves

# the line ``main`` writes to stderr when a count raises (``dryrun_all``
# reports it)
FAILED = "dry-run failed: "

_DTYPE_NAMES = {torch.bfloat16: "bf16", torch.float16: "f16",
                torch.float32: "f32"}


@contextlib.contextmanager
def plain_path():
    """Attention and the scans on their plain PyTorch paths for the
    block (the module default restored after)."""
    prev = attn_mod.get_attention_impl()
    attn_mod.set_attention_impl("plain")
    try:
        yield
    finally:
        attn_mod.set_attention_impl(prev)


def _local_bytes(tree) -> int:
    return sum((x.to_local() if sh.is_dtensor(x) else x).numel()
               * x.element_size() for x in tree_leaves(tree)
               if torch.is_tensor(x))


def build_step(cfg: ModelConfig, shape: InputShape, fake_mode, mesh=None):
    """(step, args) of ``shape``'s phase for ``cfg``: fake parameters
    (the config's dtype), Adam state for a train step (its layers
    recomputed in the backward, the reference's ``remat``) and
    ``input_specs`` made in ``fake_mode``, as DTensors on ``mesh`` by the
    step's sharding trees when a mesh is given."""
    with fake_mode:
        params = T.init_params(cfg, 0, dtype=cfg.dtype)
    batch = input_specs(cfg, shape, fake_mode=fake_mode)
    with fake_mode:
        if mesh is not None:
            params = steps_mod.distribute_tree(
                params, mesh, steps_mod.param_shardings(mesh, params))
            batch = steps_mod.distribute_tree(
                batch, mesh, steps_mod.batch_shardings(mesh, batch, shape))
        if shape.phase == "train":
            opt_cfg = adam.AdamConfig(
                moment_dtype="bfloat16" if cfg.param_count() > 1e11
                else "float32")
            opt = adam.init_adam_state(params, opt_cfg)
            return (steps_mod.make_train_step(cfg, opt_cfg, remat=True),
                    (params, opt, batch))
    if shape.phase == "prefill":
        return (steps_mod.make_prefill_step(
            cfg, long_mode=shape.long_mode, max_cache_len=shape.seq_len),
            (params, batch))
    return (steps_mod.make_serve_step(cfg, long_mode=shape.long_mode),
            (params, batch))


def _rules(mesh, shape: InputShape) -> Dict:
    """``steps.activation_rules`` with the residual stream whole along
    the sequence: a train step's sequence-parallel residual flattens to
    a strided shard, whose redistribution cost DTensor computes from
    index tensors that fake tensors cannot read.  The count is that of
    the step without sequence parallelism."""
    rules = steps_mod.activation_rules(mesh, shape)
    return {**rules, "residual": sh.P(rules["residual"][0], None, None)}


def _count_once(cfg: ModelConfig, shape: InputShape, mesh) -> Dict:
    from torch._subclasses.fake_tensor import FakeTensorMode
    fake_mode = FakeTensorMode(allow_non_fake_inputs=True)
    step, args = build_step(cfg, shape, fake_mode, mesh)
    with contextlib.ExitStack() as stack:
        stack.enter_context(fake_mode)
        stack.enter_context(plain_path())
        if mesh is not None:
            from torch.distributed.tensor.experimental import \
                implicit_replication
            stack.enter_context(sh.use_hints(_rules(mesh, shape)))
            stack.enter_context(implicit_replication())
        out, cost = op_analysis.analyze(step, *args)
    held = {op_analysis.storage_key(t)
            for t in op_analysis.local_tensors(args)}
    return {"flops_per_device": float(cost.flops),
            "bytes_per_device": float(cost.bytes),
            "collective_bytes_per_device": {k: float(v) for k, v in
                                            cost.collectives.items()},
            "argument_size_in_bytes": _local_bytes(args),
            "output_size_in_bytes": _local_bytes(out),
            "alias_size_in_bytes": sum(
                t.numel() * t.element_size()
                for t in op_analysis.local_tensors(out)
                if op_analysis.storage_key(t) in held),
            "peak_bytes_per_device": cost.peak_bytes,
            "_peak_op": cost.peak_op,
            "_rows": cost.rows}


# the repeat counts a deep model is counted at (``count_step``)
CUTS = (2, 3, 4)


def _extrapolate(f1, f2, f3, n: int):
    """Counts at ``CUTS`` repeats -> the count at ``n`` (number by number
    through dicts of the same keys): the quadratic through the three
    points, exact for work linear in the repeats and for autograd's
    accumulation of a stacked ``[R, ...]`` leaf's gradient (R slices of
    R x leaf: quadratic)."""
    if isinstance(f1, dict):
        return {k: _extrapolate(f1[k], f2[k], f3[k], n) for k in f1}
    d1, d2 = f2 - f1, f3 - 2 * f2 + f1
    m = n - CUTS[0]
    return type(f1)(f1 + m * d1 + m * (m - 1) // 2 * d2)


def _extrapolate_rows(r1, r2, r3, n: int):
    """Per-op rows at ``n`` repeats, for ranking (``op_profile``).  A row
    whose output shape carries the repeat count (an op on a stacked
    ``[R, ...]`` leaf) is in the first cut's count alone: its counts are
    scaled to ``n`` repeats."""
    out = {k: [_extrapolate(a, b, c, n) for a, b, c in
               zip(r1[k], r2[k], r3[k])]
           for k in r1 if k in r2 and k in r3}
    out.update({k: [n / CUTS[0] * x for x in v[:3]] + [v[3]]
                for k, v in r1.items() if k not in out})
    return out


def _peak(cuts, R: int, full) -> int:
    """The peak at ``R`` repeats from the counts at ``CUTS`` repeats:
    affine in the repeats when both the peak and the op at which it is
    first reached step by the same amount from one cut to the next
    (every repeat then adds the same live bytes before the same point
    of the step: its parameters, state and saved activations); else
    ``full()``'s, a count at the whole depth.  The cuts start at two
    repeats: at one, a train step's peak sits elsewhere."""
    p = [c["peak_bytes_per_device"] for c in cuts]
    n = [c["_peak_op"] for c in cuts]
    if p[2] - p[1] == p[1] - p[0] and n[2] - n[1] == n[1] - n[0]:
        return p[2] + (R - CUTS[2]) * (p[2] - p[1]), "affine in depth"
    return full()["peak_bytes_per_device"], "whole depth"


def count_step(cfg: ModelConfig, shape: InputShape, mesh=None) -> Dict:
    """One step of ``shape``'s phase on fake tensors (sharded on ``mesh``,
    or whole in a world of one), counted per device.

    Loop-aware, as the reference's HLO analysis multiplies a scanned
    body by its trip count: every repeat of the layer pattern does the
    same work, so a model of more repeats than ``CUTS`` holds is counted
    at those and the counts extrapolate to R (``_extrapolate``: exact
    for every count here, arguments and outputs included).  The
    peak extrapolates by ``_peak``'s affine rule, checked on the three
    counts, or is counted at the whole depth where the rule does not
    hold.  ``temp_size_in_bytes`` is XLA's: the peak less the arguments
    and the outputs that are not the arguments' storage."""
    R = cfg.n_pattern_repeats
    if R <= CUTS[-1]:
        rec = _count_once(cfg, shape, mesh)
        del rec["_peak_op"]
        peak_by = "whole depth"
    else:
        cuts = [_count_once(dataclasses.replace(
            cfg, n_layers=r * len(cfg.pattern)), shape, mesh)
            for r in CUTS]
        rows = _extrapolate_rows(*[c.pop("_rows") for c in cuts], R)
        peak, peak_by = _peak(cuts, R,
                              lambda: _count_once(cfg, shape, mesh))
        for c in cuts:
            del c["_peak_op"], c["peak_bytes_per_device"]
        rec = {**_extrapolate(*cuts, R), "peak_bytes_per_device": peak,
               "_rows": rows}
    n_dev = 1 if mesh is None else sh.mesh_size(mesh)
    peak = rec["peak_bytes_per_device"]
    temp = peak - rec["argument_size_in_bytes"] - (
        rec["output_size_in_bytes"] - rec["alias_size_in_bytes"])
    return {
        "n_devices": int(n_dev),
        "flops_per_device": rec["flops_per_device"],
        "bytes_per_device": rec["bytes_per_device"],
        "collective_bytes_per_device": rec["collective_bytes_per_device"],
        "params": int(cfg.param_count()),
        "active_params": int(cfg.active_param_count()),
        "seq_len": shape.seq_len, "global_batch": shape.global_batch,
        "phase": shape.phase,
        "argument_size_in_bytes": rec["argument_size_in_bytes"],
        "output_size_in_bytes": rec["output_size_in_bytes"],
        "alias_size_in_bytes": rec["alias_size_in_bytes"],
        "peak_bytes_per_device": int(peak),
        "temp_size_in_bytes": int(temp),
        "peak_counted": peak_by,
        "dtype": _DTYPE_NAMES.get(resolve_dtype(cfg.dtype), cfg.dtype),
        "counted_by": "torch dispatch",
        "attention": "plain",
        "bytes_counted": "operands + outputs of every aten op, unfused: "
                         "an upper bound",
        "_rows": rec["_rows"],
    }


def dryrun_one(arch: str, shape_name: str, multi_pod: bool,
               verbose: bool = True) -> Dict:
    """The record of one (arch, shape, mesh) on the production mesh (a
    fake world of 256 or 512 ranks, made for the call and destroyed
    after, unless a world is initialized already)."""
    cfg = archs.get(arch)
    shape = SHAPES[shape_name]
    reason = skip_reason(cfg, shape)
    if reason:
        return {"arch": arch, "shape": shape_name,
                "multi_pod": multi_pod, "skipped": reason}
    t0 = time.time()
    with production_world(multi_pod=multi_pod) as mesh:
        rec = count_step(cfg, shape, mesh)
    result = {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
              **rec, "count_s": round(time.time() - t0, 1)}
    if verbose:
        print(json.dumps(public(result), indent=2))
    return result


def public(rec: Dict) -> Dict:
    """The record without its per-op rows (``op_profile`` reads those)."""
    return {k: v for k, v in rec.items() if not k.startswith("_")}


def record_path(out: str, arch: str, shape: str, multi_pod: bool) -> str:
    tag = f"{arch}__{shape}__{'multi' if multi_pod else 'single'}"
    return os.path.join(out, tag + ".json")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    args = ap.parse_args(argv)

    try:
        result = dryrun_one(args.arch, args.shape, args.multi_pod)
    except Exception as e:
        first = (str(e).splitlines() or [""])[0]
        print(FAILED + type(e).__name__ + (f": {first}" if first else ""),
              file=sys.stderr, flush=True)
        raise
    os.makedirs(args.out, exist_ok=True)
    path = record_path(args.out, args.arch, args.shape, args.multi_pod)
    with open(path, "w") as f:
        json.dump(public(result), f, indent=2)
    print(f"wrote {path}")
    if "skipped" in result:
        print(f"SKIP: {result['skipped']}")


if __name__ == "__main__":
    main()
