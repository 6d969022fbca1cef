"""Rollout-contract adapter: genserve as a drop-in GEN executor.

Port of ``repro.genserve.adapter``.  ``generate`` returns exactly the
``rl.rollout.generate`` contract (``{sequences, gen_tokens, logprobs,
mask}``) plus an engine-stats dict.  When the whole batch fits one
decode wave (and no engine-only option is asked for) the single-wave
reference path is the fast path, and its wave stats are synthesized
from the validity mask.

``generate`` runs on ``device`` (``cuda`` by default; it raises when no
card is present unless the caller passes ``device="cpu"``), where the
params must already live.  ``mesh=`` runs the engine sharded over a
device mesh of ranks (``decoder.serve(mesh=)``) and, as the reference,
never takes the single-wave fast path: a caller that wants the
single-wave path on a mesh shards it itself (``engine.tasks``).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import plan as plan_mod
from repro_torch.device import resolve_device
from repro_torch.genserve.decoder import GenServeConfig, serve
from repro_torch.models.config import ModelConfig
from repro_torch.rl import rollout


def ttft_quantiles(stats) -> Tuple[float, float]:
    """(p50, p95) seconds over per-request time-to-first-token; (0, 0)
    when the run did not record TTFT."""
    ts = sorted(stats.get("ttft", {}).values())
    if not ts:
        return 0.0, 0.0
    return (float(np.percentile(ts, 50)), float(np.percentile(ts, 95)))


def wave_stats_from_mask(mask, wave: Optional[int] = None
                         ) -> Dict[str, object]:
    """Single-wave engine stats from a validity mask [B, N]: the useful
    occupancy at step t is the number of sequences whose token t is
    valid — the same metric genserve's slot table records."""
    m = np.asarray(torch.as_tensor(mask).cpu())
    B, N = m.shape
    trace = m.sum(axis=0)
    occ = float(m.sum() / max(N, 1))
    return {"engine": "single-wave", "wave": wave or B,
            "decode_steps": int(N),
            "slot_steps": int(m.sum()),
            "mean_occupancy": occ,
            "busy_occupancy": occ,
            "occupancy_trace": [int(c) for c in trace],
            "prefill_trace": [], "prefill_rounds": 0,
            "prefill_slot_steps": 0, "prefill_chunk": 0,
            "prefill_rounds_per_req": 0.0,
            "max_new_tokens": int(N), "ttft": {}, "queue_wait": {},
            "rounds": [], "prefills": 1, "admitted": B, "retired": B}


def _params_device(params) -> torch.device:
    return params["final_norm"]["scale"].device


def generate(params, cfg: ModelConfig, prompts,
             gen: Optional[torch.Generator],
             sampler: "rollout.SamplerConfig", *,
             wave: Optional[int] = None, decode_chunk: int = 1,
             gen_lens: Optional[Sequence[int]] = None,
             fast_path: bool = True, decode_path: str = "batched",
             admission: str = "fifo", prefill_chunk: int = 0,
             prompt_lens: Optional[Sequence[int]] = None,
             measure_ttft: bool = False, page_size: int = 0,
             prefix_cache: bool = False, pool_pages: int = 0,
             sjf_aging: int = 0,
             slot_failures: Optional[Dict[int, Sequence[int]]] = None,
             cancels: Optional[Dict[int, Sequence[int]]] = None,
             spec_k: int = 0, draft_params=None,
             draft_cfg: Optional[ModelConfig] = None, mesh=None,
             device: Union[str, torch.device] = "cuda"
             ) -> Tuple[Dict[str, torch.Tensor], Dict[str, object]]:
    """Continuous-batching generation with the rollout contract.

    `wave` defaults to ``core.plan.decode_wave(B)``; batches no larger
    than the wave take the single-wave reference path unless
    ``fast_path=False``, per-request budgets, chunked admission, the
    paged cache, speculative decoding, slot failures or cancels force the
    engine.  ``decode_path`` / ``admission`` pick the wave decode (the
    batched step or the per-slot loop) and the queue policy (FIFO or
    shortest-job-first, ``sjf_aging`` bounding starvation).
    ``prefill_chunk > 0`` turns on chunked admission (optional ragged
    ``prompt_lens``); ``page_size > 0`` the paged KV cache
    (``pool_pages`` overrides its size) and ``prefix_cache=True`` radix
    prefix reuse; ``slot_failures`` / ``cancels`` (round -> slot ids /
    request ids) inject slot deaths and cancels; ``spec_k > 0`` turns on
    draft-model speculative decoding (needs ``draft_params`` and
    ``draft_cfg``).  ``mesh`` (every rank of it calls ``generate`` alike)
    serves sharded over it; the rollout comes back full on every rank."""
    dev = resolve_device(device)
    if _params_device(params).type != dev.type:
        raise ValueError(f"params live on {_params_device(params)}, "
                         f"generate was asked to run on {dev}")
    prompts = torch.as_tensor(prompts, device=_params_device(params))
    B = int(prompts.shape[0])
    W = int(wave) if wave else plan_mod.decode_wave(B)
    if fast_path and mesh is None and gen_lens is None \
            and prefill_chunk == 0 and page_size == 0 and B <= W \
            and spec_k == 0 and not slot_failures and not cancels:
        ro = rollout.generate(params, cfg, prompts, gen, sampler)
        return ro, wave_stats_from_mask(ro["mask"], wave=min(W, B))
    gcfg = GenServeConfig(wave=min(W, B),
                          max_new_tokens=sampler.max_new_tokens,
                          decode_chunk=decode_chunk,
                          temperature=sampler.temperature,
                          eos_token=sampler.eos_token, greedy=sampler.greedy,
                          decode_path=decode_path, admission=admission,
                          prefill_chunk=prefill_chunk,
                          measure_ttft=measure_ttft, page_size=page_size,
                          prefix_cache=prefix_cache, pool_pages=pool_pages,
                          sjf_aging=sjf_aging, spec_k=spec_k)
    return serve(params, cfg, prompts, gen, gcfg, gen_lens=gen_lens,
                 prompt_lens=prompt_lens, slot_failures=slot_failures,
                 cancels=cancels, draft_params=draft_params,
                 draft_cfg=draft_cfg, mesh=mesh)
