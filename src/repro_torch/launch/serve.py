"""Serving launcher: continuous-batching generation on the card.

Port of ``repro.launch.serve`` (one-shot admission, contiguous cache).
Requests stream through the genserve engine: at most --wave sequences
decode concurrently, and finished slots (EOS or budget) are recycled by
prefill injection.  The report gives valid tokens/s, time-to-first-token
p50/p95, decode rounds, prefill injections and the measured mean
decode-wave occupancy next to the cost model's ideal.  Weights are
random, drawn from --seed.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
        --batch 48 --wave 16 --prompt-len 256 --new-tokens 64

Any architecture of attention, RWKV6 and Mamba layers with dense or MoE
FFNs runs at its full width in its config's dtype: ``--arch rwkv6-3b``
serves the 3.07 B-parameter RWKV6 model in bf16 with the same arguments.
``--arch jamba-1.5-large-398b`` builds the whole 72-layer Jamba model
(398.6 B parameters, 797 GB in bf16), which does not fit one
card; as the JAX launcher, this one has no depth flag.  A caller that
serves a depth cut passes its config to ``prepare`` / ``run`` (``cfg=``),
as ``chip_smoke.py`` does with the first 2 and 4 layers of Jamba's
period at full width.

Runs on ``--device cuda`` (the default; raises when no card is present)
or ``--device cpu``.  --prefill-chunk, --page-size, --prefix-cache and
--spec-k (with the flags that only make sense beside them) are not yet
ported and raise ``NotImplementedError``.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import torch

from repro_torch.configs import archs
from repro_torch.core.plan import (decode_wave, predicted_occupancy,
                                   prefill_rounds)
from repro_torch.device import resolve_device, resolve_dtype, synchronize
from repro_torch.genserve import adapter as genserve
from repro_torch.genserve.adapter import ttft_quantiles
from repro_torch.genserve.decoder import NOT_PORTED
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.rl.rollout import SamplerConfig


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--wave", type=int, default=0,
                    help="decode slots (0 = core.plan.decode_wave(batch))")
    ap.add_argument("--decode-chunk", type=int, default=4,
                    help="decode steps per host round")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked admission (not yet ported)")
    ap.add_argument("--eos-token", type=int, default=None,
                    help="retire sequences on this token id")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy")
    ap.add_argument("--page-size", type=int, default=0,
                    help="paged KV cache (not yet ported)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="radix prefix reuse (not yet ported)")
    ap.add_argument("--shared-prompts", type=int, default=0,
                    help="make the first N prompt tokens identical "
                         "across requests (a shared system prompt)")
    ap.add_argument("--expect-prefix-hits", action="store_true",
                    help="prefix-cache hit gate (not yet ported)")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative decoding (not yet ported)")
    ap.add_argument("--draft-arch", default="",
                    help="speculative draft model (not yet ported)")
    ap.add_argument("--check-spec-parity", action="store_true",
                    help="speculative parity gate (not yet ported)")
    ap.add_argument("--trace", default=None, metavar="FILE",
                    help="write a Chrome-trace JSON of the serving run")
    ap.add_argument("--metrics", default=None, metavar="FILE",
                    help="dump the metrics-registry snapshot as JSON")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--dtype", default=None,
                    help="parameter/cache dtype (default: the config's)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the weights, the prompts and the sampler")
    args = ap.parse_args(argv)
    unported = {"--prefill-chunk": args.prefill_chunk,
                "--page-size": args.page_size,
                "--prefix-cache": args.prefix_cache,
                "--expect-prefix-hits": args.expect_prefix_hits,
                "--spec-k": args.spec_k, "--draft-arch": args.draft_arch,
                "--check-spec-parity": args.check_spec_parity}
    for flag, val in unported.items():
        if val:
            raise NotImplementedError(f"{flag}: {NOT_PORTED}")
    return args


def prepare(args: argparse.Namespace, cfg: Optional[ModelConfig] = None):
    """The serving run of `args`: returns (device, cfg, dtype, wave,
    gen), where ``gen(**kw)`` serves every prompt once through
    ``genserve.generate`` on the seeded random weights.  ``cfg`` replaces
    the config that ``--arch`` / ``--smoke`` name (a depth cut)."""
    device = resolve_device(args.device)
    cfg = cfg or archs.get(args.arch, smoke=args.smoke)
    if cfg.is_encoder_only:
        raise SystemExit(f"{cfg.name} is encoder-only: no decode serving")
    dtype = resolve_dtype(args.dtype or cfg.dtype)
    params = T.init_params(cfg, seed=args.seed, device=device, dtype=dtype)
    pgen = torch.Generator().manual_seed(args.seed + 1)
    prompts = torch.randint(0, cfg.vocab_size,
                            (args.batch, args.prompt_len), generator=pgen)
    if args.shared_prompts > 0:
        s = min(args.shared_prompts, args.prompt_len)
        prompts[:, :s] = prompts[0, :s]
    prompts = prompts.to(device)
    wave = args.wave or decode_wave(args.batch)
    sampler = SamplerConfig(max_new_tokens=args.new_tokens,
                            temperature=args.temperature,
                            eos_token=args.eos_token,
                            greedy=args.temperature <= 0)

    def gen(**kw):
        sgen = torch.Generator(device=device).manual_seed(args.seed + 2)
        return genserve.generate(params, cfg, prompts, sgen, sampler,
                                 wave=wave, fast_path=False,
                                 decode_chunk=args.decode_chunk,
                                 device=device, **kw)

    return device, cfg, dtype, wave, gen


def run(args: argparse.Namespace, cfg: Optional[ModelConfig] = None
        ) -> Dict[str, object]:
    """Warm-up, timed run and TTFT run of the serving path; returns the
    report (and prints it).  ``cfg`` as in ``prepare``."""
    if args.trace:
        obs_trace.enable()
    device, cfg, dtype, wave, gen = prepare(args, cfg)
    gen()                    # warm-up: kernel build and load, allocator
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    synchronize(device)
    t0 = time.time()
    ro, stats = gen()        # the timed run is uninstrumented
    synchronize(device)
    dt = time.time() - t0
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    obs_metrics.reset()      # quantiles below describe this run only
    _, ttft_stats = gen(measure_ttft=True)
    valid = float(ro["mask"].sum())
    ideal = predicted_occupancy(args.batch, wave=wave,
                                prefill_rounds=prefill_rounds(
                                    args.prompt_len, 0),
                                max_new_tokens=args.new_tokens)
    p50, p95 = ttft_quantiles(ttft_stats)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"arch={cfg.name} engine={stats['engine']} wave={stats['wave']} "
          f"batch={args.batch} admission=one-shot device={device} ({kind}) "
          f"dtype={str(dtype).replace('torch.', '')}")
    print(f"generated {tuple(ro['gen_tokens'].shape)} in {dt:.3f}s "
          f"({valid / dt:.1f} valid tok/s; {stats['decode_steps']} decode "
          f"rounds, {stats['prefills']} prefill injections)")
    snap = obs_metrics.snapshot()
    ttft_h = snap.get("gen.ttft_s") or {}
    qw = snap.get("gen.queue_wait_s") or {}
    print(f"ttft p50={p50 * 1e3:.1f}ms p95={p95 * 1e3:.1f}ms "
          f"p99={ttft_h.get('p99', 0.0) * 1e3:.1f}ms")
    if qw.get("count"):
        print(f"queue wait p50={qw['p50'] * 1e3:.1f}ms "
              f"p95={qw['p95'] * 1e3:.1f}ms "
              f"p99={qw['p99'] * 1e3:.1f}ms "
              f"(n={qw['count']})")
    print(f"mean wave occupancy: {stats['mean_occupancy']:.2f} "
          f"(cost-model ideal {ideal:.2f})")
    if device.type == "cuda":
        print(f"peak device memory: {peak / 2**30:.3f} GiB")
    print("sample:", ro["sequences"][0, :24].tolist())
    if args.trace:
        obs_trace.export_chrome(args.trace)
        print(f"trace -> {args.trace}")
    if args.metrics:
        obs_metrics.dump(args.metrics)
        print(f"metrics snapshot -> {args.metrics}")
    return {"arch": cfg.name, "device": str(device), "kind": kind,
            "dtype": str(dtype), "batch": args.batch, "wave": wave,
            "seconds": dt, "valid_tokens": valid, "tok_s": valid / dt,
            "decode_rounds": stats["decode_steps"],
            "prefills": stats["prefills"], "ttft_p50_s": p50,
            "ttft_p95_s": p95, "mean_occupancy": stats["mean_occupancy"],
            "ideal_occupancy": ideal, "peak_bytes": peak,
            "gen_tokens": ro["gen_tokens"], "logprobs": ro["logprobs"],
            "mask": ro["mask"]}


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
