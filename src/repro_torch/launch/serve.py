"""Serving launcher: continuous-batching generation on the card.

Port of ``repro.launch.serve``.  Requests stream through the genserve
engine: at most --wave sequences decode concurrently, and finished slots
(EOS or budget) are recycled by prefill injection.  The report gives
valid tokens/s, time-to-first-token p50/p95, decode rounds, prefill
injections, the prefix-cache hit rate and the speculative accept rate
where they apply, and the measured decode-wave occupancy (busy occupancy
under chunked admission) next to the cost model's ideal.  Weights are
random, drawn from --seed.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
        --batch 48 --wave 16 --prompt-len 256 --new-tokens 64

Any architecture of attention, RWKV6 and Mamba layers with dense or MoE
FFNs runs at its full width in its config's dtype: ``--arch rwkv6-3b``
serves the 3.07 B-parameter RWKV6 model in bf16 with the same arguments,
and ``--arch pixtral-12b`` its decoder on token prompts, as the JAX
launcher does.  The encoder-only ``hubert-xlarge`` has no decode step
and exits with the JAX launcher's message.
``--arch jamba-1.5-large-398b`` builds the whole 72-layer Jamba model
(398.6 B parameters, 797 GB in bf16), which does not fit one
card; as the JAX launcher, this one has no depth flag.  A caller that
serves a depth cut passes its config to ``prepare`` / ``run`` (``cfg=``),
as ``chip_smoke.py`` does with the first 2 and 4 layers of Jamba's
period at full width.

Runs on ``--device cuda`` (the default; raises when no card is present)
or ``--device cpu``.  As the JAX launcher: ``--prefill-chunk N`` turns on
chunked admission (mixed wave-steps that ingest up to N prompt tokens
per round beside decode), ``--page-size`` the paged KV cache,
``--prefix-cache`` radix prefix reuse (it implies ``--page-size 8``; a
page size implies ``--prefill-chunk min(P, 16)``; ``--shared-prompts S``
makes the first S prompt tokens identical so that the cache has
something to hit, and ``--expect-prefix-hits`` exits non-zero on a zero
hit rate), and ``--spec-k K --draft-arch A`` draft-model speculative
decoding (the draft takes the target's vocab and dtype;
``--check-spec-parity`` also runs the plain engine and exits non-zero
unless greedy tokens match).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
        --smoke --batch 16 --wave 4 --prompt-len 32 --new-tokens 16 \\
        --prefill-chunk 8 --page-size 8 --prefix-cache --shared-prompts 24 \\
        --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional

import torch

from repro_torch.configs import archs
from repro_torch.core.plan import (decode_wave, predicted_occupancy,
                                   prefill_rounds)
from repro_torch.device import resolve_device, resolve_dtype, synchronize
from repro_torch.genserve import adapter as genserve
from repro_torch.genserve.adapter import ttft_quantiles
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
                    help="chunked admission: prompt tokens ingested per "
                         "mixed wave round (0 = one-shot prefill)")
    ap.add_argument("--eos-token", type=int, default=None,
                    help="retire sequences on this token id")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy")
    ap.add_argument("--page-size", type=int, default=0,
                    help="paged KV cache: tokens per pool page "
                         "(0 = contiguous per-slot cache)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="radix prefix reuse across requests (skips "
                         "prefill on cached prompt prefixes; implies "
                         "--page-size 8 unless given)")
    ap.add_argument("--shared-prompts", type=int, default=0,
                    help="make the first N prompt tokens identical "
                         "across requests (a shared system prompt)")
    ap.add_argument("--expect-prefix-hits", action="store_true",
                    help="exit nonzero unless the prefix-cache token "
                         "hit rate is > 0")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative decoding: draft tokens proposed "
                         "per wave round, verified by one batched "
                         "(k+1)-wide target step (0 = off)")
    ap.add_argument("--draft-arch", default="",
                    help="configs.archs entry for the speculative draft "
                         "model (vocab/dtype follow --arch); required "
                         "with --spec-k")
    ap.add_argument("--check-spec-parity", action="store_true",
                    help="greedy only: also run the non-speculative "
                         "engine and exit nonzero unless the emitted "
                         "tokens match exactly")
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
    if args.prefix_cache and args.page_size == 0:
        args.page_size = 8
    if args.page_size and args.prefill_chunk == 0:
        # paged admission is chunked by construction
        args.prefill_chunk = min(args.prompt_len, 16)
    if args.spec_k > 0 and not args.draft_arch:
        raise SystemExit("--spec-k needs --draft-arch")
    return args


def prepare(args: argparse.Namespace, cfg: Optional[ModelConfig] = None):
    """The serving run of `args`: returns (device, cfg, dtype, wave,
    gen), where ``gen(spec=True, **kw)`` serves every prompt once through
    ``genserve.generate`` on the seeded random weights with the engine
    flags of `args` (``spec=False`` leaves speculative decoding out).
    ``cfg`` replaces the config that ``--arch`` / ``--smoke`` name (a
    depth cut)."""
    device = resolve_device(args.device)
    cfg = cfg or archs.get(args.arch, smoke=args.smoke)
    if cfg.is_encoder_only:
        raise SystemExit(f"{cfg.name} is encoder-only: no decode serving "
                         f"(run classification via launch.train instead)")
    dtype = resolve_dtype(args.dtype or cfg.dtype)
    params = T.init_params(cfg, seed=args.seed, device=device, dtype=dtype)
    draft_params = draft_cfg = None
    if args.spec_k > 0:
        draft_cfg = dataclasses.replace(
            archs.get(args.draft_arch, smoke=args.smoke),
            vocab_size=cfg.vocab_size, dtype=cfg.dtype)
        draft_params = T.init_params(draft_cfg, seed=args.seed + 3,
                                     device=device, dtype=dtype)
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

    def gen(spec: bool = True, **kw):
        sgen = torch.Generator(device=device).manual_seed(args.seed + 2)
        use = spec and args.spec_k > 0
        return genserve.generate(
            params, cfg, prompts, sgen, sampler, wave=wave, fast_path=False,
            decode_chunk=args.decode_chunk,
            prefill_chunk=args.prefill_chunk, page_size=args.page_size,
            prefix_cache=args.prefix_cache,
            spec_k=args.spec_k if use else 0,
            draft_params=draft_params if use else None,
            draft_cfg=draft_cfg if use else None, device=device, **kw)

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
    ro_ref = None
    if args.check_spec_parity and args.spec_k > 0:
        ro_ref, _ = gen(spec=False)
    obs_metrics.reset()      # quantiles below describe this run only
    _, ttft_stats = gen(measure_ttft=True)
    valid = float(ro["mask"].sum())
    hit = float(stats.get("prefix_hit_rate", 0.0))
    ideal = predicted_occupancy(args.batch, wave=wave,
                                prefill_rounds=prefill_rounds(
                                    args.prompt_len, args.prefill_chunk,
                                    prefix_hit_rate=hit),
                                max_new_tokens=args.new_tokens)
    p50, p95 = ttft_quantiles(ttft_stats)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    admission = (f"chunked (C={args.prefill_chunk})"
                 if args.prefill_chunk else "one-shot")
    if args.page_size:
        admission += f" paged (page={args.page_size})"
    if args.prefix_cache:
        admission += " +prefix-cache"
    print(f"arch={cfg.name} engine={stats['engine']} wave={stats['wave']} "
          f"batch={args.batch} admission={admission} device={device} "
          f"({kind}) dtype={str(dtype).replace('torch.', '')}")
    print(f"generated {tuple(ro['gen_tokens'].shape)} in {dt:.3f}s "
          f"({valid / dt:.1f} valid tok/s; {stats['decode_steps']} decode "
          f"rounds, {stats['prefills']} prefill injections, "
          f"{stats['prefill_rounds']} prefill-chunk rounds)")
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
    if args.prefix_cache:
        print(f"prefix cache: {hit:.1%} token hit rate "
              f"({stats['prefill_tokens_skipped']} of "
              f"{stats['prompt_tokens']} prompt tokens skipped)")
    if args.spec_k > 0:
        print(f"speculative: k={stats['spec_k']} "
              f"draft={args.draft_arch} "
              f"accept rate {stats['accept_rate']:.1%} "
              f"({stats['spec_accepted']}/{stats['spec_proposed']} drafts; "
              f"{stats['spec_tokens']} tokens in {stats['decode_steps']} "
              f"verify rounds)")
    if args.prefill_chunk:
        print(f"busy wave occupancy (decode + prefill): "
              f"{stats['busy_occupancy']:.2f} "
              f"(cost-model ideal {ideal:.2f})")
    else:
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
    if args.expect_prefix_hits and hit <= 0.0:
        raise SystemExit("expected a nonzero prefix-cache hit rate "
                         f"(got {hit}) — shared-prompt trace not hitting")
    if ro_ref is not None:
        same = torch.equal(ro["gen_tokens"] * ro["mask"],
                           ro_ref["gen_tokens"] * ro_ref["mask"])
        if not same:
            raise SystemExit("speculative greedy decode diverged from the "
                             "non-speculative engine (token parity check)")
        print("spec parity: speculative == non-speculative (greedy)")
    return {"arch": cfg.name, "device": str(device), "kind": kind,
            "dtype": str(dtype), "batch": args.batch, "wave": wave,
            "admission": admission,
            "seconds": dt, "valid_tokens": valid, "tok_s": valid / dt,
            "decode_rounds": stats["decode_steps"],
            "prefills": stats["prefills"],
            "prefill_rounds": stats["prefill_rounds"], "ttft_p50_s": p50,
            "ttft_p95_s": p95, "mean_occupancy": stats["mean_occupancy"],
            "busy_occupancy": stats["busy_occupancy"],
            "ideal_occupancy": ideal, "peak_bytes": peak,
            "prefix_hit_rate": hit,
            "prefill_tokens_skipped": stats["prefill_tokens_skipped"],
            "accept_rate": stats["accept_rate"],
            "spec_proposed": stats["spec_proposed"],
            "spec_accepted": stats["spec_accepted"],
            "gen_tokens": ro["gen_tokens"], "logprobs": ro["logprobs"],
            "mask": ro["mask"]}


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
