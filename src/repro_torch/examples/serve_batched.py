"""Batched serving demo: continuous-batching decode for any assigned
architecture (smoke scale), reporting tokens/s, time-to-first-token
(p50/p95) and decode-wave occupancy — including the sliding-window
ring-buffer cache (mixtral/gemma2), recurrent-state decode (rwkv6/jamba)
and chunked prefill (--prefill-chunk: prompts are ingested in bounded
chunks riding along with decode rounds, so admission never stalls the
wave).

Port of ``examples/serve_batched.py``:

    PYTHONPATH=src python -m repro_torch.examples.serve_batched \\
        --arch mixtral-8x7b --prefill-chunk 16

Runs on the card (``--device cuda``, the default; raises without one)
or, with ``--device cpu``, on the plain PyTorch path.  The default
mixtral-8x7b smoke reaches ``flash_attention`` (one-shot admission) and
``decode_attention`` with its sliding window; ``--arch rwkv6-3b`` reaches
``rwkv6_scan`` and ``--arch jamba-1.5-large-398b`` ``mamba_scan``.  The
first call is the warm-up (on the card, the kernels' first launch);
``main`` returns the config and the timed call's rollout.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import torch

from repro_torch.configs import archs
from repro_torch.core.plan import decode_wave
from repro_torch.device import resolve_device, synchronize
from repro_torch.genserve import adapter as genserve
from repro_torch.genserve.adapter import ttft_quantiles
from repro_torch.models import transformer as T
from repro_torch.rl.rollout import SamplerConfig


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mixtral-8x7b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--wave", type=int, default=4)
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked admission tokens per mixed round "
                         "(0 = one-shot prefill)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = archs.get(args.arch, smoke=True)
    if cfg.is_encoder_only:
        raise SystemExit(f"{cfg.name}: encoder-only, no decode serving")
    if cfg.frontend == "features":
        print(f"note: {cfg.name} is a VLM; serving the text decoder only")
    params = T.init_params(cfg, seed=0, device=dev)
    prompts = torch.randint(
        0, cfg.vocab_size, (args.batch, args.prompt_len),
        generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    wave = args.wave or decode_wave(args.batch)
    sampler = SamplerConfig(max_new_tokens=args.new_tokens, greedy=True)
    gen = lambda **kw: genserve.generate(  # noqa: E731
        params, cfg, prompts, torch.Generator(device=dev).manual_seed(2),
        sampler, wave=wave, decode_chunk=4,
        prefill_chunk=args.prefill_chunk, fast_path=False, device=dev, **kw)
    gen()  # warm-up: the kernels' first launch
    synchronize(dev)
    t0 = time.time()
    ro, stats = gen()   # uninstrumented: TTFT stamping syncs admission
    synchronize(dev)
    dt = time.time() - t0
    _, ttft_stats = gen(measure_ttft=True)
    windows = sorted({s.window for s in cfg.pattern if s.window})
    p50, p95 = ttft_quantiles(ttft_stats)
    admission = (f"chunked C={args.prefill_chunk}" if args.prefill_chunk
                 else "one-shot")
    print(f"arch={cfg.name} (windows={windows or 'full'}) "
          f"batch={args.batch} wave={stats['wave']} "
          f"prompt={args.prompt_len} new={args.new_tokens} "
          f"admission={admission}")
    if args.prefill_chunk:
        occ_label = f"busy occupancy {stats['busy_occupancy']:.2f}"
    else:
        occ_label = f"mean occupancy {stats['mean_occupancy']:.2f}"
    print(f"decode throughput: {args.batch * args.new_tokens / dt:.1f} "
          f"tok/s ({dt:.2f}s; {occ_label}; "
          f"ttft p50={p50 * 1e3:.1f}ms p95={p95 * 1e3:.1f}ms)")
    print("sample:", ro["sequences"][0, args.prompt_len:][:16].tolist())
    return {"cfg": cfg, "rollout": ro}


if __name__ == "__main__":
    main()
