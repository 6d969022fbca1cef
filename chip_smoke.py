#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Drives the port's serving path (``repro_torch``; no JAX, nothing of the
JAX package) at the full width of qwen3-0.6b (attention), of rwkv6-3b
(RWKV6 time mix) and of jamba-1.5-large-398b (attention + Mamba, dense
and MoE FFNs; its first 2 and 4 layers, since the whole model does not
fit one card), then the RL path (scheduler -> Plan -> engine -> GEN /
INF / TRAIN -> sync) at qwen3-0.6b's full width, the LM train mode,
checkpoints, the elastic plan swaps and fault recovery, and the rest of
genserve (chunked admission, the paged cache with prefix reuse,
speculative decoding, slot failures and cancels), then the rest of the
model zoo (hubert-xlarge's encoder and pixtral-12b at full width),
speculative GEN in the RL engine, the plan sharded over ranks that
share the card, the example scripts (``repro_torch.examples``), and
every kernel size to the wrappers' limits with Gemma 2 9B's widths
served, and exits non-zero on any failure.
Phases, each printing its result:

  1. card    nvidia-smi name and power limit, torch's device name/count;
             fails without CUDA.
  2. build   nvcc builds every kernel of the paths from
             src/repro_torch/csrc (one nvcc per source, in parallel) into
             build/kernels/; ptxas's registers, spills and shared memory
             per kernel of every source.
  3. kernels each CUDA kernel against its plain PyTorch version at the
             serving paths' shapes (attention also at Jamba's GQA-8
             heads and at pixtral-12b's 32:8 heads) and on a small
             matrix (hubert-xlarge's non-causal B 2, S 1000, 16:16 heads
             of 80 among its cases), timed beside the plain version
             and one library call where one exists; kernel and library
             times as median (min-max) of 30 calls, and each kernel's
             own device time (torch.profiler) over 30 more.
             Attention: GQA/MQA, hd 16/64/80/128 (16: trace_obs's
             actor), window, softcap, ragged S and L, fp32 and bf16;
             tolerance 2e-4 fp32 with TF32 off, 2e-2 bf16.  RWKV6 scan: N 32/64/128, S 1/63/65/100/256, B 1
             and 3, and strong decay (logw about -20) at chunks 16/32/64
             with S 150 and 77; tolerance 2e-3 (rtol and atol).  Mamba
             scan: ds 8/16, S 1/32/48/63/64/65/100 and 2048, ragged
             d_inner, dt*A down to -30 and below (d_inner 198: the 4-byte
             copy path); tolerance 1e-3 (rtol and atol) on y and h_end.
             Each scan's exponential count beside its time at 16 a clock
             per SM, at the SM clock nvidia-smi reads while the kernel
             runs (a note: the bound stays bytes / operations).  Both
             attention kernels also in fp32 at the RL path's shapes (GEN
             prefill of a wave of 32, INF over 64 rollouts of 8 tokens,
             a decode step of the wave), with their plain versions and
             sdpa.
  4. parity  full-width fp32 qwen3-0.6b served twice on the same seeded
             weights and prompts, with the kernels and with the plain
             attention: greedy tokens and masks identical, logprobs
             within 1e-3, both kernels launched.
  5. serve   ``repro_torch.launch.serve`` on qwen3-0.6b in bf16 (batch 48,
             wave 16, prompt 256, 64 new tokens); launch counts are zeroed
             just before and read just after; every flash_attention launch
             must be a tensor-core (bf16) one.
  6. parity  the same for rwkv6-3b: fp32, full width, "kernel" against
             "plain"; the kernel run launches rwkv6_scan, the plain run
             nothing.
  7. serve   the same serving run on rwkv6-3b in bf16; rwkv6_scan must
             launch.
  8. parity  the same for jamba-1.5-large-398b's first 2 layers (attention
             + SwiGLU, Mamba + MoE) at full width in fp32: the kernel run
             launches mamba_scan, flash_attention and decode_attention,
             the plain run nothing.
  9. serve   the first 4 layers (three Mamba, both MoE) in bf16 through
             ``serve.run(args, cfg=...)`` with phase 5's traffic; every
             kernel of the path launches exactly once per layer per
             admit (mamba_scan, flash_attention, all on the tensor cores)
             or per decode step (decode_attention).
 10. parity  RL: one greedy PPO iteration of full-width qwen3-0.6b (vocab
             16, fp32), 16 prompts x 4 rollouts = 64 rows (two decode
             waves), run twice from the same state: with the kernels and
             with the plain attention everywhere.  Tokens and masks
             identical, log-probs / reference log-probs / values / GAE
             advantages before whitening within 1e-3, critic loss and
             grad norm within 1e-3 relative (the policy loss, about
             1e-8 over an unchanged policy, is printed only); the kernel
             run launches flash_attention in GEN and INF and
             decode_attention in GEN, TRAIN launches nothing (counts set
             to 0 at each stage boundary), the plain run nothing.
 11. train   ``repro_torch.launch.train --arch qwen3-0.6b --batch 16``
             through ``run_rl``: GRPO 3 steps, GRPO --async 3 steps, PPO
             2 steps (plan, predicted and measured ms/iter, each task's
             ms from the Event timeline, peak memory, launches per stage);
             then ``python -m repro_torch.examples.train_rl_e2e --iters 30
             --batch 16 --ckpt-every 10``: the e2e actor (d 192, 4 layers,
             4:2 heads of 48) for 30 GRPO iterations of 16 prompts x 8
             rollouts (128 GEN rows in waves of 32 on genserve), its
             rewards at iterations 0, 10, 20, 29, final accuracy,
             measured vs predicted ms/iter and wave occupancy; TRAIN
             launches nothing.  The RL rows of the kernels line take
             their launches from the GRPO run, the e2e rows from this.
 12. lm      ``repro_torch.launch.train --arch qwen3-0.6b --steps 5 --batch
             4 --seq 64``: the LM mode at full width in bf16 (vocab
             151,936); losses and grad norms finite, the step-0 loss within
             0.1 of its expectation over uniform labels on the step-0
             logits (ln V plus the init's logit spread); ms/step and peak
             memory.  Then one step of the first 2 layers in fp32 on the
             card against the same step on the CPU: loss and grad norm
             within 2e-4 relative, post-Adam parameters within 2e-4 where
             the two gradients agree (2 lr + 2e-4 elsewhere).
 13. ckpt    ``checkpoint.io`` on the card: the full-width RL actor (fp32,
             1.76 GB) and the LM phase's bf16 parameters, cuda -> file ->
             cuda bit for bit, write and read GB/s; the full-width GRPO
             ``state_tree`` (8.8 GB) refused with ``CheckpointError``
             naming the 4 GiB cap, no file and no .tmp left.
 14. elastic ``ElasticController`` (``ckpt_dir=None``) on the full-width GRPO
             trainer (vocab 16, fp32, batch 16): drop_tail swaps the plan
             (two epochs in ``epoch_report``), transient_crash is absorbed
             by retries, permanent_crash forces a replan, link_throttle
             fires a reactive replan after the calibration warmup; in every
             iteration, before and after each event, GEN launches both
             attention kernels and INF flash_attention, TRAIN none.
 15. launcher ``launch.train --rl grpo --require-recover`` with ``--drift
             drop_tail``, ``--fault ckpt_fail``, ``ckpt_flaky``,
             ``ckpt_corrupt`` and ``slot_failure`` at full width cut to the
             first 8 layers (the whole state, 2.5 GB, must fit the format's
             4 GiB); ``ckpt_corrupt`` prints ``load_latest fell back to
             ...``, ``slot_failure`` ``N slot failures requeued``.
 16. control no fault: the phase-14 trainer with the monitor and deadlines
             armed as the launcher arms them, 12 iterations; how often
             each fires (printed, not a gate); the local microbench of
             ``core.profiler``.
 17. genserve the rest of the engine at qwen3-0.6b's full width in fp32
             on its first 14 layers (a depth cut for the script's time:
             every mode's parity holds at any depth; batch 48, wave 16,
             prompt 256 with 128 shared tokens, 64 new, greedy), each
             run against one-shot admission: chunked
             (C=64), paged (page 16, identity block table), paged with
             prefix reuse (hit rate > 0, no leaked page under
             REPRO_OBS_STRICT=1), speculative k=4 with a 2-layer draft of
             the target's first layers (one-shot) and with the target as
             its own draft (chunked), slot failures {2: [0, 1]} and
             cancels {3: [2, 40]}: tokens and masks identical, log-probs
             within 1e-3; decode_attention launches in every run,
             flash_attention in one-shot admission only.  Then rwkv6-3b
             and Jamba's first 2 layers (MoE capacity_factor E / top_k:
             no token dropped), chunked against one-shot: identical, the
             scan kernels launched in one-shot only.
 18. serve   ``launch.serve`` in bf16 with phase 5's traffic: --prefill-chunk
             64; --page-size 16 --prefix-cache --shared-prompts 128
             --expect-prefix-hits; --spec-k 4 --draft-arch with the
             engine's default draft of qwen3-0.6b (its first 7 layers,
             window-free: ``default_draft``) (tok/s, TTFT, hit and accept
             rates, peak memory, launches per kernel); the paged view's
             gather per decode step.
 19. rl      phase 10's PPO iteration with GEN on genserve's chunked
             admission (prefill_chunk 16, decode_chunk 2): tokens identical
             to phase 10's, GEN launches decode_attention and no
             flash_attention, TRAIN nothing.
 20. zoo     hubert-xlarge at full width (48 layers, d 1280, 16:16 heads of
             80): one encoder forward in fp32 on features [2, 1000, 512],
             with the kernels and with the plain attention, logits within
             2e-4 (rtol and atol, TF32 off), the kernel run launching
             flash_attention 48 times, all non-causal, and no
             decode_attention; the same in bf16 at [4, 1024] (48
             tensor-core launches); ``launch.train --arch hubert-xlarge
             --steps 3 --batch 4 --seq 1024`` (bf16); ``launch.serve --arch
             pixtral-12b`` at full width on its first 20 of 40 layers (a
             depth cut for the script's time), in bf16 with phase 5's
             traffic (flash_attention once per layer per admit, all on
             the tensor cores, decode_attention once per layer per
             decode step);
             ``launch.train --arch pixtral-12b --steps 3 --seq 256`` on its
             first 8 of 40 layers (128 feature positions, 128 tokens);
             then hubert's non-causal attention at [4, 1024, 16, 80] in
             bf16 and fp32 against the plain version and sdpa, timed as
             phase 3 times its rows.
 21. rl spec phase 10's PPO iteration with speculative GEN (spec_k 4, the
             default draft: 7 window-free layers): tokens and masks
             identical to phase 10's, log-probs within 1e-3; GEN launches
             flash_attention in both models' one-shot prefill and
             decode_attention in the draft's steps (verify is plain),
             TRAIN nothing; accept rate and GEN ms; then ``launch.train
             --rl grpo --spec-k 4`` for 2 steps.
 22. sharded the probe: 2 ranks on cuda:0 over gloo run each collective
             sharded execution needs (``parallel.dist.probe_collectives``;
             the phase fails unless every one passes).  Then
             ``launch.sharded_exec``'s gen | rest plan (GEN and TRAIN at
             DP 2 / TP 2, async GRPO, 4 prompts x 8 rollouts) on
             qwen3-0.6b's first 8 layers at full width (fp32, vocab 16):
             folded onto the card in this process (a collision, no
             overlap, overlap_honest 0.0), and as 8 ranks sharing the
             card (spawned, gloo): on each GEN and INF rank the two
             attention kernels called as the path calls them, on
             DTensors at its per-rank shapes, against their plain
             versions on the full tensors (2e-4); greedy and sampled
             runs held by ``sharded_exec.check`` against the world of
             one (the GEN weights equal to the actor bit for bit after
             every sync), the first trained loss and one actor step on a
             fixed batch within 1e-5 relative, per rank GEN launching
             both attention kernels, INF flash only, TRAIN none;
             ms/iter overlapped and with the stage walk
             serialized, the weight sync's GB and ms, peak memory per
             rank; every sharded GEN replayed in a world of one on the
             GEN ranks' own weights and generator state
             (``sharded_exec._gen_replay``: tokens identical).  Ranks
             sharing one card show the mechanism, not a multi-GPU
             speedup.
 23. sharded genserve: (a) phase 22's plan with 8 prompts x 8 rollouts =
             64 GEN rows, two decode waves of 32, so GEN serves on
             genserve on the DP 2 / TP 2 GEN mesh, greedy, one-shot and
             ``prefill_chunk`` 16, held against the plan folded onto the
             card (tokens and masks identical), the kernels at the
             engine's per-rank shapes vs plain (2e-4), launches per rank
             and task kind; (b) ``genserve.generate(mesh=)`` on 4 ranks
             sharing the card: qwen3-0.6b's first 8 layers at full width
             with its own vocab (fp32), 24 requests, wave 8, prompt 64
             with 32 shared, 16 new, paged with prefix reuse,
             speculative (k 4, a 2-layer draft), slot failures with
             cancels, each token for token against the world of one on
             the card with zero leaked pages, both kernels per rank at
             the engine's shapes vs plain (2e-4), per-rank launches and
             peak memory, wall time, hit and accept rates; then both
             kernels timed at those per-rank shapes (kernel, plain,
             sdpa, bound).
 24. elastic ranks ``launch.train --rl grpo --batch 8 --search-budget 40``
             through ``run_rl`` on qwen3-0.6b's first 8 layers at full
             width (fp32, vocab 16) as 8 ranks sharing the card over gloo,
             and in a world of one on the card: ``--drift drop_tail``,
             ``--fault permanent_crash --require-recover`` and ``--fault
             ckpt_corrupt --require-recover``; every rank's recovery line
             and replans the same, and the world of one's (the reactive
             ones read measured time and are printed only; where they
             differ, the recovery line's kind); placements
             per rank before and after; ms/iter per plan epoch,
             reschedule seconds, the checkpoint's GB, gather and write
             seconds, GB/s; launches per rank and (epoch, task): GEN both
             attention kernels, reference inference flash, TRAIN none;
             both kernels within 2e-6 of plain at each rank's last
             per-rank shapes, then timed at drop_tail's (kernel, plain,
             sdpa, bound).

 25. roofline qwen3-0.6b at full width and depth in bf16, seed-made
             weights: (a) ``core.profiler.profile_local()`` on the card;
             (b) ``launch.dryrun.dryrun_one`` for decode_32k on the
             single-pod fake mesh (fake tensors on the host: the record
             and its ``launch.roofline`` row, with the host seconds);
             (c) ``launch.steps``' prefill [4, 4096], serve (batch 32,
             a cache of 8192) and train (the largest batch of 8, 4, 2, 1
             that fits at S 4096) steps on the card: CUDA-event ms
             (median, min, max of 10 calls after 2; the train step one
             call after 1), peak memory, kernel launches per step (train
             none), the MFU (model FLOPs 2 N D, 6 N D to train, over ms
             x 989 TFLOP/s), beside the world-of-one count of the same
             shape on the plain path (full S^2 attention, unfused bytes:
             no bound on the kernel path), its times at 989 TFLOP/s and
             3.35 TB/s and their max / measured, and its peak beside
             ``torch.cuda.max_memory_allocated`` (the train step's within
             10%); every cut named on its line; (d) the prefill and
             serve steps with the kernels against the same steps on the
             plain attention (|a - b| / (1 + |b|) of the logits): in
             bf16 at all 28 layers within 0.1 and within 1.25 x the gap
             of torch's sdpa in the plain attention's place (the bf16
             gap grows with depth for any fused attention), at the first
             2 layers within 2e-2, the prefill in fp32 on the first 4
             layers within 2e-4; the plain steps' peak memory beside the
             count's; then flash_attention at [4, 4096, 16:8, 128] bf16
             causal and decode_attention at batch 32 over 8192 slots
             bf16, timed as phase 3 times its rows.
 26. mesh    MoE models and heads that ``model`` does not divide, on 4
             ranks sharing the card (gloo), full width, cut in depth,
             fp32, greedy, seeded weights, through
             ``genserve.generate(mesh=)`` against the world of one on
             the card token for token: granite-moe-3b-a800m's first 8
             layers on a 2x2 mesh (40 experts over ``model``: expert
             parallel), one-shot and ``prefill_chunk`` 16; mixtral-8x7b's
             first layer on a 2x2 mesh (tensor parallel on the experts'
             FFN), one-shot; phi3-medium-14b's first 2 layers on a 1x4
             mesh (``model`` 4 does not divide its 10 KV heads), one-shot;
             wall time, peak memory and launches per rank (both
             attention kernels on every rank), both kernels at the
             engine's per-rank shapes vs plain (2e-4); ``rwkv6_scan`` and
             ``mamba_scan`` on DTensors at rwkv6-3b's and Jamba's per-rank
             shapes of a 2x2 mesh vs plain (2e-3, 1e-3); then every
             per-rank shape timed in this process (kernel, plain, sdpa,
             bound).
 27. examples ``repro_torch.examples`` on the card: ``serve_batched`` with
             its defaults (the mixtral-8x7b smoke), with
             ``--prefill-chunk 16``, ``--arch rwkv6-3b`` and ``--arch
             jamba-1.5-large-398b``, each against the same run under
             ``attention.set_attention_impl("plain")``: tokens identical,
             the kernels of its path launched (one-shot: flash and decode,
             plus rwkv6_scan or mamba_scan; chunked: decode), the plain run
             none; ``trace_obs`` (a 1-layer actor of 2 heads of 16): both
             attention kernels at head dim 16 in GEN, flash in INF, none
             in TRAIN, its Chrome trace valid; ``train_rl_elastic
             --require-switch`` (drop_tail swaps the plan; TRAIN launches
             nothing); then both attention kernels at the e2e actor's and
             trace_obs's GEN prefill, GEN decode and INF shapes (fp32)
             against plain and timed (kernel, plain, sdpa, bound).
 28. sizes   every size the JAX package's kernel wrappers take, up to the
             port's limits: (b) both attention kernels at head dims 8,
             24, 40, 72, 112, 136, 160, 192, 200, 256 in fp32 and bf16,
             and at rows that are no multiple of 16 bytes: 7, 130, 255
             in fp32, 12 and 201 in bf16 (decode copies them element by
             element; flash pads the bf16 ones to 16 and 208: the padded
             counter reads 1 a call there, elsewhere 0), flash causal,
             windowed and softcapped, decode over 1, 10 and 63 splits,
             against plain (2e-4 fp32, 2e-2 bf16); (c)
             rwkv6_scan at head sizes 16, 48, 96 and mamba_scan at state
             sizes 4, 12, 24, 32 against plain (2e-3, 1e-3); (a) Gemma
             2 9B's widths (d 3584, 16:8 heads of 256, GeGLU 14336,
             window 4096, softcaps 50 and 30, its first 4 layers, 1.71 B
             parameters with the 256000-token embedding), seeded bf16
             weights, served through ``genserve`` (6 requests, wave 4,
             prompt 256, 12 new, greedy) with the kernels and under
             ``set_attention_impl("plain")``: tokens identical, flash
             once per layer per admit, decode once per layer per step,
             none padded, the plain run none; then the final hidden
             states of the first wave's prefill, kernel against plain,
             within 1e-2 (|a - b| / |b|), where a flash attention at the
             scale of hd 128 and one that drops Q.K's last 64-column
             panel must land beyond it; (d) flash at [4, 256, 16:8, 256]
             and decode at [16, 16, 256] over 320 slots and at the
             served wave's last step ([4, 16, 256] over 268) in bf16
             timed (kernel, plain, sdpa, bound).

Each phase's seconds are printed as it ends (``[time] phase N``) and
together before the kernels line.  Then one JSON line with every
kernel's numbers, the card line, and the last line ``{"ok": true,
"device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import subprocess
import sys
import threading
import time
import zlib
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
EXP_PER_CLOCK_PER_SM = 16          # MUFU exponentials (CUDA guide, cc 9.0)
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}
ARCH = "qwen3-0.6b"
RWKV_ARCH = "rwkv6-3b"
JAMBA_ARCH = "jamba-1.5-large-398b"
HUBERT_ARCH = "hubert-xlarge"
PIXTRAL_ARCH = "pixtral-12b"
LAYERS17 = 14                      # phase 17's depth cut of qwen3-0.6b
LAYERS20 = 20                      # phase 20's of pixtral-12b's serving run
LAYERS22 = 8                       # phase 22's depth cut of qwen3-0.6b


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(fn, torch, flush, iters: int = 30, warmup: int = 3):
    """(median, min, max) CUDA-event time of one call in ms over ``iters``
    calls, L2 flushed before each call (the serving path meets every
    layer's K/V cold).  A sleep of about 0.5 ms on the card after the
    flush lets the host queue the call before the timed span opens, so
    the span holds the card's work and not the wrapper's host time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(1_000_000)        # clock cycles
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    times.sort()
    return times[len(times) // 2], times[0], times[-1]


PROFILE_ATTEMPTS = 6     # profiling sessions before device_ms fails
PROFILE_SPARE = 10       # calls a session makes beyond the ones it times


def device_ms(fn, torch, flush, kernel: str, iters: int = 30):
    """(median, min, max) of one kernel's own device time in ms, from
    torch.profiler over its last ``iters`` of ``iters + PROFILE_SPARE``
    calls with the L2 flushed before each.  A pass of its own after
    ``time_ms``'s, so that the tracing adds nothing to the event times;
    ``kernel`` is part of the kernel's name."""
    from repro_torch.launch.profile_serve import device_events
    acts = [torch.profiler.ProfilerActivity.CUDA]
    for attempt in range(PROFILE_ATTEMPTS):
        # a profiling session now and then returns no device activity at
        # all, or misses some launches (seen on the card in phases 3, 20,
        # 24 and 26: 0, 10, 23, 26, 28 or 29 of 30 or 32): the spare calls
        # absorb missed launches, and a session that still sees fewer
        # than ``iters`` is printed and profiled again
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(iters + PROFILE_SPARE):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        events = sorted((ev for ev in device_events(prof)
                         if ev["cat"] == "kernel" and kernel in ev["name"]),
                        key=lambda ev: ev["ts"])
        if len(events) >= iters:
            break
        print(f"[3 kernels] the profiler saw {len(events)} launches of "
              f"{kernel} in {iters + PROFILE_SPARE} calls, fewer than "
              f"{iters} (attempt {attempt + 1})", flush=True)
    check(len(events) >= iters, f"the profiler saw {len(events)} launches "
          f"of {kernel}, fewer than {iters}")
    times = sorted(ev["dur"] / 1e3 for ev in events[-iters:])
    return times[len(times) // 2], times[0], times[-1]


def spread(t) -> str:
    return f"{t[0]:.4f} ms ({t[1]:.4f}-{t[2]:.4f})"


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def tol(dtype, torch) -> float:
    return 2e-2 if dtype == torch.bfloat16 else 2e-4


def rel_err(a, b, rtol: float) -> float:
    """Largest |a - b| / (1 + |b|): at most ``rtol`` means
    allclose(a, b, rtol=rtol, atol=rtol)."""
    d = (a.float() - b.float()).abs()
    return float((d / (1.0 + b.float().abs())).max())


def rwkv_work(B: int, S: int, H: int, N: int, C: int):
    """(bytes, fp32 FLOPs, exponentials) of the RWKV6 scan as the
    sub-chunked algorithm computes it on these shapes: each input read
    once, y and the state written once; chunks of C positions (the last
    one ragged) cut into sub-chunks of 16.  Scores: inside a sub-chunk one
    exponential and 4 operations per (t, s, n) of its pairs s < t; across
    sub-chunks 2 N per pair, on r and k decayed at an exponential and 2
    operations per element (r once per row past the first sub-chunk, k
    once per row and later sub-chunk)."""
    nbytes = 4 * (5 * B * S * H * N + H * N + B * H * N * N)
    flops = exps = 0
    for c0 in range(0, S, C):
        c = min(C, S - c0)
        sub = [min(16, c - i) for i in range(0, c, 16)]
        diag = sum(n * (n - 1) // 2 for n in sub)
        cross = c * (c - 1) // 2 - diag
        decayed = c - sub[0] + sum(n * (len(sub) - 1 - i)
                                   for i, n in enumerate(sub))
        flops += diag * N * 4 + cross * N * 2 + decayed * N * 2
        flops += c * N * 3              # diagonal r . u . k
        flops += c * N * (2 * N + 1)    # r * e^{cum_ex}, then @ S
        flops += (c * (c + 1) // 2) * N * 2   # scores @ v over s <= t
        flops += c * N * (2 * N + 2)    # k * e^{total - cum}, then ^T @ v
        flops += N * N                  # e^{total} * S
        exps += (diag + decayed + 2 * c) * N + N
    return nbytes, flops * B * H, exps * B * H


def mamba_work(B: int, S: int, di: int, ds: int):
    """(bytes, fp32 operations) of the selective scan on these shapes:
    dt, x read and y written once, Bm, Cm, A read once, h_end written
    once; per state element and step dt*A, exp, the decay product,
    dx*B, the sum, h*C and its sum (an exponential counted as one), and
    dt*x once per channel and step."""
    nbytes = 4 * (3 * B * S * di + 2 * B * S * ds + di * ds + B * di * ds)
    return nbytes, B * S * di * (7 * ds + 1)


def sm_clock_mhz(fn, torch, seconds: float = 1.0,
                 limit: float = 30.0) -> float:
    """Median SM clock (MHz) that nvidia-smi reads while ``fn`` runs back to
    back for about ``seconds`` (at least three readings).  Fails if the
    reader fails (no nvidia-smi, a reading that is not a number) or has not
    read three times within ``limit`` seconds."""
    readings, errors, done = [], [], threading.Event()

    def poll():
        try:
            while not done.is_set():
                out = subprocess.run(
                    ["nvidia-smi", "--query-gpu=clocks.sm",
                     "--format=csv,noheader,nounits"], capture_output=True,
                    text=True, timeout=60, check=True).stdout.split()
                readings.append(float(out[0]))
        except Exception as exc:        # re-raised below, in the caller
            errors.append(exc)

    th = threading.Thread(target=poll)
    th.start()
    t0 = time.monotonic()
    try:
        while not errors and time.monotonic() - t0 < limit and (
                time.monotonic() - t0 < seconds or len(readings) < 3):
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
    finally:
        done.set()
        th.join()
    check(not errors, f"reading clocks.sm with nvidia-smi failed: "
          f"{errors[0] if errors else ''!r}")
    check(len(readings) >= 3, f"nvidia-smi read clocks.sm {len(readings)} "
          f"times in {limit:.0f} s, not 3")
    readings.sort()
    return readings[len(readings) // 2]


def exp_floor_line(name, n_exp, ms, mhz, sms) -> str:
    floor = n_exp / (EXP_PER_CLOCK_PER_SM * sms * mhz * 1e6) * 1e3
    return (f"[3 kernels] {name} exponentials: {n_exp / 1e9:.4f} G, "
            f"{floor:.4f} ms at {EXP_PER_CLOCK_PER_SM} a clock per SM on "
            f"{sms} SMs at {mhz:.0f} MHz (nvidia-smi clocks.sm while it "
            f"ran); kernel {ms:.4f} ms (note, not the bound)")


@contextlib.contextmanager
def registered(cfg):
    """``cfg`` as a ``configs.archs`` entry for the block, so that a
    launcher's ``--draft-arch`` can name it."""
    from repro_torch.configs import archs
    archs.ARCHS[cfg.name] = cfg
    try:
        yield cfg.name
    finally:
        del archs.ARCHS[cfg.name]


def default_draft(cfg):
    """The engine's default speculative draft of ``cfg``
    (``engine.tasks._draft_model``): a window-free copy with
    ``len(pattern) * max(R // 4, 1)`` layers."""
    pattern = tuple(dataclasses.replace(s, window=None)
                    for s in cfg.pattern)
    return dataclasses.replace(
        cfg, name=f"{cfg.name}-draft", pattern=pattern,
        n_layers=len(pattern) * max(cfg.n_pattern_repeats // 4, 1))


def first_layers(cfg, n: int):
    """The first n layers of cfg's pattern at full width (a depth cut)."""
    return dataclasses.replace(cfg, n_layers=n, pattern=cfg.pattern[:n])


def rel_close(a: float, b: float, rtol: float = 1e-3) -> bool:
    """|a - b| within rtol of the larger magnitude."""
    return abs(a - b) <= rtol * max(abs(a), abs(b))


class StageLaunches:
    """Kernel launches per engine stage of each RL iteration: a wrapper of
    the trainer's ``before_stage`` hook (called before every stage) and of
    ``iteration`` reads the attention kernels' counts at each stage
    boundary and sets them to 0 again, so each stage reads its own."""

    def __init__(self, fa, dec):
        self.fa, self.dec = fa, dec
        self.iters = []           # [[(task names, flash, decode), ...], ...]
        self._stage = None

    def _close_stage(self):
        if self._stage is not None:
            self.iters[-1].append((self._stage, self.fa.launches,
                                   self.dec.launches))
        self.fa.launches = self.fa.launches_tc = self.dec.launches = 0

    def install(self, cls):
        orig_bs, orig_it = cls.before_stage, cls.iteration
        hook = self

        def before_stage(trainer, stage_tasks, bb):
            hook._close_stage()
            hook._stage = tuple(t.name for t in stage_tasks)
            hook.bb = bb
            return orig_bs(trainer, stage_tasks, bb)

        def iteration(trainer, *a, **k):
            hook.iters.append([])
            hook._stage = None
            hook._close_stage()
            try:
                return orig_it(trainer, *a, **k)
            finally:
                hook._close_stage()
                hook._stage = None
        cls.before_stage, cls.iteration = before_stage, iteration
        return lambda: (setattr(cls, "before_stage", orig_bs),
                        setattr(cls, "iteration", orig_it))

    def by_kind(self, it: int):
        """{"GEN"/"INF"/"TRAIN": (flash, decode)} of iteration ``it``."""
        out = {}
        for names, f, d in self.iters[it]:
            kind = ("GEN" if "actor_generation" in names else
                    "TRAIN" if any(n.endswith("_training") for n in names)
                    else "INF")
            pf, pd = out.get(kind, (0, 0))
            out[kind] = (pf + f, pd + d)
        return out


class GenCalls:
    """Within the block, each call of the RL GEN task's
    ``genserve.generate`` leaves its engine stats (the engine pops them
    from the blackboard into its timeline) and its ms, the card
    synchronized on both sides, in ``stats`` / ``ms``."""

    def __init__(self, torch):
        from repro_torch.engine import tasks
        self.torch, self.mod = torch, tasks.genserve
        self.stats, self.ms = [], []

    def __enter__(self):
        self.orig = orig = self.mod.generate

        def generate(*a, **k):
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            ro, st = orig(*a, **k)
            self.torch.cuda.synchronize()
            self.ms.append((time.perf_counter() - t0) * 1e3)
            self.stats.append(dict(st))
            return ro, st
        self.mod.generate = generate
        return self

    def __exit__(self, *exc):
        self.mod.generate = self.orig


def rl_phase10(torch, dev, cfg, attn, fa, dec, card):
    """One greedy PPO iteration of full-width qwen3-0.6b (vocab 16, fp32)
    with 16 prompts x 4 rollouts = 64 rows (two decode waves of 32) on
    the colocated plan, run twice from the same seeded state: with the
    kernels as shipped and with the plain attention everywhere."""
    from repro_torch.data.synthetic import (AdditionTask, PromptDataset,
                                            VOCAB_SIZE)
    from repro_torch.rl.trainer import RLConfig, RLTrainer
    t0 = time.monotonic()
    rcfg = dataclasses.replace(cfg, vocab_size=VOCAB_SIZE, dtype="float32")
    task = AdditionTask(max_operand=9)
    trainer = RLTrainer(rcfg, RLConfig(algorithm="ppo", n_rollouts=4,
                                       max_new_tokens=task.max_answer_len,
                                       lr=1e-3, greedy=True),
                        task, seed=0, device=dev)
    state0 = trainer.state_tree()      # the steps are functional
    prompts, answers = next(iter(PromptDataset(task, batch=16, seed=1)))
    hook = StageLaunches(fa, dec)
    restore = hook.install(type(trainer))
    runs = {}
    try:
        for impl in ("kernel", "plain"):
            attn.set_attention_impl(impl)
            trainer.load_state_tree(state0)
            with GenCalls(torch) as calls:
                m = trainer.iteration(prompts, answers, None)
                torch.cuda.synchronize()
            runs[impl] = (m, hook.bb, hook.by_kind(-1))
            if impl == "kernel":
                gen_ms = calls.ms[0]
    finally:
        attn.set_attention_impl("kernel")
        restore()
    (mk, bk, lk), (mp, bp, lp) = runs["kernel"], runs["plain"]
    rk, rp = bk["bundle"]["rollout"], bp["bundle"]["rollout"]
    check(tuple(rk["gen_tokens"].shape) == (64, task.max_answer_len),
          f"bad rollout shape {tuple(rk['gen_tokens'].shape)}")
    same_tok = torch.equal(rk["sequences"], rp["sequences"])
    same_mask = torch.equal(rk["mask"], rp["mask"])
    # GAE's advantages before whitening: returns = advantages + values
    adv = {impl: b["returns"] - b["values"] * b["batch"]["mask"]
           for impl, b in (("kernel", bk), ("plain", bp))}
    errs = {k: max_err(a, b) for k, a, b in (
        ("logprobs", rk["logprobs"], rp["logprobs"]),
        ("lp_ref", bk["lp_ref"], bp["lp_ref"]),
        ("values", bk["values"], bp["values"]),
        ("advantages", adv["kernel"], adv["plain"]))}
    # the policy loss is printed, not held: over an unchanged policy it is
    # the mean of whitened advantages, about 1e-8, whatever they are
    rel = {k: (mk[k], mp[k]) for k in ("critic_loss", "grad_norm")}
    finite = all(torch.isfinite(x).all() for x in (
        rk["logprobs"], bk["lp_ref"], bk["values"],
        bk["batch"]["advantages"]))
    print(f"[10 parity] {ARCH} RL, fp32 full width ({rcfg.n_layers} layers, "
          f"d {rcfg.d_model}, vocab {rcfg.vocab_size}, "
          f"{rcfg.param_count() / 1e9:.3f} B parameters), greedy PPO, 16 "
          f"prompts x 4 rollouts = 64 rows, colocated plan: tokens identical="
          f"{same_tok} masks identical={same_mask}; max diff "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
          + " (tol 1e-3); " + ", ".join(
              f"{k} {a:.6g} vs {b:.6g}" for k, (a, b) in rel.items())
          + f" (rtol 1e-3); policy loss {mk['loss']:.3g} vs "
          f"{mp['loss']:.3g} (not held); GEN {gen_ms:.1f} ms (kernel run) "
          f"| card {card}", flush=True)
    print(f"[10 parity] launches per stage (flash, decode): kernel run "
          f"{lk}, plain run {lp}; {time.monotonic() - t0:.1f}s | card "
          f"{card}", flush=True)
    check(finite, "non-finite log-probs, values or advantages")
    check(same_tok and same_mask, "kernel and plain RL runs generate "
          "different tokens")
    check(all(v <= 1e-3 for v in errs.values()), f"RL parity: {errs}")
    check(all(rel_close(a, b) for a, b in rel.values()),
          f"RL losses disagree: {rel}")
    check(lk["GEN"][0] > 0 and lk["GEN"][1] > 0 and lk["INF"][0] > 0,
          f"the kernel run did not launch both kernels in GEN and flash in "
          f"INF: {lk}")
    check(lk["INF"][1] == 0, f"INF launched decode_attention: {lk}")
    check(lk["TRAIN"] == (0, 0), f"TRAIN launched kernels: {lk}")
    check(all(v == (0, 0) for v in lp.values()),
          f"the plain run launched kernels: {lp}")
    return rk["sequences"], rk["mask"], rk["logprobs"], gen_ms


def rl_phase11(torch, dev, fa, dec, card):
    """``repro_torch.launch.train`` at qwen3-0.6b's full width through
    ``run_rl``: GRPO 3 steps, GRPO --async 3 steps, PPO 2 steps, batch 16;
    then the e2e actor for 30 GRPO iterations through
    ``repro_torch.examples.train_rl_e2e``.  Returns the launches at each
    RL-path shape in the first run (GRPO, the searched plan) and at each
    of the e2e actor's shapes in its run."""
    from repro_torch.examples import train_rl_e2e
    from repro_torch.launch import train as train_mod
    from repro_torch.rl.trainer import RLTrainer
    hook = StageLaunches(fa, dec)
    restore = hook.install(RLTrainer)
    totals = None
    try:
        for extra in (["--rl", "grpo", "--steps", "3"],
                      ["--rl", "grpo", "--steps", "3", "--async"],
                      ["--rl", "ppo", "--steps", "2"]):
            argv = ["--arch", ARCH, "--batch", "16"] + extra
            hook.iters.clear()
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.monotonic()
            print(f"[11 train] python -m repro_torch.launch.train "
                  f"{' '.join(argv)}", flush=True)
            out = train_mod.run_rl(train_mod.parse_args(argv))
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            peak = torch.cuda.max_memory_allocated(dev)
            tr, cmp = out["trainer"], out["compare"]
            eng = tr.engine
            spans = {}
            for e in eng.timeline:
                if e.task >= 0:
                    spans.setdefault((e.iteration, e.task), {})[e.kind] = \
                        e.time
            per_iter = {}        # iteration -> {task name: ms}
            for (it, t), v in sorted(spans.items()):
                per_iter.setdefault(it, {})[tr.wf.task(t).name] = \
                    (v["end"] - v["start"]) * 1e3
            # a sync follows each trained iteration (none after a fill)
            trained = [it for it, tasks in per_iter.items()
                       if any(n.endswith("_training") for n in tasks)]
            for it, ms_ in zip(trained, eng.sync_durations):
                per_iter[it]["sync"] = ms_ * 1e3
            ms = [m for m in out["metrics"]]
            check(all(math.isfinite(v) for m in ms for v in m.values()),
                  "non-finite RL metrics")
            launches = [hook.by_kind(i) for i in range(len(hook.iters))]
            check(all(lk.get("TRAIN", (0, 0)) == (0, 0) for lk in launches),
                  f"TRAIN launched kernels: {launches}")
            run = {key: sum(lk.get(kind, (0, 0))[i] for lk in launches)
                   for key, kind, i in (
                       ("flash_attention/rl_gen_prefill", "GEN", 0),
                       ("flash_attention/rl_inf", "INF", 0),
                       ("decode_attention/rl_gen_decode", "GEN", 1))}
            check(all(n > 0 for n in run.values()),
                  f"the RL run did not launch both kernels: {launches}")
            totals = totals or run
            if "--async" in extra:
                check(ms[0]["sync_gb"] == 0.0 and all(
                    m["sync_gb"] > 0 for m in ms[1:]),
                    "async: the fill iteration synced or a later one not")
                rec = eng.pipeline.records[-1]
                check(rec.weight_version - rec.gen_version == 1,
                      f"async staleness {rec}")
            print(f"[11 train] plan grouping={out['search'].grouping} sizes="
                  f"{out['search'].sizes}, predicted "
                  f"{out['search'].cost * 1e3:.3f} ms/iter on the 8-GPU "
                  f"reference pool; measured {cmp['measured_iter_s'] * 1e3:.1f}"
                  f" ms/iter vs cost-model {cmp['predicted_iter_s'] * 1e3:.3f}"
                  f" ms/iter (ratio {cmp['ratio']:.1f}; from the last two "
                  f"GEN starts of the replayed timeline) | card {card}",
                  flush=True)
            for it, tasks in per_iter.items():
                print(f"[11 train] iteration {it} (Event timeline, ms): "
                      + ", ".join(f"{k} {v:.2f}" for k, v in tasks.items())
                      + f" | card {card}", flush=True)
            print(f"[11 train] launches per iteration and stage (flash, "
                  f"decode): {launches}, in all {run}; peak "
                  f"{peak / 2**30:.2f} GiB; {wall:.1f}s in all | card {card}",
                  flush=True)
            del out, tr, eng
            torch.cuda.empty_cache()
        # the e2e actor through its example: 16 prompts x 8 rollouts =
        # 128 GEN rows in waves of 32 on genserve
        argv = ["--iters", "30", "--batch", "16", "--ckpt-every", "10"]
        hook.iters.clear()
        t0 = time.monotonic()
        print(f"[11 train] python -m repro_torch.examples.train_rl_e2e "
              f"{' '.join(argv)}", flush=True)
        out = train_rl_e2e.main(argv)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        rewards = [m["reward_mean"] for m in out["metrics"]]
        check(len(rewards) == 30 and all(
            math.isfinite(r) and 0.0 <= r <= 1.0 for r in rewards),
            f"e2e rewards {rewards}")
        launches = [hook.by_kind(i) for i in range(len(hook.iters))]
        check(all(lk.get("TRAIN", (0, 0)) == (0, 0) for lk in launches),
              f"e2e TRAIN launched kernels: {launches}")
        e2e = {key: sum(lk.get(kind, (0, 0))[i] for lk in launches)
               for key, kind, i in (
                   ("flash_attention/e2e_gen_prefill", "GEN", 0),
                   ("flash_attention/e2e_inf", "INF", 0),
                   ("decode_attention/e2e_gen_decode", "GEN", 1))}
        check(all(n > 0 for n in e2e.values()),
              f"the e2e run did not launch both kernels: {e2e}")
        cmp, occ = out["compare"], out["occupancy"]
        check(occ["measured_occupancy"] > 0,
              "e2e GEN recorded no genserve wave")
        c = out["trainer"].cfg
        print(f"[11 train] e2e actor ({c.n_layers} layers, d {c.d_model}, "
              f"{c.n_heads}:{c.n_kv_heads} heads of {c.resolved_head_dim}, "
              f"fp32), GRPO 30 iterations of 16 prompts x 8: reward "
              + ", ".join(f"iter {i} {rewards[i]:.3f}"
                          for i in (0, 10, 20, 29))
              + f" (printed, not a gate); final greedy accuracy "
              f"{out['accuracy']:.2f}; measured "
              f"{cmp['measured_iter_s'] * 1e3:.1f} ms/iter vs cost-model "
              f"{cmp['predicted_iter_s'] * 1e3:.3f} (ratio "
              f"{cmp['ratio']:.2f}); genserve occupancy measured "
              f"{occ['measured_occupancy']:.2f} vs predicted "
              f"{occ.get('predicted_occupancy', 0):.2f}; launches {e2e}; "
              f"{wall:.1f}s | card {card}", flush=True)
    finally:
        restore()
    return totals, e2e, c


def gib(n: float) -> float:
    return n / 2**30


def free(torch) -> None:
    """Collect the trainers an earlier phase left (trainer and engine hold
    each other, so only the cycle collector frees them) and return their
    memory to the card."""
    gc.collect()
    torch.cuda.empty_cache()


def lm_phase12(torch, dev, card):
    """``launch.train`` in its LM mode at qwen3-0.6b's full width (bf16,
    vocab 151,936), then one step of a 2-layer cut in fp32 on the card
    against the same step on the CPU."""
    from repro_torch.configs import archs
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch import train as train_mod
    from repro_torch.models import transformer as T
    from repro_torch.optim import adam
    from repro_torch.tree import tree_leaves, tree_unflatten
    cfg = archs.get(ARCH)
    V = cfg.vocab_size
    # the step-0 expectation: over uniform labels the loss is the mean of
    # logsumexp(z) - mean(z) over positions, on the run's own first batch
    # and seed-0 weights (ln V plus the init's logit spread)
    with torch.no_grad():
        p0 = T.init_params(cfg, seed=0, device=dev)
        b0 = train_mod.make_batch(
            cfg, torch.Generator(device=dev).manual_seed(0), 4, 64)
        z = T.forward(p0, cfg, {"tokens": b0["tokens"]},
                      attn_impl="plain")["logits"].float()
        expect0 = float((torch.logsumexp(z, -1) - z.mean(-1)).mean())
        del p0, z
    torch.cuda.empty_cache()
    argv = ["--arch", ARCH, "--steps", "5", "--batch", "4", "--seq", "64"]
    free(torch)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.monotonic()
    print(f"[12 lm] python -m repro_torch.launch.train {' '.join(argv)}",
          flush=True)
    out = train_mod.main(argv)
    wall = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    losses, gn, secs = out["losses"], out["grad_norms"], out["step_s"]
    ms = sorted(s * 1e3 for s in secs[1:])
    print(f"[12 lm] {ARCH} full width bf16 ({cfg.n_layers} layers, vocab "
          f"{V}, {cfg.param_count() / 1e9:.3f} B parameters), batch 4 x seq "
          f"64: losses " + ", ".join(f"{x:.4f}" for x in losses)
          + f"; grad norms " + ", ".join(f"{x:.3f}" for x in gn)
          + f"; step 0 {secs[0] * 1e3:.1f} ms (first launches), steps 1-4 "
          f"median {ms[len(ms) // 2]:.1f} ms/step ({ms[0]:.1f}-{ms[-1]:.1f});"
          f" peak {gib(peak - base):.2f} GiB above the {gib(base):.2f} GiB "
          f"allocated before it; {wall:.1f}s | card {card}", flush=True)
    print(f"[12 lm] step-0 loss {losses[0]:.4f}: ln V = {math.log(V):.4f} "
          f"(diff {losses[0] - math.log(V):+.4f}); the uniform-label "
          f"expectation on the step-0 logits {expect0:.4f} (diff "
          f"{losses[0] - expect0:+.4f}, tol 0.1)", flush=True)
    check(all(math.isfinite(x) for x in losses + gn), "non-finite LM loss")
    check(abs(losses[0] - expect0) <= 0.1, f"step-0 loss {losses[0]} is "
          f"not within 0.1 of its uniform-label expectation {expect0}")
    check(abs(losses[0] - math.log(V)) <= 0.5, f"step-0 loss {losses[0]} "
          f"is not near ln V = {math.log(V)}")
    lm_params = out["params"]
    del out
    torch.cuda.empty_cache()

    # one step, 2 layers at full width, fp32: the card against the CPU
    cut = dataclasses.replace(first_layers(cfg, 2), dtype="float32")
    opt = adam.AdamConfig(lr=1e-3, total_steps=5)
    step = steps_mod.make_train_step(cut, opt)
    p_cpu = T.init_params(cut, seed=0, device="cpu")
    batch = train_mod.make_batch(cut, torch.Generator().manual_seed(1), 4, 64)
    res = {}
    for d in ("cpu", dev):
        p = p_cpu if d == "cpu" else tree_unflatten(
            p_cpu, [t.to(d) for t in tree_leaves(p_cpu)])
        b = {k: v.to(d) for k, v in batch.items()}
        flat = [t.detach().requires_grad_(True) for t in tree_leaves(p)]
        with torch.enable_grad():
            loss = steps_mod.lm_loss(tree_unflatten(p, flat), cut, b)
            gs = torch.autograd.grad(loss, flat)
        p1, _, m = step(p, adam.init_adam_state(p, opt), b)
        res[str(d)] = (float(m["loss"]), float(m["grad_norm"]),
                       [t.cpu() for t in tree_leaves(p1)],
                       [g.cpu() for g in gs])
    (lc, nc, pc, gc), (lg, ng, pg, gg) = res["cpu"], res[str(dev)]
    # where |g| >= 1e-6 and the two gradients agree within 1e-3 of |g|
    # ("firm"), Adam's step must agree; elsewhere it is about lr * sign(g)
    # on either side (rows of tokens absent from the batch get g = 0 and
    # stay put on both)
    firm_err, loose_err, n_firm, n_big = 0.0, 0.0, 0, 0
    for a, b_, g1, g2 in zip(pg, pc, gg, gc):
        d_ = (a - b_).abs()
        big = g2.abs() >= 1e-6
        firm = big & ((g1 - g2).abs() <= 1e-3 * g2.abs())
        n_firm += int(firm.sum())
        n_big += int(big.sum())
        if firm.any():
            firm_err = max(firm_err, float(d_[firm].max()))
        loose_err = max(loose_err, float(d_.max()))
    print(f"[12 lm] one step, first 2 layers at full width in fp32 "
          f"({cut.param_count() / 1e9:.3f} B parameters), batch 4 x 64, "
          f"card vs CPU: loss {lg:.6f} vs {lc:.6f}, grad norm {ng:.6f} vs "
          f"{nc:.6f} (rtol 2e-4); post-Adam parameters max diff "
          f"{firm_err:.3g} where the gradients agree ({n_firm} of the "
          f"{n_big} with |g| >= 1e-6; tol 2e-4), {loose_err:.3g} over all "
          f"(tol 2 lr + 2e-4) | card {card}", flush=True)
    check(rel_close(lg, lc, 2e-4) and rel_close(ng, nc, 2e-4),
          "LM step: card and CPU loss or grad norm disagree")
    check(firm_err <= 2e-4 and loose_err <= 2e-3 + 2e-4
          and n_firm >= 0.9 * n_big, "LM step: card and CPU post-Adam "
          "parameters disagree")
    return lm_params


def ckpt_phase13(torch, dev, card, lm_params):
    """Checkpoint round trips on the card: the full-width RL actor (fp32)
    and the LM phase's bf16 parameters, bit for bit; the full-width GRPO
    state over the format's cap refused before any write."""
    import shutil
    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.configs import archs
    from repro_torch.data.synthetic import AdditionTask, VOCAB_SIZE
    from repro_torch.models import transformer as T
    from repro_torch.rl.trainer import RLConfig, RLTrainer
    from repro_torch.tree import tree_leaves, tree_map
    d = ROOT / "build" / "ckpt_smoke"
    shutil.rmtree(d, ignore_errors=True)
    rcfg = dataclasses.replace(archs.get(ARCH), vocab_size=VOCAB_SIZE,
                               dtype="float32")
    actor = T.init_params(rcfg, seed=0, device=dev)
    for label, tree in (("RL actor, fp32", actor),
                        ("LM parameters, bf16", lm_params)):
        p = str(d / "tree.msgpack")
        torch.cuda.synchronize()
        t0 = time.monotonic()
        n = ckpt_io.save(p, tree)
        tw = time.monotonic() - t0
        like = tree_map(torch.zeros_like, tree)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        got = ckpt_io.restore(p, like)
        torch.cuda.synchronize()
        tr = time.monotonic() - t0
        same = all(a.device == b.device and a.dtype == b.dtype and
                   torch.equal(a.view(torch.int16) if a.dtype ==
                               torch.bfloat16 else a,
                               b.view(torch.int16) if b.dtype ==
                               torch.bfloat16 else b)
                   for a, b in zip(tree_leaves(got), tree_leaves(tree)))
        print(f"[13 ckpt] {ARCH} full width, {label}: {n / 1e9:.3f} GB, "
              f"{len(tree_leaves(tree))} leaves; cuda -> file "
              f"{tw:.2f} s ({n / tw / 1e9:.2f} GB/s), file -> cuda {tr:.2f} "
              f"s ({n / tr / 1e9:.2f} GB/s); bit-exact={same} | card {card}",
              flush=True)
        check(same, f"checkpoint round trip of the {label} is not "
              f"bit-exact")
        # where save's and restore's time goes: the device-host copies, the
        # crc32 over the payload, the file write and read on their own
        leaves = tree_leaves(tree)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        host = [ckpt_io._host_bytes(x) for x in leaves]
        t_d2h = time.monotonic() - t0
        t0 = time.monotonic()
        crc = 0
        for h in host:
            crc = zlib.crc32(h, crc)
        t_crc = time.monotonic() - t0
        q = str(d / "raw.bin")
        t0 = time.monotonic()
        with open(q, "wb") as f:
            for h in host:
                f.write(h)
        t_w = time.monotonic() - t0
        t0 = time.monotonic()
        with open(q, "rb") as f:
            raw = bytearray(os.path.getsize(q))
            f.readinto(raw)
        t_r = time.monotonic() - t0
        t0 = time.monotonic()
        dev_copy = torch.frombuffer(raw, dtype=torch.uint8).to(dev)
        torch.cuda.synchronize()
        t_h2d = time.monotonic() - t0
        print(f"[13 ckpt] {label} by part ({n / 1e9:.3f} GB): device->host "
              f"{t_d2h:.2f} s, crc32 {t_crc:.2f} s, file write {t_w:.2f} s; "
              f"file read {t_r:.2f} s, host->device {t_h2d:.2f} s (one "
              f"pageable copy) | card {card}", flush=True)
        os.remove(q)
        os.remove(p)
        del got, like, host, raw, dev_copy
    del actor
    torch.cuda.empty_cache()
    task = AdditionTask(max_operand=9)
    tr_ = RLTrainer(rcfg, RLConfig(algorithm="grpo", n_rollouts=4,
                                   max_new_tokens=task.max_answer_len),
                    task, seed=0, device=dev)
    state = tr_.state_tree()
    nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(state))
    p = str(d / "state.msgpack")
    try:
        ckpt_io.save(p, state)
        refused = None
    except ckpt_io.CheckpointError as e:
        refused = str(e)
    left = sorted(x.name for x in d.iterdir()) if d.exists() else []
    print(f"[13 ckpt] {ARCH} full-width GRPO state_tree ({nbytes / 1e9:.2f} "
          f"GB in {len(tree_leaves(state))} leaves): "
          f"{'refused: ' + refused if refused else 'WRITTEN'}; files left "
          f"{left}", flush=True)
    check(refused is not None and "4 GiB" in refused,
          "the full-width state over 4 GiB was not refused")
    check(not left, f"the refused save left {left}")
    shutil.rmtree(d, ignore_errors=True)
    del tr_, state
    free(torch)


def _rl_setup(torch, dev, cfg, batch=16):
    """The launcher's RL setup at ``cfg``'s width (the addition task, the
    8-GPU pool, a GRPO trainer on the card) on the fault tests' plan
    (``tests/test_faults.py``): GEN on a group of its own, the other tasks
    on the rest of the pool.  The plan the launcher searches keeps each
    group inside one machine, so a cross-machine throttle would slow none
    of its tasks; on this one actor training crosses machines."""
    from repro_torch.core import enumerate as enum_mod, topology, workflow
    from repro_torch.core.plan import check_constraints
    from repro_torch.data.synthetic import (AdditionTask, PromptDataset,
                                            VOCAB_SIZE)
    from repro_torch.rl.trainer import RLConfig, RLTrainer
    cfg = dataclasses.replace(cfg, vocab_size=VOCAB_SIZE, dtype="float32")
    task = AdditionTask(max_operand=9)
    topo = topology.build_testbed("single_region",
                                  counts={"A100": 4, "L4": 4})
    wf = workflow.make_workflow("grpo", workflow.LLMSpec.from_model_config(
        cfg), synchronous=True, global_batch=batch, n_rollouts=4,
        seq_in=task.prompt_len, seq_out=task.max_answer_len)
    grouping = ((0,), tuple(range(1, wf.n_tasks)))
    plan = enum_mod.build_plan(topo, wf, grouping, enum_mod.proportional_sizes(
        wf, grouping, topo.n), list(range(topo.n)))
    ok, msg = check_constraints(topo, wf, plan)
    check(ok, msg)
    tr = RLTrainer(cfg, RLConfig(algorithm="grpo", n_rollouts=4,
                                 max_new_tokens=task.max_answer_len,
                                 lr=1e-3),
                   task, seed=0, plan=plan, topo=topo, wf=wf, device=dev)
    ds = iter(PromptDataset(task, batch=batch, seed=1))
    rng = torch.Generator(device=dev).manual_seed(42)
    return tr, topo, ds, rng


def _check_launches(hook, label):
    """Every iteration's GEN launched both attention kernels, INF flash,
    TRAIN none.  Returns the per-iteration launches."""
    per = [hook.by_kind(i) for i in range(len(hook.iters))]
    for i, lk in enumerate(per):
        check(lk.get("GEN", (0, 0))[0] > 0 and lk.get("GEN", (0, 0))[1] > 0
              and lk.get("INF", (0, 0))[0] > 0,
              f"{label}: iteration {i} did not launch both kernels in GEN "
              f"and flash in INF: {lk}")
        check(lk.get("TRAIN", (0, 0)) == (0, 0),
              f"{label}: TRAIN launched kernels: {lk}")
    return per


def elastic_phase14(torch, dev, fa, dec, card):
    """The elastic controller on the full-width GRPO trainer (vocab 16,
    fp32, batch 16, the searched plan), ``ElasticConfig(ckpt_dir=None)``:
    drop_tail swaps the plan, transient_crash retries, permanent_crash
    forces a replan, link_throttle fires a reactive replan after the
    calibration warmup.  Returns the launches of iterations after a swap."""
    from repro_torch.configs import archs
    from repro_torch.core import retry, topology
    from repro_torch.core.workflow import TaskKind
    from repro_torch.engine.elastic import ElasticConfig, ElasticController
    from repro_torch.engine.executor import TaskExecutionError
    from repro_torch.faults import FaultInjector, fault_scenario
    from repro_torch.obs import calibrate as obs_cal
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.rl.trainer import RLTrainer
    cfg = archs.get(ARCH)
    hook = StageLaunches(fa, dec)
    restore = hook.install(RLTrainer)
    after_swap = {}
    try:
        for scen, n_iter in (("drop_tail", 6), ("transient_crash", 3),
                             ("permanent_crash", 4), ("link_throttle", 9)):
            hook.iters.clear()
            t0 = time.monotonic()
            tr, topo, ds, rng = _rl_setup(torch, dev, cfg)
            wf = tr.wf
            train_task = next(t for t in range(wf.n_tasks)
                              if wf.task(t).kind == TaskKind.TRAIN)
            feed = (topology.drift_scenario("drop_tail", topo, at=2)
                    if scen == "drop_tail" else (lambda it, topo=topo: topo))
            ctrl = ElasticController(tr, feed, ElasticConfig(ckpt_dir=None))
            inj = None
            if scen != "drop_tail":
                inj = FaultInjector(fault_scenario(
                    scen, at=1 if scen != "link_throttle" else 3, topo=topo,
                    train_task=train_task, n_tasks=wf.n_tasks))
                tr.engine.attach_fault_injector(inj)
                tr.engine.set_task_retry(retry.RetryPolicy(
                    max_attempts=3, base_delay_s=0.05))
            if scen == "link_throttle":
                probe = FaultInjector(inj.plan).bind(tr.engine)
                probe.begin_iteration(3)
                dil = {wf.task(t).name: round(probe.dilation(t), 3)
                       for t in range(wf.n_tasks)}
                print(f"[14 elastic] plan {[(g.tasks, g.devices) for g in tr.plan.groups]}"
                      f"; link_throttle's replay dilation per task while "
                      f"active: {dil}", flush=True)
            r0 = obs_metrics.counter("engine.task_retries").value
            f0 = obs_metrics.counter("engine.task_failures").value
            epochs, lines, recs = [], [], []
            for it in range(n_iter):
                prompts, answers = next(ds)
                try:
                    m = tr.iteration(prompts, answers, rng)
                except TaskExecutionError as e:
                    rec = ctrl.handle_failure(it, e)
                    recs.append(rec)
                    lines.append(f"iteration {it}: {type(e.cause).__name__}"
                                 f" -> forced replan, epoch {rec.epoch}")
                    m = tr.iteration(prompts, answers, rng)
                check(all(math.isfinite(float(v)) for v in m.values()),
                      f"{scen}: non-finite metrics")
                epochs.append(tr.engine.epoch)
                if scen == "link_throttle" and it == 2:
                    cal = obs_cal.fit_from_engine(tr.engine)
                    mon = obs_cal.DivergenceMonitor(threshold=2.0,
                                                    sustain=2)
                    tr.engine.attach_divergence_monitor(mon, cal)
                    tr.engine.set_task_deadlines(cal, slack=5.0)
                    ctrl.monitor = mon
                rec = ctrl.poll(it)
                if rec is not None:
                    recs.append(rec)
                    d = rec.decision
                    why = ""
                    if rec.reactive:
                        mon = ctrl.monitor
                        why = " (drifted, EWMA measured/predicted: " + ", ".join(
                            f"{wf.task(t).name} {mon.ratio(t):.2f}"
                            for t in mon.drifted_tasks()) + ")"
                    lines.append(
                        f"iteration {it}: {'reactive' if rec.reactive else 'drift'}"
                        f"{why} switch={d.switch} old {d.old_cost * 1e3:.3f} ms "
                        f"new {d.new_cost * 1e3:.3f} ms -> epoch {rec.epoch}")
                    if scen == "link_throttle" and rec.reactive:
                        break
            torch.cuda.synchronize()
            per = _check_launches(hook, f"[14 elastic] {scen}")
            retries = obs_metrics.counter("engine.task_retries").value - r0
            fails = obs_metrics.counter("engine.task_failures").value - f0
            rows = tr.engine.epoch_report()
            print(f"[14 elastic] {scen}: " + "; ".join(lines or ["no record"])
                  + f"; retries {retries:.0f}, task failures {fails:.0f}; "
                  f"epoch per iteration {epochs}; " + ", ".join(
                      f"epoch {r['epoch']} {r['iterations']} iters "
                      f"{r['measured_iter_s'] * 1e3:.1f} ms/iter"
                      for r in rows)
                  + f"; {time.monotonic() - t0:.1f}s | card {card}",
                  flush=True)
            print(f"[14 elastic] {scen} launches per iteration (flash, "
                  f"decode): {per}", flush=True)
            if scen == "drop_tail":
                check(len(ctrl.swaps) == 1 and epochs[-1] == 1
                      and [r["epoch"] for r in rows] == [0, 1],
                      f"drop_tail: no swap to epoch 1 ({epochs}, {rows})")
                after_swap = per[epochs.index(1)]
            elif scen == "transient_crash":
                check(retries == 2 and fails == 0,
                      f"transient_crash: retries {retries}, failures {fails}")
            elif scen == "permanent_crash":
                check(any(r.forced and r.applied for r in recs)
                      and tr.engine.epoch >= 1,
                      "permanent_crash: no forced replan")
            else:
                check(any(r.reactive for r in recs) and inj.fired(
                    "link_throttle"), "link_throttle: no reactive replan")
            del tr, ctrl, inj
            free(torch)
    finally:
        restore()
    return after_swap


def launcher_phase15(torch, dev, fa, dec, card):
    """``launch.train --rl grpo --require-recover`` with ``--drift
    drop_tail``, then ``--fault ckpt_fail``, ``ckpt_flaky`` and
    ``ckpt_corrupt``, at qwen3-0.6b's full width cut to its first 8 layers
    (the whole trainer state, about 2.5 GB, then fits the checkpoint
    format's 4 GiB; at 28 layers it is 8.8 GB)."""
    import shutil
    from repro_torch.configs import archs
    from repro_torch.launch import train as train_mod
    from repro_torch.rl.trainer import RLTrainer
    from repro_torch.tree import tree_leaves
    cut = first_layers(archs.get(ARCH), 8)
    hook = StageLaunches(fa, dec)
    restore = hook.install(RLTrainer)
    ckpt_dir = Path(train_mod.CKPT_DIR)
    try:
        for extra in (["--drift", "drop_tail", "--steps", "6"],
                      ["--fault", "ckpt_fail", "--steps", "4"],
                      ["--fault", "ckpt_flaky", "--steps", "4"],
                      ["--fault", "ckpt_corrupt", "--steps", "4"],
                      ["--fault", "slot_failure", "--steps", "4"]):
            shutil.rmtree(ckpt_dir, ignore_errors=True)
            hook.iters.clear()
            argv = ["--arch", ARCH, "--rl", "grpo", "--batch", "16",
                    "--require-recover"] + extra
            print(f"[15 launcher] python -m repro_torch.launch.train "
                  f"{' '.join(argv)}, first 8 of {archs.get(ARCH).n_layers} "
                  f"layers at full width (depth cut: the state must fit the "
                  f"checkpoint format's 4 GiB)", flush=True)
            t0 = time.monotonic()
            out = train_mod.run_rl(train_mod.parse_args(argv), cfg=cut)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            tr, ctrl = out["trainer"], out["controller"]
            nbytes = sum(t.numel() * t.element_size()
                         for t in tree_leaves(tr.state_tree()))
            per = _check_launches(hook, f"[15 launcher] {extra[1]}")
            rows = tr.engine.epoch_report()
            print(f"[15 launcher] {extra[1]}: recovered line "
                  f"{out['recovered']!r}; state {nbytes / 1e9:.2f} GB; swaps "
                  f"{len(ctrl.swaps)}, records {len(ctrl.records)} (reactive "
                  f"{sum(r.reactive for r in ctrl.records)}); " + ", ".join(
                      f"epoch {r['epoch']} {r['iterations']} iters "
                      f"{r['measured_iter_s'] * 1e3:.1f} ms/iter"
                      for r in rows)
                  + f"; launches per iteration {per}; {wall:.1f}s | card "
                  f"{card}", flush=True)
            if extra[1] == "drop_tail":
                check(any(r.applied and not r.reactive for r in ctrl.records)
                      and len(rows) >= 2, "drop_tail: no plan swap")
            elif extra[1] == "ckpt_corrupt":
                check(out["recovered"] is not None and out["recovered"]
                      .startswith("recovered: load_latest fell back to "),
                      f"ckpt_corrupt: {out['recovered']}")
            elif extra[1] == "slot_failure":
                check(out["recovered"] is not None and out["recovered"]
                      .endswith("slot failures requeued"),
                      f"slot_failure: {out['recovered']}")
            else:
                check(out["recovered"] is not None,
                      f"{extra[1]}: no recovery line")
            del out, tr, ctrl
            free(torch)
    finally:
        restore()
        shutil.rmtree(ckpt_dir, ignore_errors=True)


def control_phase16(torch, dev, fa, dec, card):
    """No fault injected: the full-width GRPO trainer with the divergence
    monitor and the calibrated deadlines armed as the launcher arms them
    (threshold 2.0, sustain 2, slack 5.0) after a 3-iteration warmup,
    then 12 iterations under a constant feed: how often do they fire?
    Also the local microbench the calibration can record."""
    from repro_torch.configs import archs
    from repro_torch.core import profiler
    from repro_torch.engine.elastic import ElasticConfig, ElasticController
    from repro_torch.obs import calibrate as obs_cal
    from repro_torch.obs import metrics as obs_metrics
    t0 = time.monotonic()
    tr, topo, ds, rng = _rl_setup(torch, dev, archs.get(ARCH))
    ctrl = ElasticController(tr, lambda it: topo,
                             ElasticConfig(ckpt_dir=None))
    for _ in range(3):
        tr.iteration(*next(ds), rng)
    cal = obs_cal.fit_from_engine(tr.engine, measure_local=True)
    mon = obs_cal.DivergenceMonitor(threshold=2.0, sustain=2)
    tr.engine.attach_divergence_monitor(mon, cal)
    tr.engine.set_task_deadlines(cal, slack=5.0)
    ctrl.monitor = mon
    m0 = obs_metrics.counter("engine.deadline_misses").value
    fired_at = []
    for it in range(3, 15):
        m = tr.iteration(*next(ds), rng)
        check(all(math.isfinite(float(v)) for v in m.values()),
              "control: non-finite metrics")
        rec = ctrl.poll(it)
        if rec is not None:
            fired_at.append((it, rec.decision.switch, rec.epoch))
    misses = obs_metrics.counter("engine.deadline_misses").value - m0
    ratios = {tr.wf.task(t).name: round(mon.ratio(t), 3)
              for t in range(tr.wf.n_tasks)}
    print(f"[16 control] no fault, full width, monitor (threshold 2.0, "
          f"sustain 2) and deadlines (slack 5.0) armed after 3 warmup "
          f"iterations, 12 iterations: monitor fires {mon.fire_count} "
          f"(reactive replans at (iteration, switch, epoch) {fired_at}), "
          f"deadline misses {misses:.0f}; last EWMA measured/predicted "
          f"ratios {ratios}; calibration global scale "
          f"{cal.global_scale:.4g} from {cal.n_samples} samples; "
          f"{time.monotonic() - t0:.1f}s | card {card}", flush=True)
    tf = profiler.calibrate_local_device(device=dev)
    bw = profiler.calibrate_local_hbm(device=dev)
    print(f"[16 control] local microbench (core.profiler, 8 fp32 1024^2 "
          f"matmuls; 8 passes of a 64 MB copy-scale): {tf:.2f} TFLOP/s fp32, "
          f"{bw:.1f} GB/s; in the fit: {cal.local_tflops:.2f} TFLOP/s, "
          f"{cal.local_hbm_gbps:.1f} GB/s | card {card}", flush=True)
    check(tf > 0 and bw > 0 and cal.local_tflops > 0,
          "the local microbench measured nothing")
    del tr, ctrl
    free(torch)
    return mon.fire_count, misses


def _zero_counts(*mods):
    for m in mods:
        m.launches = 0
        for extra in ("launches_tc", "launches_noncausal", "launches_padded"):
            if hasattr(m, extra):
                setattr(m, extra, 0)


def _same_rollout(a, b, rows=None):
    """(tokens and masks identical, max log-prob difference) over the
    valid positions of ``rows`` (all rows by default)."""
    pick = (lambda t: t) if rows is None else (lambda t: t[rows])
    ma, mb_ = pick(a["mask"]), pick(b["mask"])
    same = ma.equal(mb_) and (pick(a["gen_tokens"]) * ma.long()).equal(
        pick(b["gen_tokens"]) * mb_.long())
    return same, max_err(pick(a["logprobs"]) * ma, pick(b["logprobs"]) * mb_)


def genserve_phase17(torch, dev, fa, dec, rw, mb, card):
    """The rest of genserve at full width in fp32, held against one-shot
    admission on the same weights and prompts (qwen3-0.6b's first
    LAYERS17 layers, batch 48, wave
    16, prompt 256 with the first 128 tokens shared, 64 new, greedy):
    chunked admission, the paged cache (identity block table), radix
    prefix reuse, speculative decoding (a 2-layer draft of the target's
    first layers under one-shot admission, the target itself as a draft
    under chunked admission), slot failures and cancels; then rwkv6-3b
    and Jamba's 2-layer cut chunked against one-shot.  Launch counts are
    set to 0 before and read after every run."""
    from repro_torch.configs import archs
    from repro_torch.genserve import adapter
    from repro_torch.models import transformer as T
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.rl.rollout import SamplerConfig
    from repro_torch.tree import tree_map
    t_phase = time.monotonic()
    cfg = first_layers(archs.get(ARCH), LAYERS17)
    params = T.init_params(cfg, seed=0, device=dev, dtype=torch.float32)
    B, W, P, N = 48, 16, 256, 64
    prompts = torch.randint(0, cfg.vocab_size, (B, P),
                            generator=torch.Generator().manual_seed(1))
    prompts[:, :128] = prompts[0, :128]
    sampler = SamplerConfig(max_new_tokens=N, greedy=True)

    def serve_on(p, c, pr, w, smp, **kw):
        """One engine run, launch counts set to 0 just before it:
        (rollout, stats, launches, seconds)."""
        _zero_counts(fa, dec, rw, mb)
        t0 = time.monotonic()
        ro, st = adapter.generate(p, c, pr, None, smp, wave=w,
                                  decode_chunk=4, fast_path=False,
                                  device=dev, **kw)
        torch.cuda.synchronize()
        return ro, st, {"flash": fa.launches, "decode": dec.launches,
                        "rwkv": rw.launches, "mamba": mb.launches}, \
            time.monotonic() - t0

    def serve(**kw):
        return serve_on(params, cfg, prompts, W, sampler, **kw)

    old_strict = os.environ.get("REPRO_OBS_STRICT")
    os.environ["REPRO_OBS_STRICT"] = "1"       # a leaked page raises
    leaks0 = obs_metrics.counter("pagepool.leaked_pages").value
    try:
        modes = {"one-shot": {}, "chunked": dict(prefill_chunk=64),
                 "paged": dict(prefill_chunk=64, page_size=16),
                 "prefix": dict(prefill_chunk=64, page_size=16,
                                prefix_cache=True)}
        runs = {m: serve(**kw) for m, kw in modes.items()}
        base = runs["one-shot"][0]
        for m, (ro, st, n, sec) in runs.items():
            same, lp = _same_rollout(base, ro)
            print(f"[17 genserve] {ARCH} fp32 full width, first "
                  f"{LAYERS17} layers, {m}: tokens and "
                  f"masks identical to one-shot={same}, logprob max diff "
                  f"{lp:.3g} (tol 1e-3); {st['decode_steps']} decode "
                  f"rounds, {st['prefill_rounds']} prefill-chunk rounds, "
                  f"prefix hit rate {st['prefix_hit_rate']:.4f} "
                  f"({st['prefill_tokens_skipped']} tokens skipped); "
                  f"launches {n}; {sec:.1f}s | card {card}", flush=True)
            check(same and lp <= 1e-3, f"{m} admission disagrees with "
                  f"one-shot (lp {lp})")
            check(n["decode"] > 0, f"{m}: decode_attention never launched")
            check((n["flash"] > 0) == (m == "one-shot"),
                  f"{m}: flash_attention launched {n['flash']} times "
                  f"(only one-shot admission may)")
        check(runs["prefix"][1]["prefix_hit_rate"] > 0,
              "the prefix cache never hit")

        # speculative decoding: greedy tokens identical to the plain run
        plain_steps = runs["one-shot"][1]["decode_steps"]
        dcfg = first_layers(cfg, 2)
        dparams = {"embed": params["embed"],
                   "final_norm": params["final_norm"],
                   "blocks": tree_map(lambda t: t[:2], params["blocks"])}
        for label, kw in (
                ("2-layer draft, one-shot", dict(
                    spec_k=4, draft_params=dparams, draft_cfg=dcfg)),
                ("self-draft, chunked", dict(
                    spec_k=4, draft_params=params, draft_cfg=cfg,
                    prefill_chunk=64))):
            ro, st, n, sec = serve(**kw)
            same, lp = _same_rollout(base, ro)
            print(f"[17 genserve] speculative k=4, {label}: tokens identical "
                  f"to the plain run={same}, logprob max diff {lp:.3g}; "
                  f"accept rate {st['accept_rate']:.4f} "
                  f"({st['spec_accepted']}/{st['spec_proposed']}), "
                  f"{st['spec_tokens']} tokens in {st['decode_steps']} "
                  f"verify rounds (plain: {plain_steps}); launches {n}; "
                  f"{sec:.1f}s | card {card}", flush=True)
            check(same and lp <= 1e-3, f"speculative ({label}) diverged")
            check(n["decode"] > 0, f"speculative ({label}): no decode "
                  f"launch")
            check((n["flash"] > 0) == ("one-shot" in label),
                  f"speculative ({label}): flash launches {n['flash']}")

        # slot failures and cancels on the prefix-cache engine
        ref = runs["prefix"][0]
        ro, st, n, sec = serve(**modes["prefix"], slot_failures={2: [0, 1]})
        same, lp = _same_rollout(ref, ro)
        print(f"[17 genserve] slot failures {{2: [0, 1]}} (prefix cache): "
              f"requeued {st['requeued']}, retired {st['retired']}; every "
              f"request identical to the undisturbed run={same} (lp diff "
              f"{lp:.3g}); {sec:.1f}s", flush=True)
        check(st["requeued"] == 2 and st["retired"] == B and same
              and lp <= 1e-3, "slot failures: requests not regenerated "
              "identically")
        ro, st, n, sec = serve(**modes["prefix"], cancels={3: [2, 40]})
        keep = [i for i in range(B) if i not in (2, 40)]
        same, lp = _same_rollout(ref, ro, keep)
        zero = all(float(ro[k][i].abs().sum()) == 0 for i in (2, 40)
                   for k in ("gen_tokens", "mask", "logprobs"))
        print(f"[17 genserve] cancels {{3: [2, 40]}} (one in flight, one "
              f"queued): cancelled {st['cancelled']}; cancelled rows all "
              f"zero={zero}; the others identical={same} (lp diff "
              f"{lp:.3g}); {sec:.1f}s", flush=True)
        check(st["cancelled"] == 2 and zero and same and lp <= 1e-3,
              "cancels: wrong rows")
        leaked = obs_metrics.counter("pagepool.leaked_pages").value - leaks0
        check(leaked == 0, f"{leaked} leaked pages")
    finally:
        if old_strict is None:
            os.environ.pop("REPRO_OBS_STRICT", None)
        else:
            os.environ["REPRO_OBS_STRICT"] = old_strict
    del params, dparams, runs, base, ref, ro
    free(torch)

    # recurrent mixers: chunked admission against one-shot (phase 6/8's
    # traffic); the scans launch in one-shot only
    small = SamplerConfig(max_new_tokens=16, greedy=True)
    jcfg = first_layers(archs.get(JAMBA_ARCH), 2)
    # Jamba's MoE drops tokens past each expert's capacity per group of
    # tokens, and a prefill chunk is a group of its own, so chunked and
    # one-shot admission differ there in the JAX package too; at
    # capacity_factor E / top_k no token can be dropped
    jcfg = dataclasses.replace(
        jcfg, capacity_factor=jcfg.n_experts / jcfg.top_k)
    for c in (archs.get(RWKV_ARCH), jcfg):
        p_ = T.init_params(c, seed=0, device=dev, dtype=torch.float32)
        pr = torch.randint(0, c.vocab_size, (12, 64),
                           generator=torch.Generator().manual_seed(0))
        one = serve_on(p_, c, pr, 8, small)
        chk = serve_on(p_, c, pr, 8, small, prefill_chunk=16)
        same, lp = _same_rollout(one[0], chk[0])
        scan = "rwkv" if c.name == RWKV_ARCH else "mamba"
        cut = ("" if c.name == RWKV_ARCH else ", first 2 layers, MoE "
               f"capacity_factor {c.capacity_factor}")
        print(f"[17 genserve] {c.name} fp32 full width{cut}"
              f", 12 requests, wave 8, prompt 64, 16 new: chunked (C=16) "
              f"identical to one-shot={same}, logprob max diff {lp:.3g}; "
              f"launches one-shot {one[2]}, chunked {chk[2]}; "
              f"{one[3]:.1f}s + {chk[3]:.1f}s | card {card}", flush=True)
        check(same and lp <= 1e-3, f"{c.name}: chunked differs from one-shot")
        check(one[2][scan] > 0 and chk[2][scan] == 0,
              f"{c.name}: {scan}_scan must launch in one-shot only")
        check(chk[2]["decode"] > 0 or c.name == RWKV_ARCH,
              f"{c.name}: chunked run launched no decode_attention")
        del p_, one, chk
        free(torch)
    print(f"[17 genserve] {time.monotonic() - t_phase:.1f}s | card {card}",
          flush=True)


def serving_phase18(torch, dev, fa, dec, card):
    """``launch.serve`` in bf16 with phase 5's traffic, three ways:
    chunked admission, the paged cache with prefix reuse over a shared
    128-token prompt prefix, and speculative decoding with the engine's
    default draft of qwen3-0.6b (7 layers: a draft as deep as the target
    took the longest of the script's runs); then the paged view's copy
    per decode step."""
    from repro_torch.configs import archs
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import cache as cache_mod
    t_phase = time.monotonic()
    cfg = archs.get(ARCH)
    W, P, N = 16, 256, 64
    argv = ["--arch", ARCH, "--batch", "48", "--wave", str(W),
            "--prompt-len", str(P), "--new-tokens", str(N),
            "--decode-chunk", "4", "--seed", "0"]
    draft = default_draft(cfg)
    reps = {}
    for label, extra in (
            ("chunked", ["--prefill-chunk", "64"]),
            ("prefix", ["--page-size", "16", "--prefix-cache",
                        "--shared-prompts", "128", "--expect-prefix-hits"]),
            ("spec", ["--spec-k", "4", "--draft-arch", draft.name])):
        _zero_counts(fa, dec)
        t0 = time.monotonic()
        with registered(draft):
            rep = serve_mod.main(argv + extra)
        torch.cuda.synchronize()
        n = {"flash_attention": fa.launches,
             "decode_attention": dec.launches}
        gen = rep["gen_tokens"]
        check(tuple(gen.shape) == (48, N) and int(gen.min()) >= 0
              and int(gen.max()) < cfg.vocab_size,
              f"{label}: bad generated tokens {tuple(gen.shape)}")
        check(bool(torch.isfinite(rep["logprobs"]).all())
              and float(rep["logprobs"].max()) <= 1e-6,
              f"{label}: non-finite or positive logprobs")
        check(float(rep["mask"].sum()) == 48 * N,
              f"{label}: budgets not fully served")
        check(n["decode_attention"] > 0, f"{label}: no decode_attention")
        check((n["flash_attention"] > 0) == (label == "spec"),
              f"{label}: flash_attention launches {n['flash_attention']}")
        spec = (f", spec k=4 draft {draft.name} ({draft.n_layers} layers)"
                if label == "spec" else "")
        print(f"[18 serve] {ARCH} bf16 batch 48 wave {W} prompt {P} new {N},"
              f" {rep['admission']}{spec}"
              f": {rep['tok_s']:.1f} valid tok/s ({rep['seconds']:.3f} s), "
              f"TTFT p50 {rep['ttft_p50_s'] * 1e3:.1f} ms p95 "
              f"{rep['ttft_p95_s'] * 1e3:.1f} ms, {rep['decode_rounds']} "
              f"decode rounds, {rep['prefill_rounds']} prefill-chunk rounds, "
              f"busy occupancy {rep['busy_occupancy']:.2f} (ideal "
              f"{rep['ideal_occupancy']:.2f}), prefix hit rate "
              f"{rep['prefix_hit_rate']:.4f}, accept rate "
              f"{rep['accept_rate']:.4f}, peak "
              f"{rep['peak_bytes'] / 2**30:.2f} GiB; launches (3 passes) "
              f"{n}; {time.monotonic() - t0:.1f}s | card {card}", flush=True)
        reps[label] = rep
    check(reps["prefix"]["prefix_hit_rate"] > 0, "no prefix hit")

    # the paged view's copy per decode step: phase 18's prefix-cache pool
    # (2 W MP pages, a scattered block table) gathered into the
    # contiguous view of all 28 layers, against the identity view
    ps, L = 16, P + N
    MP = cache_mod.max_pages_per_slot(cfg, L, ps)
    NP = 2 * W * MP
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    pool = cache_mod.init_paged_cache(cfg, W, L, page_size=ps, n_pages=NP,
                                      dtype=torch.bfloat16, device=dev)
    btab = torch.randperm(NP, generator=torch.Generator().manual_seed(0))[
        :W * MP].view(W, MP).to(dev)
    gather = time_ms(lambda: cache_mod.paged_view(
        cfg, pool["blocks"], btab, L, page_size=ps), torch, flush)
    del pool
    ident = cache_mod.init_paged_cache(cfg, W, L, page_size=ps,
                                       dtype=torch.bfloat16, device=dev)
    itab = torch.as_tensor(cache_mod.identity_block_table(W, MP), device=dev)
    view = cache_mod.paged_view(cfg, ident["blocks"], itab, L, page_size=ps,
                                identity=True)
    copies = sum(not view[k][kk][0].is_contiguous()
                 for k in view for kk in ("k", "v"))
    nbytes = 2 * cfg.n_layers * 2 * W * L * cfg.n_kv_heads \
        * cfg.resolved_head_dim * 2          # read + write, k and v
    step_ms = reps["prefix"]["seconds"] / reps["prefix"]["decode_rounds"] * 1e3
    print(f"[18 serve] paged view per decode step, {cfg.n_layers} layers, "
          f"W {W}, L {L}, page {ps}: gathered (prefix cache, {NP} pages) "
          f"{spread(gather)} ({nbytes / 1e6:.1f} MB moved, "
          f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms at 3.35 TB/s) against "
          f"{step_ms:.3f} ms per decode step of the prefix-cache run; "
          f"identity view: {copies} of {2 * len(view)} layer views need a "
          f"copy (L = {L} is a whole number of pages) | card {card}",
          flush=True)
    del ident, view

    # the attention of a prefill chunk and of a verify step: per-row
    # positions, so plain attention (as in the JAX package), per layer at
    # this run's shapes, beside sdpa with the same mask
    import torch.nn.functional as F
    from repro_torch.models import attention as attn
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    g = torch.Generator(device=dev).manual_seed(3)
    for label, C, rep in (("prefill chunk", 64, reps["chunked"]),
                          ("verify", 5, reps["spec"])):
        pos = torch.randint(0, L - C, (W,), generator=g, device=dev)
        q = torch.randn((W, C, H, hd), generator=g, device=dev).to(
            torch.bfloat16)
        k, v = (torch.randn((W, L + C, KV, hd), generator=g, device=dev)
                .to(torch.bfloat16) for _ in range(2))
        q_pos = pos[:, None] + torch.arange(C, device=dev)
        k_pos_c, valid_c = cache_mod.ring_slot_positions(L, None, pos - 1)
        k_pos = torch.cat([k_pos_c, q_pos], dim=1)
        k_valid = torch.cat([valid_c, torch.ones_like(q_pos, dtype=bool)],
                            dim=1)
        plain = time_ms(lambda: attn.multihead_attention(
            q, k, v, q_pos, k_pos, causal=True, k_valid=k_valid), torch,
            flush)
        ok = (q_pos[:, :, None] >= k_pos[:, None, :]) & k_valid[:, None, :]
        mask4 = torch.where(ok, 0.0, -1e30).to(torch.bfloat16)[:, None]
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask4, enable_gqa=True), torch, flush)
        sub_ms = rep["seconds"] / rep["decode_rounds"] * 1e3
        print(f"[18 serve] {label} attention (per-row positions: plain), "
              f"q [{W},{C},{H},{hd}] k/v [{W},{L + C},{KV},{hd}] bf16: "
              f"{spread(plain)} per layer, {plain[0] * cfg.n_layers:.3f} ms "
              f"per step of {cfg.n_layers} layers; sdpa with the same mask "
              f"{spread(lib)}; the run's {sub_ms:.3f} ms per decode "
              f"sub-round | card {card}", flush=True)
    del flush
    free(torch)
    print(f"[18 serve] {time.monotonic() - t_phase:.1f}s | card {card}",
          flush=True)
    return reps


def rl_phase19(torch, dev, cfg, fa, dec, card, ref):
    """Phase 10's greedy PPO iteration (qwen3-0.6b full width, vocab 16,
    fp32) with GEN on genserve's chunked admission
    (``RLConfig(gen_engine="genserve", prefill_chunk=16,
    decode_chunk=2)``): tokens identical to phase 10's GEN; GEN launches
    decode_attention and no flash_attention (chunked prefill is plain
    attention), TRAIN launches nothing."""
    from repro_torch.data.synthetic import (AdditionTask, PromptDataset,
                                            VOCAB_SIZE)
    from repro_torch.rl.trainer import RLConfig, RLTrainer
    t0 = time.monotonic()
    rcfg = dataclasses.replace(cfg, vocab_size=VOCAB_SIZE, dtype="float32")
    task = AdditionTask(max_operand=9)
    trainer = RLTrainer(rcfg, RLConfig(
        algorithm="ppo", n_rollouts=4, max_new_tokens=task.max_answer_len,
        lr=1e-3, greedy=True, gen_engine="genserve", prefill_chunk=16,
        decode_chunk=2), task, seed=0, device=dev)
    prompts, answers = next(iter(PromptDataset(task, batch=16, seed=1)))
    hook = StageLaunches(fa, dec)
    restore = hook.install(type(trainer))
    try:
        m = trainer.iteration(prompts, answers, None)
        torch.cuda.synchronize()
        bb, lk = hook.bb, hook.by_kind(-1)
    finally:
        restore()
    ro = bb["bundle"]["rollout"]
    same = ro["sequences"].equal(ref[0]) and ro["mask"].equal(ref[1])
    st = trainer.engine.wave_occupancy_summary()
    print(f"[19 rl] {ARCH} greedy PPO, GEN on genserve chunked (C=16, "
          f"decode_chunk 2): tokens and masks identical to phase 10="
          f"{same}; busy occupancy {m.get('gen_busy_occupancy', 0.0):.2f}, "
          f"{m.get('gen_prefill_rounds', 0.0):.0f} prefill rounds; measured "
          f"vs predicted occupancy {st['measured_occupancy']:.2f} / "
          f"{st['predicted_occupancy']:.2f}; launches per stage (flash, "
          f"decode) {lk}; {time.monotonic() - t0:.1f}s | card {card}",
          flush=True)
    check(same, "chunked GEN differs from phase 10's GEN")
    check(all(math.isfinite(float(v)) for v in m.values()),
          "non-finite metrics")
    check(lk["GEN"][1] > 0 and lk["GEN"][0] == 0,
          f"GEN must launch decode_attention and no flash: {lk}")
    check(lk["TRAIN"] == (0, 0), f"TRAIN launched kernels: {lk}")
    del trainer
    free(torch)


def attn_row(torch, F, fa, flush, B, S, H, KV, hd, dtype, causal, card,
             label, tag="[20 zoo]", device_time=True):
    """One flash_attention row of the kernels line, timed as phase 3
    times its rows: error against the plain version, kernel (event and,
    with ``device_time``, device time), plain and sdpa times, and the
    bound recounted from these inputs (every (query, key) pair of the
    mask is computed)."""
    g = torch.Generator(device="cuda").manual_seed(5)
    q, k, v = (torch.randn((B, S, n, hd), generator=g, device="cuda")
               .to(dtype) for n in (H, KV, KV))
    run = lambda: fa.flash_attention(q, k, v, causal=causal)  # noqa: E731
    out = run()
    ref = fa.flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    err = max_err(out, ref)
    check(bool(torch.isfinite(out).all()) and err <= tol(dtype, torch),
          f"flash_attention {label}: max abs err {err}")
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    ms = time_ms(run, torch, flush)
    dev_ms = device_ms(run, torch, flush, "flash_tc" if dtype == torch.bfloat16
                       else "flash_fwd") if device_time else None
    plain = time_ms(lambda: fa.flash_attention_plain(q, k, v, causal=causal),
                    torch, flush)
    lib = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=True), torch, flush)
    nbytes = sum(x.numel() * x.element_size() for x in (q, k, v, out))
    pairs = S * (S + 1) // 2 if causal else S * S
    flops = 4.0 * B * H * hd * pairs
    b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    b_ops = flops / PEAK_FLOPS[str(dtype)] * 1e3
    name = str(dtype).replace("torch.", "")
    print(f"{tag} flash_attention ({label}) q{tuple(q.shape)} "
          f"k{tuple(k.shape)} {name} causal={causal}: err {err:.3g} (tol "
          f"{tol(dtype, torch):g}) | kernel {spread(ms)}, device "
          f"{spread(dev_ms) if dev_ms else 'not measured'}, plain "
          f"{spread(plain)}, sdpa {spread(lib)}, "
          f"kernel/sdpa {ms[0] / lib[0]:.2f}, bound "
          f"{max(b_bytes, b_ops):.4f} ms ({nbytes / 1e6:.1f} MB = "
          f"{b_bytes:.4f} ms; {flops / 1e9:.2f} GFLOP = {b_ops:.4f} ms) | "
          f"card {card}", flush=True)
    return dict(max_abs_err=err, ms=ms[0], plain_ms=plain[0],
                bound_ms=max(b_bytes, b_ops),
                bound_by="bytes" if b_bytes >= b_ops else "operations",
                library_ms=lib[0])


def zoo_phase20(torch, dev, fa, dec, card):
    """The model zoo's two feature-frontend architectures at full width:
    hubert-xlarge's encoder forward in fp32, kernel against plain, and
    in bf16 through the kernel; its LM mode in bf16; pixtral-12b served
    in bf16 with phase 5's traffic; pixtral-12b's LM mode on its first 8
    layers; then hubert's non-causal attention rows.  Returns the rows
    for the kernels line."""
    import torch.nn.functional as F
    from repro_torch.configs import archs
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import train as train_mod
    from repro_torch.models import transformer as T
    t_phase = time.monotonic()
    hcfg = archs.get(HUBERT_ARCH)
    H, KV, hd = hcfg.n_heads, hcfg.n_kv_heads, hcfg.resolved_head_dim
    rows = {}

    # (i) the encoder forward: fp32, kernel against plain (TF32 off)
    t0 = time.monotonic()
    params = T.init_params(hcfg, seed=0, device=dev, dtype=torch.float32)
    fg = torch.Generator(device=dev).manual_seed(0)
    feats = torch.randn((2, 1000, hcfg.feature_dim), generator=fg,
                        device=dev)
    runs = {}
    for impl in ("kernel", "plain"):
        _zero_counts(fa, dec)
        with torch.inference_mode():
            logits = T.forward(params, hcfg, {"features": feats},
                               attn_impl=impl)["logits"]
        torch.cuda.synchronize()
        runs[impl] = (logits, fa.launches, fa.launches_noncausal,
                      dec.launches)
    (lk, nk, nck, dk), (lp, np_, ncp, dp) = runs["kernel"], runs["plain"]
    rerr = rel_err(lk, lp, 2e-4)
    n_attn = hcfg.n_layers
    print(f"[20 zoo] {HUBERT_ARCH} fp32 full width ({hcfg.n_layers} layers, "
          f"d {hcfg.d_model}, {H}:{KV} heads of {hd}, "
          f"{hcfg.param_count() / 1e9:.3f} B parameters), encoder forward "
          f"on features [2, 1000, {hcfg.feature_dim}]: logits "
          f"{tuple(lk.shape)}, kernel vs plain max abs diff "
          f"{max_err(lk, lp):.3g}, allclose ratio {rerr:.3g} (rtol = atol "
          f"= 2e-4); launches flash {nk} (non-causal {nck}), decode {dk}; "
          f"plain run flash {np_}, decode {dp}; {time.monotonic() - t0:.1f}s"
          f" | card {card}", flush=True)
    check(bool(torch.isfinite(lk).all()), "non-finite hubert logits")
    check(rerr <= 2e-4, f"hubert kernel and plain forwards disagree: {rerr}")
    check(nk == nck == n_attn and dk == 0,
          f"hubert kernel run: flash {nk} (non-causal {nck}), decode {dk}; "
          f"expected {n_attn} non-causal flash and no decode")
    check(np_ == 0 and dp == 0, "the plain hubert run launched a kernel")
    rows["flash_attention/hubert_fp32"] = nk
    del runs, lk, lp, logits
    free(torch)

    # the same encoder in bf16 at the LM run's shape, through the kernel
    bparams = T.init_params(hcfg, seed=0, device=dev, dtype=torch.bfloat16)
    del params
    free(torch)
    feats = torch.randn((4, 1024, hcfg.feature_dim), generator=fg,
                        device=dev).to(torch.bfloat16)
    outs = {}
    for impl in ("kernel", "plain"):
        _zero_counts(fa, dec)
        with torch.inference_mode():
            outs[impl] = T.forward(bparams, hcfg, {"features": feats},
                                   attn_impl=impl)["logits"].float()
        torch.cuda.synchronize()
        if impl == "kernel":
            nb, nb_tc, nb_nc = fa.launches, fa.launches_tc, \
                fa.launches_noncausal
    print(f"[20 zoo] {HUBERT_ARCH} bf16 encoder forward on features "
          f"[4, 1024, {hcfg.feature_dim}]: launches flash {nb} (tensor cores "
          f"{nb_tc}, non-causal {nb_nc}); kernel vs plain logits max abs "
          f"diff {max_err(outs['kernel'], outs['plain']):.3g} (printed: 48 "
          f"layers of bf16 rounding) | card {card}", flush=True)
    check(bool(torch.isfinite(outs["kernel"]).all()),
          "non-finite bf16 hubert logits")
    check(nb == nb_tc == nb_nc == n_attn, f"bf16 hubert: flash {nb}, "
          f"tensor cores {nb_tc}, non-causal {nb_nc}; expected {n_attn}")
    rows["flash_attention/hubert_bf16"] = nb
    del bparams, outs, feats
    free(torch)

    # (ii) the LM mode at full width, bf16
    argv = ["--arch", HUBERT_ARCH, "--steps", "3", "--batch", "4", "--seq",
            "1024"]
    _zero_counts(fa, dec)
    lm_run(torch, dev, train_mod, argv, None, "20 zoo", card)
    check(fa.launches == 0 and dec.launches == 0,
          "LM training launched an attention kernel")

    # (iii) pixtral-12b served at full width, bf16, phase 5's traffic
    pcfg = first_layers(archs.get(PIXTRAL_ARCH), LAYERS20)
    W, P, N = 16, 256, 64
    argv = ["--arch", PIXTRAL_ARCH, "--batch", "48", "--wave", str(W),
            "--prompt-len", str(P), "--new-tokens", str(N),
            "--decode-chunk", "4", "--seed", "0"]
    _zero_counts(fa, dec)
    t0 = time.monotonic()
    rep = serve_mod.run(serve_mod.parse_args(argv), cfg=pcfg)
    torch.cuda.synchronize()
    passes = 3                          # warm-up, timed, TTFT
    got = {"flash_attention": fa.launches, "decode_attention": dec.launches}
    want = {"flash_attention": pcfg.n_layers * passes * rep["prefills"],
            "decode_attention": pcfg.n_layers * passes
            * rep["decode_rounds"]}
    gen = rep["gen_tokens"]
    check(tuple(gen.shape) == (48, N) and int(gen.min()) >= 0
          and int(gen.max()) < pcfg.vocab_size,
          f"pixtral: bad generated tokens {tuple(gen.shape)}")
    check(bool(torch.isfinite(rep["logprobs"]).all())
          and float(rep["logprobs"].max()) <= 1e-6,
          "pixtral: non-finite or positive logprobs")
    check(float(rep["mask"].sum()) == 48 * N,
          "pixtral: budgets not fully served")
    print(f"[20 zoo] {PIXTRAL_ARCH} bf16 full width (first {pcfg.n_layers} "
          f"of {archs.get(PIXTRAL_ARCH).n_layers} layers, "
          f"d {pcfg.d_model}, {pcfg.param_count() / 1e9:.2f} B parameters), "
          f"batch 48 wave {W} prompt {P} new {N}: {rep['tok_s']:.1f} valid "
          f"tok/s ({rep['valid_tokens']:.0f} tokens in {rep['seconds']:.3f} "
          f"s), TTFT p50 {rep['ttft_p50_s'] * 1e3:.1f} ms p95 "
          f"{rep['ttft_p95_s'] * 1e3:.1f} ms, {rep['decode_rounds']} decode "
          f"rounds, {rep['prefills']} prefills, occupancy "
          f"{rep['mean_occupancy']:.2f} (ideal {rep['ideal_occupancy']:.2f}), "
          f"peak {rep['peak_bytes'] / 2**30:.2f} GiB; launches (3 passes) "
          f"{got} (expected {want}), flash on the tensor cores "
          f"{fa.launches_tc}; {time.monotonic() - t0:.1f}s | card {card}",
          flush=True)
    check(got == want, f"pixtral serving launches {got}, expected {want}")
    check(fa.launches_tc == got["flash_attention"],
          f"bf16 flash launches {got['flash_attention']}, of which on the "
          f"tensor cores {fa.launches_tc}")
    rows["flash_attention/pixtral_prefill"] = got["flash_attention"]
    rows["decode_attention/pixtral_decode"] = got["decode_attention"]
    del rep, gen
    free(torch)

    # (iv) pixtral-12b's LM mode, its first 8 layers at full width
    cut = first_layers(pcfg, 8)
    n = cut.param_count()
    print(f"[20 zoo] {PIXTRAL_ARCH} LM mode, first {cut.n_layers} of "
          f"{archs.get(PIXTRAL_ARCH).n_layers} layers at full width: "
          f"{n / 1e9:.3f} B "
          f"parameters = {n * 2 / 1e9:.1f} GB bf16 weights, "
          f"{n * 2 / 1e9:.1f} GB gradients, {n * 8 / 1e9:.1f} GB fp32 Adam "
          f"moments (overwritten in place by the launcher's step)",
          flush=True)
    _zero_counts(fa, dec)
    lm_run(torch, dev, train_mod, ["--arch", PIXTRAL_ARCH, "--steps", "3",
                                   "--seq", "256"], cut, "20 zoo", card)
    check(fa.launches == 0 and dec.launches == 0,
          "LM training launched an attention kernel")

    # (v) hubert's non-causal attention rows
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    out = {}
    for dtype, key in ((torch.bfloat16, "flash_attention/hubert_bf16"),
                       (torch.float32, "flash_attention/hubert_fp32")):
        out[key] = dict(
            name=key, route="cuda",
            source="src/repro_torch/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention/kernel.py:26",
            launches=rows[key],
            **attn_row(torch, F, fa, flush, 4, 1024, H, KV, hd, dtype, False,
                       card, HUBERT_ARCH))
    del flush
    free(torch)
    print(f"[20 zoo] {time.monotonic() - t_phase:.1f}s | card {card}",
          flush=True)
    return out, rows


def lm_run(torch, dev, train_mod, argv, cfg, tag, card):
    """``launch.train`` in its LM mode (``run_lm``; ``cfg`` a depth cut or
    None): finite losses and grad norms; prints them, ms per step and the
    peak memory above what was allocated before."""
    free(torch)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.monotonic()
    print(f"[{tag}] python -m repro_torch.launch.train {' '.join(argv)}"
          + ("" if cfg is None else f" (cfg: first {cfg.n_layers} layers)"),
          flush=True)
    out = train_mod.run_lm(train_mod.parse_args(argv), cfg=cfg)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    losses, gn, secs = out["losses"], out["grad_norms"], out["step_s"]
    ms = sorted(s * 1e3 for s in secs[1:])
    c = out["cfg"]
    print(f"[{tag}] {c.name} LM {c.dtype} ({c.n_layers} layers, "
          f"{c.param_count() / 1e9:.3f} B parameters): losses "
          + ", ".join(f"{x:.4f}" for x in losses) + "; grad norms "
          + ", ".join(f"{x:.3f}" for x in gn)
          + f"; step 0 {secs[0] * 1e3:.1f} ms, later steps median "
          f"{ms[len(ms) // 2]:.1f} ms/step ({ms[0]:.1f}-{ms[-1]:.1f}); peak "
          f"{gib(peak - base):.2f} GiB above the {gib(base):.2f} GiB "
          f"allocated before it; {time.monotonic() - t0:.1f}s | card {card}",
          flush=True)
    check(all(math.isfinite(x) for x in losses + gn),
          f"{c.name}: non-finite LM loss or grad norm")
    del out
    free(torch)


def rl_spec_phase21(torch, dev, cfg, fa, dec, card, ref):
    """Phase 10's greedy PPO iteration (qwen3-0.6b full width, vocab 16,
    fp32) with speculative GEN (``RLConfig(spec_k=4)``, the default draft:
    the target's first quarter, 7 layers, window-free): tokens and masks
    identical to phase 10's GEN, log-probs within 1e-3; GEN launches
    flash_attention in the target's and the draft's one-shot prefill and
    decode_attention in the draft's steps (verify is plain attention),
    TRAIN nothing.  Then ``launch.train --rl grpo --spec-k 4``."""
    from repro_torch.data.synthetic import (AdditionTask, PromptDataset,
                                            VOCAB_SIZE)
    from repro_torch.launch import train as train_mod
    from repro_torch.rl.trainer import RLConfig, RLTrainer
    t0 = time.monotonic()
    K = 4
    rcfg = dataclasses.replace(cfg, vocab_size=VOCAB_SIZE, dtype="float32")
    task = AdditionTask(max_operand=9)
    trainer = RLTrainer(rcfg, RLConfig(
        algorithm="ppo", n_rollouts=4, max_new_tokens=task.max_answer_len,
        lr=1e-3, greedy=True, spec_k=K), task, seed=0, device=dev)
    prompts, answers = next(iter(PromptDataset(task, batch=16, seed=1)))
    hook = StageLaunches(fa, dec)
    restore = hook.install(type(trainer))
    try:
        with GenCalls(torch) as calls:
            m = trainer.iteration(prompts, answers, None)
            torch.cuda.synchronize()
        bb, lk = hook.bb, hook.by_kind(-1)
    finally:
        restore()
    dcfg = trainer._spec_draft[0]
    st, gen_ms = calls.stats[0], calls.ms[0]
    ro = bb["bundle"]["rollout"]
    same = ro["sequences"].equal(ref[0]) and ro["mask"].equal(ref[1])
    lp_err = max_err(ro["logprobs"], ref[2])
    want_gen = ((rcfg.n_layers + dcfg.n_layers) * st["prefills"],
                dcfg.n_layers * (K + 1) * st["decode_steps"])
    print(f"[21 rl spec] {ARCH} greedy PPO, GEN speculative k={K} with the "
          f"default draft ({dcfg.name}: {dcfg.n_layers} layers, "
          f"window-free): tokens and masks identical to phase 10={same}, "
          f"log-prob max diff {lp_err:.3g} (tol 1e-3); accept rate "
          f"{st['accept_rate']:.4f} ({st['spec_accepted']}/"
          f"{st['spec_proposed']} drafts, {st['spec_tokens']} tokens in "
          f"{st['decode_steps']} verify rounds, {st['prefills']} prefills); "
          f"GEN {gen_ms:.1f} ms against phase 10's {ref[3]:.1f} ms; "
          f"launches per stage (flash, decode) {lk}, GEN expected "
          f"{want_gen}; {time.monotonic() - t0:.1f}s | card {card}",
          flush=True)
    check(same, "speculative GEN differs from phase 10's GEN")
    check(lp_err <= 1e-3, f"speculative GEN log-probs differ by {lp_err}")
    check(all(math.isfinite(float(v)) for v in m.values()),
          "non-finite metrics")
    check(lk["GEN"] == want_gen, f"GEN launches {lk['GEN']}, expected "
          f"{want_gen}")
    check(lk["INF"][0] > 0 and lk["INF"][1] == 0,
          f"INF must launch flash and no decode: {lk}")
    check(lk["TRAIN"] == (0, 0), f"TRAIN launched kernels: {lk}")
    del trainer, bb, ro
    free(torch)

    argv = ["--arch", ARCH, "--batch", "16", "--rl", "grpo", "--steps", "2",
            "--spec-k", str(K)]
    t0 = time.monotonic()
    print(f"[21 rl spec] python -m repro_torch.launch.train "
          f"{' '.join(argv)}", flush=True)
    with GenCalls(torch) as calls:
        out = train_mod.run_rl(train_mod.parse_args(argv))
        torch.cuda.synchronize()
    ms = out["metrics"]
    check(len(ms) == 2 and all(math.isfinite(v) for x in ms
                               for v in x.values()),
          "non-finite RL metrics with --spec-k")
    check(len(calls.stats) == 2 and all(s["spec_proposed"] > 0
                                        for s in calls.stats),
          "--spec-k: GEN did not run speculative decoding")
    cmp = out["compare"]
    print(f"[21 rl spec] --spec-k {K}: GEN "
          + ", ".join(f"{x:.1f}" for x in calls.ms) + " ms, accept rate "
          + ", ".join(f"{s['accept_rate']:.4f}" for s in calls.stats)
          + f"; reward {ms[-1]['reward_mean']:.3f}; measured "
          f"{cmp['measured_iter_s'] * 1e3:.1f} ms/iter; "
          f"{time.monotonic() - t0:.1f}s | card {card}", flush=True)
    del out
    free(torch)


def sharded_phase22(torch, dev, card, layers: int = LAYERS22):
    """Sharded plan execution on ranks that share the card.

    First the probe: two ranks on ``cuda:0`` over gloo run each
    collective DTensor needs (``parallel.dist.probe_collectives``); a
    failing one fails the phase.  The same plan (``launch.sharded_exec``:
    GEN on plan devices 0-3, the rest on 4-7, GEN and TRAIN at DP 2 /
    TP 2, async GRPO) runs folded onto the card in this process (a world
    of one: collisions, no overlap), and as 8 ranks sharing the card:
    the attention kernels at the path's per-rank shapes against their
    plain versions (``sharded_exec.kernels_vs_plain``), greedy and
    sampled runs held against the world of one (``sharded_exec.check``),
    one actor step on a fixed batch within 1e-5 relative, launches per
    rank and task kind, ms per iteration overlapped and with the stage
    walk serialized, sync GB and ms, peak memory per rank.  Ranks that
    share one card measure the mechanism, not a multi-GPU speedup."""
    from repro_torch.configs import archs
    from repro_torch.data.synthetic import AdditionTask, VOCAB_SIZE
    from repro_torch.launch import sharded_exec as sx
    from repro_torch.parallel import dist
    t0 = time.monotonic()
    probe = dist.probe_collectives("cuda", 2)
    print(f"[22 probe] 2 ranks on cuda:0, backend "
          f"{probe[0].get('backend', dist.backend_for(dev, 2))}", flush=True)
    for name in dist.COLLECTIVES:
        print(f"[22 probe] {name}: "
              f"{' / '.join(str(r[name]) for r in probe)}", flush=True)
    ok = dist.probe_ok(probe)
    print(f"[22 probe] every collective sharded execution needs: "
          f"{'ok' if ok else 'FAILED'} ({time.monotonic() - t0:.1f}s)",
          flush=True)
    check(ok, f"ranks sharing the card over gloo: a collective failed: "
              f"{probe}")
    cfg = dataclasses.replace(first_layers(archs.get(ARCH), layers),
                              vocab_size=VOCAB_SIZE, dtype="float32")
    iters, batch, G, N = 3, 4, 8, 4
    step = (sx.step_batch(batch * G, 9, 5, VOCAB_SIZE), 5)
    base = {}
    for mode in ("sampled", "greedy"):
        tr = sx.make_trainer(cfg, dev, greedy=mode == "greedy",
                             n_rollouts=G, max_new_tokens=N)
        if mode == "sampled":
            one_step = sx.actor_step(tr, *step)
        base[mode] = sx._summary(tr, *sx.run(tr, iters, batch))
        del tr
        free(torch)
    w1 = base["sampled"]
    check(w1["world"] == 1 and w1["folding_collisions"] > 0
          and w1["overlap_active"] is False and w1["overlap_honest"] == 0.0,
          f"the world of one: {w1['folding_collisions']} collisions, "
          f"overlap {w1['overlap_active']}, honest {w1['overlap_honest']}")
    ms1 = 1e3 * sum(w1["wall_s"][1:]) / (iters - 1)
    print(f"[22 world-1] {cfg.name} first {layers} layers at full width "
          f"(fp32, vocab {VOCAB_SIZE}, {cfg.param_count() / 1e9:.3f} B "
          f"parameters), {batch} prompts x {G} rollouts = {batch * G} rows, "
          f"async GRPO folded onto the card: {w1['folding_collisions']} "
          f"collision(s), overlap_active {w1['overlap_active']}, "
          f"overlap_honest {w1['overlap_honest']}, {ms1:.0f} ms/iter "
          f"(iterations 1-{iters - 1}), losses {w1['losses']} | card {card}",
          flush=True)
    t0 = time.monotonic()
    # (the last three: no variants, no evaluate, GEN replayed on its own
    # weights in a world of one: ``sharded_exec._gen_replay``)
    res = dist.spawn(sx.rank_main, sx.WORLD, "cuda", cfg, iters, batch,
                     ("sampled", "greedy", "serialized"), None, True, G, N,
                     step, True, None, False, True, timeout=600)
    wall = time.monotonic() - t0
    r0 = res[0]
    H, hd = cfg.n_heads, cfg.head_dim
    P = AdditionTask(max_operand=9).prompt_len      # sharded_exec's task
    shapes = {"gen_prefill": [batch * G // 2, P, H // 2, hd],
              "gen_decode": [batch * G // 2, H // 2, hd],
              "inf": [batch * G // 4, P + N, H, hd]}
    errs = {}
    for r in res:
        labels = ("gen_prefill", "gen_decode") \
            if r["rank"] in r0["sampled"]["gen_ranks"] else ("inf",)
        check(set(r["kernels"]) == set(labels),
              f"rank {r['rank']} checked the kernels {sorted(r['kernels'])}")
        for label in labels:
            err, local = r["kernels"][label]
            check(local == shapes[label],
                  f"rank {r['rank']} {label}: local q {local}, the path's "
                  f"{shapes[label]}")
            check(err <= tol(torch.float32, torch),
                  f"rank {r['rank']} {label}: kernel vs plain {err:.3g} "
                  f"(tol 2e-4)")
            errs[label] = max(errs.get(label, 0.0), err)
    print(f"[22 sharded] kernels on DTensors at the path's per-rank shapes "
          f"(local q), as the sharded path calls them, vs the plain "
          f"versions on the full tensors, fp32: GEN prefill "
          f"flash_attention {shapes['gen_prefill']} max err "
          f"{errs['gen_prefill']:.3g}, GEN decode_attention "
          f"{shapes['gen_decode']} over a {P + N}-slot cache "
          f"{errs['gen_decode']:.3g}, INF flash_attention {shapes['inf']} "
          f"{errs['inf']:.3g} (tol 2e-4; 4 GEN ranks on the 2x2 mesh, 4 "
          f"INF ranks on the 4x1 one)", flush=True)
    # every reading is printed before the checks on it, so that a failed
    # run shows them
    s, ser = r0["sampled"], r0["serialized"]
    steps = [r["step"] for r in res if r["step"] is not None]
    check(len(steps) == 4, f"{len(steps)} ranks ran the actor step")
    rel = {k: abs(steps[0][k] - one_step[k]) / abs(one_step[k])
           for k in ("loss", "grad_norm")}
    agree, gagree = ([float((a == b).mean()) for a, b in
                      zip(r0[m]["tokens"], base[m]["tokens"])]
                     for m in ("sampled", "greedy"))
    replayed = {m: r0[m]["replay_agreement"]
                for m in ("sampled", "greedy", "serialized")}
    l1, b1 = s["losses"][1], base["sampled"]["losses"][1]
    print(f"[22 sharded] {sx.WORLD} ranks sharing cuda:0 over gloo: GEN on "
          f"ranks {s['gen_ranks']} (mesh {s['gen_mesh']}), TRAIN on "
          f"{s['train_ranks']} (mesh {s['train_mesh']}), collisions "
          f"{s['folding_collisions']}, overlap_active {s['overlap_active']}, "
          f"overlap_honest {s['overlap_honest']}, staleness "
          f"{s['staleness']}; greedy tokens agree with the world of one "
          f"{gagree} (bound 1.0); sampled tokens agree {agree} "
          f"(weight versions {s['gen_versions']}; bound 1.0 at version 0, "
          f"{sx.AGREEMENT} after); against a world-of-one "
          f"GEN replayed on the GEN ranks' own weights and generator state "
          f"{replayed} (bound {sx.REPLAY_AGREEMENT}); GEN weights equal to "
          f"the actor bit for bit after each iteration {s['sync_identical']} "
          f"(greedy {r0['greedy']['sync_identical']}); first trained loss "
          f"{l1:.6g} vs {b1:.6g} (difference {abs(l1 - b1):.2g}, "
          f"tol 1e-5 relative); actor step on a fixed {batch * G}-row "
          f"batch: loss and "
          f"grad norm relative {rel['loss']:.2g} / {rel['grad_norm']:.2g} "
          f"(tol 1e-5)", flush=True)
    for mode in ("sampled", "greedy"):
        sx.check(r0[mode], base[mode], greedy=mode == "greedy")
    check(ser["overlap_active"] is False,
          "the serialized run took the overlapped walk")
    check(all(v <= 1e-5 for v in rel.values()),
          f"sharded actor step vs the world of one: relative {rel}")
    check(all(len(v) == iters and min(v) >= sx.REPLAY_AGREEMENT
              for v in replayed.values()),
          f"GEN vs its world-of-one replay on the same weights: {replayed}")
    check(abs(l1 - b1) <= 1e-5 * abs(b1),
          f"first trained loss {l1} vs the world of one's {b1}")
    ms = {m: 1e3 * sum(r0[m]["wall_s"][1:]) / (iters - 1)
          for m in ("sampled", "serialized")}
    sync_ms = 1e3 * sum(s["sync_s"]) / max(len(s["sync_s"]), 1)
    print(f"[22 sharded] ms/iter (iterations 1-{iters - 1}, rank 0's wall): "
          f"overlapped {ms['sampled']:.0f}, serialized stage walk "
          f"{ms['serialized']:.0f}, world of one {ms1:.0f}; weight sync "
          f"{s['sync_gb'][1]:.3f} GB in {sync_ms:.0f} ms (train lead -> 4 "
          f"GEN ranks, gloo through host memory); peak GiB per rank "
          f"{[round(r['peak_gib'], 2) for r in res]}; {wall:.0f}s with the "
          f"ranks' start | card {card} (ranks share one card: the "
          f"mechanism, not a multi-GPU speedup)", flush=True)
    launches = {r["rank"]: r["launches"] for r in res}
    print(f"[22 sharded] launches per rank and task kind (flash, decode), "
          f"3 runs: {launches}", flush=True)
    for r, c in launches.items():
        if r in s["gen_ranks"]:
            check(c.get("GEN", {}).get("decode", 0) > 0
                  and c.get("GEN", {}).get("flash", 0) > 0,
                  f"GEN rank {r} launched {c.get('GEN')}")
        else:
            check(c.get("INF", {}).get("flash", 0) > 0,
                  f"INF rank {r} launched {c.get('INF')}")
            check(c.get("INF", {}).get("decode", 0) == 0,
                  f"INF rank {r} launched decode_attention")
        check(not any(c.get("TRAIN", {}).values()),
              f"TRAIN on rank {r} launched {c.get('TRAIN')}")


# ---------------------------------------------------------------------------
# phase 23: the genserve engine on a mesh of ranks sharing the card
# ---------------------------------------------------------------------------

LAYERS23 = 8                       # phase 23's depth cut of qwen3-0.6b
# (b)'s traffic: 24 requests, wave 8, prompt 64 with 32 shared, 16 new
SERVE23 = dict(requests=24, wave=8, prompt=64, shared=32, new=16)
SERVE23_MODES = {
    "paged+prefix": dict(prefill_chunk=16, page_size=16, prefix_cache=True),
    "spec k=4": dict(spec_k=4),
    "slot failures+cancels": dict(slot_failures={3: [1, 6], 9: [2]},
                                  cancels={2: [20], 6: [4]}),
}


def serve23_setup(torch, device):
    """Phase 23 (b)'s model (qwen3-0.6b's first 8 layers at full width,
    its own vocab, fp32), its 2-layer draft, seeded weights, and the
    traffic: every rank and the world of one build the same."""
    import numpy as np
    from repro_torch.configs import archs
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(first_layers(archs.get(ARCH), LAYERS23),
                              dtype="float32")
    dcfg = dataclasses.replace(first_layers(cfg, 2), name=f"{ARCH}-draft")
    t = SERVE23
    rng = np.random.default_rng(23)
    prompts = rng.integers(0, cfg.vocab_size, (t["requests"], t["prompt"]))
    prompts[:, :t["shared"]] = prompts[0, :t["shared"]]
    return (cfg, T.init_params(cfg, seed=0, device=device),
            dcfg, T.init_params(dcfg, seed=7, device=device),
            torch.as_tensor(prompts, device=device))


def serve23_modes(torch, device, mesh=None):
    """Each of ``SERVE23_MODES`` through ``genserve.generate`` (on
    ``mesh`` when given), greedy: rollout, wall seconds, the two attention
    kernels' launches inside the call, hit and accept rates, requeues,
    cancels and leaked pages."""
    from repro_torch.genserve import adapter
    from repro_torch.kernels.decode_attention import ops as dec
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.rl.rollout import SamplerConfig
    cfg, params, dcfg, dparams, prompts = serve23_setup(torch, device)
    out = {}
    for name, kw in SERVE23_MODES.items():
        kw = dict(kw)
        if kw.get("spec_k"):
            kw.update(draft_params=dparams, draft_cfg=dcfg)
        _zero_counts(fa, dec)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        ro, st = adapter.generate(
            params, cfg, prompts, None,
            SamplerConfig(max_new_tokens=SERVE23["new"], greedy=True),
            wave=SERVE23["wave"], fast_path=False, device=device, mesh=mesh,
            **kw)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        leaked = st["_pagepool"].leak_check(
            expected_refs=st["_radix"].page_refs()) \
            if "_pagepool" in st else []
        out[name] = dict(
            rollout={k: ro[k].cpu() for k in ("gen_tokens", "mask",
                                              "logprobs")},
            wall=wall, flash=fa.launches, decode=dec.launches,
            hit=st["prefix_hit_rate"], accept=st["accept_rate"],
            requeued=st["requeued"], cancelled=st["cancelled"],
            leaked=len(leaked))
    return out


def serve23_rank(device):
    """One of 4 GEN ranks on a 2x2 ("data", "model") mesh over the card:
    ``serve23_modes`` sharded, then both attention kernels as the engine
    calls them at its per-rank shapes against their plain versions;
    peak memory of the rank."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.launch import sharded_exec as sx
    from repro_torch.parallel import dist
    from repro_torch.parallel import sharding as sh
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = DeviceMesh(device.type, torch.arange(4).reshape(2, 2),
                      mesh_dim_names=sh.AXES)
    out = {"rank": dist.rank(), "modes": serve23_modes(torch, device, mesh)}
    from repro_torch.configs import archs
    c = archs.get(ARCH)
    out["kernels"] = sx.mesh_attention(
        mesh, device, "float32", c.n_heads, c.n_kv_heads, c.head_dim,
        SERVE23["wave"], SERVE23["prompt"],
        SERVE23["prompt"] + SERVE23["new"])
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return out


def decode_row(torch, F, dec, flush, B, L, H, KV, hd, card, label, tag,
               dtype=None):
    """One decode_attention call (fp32 unless ``dtype`` says otherwise)
    at [B, H, hd] over an L-slot cache whose last slot is not yet valid
    (a decode step's bias), timed as phase 3 times its rows: error
    against the plain version, kernel, plain and sdpa times, and the
    bound recounted from these inputs (the valid K/V rows only)."""
    dtype = dtype or torch.float32
    g = torch.Generator(device="cuda").manual_seed(5)
    q = torch.randn((B, H, hd), generator=g, device="cuda").to(dtype)
    k, v = (torch.randn((B, L, KV, hd), generator=g, device="cuda")
            .to(dtype) for _ in range(2))
    bias = torch.where(torch.arange(L, device="cuda") < L - 1, 0.0,
                       -1e30).expand(B, L).contiguous()
    run = lambda: dec.decode_attention(q, k, v, bias)  # noqa: E731
    out = run()
    err = max_err(out, dec.decode_attention_plain(q, k, v, bias))
    check(bool(torch.isfinite(out).all()) and err <= tol(dtype, torch),
          f"decode_attention {label}: max abs err {err}")
    q4, k4, v4 = q[:, :, None], k.transpose(1, 2).contiguous(), \
        v.transpose(1, 2).contiguous()
    ms = time_ms(run, torch, flush)
    plain = time_ms(lambda: dec.decode_attention_plain(q, k, v, bias),
                    torch, flush)
    lib = time_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, attn_mask=bias[:, None, None, :], enable_gqa=True),
        torch, flush)
    n_valid = int((bias == 0).sum())
    nbytes = (q.element_size() * (q.numel() + out.numel()
                                  + 2 * n_valid * KV * hd)
              + bias.element_size() * bias.numel())
    flops = 4.0 * H * hd * n_valid
    b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    b_ops = flops / PEAK_FLOPS[str(dtype)] * 1e3
    name = str(dtype).replace("torch.", "")
    print(f"{tag} decode_attention ({label}) q{tuple(q.shape)} "
          f"k{tuple(k.shape)} {name}, {n_valid} valid rows: err {err:.3g} "
          f"(tol {tol(dtype, torch):g}) | kernel {spread(ms)}, plain "
          f"{spread(plain)}, sdpa {spread(lib)}, kernel/sdpa "
          f"{ms[0] / lib[0]:.2f}, bound {max(b_bytes, b_ops):.5f} ms "
          f"({nbytes / 1e6:.3f} MB) | card {card}", flush=True)
    return dict(max_abs_err=err, ms=ms[0], plain_ms=plain[0],
                bound_ms=max(b_bytes, b_ops),
                bound_by="bytes" if b_bytes >= b_ops else "operations",
                library_ms=lib[0])


def sharded_genserve_phase23(torch, dev, card, layers: int = LAYERS23):
    """The genserve engine on a mesh of ranks that share the card.

    (a) phase 22's gen | rest plan on 8 ranks with 8 prompts x 8
    rollouts = 64 GEN rows, two decode waves of 32, so GEN serves on
    genserve on the DP 2 / TP 2 GEN mesh; greedy, one-shot admission and
    ``prefill_chunk`` 16; tokens and masks held against the plan folded
    onto the card in this process (``sharded_exec.check``), the kernels
    at the engine's per-rank shapes against their plain versions, GEN
    launches per rank.  (b) ``genserve.generate(mesh=)`` itself on 4
    ranks: qwen3-0.6b's first 8 layers at full width with its own vocab
    (fp32), 24 requests, wave 8, prompt 64 with 32 shared, 16 new, paged
    with prefix reuse, speculative (k 4, a 2-layer draft) and with slot
    failures and cancels, each token for token against the world of one
    on the card, zero leaked pages, both kernels per rank at the engine's
    per-rank shapes (2e-4); the kernels' times at those shapes in this
    process.  Ranks sharing one card measure the mechanism, not a
    multi-GPU speedup."""
    import torch.nn.functional as F
    from repro_torch.configs import archs
    from repro_torch.data.synthetic import AdditionTask, VOCAB_SIZE
    from repro_torch.kernels.decode_attention import ops as dec
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.launch import sharded_exec as sx
    from repro_torch.parallel import dist
    t_phase = time.monotonic()
    # -- (a) the RL engine: sharded GEN beyond one decode wave -----------
    cfg = dataclasses.replace(first_layers(archs.get(ARCH), layers),
                              vocab_size=VOCAB_SIZE, dtype="float32")
    iters, batch, G, N = 2, 8, 8, 4
    variants = {"one-shot": {"greedy": True},
                "chunked 16": {"greedy": True, "prefill_chunk": 16}}
    base = {}
    for label, kw in variants.items():
        tr = sx.make_trainer(cfg, dev, n_rollouts=G, max_new_tokens=N, **kw)
        base[label] = sx._summary(tr, *sx.run(tr, iters, batch))
        del tr
        free(torch)
    t0 = time.monotonic()
    res = dist.spawn(sx.rank_main, sx.WORLD, "cuda", cfg, iters, batch, (),
                     None, True, G, N, None, True, variants, timeout=600)
    wall_a = time.monotonic() - t0
    r0 = res[0]
    P = AdditionTask(max_operand=9).prompt_len
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    W = 32                                          # decode_wave(64)
    for label in variants:
        s = r0[label]
        sx.check(s, base[label], greedy=True)
        check(s["gen_wave"][1:] == [float(W)] * (iters - 1),
              f"{label}: GEN waves {s['gen_wave']}, not genserve's {W}")
        ms = 1e3 * sum(s["wall_s"][1:]) / (iters - 1)
        ms1 = 1e3 * sum(base[label]["wall_s"][1:]) / (iters - 1)
        print(f"[23 rl] {label}: {batch} prompts x {G} rollouts = "
              f"{batch * G} GEN rows in waves of {W} on genserve on the "
              f"GEN mesh {s['gen_mesh']} (ranks {s['gen_ranks']}); greedy "
              f"tokens and masks identical to the world of one in all "
              f"{iters} iterations; GEN decode steps {s['gen_decode_steps']}"
              f", prefill rounds {s['gen_prefill_rounds']}; {ms:.0f} "
              f"ms/iter (iteration 1, rank 0's wall) against the world of "
              f"one's {ms1:.0f} | card {card}", flush=True)
    shapes = {"gen_prefill": [W // 2, P, H // 2, hd],
              "gen_decode": [W // 2, H // 2, hd],
              "inf": [batch * G // 4, P + N, H, hd]}
    for r in res:
        for label, (err, local) in r["kernels"].items():
            check(local == shapes[label],
                  f"rank {r['rank']} {label}: local q {local}, the "
                  f"engine's {shapes[label]}")
            check(err <= tol(torch.float32, torch),
                  f"rank {r['rank']} {label}: kernel vs plain {err:.3g}")
        c = r["launches"]
        if r["rank"] in r0["one-shot"]["gen_ranks"]:
            check(c["GEN"]["decode"] > 0 and c["GEN"]["flash"] > 0,
                  f"GEN rank {r['rank']} launched {c['GEN']}")
        check(not any(c.get("TRAIN", {}).values()),
              f"TRAIN on rank {r['rank']} launched {c.get('TRAIN')}")
    errs = {lb: max(r["kernels"][lb][0] for r in res if lb in r["kernels"])
            for lb in shapes}
    print(f"[23 rl] kernels on DTensors at the engine's per-rank shapes "
          f"(local q) vs plain, fp32: GEN prefill {shapes['gen_prefill']} "
          f"{errs['gen_prefill']:.3g}, GEN decode {shapes['gen_decode']} "
          f"over a {P + N}-slot cache {errs['gen_decode']:.3g}, INF "
          f"{shapes['inf']} {errs['inf']:.3g} (tol 2e-4); launches per rank "
          f"and task kind (flash, decode), both runs: "
          f"{ {r['rank']: r['launches'] for r in res} }; peak GiB per rank "
          f"{[round(r['peak_gib'], 2) for r in res]}; {wall_a:.0f}s with "
          f"the ranks' start", flush=True)
    # -- (b) genserve.generate(mesh=) on 4 ranks --------------------------
    one = serve23_modes(torch, dev)
    free(torch)
    t0 = time.monotonic()
    res = dist.spawn(serve23_rank, 4, "cuda", timeout=600)
    wall_b = time.monotonic() - t0
    c = archs.get(ARCH)
    t = SERVE23
    for name in SERVE23_MODES:
        w1 = one[name]
        lp = 0.0
        for r in res:
            m = r["modes"][name]
            same, d = _same_rollout(m["rollout"], w1["rollout"])
            lp = max(lp, d)
            check(same, f"{name}: rank {r['rank']}'s tokens differ from "
                        f"the world of one's")
            check(d <= 1e-3, f"{name}: rank {r['rank']} log-probs "
                             f"{d:.3g} from the world of one's")
            check(m["leaked"] == 0 and w1["leaked"] == 0,
                  f"{name}: leaked pages {m['leaked']} / {w1['leaked']}")
            check(m["decode"] > 0, f"{name}: rank {r['rank']} launched no "
                                   f"decode_attention")
            if "prefill_chunk" not in SERVE23_MODES[name]:
                check(m["flash"] > 0, f"{name}: rank {r['rank']} launched "
                                      f"no flash_attention")
        m = res[0]["modes"][name]
        print(f"[23 serve] {name}: {t['requests']} requests, wave "
              f"{t['wave']}, prompt {t['prompt']} ({t['shared']} shared), "
              f"{t['new']} new, {c.name} first {LAYERS23} layers at full "
              f"width (vocab {c.vocab_size}, fp32) on a 2x2 mesh of 4 ranks "
              f"sharing cuda:0: tokens and masks identical to the world of "
              f"one on every rank, log-prob diff {lp:.3g}; hit rate "
              f"{m['hit']:.4f}, accept rate {m['accept']:.4f}, requeued "
              f"{m['requeued']}, cancelled {m['cancelled']}, leaked pages "
              f"{m['leaked']}; launches per rank (flash, decode) "
              f"{[(r['modes'][name]['flash'], r['modes'][name]['decode']) for r in res]}"
              f"; {m['wall']:.2f} s on the mesh (rank 0) against "
              f"{w1['wall']:.2f} s for the world of one | card {card}",
              flush=True)
    wl, hl, kl = t["wave"] // 2, c.n_heads // 2, c.n_kv_heads // 2
    want = {"prefill": [wl, t["prompt"], hl, c.head_dim],
            "decode": [wl, hl, c.head_dim]}
    for r in res:
        for label, (err, local) in r["kernels"].items():
            check(local == want[label] and err <= tol(torch.float32, torch),
                  f"rank {r['rank']} {label}: local q {local} (the "
                  f"engine's {want[label]}), kernel vs plain {err:.3g}")
    print(f"[23 serve] kernels on DTensors at the engine's per-rank shapes "
          f"vs plain, fp32: prefill {want['prefill']} "
          f"{max(r['kernels']['prefill'][0] for r in res):.3g}, decode "
          f"{want['decode']} over a {t['prompt'] + t['new']}-slot cache "
          f"{max(r['kernels']['decode'][0] for r in res):.3g} (tol 2e-4); "
          f"peak GiB per rank {[round(r['peak_gib'], 2) for r in res]}; "
          f"{wall_b:.0f}s with the ranks' start", flush=True)
    # -- the kernels' times at the per-rank shapes, in this process ------
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    tag = "[23 kernels]"
    attn_row(torch, F, fa, flush, wl, t["prompt"], hl, kl, c.head_dim,
             torch.float32, True, card, "serve mesh prefill, per rank", tag)
    decode_row(torch, F, dec, flush, wl, t["prompt"] + t["new"], hl, kl,
               c.head_dim, card, "serve mesh decode, per rank", tag)
    attn_row(torch, F, fa, flush, W // 2, P, H // 2, KV // 2, hd,
             torch.float32, True, card, "RL GEN mesh prefill, per rank",
             tag)
    decode_row(torch, F, dec, flush, W // 2, P + N, H // 2, KV // 2, hd,
               card, "RL GEN mesh decode, per rank", tag)
    del flush
    free(torch)
    print(f"[23 sharded genserve] {time.monotonic() - t_phase:.1f}s | card "
          f"{card}", flush=True)


# ---------------------------------------------------------------------------
# phase 24: the RL launcher's drift and faults on ranks sharing the card
# ---------------------------------------------------------------------------

LAYERS24 = 8            # the GRPO state (2.5 GB) must fit the format's 4 GiB
ARGV24 = ["--arch", ARCH, "--rl", "grpo", "--batch", "8",
          "--search-budget", "40"]
RUNS24 = (("drop_tail", ["--drift", "drop_tail", "--steps", "5"]),
          ("permanent_crash", ["--fault", "permanent_crash",
                               "--require-recover", "--steps", "7"]),
          ("ckpt_corrupt", ["--fault", "ckpt_corrupt", "--require-recover",
                            "--steps", "3"]))
TOL24 = 2e-6            # kernel vs plain at the per-rank shapes, fp32


def plan_key(plan):
    """A plan's parallelization and device assignment, comparable."""
    import numpy as np
    return (sorted((int(t), tuple(int(x) for x in p))
                   for t, p in plan.parallel.items()),
            sorted((int(t), np.asarray(a).tolist())
                   for t, a in plan.assignment.items()))


def task_launches():
    """Kernel launches per (plan epoch, task name) on this process: wraps
    the registered executors (a rank process, once at its start) to read
    the two attention kernels' counts around each task."""
    from repro_torch.engine import tasks as tasks_mod
    from repro_torch.kernels.decode_attention import ops as dec
    from repro_torch.kernels.flash_attention import ops as fa
    counts = {}
    for key, fn in list(tasks_mod._EXECUTORS.items()):
        def wrapped(st, bb, pl, _fn=fn):
            f0, d0 = fa.launches, dec.launches
            try:
                return _fn(st, bb, pl)
            finally:
                c = counts.setdefault(
                    f"{st.engine.epoch}/{st.wf.task(pl.task).name}", [0, 0])
                c[0] += fa.launches - f0
                c[1] += dec.launches - d0
        tasks_mod._EXECUTORS[key] = wrapped
    return counts


def elastic24_run(torch, extra, counts=None):
    """One ``launch.train`` run of phase 24 (``run_rl`` on the 8-layer
    cut) in this process, a rank's or the world of one's: the recovery
    line, the controller's records, ms/iter per plan epoch, each epoch's
    placements, the checkpoint's metrics; on a rank also the launches per
    (epoch, task) (set to 0 just before the run), the kernels against
    their plain versions at the last epoch's per-rank shapes, and the
    peak memory."""
    import shutil
    from repro_torch.configs import archs
    from repro_torch.core.plan import decode_wave
    from repro_torch.launch import sharded_exec as sx
    from repro_torch.launch import train as train_mod
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.parallel import dist
    if dist.rank() == 0:
        shutil.rmtree(train_mod.CKPT_DIR, ignore_errors=True)
    if dist.multi():
        torch.distributed.barrier()
    obs_metrics.reset()
    if counts is not None:
        counts.clear()
    args = train_mod.parse_args(ARGV24 + extra)
    t0 = time.monotonic()
    res = train_mod.run_rl(args, cfg=first_layers(archs.get(ARCH),
                                                  LAYERS24))
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    tr, ctrl = res["trainer"], res["controller"]
    eng = tr.engine
    snap = obs_metrics.snapshot()
    out = {"recovered": res["recovered"], "wall": wall,
           "records": [dict(iteration=r.iteration, epoch=r.epoch,
                            applied=r.applied, forced=r.forced,
                            reactive=r.reactive, ckpt_bytes=r.ckpt_bytes,
                            plan=plan_key(r.decision.plan),
                            resched_s=r.reschedule_s)
                       for r in ctrl.records],
           "epochs": [(row["epoch"], row["iterations"],
                       row["measured_iter_s"])
                      for row in eng.epoch_report()],
           "placements": [{tr.wf.task(t).name: (list(pl.ranks),
                                                 list(pl.mesh_shape))
                           for t, pl in c.placements.items()}
                          for c in eng.ctx_history + [eng.ctx]],
           "ckpt": {k: snap.get(k) for k in (
               "elastic.ckpt_gather_s", "elastic.ckpt_write_s",
               "elastic.checkpoint_bytes")}}
    if counts is not None:
        rows = args.batch * tr.rl.n_rollouts
        out["launches"] = {k: tuple(v) for k, v in counts.items()}
        out["kernels"] = sx.kernels_vs_plain(
            tr, rows, tr.task.prompt_len, tr.rl.max_new_tokens,
            gen_rows=decode_wave(rows))
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del res, tr, ctrl, eng
    free(torch)
    return out


def elastic24_rank(device):
    """One of 8 ranks sharing the card: the three runs of ``RUNS24``."""
    import torch
    from repro_torch.parallel import dist
    torch.backends.cuda.matmul.allow_tf32 = False
    counts = task_launches()
    return {"rank": dist.rank(),
            "runs": {label: elastic24_run(torch, extra, counts)
                     for label, extra in RUNS24}}


def _declared(records):
    """The replans nothing timed decides (a declared drift, a forced
    replan): what the world of one must share."""
    return [{k: v for k, v in r.items() if k != "resched_s"}
            for r in records if not r["reactive"]]


def _reactive(records):
    return [r["iteration"] for r in records if r["reactive"]]


def elastic_ranks_phase24(torch, dev, card):
    """``launch.train --rl grpo`` with ``--drift drop_tail``, ``--fault
    permanent_crash --require-recover`` and ``--fault ckpt_corrupt
    --require-recover`` on 8 ranks sharing the card (gloo), qwen3-0.6b's
    first 8 layers at full width (fp32, vocab 16), held against the same
    runs in a world of one on the card: the same recovery line (its kind
    where the timed reactive replans differ: one rewrites the checkpoint
    of its iteration) and the same declared and forced replans
    (iteration, epoch, plan) on every rank; the kernels within 2e-6 of plain at the last epoch's per-rank
    shapes; GEN launching both attention kernels and reference inference
    flash in every epoch, TRAIN none; ms/iter per plan epoch, reschedule
    seconds, the checkpoint's GB, gather and write seconds and GB/s; then
    both kernels timed at drop_tail's per-rank shapes after its swap.
    Ranks sharing one card measure the mechanism, not a speedup."""
    import shutil
    import torch.nn.functional as F
    from repro_torch.data.synthetic import AdditionTask
    from repro_torch.kernels.decode_attention import ops as dec
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.launch import train as train_mod
    from repro_torch.parallel import dist
    t_phase = time.monotonic()
    one = {}
    for label, extra in RUNS24:
        t0 = time.monotonic()
        one[label] = elastic24_run(torch, extra)
        print(f"[24 world-1] {label}: {one[label]['recovered']!r}; declared "
              f"replans {len(_declared(one[label]['records']))}; "
              f"{time.monotonic() - t0:.1f}s | card {card}", flush=True)
    t0 = time.monotonic()
    res = dist.spawn(elastic24_rank, 8, "cuda", timeout=600)
    wall = time.monotonic() - t0
    shutil.rmtree(train_mod.CKPT_DIR, ignore_errors=True)
    for label, _ in RUNS24:
        runs = [r["runs"][label] for r in res]
        s, w1 = runs[0], one[label]
        check(all(x["recovered"] == s["recovered"]
                  and x["records"] == s["records"] for x in runs),
              f"{label}: the ranks' recovery lines or replans differ")
        # a reactive replan checkpoints too, and one at the corrupted
        # checkpoint's iteration rewrites that file: where the (timed)
        # reactive replans differ, the line's numbers may, not its kind
        same = _reactive(s["records"]) == _reactive(w1["records"])
        check(s["recovered"] == w1["recovered"] if same else
              re.sub(r"\d+", "N", s["recovered"] or "")
              == re.sub(r"\d+", "N", w1["recovered"] or ""),
              f"{label}: recovery {s['recovered']!r} on ranks, "
              f"{w1['recovered']!r} in the world of one (reactive "
              f"replans {'alike' if same else 'differ'})")
        check(_declared(s["records"]) == _declared(w1["records"])
              and (label == "ckpt_corrupt" or _declared(s["records"])),
              f"{label}: declared or forced replans on ranks "
              f"{_declared(s['records'])} vs the world of one's "
              f"{_declared(w1['records'])}")
        before, after = s["placements"][0], s["placements"][-1]
        print(f"[24 ranks] {label}: placements (ranks, mesh) before the "
              f"first replan {before}; after the last {after}", flush=True)
        ck = s["ckpt"]
        gather, write = ck["elastic.ckpt_gather_s"], ck["elastic.ckpt_write_s"]
        n = max(write["count"], 1) if write else 1
        nbytes = ck["elastic.checkpoint_bytes"] or 0
        secs = (gather["sum"] if gather else 0) + (write["sum"]
                                                   if write else 0)
        print(f"[24 ranks] {label}: {s['recovered']!r} (world of one "
              f"{w1['recovered']!r}); replans (iteration, epoch, forced, reactive, "
              f"reschedule s) "
              f"{[(r['iteration'], r['epoch'], r['forced'], r['reactive'], round(r['resched_s'], 3)) for r in s['records']]}"
              f" (world of one {[(r['iteration'], r['epoch'], round(r['resched_s'], 3)) for r in w1['records']]}); "
              f"ms/iter per epoch "
              f"{[(e, i, round(m * 1e3, 1)) for e, i, m in s['epochs']]} "
              f"(world of one "
              f"{[(e, i, round(m * 1e3, 1)) for e, i, m in w1['epochs']]}); "
              f"checkpoints {n} of {nbytes / n / 1e9:.3f} GB, gather "
              f"{gather['sum'] / n if gather else 0:.2f} s + write "
              f"{write['sum'] / n if write else 0:.2f} s each, "
              f"{nbytes / max(secs, 1e-9) / 1e9:.3f} GB/s; run "
              f"{s['wall']:.1f} s (world of one {w1['wall']:.1f} s) | card "
              f"{card}", flush=True)
        launches = {r["rank"]: r["runs"][label]["launches"] for r in res}
        print(f"[24 ranks] {label}: launches (flash, decode) per rank and "
              f"epoch/task: {launches}", flush=True)
        for r, c in launches.items():
            for key, (nf, nd) in c.items():
                task = key.split("/", 1)[1]
                if task == "actor_generation":
                    check(nf > 0 and nd > 0, f"{label}: GEN on rank {r} "
                                             f"({key}) launched {nf}, {nd}")
                elif task == "reference_inference":
                    check(nf > 0 and nd == 0, f"{label}: INF on rank {r} "
                                              f"({key}) launched {nf}, {nd}")
                else:
                    check(nf == nd == 0, f"{label}: {key} on rank {r} "
                                         f"launched {nf}, {nd}")
        for e, iters, _ in s["epochs"]:
            if iters:
                got = [c for c in launches.values()
                       if f"{e}/actor_generation" in c]
                check(got, f"{label}: epoch {e} ran no GEN on any rank")
        errs = {}
        for r in res:
            for lb, (err, local) in r["runs"][label]["kernels"].items():
                check(err <= TOL24, f"{label}: rank {r['rank']} {lb} "
                                    f"{local}: kernel vs plain {err:.3g} "
                                    f"(tol {TOL24:g})")
                key = (lb, tuple(local))
                errs[key] = max(errs.get(key, 0.0), err)
        print(f"[24 ranks] {label}: kernels vs plain at the last epoch's "
              f"per-rank shapes (local q), fp32: "
              f"{ {f'{lb} {list(sh)}': f'{e:.3g}' for (lb, sh), e in errs.items()} }"
              f" (tol {TOL24:g}); peak GiB per rank "
              f"{[round(r['runs'][label]['peak_gib'], 2) for r in res]}",
              flush=True)
        if label == "drop_tail":
            shapes = sorted(errs)
    print(f"[24 ranks] 8 ranks on cuda:0 over gloo: {wall:.1f}s with the "
          f"ranks' start", flush=True)
    # both kernels timed at drop_tail's per-rank shapes after its swap
    from repro_torch.configs import archs
    c = archs.get(ARCH)
    task = AdditionTask(max_operand=9)     # the launcher's task
    L = task.prompt_len + task.max_answer_len
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    tag = "[24 kernels]"
    for lb, local in shapes:
        h = local[-2]
        kv = c.n_kv_heads * h // c.n_heads
        if lb == "gen_decode":
            decode_row(torch, F, dec, flush, local[0], L, h, kv, local[-1],
                       card, f"{lb}, per rank after the swap", tag)
        else:
            attn_row(torch, F, fa, flush, local[0], local[1], h, kv,
                     local[-1], torch.float32, True, card,
                     f"{lb}, per rank after the swap", tag)
    del flush
    free(torch)
    print(f"[24 elastic ranks] {time.monotonic() - t_phase:.1f}s | card "
          f"{card}", flush=True)


# ---------------------------------------------------------------------------
# phase 25: qwen3-0.6b's full-width steps against the dry-run's roofline
# ---------------------------------------------------------------------------

# the dry-run records counted in (b), on the single-pod fake mesh; the
# host seconds of train_4k and prefill_32k stand in PERF.md (the three
# together take more than the phase's minute)
COUNT_SHAPES25 = ("decode_32k",)
PREFILL25 = (4, 4096)       # prefill_32k [32, 32768]: its logits alone 318 GB
DECODE25 = (32, 8192)       # decode_32k [128, 32768]: its KV cache 481 GB
TRAIN25_SEQ = 4096          # train_4k's sequence; the largest batch that fits
TRAIN25_BATCHES = (8, 4, 2, 1)
STEP_ITERS, STEP_WARMUP = 10, 2
TRAIN25_ITERS = 1           # the train step (7.3 s a call): 1 after 1
# phase 25's bf16 limits at all 28 layers, |a - b| / (1 + |b|) of the
# logits against the plain attention: within DEPTH25_TOL, and within
# SDPA25_RATIO times the gap of torch's sdpa in the plain attention's
# place on the same inputs; from the readings on an H100 80GB HBM3 at
# 700 W: the kernels 0.0453 (prefill) and 0.0574-0.0613 (serve), sdpa
# 0.0460 and 0.0724; one layer's flash call is 0.0156 from plain there,
# as sdpa's
DEPTH25_TOL = 0.1
SDPA25_RATIO = 1.25
PEAK25_TOL = 0.10           # the train step's counted peak vs measured


def step_ms(torch, fn, iters: int = STEP_ITERS, warmup: int = STEP_WARMUP):
    """(median, min, max) CUDA-event ms of one whole step over ``iters``
    calls after ``warmup``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    times.sort()
    return times[len(times) // 2], times[0], times[-1]


def sdpa_attention(q, k, v, q_pos, k_pos, *, causal, window, cap,
                   k_valid=None):
    """torch's ``scaled_dot_product_attention`` in the plain attention's
    place (shared positions, no window or softcap): phase 25's yardstick
    for the bf16 gap a fused attention opens against the plain path."""
    import torch
    import torch.nn.functional as F
    check(window is None and cap is None, "sdpa_attention: no window, cap")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if q.shape[1] == 1:
        mask = None if k_valid is None else torch.where(
            k_valid.reshape(1, 1, 1, -1), 0.0, -1e30).to(q.dtype)
        o = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                           enable_gqa=True)
    else:
        o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                           enable_gqa=True)
    return o.transpose(1, 2)


def roofline_phase25(torch, F, dev, fa, dec, card):
    """(a) the local microbench on the card; (b) dry-run counts of
    qwen3-0.6b on the production mesh (fake tensors, on the host);
    (c) its prefill, serve and train steps at full width and depth in
    bf16 on the card at world-of-one cuts of those shapes, each beside
    its own world-of-one count and roofline bound; (d) the prefill and
    serve steps with the kernels against the same steps on the plain
    attention.  Returns the kernels line's rows at the new shapes."""
    from repro_torch.configs import archs
    from repro_torch.configs.shapes import SHAPES, InputShape
    from repro_torch.core import profiler
    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import attention as attn
    from repro_torch.models import cache as cache_mod
    from repro_torch.models import transformer as T
    from repro_torch.optim import adam
    t_phase = time.monotonic()
    tag = "[25 roofline]"
    cfg = archs.get(ARCH)
    V = cfg.vocab_size
    bf16 = torch.bfloat16

    # (a) the local microbench (core.profiler.profile_local) on the card
    prof = profiler.profile_local()
    print(f"{tag} (a) profile_local() on the card: {prof['tflops']:.2f} "
          f"TFLOP/s (fp32 1024^2 matmuls, TF32 off), "
          f"{prof['hbm_gbps']:.1f} GB/s (64 MB copy-scale) | card {card}",
          flush=True)
    check(prof["tflops"] > 0 and prof["hbm_gbps"] > 0,
          "profile_local gave a non-positive rate")

    # (b) the dry-run counts on the single-pod fake mesh (256 ranks)
    for name in COUNT_SHAPES25:
        t0 = time.monotonic()
        rec = dryrun.dryrun_one(ARCH, name, False, verbose=False)
        dt = time.monotonic() - t0
        check(not torch.distributed.is_initialized(),
              "dryrun_one left a process group initialized")
        check(rec["n_devices"] == 256 and rec["flops_per_device"] > 0
              and rec["bytes_per_device"] > 0, f"dry-run {name}: {rec}")
        print(f"{tag} (b) dryrun_one({ARCH}, {name}, single pod): "
              f"{json.dumps(dryrun.public(rec))} ({dt:.1f}s on the host)",
              flush=True)
        print(f"{tag} (b) {roofline.HEADER}", flush=True)
        print(f"{tag} (b) {roofline.row(rec)}", flush=True)

    # (c) the steps on the card, each beside its world-of-one count
    params = T.init_params(cfg, seed=0, device=dev)
    g = torch.Generator(device=dev).manual_seed(25)
    tokens = lambda B, S: torch.randint(0, V, (B, S), generator=g,
                                        device=dev)
    measured, counted = {}, {}

    def first_call(fn):
        """The step's first call, with the launch counts zeroed just
        before it and read just after, and the peak reset: (launches,
        memory held before it)."""
        free(torch)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        _zero_counts(fa, dec)
        fn()
        torch.cuda.synchronize()
        return (fa.launches, dec.launches), base

    def run(label, phase, B, S, fn, cut_note, first=None,
            iters=STEP_ITERS, warmup=STEP_WARMUP):
        """Time ``fn`` (its first call, made here or given as ``first``,
        is the first of the ``warmup`` calls) beside its count."""
        launches, base = first or first_call(fn)
        ms = step_ms(torch, fn, iters=iters, warmup=warmup - 1)
        top = torch.cuda.max_memory_allocated(dev)
        peak = top - base
        t0 = time.monotonic()
        rec = dryrun.count_step(cfg, InputShape(label, S, B, phase))
        count_s = time.monotonic() - t0
        counted[label] = rec
        print(f"{tag} (c) {label} step [{B}, {S}]: the count's peak "
              f"{gib(rec['peak_bytes_per_device']):.2f} GiB "
              f"({rec['peak_counted']}; arguments "
              f"{gib(rec['argument_size_in_bytes']):.2f}, temp "
              f"{gib(rec['temp_size_in_bytes']):.2f}, outputs "
              f"{gib(rec['output_size_in_bytes']):.2f} of which aliased "
              f"{gib(rec['alias_size_in_bytes']):.2f}; the plain path) "
              f"beside torch.cuda.max_memory_allocated {gib(top):.2f} GiB "
              f"on the kernel path ({gib(base):.2f} held before it); "
              f"above the arguments: counted "
              f"{gib(rec['peak_bytes_per_device'] - rec['argument_size_in_bytes']):.2f}"
              f", measured above what was held {gib(peak):.2f} | card "
              f"{card}", flush=True)
        t = roofline.roofline_terms(rec)
        b_ops, b_bytes = t["compute_s"] * 1e3, t["memory_s"] * 1e3
        mfu = t["model_flops"] / (ms[0] * 1e-3 * roofline.peak_flops(rec))
        n_d = 6 if phase == "train" else 2
        note = ("the step's own path, its bytes an upper bound"
                if phase == "train" else "the kernel path does less work, "
                "so this is no bound on it")
        print(f"{tag} (c) {label} step [{B}, {S}] ({cut_note}): "
              f"{spread(ms)} over {iters} calls after {warmup} "
              f"(the first counting the launches), "
              f"peak {gib(peak):.2f} GiB above the {gib(base):.2f} GiB "
              f"held before it, launches per step flash {launches[0]} "
              f"decode {launches[1]} | model FLOPs ({n_d} N D) "
              f"{t['model_flops']:.4e}, MFU "
              f"{mfu:.4f} at 989 TFLOP/s | the plain path's count (world "
              f"of one, {count_s:.1f}s: full S^2 QK^T and PV, every aten "
              f"op's bytes unfused; {note}): "
              f"{rec['flops_per_device']:.4e} FLOP, "
              f"{rec['bytes_per_device']:.4e} B, {b_ops:.3f} ms at 989 "
              f"TFLOP/s, {b_bytes:.3f} ms at 3.35 TB/s; their max / "
              f"measured {max(b_ops, b_bytes) / ms[0]:.4f} | card {card}",
              flush=True)
        measured[label] = launches
        return launches

    # prefill [4, 4096]
    Bp, Sp = PREFILL25
    pbatch = {"tokens": tokens(Bp, Sp)}
    prefill = steps_mod.make_prefill_step(cfg, max_cache_len=Sp)
    launches = run("prefill", "prefill", Bp, Sp,
                   lambda: prefill(params, pbatch),
                   f"cut from prefill_32k [32, 32768]: its logits alone "
                   f"would be {32 * 32768 * V * 2 / 1e9:.0f} GB in bf16")
    check(launches == (cfg.n_layers, 0), f"prefill step launches "
          f"{launches}, expected ({cfg.n_layers}, 0)")

    # train: the largest batch that fits at S 4096 (remat, as the count,
    # fp32 Adam)
    opt_cfg = adam.AdamConfig()
    opt = adam.init_adam_state(params, opt_cfg)
    train = steps_mod.make_train_step(cfg, opt_cfg, remat=True)
    for Bt in TRAIN25_BATCHES:
        tb = {"tokens": tokens(Bt, TRAIN25_SEQ),
              "labels": tokens(Bt, TRAIN25_SEQ),
              "loss_mask": torch.ones((Bt, TRAIN25_SEQ), dtype=bf16,
                                      device=dev)}
        out = []
        try:
            first = first_call(lambda: out.append(train(params, opt, tb)))
            break
        except torch.cuda.OutOfMemoryError:
            pass        # the traceback's tensors go when the block ends
        print(f"{tag} (c) train batch {Bt} x {TRAIN25_SEQ} does not fit",
              flush=True)
        del tb, out
        free(torch)
    check(math.isfinite(float(out[0][2]["loss"])),
          "train step: non-finite loss")
    del out
    launches = run("train", "train", Bt, TRAIN25_SEQ,
                   lambda: train(params, opt, tb),
                   f"cut from train_4k [256, 4096]: the largest batch "
                   f"of {TRAIN25_BATCHES} that fits", first=first,
                   iters=TRAIN25_ITERS, warmup=1)
    check(launches == (0, 0), f"train step launched {launches}")
    # the train step runs the plain attention either way: its peak is
    # the count's (the arguments held in both)
    top = torch.cuda.max_memory_allocated(dev)
    want = counted["train"]["peak_bytes_per_device"]
    check(abs(want - top) <= PEAK25_TOL * top,
          f"train step: counted peak {gib(want):.2f} GiB against "
          f"{gib(top):.2f} measured")
    del opt, tb
    free(torch)

    # serve: batch 32, a full cache of 8192 positions
    Bd, L = DECODE25
    cache = cache_mod.init_cache(cfg, Bd, L, dtype=bf16, device=dev)
    for leaf in cache["blocks"]["layer0"].values():
        leaf.normal_(generator=g)
    cache["pos"] = L - 1
    dbatch = {"tokens": tokens(Bd, 1), "cache": cache}
    serve = steps_mod.make_serve_step(cfg)
    full_kv = cfg.n_layers * 2 * 128 * 32768 * cfg.n_kv_heads \
        * cfg.resolved_head_dim * 2
    launches = run("serve", "decode", Bd, L,
                   lambda: serve(params, dbatch),
                   f"cut from decode_32k [128, 32768]: its KV cache would "
                   f"be {full_kv / 1e9:.0f} GB in bf16")
    check(launches == (0, cfg.n_layers), f"serve step launches "
          f"{launches}, expected (0, {cfg.n_layers})")

    # (d) the kernel path against the plain attention.  In bf16 the gap
    # grows with depth for any fused attention, torch's sdpa as much as
    # the kernels (bf16 probabilities in the PV product; the plain path
    # runs fp32 inside): at all 28 layers each step is held to
    # DEPTH25_TOL, at its first 2 layers to 2e-2, and in fp32 at its
    # first 4 layers to 2e-4; sdpa's gap in the plain attention's place
    # is printed beside it
    def run_as(impl, fn):
        attn.set_attention_impl(impl)
        try:
            return fn()
        finally:
            attn.set_attention_impl("kernel")

    def sdpa_run(fn):
        keep = attn.plain_attention, attn.chunked_attention
        attn.plain_attention = attn.chunked_attention = sdpa_attention
        try:
            return run_as("plain", fn)
        finally:
            attn.plain_attention, attn.chunked_attention = keep

    plain_peak = {}

    def gaps(step, p_, batch, name=None):
        fn = lambda: step(p_, batch)[0]     # noqa: E731
        k_ = fn()
        free(torch)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        p_out = run_as("plain", fn)
        if name is not None:
            plain_peak[name] = (torch.cuda.max_memory_allocated(dev), base)
        check(bool(torch.isfinite(k_.float()).all())
              and bool(torch.isfinite(p_out.float()).all()),
              "non-finite logits")
        return rel_err(k_, p_out, 0), p_out, fn

    cut2 = first_layers(cfg, 2)
    p2 = T.init_params(cut2, seed=0, device=dev)
    err = {}
    for name, step, p_, batch in (
            ("prefill", prefill, params, pbatch),
            ("serve", serve, params, dbatch),
            ("prefill, first 2 layers", steps_mod.make_prefill_step(
                cut2, max_cache_len=Sp), p2, pbatch),
            ("serve, first 2 layers", steps_mod.make_serve_step(cut2), p2,
             {"tokens": dbatch["tokens"], "cache": {
                 "blocks": {"layer0": {n: t[:2] for n, t in
                                       cache["blocks"]["layer0"].items()}},
                 "pos": L - 1}})):
        e, p_out, fn = gaps(step, p_, batch, name)
        err[name] = e
        if "first" not in name:
            err[name + " (sdpa)"] = rel_err(sdpa_run(fn), p_out, 0)
    cut4 = dataclasses.replace(first_layers(cfg, 4), dtype="float32")
    p4 = T.init_params(cut4, seed=0, device=dev)
    err["prefill fp32, first 4 layers"] = gaps(
        steps_mod.make_prefill_step(cut4, max_cache_len=Sp), p4, pbatch)[0]
    print(f"{tag} (d) the kernel steps against the plain attention, "
          f"|a - b| / (1 + |b|) of the logits: "
          + ", ".join(f"{k} {v:.4g}" for k, v in err.items())
          + f" (bf16 all layers: {DEPTH25_TOL} and {SDPA25_RATIO} x "
          f"sdpa's; first 2 layers: 2e-2; fp32: 2e-4) | card {card}",
          flush=True)
    for name in ("prefill", "serve"):
        top, held = plain_peak[name]
        rec = counted[name]
        print(f"{tag} (d) {name} step on the plain attention (28 layers, "
              f"bf16): torch.cuda.max_memory_allocated {gib(top):.2f} GiB "
              f"({gib(held):.2f} held before it) beside the count's peak "
              f"{gib(rec['peak_bytes_per_device']):.2f} GiB (arguments "
              f"{gib(rec['argument_size_in_bytes']):.2f}); above the "
              f"arguments: counted "
              f"{gib(rec['peak_bytes_per_device'] - rec['argument_size_in_bytes']):.2f}"
              f", measured above what was held {gib(top - held):.2f} | card "
              f"{card}", flush=True)
        sdpa_gap = err[name + " (sdpa)"]
        check(err[name] <= DEPTH25_TOL
              and err[name] <= SDPA25_RATIO * sdpa_gap,
              f"{name} step: the kernels are {err[name]:.4g} from plain "
              f"(limits {DEPTH25_TOL} and {SDPA25_RATIO} x sdpa's "
              f"{sdpa_gap:.4g})")
        check(err[name + ", first 2 layers"] <= 2e-2,
              f"{name} step, first 2 layers: {err[name + ', first 2 layers']}"
              f" from plain")
    check(err["prefill fp32, first 4 layers"] <= 2e-4,
          "the fp32 prefill step disagrees with the plain attention")
    del params, p2, p4, cache, dbatch, pbatch
    free(torch)

    # the kernels line's rows at these shapes
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    rows = {
        "flash_attention/qwen3_prefill_4096": dict(
            name="flash_attention/qwen3_prefill_4096", route="cuda",
            source="src/repro_torch/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention/kernel.py:26",
            launches=measured["prefill"][0],
            **attn_row(torch, F, fa, flush, Bp, Sp, H, KV, hd, bf16, True,
                       card, f"{ARCH} prefill step [{Bp}, {Sp}]", tag)),
        "decode_attention/qwen3_decode_8192": dict(
            name="decode_attention/qwen3_decode_8192", route="cuda",
            source="src/repro_torch/csrc/decode_attention.cu",
            replaces="src/repro/kernels/decode_attention/kernel.py:21",
            launches=measured["serve"][1],
            **decode_row(torch, F, dec, flush, Bd, L, H, KV, hd, card,
                         f"{ARCH} serve step, cache {L}", tag, dtype=bf16)),
    }
    del flush
    free(torch)
    print(f"{tag} {time.monotonic() - t_phase:.1f}s | card {card}",
          flush=True)
    return rows


# ---------------------------------------------------------------------------
# phase 26: MoE models and heads that ``model`` does not divide, on ranks
# ---------------------------------------------------------------------------

# 8 requests, wave 4, prompt 32, 8 new tokens, fp32, greedy
SERVE26 = dict(requests=8, wave=4, prompt=32, new=8)
MODES26 = {"one-shot": {}, "chunked 16": {"prefill_chunk": 16}}
# name -> (arch, first layers, mesh shape, modes, why this cut)
RUNS26 = {
    "granite": ("granite-moe-3b-a800m", 8, (2, 2), ("one-shot", "chunked 16"),
                "40 experts over model 2: expert parallel"),
    "mixtral": ("mixtral-8x7b", 1, (2, 2), ("one-shot",),
                "8 experts: tensor parallel on the experts' FFN"),
    "phi3": ("phi3-medium-14b", 2, (1, 4), ("one-shot",),
             "model 4 divides the 40 query heads, not the 10 KV heads"),
}
# the scans on DTensors at per-rank shapes of a 2x2 mesh: phase 3's
# batch and prompt (16 x 256) over data 2; rwkv6-3b's 40 heads and
# Jamba's d_inner 16384 over model 2
SCAN26 = dict(B=16, S=256)


def serve26_run(torch, device, name, mesh=None):
    """``RUNS26[name]``'s cut through ``genserve.generate`` (on ``mesh``
    when given) in each of its modes: rollout, wall seconds and the two
    attention kernels' launches inside the call."""
    import numpy as np
    from repro_torch.configs import archs
    from repro_torch.genserve import adapter
    from repro_torch.kernels.decode_attention import ops as dec
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models import transformer as T
    from repro_torch.rl.rollout import SamplerConfig
    arch, layers, _, modes, _ = RUNS26[name]
    cfg = dataclasses.replace(first_layers(archs.get(arch), layers),
                              dtype="float32")
    t = SERVE26
    prompts = torch.as_tensor(np.random.default_rng(26).integers(
        0, cfg.vocab_size, (t["requests"], t["prompt"])), device=device)
    params = T.init_params(cfg, seed=0, device=device)
    out = {}
    for mode in modes:
        _zero_counts(fa, dec)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        ro, _ = adapter.generate(
            params, cfg, prompts, None,
            SamplerConfig(max_new_tokens=t["new"], greedy=True),
            wave=t["wave"], fast_path=False, device=device, mesh=mesh,
            **MODES26[mode])
        torch.cuda.synchronize()
        out[mode] = dict(
            rollout={k: ro[k].cpu() for k in ("gen_tokens", "mask",
                                              "logprobs")},
            wall=time.monotonic() - t0, flash=fa.launches,
            decode=dec.launches)
    del params
    return out


def scans26(torch, device, mesh):
    """``rwkv6_scan`` and ``mamba_scan`` on DTensors (rows over ``data``,
    heads or channels over ``model``: each rank launches the kernel on
    its shard) against their plain versions on the full inputs, every
    rank's alike: {kernel: (allclose ratio, max abs err, the local
    input shape, launches)}."""
    import torch.nn.functional as F
    from repro_torch.configs import archs
    from repro_torch.kernels.mamba_scan import ops as mb
    from repro_torch.kernels.rwkv6_scan import ops as rw
    from repro_torch.parallel import sharding as sh
    g = torch.Generator(device=device).manual_seed(26)
    n = lambda *shape: torch.randn(shape, generator=g, device=device)
    B, S = SCAN26["B"], SCAN26["S"]
    rc, jc = archs.get(RWKV_ARCH), archs.get(JAMBA_ARCH)
    H, N = rc.rwkv_n_heads, rc.rwkv_head_dim
    heads, chan = sh.P("data", None, "model", None), sh.P("data", None,
                                                          "model")
    out = {}
    r, k, v = n(B, S, H, N), n(B, S, H, N), n(B, S, H, N)
    logw = -torch.exp(n(B, S, H, N) * 0.5 - 1.0)
    u = n(H, N) * 0.5
    _zero_counts(rw)
    got = rw.rwkv6_scan(*(sh.distribute(x, mesh, heads)
                          for x in (r, k, v, logw)), u)
    want = rw.rwkv6_scan_plain(r, k, v, logw, u)
    full = [x.full_tensor() for x in got]
    out["rwkv6_scan"] = (
        max(rel_err(a, b, 2e-3) for a, b in zip(full, want)),
        max(max_err(a, b) for a, b in zip(full, want)),
        list(got[0].to_local().shape), rw.launches)
    del r, k, v, logw, got, want, full
    di, ds = jc.mamba_d_inner, jc.mamba_d_state
    dt, x = F.softplus(n(B, S, di) - 1), n(B, S, di)
    Bm, Cm, A = n(B, S, ds), n(B, S, ds), -torch.exp(n(di, ds) * 0.3)
    _zero_counts(mb)
    got = mb.mamba_scan(sh.distribute(dt, mesh, chan),
                        sh.distribute(x, mesh, chan), Bm, Cm, A)
    want = mb.mamba_scan_plain(dt, x, Bm, Cm, A)
    full = [y.full_tensor() for y in got]
    out["mamba_scan"] = (
        max(rel_err(a, b, 1e-3) for a, b in zip(full, want)),
        max(max_err(a, b) for a, b in zip(full, want)),
        list(got[0].to_local().shape), mb.launches)
    return out


def serve26_rank(device):
    """One of 4 ranks sharing the card: each ``RUNS26`` cut through
    ``serve26_run`` on a ("data", "model") mesh of its shape over the 4
    ranks, then both attention kernels as that mesh calls them at the
    engine's per-rank shapes against their plain versions; the rank's
    peak memory per cut; then ``scans26`` on the 2x2 mesh."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.configs import archs
    from repro_torch.launch import sharded_exec as sx
    from repro_torch.parallel import dist
    from repro_torch.parallel import sharding as sh
    torch.backends.cuda.matmul.allow_tf32 = False
    meshes = {shape: DeviceMesh(device.type,
                                torch.arange(4).reshape(shape),
                                mesh_dim_names=sh.AXES)
              for shape in {r[2] for r in RUNS26.values()}}
    out = {"rank": dist.rank(), "runs": {}}
    t = SERVE26
    for name, (arch, _, shape, _, _) in RUNS26.items():
        free(torch)
        torch.cuda.reset_peak_memory_stats(device)
        modes = serve26_run(torch, device, name, meshes[shape])
        c = archs.get(arch)
        kern = sx.mesh_attention(
            meshes[shape], device, "float32", c.n_heads, c.n_kv_heads,
            c.resolved_head_dim, t["wave"], t["prompt"],
            t["prompt"] + t["new"])
        out["runs"][name] = dict(
            modes=modes, kernels=kern,
            peak_gib=torch.cuda.max_memory_allocated(device) / 2**30)
    free(torch)
    out["scans"] = scans26(torch, device, meshes[(2, 2)])
    return out


def mesh_phase26(torch, dev, card):
    """MoE models and heads that ``model`` does not divide, served on
    ranks sharing the card.  Each cut is full width, cut only in depth,
    fp32, greedy, seeded weights, through ``genserve.generate(mesh=)`` on
    4 ranks (gloo) against the world of one on the card, token for
    token: granite-moe-3b-a800m's first 8 layers on a 2x2 mesh (expert
    parallel: 40 experts over ``model``), one-shot and ``prefill_chunk``
    16; mixtral-8x7b's first layer on a 2x2 mesh (8 experts: tensor
    parallel on the experts' FFN), one-shot; phi3-medium-14b's first 2
    layers on a 1x4 mesh (``model`` 4 does not divide the 10 KV heads:
    the heads stay whole and the rows split over ``model``), one-shot.
    Both attention kernels launch on every rank, and hold within 2e-4 of
    plain at the engine's per-rank shapes; ``rwkv6_scan`` and
    ``mamba_scan`` on DTensors at rwkv6-3b's and Jamba's per-rank shapes
    on a 2x2 mesh hold within phase 3's tolerances.  Then every per-rank
    shape timed in this process (kernel, plain, sdpa, bound).  Returns
    the kernels line's rows at the per-rank attention shapes."""
    import torch.nn.functional as F
    from repro_torch.configs import archs
    from repro_torch.kernels.decode_attention import ops as dec
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.mamba_scan import ops as mb
    from repro_torch.kernels.rwkv6_scan import ops as rw
    from repro_torch.parallel import dist
    t_phase = time.monotonic()
    tag = "[26 mesh]"
    t = SERVE26
    one = {}
    for name in RUNS26:
        one[name] = serve26_run(torch, dev, name)
        free(torch)
    t0 = time.monotonic()
    res = dist.spawn(serve26_rank, 4, "cuda", timeout=600)
    wall = time.monotonic() - t0
    want_local = {}
    for name, (arch, layers, shape, modes, why) in RUNS26.items():
        c = archs.get(arch)
        H, KV, hd = c.n_heads, c.n_kv_heads, c.resolved_head_dim
        data, model = shape
        even = math.gcd(H, KV) % model == 0
        rows = t["wave"] // (data if even else data * model)
        heads = H // model if even else H
        want_local[name] = (rows, heads, KV // model if even else KV)
        want = {"prefill": [rows, t["prompt"], heads, hd],
                "decode": [rows, heads, hd]}
        for mode in modes:
            w1 = one[name][mode]
            lp = 0.0
            for r in res:
                m = r["runs"][name]["modes"][mode]
                same, d = _same_rollout(m["rollout"], w1["rollout"])
                lp = max(lp, d)
                check(same, f"{name} {mode}: rank {r['rank']}'s tokens "
                            f"differ from the world of one's")
                check(d <= 1e-3, f"{name} {mode}: rank {r['rank']} "
                                 f"log-probs {d:.3g} from the world of one's")
                check(m["decode"] > 0, f"{name} {mode}: rank {r['rank']} "
                                       f"launched no decode_attention")
                if "prefill_chunk" not in MODES26[mode]:
                    check(m["flash"] > 0, f"{name} {mode}: rank "
                                          f"{r['rank']} launched no "
                                          f"flash_attention")
            m0 = res[0]["runs"][name]["modes"][mode]
            print(f"{tag} {name} {mode}: {arch} first {layers} layers at "
                  f"full width (d {c.d_model}, {H}:{KV} heads of {hd}, "
                  f"{c.n_experts} experts top-{c.top_k}, vocab "
                  f"{c.vocab_size}; {why}), fp32, {t['requests']} requests"
                  f", wave {t['wave']}, prompt {t['prompt']}, {t['new']} "
                  f"new, on a {data}x{model} mesh of 4 ranks sharing "
                  f"cuda:0: tokens and masks identical to the world of one "
                  f"on every rank, log-prob diff {lp:.3g}; launches per "
                  f"rank (flash, decode) "
                  f"{[(r['runs'][name]['modes'][mode]['flash'], r['runs'][name]['modes'][mode]['decode']) for r in res]}"
                  f"; {m0['wall']:.2f} s on the mesh (rank 0) against "
                  f"{w1['wall']:.2f} s for the world of one | card {card}",
                  flush=True)
        for r in res:
            for label, (err, local) in r["runs"][name]["kernels"].items():
                check(local == want[label] and err <= tol(torch.float32,
                                                          torch),
                      f"{name} rank {r['rank']} {label}: local q {local} "
                      f"(the engine's {want[label]}), kernel vs plain "
                      f"{err:.3g}")
        print(f"{tag} {name}: kernels on DTensors at the engine's per-rank "
              f"shapes vs plain, fp32: prefill {want['prefill']} "
              f"{max(r['runs'][name]['kernels']['prefill'][0] for r in res):.3g}"
              f", decode {want['decode']} over a {t['prompt'] + t['new']}"
              f"-slot cache "
              f"{max(r['runs'][name]['kernels']['decode'][0] for r in res):.3g}"
              f" (tol 2e-4); peak GiB per rank "
              f"{[round(r['runs'][name]['peak_gib'], 2) for r in res]}",
              flush=True)
    rc, jc = archs.get(RWKV_ARCH), archs.get(JAMBA_ARCH)
    B, S = SCAN26["B"], SCAN26["S"]
    scan_local = {"rwkv6_scan": [B // 2, S, rc.rwkv_n_heads // 2,
                                 rc.rwkv_head_dim],
                  "mamba_scan": [B // 2, S, jc.mamba_d_inner // 2]}
    scan_tol = {"rwkv6_scan": 2e-3, "mamba_scan": 1e-3}
    for kname, want in scan_local.items():
        for r in res:
            ratio, err, local, n = r["scans"][kname]
            check(local == want and ratio <= scan_tol[kname] and n == 1,
                  f"{kname} on DTensors, rank {r['rank']}: local {local} "
                  f"(want {want}), allclose ratio {ratio:.3g} (tol "
                  f"{scan_tol[kname]}), launches {n}")
        print(f"{tag} {kname} on DTensors (2x2 mesh, rows over data, "
              f"{'heads' if kname == 'rwkv6_scan' else 'channels'} over "
              f"model) vs plain on the full inputs: local {want} on every "
              f"rank, one launch each, allclose ratio "
              f"{max(r['scans'][kname][0] for r in res):.3g} (tol "
              f"{scan_tol[kname]}), max abs err "
              f"{max(r['scans'][kname][1] for r in res):.3g}", flush=True)
    print(f"{tag} 4 ranks: {wall:.0f}s with the ranks' start", flush=True)
    # -- every per-rank shape timed in this process -----------------------
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    ktag = "[26 kernels]"
    rows = {}
    for name, (arch, _, shape, modes, _) in RUNS26.items():
        c = archs.get(arch)
        nr, hl, kl = want_local[name]
        hd = c.resolved_head_dim
        launches = [(r["runs"][name]["modes"]["one-shot"]["flash"],
                     r["runs"][name]["modes"]["one-shot"]["decode"])
                    for r in res]
        base = dict(route="cuda")
        rows[f"flash_attention/{name}_mesh_per_rank"] = dict(
            name=f"flash_attention/{name}_mesh_per_rank",
            source="src/repro_torch/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention/kernel.py:26",
            launches=launches[0][0], **base,
            **attn_row(torch, F, fa, flush, nr, t["prompt"], hl, kl, hd,
                       torch.float32, True, card,
                       f"{name} one-shot, per rank", ktag))
        rows[f"decode_attention/{name}_mesh_per_rank"] = dict(
            name=f"decode_attention/{name}_mesh_per_rank",
            source="src/repro_torch/csrc/decode_attention.cu",
            replaces="src/repro/kernels/decode_attention/kernel.py:21",
            launches=launches[0][1], **base,
            **decode_row(torch, F, dec, flush, nr, t["prompt"] + t["new"],
                         hl, kl, hd, card, f"{name} one-shot, per rank",
                         ktag))
    g = torch.Generator(device=dev).manual_seed(26)
    n = lambda *shape: torch.randn(shape, generator=g, device=dev)
    bl, _, rh, rn = scan_local["rwkv6_scan"]
    ins = (n(bl, S, rh, rn), n(bl, S, rh, rn), n(bl, S, rh, rn),
           -torch.exp(n(bl, S, rh, rn) * 0.5 - 1.0), n(rh, rn) * 0.5)
    ms = time_ms(lambda: rw.rwkv6_scan(*ins), torch, flush)
    plain = time_ms(lambda: rw.rwkv6_scan_plain(*ins), torch, flush,
                    iters=5, warmup=1)
    nbytes, flops, exps = rwkv_work(bl, S, rh, rn, 64)
    b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    b_ops = (flops + exps) / PEAK_FLOPS["torch.float32"] * 1e3
    print(f"{ktag} rwkv6_scan (rwkv6-3b on a 2x2 mesh, per rank) "
          f"r{tuple(ins[0].shape)} fp32 chunk 64: kernel {spread(ms)}, plain "
          f"(per-token recurrence) {spread(plain)}, no library call, bound "
          f"{max(b_bytes, b_ops):.4f} ms ({nbytes / 1e6:.1f} MB = "
          f"{b_bytes:.4f} ms; {(flops + exps) / 1e9:.2f} G operations = "
          f"{b_ops:.4f} ms at 67 TFLOP/s fp32) | card {card}", flush=True)
    del ins
    bl, _, di = scan_local["mamba_scan"]
    ds = jc.mamba_d_state
    ins = (F.softplus(n(bl, S, di) - 1), n(bl, S, di), n(bl, S, ds),
           n(bl, S, ds), -torch.exp(n(di, ds) * 0.3))
    ms = time_ms(lambda: mb.mamba_scan(*ins), torch, flush)
    plain = time_ms(lambda: mb.mamba_scan_plain(*ins), torch, flush,
                    iters=5, warmup=1)
    nbytes, ops = mamba_work(bl, S, di, ds)
    b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    b_ops = ops / PEAK_FLOPS["torch.float32"] * 1e3
    print(f"{ktag} mamba_scan (Jamba on a 2x2 mesh, per rank) "
          f"x{tuple(ins[1].shape)} ds {ds} fp32: kernel {spread(ms)}, plain "
          f"(per-token recurrence) {spread(plain)}, no library call, bound "
          f"{max(b_bytes, b_ops):.4f} ms ({nbytes / 1e6:.1f} MB = "
          f"{b_bytes:.4f} ms; {ops / 1e9:.2f} G operations = {b_ops:.4f} "
          f"ms) | card {card}", flush=True)
    del ins, flush
    free(torch)
    print(f"[26 mesh] {time.monotonic() - t_phase:.1f}s | card {card}",
          flush=True)
    return rows


# ---------------------------------------------------------------------------
# phase 27: the example scripts on the card
# ---------------------------------------------------------------------------

# serve_batched's runs: extra flags -> the kernels its path launches
# (chunked admission runs the prefill attention and the scans plain, as
# the JAX package does; the rwkv6 smoke has no attention layer)
SERVE27 = (((), ("flash_attention", "decode_attention")),
           (("--prefill-chunk", "16"), ("decode_attention",)),
           (("--arch", RWKV_ARCH), ("rwkv6_scan",)),
           (("--arch", JAMBA_ARCH),
            ("flash_attention", "decode_attention", "mamba_scan")))


def rl_shapes(rows: int, wave: int, cfg, prompt: int, new: int):
    """The attention shapes of one GRPO iteration of ``cfg`` over
    ``rows`` rollouts decoded in waves of ``wave``: GEN's prefill of one
    wave, GEN's decode step of it over prompt + new cache slots, INF's
    forward over every rollout."""
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    return {"gen_prefill": (wave, prompt, H, KV, hd),
            "gen_decode": (wave, prompt + new, H, KV, hd),
            "inf": (rows, prompt + new, H, KV, hd)}


def examples_phase27(torch, F, fa, dec, rw, mb, attn, flush, card, e2e_cfg,
                     e2e_launches):
    """The examples on the card (``repro_torch.examples``):
    ``serve_batched`` four ways, each against the same run on the plain
    attention (tokens identical; the kernels of its path launched, the
    plain run none); ``trace_obs`` (head dim 16: both attention kernels
    in GEN, flash in INF, none in TRAIN; its Chrome trace valid);
    ``train_rl_elastic --require-switch``; then both attention kernels
    against plain and timed at the e2e actor's (phase 11) and trace_obs's
    shapes.  Returns those kernel rows."""
    from repro_torch.data.synthetic import AdditionTask
    from repro_torch.examples import (serve_batched, trace_obs,
                                      train_rl_elastic)
    from repro_torch.obs import trace as obs_trace
    from repro_torch.rl.trainer import RLTrainer
    mods = {"flash_attention": fa, "decode_attention": dec,
            "rwkv6_scan": rw, "mamba_scan": mb}
    tag = "[27 examples]"
    for extra, want in SERVE27:
        argv = list(extra)
        runs = {}
        try:
            for impl in ("kernel", "plain"):
                attn.set_attention_impl(impl)
                _zero_counts(*mods.values())
                t0 = time.monotonic()
                out = serve_batched.main(argv)
                torch.cuda.synchronize()
                runs[impl] = (out, {k: m.launches for k, m in mods.items()},
                              time.monotonic() - t0)
        finally:
            attn.set_attention_impl("kernel")
        (ko, kn, kt), (po, pn, pt) = runs["kernel"], runs["plain"]
        same = torch.equal(ko["rollout"]["sequences"],
                           po["rollout"]["sequences"])
        print(f"{tag} python -m repro_torch.examples.serve_batched "
              f"{' '.join(argv)}: {ko['cfg'].name}, tokens identical to the "
              f"plain attention's={same}; launches {kn} (plain run {pn}); "
              f"{kt:.1f}s (plain {pt:.1f}s) | card {card}", flush=True)
        check(same, f"serve_batched {argv}: kernel and plain tokens differ")
        check(all(kn[k] > 0 for k in want),
              f"serve_batched {argv} did not launch {want}: {kn}")
        check(not any(pn.values()), f"the plain run launched {pn}")

    hook = StageLaunches(fa, dec)
    restore = hook.install(RLTrainer)
    try:
        t0 = time.monotonic()
        print(f"{tag} python -m repro_torch.examples.trace_obs", flush=True)
        out = trace_obs.main([])
        torch.cuda.synchronize()
        obs_launches = [hook.by_kind(i) for i in range(len(hook.iters))]
        trace_errors = obs_trace.validate_file(out["trace"])
        obs_wall = time.monotonic() - t0
        obs_cfg = out["trainer"].cfg
        print(f"{tag} trace_obs (head dim {obs_cfg.resolved_head_dim}): "
              f"rewards {out['rewards']}; launches per iteration (flash, "
              f"decode) by stage {obs_launches}; trace {out['trace']} "
              f"errors {trace_errors}; {obs_wall:.1f}s | card {card}",
              flush=True)
        check(all(math.isfinite(r) and 0.0 <= r <= 1.0
                  for r in out["rewards"]), f"trace_obs rewards "
              f"{out['rewards']}")
        check(not trace_errors and not out["trace_errors"],
              f"trace_obs's trace is invalid: {trace_errors}")
        check(len(obs_launches) == 4 and all(
            lk["GEN"][0] > 0 and lk["GEN"][1] > 0 and lk["INF"][0] > 0
            and lk["TRAIN"] == (0, 0) for lk in obs_launches),
            f"trace_obs launches {obs_launches}")
        obs_run = {"flash_attention/obs_gen_prefill": sum(
                       lk["GEN"][0] for lk in obs_launches),
                   "flash_attention/obs_inf": sum(
                       lk["INF"][0] for lk in obs_launches),
                   "decode_attention/obs_gen_decode": sum(
                       lk["GEN"][1] for lk in obs_launches)}
        del out

        hook.iters.clear()
        t0 = time.monotonic()
        print(f"{tag} python -m repro_torch.examples.train_rl_elastic "
              f"--require-switch", flush=True)
        try:
            out = train_rl_elastic.main(["--require-switch"])
        except SystemExit as e:
            fail(f"train_rl_elastic --require-switch exited {e.code}")
        torch.cuda.synchronize()
        el_launches = [hook.by_kind(i) for i in range(len(hook.iters))]
        swaps = out["controller"].swaps
        print(f"{tag} train_rl_elastic: {len(swaps)} applied swap(s) at "
              f"iteration(s) {[r.iteration for r in swaps]}, weight "
              f"versions {out['wv_trace']}, epochs "
              + "; ".join(f"{r['epoch']}: {r['iterations']} iters "
                          f"measured {r['measured_iter_s'] * 1e3:.1f} ms/iter"
                          f" predicted {r['predicted_iter_s'] * 1e3:.3f}"
                          for r in out["epoch_report"])
              + f"; {time.monotonic() - t0:.1f}s | card {card}", flush=True)
        check(len(swaps) >= 1, "train_rl_elastic applied no swap")
        check(all(lk["TRAIN"] == (0, 0) and lk["GEN"][0] > 0
                  and lk["GEN"][1] > 0 for lk in el_launches),
              f"train_rl_elastic launches {el_launches}")
        del out
    finally:
        restore()
        obs_trace.disable()
        obs_trace.reset()

    # the kernels at the two actors' shapes: e2e (16 prompts x 8 rollouts,
    # waves of 32) and trace_obs (2 prompts x 2 rollouts, one wave of 4)
    task = AdditionTask(max_operand=9)
    P, N = task.prompt_len, task.max_answer_len
    rows = {}
    for who, cfg, shapes, launches in (
            ("e2e", e2e_cfg, rl_shapes(128, 32, e2e_cfg, P, N),
             e2e_launches),
            ("obs", obs_cfg, rl_shapes(4, 4, obs_cfg, P, N), obs_run)):
        for part, (B, S, H, KV, hd) in shapes.items():
            kname = "decode_attention" if part == "gen_decode" \
                else "flash_attention"
            key = f"{kname}/{who}_{part}"
            label = f"{who} actor, {part}, hd {hd}"
            if kname == "flash_attention":
                row = attn_row(torch, F, fa, flush, B, S, H, KV, hd,
                               torch.float32, True, card, label, tag=tag,
                               device_time=False)
            else:
                row = decode_row(torch, F, dec, flush, B, S, H, KV, hd,
                                 card, label, tag)
            rows[key] = dict(
                name=key, route="cuda",
                source=f"src/repro_torch/csrc/{kname}.cu",
                replaces=("src/repro/kernels/flash_attention/kernel.py:26"
                          if kname == "flash_attention" else
                          "src/repro/kernels/decode_attention/kernel.py:21"),
                launches=launches[key], **row)
    return rows


SWEEP28 = (8, 24, 40, 72, 112, 136, 160, 192, 200, 256)   # head dims
# rows that are no multiple of 16 bytes, which decode copies element by
# element (fp32 above 128: two vectors a lane) and flash pads in bf16
ODD28 = {"float32": (7, 130, 255), "bfloat16": (12, 201)}
HIDDEN28_TOL = 1e-2  # |kernel - plain| / |plain| of Gemma's final hidden
DECODE28 = ((64, 16, 8, 300), (4, 4, 2, 300), (1, 8, 1, 2000))  # B H KV L


def gemma9b_widths(cfg):
    """Gemma 2 9B's widths (arXiv:2408.00118, Table 1: d_model 3584, 16
    heads over 8 KV heads of 256, GeGLU 14336, window 4096, softcaps 50
    and 30) on the zoo's gemma2-27b family, cut to 4 layers (two
    local/global pairs); its queries are scaled by 1/sqrt(256), the head
    size, as the model's 1/sqrt(hd) scales them."""
    return dataclasses.replace(cfg, name="gemma2-9b-widths", d_model=3584,
                               n_heads=16, n_kv_heads=8, head_dim=256,
                               d_ff=14336, n_layers=4)


def sizes_phase28(torch, F, dev, fa, dec, rw, mb, attn, flush, card):
    """Every head dim to 256, RWKV6 head size to 128 and Mamba state size
    to 32: (b) both attention kernels at SWEEP28 and ODD28, both dtypes,
    against plain (flash causal, windowed, softcapped; decode over one
    split and many), the padded launches counted; (c) the scans at sizes
    between their instantiated ones; (a) Gemma 2 9B's widths served
    through genserve in bf16 with the kernels and with the plain
    attention, tokens identical, the launches per layer per admit and
    step, none padded; then the prefill's final hidden states, kernel
    against plain within HIDDEN28_TOL, where two wrong flash attentions
    (the scale of hd 128, Q.K's last 64-column panel dropped) must land
    beyond it; (d) both kernels timed at Gemma's shapes, decode also at
    the served wave's.  Returns the kernels line's three rows."""
    from repro_torch.configs import archs
    from repro_torch.genserve import adapter
    from repro_torch.models import transformer as T
    from repro_torch.rl.rollout import SamplerConfig
    tag = "[28 sizes]"
    t_phase = time.monotonic()
    g = torch.Generator(device=dev).manual_seed(28)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    # (b) attention at every head-dim class
    for dtype in (torch.float32, torch.bfloat16):
        hds = SWEEP28 + ODD28[str(dtype).replace("torch.", "")]
        for hd in hds:
            pads = int(fa.read_width(hd, dtype) != hd)
            errs = []
            for i, (B, S, H, KV, window, cap) in enumerate((
                    (2, 150, 4, 2, None, None), (2, 150, 4, 2, 48, None),
                    (1, 77, 4, 1, None, 50.0))):
                q, k, v = (randn(B, S, n, hd, dtype=dtype)
                           for n in (H, KV, KV))
                fa.launches_padded = 0
                out = fa.flash_attention(q, k, v, window=window, cap=cap)
                ref = fa.flash_attention_plain(q, k, v, window=window,
                                               cap=cap)
                torch.cuda.synchronize()
                check(fa.launches_padded == pads, f"flash hd {hd} {dtype}: "
                      f"padded launches {fa.launches_padded}, want {pads}")
                check(out.shape == q.shape and bool(
                    torch.isfinite(out).all()), f"flash hd {hd} {dtype}")
                errs.append(max_err(out, ref))
            for B, H, KV, L in DECODE28:
                q = randn(B, H, hd, dtype=dtype)
                k, v = (randn(B, L, KV, hd, dtype=dtype) for _ in range(2))
                keep = torch.rand((B, L), generator=g, device=dev) < 0.75
                keep[:, 0] = True
                bias = torch.where(keep, 0.0, -1e30).float()
                cap = 30.0 if L == 300 else None
                out = dec.decode_attention(q, k, v, bias, cap=cap)
                ref = dec.decode_attention_plain(q, k, v, bias, cap=cap)
                torch.cuda.synchronize()
                check(bool(torch.isfinite(out).all()),
                      f"decode hd {hd} {dtype}")
                errs.append(max_err(out, ref))
            name = str(dtype).replace("torch.", "")
            splits = [dec.plan(*shape[:3], shape[3], hd, sms).splits
                      for shape in DECODE28]
            print(f"{tag} hd {hd} {name}: flash causal / windowed / capped "
                  f"max abs err {errs[0]:.3g} / {errs[1]:.3g} / "
                  f"{errs[2]:.3g}, padded launches {pads} a call; decode "
                  f"over {' / '.join(map(str, splits))} splits "
                  f"{errs[3]:.3g} / {errs[4]:.3g} / {errs[5]:.3g} (tol "
                  f"{tol(dtype, torch):g})", flush=True)
            check(max(errs) <= tol(dtype, torch),
                  f"hd {hd} {name}: max abs err {max(errs)} over tol")

    # (c) the scans between their instantiated sizes
    for N in (16, 48, 96):
        r, k, v = (randn(2, 100, 3, N) for _ in range(3))
        logw = -torch.exp(randn(2, 100, 3, N) * 0.5 - 1.0)
        u = randn(3, N) * 0.5
        rw.launches_padded = 0
        y, st = rw.rwkv6_scan(r, k, v, logw, u)
        yr, sr = rw.rwkv6_scan_plain(r, k, v, logw, u)
        torch.cuda.synchronize()
        err = max(rel_err(y, yr, 2e-3), rel_err(st, sr, 2e-3))
        print(f"{tag} rwkv6_scan N {N} (on the kernel's "
              f"{rw.head_size_width(N)}): allclose ratio {err / 2e-3:.3g} "
              f"(2e-3), padded launches {rw.launches_padded}", flush=True)
        check(err <= 2e-3 and rw.launches_padded == 1,
              f"rwkv6_scan N {N}: err {err}, padded {rw.launches_padded}")
    for ds in (4, 12, 24, 32):
        dt = F.softplus(randn(2, 100, 200) - 1)
        x, Bm, Cm = randn(2, 100, 200), randn(2, 100, ds), randn(2, 100, ds)
        A = -torch.exp(randn(200, ds) * 0.3)
        mb.launches_padded = 0
        y, h = mb.mamba_scan(dt, x, Bm, Cm, A)
        yr, hr = mb.mamba_scan_plain(dt, x, Bm, Cm, A)
        torch.cuda.synchronize()
        err = max(rel_err(y, yr, 1e-3), rel_err(h, hr, 1e-3))
        want = int(ds not in mb.STATE_DIMS)
        print(f"{tag} mamba_scan ds {ds} (on the kernel's "
              f"{mb.state_width(ds)}): allclose ratio {err / 1e-3:.3g} "
              f"(1e-3), padded launches {mb.launches_padded}", flush=True)
        check(err <= 1e-3 and mb.launches_padded == want,
              f"mamba_scan ds {ds}: err {err}, padded {mb.launches_padded}")

    # (a) Gemma 2 9B's widths served, kernels against plain attention
    cfg = gemma9b_widths(archs.get("gemma2-27b"))
    params = T.init_params(cfg, seed=0, device=dev, dtype=torch.bfloat16)
    n_req, wave, prompt, new = 6, 4, 256, 12
    prompts = torch.randint(0, cfg.vocab_size, (n_req, prompt),
                            generator=torch.Generator().manual_seed(28))
    sampler = SamplerConfig(max_new_tokens=new, greedy=True)
    runs = {}
    try:
        for impl in ("kernel", "plain"):
            attn.set_attention_impl(impl)
            _zero_counts(fa, dec)
            t0 = time.monotonic()
            ro, st = adapter.generate(params, cfg, prompts, None, sampler,
                                      wave=wave, decode_chunk=4,
                                      fast_path=False, device=dev)
            torch.cuda.synchronize()
            runs[impl] = (ro, st, (fa.launches, dec.launches,
                                   fa.launches_padded, fa.launches_tc),
                          time.monotonic() - t0)
    finally:
        attn.set_attention_impl("kernel")
    (rk, sk, nk, tk), (rp, sp, npl, tp) = runs["kernel"], runs["plain"]
    same, lp_err = _same_rollout(rk, rp)
    L = cfg.n_layers
    want = (L * sk["prefills"], L * sk["decode_steps"], 0, L * sk["prefills"])
    print(f"{tag} {cfg.name} (d {cfg.d_model}, {cfg.n_heads}:"
          f"{cfg.n_kv_heads} heads of {cfg.resolved_head_dim}, GeGLU "
          f"{cfg.d_ff}, window {cfg.pattern[0].window}, softcaps "
          f"{cfg.attn_softcap} / {cfg.final_softcap}, vocab "
          f"{cfg.vocab_size}, first {L} layers: "
          f"{cfg.param_count() / 1e9:.2f} B parameters) bf16, {n_req} "
          f"requests, wave {wave}, prompt {prompt}, {new} new, greedy: "
          f"tokens identical to the plain attention's={same}, log-prob max "
          f"diff {lp_err:.3g}; launches (flash, decode, flash padded, "
          f"flash on the tensor cores) {nk}, expected {want} ({L} layers x "
          f"{sk['prefills']} admits, x {sk['decode_steps']} decode steps); "
          f"plain run {npl}; {tk:.1f}s (plain {tp:.1f}s) | card {card}",
          flush=True)
    check(same, f"{cfg.name}: kernel and plain tokens differ")
    check(nk == want, f"{cfg.name} launches {nk}, expected {want}")
    check(npl[:3] == (0, 0, 0), f"the plain run launched {npl}")
    check(sk["occupancy_trace"] == sp["occupancy_trace"],
          f"{cfg.name}: the runs disagree on the occupancy trace")
    del runs, rk, rp

    # the greedy picks of seeded weights have probabilities near 1, so
    # equal tokens would not tell a wrong attention apart: the prefill's
    # final hidden states would
    from repro_torch.kernels import ops as kops
    toks = {"tokens": prompts[:wave].to(dev)}
    real = kops._flash

    def hidden(impl):
        with torch.no_grad():
            return T.forward(params, cfg, toks,
                             attn_impl=impl)["hidden"].float()

    def scaled_128(q, k, v, **kw):       # 1/sqrt(128) for 1/sqrt(256)
        return real(q * 2 ** 0.5, k, v, **kw)

    def panel_dropped(q, k, v, **kw):    # Q.K over the first 192 columns
        q = q.clone()
        q[..., 192:] = 0
        return real(q, k, v, **kw)

    ref_h = hidden("plain")
    gaps = {}
    try:
        for name, fn in (("kernel", real), ("scale of hd 128", scaled_128),
                         ("last panel dropped", panel_dropped)):
            kops._flash = fn
            h = hidden("kernel")
            gaps[name] = (float((h - ref_h).norm() / ref_h.norm()),
                          max_err(h, ref_h))
    finally:
        kops._flash = real
    print(f"{tag} {cfg.name} prefill [{wave}, {prompt}], final hidden "
          f"states against plain attention, |a - b| / |b| (max abs err): "
          + ", ".join(f"{n} {r:.3g} ({m:.3g})" for n, (r, m) in gaps.items())
          + f"; bound {HIDDEN28_TOL:g}, the kernel within, the two wrong "
          f"attentions beyond | card {card}", flush=True)
    check(gaps["kernel"][0] <= HIDDEN28_TOL,
          f"{cfg.name}: hidden states {gaps['kernel'][0]} from plain")
    check(all(r > HIDDEN28_TOL for n, (r, _) in gaps.items()
              if n != "kernel"), f"{cfg.name}: a wrong attention within "
          f"the bound: {gaps}")
    del params, ref_h
    free(torch)

    # (d) both kernels at Gemma's serving shapes
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    rows = {
        "flash_attention/gemma2_9b_prefill": dict(
            name="flash_attention/gemma2_9b_prefill", route="cuda",
            source="src/repro_torch/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention/kernel.py:26",
            launches=nk[0],
            **attn_row(torch, F, fa, flush, 4, 256, H, KV, hd,
                       torch.bfloat16, True, card,
                       f"{cfg.name} prefill, hd {hd}", tag=tag,
                       device_time=False)),
        "decode_attention/gemma2_9b_decode": dict(
            name="decode_attention/gemma2_9b_decode", route="cuda",
            source="src/repro_torch/csrc/decode_attention.cu",
            replaces="src/repro/kernels/decode_attention/kernel.py:21",
            launches=nk[1],
            **decode_row(torch, F, dec, flush, 16, 320, H, KV, hd, card,
                         f"{cfg.name} decode, hd {hd}", tag,
                         dtype=torch.bfloat16)),
        "decode_attention/gemma2_9b_served": dict(
            name="decode_attention/gemma2_9b_served", route="cuda",
            source="src/repro_torch/csrc/decode_attention.cu",
            replaces="src/repro/kernels/decode_attention/kernel.py:21",
            launches=nk[1],
            **decode_row(torch, F, dec, flush, wave, prompt + new, H, KV,
                         hd, card, f"{cfg.name} served wave's last step, "
                         f"hd {hd}", tag, dtype=torch.bfloat16)),
    }
    print(f"{tag} {time.monotonic() - t_phase:.1f}s | card {card}",
          flush=True)
    return rows


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a "
             "CUDA card")
    os.chdir(ROOT)       # the launcher's checkpoints: results/elastic_ckpt
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import torch.nn.functional as F

    from repro_torch.configs import archs
    from repro_torch.genserve import adapter
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention import ops as dec
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.mamba_scan import ops as mb
    from repro_torch.kernels.rwkv6_scan import ops as rw
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import attention as attn
    from repro_torch.models import cache as cache_mod
    from repro_torch.models import transformer as T
    from repro_torch.rl.rollout import SamplerConfig

    t_all = time.monotonic()
    laps = []

    def lap(phase: str) -> None:
        """Print the seconds since the previous phase ended."""
        now = time.monotonic()
        laps.append((phase, now - (t_all + sum(t for _, t in laps))))
        print(f"[time] phase {phase}: {laps[-1][1]:.1f}s", flush=True)
    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"[1 card] {card} | torch: {kind} x{count} | torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)

    t0 = time.monotonic()
    secs = build.build()
    print(f"[2 build] {len(build.SOURCES)} sources -> {build.BUILD_DIR} in "
          f"{time.monotonic() - t0:.1f}s "
          f"({', '.join(f'{k} {v:.1f}s' for k, v in secs.items()) or 'cached'})",
          flush=True)
    for name in build.SOURCES:
        for line in build.resources(name):
            print(f"[2 build] ptxas {name}: {line}", flush=True)

    lap("1-2")
    # ---- 3. kernels vs plain versions -----------------------------------
    g = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)  # 256 MB

    def randn(*shape, dtype):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    bf16 = torch.bfloat16
    cfg = archs.get(ARCH)
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    W, P, N = 16, 256, 64
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    results = {}

    jcfg = archs.get(JAMBA_ARCH)

    def flash_case(H_, KV_, label):
        """flash_attention at one admission wave's prefill shape, causal,
        bf16: error, times and bound."""
        q, k, v = (randn(W, P, n, hd, dtype=bf16) for n in (H_, KV_, KV_))
        out = fa.flash_attention(q, k, v, causal=True)
        ref = fa.flash_attention_plain(q, k, v, causal=True)
        torch.cuda.synchronize()
        err = max_err(out, ref)
        check(bool(torch.isfinite(out).all()) and err <= tol(bf16, torch),
              f"flash_attention {label} shape: max abs err {err}")
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        ms = time_ms(lambda: fa.flash_attention(q, k, v, causal=True), torch,
                     flush)
        dev_ms = device_ms(lambda: fa.flash_attention(q, k, v, causal=True),
                           torch, flush, "flash_tc")
        plain = time_ms(lambda: fa.flash_attention_plain(q, k, v,
                                                         causal=True),
                        torch, flush)
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), torch, flush)
        nbytes = sum(x.numel() * x.element_size() for x in (q, k, v, out))
        flops = 4.0 * W * H_ * hd * (P * (P + 1) // 2)  # unmasked pairs
        b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        b_ops = flops / PEAK_FLOPS[str(bf16)] * 1e3
        print(f"[3 kernels] flash_attention ({label}) q{tuple(q.shape)} "
              f"k{tuple(k.shape)} bf16 causal, tensor cores: err {err:.3g} "
              f"(tol 2e-2) | kernel {spread(ms)}, device {spread(dev_ms)}, "
              f"plain {plain[0]:.4f} ms, "
              f"sdpa {spread(lib)}, kernel/sdpa {ms[0] / lib[0]:.2f}, bound "
              f"{max(b_bytes, b_ops):.4f} ms ({nbytes / 1e6:.1f} MB, "
              f"{flops / 1e9:.2f} GFLOP)", flush=True)
        return dict(max_abs_err=err, ms=ms[0], plain_ms=plain[0],
                    bound_ms=max(b_bytes, b_ops),
                    bound_by="bytes" if b_bytes >= b_ops else "operations",
                    library_ms=lib[0])

    def decode_case(H_, KV_, label):
        """decode_attention at the serving decode shape: W slots, cache
        L = P + N, bias from real per-slot positions of a full (non-ring)
        cache, bf16: error, times and bound."""
        L = P + N
        pos = torch.randint(P, L, (W,), generator=g, device=dev)
        q = randn(W, H_, hd, dtype=bf16)
        k, v = (randn(W, L, KV_, hd, dtype=bf16) for _ in range(2))
        k_pos, valid = cache_mod.ring_slot_positions(L, None, pos)
        bias = attn.decode_bias(pos[:, None], k_pos, causal=True,
                                window=None, k_valid=valid,
                                batch=W).contiguous()
        out = dec.decode_attention(q, k, v, bias)
        ref = dec.decode_attention_plain(q, k, v, bias)
        torch.cuda.synchronize()
        err = max_err(out, ref)
        check(bool(torch.isfinite(out).all()) and err <= tol(bf16, torch),
              f"decode_attention {label} shape: max abs err {err}")
        q4, k4, v4 = q[:, :, None], k.transpose(1, 2).contiguous(), \
            v.transpose(1, 2).contiguous()
        mask4 = bias.to(bf16)[:, None, None, :]
        ms = time_ms(lambda: dec.decode_attention(q, k, v, bias), torch,
                     flush)
        dev_ms = device_ms(lambda: dec.decode_attention(q, k, v, bias),
                           torch, flush, "decode_kernel")
        plain = time_ms(lambda: dec.decode_attention_plain(q, k, v, bias),
                        torch, flush)
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=mask4, enable_gqa=True), torch, flush)
        n_valid = int((bias == 0).sum())              # K/V rows needed
        row_bytes = KV_ * hd * k.element_size()
        nbytes = (q.numel() * q.element_size()
                  + out.numel() * out.element_size() + bias.numel() * 4
                  + 2 * n_valid * row_bytes)
        flops = 4.0 * H_ * hd * n_valid
        b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        b_ops = flops / PEAK_FLOPS[str(bf16)] * 1e3
        pl = dec.plan(W, H_, KV_, L, hd, sms)
        print(f"[3 kernels] decode_attention ({label}) q{tuple(q.shape)} "
              f"k{tuple(k.shape)} bf16, {n_valid} valid rows, one launch of "
              f"{W * KV_ * pl.head_groups * pl.splits} blocks ({pl.splits} "
              f"splits of {pl.chunk} keys): err {err:.3g} (tol 2e-2) | "
              f"kernel {spread(ms)}, device {spread(dev_ms)}, plain "
              f"{plain[0]:.4f} ms, sdpa "
              f"{spread(lib)}, kernel/sdpa {ms[0] / lib[0]:.2f}, bound "
              f"{max(b_bytes, b_ops):.4f} ms ({nbytes / 1e6:.1f} MB)",
              flush=True)
        return dict(max_abs_err=err, ms=ms[0], plain_ms=plain[0],
                    bound_ms=max(b_bytes, b_ops),
                    bound_by="bytes" if b_bytes >= b_ops else "operations",
                    library_ms=lib[0])

    results["flash_attention"] = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:26",
        **flash_case(H, KV, ARCH))
    results["decode_attention"] = dict(
        name="decode_attention", route="cuda",
        source="src/repro_torch/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention/kernel.py:21",
        **decode_case(H, KV, ARCH))
    flash_case(jcfg.n_heads, jcfg.n_kv_heads, JAMBA_ARCH)
    decode_case(jcfg.n_heads, jcfg.n_kv_heads, JAMBA_ARCH)
    # pixtral-12b's serving shapes (phase 20; hd 128 as qwen3's)
    pxcfg = archs.get(PIXTRAL_ARCH)
    check(pxcfg.resolved_head_dim == hd, "pixtral's head dim is not 128")
    for key, case in (("flash_attention/pixtral_prefill", flash_case),
                      ("decode_attention/pixtral_decode", decode_case)):
        kname = key.split("/")[0]
        results[key] = dict(
            name=key, route="cuda", source=results[kname]["source"],
            replaces=results[kname]["replaces"],
            **case(pxcfg.n_heads, pxcfg.n_kv_heads, PIXTRAL_ARCH))

    # small matrix: GQA/MQA, hd 64/80/128, window, caps, ragged S / L
    n_cases = 0
    for dtype in (torch.float32, bf16):
        for B, S, h_, kv_, d_, causal, window, cap in [
                (2, 300, 4, 2, 64, True, None, None),
                (1, 100, 4, 1, 128, True, 64, None),
                (2, 200, 4, 2, 80, True, None, 50.0),
                (1, 77, 8, 8, 128, False, None, None),
                (1, 130, 4, 2, 64, True, 64, 30.0),
                (2, 1000, 16, 16, 80, False, None, None),    # hubert
                (4, 70, 2, 2, 16, True, None, None),         # trace_obs
                (3, 130, 4, 2, 16, True, 64, None)]:         # hd 16
            q, k, v = (randn(B, S, n, d_, dtype=dtype) for n in (h_, kv_, kv_))
            out = fa.flash_attention(q, k, v, causal=causal, window=window,
                                     cap=cap)
            ref = fa.flash_attention_plain(q, k, v, causal=causal,
                                           window=window, cap=cap)
            err = max_err(out, ref)
            check(err <= tol(dtype, torch),
                  f"flash_attention B{B} S{S} H{h_}:{kv_} hd{d_} causal="
                  f"{causal} window={window} cap={cap} {dtype}: err {err}")
            n_cases += 1
        for B, h_, kv_, d_, L_, cap, window in [
                (2, 4, 2, 64, 300, None, None),
                (1, 4, 1, 80, 200, 30.0, None),
                (3, 8, 2, 128, 1000, 50.0, None),
                (4, 4, 4, 64, 77, None, None),
                (2, 4, 2, 128, 64, 30.0, 64),
                (4, 2, 2, 16, 8, None, None),                # trace_obs
                (3, 4, 2, 16, 300, None, 64)]:
            q = randn(B, h_, d_, dtype=dtype)
            k, v = (randn(B, L_, kv_, d_, dtype=dtype) for _ in range(2))
            p_ = torch.randint(0, 3 * L_, (B,), generator=g, device=dev)
            kp, ok = cache_mod.ring_slot_positions(L_, window, p_)
            bias = attn.decode_bias(p_[:, None], kp, causal=True,
                                    window=window, k_valid=ok,
                                    batch=B).contiguous()
            out = dec.decode_attention(q, k, v, bias, cap=cap)
            ref = dec.decode_attention_plain(q, k, v, bias, cap=cap)
            err = max_err(out, ref)
            check(err <= tol(dtype, torch),
                  f"decode_attention B{B} H{h_}:{kv_} hd{d_} L{L_} cap={cap} "
                  f"window={window} {dtype}: err {err}")
            n_cases += 1
    torch.cuda.synchronize()
    print(f"[3 kernels] small matrix: {n_cases} cases agree with the plain "
          f"versions (fp32 2e-4, bf16 2e-2)", flush=True)

    # fp32 attention at the RL path's shapes (qwen3-0.6b's heads; 16 prompts
    # x 4 rollouts = 64 rows, prompt 5 + 3 new tokens, decode wave 32)
    f32 = torch.float32

    def fp32_flash_case(B_, S_):
        q, k, v = (randn(B_, S_, n, hd, dtype=f32) for n in (H, KV, KV))
        out = fa.flash_attention(q, k, v, causal=True)
        ref = fa.flash_attention_plain(q, k, v, causal=True)
        torch.cuda.synchronize()
        err = max_err(out, ref)
        check(bool(torch.isfinite(out).all()) and err <= tol(f32, torch),
              f"flash_attention fp32 {tuple(q.shape)}: max abs err {err}")
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        ms = time_ms(lambda: fa.flash_attention(q, k, v, causal=True), torch,
                     flush)
        plain = time_ms(lambda: fa.flash_attention_plain(q, k, v,
                                                         causal=True),
                        torch, flush)
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), torch, flush)
        nbytes = sum(x.numel() * x.element_size() for x in (q, k, v, out))
        flops = 4.0 * B_ * H * hd * (S_ * (S_ + 1) // 2)
        return q, err, ms, plain, lib, nbytes, flops

    def fp32_decode_case(B_, L_, P_):
        pos = torch.randint(P_, L_, (B_,), generator=g, device=dev)
        q = randn(B_, H, hd, dtype=f32)
        k, v = (randn(B_, L_, KV, hd, dtype=f32) for _ in range(2))
        k_pos, valid = cache_mod.ring_slot_positions(L_, None, pos)
        bias = attn.decode_bias(pos[:, None], k_pos, causal=True,
                                window=None, k_valid=valid,
                                batch=B_).contiguous()
        out = dec.decode_attention(q, k, v, bias)
        ref = dec.decode_attention_plain(q, k, v, bias)
        torch.cuda.synchronize()
        err = max_err(out, ref)
        check(bool(torch.isfinite(out).all()) and err <= tol(f32, torch),
              f"decode_attention fp32 {tuple(k.shape)}: max abs err {err}")
        q4, k4, v4 = q[:, :, None], k.transpose(1, 2).contiguous(), \
            v.transpose(1, 2).contiguous()
        mask4 = bias[:, None, None, :]
        ms = time_ms(lambda: dec.decode_attention(q, k, v, bias), torch,
                     flush)
        plain = time_ms(lambda: dec.decode_attention_plain(q, k, v, bias),
                        torch, flush)
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=mask4, enable_gqa=True), torch, flush)
        n_valid = int((bias == 0).sum())
        nbytes = (q.numel() * 4 + out.numel() * 4 + bias.numel() * 4
                  + 2 * n_valid * KV * hd * 4)
        flops = 4.0 * H * hd * n_valid
        return k, err, ms, plain, lib, nbytes, flops

    RL_ROWS, RL_PROMPT, RL_NEW = 64, 5, 3
    RL_WAVE = 32
    rl_cases = {
        "flash_attention/rl_gen_prefill": (
            "flash_attention", "GEN prefill of one admission wave",
            fp32_flash_case(RL_WAVE, RL_PROMPT)),
        "flash_attention/rl_inf": (
            "flash_attention", "INF forward over the rollouts",
            fp32_flash_case(RL_ROWS, RL_PROMPT + RL_NEW)),
        "decode_attention/rl_gen_decode": (
            "decode_attention", "GEN decode step of one wave",
            fp32_decode_case(RL_WAVE, RL_PROMPT + RL_NEW, RL_PROMPT)),
    }
    for key, (kname, what, (x, err, ms, plain, lib, nbytes, flops)) in \
            rl_cases.items():
        b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        b_ops = flops / PEAK_FLOPS[str(f32)] * 1e3
        print(f"[3 kernels] {kname} at the RL path's {what} shape "
              f"{tuple(x.shape)} fp32 (CUDA cores): err {err:.3g} (tol "
              f"2e-4) | kernel {spread(ms)}, plain {spread(plain)}, sdpa "
              f"{spread(lib)}, bound {max(b_bytes, b_ops):.5f} ms "
              f"({nbytes / 1e6:.3f} MB, {flops / 1e6:.2f} MFLOP) | card "
              f"{card}", flush=True)
        results[key] = dict(
            name=key, route="cuda", source=results[kname]["source"],
            replaces=results[kname]["replaces"], max_abs_err=err, ms=ms[0],
            plain_ms=plain[0], bound_ms=max(b_bytes, b_ops),
            bound_by="bytes" if b_bytes >= b_ops else "operations",
            library_ms=lib[0])

    # RWKV6 scan at the serving path's prefill shape (one admission wave of
    # rwkv6-3b), with tests/test_kernels.py's input distribution
    rcfg = archs.get(RWKV_ARCH)
    RH, RN = rcfg.rwkv_n_heads, rcfg.rwkv_head_dim

    def rwkv_inputs(B, S, H, N, decay_shift=-1.0):
        r, k, v = (torch.randn((B, S, H, N), generator=g, device=dev)
                   for _ in range(3))
        logw = -torch.exp(torch.randn((B, S, H, N), generator=g, device=dev)
                          * 0.5 + decay_shift)
        return r, k, v, logw, torch.randn((H, N), generator=g,
                                          device=dev) * 0.5

    ins = rwkv_inputs(W, P, RH, RN)
    y, st = rw.rwkv6_scan(*ins)
    yr, sr = rw.rwkv6_scan_plain(*ins)
    torch.cuda.synchronize()
    err = max(max_err(y, yr), max_err(st, sr))
    rerr = max(rel_err(y, yr, 2e-3), rel_err(st, sr, 2e-3))
    check(bool(torch.isfinite(y).all()) and rerr <= 2e-3,
          f"rwkv6_scan main-path shape: max abs err {err}, allclose "
          f"ratio {rerr}")
    ms = time_ms(lambda: rw.rwkv6_scan(*ins), torch, flush)
    dev_ms = device_ms(lambda: rw.rwkv6_scan(*ins), torch, flush,
                       "rwkv6_chunked")
    plain_ms = time_ms(lambda: rw.rwkv6_scan_plain(*ins), torch, flush,
                       iters=5, warmup=1)[0]
    nbytes, flops, exps = rwkv_work(W, P, RH, RN, 64)
    b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    b_ops = (flops + exps) / PEAK_FLOPS["torch.float32"] * 1e3
    results["rwkv6_scan"] = dict(
        name="rwkv6_scan", route="cuda",
        source="src/repro_torch/csrc/rwkv6_scan.cu",
        replaces="src/repro/kernels/rwkv6_scan/kernel.py:21",
        max_abs_err=err, ms=ms[0], plain_ms=plain_ms,
        bound_ms=max(b_bytes, b_ops),
        bound_by="bytes" if b_bytes >= b_ops else "operations",
        library_ms=None)
    print(f"[3 kernels] rwkv6_scan r{tuple(ins[0].shape)} fp32 chunk 64: err "
          f"{err:.3g} (allclose 2e-3 ratio {rerr:.3g}) | kernel {spread(ms)}, "
          f"device {spread(dev_ms)}, plain (per-token recurrence) "
          f"{plain_ms:.4f} ms, no library call, bound {max(b_bytes, b_ops):.4f} ms ({nbytes / 1e6:.1f} MB "
          f"= {b_bytes:.4f} ms; {flops / 1e9:.2f} GFLOP + {exps / 1e9:.3f} G "
          f"exp = {b_ops:.4f} ms at 67 TFLOP/s fp32)", flush=True)
    mhz = sm_clock_mhz(lambda: rw.rwkv6_scan(*ins), torch)
    print(exp_floor_line("rwkv6_scan", exps, ms[0], mhz, sms), flush=True)

    n_cases = 0
    for N_ in (32, 64, 128):
        for S_ in (1, 63, 65, 100, 256):
            for B_ in (1, 3):
                ins = rwkv_inputs(B_, S_, 2, N_)
                y, st = rw.rwkv6_scan(*ins)
                yr, sr = rw.rwkv6_scan_plain(*ins)
                rerr = max(rel_err(y, yr, 2e-3), rel_err(st, sr, 2e-3))
                check(rerr <= 2e-3, f"rwkv6_scan B{B_} S{S_} N{N_}: "
                      f"allclose ratio {rerr}")
                n_cases += 1
    for chunk in rw.CHUNKS:              # strong decay: logw about -20
        for S_ in (150, 77):
            ins = rwkv_inputs(2, S_, 3, 64, decay_shift=3.0)
            y, st = rw.rwkv6_scan(*ins, chunk=chunk)
            yr, sr = rw.rwkv6_scan_plain(*ins)
            rerr = max(rel_err(y, yr, 2e-3), rel_err(st, sr, 2e-3))
            check(bool(torch.isfinite(y).all()) and rerr <= 2e-3,
                  f"rwkv6_scan strong decay chunk {chunk} S{S_}: allclose "
                  f"ratio {rerr}")
            n_cases += 1
    torch.cuda.synchronize()
    print(f"[3 kernels] rwkv6_scan small matrix: {n_cases} cases agree with "
          f"the per-token recurrence (2e-3)", flush=True)

    # Mamba selective scan at the serving path's prefill shape (one
    # admission wave of jamba's d_inner), with tests/test_kernels.py's
    # input distribution
    DI, DS = jcfg.mamba_d_inner, jcfg.mamba_d_state

    def mamba_inputs(B, S, di, ds):
        n = lambda *shape: torch.randn(shape, generator=g, device=dev)
        return (F.softplus(n(B, S, di) - 1), n(B, S, di), n(B, S, ds),
                n(B, S, ds), -torch.exp(n(di, ds) * 0.3))

    ins = mamba_inputs(W, P, DI, DS)
    y, h = mb.mamba_scan(*ins)
    yr, hr = mb.mamba_scan_plain(*ins)
    torch.cuda.synchronize()
    err = max(max_err(y, yr), max_err(h, hr))
    rerr = max(rel_err(y, yr, 1e-3), rel_err(h, hr, 1e-3))
    check(bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
          and rerr <= 1e-3, f"mamba_scan main-path shape: max abs err "
          f"{err}, allclose ratio {rerr}")
    ms = time_ms(lambda: mb.mamba_scan(*ins), torch, flush)
    dev_ms = device_ms(lambda: mb.mamba_scan(*ins), torch, flush,
                       "mamba_scan_fwd")
    plain_ms = time_ms(lambda: mb.mamba_scan_plain(*ins), torch, flush,
                       iters=5, warmup=1)[0]
    nbytes, ops = mamba_work(W, P, DI, DS)
    b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    b_ops = ops / PEAK_FLOPS["torch.float32"] * 1e3
    results["mamba_scan"] = dict(
        name="mamba_scan", route="cuda",
        source="src/repro_torch/csrc/mamba_scan.cu",
        replaces="src/repro/kernels/mamba_scan/kernel.py:23",
        max_abs_err=err, ms=ms[0], plain_ms=plain_ms,
        bound_ms=max(b_bytes, b_ops),
        bound_by="bytes" if b_bytes >= b_ops else "operations",
        library_ms=None)
    print(f"[3 kernels] mamba_scan dt/x{tuple(ins[1].shape)} Bm/Cm"
          f"{tuple(ins[2].shape)} fp32: err {err:.3g} (allclose 1e-3 ratio "
          f"{rerr:.3g}) | kernel {spread(ms)}, device {spread(dev_ms)}, plain "
          f"(per-token recurrence) "
          f"{plain_ms:.4f} ms, no library call, bound "
          f"{max(b_bytes, b_ops):.4f} ms ({nbytes / 1e6:.1f} MB = "
          f"{b_bytes:.4f} ms; {ops / 1e9:.2f} G fp32 operations = "
          f"{b_ops:.4f} ms at 67 TFLOP/s) | card {card}", flush=True)
    mhz = sm_clock_mhz(lambda: mb.mamba_scan(*ins), torch)
    print(exp_floor_line("mamba_scan", W * P * DI * DS, ms[0], mhz, sms),
          flush=True)
    del ins, y, h, yr, hr

    n_cases = 0
    matrix = [(2, 64, 128, 16), (1, 100, 512, 16), (2, 32, 64, 8),
              (1, 48, 320, 16)]                     # tests/test_kernels.py
    matrix += [(2, S_, 200, ds_) for S_ in (1, 63, 65) for ds_ in (8, 16)]
    matrix += [(2, 2048, 256, 16),                  # long: the ex2 precision
               (2, 100, 256, 16, 10.0), (2, 100, 198, 16, 10.0)]  # underflow
    for B_, S_, di_, ds_, *scale in matrix:
        ins = mamba_inputs(B_, S_, di_, ds_)
        if scale:                       # dt * A down to -30 and below
            ins = (ins[0] * scale[0] + 1.0, *ins[1:4], ins[4] * scale[0])
            check(float((ins[0][..., None] * ins[4]).min()) <= -30.0,
                  "the underflow case does not reach dt * A <= -30")
        y, h = mb.mamba_scan(*ins)
        yr, hr = mb.mamba_scan_plain(*ins)
        rerr = max(rel_err(y, yr, 1e-3), rel_err(h, hr, 1e-3))
        check(bool(torch.isfinite(y).all()) and rerr <= 1e-3,
              f"mamba_scan B{B_} S{S_} di{di_} ds{ds_} scale {scale}: "
              f"allclose ratio {rerr}")
        n_cases += 1
    torch.cuda.synchronize()
    print(f"[3 kernels] mamba_scan small matrix: {n_cases} cases agree with "
          f"the per-token recurrence (1e-3)", flush=True)

    lap("3")
    # ---- 4. whole-path parity, fp32, full width -------------------------
    params = T.init_params(cfg, seed=0, device=dev, dtype=torch.float32)
    prompts = torch.randint(0, cfg.vocab_size, (12, 64),
                            generator=torch.Generator().manual_seed(0))
    sampler = SamplerConfig(max_new_tokens=16, greedy=True)
    runs = {}
    for impl in ("kernel", "plain"):
        attn.set_attention_impl(impl)
        fa.launches = fa.launches_tc = dec.launches = 0
        ro, st = adapter.generate(params, cfg, prompts, None, sampler,
                                  wave=8, decode_chunk=4, fast_path=False,
                                  device=dev)
        torch.cuda.synchronize()
        runs[impl] = (ro, st, fa.launches, dec.launches)
        n_tc = fa.launches_tc if impl == "kernel" else n_tc
    attn.set_attention_impl("kernel")
    (rk, sk, nf, nd), (rp, sp, pf, pd) = runs["kernel"], runs["plain"]
    check(nf > 0 and nd > 0, f"fp32 kernel run launched flash {nf}, "
          f"decode {nd} times")
    check(n_tc == 0, "fp32 flash launches took the tensor cores")
    check(pf == 0 and pd == 0, "the plain run launched a kernel")
    same_tok = torch.equal(rk["gen_tokens"], rp["gen_tokens"])
    same_mask = torch.equal(rk["mask"], rp["mask"])
    lp_err = max_err(rk["logprobs"], rp["logprobs"])
    print(f"[4 parity] {ARCH} fp32 full width ({cfg.n_layers} layers, d "
          f"{cfg.d_model}), 12 requests, wave 8, prompt 64, 16 new: tokens "
          f"identical={same_tok} masks identical={same_mask} logprob max "
          f"diff {lp_err:.3g} (tol 1e-3); kernel run launched flash {nf}, "
          f"decode {nd}; prefills {sk['prefills']}, decode rounds "
          f"{sk['decode_steps']}", flush=True)
    check(same_tok and same_mask and lp_err <= 1e-3,
          "fp32 kernel and plain serving runs disagree")
    check(sk["occupancy_trace"] == sp["occupancy_trace"],
          "fp32 runs disagree on the occupancy trace")
    del params, runs, rk, rp
    torch.cuda.empty_cache()

    lap("4")
    # ---- 5. the serving path, bf16, full width ---------------------------
    argv = ["--arch", ARCH, "--batch", "48", "--wave", str(W),
            "--prompt-len", str(P), "--new-tokens", str(N),
            "--decode-chunk", "4", "--seed", "0"]
    fa.launches = fa.launches_tc = dec.launches = 0
    rep = serve_mod.main(argv)
    torch.cuda.synchronize()
    launches = {"flash_attention": fa.launches,
                "decode_attention": dec.launches}
    check(all(n > 0 for n in launches.values()),
          f"the serving run did not launch every kernel: {launches}")
    check(fa.launches_tc == fa.launches, f"bf16 flash launches "
          f"{fa.launches}, of which on the tensor cores {fa.launches_tc}")
    gen = rep["gen_tokens"]
    check(tuple(gen.shape) == (48, N) and int(gen.min()) >= 0
          and int(gen.max()) < cfg.vocab_size,
          f"bad generated tokens {tuple(gen.shape)}")
    check(bool(torch.isfinite(rep["logprobs"]).all())
          and float(rep["logprobs"].max()) <= 1e-6,
          "non-finite or positive logprobs")
    check(float(rep["mask"].sum()) == 48 * N, "budgets not fully served")
    print(f"[5 serve] {ARCH} bf16 batch 48 wave {W} prompt {P} new {N}: "
          f"{rep['tok_s']:.1f} valid tok/s ({rep['valid_tokens']:.0f} tokens "
          f"in {rep['seconds']:.3f} s), TTFT p50 {rep['ttft_p50_s'] * 1e3:.1f}"
          f" ms p95 {rep['ttft_p95_s'] * 1e3:.1f} ms, {rep['decode_rounds']} "
          f"decode rounds, {rep['prefills']} prefills, occupancy "
          f"{rep['mean_occupancy']:.2f} (ideal {rep['ideal_occupancy']:.2f}), "
          f"peak {rep['peak_bytes'] / 2**30:.2f} GiB | card {card}",
          flush=True)
    print(f"[5 serve] kernel launches in the serving run (3 passes: warm-up,"
          f" timed, TTFT): {launches}, flash on the tensor cores "
          f"{fa.launches_tc}; {rep['tok_s']:.1f} valid tok/s beside "
          f"357.1-364.3 with the CUDA-core attention kernels on an H100 "
          f"80GB HBM3 at 700 W (record only: the step is host-bound)",
          flush=True)
    for name, n in launches.items():
        results[name]["launches"] = n
    del rep
    torch.cuda.empty_cache()

    lap("5")
    # ---- 6. RWKV6 whole-path parity, fp32, full width --------------------
    params = T.init_params(rcfg, seed=0, device=dev, dtype=torch.float32)
    prompts = torch.randint(0, rcfg.vocab_size, (12, 64),
                            generator=torch.Generator().manual_seed(0))
    runs = {}
    for impl in ("kernel", "plain"):
        attn.set_attention_impl(impl)
        rw.launches = 0
        ro, st = adapter.generate(params, rcfg, prompts, None, sampler,
                                  wave=8, decode_chunk=4, fast_path=False,
                                  device=dev)
        torch.cuda.synchronize()
        runs[impl] = (ro, st, rw.launches)
    attn.set_attention_impl("kernel")
    (rk, sk, nr), (rp, sp, pr) = runs["kernel"], runs["plain"]
    check(nr > 0, f"fp32 kernel run launched rwkv6_scan {nr} times")
    check(pr == 0, "the plain run launched rwkv6_scan")
    same_tok = torch.equal(rk["gen_tokens"], rp["gen_tokens"])
    same_mask = torch.equal(rk["mask"], rp["mask"])
    lp_err = max_err(rk["logprobs"], rp["logprobs"])
    print(f"[6 parity] {RWKV_ARCH} fp32 full width ({rcfg.n_layers} layers, "
          f"d {rcfg.d_model}, {RH} heads of {RN}), 12 requests, wave 8, "
          f"prompt 64, 16 new: tokens identical={same_tok} masks "
          f"identical={same_mask} logprob max diff {lp_err:.3g} (tol 1e-3); "
          f"kernel run launched rwkv6_scan {nr}; prefills {sk['prefills']}, "
          f"decode rounds {sk['decode_steps']}", flush=True)
    check(same_tok and same_mask and lp_err <= 1e-3,
          "fp32 kernel and plain rwkv6 serving runs disagree")
    check(sk["occupancy_trace"] == sp["occupancy_trace"],
          "fp32 rwkv6 runs disagree on the occupancy trace")
    del params, runs, rk, rp
    torch.cuda.empty_cache()

    lap("6")
    # ---- 7. the RWKV6 serving path, bf16, full width ---------------------
    argv[1] = RWKV_ARCH
    fa.launches = dec.launches = rw.launches = 0
    rep = serve_mod.main(argv)
    torch.cuda.synchronize()
    n_rwkv = rw.launches
    check(n_rwkv > 0, "the rwkv6-3b serving run did not launch rwkv6_scan")
    gen = rep["gen_tokens"]
    check(tuple(gen.shape) == (48, N) and int(gen.min()) >= 0
          and int(gen.max()) < rcfg.vocab_size,
          f"bad generated tokens {tuple(gen.shape)}")
    check(bool(torch.isfinite(rep["logprobs"]).all())
          and float(rep["logprobs"].max()) <= 1e-6,
          "non-finite or positive logprobs")
    check(float(rep["mask"].sum()) == 48 * N, "budgets not fully served")
    print(f"[7 serve] {RWKV_ARCH} bf16 batch 48 wave {W} prompt {P} new {N}: "
          f"{rep['tok_s']:.1f} valid tok/s ({rep['valid_tokens']:.0f} tokens "
          f"in {rep['seconds']:.3f} s), TTFT p50 {rep['ttft_p50_s'] * 1e3:.1f}"
          f" ms p95 {rep['ttft_p95_s'] * 1e3:.1f} ms, {rep['decode_rounds']} "
          f"decode rounds, {rep['prefills']} prefills, occupancy "
          f"{rep['mean_occupancy']:.2f} (ideal {rep['ideal_occupancy']:.2f}), "
          f"peak {rep['peak_bytes'] / 2**30:.2f} GiB | card {card}",
          flush=True)
    print(f"[7 serve] kernel launches in the serving run (3 passes: warm-up,"
          f" timed, TTFT): rwkv6_scan {n_rwkv}, flash_attention "
          f"{fa.launches}, decode_attention {dec.launches}", flush=True)
    results["rwkv6_scan"]["launches"] = n_rwkv
    del rep
    torch.cuda.empty_cache()

    lap("7")
    # ---- 8. Jamba whole-path parity, fp32, first 2 layers at full width --
    cut2 = first_layers(jcfg, 2)
    params = T.init_params(cut2, seed=0, device=dev, dtype=torch.float32)
    prompts = torch.randint(0, cut2.vocab_size, (12, 64),
                            generator=torch.Generator().manual_seed(0))
    runs = {}
    for impl in ("kernel", "plain"):
        attn.set_attention_impl(impl)
        fa.launches = fa.launches_tc = dec.launches = mb.launches = 0
        ro, st = adapter.generate(params, cut2, prompts, None, sampler,
                                  wave=8, decode_chunk=4, fast_path=False,
                                  device=dev)
        torch.cuda.synchronize()
        runs[impl] = (ro, st, (mb.launches, fa.launches, dec.launches))
        n_tc = fa.launches_tc if impl == "kernel" else n_tc
    attn.set_attention_impl("kernel")
    (rk, sk, nk), (rp, sp, np_) = runs["kernel"], runs["plain"]
    check(all(n > 0 for n in nk), f"fp32 jamba kernel run launched "
          f"mamba_scan/flash/decode {nk} times")
    check(not any(np_), f"the plain jamba run launched kernels {np_}")
    check(n_tc == 0, "fp32 flash launches took the tensor cores")
    same_tok = torch.equal(rk["gen_tokens"], rp["gen_tokens"])
    same_mask = torch.equal(rk["mask"], rp["mask"])
    lp_err = max_err(rk["logprobs"], rp["logprobs"])
    print(f"[8 parity] {JAMBA_ARCH} fp32, first {cut2.n_layers} layers at "
          f"full width (d {cut2.d_model}, d_inner {DI}, {cut2.n_experts} "
          f"experts top-{cut2.top_k}, {cut2.param_count() / 1e9:.2f} B "
          f"parameters), 12 requests, wave 8, prompt 64, 16 new: tokens "
          f"identical={same_tok} masks identical={same_mask} logprob max "
          f"diff {lp_err:.3g} (tol 1e-3); kernel run launched mamba_scan "
          f"{nk[0]}, flash {nk[1]}, decode {nk[2]}; prefills "
          f"{sk['prefills']}, decode rounds {sk['decode_steps']}", flush=True)
    check(same_tok and same_mask and lp_err <= 1e-3,
          "fp32 kernel and plain jamba serving runs disagree")
    check(sk["occupancy_trace"] == sp["occupancy_trace"],
          "fp32 jamba runs disagree on the occupancy trace")
    del params, runs, rk, rp
    torch.cuda.empty_cache()

    lap("8")
    # ---- 9. the Jamba serving path, bf16, first 4 layers at full width ---
    cut4 = first_layers(jcfg, 4)
    argv[1] = JAMBA_ARCH
    fa.launches = fa.launches_tc = dec.launches = rw.launches = 0
    mb.launches = 0
    rep = serve_mod.run(serve_mod.parse_args(argv), cfg=cut4)
    torch.cuda.synchronize()
    n_tc = fa.launches_tc
    got = {"mamba_scan": mb.launches, "flash_attention": fa.launches,
           "decode_attention": dec.launches, "rwkv6_scan": rw.launches}
    n_mamba = sum(s_.mixer.value == "mamba" for s_ in cut4.pattern)
    n_attn = sum(s_.mixer.value == "attention" for s_ in cut4.pattern)
    passes = 3                          # warm-up, timed, TTFT
    want = {"mamba_scan": n_mamba * passes * rep["prefills"],
            "flash_attention": n_attn * passes * rep["prefills"],
            "decode_attention": n_attn * passes * rep["decode_rounds"],
            "rwkv6_scan": 0}
    gen = rep["gen_tokens"]
    check(tuple(gen.shape) == (48, N) and int(gen.min()) >= 0
          and int(gen.max()) < cut4.vocab_size,
          f"bad generated tokens {tuple(gen.shape)}")
    check(bool(torch.isfinite(rep["logprobs"]).all())
          and float(rep["logprobs"].max()) <= 1e-6,
          "non-finite or positive logprobs")
    check(float(rep["mask"].sum()) == 48 * N, "budgets not fully served")
    print(f"[9 serve] {JAMBA_ARCH} bf16, first {cut4.n_layers} layers at "
          f"full width ({cut4.param_count() / 1e9:.2f} B parameters), batch "
          f"48 wave {W} prompt {P} new {N}: {rep['tok_s']:.1f} valid tok/s "
          f"({rep['valid_tokens']:.0f} tokens in {rep['seconds']:.3f} s), "
          f"TTFT p50 {rep['ttft_p50_s'] * 1e3:.1f} ms p95 "
          f"{rep['ttft_p95_s'] * 1e3:.1f} ms, {rep['decode_rounds']} decode "
          f"rounds, {rep['prefills']} prefills, occupancy "
          f"{rep['mean_occupancy']:.2f} (ideal {rep['ideal_occupancy']:.2f}), "
          f"peak {rep['peak_bytes'] / 2**30:.2f} GiB | card {card}",
          flush=True)
    print(f"[9 serve] kernel launches in the serving run (3 passes: warm-up,"
          f" timed, TTFT): {got} (expected {want})", flush=True)
    check(got == want, f"jamba serving launches {got}, expected {want}")
    check(n_tc == got["flash_attention"], f"bf16 flash launches "
          f"{got['flash_attention']}, of which on the tensor cores {n_tc}")
    results["mamba_scan"]["launches"] = got["mamba_scan"]
    del rep
    torch.cuda.empty_cache()

    lap("9")
    # ---- 10. RL parity: one greedy PPO iteration, kernels against plain --
    rl_ref = rl_phase10(torch, dev, cfg, attn, fa, dec, card)
    torch.cuda.empty_cache()

    lap("10")
    # ---- 11. the RL launcher at full width, then the e2e actor -----------
    # the RL rows' launches: the launcher's GRPO run (3 iterations)
    rl_launches, e2e_launches, e2e_cfg = rl_phase11(torch, dev, fa, dec,
                                                    card)
    for key, n in rl_launches.items():
        results[key]["launches"] = n
    torch.cuda.empty_cache()

    lap("11")
    # ---- 12. the LM mode at full width; one step card against CPU --------
    lm_params = lm_phase12(torch, dev, card)

    lap("12")
    # ---- 13. checkpoints on the card --------------------------------------
    ckpt_phase13(torch, dev, card, lm_params)
    del lm_params
    torch.cuda.empty_cache()

    lap("13")
    # ---- 14. elastic plan swaps and faults at full width -------------------
    after = elastic_phase14(torch, dev, fa, dec, card)
    print(f"[14 elastic] launches in the first iteration after the swap "
          f"(flash, decode): {after}", flush=True)

    lap("14")
    # ---- 15. the launcher's drift and checkpoint faults, 4-layer cut -------
    launcher_phase15(torch, dev, fa, dec, card)

    lap("15")
    # ---- 16. no-fault control: spurious fires of the monitor and deadlines -
    control_phase16(torch, dev, fa, dec, card)

    lap("16")
    # ---- 17. the rest of genserve, fp32, held against one-shot -------------
    genserve_phase17(torch, dev, fa, dec, rw, mb, card)

    lap("17")
    # ---- 18. chunked, prefix-cache and speculative serving, bf16 -----------
    serving_phase18(torch, dev, fa, dec, card)

    lap("18")
    # ---- 19. RL GEN on chunked admission -----------------------------------
    rl_phase19(torch, dev, cfg, fa, dec, card, rl_ref)

    lap("19")
    # ---- 20. the model zoo: hubert-xlarge and pixtral-12b ------------------
    zoo_rows, zoo_launches = zoo_phase20(torch, dev, fa, dec, card)
    results.update(zoo_rows)
    for key in ("flash_attention/pixtral_prefill",
                "decode_attention/pixtral_decode"):
        results[key]["launches"] = zoo_launches[key]

    lap("20")
    # ---- 21. RL GEN with speculative decoding --------------------------------
    rl_spec_phase21(torch, dev, cfg, fa, dec, card, rl_ref)
    free(torch)

    lap("21")
    # ---- 22. sharded plan execution on ranks sharing the card --------------
    sharded_phase22(torch, dev, card)

    lap("22")
    # ---- 23. the genserve engine on a mesh of ranks ------------------------
    sharded_genserve_phase23(torch, dev, card)

    lap("23")
    # ---- 24. the launcher's drift and faults on ranks ----------------------
    elastic_ranks_phase24(torch, dev, card)

    lap("24")
    # ---- 25. full-width steps against the dry-run's roofline ---------------
    results.update(roofline_phase25(torch, F, dev, fa, dec, card))

    lap("25")
    # ---- 26. MoE models and uneven heads on a mesh of ranks ----------------
    results.update(mesh_phase26(torch, dev, card))

    lap("26")
    # ---- 27. the example scripts on the card --------------------------------
    results.update(examples_phase27(torch, F, fa, dec, rw, mb, attn, flush,
                                    card, e2e_cfg, e2e_launches))

    lap("27")
    # ---- 28. every head dim to 256; Gemma 2 9B's widths served ----------
    results.update(sizes_phase28(torch, F, dev, fa, dec, rw, mb, attn,
                                 flush, card))

    lap("28")
    print("[time] by phase: " + ", ".join(f"{p} {t:.1f}s" for p, t in laps),
          flush=True)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in results.values()]}))
    print(f"[done] {time.monotonic() - t_all:.1f}s", flush=True)
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind, "count": count}}))


if __name__ == "__main__":
    main()
