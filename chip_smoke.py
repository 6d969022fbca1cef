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
speculative decoding, slot failures and cancels), and exits non-zero on
any failure.  Phases, each printing its result:

  1. card    nvidia-smi name and power limit, torch's device name/count;
             fails without CUDA.
  2. build   nvcc builds every kernel of the paths from
             src/repro_torch/csrc (one nvcc per source, in parallel) into
             build/kernels/; ptxas's registers, spills and shared memory
             per kernel of every source.
  3. kernels each CUDA kernel against its plain PyTorch version at the
             serving paths' shapes (attention also at Jamba's GQA-8
             heads) and on a small matrix, timed beside the plain version
             and one library call where one exists; kernel and library
             times as median (min-max) of 30 calls, and each kernel's
             own device time (torch.profiler) over 30 more.
             Attention: GQA/MQA, hd 64/80/128, window, softcap, ragged S
             and L, fp32 and bf16; tolerance 2e-4 fp32 with TF32 off,
             2e-2 bf16.  RWKV6 scan: N 32/64/128, S 1/63/65/100/256, B 1
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
             then the e2e actor (d 192, 4 layers) for 30 GRPO iterations,
             its reward printed.  The RL rows of the kernels line take
             their launches from the GRPO run.
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
             (batch 48, wave 16, prompt 256 with 128 shared tokens, 64
             new, greedy), each run against one-shot admission: chunked
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
             --expect-prefix-hits; --spec-k 4 --draft-arch qwen3-0.6b
             (tok/s, TTFT, hit and accept rates, peak memory, launches per
             kernel); the paged view's gather per decode step.
 19. rl      phase 10's PPO iteration with GEN on genserve's chunked
             admission (prefill_chunk 16, decode_chunk 2): tokens identical
             to phase 10's, GEN launches decode_attention and no
             flash_attention, TRAIN nothing.

Then one JSON line with every kernel's numbers, the card line, and the
last line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
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


def device_ms(fn, torch, flush, kernel: str, iters: int = 30):
    """(median, min, max) of one kernel's own device time in ms, from
    torch.profiler over ``iters`` calls with the L2 flushed before each.
    A pass of its own after ``time_ms``'s, so that the tracing adds
    nothing to the event times; ``kernel`` is part of the kernel's name."""
    from repro_torch.launch.profile_serve import device_events
    acts = [torch.profiler.ProfilerActivity.CUDA]
    for attempt in range(2):
        # a profiling session now and then returns no device activity at
        # all (seen once on the card for one of phase 3's cases): profile
        # a second time before failing
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(iters):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        times = sorted(ev["dur"] / 1e3 for ev in device_events(prof)
                       if ev["cat"] == "kernel" and kernel in ev["name"])
        if len(times) == iters:
            break
        print(f"[3 kernels] the profiler saw {len(times)} launches of "
              f"{kernel}, not {iters} (attempt {attempt + 1})", flush=True)
    check(len(times) == iters, f"the profiler saw {len(times)} launches of "
          f"{kernel}, not {iters}")
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
            m = trainer.iteration(prompts, answers, None)
            torch.cuda.synchronize()
            runs[impl] = (m, hook.bb, hook.by_kind(-1))
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
          f"{mp['loss']:.3g} (not held) | card {card}", flush=True)
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
    return rk["sequences"], rk["mask"]


def rl_phase11(torch, dev, fa, dec, card):
    """``repro_torch.launch.train`` at qwen3-0.6b's full width through
    ``run_rl``: GRPO 3 steps, GRPO --async 3 steps, PPO 2 steps, batch 16;
    then the e2e actor for 30 GRPO iterations.  Returns the launches at
    each RL-path shape in the first run (GRPO, the searched plan)."""
    from repro_torch.launch import train as train_mod
    from repro_torch.models.config import ModelConfig
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
        e2e = ModelConfig(name="rl-actor", n_layers=4, d_model=192,
                          n_heads=4, n_kv_heads=2, head_dim=48, d_ff=576,
                          vocab_size=16, dtype="float32")
        hook.iters.clear()
        t0 = time.monotonic()
        out = train_mod.run_rl(train_mod.parse_args(
            ["--arch", ARCH, "--rl", "grpo", "--steps", "30", "--batch",
             "16"]), cfg=e2e)
        rewards = [m["reward_mean"] for m in out["metrics"]]
        check(all(math.isfinite(r) for r in rewards),
              "non-finite e2e rewards")
        print(f"[11 train] e2e actor (d 192, 4 layers, hd 48, 4:2 heads, "
              f"fp32), GRPO 30 iterations of 16 prompts x 4: reward "
              + ", ".join(f"iter {i} {rewards[i]:.3f}"
                          for i in (0, 10, 20, 29))
              + f" (printed, not a gate); "
              f"{time.monotonic() - t0:.1f}s | card {card}", flush=True)
    finally:
        restore()
    return totals


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
        if hasattr(m, "launches_tc"):
            m.launches_tc = 0


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
    admission on the same weights and prompts (qwen3-0.6b, batch 48, wave
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
    cfg = archs.get(ARCH)
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
            print(f"[17 genserve] {ARCH} fp32 full width, {m}: tokens and "
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
    128-token prompt prefix, and speculative decoding with a qwen3-0.6b
    draft; then the paged view's copy per decode step."""
    from repro_torch.configs import archs
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import cache as cache_mod
    t_phase = time.monotonic()
    cfg = archs.get(ARCH)
    W, P, N = 16, 256, 64
    argv = ["--arch", ARCH, "--batch", "48", "--wave", str(W),
            "--prompt-len", str(P), "--new-tokens", str(N),
            "--decode-chunk", "4", "--seed", "0"]
    reps = {}
    for label, extra in (
            ("chunked", ["--prefill-chunk", "64"]),
            ("prefix", ["--page-size", "16", "--prefix-cache",
                        "--shared-prompts", "128", "--expect-prefix-hits"]),
            ("spec", ["--spec-k", "4", "--draft-arch", ARCH])):
        _zero_counts(fa, dec)
        t0 = time.monotonic()
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
        spec = f", spec k=4 draft {ARCH}" if label == "spec" else ""
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

    # small matrix: GQA/MQA, hd 64/80/128, window, caps, ragged S / L
    n_cases = 0
    for dtype in (torch.float32, bf16):
        for B, S, h_, kv_, d_, causal, window, cap in [
                (2, 300, 4, 2, 64, True, None, None),
                (1, 100, 4, 1, 128, True, 64, None),
                (2, 200, 4, 2, 80, True, None, 50.0),
                (1, 77, 8, 8, 128, False, None, None),
                (1, 130, 4, 2, 64, True, 64, 30.0)]:
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
                (2, 4, 2, 128, 64, 30.0, 64)]:
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

    # ---- 10. RL parity: one greedy PPO iteration, kernels against plain --
    rl_ref = rl_phase10(torch, dev, cfg, attn, fa, dec, card)
    torch.cuda.empty_cache()

    # ---- 11. the RL launcher at full width, then the e2e actor -----------
    # the RL rows' launches: the launcher's GRPO run (3 iterations)
    for key, n in rl_phase11(torch, dev, fa, dec, card).items():
        results[key]["launches"] = n
    torch.cuda.empty_cache()

    # ---- 12. the LM mode at full width; one step card against CPU --------
    lm_params = lm_phase12(torch, dev, card)

    # ---- 13. checkpoints on the card --------------------------------------
    ckpt_phase13(torch, dev, card, lm_params)
    del lm_params
    torch.cuda.empty_cache()

    # ---- 14. elastic plan swaps and faults at full width -------------------
    after = elastic_phase14(torch, dev, fa, dec, card)
    print(f"[14 elastic] launches in the first iteration after the swap "
          f"(flash, decode): {after}", flush=True)

    # ---- 15. the launcher's drift and checkpoint faults, 8-layer cut -------
    launcher_phase15(torch, dev, fa, dec, card)

    # ---- 16. no-fault control: spurious fires of the monitor and deadlines -
    control_phase16(torch, dev, fa, dec, card)

    # ---- 17. the rest of genserve, fp32, held against one-shot -------------
    genserve_phase17(torch, dev, fa, dec, rw, mb, card)

    # ---- 18. chunked, prefix-cache and speculative serving, bf16 -----------
    serving_phase18(torch, dev, fa, dec, card)

    # ---- 19. RL GEN on chunked admission -----------------------------------
    rl_phase19(torch, dev, cfg, fa, dec, card, rl_ref)

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
