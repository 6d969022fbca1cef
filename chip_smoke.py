#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Drives the port's serving path (``repro_torch``; no JAX, nothing of the
JAX package) at the full width of qwen3-0.6b (attention), of rwkv6-3b
(RWKV6 time mix) and of jamba-1.5-large-398b (attention + Mamba, dense
and MoE FFNs; its first 2 and 4 layers, since the whole model does not
fit one card) and exits non-zero on any failure.  Phases, each printing
its result:

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
             runs (a note: the bound stays bytes / operations).
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

Then one JSON line with every kernel's numbers, the card line, and the
last line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import threading
import time
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
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    times = sorted(ev["dur"] / 1e3 for ev in device_events(prof)
                   if ev["cat"] == "kernel" and kernel in ev["name"])
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


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a "
             "CUDA card")
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
