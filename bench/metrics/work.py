"""Work counts and the card's peaks, frozen for the benchmark.

Every count is worked out from the traffic and the configuration, never
from what a kernel launched: the same work is counted whatever
implements it.  Peaks are an NVIDIA H100 SXM's data-sheet rates (dense,
no sparsity) at its 700 W limit.
"""
from __future__ import annotations

PEAK_BF16 = 989e12        # FLOP/s, tensor cores, bf16 and fp16
PEAK_FP32 = 67e12         # FLOP/s, fp32 outside the tensor cores (TF32 off)
HBM = 3.35e12             # bytes/s


def rwkv_work(B: int, S: int, H: int, N: int, C: int):
    """(bytes, fp32 FLOPs, exponentials) of the RWKV6 scan as the
    sub-chunked algorithm computes it on these shapes: each input read
    once, y and the state written once; chunks of C positions (the last
    one ragged) cut into sub-chunks of 16.  Scores: inside a sub-chunk one
    exponential and 4 operations per (t, s, n) of its pairs s < t; across
    sub-chunks 2 N per pair, on r and k decayed at an exponential and 2
    operations per element (r once per row past the first sub-chunk, k
    once per row and later sub-chunk).  A frozen copy of the port's
    ``chip_smoke.rwkv_work``."""
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


def attention_dims(c: dict):
    return (c["num_hidden_layers"], c["num_attention_heads"],
            c["num_key_value_heads"], c["head_dim"])


def flash_bound_s(c: dict, S: int, elem_bytes: int) -> float:
    """Least time of one sequence's causal prefill attention, every layer:
    the larger of its FLOPs (QK^T and PV over the S (S + 1) / 2 visible
    pairs) at the bf16 peak and its Q, K, V and O bytes at HBM speed."""
    L, H, KV, hd = attention_dims(c)
    flops = 4.0 * H * hd * S * (S + 1) / 2
    nbytes = S * (2 * H + 2 * KV) * hd * elem_bytes
    return L * max(flops / PEAK_BF16, nbytes / HBM)


def decode_bytes(c: dict, ctx: int, elem_bytes: int) -> float:
    """Bytes one decode token's attention needs, every layer: the ``ctx``
    valid K and V rows, its Q and its output."""
    L, H, KV, hd = attention_dims(c)
    return L * (ctx * 2 * KV * hd + 2 * H * hd) * elem_bytes
