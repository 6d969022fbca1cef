"""The port's kernels against the JAX Pallas kernels.

On the CPU the port's wrappers take their plain PyTorch versions and the
JAX kernels run Pallas in interpret mode (``repro.kernels.backend``), as
``tests/test_kernels.py`` runs them: the same inputs, made with numpy
from a seed, go through both.  Tolerance 2e-4 in fp32 and 2e-2 in bf16
for attention (``tests/test_kernels.py:20-22``), 2e-3 for the RWKV6 scan
(``tests/test_kernels.py:78-81``), 1e-3 for the Mamba scan
(``tests/test_kernels.py:98-101``).  ``tests/test_torch_cuda.py`` holds
the hand-written CUDA kernels against the plain versions on the card.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.decode_attention.ops import decode_attention as j_decode  # noqa: E402
from repro.kernels.flash_attention.ops import flash_attention as j_flash  # noqa: E402
from repro.kernels.mamba_scan.ops import mamba_scan as j_mamba  # noqa: E402
from repro.kernels.mamba_scan.ref import mamba_scan_ref as j_mamba_ref  # noqa: E402
from repro.kernels.rwkv6_scan.ops import rwkv6_scan as j_rwkv  # noqa: E402
from repro.kernels.rwkv6_scan.ref import rwkv6_scan_ref as j_rwkv_ref  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import cache as jcache  # noqa: E402
from repro_torch.kernels.decode_attention import ops as t_decode  # noqa: E402
from repro_torch.configs import archs as tarchs  # noqa: E402
from repro_torch.kernels import ops as t_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as t_flash  # noqa: E402
from repro_torch.kernels.mamba_scan import ops as t_mamba  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ops as t_rwkv  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

DT = {"float32": (np.float32, jnp.float32, torch.float32),
      "bfloat16": (ml_dtypes.bfloat16, jnp.bfloat16, torch.bfloat16)}


def tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-4, atol=2e-4)


def _normal(rng, shape, dtype):
    """Same values on both sides: numpy draws, rounded to `dtype`."""
    a = rng.standard_normal(shape).astype(np.float32)
    return a.astype(DT[dtype][0])


def _t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _np32(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("H,KV,causal,window,cap", [
    (4, 2, True, None, None),      # GQA
    (4, 1, True, 64, None),        # MQA + window
    (4, 2, True, None, 50.0),      # softcap
    (4, 2, False, None, None),     # non-causal
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_vs_pallas(H, KV, causal, window, cap, dtype):
    B, S, hd = 1, 300, 80
    rng = np.random.default_rng(11)
    q = _normal(rng, (B, S, H, hd), dtype)
    k = _normal(rng, (B, S, KV, hd), dtype)
    v = _normal(rng, (B, S, KV, hd), dtype)
    ref = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=causal, window=window, cap=cap)
    out = t_flash.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                                  window=window, cap=cap)
    assert out.dtype == DT[dtype][2] and out.shape == (B, S, H, hd)
    np.testing.assert_allclose(_np32(out), _np32(ref), **tol(dtype))


@pytest.mark.parametrize("H,KV,hd,L,cap", [
    (4, 2, 64, 300, None), (4, 1, 80, 300, 30.0), (8, 2, 128, 700, 30.0),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_plain_vs_pallas(H, KV, hd, L, cap, dtype):
    B = 2
    rng = np.random.default_rng(5)
    q = _normal(rng, (B, H, hd), dtype)
    k = _normal(rng, (B, L, KV, hd), dtype)
    v = _normal(rng, (B, L, KV, hd), dtype)
    bias = np.where(rng.random((B, L)) < 0.75, 0.0, -1e30).astype(np.float32)
    ref = j_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   jnp.asarray(bias), cap=cap)
    out = t_decode.decode_attention(_t(q), _t(k), _t(v), _t(bias), cap=cap)
    assert out.dtype == DT[dtype][2] and out.shape == (B, H, hd)
    np.testing.assert_allclose(_np32(out), _np32(ref), **tol(dtype))


def test_wrappers_count_no_launch_on_cpu():
    rng = np.random.default_rng(0)
    q = _t(_normal(rng, (1, 8, 2, 32), "float32"))
    before = (t_flash.launches, t_decode.launches, t_rwkv.launches,
              t_mamba.launches)
    t_flash.flash_attention(q, q, q)
    t_decode.decode_attention(q[:, 0], q, q, torch.zeros(1, 8))
    t_rwkv.rwkv6_scan(q, q, q, -q.abs(), q[0, 0])
    x = q.reshape(1, 8, 64)
    t_mamba.mamba_scan(x.abs(), x, x[..., :8], x[..., :8], -torch.ones(64, 8))
    assert (t_flash.launches, t_decode.launches, t_rwkv.launches,
            t_mamba.launches) == before


@pytest.mark.parametrize("sms", [132, 114])       # H100 SXM, H100 PCIe
@pytest.mark.parametrize("B,H,KV,L,hd", [
    (16, 16, 8, 320, 128), (16, 64, 8, 320, 128),   # serving: qwen3, jamba
    (1, 8, 1, 4096, 128), (3, 16, 1, 200, 64), (2, 4, 2, 1, 80),
    (1, 1, 1, 1, 32), (4, 4, 4, 77, 64), (48, 48, 8, 2048, 96),
    (1, 128, 1, 31, 48), (2, 24, 8, 33, 128),
])
def test_decode_plan(B, H, KV, L, hd, sms):
    """The decode launch plan: at least one split, never more splits than
    TILE-key tiles, keys per split a multiple of the tile, every split
    non-empty, at most one block per SM once L is split and one split
    only where a second would pass that, and scratch and tickets sized to
    the buffers the kernel indexes (none with one split)."""
    p = t_decode.plan(B, H, KV, L, hd, sms)
    n_tiles = -(-L // t_decode.TILE)
    assert 1 <= p.splits <= n_tiles
    assert p.chunk % t_decode.TILE == 0 and p.chunk > 0
    assert (p.splits - 1) * p.chunk < L <= p.splits * p.chunk
    assert p.head_groups == -(-(H // KV) // t_decode.GROUP)
    blocks = B * KV * p.head_groups
    if p.splits == 1:
        assert p.scratch == p.tickets == 0
        assert n_tiles == 1 or blocks * 2 > sms
    else:
        assert p.scratch == B * H * p.splits * (hd + 2)
        assert p.tickets == blocks
        assert blocks * p.splits <= sms


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [1, 12, 16, 40, 72, 136, 200, 255, 256])
def test_flash_path_and_head_dims(hd, dtype):
    """The dtype alone picks the flash kernel (bf16: tensor cores, fp32:
    CUDA cores); the wrapper's checks take every head dim up to
    ``MAX_HEAD_DIM`` (256) and refuse any above it before a launch; the
    kernel reads bf16 rows padded to a multiple of 8 and fp32 ones as
    they are."""
    tdt = DT[dtype][2]
    assert t_flash.tensor_core_path(tdt) == (dtype == "bfloat16")
    q = torch.zeros((1, 3, 2, hd), dtype=tdt)
    t_flash._check(q, q, q)
    width = t_flash.read_width(hd, tdt)
    assert width == (-(-hd // 8) * 8 if dtype == "bfloat16" else hd)
    assert t_flash.pad_head_dim(q, width).shape == (1, 3, 2, width)
    q = torch.zeros((1, 3, 2, hd + t_flash.MAX_HEAD_DIM), dtype=tdt)
    with pytest.raises(ValueError, match="head dim"):
        t_flash._check(q, q, q)
    with pytest.raises(TypeError):
        t_flash.tensor_core_path(torch.float16)


@pytest.mark.parametrize("B,S,H,N,chunk", [
    (2, 128, 2, 32, 32), (1, 100, 4, 64, 64),   # padding path
    (2, 64, 1, 16, 16), (1, 64, 2, 128, 32),
])
def test_rwkv6_scan_plain_vs_pallas(B, S, H, N, chunk):
    """The port's rwkv6_scan (on the CPU: the per-token recurrence)
    against the JAX Pallas kernel in interpret mode and against the JAX
    recurrence, over ``tests/test_kernels.py``'s matrix and input
    distribution."""
    rng = np.random.default_rng(21)
    r, k, v = (rng.standard_normal((B, S, H, N)).astype(np.float32)
               for _ in range(3))
    logw = -np.exp(rng.standard_normal((B, S, H, N)) * 0.5 - 1.0) \
        .astype(np.float32)
    u = (rng.standard_normal((H, N)) * 0.5).astype(np.float32)
    yt, st = t_rwkv.rwkv6_scan(_t(r), _t(k), _t(v), _t(logw), _t(u),
                               chunk=chunk)
    assert yt.dtype == st.dtype == torch.float32
    assert yt.shape == (B, S, H, N) and st.shape == (B, H, N, N)
    for yj, sj in (j_rwkv(r, k, v, logw, u, chunk=chunk),
                   j_rwkv_ref(r, k, v, logw, u)):
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj),
                                   rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(st.numpy(), np.asarray(sj),
                                   rtol=2e-3, atol=2e-3)


def _tf32_cut(x):
    """x with its 13 low mantissa bits cleared: the TF32 value the tensor
    core reads from an fp32 register."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def _mm_3xtf32(a, b):
    """a @ b as ``csrc/rwkv6_scan.cu``'s mma.sync products: each operand
    split into hi = its TF32 cut and lo = x - hi (read as TF32 in turn),
    lo.hi + hi.lo + hi.hi summed in fp32."""
    a, b = np.float32(a), np.float32(b)
    ah, bh = _tf32_cut(a), _tf32_cut(b)
    al, bl = _tf32_cut(a - ah), _tf32_cut(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _rwkv6_subchunk_emulation(r, k, v, logw, u, chunk, sub=16):
    """The CUDA kernel's decomposition in float32 numpy: per chunk the
    prefix sum of log2(e) * logw, the diagonal sub-chunk blocks with one
    exponential per (t, s, n), the off-diagonal blocks as 3xTF32 products
    of r and k decayed against ref_j (cum_ex at the first row of
    sub-chunk j), then y = r e^{cum_ex} S + A v and S <- e^{total} S +
    (k e^{total - cum})^T v in 3xTF32.  Returns (y, state, the largest
    exponent taken before any clamp)."""
    B, S, H, N = r.shape
    l2e = np.float32(1.4426950408889634)
    ex2 = lambda x: np.exp2(np.minimum(x, 0)).astype(np.float32)
    y = np.zeros_like(r)
    state = np.zeros((B, H, N, N), np.float32)
    top = -np.inf
    for b in range(B):
        for h in range(H):
            St = np.zeros((N, N), np.float32)
            for c0 in range(0, S, chunk):
                n = min(chunk, S - c0)
                pad = lambda a: np.concatenate(
                    [a[b, c0:c0 + n, h], np.zeros((chunk - n, N), np.float32)])
                rc, kc, vc, wc = (pad(a) for a in (r, k, v, logw))
                cum = np.cumsum(wc * l2e, axis=0, dtype=np.float32)
                ce = np.concatenate([np.zeros((1, N), np.float32), cum[:-1]])
                A = np.zeros((chunk, chunk), np.float32)
                for j in range(chunk // sub):
                    tj = slice(j * sub, (j + 1) * sub)
                    e = ce[tj, None, :] - cum[None, tj, :]      # [t, s, n]
                    lower = np.tril(np.ones((sub, sub), bool), -1)
                    top = max(top, e[lower].max(initial=-np.inf))
                    A[tj, tj] = np.where(
                        lower, (rc[tj, None] * kc[None, tj] * ex2(e)).sum(-1),
                        0) + np.diag((rc[tj] * u[h] * kc[tj]).sum(-1))
                    ref = ce[j * sub]
                    for i in range(j):
                        si = slice(i * sub, (i + 1) * sub)
                        er, ek = ce[tj] - ref, ref - cum[si]
                        top = max(top, er.max(), ek.max())
                        A[tj, si] = _mm_3xtf32(rc[tj] * ex2(er),
                                               (kc[si] * ex2(ek)).T)
                total = cum[-1]
                top = max(top, ce.max(), (total - cum).max())
                yc = _mm_3xtf32(rc * ex2(ce), St) + _mm_3xtf32(A, vc)
                y[b, c0:c0 + n, h] = yc[:n]
                St = ex2(total)[:, None] * St + _mm_3xtf32(
                    (kc * ex2(total - cum)).T, vc)
            state[b, h] = St
    return y, state, top


@pytest.mark.parametrize("decay_shift", [-1.0, 3.0])
@pytest.mark.parametrize("B,S,H,N,chunk", [
    (2, 128, 2, 32, 32), (1, 100, 4, 64, 64),   # padding path
    (2, 64, 1, 16, 16), (1, 64, 2, 128, 32),
])
def test_rwkv6_subchunk_tf32_emulation_vs_pallas(B, S, H, N, chunk,
                                                 decay_shift):
    """The CUDA kernel's algorithm (sub-chunks of 16, the ref_j factoring,
    3xTF32 products), emulated on the CPU, against the JAX Pallas kernel in
    interpret mode and the JAX recurrence at 2e-3, at the usual decay and
    at logw about -20 (shift 3.0), where a factored e^{cum_ex} e^{-cum}
    overflows.  Every exponent it takes is <= 0.  (Plain TF32 products,
    one pass, miss 2e-3 on this matrix: up to 1.5e-2.)"""
    rng = np.random.default_rng(21)
    r, k, v = (rng.standard_normal((B, S, H, N)).astype(np.float32)
               for _ in range(3))
    logw = -np.exp(rng.standard_normal((B, S, H, N)) * 0.5 + decay_shift) \
        .astype(np.float32)
    u = (rng.standard_normal((H, N)) * 0.5).astype(np.float32)
    ye, se, top = _rwkv6_subchunk_emulation(r, k, v, logw, u, chunk)
    assert top <= 0.0
    assert np.isfinite(ye).all() and np.isfinite(se).all()
    for yj, sj in (j_rwkv(r, k, v, logw, u, chunk=chunk),
                   j_rwkv_ref(r, k, v, logw, u)):
        np.testing.assert_allclose(ye, np.asarray(yj), rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(se, np.asarray(sj), rtol=2e-3, atol=2e-3)


def test_rwkv_kernel_routing(monkeypatch):
    """Under "kernel" every prefill layer calls the rwkv wrapper (once per
    layer, zero state); decode steps (carried state) never do; "plain"
    never does; on the CPU nothing counts as a launch."""
    cfg = tarchs.SMOKE["rwkv6-3b"]
    tp = TT.init_params(cfg, seed=5)
    calls = []

    def spy(*a):
        calls.append(a[0].shape)
        return real(*a)

    real = t_ops.rwkv6_scan
    monkeypatch.setattr(t_ops, "rwkv6_scan", spy)
    n_r = t_rwkv.launches
    prompts = torch.randint(0, cfg.vocab_size, (2, 7),
                            generator=torch.Generator().manual_seed(0))
    for impl, n_calls in (("kernel", cfg.n_layers), ("plain", 0)):
        tattn.set_attention_impl(impl)
        try:
            calls.clear()
            out = TT.forward(tp, cfg, {"tokens": prompts},
                             return_cache=True)
            assert len(calls) == n_calls
            assert all(c == (2, 7, cfg.rwkv_n_heads, cfg.rwkv_head_dim)
                       for c in calls)
            cache = out["cache"]
            for _ in range(2):
                _, cache = TT.decode_step(tp, cfg, prompts[:, :1], cache)
            assert len(calls) == n_calls
        finally:
            tattn.set_attention_impl("kernel")
    assert t_rwkv.launches == n_r


def test_kernel_path_in_model_attention():
    """Port of test_pallas_path_in_model_attention: the "kernel" impl
    agrees with the "plain" impl and with the JAX jnp path."""
    rng = np.random.default_rng(7)
    B, S, H, KV, hd = 1, 128, 4, 2, 64
    q = _normal(rng, (B, S, H, hd), "float32")
    k = _normal(rng, (B, S, KV, hd), "float32")
    v = _normal(rng, (B, S, KV, hd), "float32")
    pos = np.arange(S)
    ref = jattn.multihead_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), jnp.asarray(pos),
                                    jnp.asarray(pos), causal=True)
    tp = torch.arange(S)
    plain = tattn.multihead_attention(_t(q), _t(k), _t(v), tp, tp,
                                      causal=True, force_impl="plain")
    kern = tattn.multihead_attention(_t(q), _t(k), _t(v), tp, tp,
                                     causal=True, force_impl="kernel")
    np.testing.assert_allclose(plain.numpy(), np.asarray(ref),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(kern.numpy(), plain.numpy(),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("case", ["decode-ring", "decode-full-scalar",
                                  "prefill", "per-row-chunk",
                                  "chunked-k-valid"])
def test_routing_vs_jax_pallas(case):
    """``multihead_attention(force_impl="pallas")`` (JAX) against the
    port's ``"kernel"`` impl on CPU tensors, through each routing case."""
    rng = np.random.default_rng(3)
    B, H, KV, hd, window, cap = 3, 4, 2, 64, None, None
    kw = {}
    if case == "decode-ring":
        L, window, cap = 16, 16, 50.0
        pos = np.array([3, 17, 40])
        kp, valid = jcache.ring_slot_positions(L, window, jnp.asarray(pos))
        q_pos, k_pos, Sq, Sk = pos[:, None], np.asarray(kp), 1, L
        kw["k_valid"] = np.asarray(valid)
    elif case == "decode-full-scalar":
        L, pos = 24, 9
        kp, valid = jcache.ring_slot_positions(L, None, pos)
        q_pos, k_pos, Sq, Sk = np.full((1,), pos), np.asarray(kp), 1, L
        kw["k_valid"] = np.asarray(valid)
    elif case == "prefill":
        Sq = Sk = 40
        window, cap = 16, 50.0
        q_pos = k_pos = np.arange(Sq)
    elif case == "per-row-chunk":
        Sq, Sk = 4, 12
        q_pos = np.array([[8, 9, 10, 11], [2, 3, 4, 5], [0, 1, 2, 3]])
        k_pos = np.concatenate([np.tile(np.arange(8), (3, 1)), q_pos], 1)
        kw["k_valid"] = k_pos <= q_pos[:, -1:]
    else:   # shared positions with a 1-D k_valid -> chunked path
        Sq = Sk = 24
        q_pos = k_pos = np.arange(Sq)
        kw["k_valid"] = np.arange(Sk) % 5 != 3
    q = _normal(rng, (B, Sq, H, hd), "float32")
    k = _normal(rng, (B, Sk, KV, hd), "float32")
    v = _normal(rng, (B, Sk, KV, hd), "float32")
    ref = jattn.multihead_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(q_pos),
        jnp.asarray(k_pos), causal=True, window=window, cap=cap,
        force_impl="pallas",
        **{n: jnp.asarray(a) for n, a in kw.items()})
    out = tattn.multihead_attention(
        _t(q), _t(k), _t(v), _t(q_pos), _t(k_pos),
        causal=True, window=window, cap=cap, force_impl="kernel",
        **{n: _t(a) for n, a in kw.items()})
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               rtol=2e-4, atol=2e-4)


def test_chunked_attention_vs_jax():
    """The plain blockwise path with ragged chunks (q/k not a multiple of
    the chunk) against the JAX chunked_attention."""
    rng = np.random.default_rng(4)
    B, S, H, KV, hd = 2, 45, 4, 2, 32
    q = _normal(rng, (B, S, H, hd), "float32")
    k = _normal(rng, (B, S, KV, hd), "float32")
    v = _normal(rng, (B, S, KV, hd), "float32")
    pos = np.arange(S)
    kv_ = np.arange(S) % 7 != 2
    ref = jattn.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
        jnp.asarray(pos), causal=True, window=20, cap=30.0, q_chunk=16,
        k_chunk=16, k_valid=jnp.asarray(kv_))
    out = tattn.chunked_attention(
        _t(q), _t(k), _t(v), torch.as_tensor(pos), torch.as_tensor(pos),
        causal=True, window=20, cap=30.0, q_chunk=16, k_chunk=16,
        k_valid=torch.as_tensor(kv_))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("B,S,di,ds,chunk,bd", [
    (2, 64, 128, 16, 16, 64), (1, 100, 512, 16, 32, 256),  # padding
    (2, 32, 64, 8, 32, 64), (1, 48, 320, 16, 16, 64),      # di padding
])
def test_mamba_scan_plain_vs_pallas(B, S, di, ds, chunk, bd):
    """The port's mamba_scan (on the CPU: the per-token recurrence)
    against the JAX Pallas kernel in interpret mode and against the JAX
    recurrence, over ``tests/test_kernels.py``'s matrix and input
    distribution."""
    rng = np.random.default_rng(22)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, di)) - 1)) \
        .astype(np.float32)
    x = rng.standard_normal((B, S, di)).astype(np.float32)
    Bm = rng.standard_normal((B, S, ds)).astype(np.float32)
    Cm = rng.standard_normal((B, S, ds)).astype(np.float32)
    A = -np.exp(rng.standard_normal((di, ds)) * 0.3).astype(np.float32)
    yt, ht = t_mamba.mamba_scan(_t(dt), _t(x), _t(Bm), _t(Cm), _t(A))
    assert yt.dtype == ht.dtype == torch.float32
    assert yt.shape == (B, S, di) and ht.shape == (B, di, ds)
    for yj, hj in (j_mamba(dt, x, Bm, Cm, A, chunk=chunk, bd=bd),
                   j_mamba_ref(dt, x, Bm, Cm, A)):
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj),
                                   rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(ht.numpy(), np.asarray(hj),
                                   rtol=1e-3, atol=1e-3)


def test_mamba_kernel_routing(monkeypatch):
    """Under "kernel" every Mamba layer of a prefill calls the mamba
    wrapper (once per layer, zero state, fp32 contiguous inputs);
    decode steps (carried state) never do; "plain" never does; on the
    CPU nothing counts as a launch."""
    cfg = tarchs.SMOKE["jamba-1.5-large-398b"]
    tp = TT.init_params(cfg, seed=5)
    calls = []

    def spy(*a):
        assert all(t.dtype == torch.float32 and t.is_contiguous()
                   for t in a)
        calls.append(a[1].shape)
        return real(*a)

    real = t_ops.mamba_scan
    monkeypatch.setattr(t_ops, "mamba_scan", spy)
    n_m = t_mamba.launches
    n_mamba = sum(s.mixer.value == "mamba" for s in cfg.pattern)
    assert n_mamba > 0
    prompts = torch.randint(0, cfg.vocab_size, (2, 7),
                            generator=torch.Generator().manual_seed(0))
    for impl, n_calls in (("kernel", n_mamba * cfg.n_pattern_repeats),
                          ("plain", 0)):
        tattn.set_attention_impl(impl)
        try:
            calls.clear()
            out = TT.forward(tp, cfg, {"tokens": prompts},
                             return_cache=True)
            assert len(calls) == n_calls
            assert all(c == (2, 7, cfg.mamba_d_inner) for c in calls)
            cache = out["cache"]
            for _ in range(2):
                _, cache = TT.decode_step(tp, cfg, prompts[:, :1], cache)
            assert len(calls) == n_calls
        finally:
            tattn.set_attention_impl("kernel")
    assert t_mamba.launches == n_m
