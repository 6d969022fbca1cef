"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card (``-m cuda``; each test skips without a card).  Imports no JAX,
so it runs on a machine that has only the port:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance 2e-4 in fp32 (TF32 off) and 2e-2 in bf16 for attention, as
``tests/test_kernels.py:20-22``; 2e-3 for the RWKV6 scan, as
``tests/test_kernels.py:78-81``; 1e-3 for the Mamba scan, as
``tests/test_kernels.py:98-101``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.decode_attention import ops as t_decode  # noqa: E402
from repro_torch.kernels.flash_attention import ops as t_flash  # noqa: E402
from repro_torch.kernels.mamba_scan import ops as t_mamba  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ops as t_rwkv  # noqa: E402

DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-4, atol=2e-4)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,KV,hd,causal,window,cap", [
    (2, 300, 4, 2, 64, True, None, None), (1, 100, 4, 1, 80, True, 64, 50.0),
    (2, 256, 16, 8, 128, True, None, None), (1, 77, 4, 4, 48, False, None, None),
    (2, 256, 64, 8, 128, True, None, None),     # jamba's heads: GQA 8
    (2, 1000, 16, 16, 80, False, None, None),   # hubert: non-causal, H == KV
    # qwen3-0.6b's one-shot admission per rank of a DP 2 / TP 2 mesh:
    # genserve.generate(mesh=)'s wave 8 at prompt 64, the RL engine's
    # wave 32 at the addition task's prompt 5 (chip_smoke phase 23)
    (4, 64, 8, 4, 128, True, None, None), (16, 5, 8, 4, 128, True, None, None),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_cuda(B, S, H, KV, hd, causal, window, cap, dtype):
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(0)
    dt = DT[dtype]
    q, k, v = (torch.randn(s, generator=g, device=dev).to(dt) for s in
               ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)))
    out = t_flash.flash_attention(q, k, v, causal=causal, window=window,
                                  cap=cap)
    ref = t_flash.flash_attention_plain(q, k, v, causal=causal,
                                        window=window, cap=cap)
    torch.cuda.synchronize()
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               ref.float().cpu().numpy(), **tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KV,hd,L,cap", [
    (2, 4, 2, 64, 300, None), (1, 8, 8, 80, 512, 30.0),
    (16, 16, 8, 128, 320, None), (3, 4, 1, 128, 1000, 30.0),
    (16, 64, 8, 128, 320, None),                # jamba's heads: GQA 8
    # a decode step per rank of the same meshes (phase 23)
    (4, 8, 4, 128, 80, None), (16, 8, 4, 128, 9, None),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_cuda(B, H, KV, hd, L, cap, dtype):
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(0)
    dt = DT[dtype]
    q, k, v = (torch.randn(s, generator=g, device=dev).to(dt) for s in
               ((B, H, hd), (B, L, KV, hd), (B, L, KV, hd)))
    keep = torch.rand((B, L), generator=g, device=dev) < 0.75
    bias = torch.where(keep, 0.0, -1e30).float()
    out = t_decode.decode_attention(q, k, v, bias, cap=cap)
    ref = t_decode.decode_attention_plain(q, k, v, bias, cap=cap)
    torch.cuda.synchronize()
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               ref.float().cpu().numpy(), **tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("S,hd,window", [(1, 64, None), (64, 32, None),
                                         (65, 48, 1), (129, 96, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_cuda_edges(S, hd, window, dtype):
    """Sequence lengths at and around the 64-row tile, head dims below and
    between the 64-column panels, and the narrowest window (a row attends
    to itself only), on the CUDA-core (fp32) and tensor-core (bf16)
    kernels."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(1)
    q, k, v = (torch.randn(s, generator=g, device=dev).to(DT[dtype]) for s in
               ((2, S, 4, hd), (2, S, 2, hd), (2, S, 2, hd)))
    out = t_flash.flash_attention(q, k, v, causal=True, window=window)
    ref = t_flash.flash_attention_plain(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               ref.float().cpu().numpy(), **tol(dtype))


@pytest.mark.cuda
def test_flash_attention_cuda_counts_tensor_core_launches():
    """bf16 takes the tensor-core kernel and fp32 the CUDA-core one, as
    the CUDA source reports each launch; the wrapper counts every launch
    and the tensor-core ones apart."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(8)
    for dtype, tc in (("bfloat16", 1), ("float32", 0)):
        q, k, v = (torch.randn((1, 70, 4, 64), generator=g,
                               device=dev).to(DT[dtype]) for _ in range(3))
        n, n_tc = t_flash.launches, t_flash.launches_tc
        t_flash.flash_attention(q, k, v)
        assert (t_flash.launches, t_flash.launches_tc) == (n + 1, n_tc + tc)


@pytest.mark.cuda
@pytest.mark.parametrize("L", [1, 64, 65, 200])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_cuda_edges(L, dtype):
    """L at and around the tile, and a row whose every entry is masked:
    the finite NEG_INF makes it a uniform average over exactly L keys."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(2)
    B, H, KV, hd = 3, 16, 1, 64
    dt = DT[dtype]
    q = torch.randn((B, H, hd), generator=g, device=dev).to(dt)
    k, v = (torch.randn((B, L, KV, hd), generator=g, device=dev).to(dt)
            for _ in range(2))
    bias = torch.zeros((B, L), device=dev)
    bias[1] = -1e30
    bias[2, L // 2:] = -1e30
    out = t_decode.decode_attention(q, k, v, bias)
    ref = t_decode.decode_attention_plain(q, k, v, bias)
    torch.cuda.synchronize()
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               ref.float().cpu().numpy(), **tol(dtype))
    torch.testing.assert_close(out[1].float(),
                               v[1].float().mean(0).expand(H, hd),
                               **tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_cuda_many_splits(dtype):
    """One (b, kv head) pair and a long cache: the plan cuts L into many
    splits, which the last block to finish combines in the same launch;
    a second call finds the tickets reset."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(9)
    B, H, KV, hd, L = 1, 8, 1, 128, 4096
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert t_decode.plan(B, H, KV, L, hd, sms).splits > 16
    dt = DT[dtype]
    q = torch.randn((B, H, hd), generator=g, device=dev).to(dt)
    k, v = (torch.randn((B, L, KV, hd), generator=g, device=dev).to(dt)
            for _ in range(2))
    keep = torch.rand((B, L), generator=g, device=dev) < 0.5
    bias = torch.where(keep, 0.0, -1e30).float()
    ref = t_decode.decode_attention_plain(q, k, v, bias)
    for _ in range(2):
        out = t_decode.decode_attention(q, k, v, bias)
        torch.cuda.synchronize()
        np.testing.assert_allclose(out.float().cpu().numpy(),
                                   ref.float().cpu().numpy(), **tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_kernels_at_head_dim_16_cuda(dtype):
    """Head dim 16 (``examples/trace_obs.py``'s actor: d 32, 2 heads): the
    flash kernel causal, windowed and non-causal at trace_obs's GEN
    prefill and INF shapes and at a tile-crossing S, and the decode
    kernel with one and many splits, each against its plain version; a
    head dim above the kernels' 256 still raises on a CUDA tensor."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(16)
    dt = DT[dtype]
    for B, S, H, KV, causal, window in [(4, 5, 2, 2, True, None),
                                        (4, 8, 2, 2, True, None),
                                        (3, 130, 4, 2, True, 64),
                                        (2, 77, 2, 2, False, None)]:
        q, k, v = (torch.randn(s, generator=g, device=dev).to(dt) for s in
                   ((B, S, H, 16), (B, S, KV, 16), (B, S, KV, 16)))
        out = t_flash.flash_attention(q, k, v, causal=causal, window=window)
        ref = t_flash.flash_attention_plain(q, k, v, causal=causal,
                                            window=window)
        torch.cuda.synchronize()
        np.testing.assert_allclose(out.float().cpu().numpy(),
                                   ref.float().cpu().numpy(), **tol(dtype))
    for B, H, KV, L in [(4, 2, 2, 8), (3, 4, 2, 300), (1, 8, 1, 4096)]:
        q = torch.randn((B, H, 16), generator=g, device=dev).to(dt)
        k, v = (torch.randn((B, L, KV, 16), generator=g, device=dev).to(dt)
                for _ in range(2))
        keep = torch.rand((B, L), generator=g, device=dev) < 0.75
        keep[:, 0] = True
        bias = torch.where(keep, 0.0, -1e30).float()
        out = t_decode.decode_attention(q, k, v, bias)
        ref = t_decode.decode_attention_plain(q, k, v, bias)
        torch.cuda.synchronize()
        np.testing.assert_allclose(out.float().cpu().numpy(),
                                   ref.float().cpu().numpy(), **tol(dtype))
    q = torch.zeros((1, 8, 2, 257), device=dev, dtype=dt)
    with pytest.raises(ValueError, match="head dim"):
        t_flash.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="head dim"):
        t_decode.decode_attention(q[:, 0], q, q,
                                  torch.zeros((1, 8), device=dev))


def test_wrappers_reject_what_the_kernels_do_not_take():
    """Checks run before any build or launch (so they hold on the CPU
    too, through the wrappers' validators): a head dim above 256 (40
    and 256 pass), a strided or half tensor, a bias of the wrong shape
    or dtype."""
    for hd in (40, 256):
        q = torch.zeros((1, 4, 2, hd))
        t_flash._check(q, q, q)
        t_decode._check(q[:, 0], q, q, torch.zeros((1, 4)))
    q = torch.zeros((1, 4, 2, 257))
    with pytest.raises(ValueError, match="head dim"):
        t_flash._check(q, q, q)
    with pytest.raises(ValueError, match="head dim"):
        t_decode._check(q[:, 0], q, q, torch.zeros((1, 4)))
    with pytest.raises(ValueError, match="contiguous"):
        qt = torch.zeros((1, 2, 4, 64)).transpose(1, 2)
        t_flash._check(qt, qt, qt)
    with pytest.raises(TypeError):
        t_flash._check(q.half(), q.half(), q.half())
    k = torch.zeros((1, 8, 2, 64))
    with pytest.raises(ValueError, match="bias"):
        t_decode._check(torch.zeros((1, 4, 64)), k, k, torch.zeros((1, 7)))
    with pytest.raises(TypeError, match="bias"):
        t_decode._check(torch.zeros((1, 4, 64)), k, k,
                        torch.zeros((1, 8), dtype=torch.float64))


# chip_smoke.py phase 28 (b): head dims of every instantiated width and
# between them, and rows that are no multiple of 16 bytes (7, 12, 130,
# 201, 255), which decode copies element by element (fp32 above 128: two
# vectors a lane) and whose bf16 rows the flash wrapper pads
SWEEP_HEAD_DIMS = (7, 8, 12, 24, 40, 72, 112, 130, 136, 160, 192, 200, 201,
                   255, 256)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", SWEEP_HEAD_DIMS)
def test_attention_kernels_at_every_head_dim_cuda(hd, dtype):
    """Both attention kernels against their plain versions at head dims
    from 7 to 256: flash causal, windowed and softcapped, decode with
    one split and with many; the flash wrapper pads a copy only for bf16
    rows that are no multiple of 8 (hd 7, 12, 130, 201, 255 here), the
    decode wrapper never."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(hd)
    dt = DT[dtype]
    for B, S, H, KV, window, cap in [(2, 150, 4, 2, None, None),
                                     (2, 150, 4, 2, 48, None),
                                     (1, 77, 4, 1, 40, 50.0)]:
        q, k, v = (torch.randn((B, S, n, hd), generator=g, device=dev)
                   .to(dt) for n in (H, KV, KV))
        n = t_flash.launches_padded
        out = t_flash.flash_attention(q, k, v, window=window, cap=cap)
        ref = t_flash.flash_attention_plain(q, k, v, window=window, cap=cap)
        torch.cuda.synchronize()
        assert out.shape == q.shape and out.is_contiguous()
        np.testing.assert_allclose(out.float().cpu().numpy(),
                                   ref.float().cpu().numpy(), **tol(dtype))
        assert t_flash.launches_padded - n == int(
            dtype == "bfloat16" and hd % 8 != 0)
    for B, H, KV, L in [(4, 4, 2, 300), (1, 8, 1, 2000)]:
        q = torch.randn((B, H, hd), generator=g, device=dev).to(dt)
        k, v = (torch.randn((B, L, KV, hd), generator=g, device=dev).to(dt)
                for _ in range(2))
        keep = torch.rand((B, L), generator=g, device=dev) < 0.75
        keep[:, 0] = True
        bias = torch.where(keep, 0.0, -1e30).float()
        for cap in (None, 30.0):
            out = t_decode.decode_attention(q, k, v, bias, cap=cap)
            ref = t_decode.decode_attention_plain(q, k, v, bias, cap=cap)
            torch.cuda.synchronize()
            np.testing.assert_allclose(out.float().cpu().numpy(),
                                       ref.float().cpu().numpy(),
                                       **tol(dtype))


def _rwkv_inputs(g, dev, B, S, H, N, decay_shift=-1.0):
    """``tests/test_kernels.py``'s distribution: r, k, v ~ N(0, 1),
    logw = -exp(0.5 N(0, 1) + decay_shift), u = 0.5 N(0, 1)."""
    r, k, v = (torch.randn((B, S, H, N), generator=g, device=dev)
               for _ in range(3))
    logw = -torch.exp(torch.randn((B, S, H, N), generator=g, device=dev)
                      * 0.5 + decay_shift)
    u = torch.randn((H, N), generator=g, device=dev) * 0.5
    return r, k, v, logw, u


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 63, 65, 100, 256])
@pytest.mark.parametrize("N", [32, 64, 128])
def test_rwkv6_scan_cuda(N, S):
    """Sequence lengths at and around the 64-position chunk, every
    instantiated head dim, B 1 and 3."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(3)
    for B in (1, 3):
        ins = _rwkv_inputs(g, dev, B, S, 2, N)
        y, st = t_rwkv.rwkv6_scan(*ins)
        yr, sr = t_rwkv.rwkv6_scan_plain(*ins)
        torch.cuda.synchronize()
        torch.testing.assert_close(y, yr, rtol=2e-3, atol=2e-3)
        torch.testing.assert_close(st, sr, rtol=2e-3, atol=2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [150, 77])
@pytest.mark.parametrize("chunk", [16, 32, 64])
@pytest.mark.parametrize("decay_shift", [-1.0, 3.0])
def test_rwkv6_scan_cuda_chunks_and_strong_decay(chunk, decay_shift, S):
    """Every chunk gives the same function, S is no multiple of the
    16-position sub-chunk, and a decay strong enough that a factored
    exp(cum_ex) * exp(-cum) would overflow (logw about -20 at shift 3)
    stays finite and exact."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(4)
    ins = _rwkv_inputs(g, dev, 2, S, 3, 64, decay_shift)
    y, st = t_rwkv.rwkv6_scan(*ins, chunk=chunk)
    yr, sr = t_rwkv.rwkv6_scan_plain(*ins)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all())
    torch.testing.assert_close(y, yr, rtol=2e-3, atol=2e-3)
    torch.testing.assert_close(st, sr, rtol=2e-3, atol=2e-3)


@pytest.mark.cuda
def test_rwkv6_scan_cuda_raises_on_what_the_kernel_does_not_take():
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(5)
    r, k, v, logw, u = _rwkv_inputs(g, dev, 1, 8, 2, 64)
    with pytest.raises(ValueError, match="one device"):
        t_rwkv.rwkv6_scan(r, k, v, logw, u.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        t_rwkv.rwkv6_scan(r.transpose(1, 2).contiguous().transpose(1, 2),
                          k, v, logw, u)
    with pytest.raises(TypeError, match="float32"):
        t_rwkv.rwkv6_scan(r.bfloat16(), k, v, logw, u)
    with pytest.raises(ValueError, match="chunk"):
        t_rwkv.rwkv6_scan(r, k, v, logw, u, chunk=48)
    big = _rwkv_inputs(g, dev, 1, 8, 1, 129)
    n = t_rwkv.launches
    with pytest.raises(ValueError, match="head dim 129"):
        t_rwkv.rwkv6_scan(*big)
    assert t_rwkv.launches == n
    t_rwkv.rwkv6_scan(r, k, v, logw, u)
    assert t_rwkv.launches == n + 1


@pytest.mark.cuda
@pytest.mark.parametrize("N", [16, 48, 96])
def test_rwkv6_scan_cuda_padded_head_sizes(N):
    """Head sizes between the instantiated 32, 64 and 128 (chip_smoke.py
    phase 28 (c)): the wrapper pads a copy to the next one and slices y
    and the state back."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(N)
    ins = _rwkv_inputs(g, dev, 2, 100, 3, N)
    n = t_rwkv.launches_padded
    y, st = t_rwkv.rwkv6_scan(*ins)
    yr, sr = t_rwkv.rwkv6_scan_plain(*ins)
    torch.cuda.synchronize()
    assert t_rwkv.launches_padded == n + 1
    assert y.shape == (2, 100, 3, N) and st.shape == (2, 3, N, N)
    torch.testing.assert_close(y, yr, rtol=2e-3, atol=2e-3)
    torch.testing.assert_close(st, sr, rtol=2e-3, atol=2e-3)


def test_rwkv_wrapper_rejects_what_the_kernel_does_not_take():
    """The wrapper's checks, which run before any build or launch: every
    head size up to 128 passes (48 and 128 here), 129 is refused."""
    x = torch.zeros((1, 8, 2, 64))
    u = torch.zeros((2, 64))
    t_rwkv._check(x, x, x, x, u)
    for n in (48, 128):
        y = torch.zeros((1, 8, 2, n))
        t_rwkv._check(y, y, y, y, torch.zeros((2, n)))
    with pytest.raises(ValueError, match="head dim"):
        y = torch.zeros((1, 8, 2, 129))
        t_rwkv._check(y, y, y, y, torch.zeros((2, 129)))
    with pytest.raises(ValueError, match="contiguous"):
        xt = torch.zeros((1, 2, 8, 64)).transpose(1, 2)
        t_rwkv._check(xt, x, x, x, u)
    with pytest.raises(TypeError, match="float32"):
        t_rwkv._check(x.double(), x, x, x, u)
    with pytest.raises(ValueError, match="u "):
        t_rwkv._check(x, x, x, x, torch.zeros((3, 64)))
    with pytest.raises(ValueError, match="shapes"):
        t_rwkv._check(x, x[:, :4], x, x, u)
    with pytest.raises(ValueError, match="aligned"):
        flat = torch.zeros(1 + x.numel())
        t_rwkv._check(flat[1:].view(x.shape), x, x, x, u)


def _mamba_inputs(g, dev, B, S, di, ds):
    """``tests/test_kernels.py``'s distribution: dt = softplus(N(0,1) - 1),
    x, Bm, Cm ~ N(0, 1), A = -exp(0.3 N(0, 1))."""
    n = lambda *s: torch.randn(s, generator=g, device=dev)
    return (torch.nn.functional.softplus(n(B, S, di) - 1), n(B, S, di),
            n(B, S, ds), n(B, S, ds), -torch.exp(n(di, ds) * 0.3))


@pytest.mark.cuda
@pytest.mark.parametrize("ds,S", [(ds, S) for ds in (8, 16)
                                  for S in (1, 63, 65, 256)] + [(16, 2048)])
def test_mamba_scan_cuda(ds, S):
    """Sequence lengths around the 16-step tile and a long one (2048
    steps, for the base-2 approximate exponential), both instantiated
    state dims, and d_inner a multiple of the 128-channel block and
    not."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(6)
    for B, di in ((2, 256), (3, 200)):
        ins = _mamba_inputs(g, dev, B, S, di, ds)
        y, h = t_mamba.mamba_scan(*ins)
        yr, hr = t_mamba.mamba_scan_plain(*ins)
        torch.cuda.synchronize()
        torch.testing.assert_close(y, yr, rtol=1e-3, atol=1e-3)
        torch.testing.assert_close(h, hr, rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("di", [256, 198])
def test_mamba_scan_cuda_underflow(di):
    """dt * A down to -30 and below, where exp underflows: the kernel's
    exponential flushes to 0 as the plain version's does.  di 198 is no
    multiple of 4, so the 4-byte copy path runs."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(7)
    dt, x, Bm, Cm, A = _mamba_inputs(g, dev, 2, 100, di, 16)
    dt = dt * 10.0 + 1.0
    A = A * 10.0
    assert float((dt[:, :, :, None] * A).min()) <= -30.0
    y, h = t_mamba.mamba_scan(dt, x, Bm, Cm, A)
    yr, hr = t_mamba.mamba_scan_plain(dt, x, Bm, Cm, A)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
    torch.testing.assert_close(y, yr, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(h, hr, rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
def test_mamba_scan_cuda_raises_on_what_the_kernel_does_not_take():
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(7)
    dt, x, Bm, Cm, A = _mamba_inputs(g, dev, 1, 8, 128, 16)
    with pytest.raises(ValueError, match="one device"):
        t_mamba.mamba_scan(dt, x, Bm, Cm, A.cpu())
    with pytest.raises(TypeError, match="float32"):
        t_mamba.mamba_scan(dt.bfloat16(), x, Bm, Cm, A)
    with pytest.raises(ValueError, match="contiguous"):
        t_mamba.mamba_scan(dt, x, Bm.transpose(1, 2).contiguous()
                           .transpose(1, 2), Cm, A)
    big = _mamba_inputs(g, dev, 1, 8, 128, 33)
    n = t_mamba.launches
    with pytest.raises(ValueError, match="state dim 33"):
        t_mamba.mamba_scan(*big)
    assert t_mamba.launches == n
    t_mamba.mamba_scan(dt, x, Bm, Cm, A)
    assert t_mamba.launches == n + 1


@pytest.mark.cuda
@pytest.mark.parametrize("ds", [4, 12, 24, 32])
def test_mamba_scan_cuda_state_sizes(ds):
    """State sizes to 32 (chip_smoke.py phase 28 (c)): 32 instantiated,
    4, 12 and 24 padded to 8, 16 and 32 with h_end sliced back."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(ds)
    ins = _mamba_inputs(g, dev, 2, 100, 200, ds)
    n = t_mamba.launches_padded
    y, h = t_mamba.mamba_scan(*ins)
    yr, hr = t_mamba.mamba_scan_plain(*ins)
    torch.cuda.synchronize()
    assert t_mamba.launches_padded == n + int(ds != 32)
    assert h.shape == (2, 200, ds)
    torch.testing.assert_close(y, yr, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(h, hr, rtol=1e-3, atol=1e-3)


def test_mamba_wrapper_rejects_what_the_kernel_does_not_take():
    """The wrapper's checks, which run before any build or launch: every
    state size up to 32 passes (4 and 32 here), 33 is refused."""
    x = torch.zeros((2, 8, 64))
    bc = torch.zeros((2, 8, 16))
    a = torch.zeros((64, 16))
    t_mamba._check(x, x, bc, bc, a)
    for n in (4, 32):
        b4 = torch.zeros((2, 8, n))
        t_mamba._check(x, x, b4, b4, torch.zeros((64, n)))
    with pytest.raises(ValueError, match="state dim"):
        b4 = torch.zeros((2, 8, 33))
        t_mamba._check(x, x, b4, b4, torch.zeros((64, 33)))
    with pytest.raises(ValueError, match="contiguous"):
        t_mamba._check(torch.zeros((2, 64, 8)).transpose(1, 2), x, bc, bc, a)
    with pytest.raises(TypeError, match="float32"):
        t_mamba._check(x.double(), x, bc, bc, a)
    with pytest.raises(ValueError, match="A "):
        t_mamba._check(x, x, bc, bc, torch.zeros((32, 16)))
    with pytest.raises(ValueError, match="shapes"):
        t_mamba._check(x, x[:, :4], bc, bc, a)
    with pytest.raises(ValueError, match="shapes Bm"):
        t_mamba._check(x, x, bc[:, :4], bc[:, :4], a)


# ---------------------------------------------------------------------------
# autograd through the kernels is refused; the RL iteration on the card
# ---------------------------------------------------------------------------

def test_refuse_grad_guard():
    """The guard every CUDA wrapper calls before it launches (it runs
    before any build, so it holds on the CPU too)."""
    from repro_torch.kernels.guard import refuse_grad
    x = torch.zeros(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        refuse_grad("k", torch.zeros(3), x)
    with torch.no_grad():
        refuse_grad("k", x)
    with torch.inference_mode():
        refuse_grad("k", x)
    refuse_grad("k", torch.zeros(3), None)


def _grad_cases(dev):
    g = torch.Generator(device=dev).manual_seed(0)

    def rn(*shape):
        return torch.randn(shape, generator=g, device=dev)
    q, k = rn(1, 16, 4, 64), rn(1, 16, 2, 64)
    qd, kd = rn(2, 4, 64), rn(2, 16, 2, 64)
    bias = torch.zeros((2, 16), device=dev)
    r, kk, v, logw, u = _rwkv_inputs(g, dev, 1, 16, 2, 64)
    dt = torch.rand((1, 16, 64), generator=g, device=dev) * 0.1
    x, bm = rn(1, 16, 64), rn(1, 16, 16)
    a = -torch.rand((64, 16), generator=g, device=dev)
    return {"flash_attention": (t_flash.flash_attention, (q, k, k)),
            "decode_attention": (t_decode.decode_attention,
                                 (qd, kd, kd, bias)),
            "rwkv6_scan": (t_rwkv.rwkv6_scan, (r, kk, v, logw, u)),
            "mamba_scan": (t_mamba.mamba_scan, (dt, x, bm, bm, a))}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["flash_attention", "decode_attention",
                                  "rwkv6_scan", "mamba_scan"])
def test_wrappers_refuse_autograd_on_the_card(name):
    """Under grad mode an input that requires grad raises (the kernel's
    output would carry no grad_fn); under no_grad / inference_mode the
    same call launches."""
    dev = _cuda()
    fn, args = _grad_cases(dev)[name]
    leaky = [args[0].clone().requires_grad_(True)] + list(args[1:])
    with pytest.raises(RuntimeError, match="no backward"):
        fn(*leaky)
    with torch.no_grad():
        fn(*leaky)
    with torch.inference_mode():
        fn(*args)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_ppo_iteration_on_the_card_matches_cpu():
    """One greedy PPO iteration of the qwen3 smoke (vocab 16, fp32) on the
    card against the same on the CPU from the same state: identical
    tokens, log-probs and losses within 2e-4; GEN and INF launch both
    attention kernels, TRAIN none."""
    import dataclasses
    from repro_torch import bridge
    from repro_torch.configs.archs import SMOKE
    from repro_torch.data.synthetic import AdditionTask, PromptDataset
    from repro_torch.rl.trainer import RLConfig, RLTrainer
    dev = _cuda()
    cfg = dataclasses.replace(SMOKE["qwen3-0.6b"], vocab_size=16,
                              dtype="float32")
    rl = RLConfig(algorithm="ppo", n_rollouts=4, max_new_tokens=3,
                  greedy=True, lr=1e-3)
    cpu = RLTrainer(cfg, rl, AdditionTask(9), seed=0, device="cpu")
    card = RLTrainer(cfg, rl, AdditionTask(9), seed=0, device=dev)
    card.load_state_tree(bridge.from_numpy_state_tree(
        bridge.to_numpy_state_tree(cpu.state_tree()), cfg, dev))
    counts = []
    orig = card.before_stage

    def hook(stage, bb):
        counts.append((stage[0].kind.name, t_flash.launches,
                       t_decode.launches))
        return orig(stage, bb)
    card.before_stage = hook
    prompts, answers = next(iter(PromptDataset(AdditionTask(9), batch=4,
                                               seed=1)))
    m_cpu = cpu.iteration(prompts, answers, None)
    t_flash.launches = t_decode.launches = 0
    m_card = card.iteration(prompts, answers, None)
    counts.append(("END", t_flash.launches, t_decode.launches))
    for k in ("reward_mean", "kl", "loss", "critic_loss", "grad_norm",
              "gen_len"):
        np.testing.assert_allclose(m_card[k], m_cpu[k], rtol=2e-4,
                                   atol=2e-4)
    kinds = [c[0] for c in counts]
    assert kinds == ["GEN", "INF", "TRAIN", "END"]
    (_, f0, d0), (_, f1, d1), (_, f2, d2), (_, f3, d3) = counts
    assert f1 > f0 == 0 and d1 > d0 == 0            # GEN: prefill + decode
    assert f2 > f1 and d2 == d1                     # INF: forward only
    assert (f3, d3) == (f2, d2)                     # TRAIN: no kernel


@pytest.mark.cuda
def test_checkpoint_round_trip_on_the_card_is_bit_exact(tmp_path):
    """fp32, bf16 and int32 leaves on the card -> file -> the card, bit for
    bit, on the ``like`` leaves' device and dtype."""
    from repro_torch.checkpoint import io as ckpt_io
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(0)
    tree = {"w": torch.randn((257, 129), generator=g, device=dev),
            "h": torch.randn((64, 3), generator=g, device=dev).to(
                torch.bfloat16),
            "n": torch.arange(11, dtype=torch.int32, device=dev),
            "t": (torch.randn((5,), generator=g, device=dev), None)}
    p = str(tmp_path / "card.msgpack")
    assert ckpt_io.save(p, tree) > 0
    like = {"w": torch.zeros((257, 129), device=dev),
            "h": torch.zeros((64, 3), dtype=torch.bfloat16, device=dev),
            "n": torch.zeros(11, dtype=torch.int32, device=dev),
            "t": (torch.zeros(5, device=dev), None)}
    got = ckpt_io.restore(p, like)
    for a, b in ((got["w"], tree["w"]), (got["h"], tree["h"]),
                 (got["n"], tree["n"]), (got["t"][0], tree["t"][0])):
        assert a.device.type == "cuda" and a.dtype == b.dtype
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                           else a, b.view(torch.int16)
                           if b.dtype == torch.bfloat16 else b)


@pytest.mark.cuda
def test_checkpoint_over_the_cap_raises_on_the_card(tmp_path):
    """A tree over 4 GiB on the card (2 x 2.1 GB fp32) raises before any
    copy or file."""
    from repro_torch.checkpoint import io as ckpt_io
    dev = _cuda()
    tree = {"a": torch.zeros(2**29 + 2**20, device=dev),
            "b": torch.zeros(2**29, device=dev)}
    p = str(tmp_path / "big.msgpack")
    with pytest.raises(ckpt_io.CheckpointError, match="4 GiB"):
        ckpt_io.save(p, tree)
    assert not tmp_path.joinpath("big.msgpack").exists()
    assert not tmp_path.joinpath("big.msgpack.tmp").exists()


@pytest.mark.cuda
def test_drift_swap_on_the_card_launches_the_kernels():
    """GRPO at qwen3-0.6b's width cut to 2 layers (vocab 16, fp32) under a
    ``drop_tail`` drift: the controller swaps the plan, and GEN and INF
    launch both attention kernels in every iteration, before and after
    the swap."""
    import dataclasses
    from repro_torch.configs import archs
    from repro_torch.core import topology, workflow
    from repro_torch.core.sha import HybridScheduler
    from repro_torch.data.synthetic import AdditionTask, PromptDataset
    from repro_torch.engine.elastic import ElasticConfig, ElasticController
    from repro_torch.rl.trainer import RLConfig, RLTrainer
    dev = _cuda()
    full = archs.get("qwen3-0.6b")
    cfg = dataclasses.replace(full, n_layers=2, pattern=full.pattern,
                              vocab_size=16, dtype="float32")
    task = AdditionTask(max_operand=9)
    topo = topology.build_testbed("single_region",
                                  counts={"A100": 4, "L4": 4})
    wf = workflow.make_workflow("grpo", workflow.LLMSpec.from_model_config(
        cfg), synchronous=True, global_batch=8, n_rollouts=4,
        seq_in=task.prompt_len, seq_out=task.max_answer_len)
    plan = HybridScheduler(topo, wf, max_groupings=8,
                           max_sizes_per_grouping=4).search(budget=60).plan
    tr = RLTrainer(cfg, RLConfig(algorithm="grpo", n_rollouts=4,
                                 max_new_tokens=task.max_answer_len),
                   task, seed=0, plan=plan, topo=topo, wf=wf, device=dev)
    ctrl = ElasticController(tr, topology.drift_scenario("drop_tail", topo,
                                                         at=1),
                             ElasticConfig(budget=60, ckpt_dir=None))
    ds = iter(PromptDataset(task, batch=8, seed=1))
    rng = torch.Generator(device=dev).manual_seed(0)
    per_iter = []
    for it in range(3):
        t_flash.launches = t_decode.launches = 0
        tr.iteration(*next(ds), rng)
        per_iter.append((tr.engine.epoch, t_flash.launches,
                         t_decode.launches))
        ctrl.poll(it)
    assert tr.engine.epoch == 1 and len(ctrl.swaps) == 1
    assert [e for e, _, _ in per_iter] == [0, 0, 1]
    assert all(f > 0 and d > 0 for _, f, d in per_iter), per_iter
    assert [r["epoch"] for r in tr.engine.epoch_report()] == [0, 1]


@pytest.mark.cuda
def test_ranks_share_the_card_over_gloo():
    """Two ranks on ``cuda:0`` over gloo (NCCL refuses two ranks on one
    card) run every collective sharded execution needs
    (``parallel.dist.probe_collectives``; DTensor's all-gathers go
    through the plain collective there, ``dist.use_sync_all_gather``)."""
    _cuda()
    from repro_torch.parallel import dist
    res = dist.probe_collectives("cuda", 2)
    assert dist.probe_ok(res), res


@pytest.mark.cuda
def test_kernel_wrappers_on_dtensors_cuda():
    """The four kernels on DTensors over 4 ranks sharing the card, each
    rank launching on its local rows and heads or channels, against the
    plain versions on the full inputs (tolerances as above)."""
    _cuda()
    import torch_sharded_ranks as ranks
    from repro_torch.kernels import build
    from repro_torch.parallel import dist
    build.build()
    res = dist.spawn(ranks.kernels_rank, 4, "cuda", timeout=300)
    tols = {"flash_attention": 2e-4, "decode_attention": 2e-4,
            "rwkv6_scan": 2e-3, "mamba_scan": 1e-3}
    for r in res:
        for name, (err, placements) in r.items():
            assert err <= tols[name], (name, err)
            assert placements.startswith("(Shard(dim=0), Shard(dim=")



@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_serve_steps_kernels_against_plain(dtype):
    """``launch.steps``' prefill and serve steps (qwen3-0.6b's first 2
    layers at full width) with the kernels against the same steps on the
    plain attention: last-position and decode logits within the
    attention tolerance; each step launches its kernel once per layer."""
    import dataclasses
    from repro_torch.configs import archs
    from repro_torch.launch import steps
    from repro_torch.models import attention as attn
    from repro_torch.models import cache as cache_mod
    from repro_torch.models import transformer as T
    dev = _cuda()
    cfg = archs.get("qwen3-0.6b")
    cfg = dataclasses.replace(cfg, n_layers=2, pattern=cfg.pattern[:2],
                              dtype=dtype)
    params = T.init_params(cfg, seed=0, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 300),
                                     generator=g, device=dev)}
    nxt_tok = torch.randint(0, cfg.vocab_size, (2, 1), generator=g,
                            device=dev)
    prefill = steps.make_prefill_step(cfg, max_cache_len=320)
    serve = steps.make_serve_step(cfg)

    def run(impl):
        attn.set_attention_impl(impl)
        try:
            t_flash.launches = t_decode.launches = 0
            last, cache = prefill(params, batch)
            nxt = {"tokens": nxt_tok, "cache": cache}
            logits, _ = serve(params, nxt)
            torch.cuda.synchronize()
            return last, logits, (t_flash.launches, t_decode.launches)
        finally:
            attn.set_attention_impl("kernel")
    k_last, k_logits, k_n = run("kernel")
    p_last, p_logits, p_n = run("plain")
    assert k_n == (2, 2) and p_n == (0, 0)
    np.testing.assert_allclose(k_last.float().cpu(), p_last.float().cpu(),
                               **tol(dtype))
    np.testing.assert_allclose(k_logits.float().cpu(),
                               p_logits.float().cpu(), **tol(dtype))


@pytest.mark.cuda
def test_device_spans_and_ttft_events_on_the_card(monkeypatch):
    """A ``device_span`` around a spin kernel covers the kernel's
    profiler interval (both on the host's ``perf_counter`` clock, the
    profiler's by a marker spin as ``bench/harness/devtrace.py`` puts it
    there) within 50 us at each end.  Then a small one-shot engine batch
    whose TTFT events are also waited for as they are recorded: each
    admit's event stamp agrees with the host stamp taken after that
    wait (the sync-per-admit stamp) within 1 ms."""
    import time
    from repro_torch.configs import archs
    from repro_torch.genserve.decoder import GenServeConfig, serve
    from repro_torch.models import transformer as T
    from repro_torch.obs import trace as obs_trace
    dev = _cuda()
    torch.cuda.synchronize(dev)
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    # the first launches under a fresh profiler may wait on its set-up:
    # spins before the marker
    for _ in range(3):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize(dev)
    mark = time.perf_counter()
    torch.cuda._sleep(1000)
    torch.cuda.synchronize(dev)
    tr = obs_trace.Tracer()
    tr.enable()
    try:
        with tr.device_span("spin", dev):
            torch.cuda._sleep(2_000_000)
        torch.cuda.synchronize(dev)
    finally:
        prof.stop()
    spins = sorted((e for e in prof.profiler.kineto_results.events()
                    if e.device_type() == torch.autograd.DeviceType.CUDA
                    and "spin_kernel" in e.name()),
                   key=lambda e: e.start_ns())
    assert len(spins) == 5, [e.name() for e in spins]
    offset = spins[3].start_ns() * 1e-9 - mark
    k0 = spins[4].start_ns() * 1e-9 - offset
    k1 = k0 + spins[4].duration_ns() * 1e-9
    [(name, h0, h1, d0, d1, _)] = tr.device_spans()
    assert name == "spin" and k1 - k0 > 5e-4
    assert abs(d0 - k0) <= 50e-6 and abs(d1 - k1) <= 50e-6, \
        (d0 - k0, d1 - k1)

    stamps = []

    class WaitedClock(obs_trace.DeviceClock):
        def record(self):
            ev = super().record()
            if hasattr(self, "host"):             # an admit's stamp
                torch.cuda.synchronize(self.device)
                stamps.append((self, ev, time.perf_counter()))
            return ev
    monkeypatch.setattr(obs_trace, "DeviceClock", WaitedClock)
    cfg = archs.SMOKE["qwen3-0.6b"]
    params = T.init_params(cfg, seed=0, device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (6, 16), device=dev,
                            generator=torch.Generator(dev).manual_seed(0))
    _, stats = serve(params, cfg, prompts, None, GenServeConfig(
        wave=2, max_new_tokens=8, greedy=True, measure_ttft=True),
        gen_lens=[8, 2, 5, 8, 3, 6])
    assert len(stamps) == stats["prefills"] >= 3
    for clock, ev, host in stamps:
        assert abs(clock.at(ev) - host) <= 1e-3, clock.at(ev) - host
    by_admit = sorted(set(stats["ttft"].values()))
    assert len(by_admit) == len(stamps)
    for got, (_, _, host) in zip(by_admit, stamps):
        assert abs((got - by_admit[0]) - (host - stamps[0][2])) <= 1e-3


@pytest.mark.cuda
def test_admit_over_the_admitted_rows_on_the_card(monkeypatch):
    """The bf16 smoke qwen3-0.6b engine at wave 8, slots recycled: each
    one-shot admit prefills its admitted rows alone, and its first tokens
    are the whole-wave forward's greedy tokens for the same prompts (the
    first prompt in the free slots), its slots' cache rows within the
    bf16 tolerance."""
    import dataclasses
    from repro_torch.configs import archs
    from repro_torch.genserve import decoder
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves
    dev = _cuda()
    cfg = dataclasses.replace(archs.SMOKE["qwen3-0.6b"], dtype="bfloat16")
    params = T.init_params(cfg, seed=0, device=dev)
    W, P, N, B = 8, 32, 6, 20
    prompts = torch.randint(0, cfg.vocab_size, (B, P), device=dev,
                            generator=torch.Generator(dev).manual_seed(0))
    seen = []
    admit = decoder._Programs.admit

    def spy(self, params, dparams, st, pb, slots, rows, limits, gen):
        n = admit(self, params, dparams, st, pb, slots, rows, limits, gen)
        idx = slots.to(dev)
        seen.append((n, pb.clone(), idx, st["tok"][idx].clone(),
                     [leaf[:, idx].clone()
                      for leaf in tree_leaves(st["cache"])]))
        return n
    monkeypatch.setattr(decoder._Programs, "admit", spy)
    with torch.no_grad():
        _, stats = decoder.serve(
            params, cfg, prompts, None, decoder.GenServeConfig(
                wave=W, max_new_tokens=N, greedy=True),
            gen_lens=[1 + i % N for i in range(B)])
        assert len(seen) == stats["prefills"] >= 3
        assert stats["prefill_rows"] == stats["admitted"] == B
        for n, pb, idx, tok0, rows in seen:
            assert n == len(pb) == len(idx)
            wave = pb[:1].repeat(W, 1)
            wave[idx] = pb
            ref = T.forward(params, cfg, {"tokens": wave},
                            return_cache=True, max_cache_len=P + N)
            assert torch.equal(tok0, ref["logits"][idx, -1].argmax(-1))
            for got, want in zip(rows, tree_leaves(ref["cache"]["blocks"])):
                np.testing.assert_allclose(got.float().cpu(),
                                           want[:, idx].float().cpu(),
                                           **tol("bfloat16"))
