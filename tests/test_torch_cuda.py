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


def test_wrappers_reject_what_the_kernels_do_not_take():
    """Checks run before any build or launch (so they hold on the CPU
    too, through the wrappers' validators)."""
    q = torch.zeros((1, 4, 2, 40))
    with pytest.raises(ValueError, match="head dim"):
        t_flash._check(q, q, q)
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
    n = t_rwkv.launches
    t_rwkv.rwkv6_scan(r, k, v, logw, u)
    assert t_rwkv.launches == n + 1


def test_rwkv_wrapper_rejects_what_the_kernel_does_not_take():
    """The wrapper's checks, which run before any build or launch."""
    x = torch.zeros((1, 8, 2, 64))
    u = torch.zeros((2, 64))
    t_rwkv._check(x, x, x, x, u)
    with pytest.raises(ValueError, match="head dim"):
        y = torch.zeros((1, 8, 2, 48))
        t_rwkv._check(y, y, y, y, torch.zeros((2, 48)))
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
    n = t_mamba.launches
    t_mamba.mamba_scan(dt, x, Bm, Cm, A)
    assert t_mamba.launches == n + 1


def test_mamba_wrapper_rejects_what_the_kernel_does_not_take():
    """The wrapper's checks, which run before any build or launch."""
    x = torch.zeros((2, 8, 64))
    bc = torch.zeros((2, 8, 16))
    a = torch.zeros((64, 16))
    t_mamba._check(x, x, bc, bc, a)
    with pytest.raises(ValueError, match="state dim"):
        b4 = torch.zeros((2, 8, 4))
        t_mamba._check(x, x, b4, b4, torch.zeros((64, 4)))
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
