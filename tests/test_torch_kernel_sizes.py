"""Every size the JAX package's kernel wrappers take, up to the port's
limits: attention head dims 1-256, RWKV6 head sizes 1-128, Mamba state
sizes 1-32.

On the card the port's wrappers read most sizes in place and zero-pad a
copy of the rest (bf16 attention rows whose head dim is no multiple of
8; RWKV6 head sizes to 32, 64 or 128; Mamba state sizes to 8, 16 or 32).
Here each padding function runs in front of its plain PyTorch version,
as the wrapper runs it in front of the kernel, against the JAX package's
wrapper (Pallas in interpret mode, as ``tests/test_kernels.py`` runs
it) on the same inputs made with numpy from a seed.  Tolerances are
``tests/test_kernels.py``'s: 2e-4 in fp32 and 2e-2 in bf16 for
attention, 2e-3 for the RWKV6 scan, 1e-3 for the Mamba scan.  Then a
two-layer Gemma-2-family model at head dim 256 served greedy by the
port's engine against the JAX engine on the Pallas attention.
"""
import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.archs import SMOKE as JSMOKE  # noqa: E402
from repro.genserve import adapter as jadapter  # noqa: E402
from repro.kernels.decode_attention.ops import decode_attention as j_decode  # noqa: E402
from repro.kernels.flash_attention.ops import flash_attention as j_flash  # noqa: E402
from repro.kernels.mamba_scan.ops import mamba_scan as j_mamba  # noqa: E402
from repro.kernels.rwkv6_scan.ops import rwkv6_scan as j_rwkv  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.rl.rollout import SamplerConfig as JSampler  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import archs as tarchs  # noqa: E402
from repro_torch.genserve import adapter as tadapter  # noqa: E402
from repro_torch.kernels.decode_attention import ops as t_decode  # noqa: E402
from repro_torch.kernels.flash_attention import ops as t_flash  # noqa: E402
from repro_torch.kernels.mamba_scan import ops as t_mamba  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ops as t_rwkv  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.rl.rollout import SamplerConfig as TSampler  # noqa: E402

DT = {"float32": (np.float32, torch.float32),
      "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on the host's
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-4, atol=2e-4)


def _normal(rng, shape, dtype="float32"):
    return rng.standard_normal(shape).astype(np.float32) \
        .astype(DT[dtype][0])


def _t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _np32(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# the padding functions in front of the plain versions, against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hd", [12, 40, 200])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_read_width_and_padding_vs_pallas(hd, dtype):
    """What the flash wrapper hands the kernel (bf16 hd 12 padded to 16,
    every other case as it is), through the plain version with the
    native scale and sliced back, causal with a window and a softcap."""
    B, S, H, KV, window, cap = 2, 70, 4, 2, 24, 50.0
    rng = np.random.default_rng(hd)
    q, k, v = (_normal(rng, (B, S, n, hd), dtype) for n in (H, KV, KV))
    ref = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=True, window=window, cap=cap)
    width = t_flash.read_width(hd, DT[dtype][1])
    assert width == (16 if (dtype, hd) == ("bfloat16", 12) else hd)
    qp, kp, vp = (t_flash.pad_head_dim(_t(x), width) for x in (q, k, v))
    out = t_flash.flash_attention_plain(qp, kp, vp, causal=True,
                                        window=window, cap=cap,
                                        scale=1.0 / math.sqrt(hd))
    assert out.shape == (B, S, H, width) and out.dtype == DT[dtype][1]
    assert not out[..., hd:].any()        # padded columns come out zero
    np.testing.assert_allclose(_np32(out[..., :hd]), _np32(ref),
                               **tol(dtype))


@pytest.mark.parametrize("hd", [12, 40, 200])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_at_native_head_dims_vs_pallas(hd, dtype):
    """The decode kernel reads every head dim in place (nothing is
    padded): the plain version at the native head dim, softcapped, over
    a sliding window's bias, against the JAX wrapper (which pads to 256
    and corrects its scale)."""
    B, H, KV, L, window, cap = 3, 4, 2, 90, 40, 30.0
    rng = np.random.default_rng(100 + hd)
    q = _normal(rng, (B, H, hd), dtype)
    k, v = (_normal(rng, (B, L, KV, hd), dtype) for _ in range(2))
    pos = np.array([89, 50, 10])
    kpos = np.arange(L)[None, :]
    ok = (kpos <= pos[:, None]) & (pos[:, None] - kpos < window)
    bias = np.where(ok, 0.0, -1e30).astype(np.float32)
    ref = j_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   jnp.asarray(bias), cap=cap)
    out = t_decode.decode_attention(_t(q), _t(k), _t(v), _t(bias), cap=cap)
    assert out.shape == (B, H, hd) and out.dtype == DT[dtype][1]
    np.testing.assert_allclose(_np32(out), _np32(ref), **tol(dtype))


@pytest.mark.parametrize("N", [16, 48])
def test_rwkv6_head_size_padding_vs_pallas(N):
    """N 16 and 48 run on the kernel's 32 and 64 with zero-padded r, k,
    v, u and logw 0; y and the state sliced back."""
    B, S, H, chunk = 2, 40, 2, 16
    rng = np.random.default_rng(N)
    r, k, v = (_normal(rng, (B, S, H, N)) for _ in range(3))
    logw = -np.exp(rng.standard_normal((B, S, H, N)) * 0.5 - 1.0) \
        .astype(np.float32)
    u = (rng.standard_normal((H, N)) * 0.5).astype(np.float32)
    yj, sj = j_rwkv(r, k, v, logw, u, chunk=chunk)
    width = t_rwkv.head_size_width(N)
    assert width == {16: 32, 48: 64}[N]
    padded = t_rwkv.pad_head_size(*(_t(x) for x in (r, k, v, logw, u)),
                                  width)
    assert padded[0].shape == (B, S, H, width) and padded[4].shape == (
        H, width)
    assert not padded[3][..., N:].any()         # logw 0: decay 1
    y, st = t_rwkv.rwkv6_scan_plain(*padded)
    assert not y[..., N:].any() and not st[:, :, N:].any() \
        and not st[..., N:].any()
    np.testing.assert_allclose(y[..., :N].numpy(), np.asarray(yj),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(st[:, :, :N, :N].numpy(), np.asarray(sj),
                               rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("ds", [4, 12, 24])
def test_mamba_state_padding_vs_pallas(ds):
    """ds 4, 12 and 24 run on the kernel's 8, 16 and 32 with Bm, Cm and
    A zero-padded; h_end sliced back."""
    B, S, di = 2, 40, 48
    rng = np.random.default_rng(ds)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, di)) - 1.0)) \
        .astype(np.float32)
    x = _normal(rng, (B, S, di))
    Bm, Cm = (_normal(rng, (B, S, ds)) for _ in range(2))
    A = -np.exp(rng.standard_normal((di, ds)) * 0.3).astype(np.float32)
    yj, hj = j_mamba(dt, x, Bm, Cm, A)
    width = t_mamba.state_width(ds)
    assert width == {4: 8, 12: 16, 24: 32}[ds]
    Bp, Cp, Ap = t_mamba.pad_state(_t(Bm), _t(Cm), _t(A), width)
    assert Bp.shape == (B, S, width) and Ap.shape == (di, width)
    y, h = t_mamba.mamba_scan_plain(_t(dt), _t(x), Bp, Cp, Ap)
    assert not h[..., ds:].any()
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_allclose(h[..., :ds].numpy(), np.asarray(hj),
                               rtol=1e-3, atol=1e-3)


# ---------------------------------------------------------------------------
# each wrapper's checks: every size up to the limit, not one beyond
# ---------------------------------------------------------------------------

def test_attention_checks_take_every_head_dim_to_256():
    assert t_flash.MAX_HEAD_DIM == t_decode.MAX_HEAD_DIM == 256
    for dt in t_flash.DTYPES:
        for hd in range(1, 258):
            q = torch.zeros((1, 2, 2, hd), dtype=dt)
            bias = torch.zeros((1, 2))
            if hd <= 256:
                t_flash._check(q, q, q)
                t_decode._check(q[:, 0], q, q, bias)
                continue
            with pytest.raises(ValueError, match="head dim 257"):
                t_flash._check(q, q, q)
            with pytest.raises(ValueError, match="head dim 257"):
                t_decode._check(q[:, 0], q, q, bias)


def test_rwkv6_check_takes_every_head_size_to_128():
    assert t_rwkv.MAX_HEAD_SIZE == 128
    for N in range(1, 130):
        x = torch.zeros((1, 3, 2, N))
        u = torch.zeros((2, N))
        if N <= 128:
            t_rwkv._check(x, x, x, x, u)
            assert t_rwkv.head_size_width(N) == min(
                w for w in t_rwkv.HEAD_DIMS if w >= N)
        else:
            with pytest.raises(ValueError, match="head dim 129"):
                t_rwkv._check(x, x, x, x, u)


def test_mamba_check_takes_every_state_size_to_32():
    assert t_mamba.MAX_STATE_DIM == 32
    x = torch.zeros((1, 3, 16))
    for ds in range(1, 34):
        b = torch.zeros((1, 3, ds))
        a = torch.zeros((16, ds))
        if ds <= 32:
            t_mamba._check(x, x, b, b, a)
            assert t_mamba.state_width(ds) == min(
                w for w in t_mamba.STATE_DIMS if w >= ds)
        else:
            with pytest.raises(ValueError, match="state dim 33"):
                t_mamba._check(x, x, b, b, a)


# ---------------------------------------------------------------------------
# a Gemma-2-family model at head dim 256, served
# ---------------------------------------------------------------------------

def test_gemma2_family_at_head_dim_256_serves_as_the_jax_engine():
    """Two layers (local window 16, global), softcaps 50 and 30, 2:1
    heads of 256 on d_model 128: 5 requests through a wave of 4 (a slot
    recycled), prompt 12, 10 new tokens, greedy.  The port's engine
    (the wrappers' plain versions on the CPU) against the JAX engine
    under the Pallas attention in interpret mode (its wrappers take hd
    256 unpadded): tokens and masks identical, log-probs within 2e-4.
    The greedy picks of seeded weights sit near probability 1, so the
    prompts' prefill logits, every entry, are held within 2e-4 too."""
    widths = dict(head_dim=256, d_model=128, n_heads=2, n_kv_heads=1,
                  d_ff=256)
    jcfg = dataclasses.replace(JSMOKE["gemma2-27b"], **widths)
    tcfg = dataclasses.replace(tarchs.SMOKE["gemma2-27b"], **widths)
    assert tcfg.resolved_head_dim == 256 and tcfg.attn_softcap == 50.0
    jp = JT.init_params(jax.random.PRNGKey(4), jcfg)
    prompts = np.random.default_rng(8).integers(0, jcfg.vocab_size, (5, 12))
    jattn.set_attention_impl("pallas")
    try:
        ref, rstats = jadapter.generate(
            jp, jcfg, jnp.asarray(prompts), jax.random.PRNGKey(1),
            JSampler(max_new_tokens=10, greedy=True), wave=4,
            decode_chunk=3, fast_path=False)
        ref_logits = JT.forward(jp, jcfg,
                                {"tokens": jnp.asarray(prompts)})["logits"]
    finally:
        jattn.set_attention_impl("jnp")
    tp = bridge.from_numpy_params(jax.tree_util.tree_map(np.asarray, jp),
                                  tcfg, "cpu")
    logits = TT.forward(tp, tcfg, {"tokens": torch.as_tensor(prompts)},
                        attn_impl="kernel")["logits"]
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                               rtol=2e-4, atol=2e-4)
    tattn.set_attention_impl("kernel")
    out, stats = tadapter.generate(
        tp, tcfg, torch.as_tensor(prompts), None,
        TSampler(max_new_tokens=10, greedy=True), wave=4, decode_chunk=3,
        fast_path=False, device="cpu")
    np.testing.assert_array_equal(out["gen_tokens"].numpy(),
                                  np.asarray(ref["gen_tokens"]))
    np.testing.assert_array_equal(out["mask"].numpy(),
                                  np.asarray(ref["mask"]))
    np.testing.assert_allclose(out["logprobs"].numpy(),
                               np.asarray(ref["logprobs"]),
                               rtol=2e-4, atol=2e-4)
    assert stats["prefills"] == rstats["prefills"] >= 2
