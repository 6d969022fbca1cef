"""The port's model layers, caches and assembly against the JAX package,
one by one, then forward + per-row decode steps end to end.

Inputs are made with numpy from a seed and go through the JAX function
and its port; weights are carried across with ``repro_torch.bridge``.
Tolerance 2e-4 (fp32); initialisation is held bit for bit.
"""
import math
import weakref

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils._pytree import tree_flatten  # noqa: E402

from repro.configs.archs import JAMBA_1_5_LARGE, SMOKE  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import cache as jcache  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import mamba as jmamba  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import rwkv as jrwkv  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.config import FFN, reduced  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import archs as tarchs  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import cache as tcache  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import mamba as tmamba  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import rwkv as trwkv  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.config import FFN as TFFN  # noqa: E402
from repro_torch.models.config import ModelConfig as TModelConfig  # noqa: E402
from repro_torch.models.config import reduced as treduced  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on the host's
    cores, and torch's default of one thread per core oversubscribes
    them (two launcher tests took 66 s instead of 24 s under a full
    load)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(rtol=2e-4, atol=2e-4)
JAMBA3 = "jamba-1.5-large-398b-3layer"   # attn/dense, mamba/MoE, mamba/dense
E2E = "rl-actor-e2e"   # examples/train_rl_e2e.py's actor
ARCHS = ["qwen3-0.6b", "gemma2-27b", "rwkv6-3b", "jamba-1.5-large-398b",
         JAMBA3, "mixtral-8x7b", "granite-moe-3b-a800m", "phi3-medium-14b",
         "nemotron-4-15b", "hubert-xlarge", "pixtral-12b", E2E]


def _cfgs(name):
    """(JAX config, port config) of a test architecture: a smoke, the
    3-layer Jamba cut that holds each of its three layer kinds, or the RL
    e2e actor (d 192, 4 layers, hd 48, 4 query heads over 2 KV heads,
    the addition task's 16 tokens, fp32)."""
    if name == JAMBA3:
        return (reduced(JAMBA_1_5_LARGE, n_layers=3),
                treduced(tarchs.JAMBA_1_5_LARGE, n_layers=3))
    if name == E2E:
        kw = dict(name="rl-actor", n_layers=4, d_model=192, n_heads=4,
                  n_kv_heads=2, head_dim=48, d_ff=576, vocab_size=16,
                  dtype="float32")
        return JModelConfig(**kw), TModelConfig(**kw)
    return SMOKE[name], tarchs.SMOKE[name]


def _t(a):
    return torch.from_numpy(np.array(a))


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _bridged(name, seed=0):
    cfg, tcfg = _cfgs(name)
    jp = JT.init_params(jax.random.PRNGKey(seed), cfg)
    tp = bridge.from_numpy_params(jax.tree_util.tree_map(np.asarray, jp),
                                  tcfg, "cpu")
    return cfg, tcfg, jp, tp


def test_rmsnorm_and_rope():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 64)).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    np.testing.assert_allclose(
        tlayers.rmsnorm({"scale": _t(scale)}, _t(x), 1e-6).numpy(),
        np.asarray(jlayers.rmsnorm({"scale": scale}, x, 1e-6)), **TOL)
    pos = np.array([[0, 3, 9, 100, 4000], [7, 7, 1, 2, 321]])
    np.testing.assert_allclose(
        tlayers.apply_rope(_t(x), _t(pos), 1e6).numpy(),
        np.asarray(jlayers.apply_rope(x, pos, 1e6)), **TOL)


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "squared_relu", "gelu",
                                  "rwkv_channel", "token_shift"])
def test_ffn(kind):
    cfg = SMOKE["qwen3-0.6b"]
    x = np.random.default_rng(1).standard_normal((2, 7, cfg.d_model)) \
        .astype(np.float32)
    if kind == "token_shift":
        np.testing.assert_array_equal(tlayers.token_shift(_t(x)).numpy(),
                                      np.asarray(jlayers.token_shift(x)))
        return
    p = jlayers.init_ffn(jax.random.PRNGKey(1), cfg, FFN(kind), jnp.float32)
    if kind == "rwkv_channel":   # non-trivial mixes
        rng = np.random.default_rng(3)
        p["mu_k"] = rng.random(cfg.d_model).astype(np.float32)
        p["mu_r"] = rng.random(cfg.d_model).astype(np.float32)
    shifted = jlayers.token_shift(x) if kind == "rwkv_channel" else None
    ref = jlayers.apply_ffn(p, cfg, FFN(kind), x, shifted=shifted)
    tp = {k: _t(v) for k, v in p.items()}
    out = tlayers.apply_ffn(
        tp, tarchs.SMOKE["qwen3-0.6b"], TFFN(kind), _t(x),
        shifted=None if shifted is None else _t(shifted))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def _rwkv_inputs(rng, B, S, H, N):
    r, k, v = (rng.standard_normal((B, S, H, N)).astype(np.float32)
               for _ in range(3))
    logw = -np.exp(rng.standard_normal((B, S, H, N)) * 0.5 - 1.0) \
        .astype(np.float32)
    u = (rng.standard_normal((H, N)) * 0.5).astype(np.float32)
    return r, k, v, logw, u


@pytest.mark.parametrize("carried", [False, True])
def test_rwkv_scan_vs_jax(carried):
    """The chunked scan with a ragged last chunk (S 40, chunk 16), from a
    zero or a carried state, and one decode step (S 1, chunk 1)."""
    rng = np.random.default_rng(12)
    B, H, N = 2, 3, 32
    s0 = (rng.standard_normal((B, H, N, N)).astype(np.float32)
          if carried else None)
    for S, chunk in ((40, 16), (1, 1)):
        r, k, v, logw, u = _rwkv_inputs(rng, B, S, H, N)
        yj, sj = jrwkv.rwkv_scan(r, k, v, logw, u, s0, chunk=chunk)
        yt, st = trwkv.rwkv_scan(_t(r), _t(k), _t(v), _t(logw), _t(u),
                                 None if s0 is None else _t(s0), chunk=chunk)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), **TOL)


@pytest.mark.parametrize("impl", ["plain", "kernel"])
@pytest.mark.parametrize("carried", [False, True])
def test_apply_rwkv_vs_jax(carried, impl):
    """apply_rwkv (projections, scan, group norm, gate) and its returned
    state; under "kernel" a zero-state call takes the kernel wrapper.
    Then the chunked-prefill ``valid=`` path on the same inputs."""
    cfg = SMOKE["rwkv6-3b"]
    H, N, d = cfg.rwkv_n_heads, cfg.rwkv_head_dim, cfg.d_model
    p = jrwkv.init_rwkv(jax.random.PRNGKey(4), cfg, jnp.float32)
    rng = np.random.default_rng(13)
    p["mu"] = rng.random((5, d)).astype(np.float32)
    p["out_norm"]["scale"] = rng.standard_normal(d).astype(np.float32)
    S = 1 if carried else 9
    x = rng.standard_normal((2, S, d)).astype(np.float32)
    state = None
    if carried:
        state = {"tm_shift": rng.standard_normal((2, d)).astype(np.float32),
                 "wkv": rng.standard_normal((2, H, N, N)).astype(np.float32)}
    yj, sj = jrwkv.apply_rwkv(p, cfg, x, state=state, return_state=True)
    tattn.set_attention_impl(impl)
    try:
        yt, st = trwkv.apply_rwkv(
            jax.tree_util.tree_map(_t, p), tarchs.SMOKE["rwkv6-3b"], _t(x),
            state=None if state is None
            else jax.tree_util.tree_map(_t, state), return_state=True)
    finally:
        tattn.set_attention_impl("kernel")
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
    for key in ("tm_shift", "wkv"):
        np.testing.assert_allclose(st[key].numpy(), np.asarray(sj[key]),
                                   **TOL, err_msg=key)
    # the chunked-prefill path: valid prefixes of S and S // 2 tokens
    valid = np.arange(S)[None, :] < np.array([S, S // 2])[:, None]
    yj, sj = jrwkv.apply_rwkv(p, cfg, x, state=state, return_state=True,
                              valid=jnp.asarray(valid))
    yt, st = trwkv.apply_rwkv(
        jax.tree_util.tree_map(_t, p), tarchs.SMOKE["rwkv6-3b"], _t(x),
        state=None if state is None
        else jax.tree_util.tree_map(_t, state), return_state=True,
        valid=_t(valid))
    np.testing.assert_allclose(yt.numpy()[valid], np.asarray(yj)[valid],
                               **TOL)
    for key in ("tm_shift", "wkv"):
        np.testing.assert_allclose(st[key].numpy(), np.asarray(sj[key]),
                                   **TOL, err_msg=key)


def test_qkv_project_qk_norm():
    cfg, tcfg, jp, tp = _bridged("qwen3-0.6b")
    assert cfg.qk_norm
    pa = jax.tree_util.tree_map(lambda l: l[0], jp["blocks"]["layer0"]["attn"])
    # non-trivial norm scales so qk-norm is actually exercised
    rng = np.random.default_rng(2)
    pa["q_norm"]["scale"] = rng.standard_normal(64).astype(np.float32)
    pa["k_norm"]["scale"] = rng.standard_normal(64).astype(np.float32)
    x = rng.standard_normal((2, 6, cfg.d_model)).astype(np.float32)
    pos = np.arange(6) + 3
    ref = jattn.qkv_project(pa, cfg, x, pos)
    out = tattn.qkv_project(jax.tree_util.tree_map(_t, pa), tcfg, _t(x),
                            _t(pos))
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("case", [
    "scalar-token", "scalar-token-clamp", "scalar-slice", "per-row-token",
    "per-row-ring", "ring-wrap", "full-clamp", "valid-chunk"])
def test_write_kv(case):
    rng = np.random.default_rng(4)
    B, KV, hd = 3, 2, 8
    L, C, window, valid = 10, 1, None, None
    if case == "scalar-token":
        pos = 4
    elif case == "scalar-token-clamp":
        pos = 17
    elif case == "scalar-slice":
        pos, C = 2, 5
    elif case == "per-row-token":
        pos = np.array([0, 9, 23])
    elif case == "per-row-ring":
        pos, window = np.array([0, 9, 23]), 10
    elif case == "ring-wrap":
        pos, C, window = 6, 17, 10
    elif case == "full-clamp":
        pos, C = 3, 12
    else:
        pos, C, window = np.array([1, 8, 15]), 5, 10
        valid = rng.random((B, C)) < 0.7
    ck = rng.standard_normal((B, L, KV, hd)).astype(np.float32)
    cv = rng.standard_normal((B, L, KV, hd)).astype(np.float32)
    kn = rng.standard_normal((B, C, KV, hd)).astype(np.float32)
    vn = rng.standard_normal((B, C, KV, hd)).astype(np.float32)
    jk, jv = jcache.write_kv(jnp.asarray(ck), jnp.asarray(cv), kn, vn,
                             jnp.asarray(pos), window,
                             valid=None if valid is None
                             else jnp.asarray(valid))
    tpos = pos if isinstance(pos, int) else _t(pos)
    tk, tv = tcache.write_kv(_t(ck), _t(cv), _t(kn), _t(vn), tpos, window,
                             valid=None if valid is None else _t(valid))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_gather_scatter_and_zero_slots():
    rng = np.random.default_rng(5)
    dst = {"layer0": {n: rng.standard_normal((2, 4, 3, 1, 2))
                      .astype(np.float32) for n in ("k", "v")}}
    src = jax.tree_util.tree_map(lambda a: a + 10.0, dst)
    mask = np.array([True, False, True, False])
    ref = jcache.scatter_slots(dst, src, jnp.asarray(mask))
    out = tcache.scatter_slots(jax.tree_util.tree_map(_t, dst),
                               jax.tree_util.tree_map(_t, src), _t(mask))
    for (p, a), (_, b) in zip(_leaves(out), _leaves(ref)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), p)
    idx = np.array([3, 0])
    refg = jcache.gather_slots(dst, jnp.asarray(idx))
    outg = tcache.gather_slots(jax.tree_util.tree_map(_t, dst), _t(idx))
    for (p, a), (_, b) in zip(_leaves(outg), _leaves(refg)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), p)
    refz = jcache.zero_slots(dst, jnp.asarray(mask))
    outz = tcache.zero_slots(jax.tree_util.tree_map(_t, dst), _t(mask))
    for (p, a), (_, b) in zip(_leaves(outz), _leaves(refz)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), p)


@pytest.mark.parametrize("name", ARCHS)
def test_init_params_layout_matches_jax(name):
    cfg, tcfg = _cfgs(name)
    jp = dict(_leaves(JT.init_params(jax.random.PRNGKey(0), cfg)))
    tp = dict(_leaves(TT.init_params(tcfg, seed=0)))
    assert jp.keys() == tp.keys()
    for k in jp:
        assert tuple(jp[k].shape) == tuple(tp[k].shape), k
        if k[-1] in ("A_log", "D", "dt_bias", "conv_b"):   # fixed inits
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, err_msg=str(k))
    tok = tp[("embed", "tokens")]
    assert abs(float(tok.std()) - 0.02 * 0.88) < 2e-3   # trunc-normal ±2σ
    assert float(tok.abs().max()) <= 0.04 + 1e-6


def _assert_cache_close(tc, jc):
    """Leaf by leaf, matched by path (JAX returns scanned dicts with
    sorted keys)."""
    jl = dict(_leaves(jc))
    tl = dict(_leaves(tc))
    assert tl.keys() == jl.keys()
    for p, a in tl.items():
        np.testing.assert_allclose(a.numpy(), np.asarray(jl[p]), **TOL,
                                   err_msg=str(p))


@pytest.mark.parametrize("impl", ["plain", "kernel"])
@pytest.mark.parametrize("name", ARCHS)
def test_forward_and_per_row_decode(name, impl):
    """forward(return_cache) logits + every cache leaf, then 6 per-row
    decode steps (ragged positions; gemma2's window-16 ring wraps;
    rwkv6 carries tm_shift / wkv / cm_shift, jamba conv / ssm; MoE
    prefill drops tokens past capacity, MoE decode is dense; pixtral's
    decoder on token prompts).  The encoder-only hubert-xlarge has no
    decode step: its forward over audio frames (non-causal attention,
    sinusoidal positions) only."""
    cfg, tcfg, jp, tp = _bridged(name, seed=1)
    rng = np.random.default_rng(6)
    B, P, N = 3, 12, 6
    prompts = rng.integers(0, cfg.vocab_size, (B, P))
    jattn.set_attention_impl("jnp")
    if cfg.is_encoder_only:
        feats = rng.standard_normal((B, P, cfg.feature_dim)) \
            .astype(np.float32)
        ref = JT.forward(jp, cfg, {"features": feats})
        tattn.set_attention_impl(impl)
        try:
            out = TT.forward(tp, tcfg, {"features": _t(feats)})
        finally:
            tattn.set_attention_impl("kernel")
        np.testing.assert_allclose(out["logits"].numpy(),
                                   np.asarray(ref["logits"]), **TOL)
        return
    ref = JT.forward(jp, cfg, {"tokens": jnp.asarray(prompts)},
                     return_cache=True, max_cache_len=P + N + 8)
    tattn.set_attention_impl(impl)
    try:
        out = TT.forward(tp, tcfg, {"tokens": _t(prompts)},
                         return_cache=True, max_cache_len=P + N + 8)
        np.testing.assert_allclose(out["logits"].numpy(),
                                   np.asarray(ref["logits"]), **TOL)
        np.testing.assert_allclose(out["aux_loss"].numpy(),
                                   np.asarray(ref["aux_loss"]), **TOL)
        jc, tc = ref["cache"], out["cache"]
        assert int(jc["pos"]) == tc["pos"]
        _assert_cache_close(tc["blocks"], jc["blocks"])
        # per-row positions: rows start at different cursors
        pos = np.array([P, P + 5, P + 9])
        jc = {"blocks": jc["blocks"], "pos": jnp.asarray(pos)}
        tc = {"blocks": tc["blocks"], "pos": _t(pos)}
        tok = rng.integers(0, cfg.vocab_size, (B, 1))
        for _ in range(N):
            jl, jc = JT.decode_step(jp, cfg, jnp.asarray(tok), jc)
            tl, tc = TT.decode_step(tp, tcfg, _t(tok), tc)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
            np.testing.assert_array_equal(tc["pos"].numpy(),
                                          np.asarray(jc["pos"]))
            tok = np.asarray(jnp.argmax(jl, -1))[:, None]
        _assert_cache_close(tc["blocks"], jc["blocks"])
    finally:
        tattn.set_attention_impl("kernel")


@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_pixtral_feature_prefill_then_decode(impl):
    """pixtral-12b: image patches in front of unscaled token embeddings,
    RoPE over the whole sequence, prefilled with ``return_cache``; then 4
    decode steps from the cache, every step's logits and the cache
    against the JAX package."""
    cfg, tcfg, jp, tp = _bridged("pixtral-12b", seed=2)
    rng = np.random.default_rng(9)
    B, F_, P, N = 2, 6, 5, 4
    feats = rng.standard_normal((B, F_, cfg.feature_dim)).astype(np.float32)
    prompts = rng.integers(0, cfg.vocab_size, (B, P))
    jattn.set_attention_impl("jnp")
    ref = JT.forward(jp, cfg, {"features": feats,
                               "tokens": jnp.asarray(prompts)},
                     return_cache=True, max_cache_len=F_ + P + N)
    tattn.set_attention_impl(impl)
    try:
        out = TT.forward(tp, tcfg, {"features": _t(feats),
                                    "tokens": _t(prompts)},
                         return_cache=True, max_cache_len=F_ + P + N)
        np.testing.assert_allclose(out["logits"].numpy(),
                                   np.asarray(ref["logits"]), **TOL)
        jc, tc = ref["cache"], out["cache"]
        assert int(jc["pos"]) == tc["pos"] == F_ + P
        _assert_cache_close(tc["blocks"], jc["blocks"])
        tok = np.asarray(jnp.argmax(ref["logits"][:, -1], -1))[:, None]
        for _ in range(N):
            jl, jc = JT.decode_step(jp, cfg, jnp.asarray(tok), jc)
            tl, tc = TT.decode_step(tp, tcfg, _t(tok), tc)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
            tok = np.asarray(jnp.argmax(jl, -1))[:, None]
        assert tc["pos"] == int(jc["pos"]) == F_ + P + N
        _assert_cache_close(tc["blocks"], jc["blocks"])
    finally:
        tattn.set_attention_impl("kernel")


def test_encoder_only_has_no_decode_path():
    """hubert-xlarge (encoder-only) refuses ``decode_step`` and both chunk
    steps with the JAX package's messages; its forward runs."""
    cfg, tcfg, jp, tp = _bridged("hubert-xlarge")
    B, C = 2, 3
    jc = dict(jcache.init_cache(cfg, B, 8), pos=jnp.zeros((B,), jnp.int32))
    tc = dict(tcache.init_cache(tcfg, B, 8),
              pos=torch.zeros((B,), dtype=torch.int64))
    jt = jnp.zeros((B, C), jnp.int32)
    tt = torch.zeros((B, C), dtype=torch.int64)
    n_valid = np.array([C, 1])
    for what, jcall, tcall in (
            ("step", lambda: JT.decode_step(jp, cfg, jt[:, :1], jc),
             lambda: TT.decode_step(tp, tcfg, tt[:, :1], tc)),
            ("path", lambda: JT.prefill_chunk_step(jp, cfg, jt, jc,
                                                   n_valid=n_valid),
             lambda: TT.prefill_chunk_step(tp, tcfg, tt, tc,
                                           n_valid=_t(n_valid))),
            ("path", lambda: JT.verify_chunk_step(jp, cfg, jt, jc),
             lambda: TT.verify_chunk_step(tp, tcfg, tt, tc))):
        msg = f"encoder-only models have no decode {what}"
        with pytest.raises(AssertionError, match=msg):
            jcall()
        with pytest.raises(ValueError, match=msg):
            tcall()
    feats = np.random.default_rng(3).standard_normal(
        (B, 5, cfg.feature_dim)).astype(np.float32)
    out = TT.forward(tp, tcfg, {"features": _t(feats)})
    assert tuple(out["logits"].shape) == (B, 5, cfg.vocab_size)


# ---------------------------------------------------------------------------
# Mamba
# ---------------------------------------------------------------------------

def _mamba_inputs(rng, B, S, di, ds):
    """tests/test_kernels.py's distribution for the scan inputs."""
    dt = np.log1p(np.exp(rng.standard_normal((B, S, di)) - 1)) \
        .astype(np.float32)
    x = rng.standard_normal((B, S, di)).astype(np.float32)
    Bm = rng.standard_normal((B, S, ds)).astype(np.float32)
    Cm = rng.standard_normal((B, S, ds)).astype(np.float32)
    A = -np.exp(rng.standard_normal((di, ds)) * 0.3).astype(np.float32)
    return dt, x, Bm, Cm, A


@pytest.mark.parametrize("carried", [False, True])
def test_ssm_scan_vs_jax(carried):
    """The port's scan (chunks of 64, one here) against the JAX chunked
    associative scan (S 40 in ragged chunks of 16), from a zero or a
    carried state, with the D x skip, and one decode step (S 1)."""
    rng = np.random.default_rng(14)
    B, di, ds = 2, 48, 16
    D = rng.standard_normal(di).astype(np.float32)
    h0 = (rng.standard_normal((B, di, ds)).astype(np.float32)
          if carried else None)
    for S in (40, 1):
        dt, x, Bm, Cm, A = _mamba_inputs(rng, B, S, di, ds)
        yj, hj = jmamba.ssm_scan(dt, Bm, Cm, x, A, D, h0, chunk=min(16, S))
        yt, ht = tmamba.ssm_scan(_t(dt), _t(Bm), _t(Cm), _t(x), _t(A), _t(D),
                                 None if h0 is None else _t(h0))
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
        np.testing.assert_allclose(ht.numpy(), np.asarray(hj), **TOL)


@pytest.mark.parametrize("impl", ["plain", "kernel"])
@pytest.mark.parametrize("carried", [False, True])
def test_apply_mamba_vs_jax(carried, impl):
    """apply_mamba (in_proj, causal conv, selective scan, gate) and its
    returned conv / ssm state; under "kernel" a zero-state call takes
    the kernel wrapper and adds D x after it.  Then the chunked-prefill
    ``valid=`` path on the same inputs."""
    cfg = SMOKE["jamba-1.5-large-398b"]
    di, ds, dc = cfg.mamba_d_inner, cfg.mamba_d_state, cfg.mamba_d_conv
    p = jmamba.init_mamba(jax.random.PRNGKey(5), cfg, jnp.float32)
    rng = np.random.default_rng(15)
    p["conv_b"] = rng.standard_normal(di).astype(np.float32) * 0.1
    p["D"] = rng.standard_normal(di).astype(np.float32)
    p["dt_bias"] = (rng.standard_normal(di) - 2.0).astype(np.float32)
    S = 1 if carried else 9
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    state = None
    if carried:
        state = {"conv": rng.standard_normal((2, dc - 1, di))
                 .astype(np.float32),
                 "ssm": rng.standard_normal((2, di, ds)).astype(np.float32)}
    yj, sj = jmamba.apply_mamba(p, cfg, x, state=state, return_state=True)
    tcfg = tarchs.SMOKE["jamba-1.5-large-398b"]
    tp = jax.tree_util.tree_map(_t, p)
    tattn.set_attention_impl(impl)
    try:
        yt, st = tmamba.apply_mamba(
            tp, tcfg, _t(x), return_state=True,
            state=None if state is None
            else jax.tree_util.tree_map(_t, state))
    finally:
        tattn.set_attention_impl("kernel")
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
    for key in ("conv", "ssm"):
        np.testing.assert_allclose(st[key].numpy(), np.asarray(sj[key]),
                                   **TOL, err_msg=key)
    # the chunked-prefill path: valid prefixes of S and S // 2 tokens
    valid = np.arange(S)[None, :] < np.array([S, S // 2])[:, None]
    yj, sj = jmamba.apply_mamba(p, cfg, x, state=state, return_state=True,
                                valid=jnp.asarray(valid))
    yt, st = tmamba.apply_mamba(
        tp, tcfg, _t(x), return_state=True, valid=_t(valid),
        state=None if state is None
        else jax.tree_util.tree_map(_t, state))
    np.testing.assert_allclose(yt.numpy()[valid], np.asarray(yj)[valid],
                               **TOL)
    for key in ("conv", "ssm"):
        np.testing.assert_allclose(st[key].numpy(), np.asarray(sj[key]),
                                   **TOL, err_msg=key)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["prefill", "decode", "capacity-drop",
                                  "squared-relu", "groups"])
def test_apply_moe_vs_jax(case):
    """Grouped one-hot dispatch (S > 1) and the dense single-token path
    (S == 1), y and the aux loss: a capacity that drops tokens, a
    non-gated expert FFN, and several groups of 512 tokens."""
    import dataclasses
    cfg = SMOKE["mixtral-8x7b"]
    kind = FFN.SWIGLU
    B, S = 3, 12
    if case == "decode":
        S = 1
    elif case == "capacity-drop":
        cfg = dataclasses.replace(cfg, capacity_factor=0.25)
        assert jmoe._capacity(S, cfg) * cfg.n_experts < S * cfg.top_k
    elif case == "squared-relu":
        kind = FFN.SQUARED_RELU
    elif case == "groups":
        B, S = 1, 1024
    tcfg = dataclasses.replace(tarchs.SMOKE["mixtral-8x7b"],
                               capacity_factor=cfg.capacity_factor)
    p = jmoe.init_moe(jax.random.PRNGKey(6), cfg, kind, jnp.float32)
    x = np.random.default_rng(16).standard_normal((B, S, cfg.d_model)) \
        .astype(np.float32)
    if kind == FFN.SQUARED_RELU:
        # the fan-in-E init squares up to outputs near 1e3 at unit inputs,
        # where 2e-4 is below fp32 rounding; a tenth of them stays near 10
        x *= 0.1
    yj, aj = jmoe.apply_moe(p, cfg, kind, x)
    yt, at = tmoe.apply_moe(jax.tree_util.tree_map(_t, p), tcfg, TFFN(kind),
                            _t(x))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
    np.testing.assert_allclose(float(at), float(aj), rtol=1e-5, atol=1e-7)


def test_moe_top_k_ties_take_the_lower_expert():
    """Equal gates route as jax.lax.top_k does: lower expert first."""
    gates, top_w, top_e = tmoe._route(torch.zeros((2, 5, 3)),
                                      torch.zeros((3, 6)), 2)
    assert top_e.tolist() == [[[0, 1]] * 5] * 2
    assert torch.allclose(top_w, torch.full_like(top_w, 0.5))


# ---------------------------------------------------------------------------
# Caches of the recurrent mixers
# ---------------------------------------------------------------------------

def test_mamba_cache_leaves_and_slot_reset():
    """init_cache's conv / ssm leaves match the JAX cache (fp32, [R, B,
    ...]); scatter_slots replaces both leaves of a recycled slot with the
    fresh prefill state, and zero_slots clears them."""
    name = "jamba-1.5-large-398b"
    cfg, tcfg = _cfgs(name)
    jc = dict(_leaves(jcache.init_cache(cfg, 3, 16)["blocks"]))
    tc = tcache.init_cache(tcfg, 3, 16)["blocks"]
    for path, leaf in _leaves(tc):
        assert tuple(leaf.shape) == tuple(jc[path].shape), path
        if path[-1] in ("conv", "ssm"):
            assert leaf.dtype == torch.float32
            assert np.asarray(jc[path]).dtype == np.float32
    _, _, _, tp = _bridged(name)
    prompts = torch.as_tensor(np.random.default_rng(8).integers(
        0, tcfg.vocab_size, (3, 7)))
    fresh = TT.forward(tp, tcfg, {"tokens": prompts}, return_cache=True,
                       max_cache_len=16)["cache"]["blocks"]
    for leaf in (tc["layer1"]["conv"], tc["layer1"]["ssm"]):
        leaf.fill_(7.0)                          # a stale previous occupant
    mask = torch.tensor([False, True, True])
    tcache.scatter_slots(tc, fresh, mask)
    for n in ("conv", "ssm"):
        new, ref = tc["layer1"][n], fresh["layer1"][n]
        assert torch.equal(new[:, 1:], ref[:, 1:].float()), n
        assert bool((new[:, 0] == 7.0).all()), n
        assert float(ref.abs().sum()) > 0, n
    tcache.zero_slots(tc, mask)
    for n in ("conv", "ssm"):
        assert float(tc["layer1"][n][:, 1:].abs().sum()) == 0.0, n


# ---------------------------------------------------------------------------
# Initialisation: unchanged values, bounded memory
# ---------------------------------------------------------------------------

def _whole_leaf_init(gen, shape, scale=None, dtype=torch.float32):
    """The stack-based init's draw: a whole fp32 leaf, then a scaled
    copy, then a cast."""
    if scale is None:
        scale = 1.0 / math.sqrt(shape[0])
    w = torch.empty(shape, dtype=torch.float32, device=gen.device)
    return (tlayers._trunc_normal_(w, gen, 1.0) * scale).to(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["qwen3-0.6b", "rwkv6-3b",
                                  "jamba-1.5-large-398b"])
def test_init_params_unchanged_for_seed(name, dtype, monkeypatch):
    """init_params, which allocates each [R, ...] leaf once and draws
    bf16 leaves in small fp32 slices (the slice is shrunk here so that
    every leaf takes several), gives bit for bit the params of drawing
    every repeat's layers as whole fp32 leaves and stacking them."""
    tcfg = tarchs.SMOKE[name]
    dt = getattr(torch, dtype)
    monkeypatch.setattr(tlayers, "DRAW_CHUNK", 1000)
    params = TT.init_params(tcfg, seed=3, dtype=dt)
    for mod in (tlayers, tattn, trwkv, tmamba, tmoe):
        monkeypatch.setattr(mod, "dense_init", _whole_leaf_init)
    gen = torch.Generator().manual_seed(3)
    embed = tlayers.init_embeddings(gen, tcfg, dt)
    reps = [{f"layer{j}": TT._init_layer(gen, tcfg, spec, dt)
             for j, spec in enumerate(tcfg.pattern)}
            for _ in range(tcfg.n_pattern_repeats)]
    ref = {"embed": embed,
           "blocks": tcache.tree_map(lambda *ls: torch.stack(ls), *reps),
           "final_norm": tlayers.init_rmsnorm(tcfg.d_model, dt, "cpu")}
    got, want = dict(_leaves(params)), dict(_leaves(ref))
    assert got.keys() == want.keys()
    for path, t in got.items():
        assert t.dtype == dt and torch.equal(t, want[path]), path


class _LiveBytes(TorchDispatchMode):
    """Counts the bytes of every tensor an op allocates (outputs that
    share no storage with its inputs), live until the tensor is freed."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = 0

    def _free(self, n):
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins = {t.untyped_storage().data_ptr()
               for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)}
        for t in tree_flatten(out)[0]:
            if (isinstance(t, torch.Tensor)
                    and t.untyped_storage().data_ptr() not in ins):
                n = t.untyped_storage().nbytes()
                self.live += n
                self.peak = max(self.peak, self.live)
                weakref.finalize(t, self._free, n)
        return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_init_peak_memory(dtype, monkeypatch):
    """An [E, d, f] expert leaf: the fp32 leaf is drawn in place (peak =
    the leaf), the bf16 leaf in one-expert fp32 slices (peak = the leaf
    plus one slice), where drawing the whole fp32 leaf, scaling and
    casting peaks at two fp32 copies beside the result."""
    E, d, f = 8, 64, 512
    dt = getattr(torch, dtype)
    monkeypatch.setattr(tlayers, "DRAW_CHUNK", d * f)
    gen = torch.Generator().manual_seed(0)
    with _LiveBytes() as m:
        w = tlayers.dense_init(gen, (E, d, f), dtype=dt)
    leaf = w.numel() * w.element_size()
    slice_ = 0 if dt == torch.float32 else d * f * 4
    assert m.peak <= leaf + slice_ + 64, (m.peak, leaf, slice_)
    with _LiveBytes() as m_old:
        _whole_leaf_init(gen, (E, d, f), dtype=dt)
    assert m_old.peak >= 2 * E * d * f * 4 > m.peak
