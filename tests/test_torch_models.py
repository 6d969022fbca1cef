"""The port's model layers, caches and assembly against the JAX package,
one by one, then forward + per-row decode steps end to end.

Inputs are made with numpy from a seed and go through the JAX function
and its port; weights are carried across with ``repro_torch.bridge``.
Tolerance 2e-4 (fp32).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.archs import SMOKE  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import cache as jcache  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import rwkv as jrwkv  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.config import FFN  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import archs as tarchs  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import cache as tcache  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import rwkv as trwkv  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.config import FFN as TFFN  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
ARCHS = ["qwen3-0.6b", "gemma2-27b", "rwkv6-3b"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _bridged(name, seed=0):
    cfg = SMOKE[name]
    jp = JT.init_params(jax.random.PRNGKey(seed), cfg)
    tp = bridge.from_numpy_params(jax.tree_util.tree_map(np.asarray, jp),
                                  tarchs.SMOKE[name], "cpu")
    return cfg, tarchs.SMOKE[name], jp, tp


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
    state; under "kernel" a zero-state call takes the kernel wrapper."""
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
    with pytest.raises(NotImplementedError, match="not yet ported"):
        trwkv.apply_rwkv(jax.tree_util.tree_map(_t, p),
                         tarchs.SMOKE["rwkv6-3b"], _t(x),
                         valid=torch.ones((2, S), dtype=torch.bool))


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
    cfg = SMOKE[name]
    jp = dict(_leaves(JT.init_params(jax.random.PRNGKey(0), cfg)))
    tp = dict(_leaves(TT.init_params(tarchs.SMOKE[name], seed=0)))
    assert jp.keys() == tp.keys()
    for k in jp:
        assert tuple(jp[k].shape) == tuple(tp[k].shape), k
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
    rwkv6 carries tm_shift / wkv / cm_shift)."""
    cfg, tcfg, jp, tp = _bridged(name, seed=1)
    rng = np.random.default_rng(6)
    B, P, N = 3, 12, 6
    prompts = rng.integers(0, cfg.vocab_size, (B, P))
    jattn.set_attention_impl("jnp")
    ref = JT.forward(jp, cfg, {"tokens": jnp.asarray(prompts)},
                     return_cache=True, max_cache_len=P + N + 8)
    tattn.set_attention_impl(impl)
    try:
        out = TT.forward(tp, tcfg, {"tokens": _t(prompts)},
                         return_cache=True, max_cache_len=P + N + 8)
        np.testing.assert_allclose(out["logits"].numpy(),
                                   np.asarray(ref["logits"]), **TOL)
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


def test_unported_mixers_raise():
    with pytest.raises(NotImplementedError):
        TT.init_params(tarchs.SMOKE["jamba-1.5-large-398b"])
    with pytest.raises(NotImplementedError):
        TT.init_params(tarchs.SMOKE["mixtral-8x7b"])
