"""Every ``configs.archs`` architecture's reduced variant through the port
against the JAX package: the port of ``tests/test_archs_smoke.py``.

On bridged JAX weights, fp32, with inputs made by numpy from a seed
(features in front of tokens for hubert-xlarge and pixtral-12b, as
``configs.shapes.token_splits`` splits them): the reduced limits;
forward logits and the MoE aux loss within 2e-4, ``count_params`` equal
to the JAX package's and within 5% of ``param_count()``; one LM train
step (``launch.steps.make_train_step``): loss and grad norm within rtol
2e-4, post-Adam parameters within 2e-6 where |g| >= 1e-6 and the two
packages' gradients agree within 1e-3 of |g|, else within 2*lr + 2e-6
(``tests/test_torch_lm.py``); and for the eight architectures with a
decode step, decode from a prefilled cache against the full forward,
each step's logits within 2e-4 of the JAX package's decode and of the
port's own forward.

The JAX side of each architecture is computed once per module
(``_ref``): ``tests/test_archs_smoke.py`` compiles the same ten smokes.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import archs as jarchs  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim import adam as jadam  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import archs as tarchs  # noqa: E402
from repro_torch.configs.shapes import token_splits  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.optim import adam as tadam  # noqa: E402
from repro_torch.tree import tree_leaves, tree_unflatten  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on the host's
    cores, and torch's default of one thread per core oversubscribes
    them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ALL_ARCHS = sorted(jarchs.ARCHS)
DECODE_ARCHS = [n for n in ALL_ARCHS
                if not jarchs.get(n, smoke=True).is_encoder_only
                and jarchs.get(n, smoke=True).frontend == "tokens"]
TOL = dict(rtol=2e-4, atol=2e-4)
LR = 1e-3
B, S = 2, 32


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def smoke_inputs(cfg, rng, batch=B, seq=S):
    """``tests/test_archs_smoke.py``'s split, drawn with numpy."""
    n_feat, n_tok = token_splits(cfg, seq)
    n_feat = min(n_feat, seq // 2) if n_feat else 0
    n_tok = seq - n_feat
    out = {}
    if n_feat:
        out["features"] = rng.standard_normal(
            (batch, n_feat, cfg.feature_dim)).astype(np.float32)
    if n_tok:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (batch, n_tok),
                                     dtype=np.int32)
    return out


def _torch_batch(batch):
    return {k: torch.as_tensor(v).long() if v.dtype == np.int32
            else torch.as_tensor(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def _ref():
    """name -> the JAX package's side of every test below, computed on
    first use."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _reference(name)
        return cache[name]
    return get


def _reference(name):
    cfg = jarchs.get(name, smoke=True)
    jp = JT.init_params(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(0)
    batch = smoke_inputs(cfg, rng)
    batch["labels"] = rng.integers(0, cfg.vocab_size, (B, S),
                                   dtype=np.int32)
    batch["loss_mask"] = (rng.random((B, S)) < 0.8).astype(np.float32)
    opt = jadam.AdamConfig(lr=LR)
    step = jsteps.make_train_step(cfg, opt)

    @jax.jit
    def run(p, b):       # one compile: forward, the step and its gradients
        out = JT.forward(p, cfg, {k: b[k] for k in ("features", "tokens")
                                  if k in b})
        p1, _, m = step(p, jadam.init_adam_state(p, opt), b)
        g = jax.grad(lambda q: jsteps.lm_loss(q, cfg, b))(p)
        return out["logits"], out["aux_loss"], p1, m, g

    logits, aux, jp1, jm, grads = run(jp, batch)
    return dict(cfg=cfg, params=jp, batch=batch, logits=logits,
                aux=aux, count=JT.count_params(jp), stepped=jp1,
                metrics=jm, grads=grads)


def _port(ref):
    tcfg = tarchs.get(ref["cfg"].name.removesuffix("-smoke"), smoke=True)
    tp = bridge.from_numpy_params(
        jax.tree_util.tree_map(np.asarray, ref["params"]), tcfg, "cpu")
    return tcfg, tp


@pytest.mark.parametrize("name", ALL_ARCHS)
def test_reduced_config_limits(name):
    cfg = tarchs.get(name, smoke=True)
    cfg.validate()
    assert cfg.n_layers <= 2
    assert cfg.d_model <= 512
    if cfg.has_moe:
        assert cfg.n_experts <= 4
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jarchs.get(name, smoke=True))


@pytest.mark.parametrize("name", ALL_ARCHS)
def test_forward_matches_reference(name, _ref):
    ref = _ref(name)
    tcfg, tp = _port(ref)
    inputs = _torch_batch({k: ref["batch"][k] for k in ("features", "tokens")
                           if k in ref["batch"]})
    with torch.no_grad():
        out = TT.forward(tp, tcfg, inputs)
    assert tuple(out["logits"].shape) == (B, S, tcfg.vocab_size)
    assert bool(torch.isfinite(out["logits"]).all())
    np.testing.assert_allclose(_np(out["logits"]), np.asarray(ref["logits"]),
                               **TOL)
    np.testing.assert_allclose(float(out["aux_loss"]), float(ref["aux"]),
                               **TOL)
    n = TT.count_params(tp)
    assert n == ref["count"]
    assert abs(n - tcfg.param_count()) / n < 0.05
    # a fresh port init has the same leaves, hence the same count
    assert TT.count_params(TT.init_params(tcfg, seed=0)) == n


@pytest.mark.parametrize("name", ALL_ARCHS)
def test_one_train_step_matches_reference(name, _ref):
    ref = _ref(name)
    tcfg, tp = _port(ref)
    tb = _torch_batch(ref["batch"])
    opt = tadam.AdamConfig(lr=LR)
    tp1, to1, tm = tsteps.make_train_step(tcfg, opt)(
        tp, tadam.init_adam_state(tp, opt), tb)
    jm = ref["metrics"]
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=2e-4)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                   rel=2e-4)
    assert int(to1["step"]) == 1
    with torch.enable_grad():
        flat = [p.detach().requires_grad_(True) for p in tree_leaves(tp)]
        loss = tsteps.lm_loss(tree_unflatten(tp, flat), tcfg, tb)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    n_firm = n_all = 0
    moved = 0.0
    for a, a0, b, g, gj in zip(tree_leaves(tp1), tree_leaves(tp),
                               jax.tree_util.tree_leaves(ref["stepped"]),
                               grads,
                               jax.tree_util.tree_leaves(ref["grads"])):
        d = np.abs(_np(a) - np.asarray(b))
        g = np.zeros(d.shape) if g is None else _np(g)
        gj = np.asarray(gj)
        firm = (np.abs(g) >= 1e-6) & (np.abs(g - gj) <= 1e-3 * np.abs(g))
        n_firm += int(firm.sum())
        n_all += int((np.abs(g) >= 1e-6).sum())
        assert float(d[firm].max(initial=0.0)) <= 2e-6
        assert float(d.max(initial=0.0)) <= 2 * LR + 2e-6
        moved += float(np.abs(_np(a) - _np(a0)).sum())
    assert n_firm > 0.9 * n_all
    assert moved > 0


@pytest.mark.parametrize("name", DECODE_ARCHS)
def test_decode_matches_forward(name, _ref):
    """``tests/test_archs_smoke.py``'s decode check (MoE capacity 8: no
    token dropped) on the port, each step also against the JAX decode."""
    ref = _ref(name)
    cfg = ref["cfg"]
    tcfg, tp = _port(ref)
    if cfg.has_moe:
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
        tcfg = dataclasses.replace(tcfg, capacity_factor=8.0)
    Sd, Sp = 24, 20
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, Sd),
                                             dtype=np.int32)
    tt = torch.as_tensor(toks).long()
    with torch.no_grad():
        full = TT.forward(tp, tcfg, {"tokens": tt})["logits"]
        cache = TT.forward(tp, tcfg, {"tokens": tt[:, :Sp]},
                           return_cache=True, max_cache_len=Sd)["cache"]
        jcache = JT.forward(ref["params"], cfg,
                            {"tokens": jnp.asarray(toks[:, :Sp])},
                            return_cache=True, max_cache_len=Sd,
                            remat=False)["cache"]
        for t in range(Sp, Sd):
            logits, cache = TT.decode_step(tp, tcfg, tt[:, t:t + 1], cache)
            jl, jcache = JT.decode_step(ref["params"], cfg,
                                        jnp.asarray(toks[:, t:t + 1]), jcache)
            np.testing.assert_allclose(_np(logits), np.asarray(jl), **TOL)
            np.testing.assert_allclose(_np(logits), _np(full[:, t]), **TOL)
