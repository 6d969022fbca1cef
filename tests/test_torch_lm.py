"""The LM train mode: ``launch.steps`` (loss and one functional Adam step)
and ``launch.train``'s LM mode, against the JAX package on bridged
weights and the same numpy batch.

Tolerances (fp32): loss and grad norm within rtol 2e-4; gradients leaf
by leaf within rtol 2e-4 and atol 2e-4 x the leaf's largest |g|;
post-Adam parameters within 2e-6 where |g| >= 1e-6 and the two packages'
gradients agree within 1e-3 of |g|, else within 2*lr + 2e-6.  Adam's
first step is about lr*g/(|g| + eps): where |g| is near eps, a gradient
that differs by rounding (the MoE smoke's attention gradients of about
1e-6 differ by about 2% between the packages) moves the parameter by a
visible fraction of lr (see ``tests/test_torch_rl.py``)."""
import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.archs import SMOKE  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim import adam as jadam  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import archs as tarchs  # noqa: E402
from repro_torch.configs.shapes import token_splits  # noqa: E402
from repro_torch.data.synthetic import random_lm_batch  # noqa: E402
from repro_torch.launch import steps as tsteps, train as tlaunch  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.optim import adam as tadam  # noqa: E402
from repro_torch.tree import tree_leaves, tree_unflatten  # noqa: E402


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


LR = 1e-3
# hubert-xlarge: audio frames only, non-causal; pixtral-12b: image
# patches in front of its tokens
ARCHS = ["qwen3-0.6b", "mixtral-8x7b", "gemma2-27b", "hubert-xlarge",
         "pixtral-12b"]


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _setup(arch, B=2, S=12):
    jcfg = dataclasses.replace(SMOKE[arch], dtype="float32")
    tcfg = dataclasses.replace(tarchs.SMOKE[arch], dtype="float32")
    jp = JT.init_params(jax.random.PRNGKey(1), jcfg)
    tp = bridge.from_numpy_params(jax.tree_util.tree_map(np.asarray, jp),
                                  tcfg, "cpu")
    rng = np.random.default_rng(0)
    n_feat, n_tok = token_splits(tcfg, S)
    batch = {}
    if n_feat:
        batch["features"] = rng.standard_normal(
            (B, n_feat, jcfg.feature_dim)).astype(np.float32)
    if n_tok:
        batch["tokens"] = rng.integers(0, jcfg.vocab_size, (B, n_tok),
                                       dtype=np.int32)
    batch["labels"] = rng.integers(0, jcfg.vocab_size, (B, S),
                                   dtype=np.int32)
    batch["loss_mask"] = (rng.random((B, S)) < 0.8).astype(np.float32)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    for k in ("tokens", "labels"):
        if k in tb:
            tb[k] = tb[k].long()
    return jcfg, tcfg, jp, tp, batch, tb


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_matches_reference(arch):
    jcfg, tcfg, jp, tp, batch, tb = _setup(arch)
    want = float(jsteps.lm_loss(jp, jcfg, batch))
    with torch.no_grad():
        got = float(tsteps.lm_loss(tp, tcfg, tb))
    assert got == pytest.approx(want, rel=2e-4)
    # no mask: the mean over every position
    nb = {k: v for k, v in batch.items() if k != "loss_mask"}
    with torch.no_grad():
        got = float(tsteps.lm_loss(tp, tcfg, {k: v for k, v in tb.items()
                                               if k != "loss_mask"}))
    assert got == pytest.approx(float(jsteps.lm_loss(jp, jcfg, nb)),
                                rel=2e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_train_step_matches_reference(arch):
    jcfg, tcfg, jp, tp, batch, tb = _setup(arch)
    opt_j = jadam.AdamConfig(lr=LR, total_steps=5)
    opt_t = tadam.AdamConfig(lr=LR, total_steps=5)
    jstep = jax.jit(jsteps.make_train_step(jcfg, opt_j))
    tstep = tsteps.make_train_step(tcfg, opt_t)
    jp1, jo1, jm = jstep(jp, jadam.init_adam_state(jp, opt_j), batch)
    tp1, to1, tm = tstep(tp, tadam.init_adam_state(tp, opt_t), tb)
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=2e-4)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                   rel=2e-4)
    assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    assert int(to1["step"]) == int(jo1["step"]) == 1
    with torch.enable_grad():
        flat = [p.detach().requires_grad_(True) for p in tree_leaves(tp)]
        loss = tsteps.lm_loss(tree_unflatten(tp, flat), tcfg, tb)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    jgrads = jax.tree_util.tree_leaves(
        jax.grad(lambda p: jsteps.lm_loss(p, jcfg, batch))(jp))
    n_firm = 0
    for a, b, g, gj in zip(tree_leaves(tp1), jax.tree_util.tree_leaves(jp1),
                           grads, jgrads):
        d = np.abs(_np(a) - np.asarray(b))
        g = np.zeros(d.shape) if g is None else _np(g)
        gj = np.asarray(gj)
        np.testing.assert_allclose(
            g, gj, rtol=2e-4, atol=2e-4 * float(np.abs(gj).max()))
        firm = (np.abs(g) >= 1e-6) & (np.abs(g - gj) <= 1e-3 * np.abs(g))
        n_firm += int(firm.sum())
        assert float(d[firm].max(initial=0.0)) <= 2e-6
        assert float(d.max(initial=0.0)) <= 2 * LR + 2e-6
    assert n_firm > 0.9 * sum(g.numel() for g in grads if g is not None)


def test_random_lm_batch_is_next_token():
    g = torch.Generator().manual_seed(3)
    b = random_lm_batch(g, 3, 10, 50)
    assert b["tokens"].shape == b["labels"].shape == (3, 10)
    assert torch.equal(b["labels"][:, :-1], b["tokens"][:, 1:])
    assert torch.equal(b["labels"][:, -1], b["tokens"][:, 0])
    assert int(b["tokens"].min()) >= 0 and int(b["tokens"].max()) < 50
    assert b["loss_mask"].dtype == torch.float32
    assert float(b["loss_mask"].sum()) == 30
    b2 = random_lm_batch(torch.Generator().manual_seed(3), 3, 10, 50)
    assert torch.equal(b["tokens"], b2["tokens"])


def test_launcher_lm_mode_smoke(capsys):
    out = tlaunch.main(["--arch", "qwen3-0.6b", "--smoke", "--steps", "3",
                        "--batch", "2", "--seq", "16", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("arch=qwen3-0.6b-smoke")
    assert [ln.split()[:2] for ln in lines if ln.startswith("step")] == \
        [["step", "0"], ["step", "1"], ["step", "2"]]
    assert lines[-1] == "done"
    assert all(math.isfinite(v) for v in out["losses"] + out["grad_norms"])
    # independent uniform labels: step 0 sits near ln V (the init's logit
    # spread adds about sigma^2 / 2 with sigma = 0.02 sqrt(d_model))
    V = out["cfg"].vocab_size
    assert abs(out["losses"][0] - math.log(V)) < 0.2
    assert int(out["opt_state"]["step"]) == 3


@pytest.mark.parametrize("arch,n_feat,n_tok", [("hubert-xlarge", 16, 0),
                                               ("pixtral-12b", 8, 8)])
def test_launcher_lm_mode_feature_frontends(arch, n_feat, n_tok, capsys):
    """``make_batch`` follows ``token_splits`` (features in the config's
    dtype, drawn from the generator); the launcher's LM mode trains
    both feature-frontend architectures."""
    cfg = tarchs.get(arch, smoke=True)
    b = tlaunch.make_batch(cfg, torch.Generator().manual_seed(0), 2, 16)
    assert tuple(b["features"].shape) == (2, n_feat, cfg.feature_dim)
    assert b["features"].dtype == torch.float32
    assert ("tokens" in b) == (n_tok > 0)
    if n_tok:
        assert tuple(b["tokens"].shape) == (2, n_tok)
    assert tuple(b["labels"].shape) == tuple(b["loss_mask"].shape) == (2, 16)
    b2 = tlaunch.make_batch(cfg, torch.Generator().manual_seed(0), 2, 16)
    assert all(torch.equal(b[k], b2[k]) for k in b)
    out = tlaunch.main(["--arch", arch, "--smoke", "--steps", "2",
                        "--batch", "2", "--seq", "16", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith(f"arch={arch}-smoke")
    assert lines[-1] == "done"
    assert len(out["losses"]) == 2
    assert all(math.isfinite(v) for v in out["losses"] + out["grad_norms"])
    assert int(out["opt_state"]["step"]) == 2


def test_donated_train_step_matches_functional():
    """``make_train_step(donate=True)`` (the launcher's loop) gives bit for
    bit the functional step's parameters and moments, written into the
    tensors it was given; two steps in a row (bf16 parameters, fp32
    moments)."""
    tcfg = tarchs.get("pixtral-12b", smoke=True)
    params = TT.init_params(tcfg, seed=0, dtype="bfloat16")
    opt = tadam.AdamConfig(lr=LR, total_steps=5)
    gen = torch.Generator().manual_seed(1)
    batches = [tlaunch.make_batch(tcfg, gen, 2, 16) for _ in range(2)]
    fp, fo = params, tadam.init_adam_state(params, opt)
    dp = tree_unflatten(params, [t.clone() for t in tree_leaves(params)])
    do = tadam.init_adam_state(dp, opt)
    step_f = tsteps.make_train_step(tcfg, opt)
    step_d = tsteps.make_train_step(tcfg, opt, donate=True)
    for b in batches:
        fp, fo, fm = step_f(fp, fo, b)
        mine = [id(t) for t in tree_leaves((dp, do["m"], do["v"]))]
        dp, do, dm = step_d(dp, do, b)
        assert [id(t) for t in tree_leaves((dp, do["m"], do["v"]))] == mine
        assert float(dm["loss"]) == float(fm["loss"])
        for a, c in zip(tree_leaves((dp, do)), tree_leaves((fp, fo))):
            assert a.dtype == c.dtype and torch.equal(a, c)
