"""RL math, the optimizer and the trainer's steps: the port against the JAX
package on the same numpy inputs and bridged weights.

Tolerances: 2e-4 in fp32 (TF32 off) for losses, log-probs, values and
advantages; 1e-6 for ``adam_update`` on identical gradients.  Gradients
of the actor and critic steps: every leaf within rtol 2e-4 and atol
2e-4 x that leaf's largest |g|.  Post-Adam parameters: see
``_assert_post_adam``.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.archs import SMOKE  # noqa: E402
from repro.data.synthetic import AdditionTask as JTask, VOCAB_SIZE  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim import adam as jadam  # noqa: E402
from repro.rl import gae as jgae, losses as jlosses  # noqa: E402
from repro.rl import rewards as jrewards, rollout as jrollout  # noqa: E402
from repro.rl import sync as jsync  # noqa: E402
from repro.rl.trainer import RLConfig as JRL, RLTrainer as JTrainer  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import archs as tarchs  # noqa: E402
from repro_torch.data.synthetic import AdditionTask as TTask  # noqa: E402
from repro_torch.kernels import ops as kernel_ops  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.optim import adam as tadam  # noqa: E402
from repro_torch.rl import gae as tgae, losses as tlosses  # noqa: E402
from repro_torch.rl import rewards as trewards, rollout as trollout  # noqa: E402
from repro_torch.rl import sync as tsync  # noqa: E402
from repro_torch.rl.trainer import RLConfig as TRL, RLTrainer as TTrainer  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
LR = 1e-3
CFG = dataclasses.replace(SMOKE["qwen3-0.6b"], vocab_size=VOCAB_SIZE,
                          dtype="float32")
TCFG = dataclasses.replace(tarchs.SMOKE["qwen3-0.6b"], vocab_size=VOCAB_SIZE,
                           dtype="float32")


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _close(a, b, **tol):
    np.testing.assert_allclose(_np(a), _np(b), **(tol or TOL))


def _rl_inputs(seed=0, B=8, T=6, group=4):
    rng = np.random.default_rng(seed)
    mask = np.ones((B, T), np.float32)
    lens = rng.integers(1, T + 1, B)
    for i, n in enumerate(lens):
        mask[i, n:] = 0.0
    return {"lp_new": (-rng.random((B, T)) * 3).astype(np.float32),
            "lp_old": (-rng.random((B, T)) * 3).astype(np.float32),
            "adv": rng.normal(size=(B, T)).astype(np.float32),
            "values": rng.normal(size=(B, T)).astype(np.float32),
            "values_old": rng.normal(size=(B, T)).astype(np.float32),
            "returns": rng.normal(size=(B, T)).astype(np.float32),
            "logits": rng.normal(size=(B, T, VOCAB_SIZE)).astype(np.float32),
            "score": rng.random(B).astype(np.float32),
            "seq_reward": rng.random(B).astype(np.float32),
            "toks": rng.integers(0, VOCAB_SIZE, (B, T)).astype(np.int32),
            "mask": mask, "group": group}


def _math_cases():
    def ppo(m, L, x):
        out = L.ppo_policy_loss(x("lp_new"), x("lp_old"), x("adv"),
                                x("mask"), clip_eps=0.2)
        return [out[k] for k in sorted(out)]

    def value(m, L, x):
        return [L.value_loss(x("values"), x("values_old"), x("returns"),
                             x("mask"), clip_eps=0.2)]

    def entropy(m, L, x):
        return [L.entropy_bonus(x("logits"), x("mask"))]

    def kl(m, L, x):
        return list(L.kl_penalised_rewards(x("score"), x("lp_new"),
                                           x("lp_old"), x("mask"),
                                           kl_beta=0.05))

    def gae(m, L, x):
        return list(m.gae_advantages(x("adv"), x("values") * x("mask"),
                                     x("mask"), gamma=0.99, lam=0.95))

    def grpo(m, L, x):
        return [m.grpo_advantages(x("seq_reward"), 4, x("mask"))]

    def whiten(m, L, x):
        return [m.whiten(x("adv") * x("mask"), x("mask"))]

    def gather(m, L, x):
        return [L.gather_logprobs(x("logits"), x("toks"))]

    return {"ppo_policy_loss": ppo, "value_loss": value,
            "entropy_bonus": entropy, "kl_penalised_rewards": kl,
            "gae_advantages": gae, "grpo_advantages": grpo,
            "whiten": whiten, "gather_logprobs": gather}


@pytest.mark.parametrize("name", sorted(_math_cases()))
def test_rl_math_matches_reference(name):
    """Each objective / advantage function on seeded numpy inputs (ragged
    masks, GRPO groups of 4); GAE's reverse loop against ``lax.scan``."""
    fn = _math_cases()[name]
    inp = _rl_inputs()
    ref = fn(jgae, jlosses, lambda k: jnp.asarray(inp[k]))
    got = fn(tgae, tlosses, lambda k: _t(inp[k]))
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        _close(g, r)


def test_grpo_advantages_use_the_population_std():
    """A group of two rewards 0 and 1: population std 0.5, so the
    advantages are +-1/(0.5 + 1e-4), as ``jnp.std`` gives."""
    r = np.array([0.0, 1.0], np.float32)
    m = np.ones((2, 3), np.float32)
    got = tgae.grpo_advantages(_t(r), 2, _t(m))
    ref = jgae.grpo_advantages(jnp.asarray(r), 2, jnp.asarray(m))
    _close(got, ref, rtol=1e-6, atol=1e-6)
    _close(got[1, 0], 0.5 / 0.5001, rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def weights():
    jp = JT.init_params(jax.random.PRNGKey(4), CFG)
    tp = bridge.from_numpy_params(jax.tree_util.tree_map(np.asarray, jp),
                                  TCFG, "cpu")
    rng = np.random.default_rng(1)
    seqs = rng.integers(0, VOCAB_SIZE, (6, 8)).astype(np.int32)
    return jp, tp, seqs


@pytest.fixture(scope="module")
def ref_logprobs(weights):
    jp, _, seqs = weights
    return jrollout.sequence_logprobs(jp, CFG, jnp.asarray(seqs), 5)


@pytest.mark.parametrize("impl", [None, "plain"])
def test_sequence_logprobs_matches_reference(weights, ref_logprobs, impl):
    jp, tp, seqs = weights
    lj, oj = ref_logprobs
    lt, ot = trollout.sequence_logprobs(tp, TCFG, _t(seqs).long(), 5,
                                        attn_impl=impl)
    assert tuple(lt.shape) == (6, 3)
    _close(lt, lj)
    _close(ot["aux_loss"], oj["aux_loss"])


def test_critic_values_and_reward_scores_match_reference(weights):
    jp, tp, seqs = weights
    key = jax.random.PRNGKey(6)
    jh = jrewards.init_value_head(key, CFG)
    th = bridge.from_numpy_params(jax.tree_util.tree_map(np.asarray, jh),
                                  TCFG, "cpu")
    vj = jrewards.critic_values(jp, jh, CFG, jnp.asarray(seqs), 5)
    vt = trewards.critic_values(tp, th, TCFG, _t(seqs).long(), 5)
    _close(vt, vj)
    last = np.array([7, 6, 5, 7, 3, 4])
    sj = jrewards.reward_model_scores(jp, jh, CFG, jnp.asarray(seqs),
                                      jnp.asarray(last))
    st = trewards.reward_model_scores(tp, th, TCFG, _t(seqs).long(),
                                      _t(last))
    _close(st, sj)


ADAM_CASES = {
    "fp32": dict(),
    "bf16_moments": dict(moment_dtype="bfloat16"),
    "clipped": dict(grad_clip_norm=0.5),
    "unclipped_wd": dict(grad_clip_norm=None, weight_decay=0.1),
    "warmup": dict(warmup_steps=4),
    "warmup_cosine": dict(warmup_steps=2, total_steps=5, min_lr_frac=0.2),
}


@pytest.mark.parametrize("case", sorted(ADAM_CASES))
def test_adam_update_matches_reference(case):
    """Three steps on identical numpy gradients (a nested tree with a
    tuple, as the critic's state is): parameters, moments, lr and the
    global norm within 1e-6."""
    cfg_kw = dict(lr=1e-2, **ADAM_CASES[case])
    rng = np.random.default_rng(3)

    def draw():
        return {"a": rng.normal(size=(4, 5)).astype(np.float32),
                "b": {"c": rng.normal(size=3).astype(np.float32),
                      "d": rng.normal(size=(2, 2, 3)).astype(np.float32)}}
    p0 = (draw(), {"w": rng.normal(size=(5, 1)).astype(np.float32)})
    grads = [(draw(), {"w": rng.normal(size=(5, 1)).astype(np.float32)})
             for _ in range(3)]
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    tp = tuple(_tree_t(x) for x in p0)
    jc, tc = jadam.AdamConfig(**cfg_kw), tadam.AdamConfig(**cfg_kw)
    js, ts = jadam.init_adam_state(jp, jc), tadam.init_adam_state(tp, tc)
    jupdate = jax.jit(jadam.adam_update, static_argnums=3)
    for g in grads:
        jp, js, jm = jupdate(jp, jax.tree_util.tree_map(jnp.asarray, g), js,
                             jc)
        tp, ts, tm = tadam.adam_update(tp, tuple(_tree_t(x) for x in g),
                                       ts, tc)
        tol = dict(rtol=1e-6, atol=1e-6)
        for a, b in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
            _close(a, b, **tol)
        for k in ("m", "v"):
            for a, b in zip(tree_leaves(ts[k]),
                            jax.tree_util.tree_leaves(js[k])):
                assert str(a.dtype).endswith(str(b.dtype))
                _close(a.float(), np.asarray(b, np.float32), **tol)
        assert int(ts["step"]) == int(js["step"])
        _close(tm["lr"], jm["lr"], **tol)
        _close(tm["grad_norm"], jm["grad_norm"], **tol)


def _tree_t(x):
    if isinstance(x, dict):
        return {k: _tree_t(v) for k, v in x.items()}
    return _t(x)


def test_tree_bytes_and_sync_weights(weights):
    jp, tp, _ = weights
    assert tsync.tree_bytes(tp) == jsync.tree_bytes(jp)
    gen, n = tsync.sync_weights(tp)
    assert gen is tp and n == jsync.tree_bytes(jp)
    # a target placement on the training placement's single device: the
    # reference's identity handoff (the moves over ranks:
    # tests/test_torch_sharded.py)
    from repro_torch.engine import placement as tplace
    grid = np.empty((1, 1), dtype=object)
    grid[0, 0] = torch.device("cpu")
    pl = tplace.TaskPlacement(0, 1, 1, 1, (0,), (torch.device("cpu"),),
                              tplace.LocalMesh(grid), grid=grid)
    gen, n = tsync.sync_weights(tp, tplace.ParamShardings(pl, None),
                                source=pl)
    assert gen is tp and n == jsync.tree_bytes(jp)


# ---------------------------------------------------------------------------
# actor_step / critic_step on a seeded batch
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trainers():
    """PPO trainers of both packages (colocate-all default plan) on the
    same state: the reference's, carried across with the bridge."""
    rl = dict(algorithm="ppo", n_rollouts=4, max_new_tokens=3, lr=LR)
    J = JTrainer(CFG, JRL(**rl), JTask(max_operand=9), jax.random.PRNGKey(0))
    P = TTrainer(TCFG, TRL(**rl), TTask(max_operand=9), seed=0, device="cpu")
    P.load_state_tree(bridge.from_numpy_state_tree(
        jax.tree_util.tree_map(np.asarray, J.state_tree()), TCFG, "cpu"))
    rng = np.random.default_rng(11)
    B, S, G = 8, 8, 5
    inp = _rl_inputs(seed=12, B=B, T=S - G)
    batch = {"sequences": rng.integers(0, VOCAB_SIZE, (B, S)).astype(
                 np.int32),
             "logp_old": inp["lp_old"], "advantages": inp["adv"],
             "mask": inp["mask"], "values_old": inp["values_old"],
             "returns": inp["returns"]}
    return J, P, batch, G


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tbatch(batch):
    out = {k: _t(v) for k, v in batch.items()}
    out["sequences"] = out["sequences"].long()
    return out


def _assert_grads(tgrads, jgrads):
    """Every leaf within rtol 2e-4 and atol 2e-4 x its largest |g|."""
    tl, jl = tree_leaves(tgrads), jax.tree_util.tree_leaves(jgrads)
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        b = np.asarray(b)
        scale = float(np.abs(b).max())
        np.testing.assert_allclose(_np(a), b, rtol=2e-4,
                                   atol=2e-4 * max(scale, 1e-30))


def _assert_post_adam(tparams, jparams, jgrads, lr):
    """Adam's first step moves each parameter by lr*g/(|g| + eps), about
    lr*sign(g).  Where the reference's |g| >= 1e-6 (a hundred times eps)
    the step is fixed by the gradient to far below 1e-7, so those
    parameters must agree within 2e-6 (fp32 rounding of the weights
    themselves).  Where |g| < 1e-6 the sign of a gradient near the
    rounding floor may differ between the packages, and the step differs
    by at most 2*lr: those parameters are held within 2*lr + 2e-6."""
    for a, b, g in zip(tree_leaves(tparams),
                       jax.tree_util.tree_leaves(jparams),
                       jax.tree_util.tree_leaves(jgrads)):
        a, b, g = _np(a), np.asarray(b), np.abs(np.asarray(g))
        d = np.abs(a - b)
        firm = g >= 1e-6
        assert float(d[firm].max(initial=0.0)) <= 2e-6
        assert float(d.max(initial=0.0)) <= 2 * lr + 2e-6


def _jax_actor_loss(params, batch, G):
    lp, out = jrollout.sequence_logprobs(params, CFG, batch["sequences"], G)
    pl = jlosses.ppo_policy_loss(lp, batch["logp_old"], batch["advantages"],
                                 batch["mask"], clip_eps=0.2)
    return pl["loss"] + out["aux_loss"], pl


def _jax_critic_loss(cp, batch, G):
    v = jrewards.critic_values(cp[0], cp[1], CFG, batch["sequences"], G)
    return 0.5 * jlosses.value_loss(v, batch["values_old"], batch["returns"],
                                    batch["mask"], clip_eps=0.2)


def test_actor_step_matches_reference(trainers):
    """Loss, policy metrics, per-leaf gradients, grad norm, lr, Adam's
    moments and the stepped parameters of one actor step."""
    J, P, batch, G = trainers
    jb, tb = _jbatch(batch), _tbatch(batch)
    @jax.jit
    def ref(params, opt, batch):       # one compile: gradients and step
        return (jax.value_and_grad(_jax_actor_loss, has_aux=True)(
            params, batch, G), J._actor_step_raw(params, opt, batch, G))
    ((jloss, jpl), jgrads), (jnew, jopt, jm) = ref(J.actor, J.actor_opt, jb)
    tloss, tpl, tgrads = P.actor_grads(P.actor, tb, G)
    _close(tloss, jloss)
    for k in jpl:
        _close(tpl[k], jpl[k])
    _assert_grads(tgrads, jgrads)
    tnew, topt, tm = P._actor_step(P.actor, P.actor_opt, tb, G)
    for k in ("loss", "clip_frac", "approx_kl", "ratio_mean", "lr",
              "grad_norm"):
        _close(tm[k], jm[k])
    _assert_post_adam(tnew, jnew, jgrads, LR)
    assert int(topt["step"]) == int(jopt["step"]) == 1
    for a, b in zip(tree_leaves(topt["m"]),
                    jax.tree_util.tree_leaves(jopt["m"])):
        b = np.asarray(b)
        np.testing.assert_allclose(_np(a), b, rtol=2e-4,
                                   atol=2e-4 * max(float(np.abs(b).max()),
                                                   1e-30))
    # functional: the old parameters are untouched
    for a, b in zip(tree_leaves(P.actor), jax.tree_util.tree_leaves(J.actor)):
        np.testing.assert_array_equal(_np(a), np.asarray(b))


def test_critic_step_matches_reference(trainers):
    J, P, batch, G = trainers
    jb, tb = _jbatch(batch), _tbatch(batch)
    jcp = (J.critic, J.value_head)
    @jax.jit
    def ref(cp, opt, batch):           # one compile: gradients and step
        return (jax.value_and_grad(_jax_critic_loss)(cp, batch, G),
                J._critic_step_raw(cp, opt, batch, G))
    (jloss, jgrads), (jnew, jopt, jl) = ref(jcp, J.critic_opt, jb)
    tloss, tgrads = P.critic_grads((P.critic, P.value_head), tb, G)
    _close(tloss, jloss)
    _assert_grads(tgrads, jgrads)
    tnew, topt, tl = P._critic_step((P.critic, P.value_head), P.critic_opt,
                                    tb, G)
    _close(tl, jl)
    _assert_post_adam(tnew, jnew, jgrads, LR)
    assert isinstance(tnew, tuple) and set(tnew[1]) == {"w"}


def test_train_steps_never_enter_a_kernel_wrapper(trainers, monkeypatch):
    """The §0 routing: with both attention kernel entry points made to
    raise, one actor step and one critic step still run (TRAIN takes the
    plain attention explicitly), while the INF forward on the default
    path does reach them."""
    J, P, batch, G = trainers
    tb = _tbatch(batch)

    def boom(*a, **k):
        raise AssertionError("a training step entered a kernel wrapper")
    monkeypatch.setattr(kernel_ops, "flash_attention", boom)
    monkeypatch.setattr(kernel_ops, "flash_decode_attention", boom)
    P._actor_step(P.actor, P.actor_opt, tb, G)
    P._critic_step((P.critic, P.value_head), P.critic_opt, tb, G)
    with pytest.raises(AssertionError, match="kernel wrapper"):
        P._ref_logp(P.ref, tb["sequences"], G)
    with pytest.raises(AssertionError, match="kernel wrapper"):
        TT.forward(P.actor, TCFG, {"tokens": tb["sequences"]})
    TT.forward(P.actor, TCFG, {"tokens": tb["sequences"]}, attn_impl="plain")
