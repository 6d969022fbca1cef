"""The trainer's sharded steps on 4 gloo ranks over one 2x2 ("data",
"model") mesh, against the JAX package's single-device steps on the same
bridged weights and batch, and against the port's own world of one.

The ranks run in a subprocess with a timeout of its own
(``tests/torch_sharded_ranks.py``: ``parallel.dist.spawn``, one thread a
rank, FileStore rendezvous), on the e2e actor (d 192, 4 layers, 4:2
heads of 48, vocab 16) in fp32.  Tolerances: losses, grad norm,
log-probs and values within 1e-5 relative (atol 1e-6); greedy tokens
identical.  Post-Adam parameters within 1e-5 relative (atol 1e-7) where
the reference's |g| is at least 1e-4 of its leaf's largest |g| (and
1e-6): there the gradient stands well above the fp32 noise of the TP/DP
partial sums (about 1e-6 of the leaf's scale), and Adam's first step,
which divides g by |g|, is fixed by it.  Below that the noise moves
g / |g| (a gradient at the floor may even change sign), so those
parameters are held within 2*lr + 2e-6, as ``tests/test_torch_rl.py``
holds its |g| < 1e-6.
"""
import os
import pickle
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.data.synthetic import AdditionTask as JTask  # noqa: E402
from repro.models.config import ModelConfig as JConfig  # noqa: E402
from repro.rl import losses as jlosses, rewards as jrewards  # noqa: E402
from repro.rl import rollout as jrollout  # noqa: E402
from repro.rl.trainer import RLConfig as JRL, RLTrainer as JTrainer  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.data.synthetic import AdditionTask as TTask  # noqa: E402
from repro_torch.models.config import ModelConfig as TConfig  # noqa: E402
from repro_torch.rl.trainer import RLConfig as TRL, RLTrainer as TTrainer  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HELPER = os.path.join(REPO, "tests", "torch_sharded_ranks.py")
E2E = dict(name="rl-actor", n_layers=4, d_model=192, n_heads=4,
           n_kv_heads=2, head_dim=48, d_ff=576, vocab_size=16,
           dtype="float32")
LR = 1e-3
RL = dict(algorithm="ppo", n_rollouts=4, max_new_tokens=3, lr=LR,
          greedy=True)
B, S, G = 8, 8, 5
TOL = dict(rtol=1e-5, atol=1e-6)


def run_world(job, tmp_path, timeout=300):
    """Spawn the job's world in a subprocess; rank 0's results and the
    rest of the job's."""
    inp, out = tmp_path / "job.pkl", tmp_path / "out.pkl"
    with open(inp, "wb") as f:
        pickle.dump(job, f)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(REPO, "src"), os.path.join(REPO, "tests"),
         env.get("PYTHONPATH", "")])
    r = subprocess.run([sys.executable, HELPER, str(inp), str(out)],
                       capture_output=True, text=True, timeout=timeout,
                       env=env, cwd=REPO)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    with open(out, "rb") as f:
        return pickle.load(f)


class Started:
    """A job's world running in a subprocess (``start_world``) while the
    test goes on; ``result()`` waits for it."""

    def __init__(self, job, tmp_path, timeout):
        import time
        self.inp, self.out = tmp_path / "job.pkl", tmp_path / "out.pkl"
        with open(self.inp, "wb") as f:
            pickle.dump(job, f)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [os.path.join(REPO, "src"), os.path.join(REPO, "tests"),
             env.get("PYTHONPATH", "")])
        self.deadline = time.monotonic() + timeout
        self.proc = subprocess.Popen(
            [sys.executable, HELPER, str(self.inp), str(self.out)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=REPO, start_new_session=True)
        self._res = None

    def result(self):
        import time
        if self._res is None:
            try:
                out, err = self.proc.communicate(
                    timeout=max(self.deadline - time.monotonic(), 1.0))
            except subprocess.TimeoutExpired:
                self.stop()
                raise AssertionError("the ranks did not end in time")
            assert self.proc.returncode == 0, \
                f"stdout:\n{out}\nstderr:\n{err}"
            with open(self.out, "rb") as f:
                self._res = pickle.load(f)
        return self._res

    def stop(self):
        """End the subprocess and its ranks (its process group)."""
        import signal
        if self.proc.poll() is None:
            try:
                os.killpg(self.proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            self.proc.communicate()


def start_world(job, tmp_path, timeout=300) -> Started:
    """``run_world`` without waiting: the world starts now."""
    return Started(job, tmp_path, timeout)


def _batch(seed=12):
    rng = np.random.default_rng(seed)
    T = S - G
    mask = np.ones((B, T), np.float32)
    for i, n in enumerate(rng.integers(1, T + 1, B)):
        mask[i, n:] = 0.0
    return {"sequences": rng.integers(0, 16, (B, S)).astype(np.int32),
            "logp_old": (-rng.random((B, T)) * 3).astype(np.float32),
            "advantages": rng.normal(size=(B, T)).astype(np.float32),
            "mask": mask,
            "values_old": rng.normal(size=(B, T)).astype(np.float32),
            "returns": rng.normal(size=(B, T)).astype(np.float32)}


def _jax_actor_loss(params, batch, cfg):
    lp, out = jrollout.sequence_logprobs(params, cfg, batch["sequences"], G)
    pl = jlosses.ppo_policy_loss(lp, batch["logp_old"], batch["advantages"],
                                 batch["mask"], clip_eps=0.2)
    return pl["loss"] + out["aux_loss"]


def _jax_critic_loss(cp, batch, cfg):
    v = jrewards.critic_values(cp[0], cp[1], cfg, batch["sequences"], G)
    return 0.5 * jlosses.value_loss(v, batch["values_old"], batch["returns"],
                                    batch["mask"], clip_eps=0.2)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The JAX package's single-device steps, the port's world of one,
    and the 4-rank world, on the same state, batch and prompts."""
    jcfg = JConfig(**E2E)
    J = JTrainer(jcfg, JRL(**RL), JTask(max_operand=9),
                 jax.random.PRNGKey(0))
    state = jax.tree_util.tree_map(np.asarray, J.state_tree())
    batch = _batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    prompts = np.random.default_rng(3).integers(0, 16, (B, G)).astype(
        np.int32)
    ref = {}
    ref["actor"], _, ref["actor_metrics"] = J._actor_step(
        J.actor, J.actor_opt, jb, gen_start=G)
    ref["actor_grads"] = jax.grad(_jax_actor_loss)(J.actor, jb, jcfg)
    (ref["critic"], ref["value_head"]), _, ref["critic_loss"] = \
        J._critic_step((J.critic, J.value_head), J.critic_opt, jb,
                       gen_start=G)
    ref["critic_grads"] = jax.grad(_jax_critic_loss)(
        (J.critic, J.value_head), jb, jcfg)
    ref["ref_logp"] = J._ref_logp(J.ref, jb["sequences"], gen_start=G)
    ref["values"] = J._critic_vals(J.critic, J.value_head, jb["sequences"],
                                   gen_start=G)
    ref["rollout"] = J._generate(J.gen_params, prompts=jnp.asarray(prompts),
                                 rng=jax.random.PRNGKey(1))
    ref = jax.tree_util.tree_map(np.asarray, ref)

    tcfg = TConfig(**E2E)
    P = TTrainer(tcfg, TRL(**RL), TTask(max_operand=9), seed=0, device="cpu")
    P.load_state_tree(bridge.from_numpy_state_tree(state, tcfg, "cpu"))
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    tb["sequences"] = tb["sequences"].long()
    one = {}
    one["actor"], one["actor_opt"], one["actor_metrics"] = P._actor_step(
        P.actor, P.actor_opt, tb, gen_start=G)
    (one["critic"], one["value_head"]), _, one["critic_loss"] = \
        P._critic_step((P.critic, P.value_head), P.critic_opt, tb,
                       gen_start=G)
    with torch.inference_mode():
        one["rollout"] = P._generate(P.gen_params,
                                     torch.as_tensor(prompts).long(), None)

    job = {"kind": "steps", "world": 4, "timeout": 240, "cfg": tcfg,
           "rl": TRL(**RL), "state": state, "batch": batch, "gen_start": G,
           "prompts": prompts}
    res = run_world(job, tmp_path_factory.mktemp("sharded"))
    return ref, one, res["ranks"]


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _assert_post_adam(got, want, grads):
    for a, b, g in zip(tree_leaves(got), jax.tree_util.tree_leaves(want),
                       jax.tree_util.tree_leaves(grads)):
        a, b, g = _np(a), np.asarray(b), np.abs(np.asarray(g))
        d = np.abs(a - b)
        firm = g >= max(1e-6, 1e-4 * float(g.max(initial=0.0)))
        assert np.all(d[firm] <= 1e-7 + 1e-5 * np.abs(b[firm]))
        assert float(d.max(initial=0.0)) <= 2 * LR + 2e-6


def test_ranks_agree_and_mesh_is_2x2(world):
    _, _, ranks = world
    assert len(ranks) == 4
    shape, rk = ranks[0]["mesh"]["actor_training"]
    assert tuple(shape) == (2, 2) and tuple(rk) == (0, 1, 2, 3)
    # storage: wq [R, d, H*hd] FSDP over data on d, TP over model on H*hd
    assert ranks[0]["actor_placements"] == "(Shard(dim=1), Shard(dim=2))"
    # Adam's step counter replicated; the batch over data
    assert ranks[0]["step_replicated"] is True
    assert ranks[0]["batch_placements"] == "(Shard(dim=0), Replicate())"
    for r in ranks[1:]:
        for a, b in zip(tree_leaves(r["actor"]),
                        tree_leaves(ranks[0]["actor"])):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(r["rollout"]["sequences"],
                                      ranks[0]["rollout"]["sequences"])


def test_sharded_actor_step_matches_reference(world):
    ref, one, ranks = world
    got = ranks[0]
    for k in ("loss", "grad_norm", "clip_frac", "approx_kl", "ratio_mean"):
        np.testing.assert_allclose(got["actor_metrics"][k],
                                   ref["actor_metrics"][k], **TOL)
        np.testing.assert_allclose(got["actor_metrics"][k],
                                   float(one["actor_metrics"][k]), **TOL)
    assert got["actor_metrics"]["loss"] != 0.0
    _assert_post_adam(got["actor"], ref["actor"], ref["actor_grads"])
    _assert_post_adam(got["actor"], _np_tree(one["actor"]),
                      ref["actor_grads"])


def _np_tree(tree):
    return jax.tree_util.tree_map(_np, tree)


def test_sharded_actor_step_moments_match_world_of_one(world):
    """Adam's moments after the sharded step, gathered, equal the world
    of one's leaf by leaf (the step counter replicated, 1 on both):
    within 1e-5 relative plus 1e-5 of the leaf's largest moment.  The
    moments carry g and g^2 themselves, so the fp32 noise of the TP/DP
    partial sums shows in them at about 1e-6 of the leaf's scale (2e-6
    at most on this run); a shard in the wrong place or a wrong moment
    is off by the leaf's scale."""
    _, one, ranks = world
    opt, want = ranks[0]["actor_opt"], _np_tree(one["actor_opt"])
    assert int(opt["step"]) == int(want["step"]) == 1
    for key in ("m", "v"):
        got, ref = tree_leaves(opt[key]), tree_leaves(want[key])
        assert len(got) == len(ref) == len(tree_leaves(ranks[0]["actor"]))
        for a, b in zip(got, ref):
            assert a.shape == b.shape
            scale = float(np.abs(b).max(initial=0.0))
            assert scale > 0.0
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * scale)


def test_sharded_critic_step_matches_reference(world):
    ref, one, ranks = world
    got = ranks[0]
    np.testing.assert_allclose(got["critic_loss"], ref["critic_loss"], **TOL)
    np.testing.assert_allclose(got["critic_loss"], float(one["critic_loss"]),
                               **TOL)
    _assert_post_adam((got["critic"], got["value_head"]),
                      (ref["critic"], ref["value_head"]),
                      ref["critic_grads"])


def test_sharded_ref_logp_and_values_match_reference(world):
    ref, _, ranks = world
    np.testing.assert_allclose(ranks[0]["ref_logp"], ref["ref_logp"], **TOL)
    np.testing.assert_allclose(ranks[0]["values"], ref["values"], **TOL)


def test_sharded_greedy_generate_matches_reference(world):
    ref, one, ranks = world
    got = ranks[0]["rollout"]
    np.testing.assert_array_equal(got["sequences"],
                                  ref["rollout"]["sequences"])
    np.testing.assert_array_equal(got["sequences"],
                                  _np(one["rollout"]["sequences"]))
    np.testing.assert_array_equal(got["mask"], ref["rollout"]["mask"])
    np.testing.assert_allclose(got["logprobs"], ref["rollout"]["logprobs"],
                               **TOL)


def test_sharded_genserve_gen_names_item_9b(world):
    """The path the item named (a sharded GEN on the genserve engine,
    refused until it was ported) runs on the GEN mesh: its greedy tokens
    and mask equal the single-wave sharded path's and the JAX package's,
    on every rank, with log-probs within the file's tolerance."""
    ref, _, ranks = world
    for r in ranks:
        got = r["genserve_rollout"]
        assert r["genserve_engine"] == "genserve"
        for k in ("sequences", "gen_tokens", "mask"):
            np.testing.assert_array_equal(got[k], r["rollout"][k])
        np.testing.assert_array_equal(got["sequences"],
                                      ref["rollout"]["sequences"])
        np.testing.assert_allclose(got["logprobs"],
                                   ref["rollout"]["logprobs"], **TOL)


@pytest.mark.parametrize("kernel", ["flash_attention", "decode_attention",
                                    "rwkv6_scan", "mamba_scan"])
def test_kernel_wrappers_take_dtensors(world, kernel):
    """Each wrapper on DTensors runs per rank on its local rows (over
    data) and heads or channels (over model) through ``local_map``; on
    the CPU each rank's call is the plain version."""
    _, _, ranks = world
    err, placements = ranks[0]["kernels"][kernel]
    assert err <= 1e-6, (kernel, err)
    assert placements == "(Shard(dim=0), Shard(dim=%d))" % (
        1 if kernel == "decode_attention" else 2)

