"""Sharded plan execution on 8 gloo ranks: the port of
``tests/test_sharded_exec.py`` / ``examples/sharded_exec.py``
(``repro_torch.launch.sharded_exec``).

GEN on ranks 0-3 and the inference and training tasks on ranks 4-7
(GEN and TRAIN at DP=2/TP=2), asynchronous GRPO, from the JAX package's
initial state.  The ranks run in a subprocess with a timeout of its own
(``tests/torch_sharded_ranks.py``), which also runs the same plan folded
onto one device (the port's world of one).  Held: every assertion of
the example — disjoint GEN/TRAIN ranks, zero collisions, train mesh
(2, 2), ``overlap_active`` and ``overlap_honest`` 1.0, one-step
staleness, GRPO losses within the example's rtol 5e-2 / atol 1e-4 with
a loss that is not zero — plus greedy tokens identical to the world of
one and to the JAX package's single-device run, weight-sync bytes
equal to ``tree_bytes(actor)``, the GEN ranks' weights equal to the
actor bit for bit after every iteration, and the attention calls of the
path on DTensors at its per-rank shapes against the plain versions.  Sampled tokens are identical to the
world of one while GEN decodes with the initial weights; after the first
weight sync at least 95% of them (``sharded_exec.AGREEMENT``): Adam's
first step turns the fp32 reduction-order noise of the TP/DP partial
sums in a near-zero gradient into a parameter difference of up to 2*lr,
and a sample at a boundary of the categorical may then take the next
token (one of 64 on this run's third iteration).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import enumerate as jenum, topology as jtopo  # noqa: E402
from repro.core import workflow as jwf  # noqa: E402
from repro.data.synthetic import AdditionTask as JTask  # noqa: E402
from repro.models.config import ModelConfig as JConfig  # noqa: E402
from repro.rl import sync as jsync  # noqa: E402
from repro.rl.trainer import RLConfig as JRL, RLTrainer as JTrainer  # noqa: E402
from repro_torch.launch import sharded_exec  # noqa: E402

from test_torch_sharded import run_world  # noqa: E402

ITERS, BATCH = 3, 4


def _jax_trainer(greedy):
    """The example's JAX trainer on one device (its 8-device plan folds
    onto it)."""
    cfg = JConfig(name="sharded-tiny", n_layers=2, d_model=64, n_heads=2,
                  n_kv_heads=2, head_dim=32, d_ff=128, vocab_size=16,
                  dtype="float32")
    task = JTask(max_operand=9)
    rl = JRL(algorithm="grpo", n_rollouts=4, max_new_tokens=4,
             asynchronous=True, greedy=greedy, whiten_advantages=False)
    wf = jwf.make_workflow("grpo", jwf.LLMSpec.from_model_config(cfg),
                           synchronous=False, n_rollouts=4,
                           seq_in=task.prompt_len, seq_out=4,
                           global_batch=1)
    topo = jtopo.build_testbed("single_region", counts={"A100": 4, "L4": 4})
    grouping = next(g for g in jenum.priority_groupings(wf)
                    if len(g) == 2 and any(
                        wf.task(t).kind == jwf.TaskKind.GEN
                        for t in min(g, key=len)))
    gen_gi = next(gi for gi, g in enumerate(grouping)
                  if any(wf.task(t).kind == jwf.TaskKind.GEN for t in g))
    parallel = {t: (2, 1, 2) if wf.task(t).kind in (jwf.TaskKind.GEN,
                                                     jwf.TaskKind.TRAIN)
                else (4, 1, 1) for t in range(wf.n_tasks)}
    order = list(range(8)) if gen_gi == 0 else \
        list(range(4, 8)) + list(range(4))
    plan = jenum.build_plan(topo, wf, grouping, [4, 4], order,
                            parallel=parallel)
    return JTrainer(cfg, rl, task, jax.random.PRNGKey(0), plan=plan,
                    topo=topo, wf=wf, devices=[jax.devices()[0]])


def _jax_tokens(J, iters):
    rng = np.random.default_rng(0)
    key = jax.random.PRNGKey(7)
    out = []
    for _ in range(iters):
        prompts, answers = J.task.sample_batch(rng, BATCH)
        key, k = jax.random.split(key)
        J.iteration(prompts, answers, k)
        out.append(np.asarray(J.engine.pipeline._pending["rollout"]
                              ["gen_tokens"]))
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    J = _jax_trainer(greedy=True)
    state = jax.tree_util.tree_map(np.asarray, J.state_tree())
    actor_bytes = jsync.tree_bytes(J.actor)
    jtokens = _jax_tokens(J, ITERS)
    job = {"kind": "exec", "world": 8, "timeout": 240,
           "cfg": sharded_exec.tiny_cfg(), "iters": ITERS, "batch": BATCH,
           "modes": ("sampled", "greedy"), "state": state}
    res = run_world(job, tmp_path_factory.mktemp("sharded_exec"))
    return res["ranks"], res["world1"], jtokens, actor_bytes


@pytest.mark.parametrize("mode", ["sampled", "greedy"])
def test_example_assertions_hold(world, mode):
    """``sharded_exec.check``: the example's assertions, mode by mode."""
    ranks, one, _, _ = world
    sharded_exec.check(ranks[0][mode], one[mode], greedy=mode == "greedy")


def test_placement_disjoint_and_collision_free(world):
    ranks, one, _, _ = world
    s = ranks[0]["sampled"]
    assert s["world"] == 8 and s["folding_collisions"] == 0
    assert s["gen_ranks"] == [0, 1, 2, 3]
    assert s["train_ranks"] == [4, 5, 6, 7]
    assert s["train_mesh"] == [2, 2] and s["gen_mesh"] == [2, 2]
    assert s["overlap_active"] is True and s["overlap_honest"] == 1.0
    # the world of one folds both groups onto its device: they collide,
    # and the stage walk serializes
    w = one["sampled"]
    assert w["world"] == 1 and w["folding_collisions"] > 0
    assert w["overlap_active"] is False and w["overlap_honest"] == 0.0


def test_every_rank_replays_the_same_run(world):
    ranks, _, _, _ = world
    for r in ranks[1:]:
        for mode in ("sampled", "greedy"):
            assert r[mode]["losses"] == ranks[0][mode]["losses"]
            assert r[mode]["staleness"] == ranks[0][mode]["staleness"]
            for a, b in zip(r[mode]["tokens"], ranks[0][mode]["tokens"]):
                np.testing.assert_array_equal(a, b)


def test_one_step_staleness(world):
    ranks, _, _, _ = world
    for mode in ("sampled", "greedy"):
        st = ranks[0][mode]["staleness"]
        assert len(st) == ITERS - 1 and st[0] == 0
        assert all(s == 1 for s in st[1:])


def test_sampled_tokens_identical_to_world_of_one(world):
    """Identical while GEN decodes with the initial weights (every GEN
    rank draws the whole batch's random numbers from its generator);
    after the first sync, ``sharded_exec.AGREEMENT`` of them."""
    ranks, one, _, _ = world
    s = ranks[0]["sampled"]
    assert s["gen_versions"] == one["sampled"]["gen_versions"]
    assert s["gen_versions"][:2] == [0, 0]
    for a, b, v in zip(s["tokens"], one["sampled"]["tokens"],
                       s["gen_versions"]):
        if v == 0:
            np.testing.assert_array_equal(a, b)
        else:
            assert np.mean(a == b) >= sharded_exec.AGREEMENT


def test_gen_replay_on_its_own_weights_is_identical(world):
    """Each sharded GEN against a world-of-one GEN decoding the same
    prompts from the same generator state on the weights the GEN ranks
    held (``sharded_exec._gen_replay``): with the weights equal, only the
    reduction order of the sharded matmuls differs, and every token
    agrees (``sharded_exec.REPLAY_AGREEMENT``), sampled runs after the
    syncs included."""
    ranks, _, _, _ = world
    for r in ranks[:4]:
        for mode in ("sampled", "greedy"):
            got = r[mode]["replay_agreement"]
            assert len(got) == ITERS, (r["rank"], mode, got)
            assert all(a >= sharded_exec.REPLAY_AGREEMENT for a in got), \
                (r["rank"], mode, got)
    for r in ranks[4:]:
        assert r["sampled"]["replay_agreement"] == []


def test_greedy_tokens_identical_to_jax_single_device(world):
    ranks, _, jtokens, _ = world
    got = ranks[0]["greedy"]["tokens"]
    assert len(got) == len(jtokens) == ITERS
    for a, b in zip(got, jtokens):
        np.testing.assert_array_equal(a, b)


def test_grpo_losses_match_world_of_one(world):
    ranks, one, _, _ = world
    ls, lb = ranks[0]["sampled"]["losses"][1:], one["sampled"]["losses"][1:]
    assert any(abs(x) > 1e-6 for x in ls), \
        "degenerate run: every loss is zero, parity would be vacuous"
    np.testing.assert_allclose(ls, lb, rtol=5e-2, atol=1e-4)


def test_weight_sync_moves_the_actor(world):
    ranks, _, _, actor_bytes = world
    s = ranks[0]["sampled"]
    assert s["actor_bytes"] == actor_bytes
    assert s["sync_gb"][0] == 0.0               # the pipeline fill
    for g in s["sync_gb"][1:]:
        assert g * 1e9 == pytest.approx(actor_bytes)
    assert len(s["sync_s"]) == ITERS - 1
    # after each iteration (the fill, then each sync) the GEN ranks hold
    # the actor bit for bit (the train lead's gathered leaves against
    # the GEN ranks')
    for r in ranks[:4]:
        for mode in ("sampled", "greedy"):
            assert r[mode]["sync_identical"] == [True] * ITERS
    for r in ranks[4:]:
        assert r["sampled"]["sync_identical"] == [None] * ITERS


def test_kernels_at_the_paths_shapes_match_plain(world):
    """``sharded_exec.kernels_vs_plain``: the attention calls of the
    sharded path on DTensors (GEN's prefill and decode on the 2x2 mesh,
    INF on the 4x1 one) at its shapes, 16 rows, against the plain
    versions on the full tensors; on the CPU each rank's call is the
    plain version on its local rows and heads."""
    ranks, _, _, _ = world
    for r in ranks[:4]:
        k = r["kernels"]
        assert set(k) == {"gen_prefill", "gen_decode"}
        assert k["gen_prefill"][1] == [8, 5, 1, 32]
        assert k["gen_decode"][1] == [8, 1, 32]
    for r in ranks[4:]:
        assert set(r["kernels"]) == {"inf"}
        assert r["kernels"]["inf"][1] == [4, 9, 2, 32]
    for r in ranks:
        for label, (err, _) in r["kernels"].items():
            assert err <= 1e-6, (r["rank"], label, err)


def test_compare_with_simulator_prices_the_realized_plan(world):
    ranks, _, _, _ = world
    s = ranks[0]["sampled"]
    assert s["measured_iter_s"] > 0 and s["predicted_iter_s"] > 0
    assert s["predicted_iter_realized_s"] > 0
    assert s["tp_shrunk"] == 0.0                # 8 ranks: nothing shrank


@pytest.fixture(scope="module")
def swapped(tmp_path_factory):
    job = {"kind": "swap", "world": 8, "timeout": 240,
           "cfg": sharded_exec.tiny_cfg(), "batch": BATCH}
    res = run_world(job, tmp_path_factory.mktemp("sharded_swap"))
    return res["ranks"], res["world1"]


def test_plan_swap_rebuilds_the_meshes(swapped):
    """``Engine.apply_plan`` on every rank: the state moves from the gen |
    rest placements to every task on all 8 ranks at (4, 2), and training
    goes on as in the world of one (which folds both plans onto its
    device)."""
    ranks, one = swapped
    s = ranks[0]
    assert s["before"]["actor_generation"] == [0, 1, 2, 3]
    assert s["before"]["actor_training"] == [4, 5, 6, 7]
    for name, (shape, rk) in s["after"].items():
        assert shape == [4, 2] and rk == list(range(8)), name
    assert s["overlap"] is False and s["epoch"] == 1.0
    # the syncs before and after the swap (GEN rank 0 holds the check)
    assert s["sync_identical"] == [True] * 4
    assert s["staleness"] == one["staleness"]
    assert any(abs(x) > 1e-6 for x in s["losses"][1:])
    np.testing.assert_allclose(s["losses"], one["losses"], rtol=5e-2,
                               atol=1e-4)
    for r in ranks[1:]:
        assert r["losses"] == s["losses"]


def _launch(prefix, tmp_path):
    import os
    import subprocess
    import sys
    from test_torch_sharded import REPO
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(REPO, "src"),
                                         env.get("PYTHONPATH", "")])
    argv = ["-m", "repro_torch.launch.train", "--arch", "qwen3-0.6b",
            "--smoke", "--rl", "grpo", "--async", "--steps", "3",
            "--batch", "4", "--search-budget", "16", "--device", "cpu"]
    r = subprocess.run([sys.executable, *prefix, *argv], capture_output=True,
                       text=True, timeout=300, env=env, cwd=tmp_path)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    return r.stdout.splitlines()


def test_rl_launcher_under_torchrun(tmp_path):
    """``launch.train --rl`` under ``torch.distributed.run`` with 4 CPU
    ranks (8 plan devices fold onto 4: an oversubscribed fold, meshes
    over unsorted plan order): rank 0 alone prints, one placement line
    per task, and the iterations' rewards and KL are the world of one's
    (iterations 0-2; the async run trains on iteration 0's bundle)."""
    lines = _launch(["-m", "torch.distributed.run", "--standalone",
                     "--nproc-per-node", "4"], tmp_path)
    one = _launch([], tmp_path)
    assert sum(ln.startswith("plan: ") for ln in lines) == 1
    assert lines[-1] == "done" and lines.count("done") == 1
    places = [ln for ln in lines if ln.startswith("placement ")]
    assert len(places) == 4 and all("mesh={'data': " in ln
                                    for ln in places)

    def iters(ls):
        # iter N reward=R kl=K sync=SMB (...)
        return [(ln.split()[1], ln.split()[2],
                 float(ln.split()[3][len("kl="):]),
                 float(ln.split()[4][len("sync="):-2]))
                for ln in ls if ln.startswith("iter ")]
    got, want = iters(lines), iters(one)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g[:2] == w[:2]                   # iteration, reward
        assert abs(g[2] - w[2]) < 2e-3 and g[3] == w[3]

