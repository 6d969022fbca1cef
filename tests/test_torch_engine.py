"""The RL slice as a whole: the port's scheduler → Plan → Engine →
GEN/INF/TRAIN → sync against the JAX package's, on ``SMOKE["qwen3-0.6b"]``
with the task's 16-token vocabulary in fp32, on the CPU, from bridged
state.

Greedy decoding makes the tokens comparable (identical); log-probs,
values, advantages and losses are held within 2e-4.  Greedy GRPO is
degenerate (every rollout of a group is the same, so its advantages are
rounding noise that whitening amplifies): greedy GRPO is held on its
tokens and wave statistics, TRAIN on greedy PPO (GAE over the critic's
values) and on the reference's own sampled GRPO rollouts, converted.
Post-Adam parameters: within 2e-6 where |g| >= 1e-6, else within
2*lr + 2e-6 (Adam's first step is about lr*sign(g); see
``tests/test_torch_rl.py``)."""
import dataclasses
import threading

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.archs import SMOKE  # noqa: E402
from repro.core import topology as jtopo, workflow as jwf  # noqa: E402
from repro.core.sha import HybridScheduler as JHS  # noqa: E402
from repro.data.synthetic import AdditionTask as JTask  # noqa: E402
from repro.data.synthetic import PromptDataset, VOCAB_SIZE  # noqa: E402
from repro.rl.trainer import RLConfig as JRL, RLTrainer as JTrainer  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import archs as tarchs  # noqa: E402
from repro_torch.core import topology as ttopo, workflow as twf  # noqa: E402
from repro_torch.core.sha import HybridScheduler as THS  # noqa: E402
from repro_torch.core.workflow import TaskKind  # noqa: E402
from repro_torch.data.synthetic import AdditionTask as TTask  # noqa: E402
from repro_torch.engine import tasks as ttasks  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.rl.trainer import RLConfig as TRL, RLTrainer as TTrainer  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402


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
LR = 1e-3
CFG = dataclasses.replace(SMOKE["qwen3-0.6b"], vocab_size=VOCAB_SIZE,
                          dtype="float32")
TCFG = dataclasses.replace(tarchs.SMOKE["qwen3-0.6b"], vocab_size=VOCAB_SIZE,
                           dtype="float32")
PROMPT, ANSWER = 5, 3          # AdditionTask(max_operand=9)


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(a, b, **tol):
    np.testing.assert_allclose(_np(a), _np(b), **(tol or TOL))


def _searched(alg, batch):
    out = []
    for topo_m, wf_m, HS, cfg in ((jtopo, jwf, JHS, CFG),
                                  (ttopo, twf, THS, TCFG)):
        topo = topo_m.build_testbed("single_region",
                                    counts={"A100": 4, "L4": 4})
        wf = wf_m.make_workflow(alg, wf_m.LLMSpec.from_model_config(cfg),
                                synchronous=True, global_batch=batch,
                                n_rollouts=4, seq_in=PROMPT, seq_out=ANSWER)
        r = HS(topo, wf, max_groupings=8, max_sizes_per_grouping=4).search(
            budget=20)
        out.append((topo, wf, r.plan))
    return out


def _capture(trainer, into):
    """Keep each iteration's blackboard: the trainer's ``before_stage``
    hook receives it before every stage."""
    orig = trainer.before_stage

    def hook(stage, bb):
        into["bb"] = bb
        return orig(stage, bb)
    trainer.before_stage = hook


def _pair(alg, batch, **rl_kw):
    (jt, jw, jp), (tt, tw, tp) = _searched(alg, batch)
    rl = dict(algorithm=alg, n_rollouts=4, max_new_tokens=ANSWER, lr=LR,
              **rl_kw)
    J = JTrainer(CFG, JRL(**rl), JTask(max_operand=9), jax.random.PRNGKey(0),
                 plan=jp, topo=jt, wf=jw)
    P = TTrainer(TCFG, TRL(**rl), TTask(max_operand=9), seed=0, plan=tp,
                 topo=tt, wf=tw, device="cpu")
    P.load_state_tree(_bridged(J))
    return J, P


def _bridged(J):
    return bridge.from_numpy_state_tree(
        jax.tree_util.tree_map(np.asarray, J.state_tree()), TCFG, "cpu")


def _assert_post_adam(tparams, jparams, grads, lr):
    """Within 2e-6 where |g| >= 1e-6, else within 2*lr + 2e-6."""
    for a, b, g in zip(tree_leaves(tparams),
                       jax.tree_util.tree_leaves(jparams),
                       tree_leaves(grads)):
        d = np.abs(_np(a) - np.asarray(b))
        firm = np.abs(_np(g)) >= 1e-6
        assert float(d[firm].max(initial=0.0)) <= 2e-6
        assert float(d.max(initial=0.0)) <= 2 * lr + 2e-6


@pytest.fixture(scope="module")
def ppo():
    """One greedy PPO iteration (4 prompts x 4 rollouts, the single-wave
    GEN path) through both engines on the searched plan."""
    J, P = _pair("ppo", 4, greedy=True)
    prompts, answers = next(iter(PromptDataset(JTask(max_operand=9),
                                               batch=4, seed=1)))
    cj, cp = {}, {}
    _capture(J, cj)
    _capture(P, cp)
    actor0, critic0 = P.actor, (P.critic, P.value_head)
    mj = J.iteration(prompts, answers, jax.random.PRNGKey(5))
    mp = P.iteration(prompts, answers, None)
    return dict(J=J, P=P, mj=mj, mp=mp, bj=cj["bb"], bp=cp["bb"],
                actor0=actor0, critic0=critic0, prompts=prompts,
                answers=answers)


def test_greedy_ppo_iteration_matches_reference(ppo):
    J, P, bj, bp = ppo["J"], ppo["P"], ppo["bj"], ppo["bp"]
    roj, rop = bj["bundle"]["rollout"], bp["bundle"]["rollout"]
    for k in ("sequences", "gen_tokens", "mask"):
        np.testing.assert_array_equal(_np(rop[k]), np.asarray(roj[k]))
    _close(rop["logprobs"], roj["logprobs"])
    np.testing.assert_array_equal(bp["scores"], bj["scores"])
    for k in ("lp_ref", "values", "returns"):
        _close(bp[k], bj[k])
    for k in ("advantages", "logp_old", "mask"):
        _close(bp["batch"][k], bj["batch"][k])
    assert float(np.abs(_np(bp["batch"]["advantages"])).max()) > 0.1
    mj, mp = ppo["mj"], ppo["mp"]
    assert set(mp) == set(mj)
    for k in ("reward_mean", "kl", "loss", "critic_loss", "grad_norm",
              "gen_len", "sync_gb", "lr", "clip_frac", "approx_kl",
              "ratio_mean", "gen_wave", "gen_wave_occupancy",
              "gen_decode_steps"):
        _close(mp[k], mj[k])
    batch = bp["batch"]
    _, _, g = P.actor_grads(ppo["actor0"], batch, PROMPT)
    _assert_post_adam(P.actor, J.actor, g, LR)
    cbatch = dict(batch, values_old=bp["values"].clone() * batch["mask"],
                  returns=bp["returns"])
    _, g = P.critic_grads(ppo["critic0"], cbatch, PROMPT)
    _assert_post_adam((P.critic, P.value_head), (J.critic, J.value_head), g,
                      LR)
    assert P.weight_version == J.weight_version == 1
    assert P.gen_params is P.actor


def test_engine_reports_match_reference(ppo):
    J, P = ppo["J"], ppo["P"]
    cj = J.engine.compare_with_simulator()
    cp = P.engine.compare_with_simulator()
    assert set(cp) == set(cj)
    assert cp["predicted_iter_s"] == cj["predicted_iter_s"]
    oj = J.engine.wave_occupancy_summary()
    op = P.engine.wave_occupancy_summary()
    assert set(op) == set(oj)
    for k in ("measured_occupancy", "measured_decode_steps",
              "predicted_occupancy", "folding_collisions", "overlap_honest",
              "predicted_occupancy_plan"):
        assert op[k] == pytest.approx(oj[k], rel=1e-12)
    ev = [e for e in P.engine.timeline if e.task >= 0]
    assert len(ev) == 2 * P.wf.n_tasks
    # one card: every plan group folds onto it, and its events say so
    assert all(e.collision for e in ev) == (len(P.plan.groups) > 1)
    assert [r["epoch"] for r in P.engine.epoch_report()] == [0]


def test_evaluate_matches_reference(ppo):
    """Greedy exact-match accuracy of the generation replica after the
    step, on fresh prompts, against the reference's greedy generation
    (its trainer's sampler is greedy here, as ``evaluate``'s is; the
    jitted path is already compiled for 16 rows) and reward."""
    J, P = ppo["J"], ppo["P"]
    task = JTask(max_operand=9)
    prompts, answers = task.sample_batch(np.random.default_rng(7), 16)
    ro = J._generate(J.gen_params, prompts=jax.numpy.asarray(prompts),
                     rng=jax.random.PRNGKey(1))
    exact = [task.reward(a, g) >= 1.0
             for a, g in zip(answers, np.asarray(ro["gen_tokens"]))]
    assert P.evaluate(prompts, answers, None) == float(np.mean(exact))


def test_reference_params_unchanged_after_two_steps(ppo):
    P = ppo["P"]
    ref0 = [_np(t).copy() for t in tree_leaves(P.ref)]
    actor1 = [_np(t).copy() for t in tree_leaves(P.actor)]
    m = P.iteration(ppo["prompts"], ppo["answers"], None)
    assert m["sync_gb"] > 0 and P.weight_version == 2
    for a, b in zip(tree_leaves(P.ref), ref0):
        np.testing.assert_array_equal(_np(a), b)
    assert any(not np.array_equal(_np(a), b)
               for a, b in zip(tree_leaves(P.actor), actor1))


@pytest.fixture(scope="module")
def grpo():
    """9 prompts x 4 rollouts = 36 rows > the decode wave of 32, so GEN
    takes the continuous-batching decoder: one greedy iteration through
    both engines, then one sampled iteration of the reference whose
    bundle the port trains on."""
    J, P = _pair("grpo", 9, greedy=True)
    ds = iter(PromptDataset(JTask(max_operand=9), batch=9, seed=1))
    prompts, answers = next(ds)
    cj, cp = {}, {}
    _capture(J, cj)
    _capture(P, cp)
    mj = J.iteration(prompts, answers, jax.random.PRNGKey(5))
    mp = P.iteration(prompts, answers, None)
    out = dict(mj=mj, mp=mp, bj=cj["bb"], bp=cp["bb"],
               oj=J.engine.wave_occupancy_summary(),
               op=P.engine.wave_occupancy_summary(),
               wj=len(J.engine.wave_timeline), wp=len(P.engine.wave_timeline))
    # sampled: the reference draws its own rollouts (threefry); the port
    # starts from the reference's state and trains on that bundle
    state = _bridged(J)
    J.sampler = dataclasses.replace(J.sampler, greedy=False)
    prompts, answers = next(ds)
    J.iteration(prompts, answers, jax.random.PRNGKey(6))
    out.update(J=J, P=P, state=state, sampled=cj["bb"])
    return out


def test_greedy_grpo_two_waves_match_reference(grpo):
    roj = grpo["bj"]["bundle"]["rollout"]
    rop = grpo["bp"]["bundle"]["rollout"]
    assert rop["gen_tokens"].shape[0] == 36
    for k in ("sequences", "gen_tokens", "mask"):
        np.testing.assert_array_equal(_np(rop[k]), np.asarray(roj[k]))
    _close(rop["logprobs"], roj["logprobs"])
    mj, mp = grpo["mj"], grpo["mp"]
    assert mj["gen_wave"] == 32.0
    for k in ("gen_wave", "gen_wave_occupancy", "gen_decode_steps",
              "reward_mean", "gen_len"):
        assert mp[k] == mj[k]
    assert grpo["op"] == pytest.approx(grpo["oj"], rel=1e-12)
    assert grpo["wp"] == grpo["wj"] > 2


def test_sampled_grpo_trains_on_reference_bundle(grpo):
    """INF and TRAIN of the port on the reference's sampled rollouts:
    reference log-probs, advantages, loss, grad norm and the stepped
    actor."""
    J, P, bj = grpo["J"], grpo["P"], grpo["sampled"]
    P.load_state_tree(grpo["state"])
    actor0 = P.actor
    ro = {k: torch.as_tensor(np.array(v))
          for k, v in bj["bundle"]["rollout"].items()}
    scores = np.asarray(bj["scores"])
    assert len(set(scores.tolist())) > 1    # the groups' rewards differ
    bundle = dict(bj["bundle"], rollout=ro)
    bb = {"lock": threading.Lock(), "metrics": {},
          "bundle": bundle, "scores": scores}
    wf = P.wf
    inf = next(t for t in range(wf.n_tasks)
               if wf.task(t).name == "reference_inference")
    train = next(t for t in range(wf.n_tasks)
                 if wf.task(t).kind == TaskKind.TRAIN)
    ttasks.run_reference(P, bb, P.engine.placements[inf])
    _close(bb["lp_ref"], bj["lp_ref"])
    # TRAIN from the reference's own INF output: where a group's scores
    # tie, its advantages are the KL penalty's spread alone, which whitening
    # scales up, and a 1e-7 log-prob difference would show there
    bb["lp_ref"] = torch.as_tensor(np.array(bj["lp_ref"]))
    ttasks.ensure_train_batch(P, bb)
    _close(bb["batch"]["advantages"], bj["batch"]["advantages"])
    ttasks.run_actor_training(P, bb, P.engine.placements[train])
    mj = bj["metrics"]
    for k in ("reward_mean", "kl", "loss", "grad_norm", "clip_frac",
              "approx_kl", "ratio_mean"):
        _close(bb["metrics"][k], mj[k])
    _, _, g = P.actor_grads(actor0, bb["batch"], PROMPT)
    _assert_post_adam(P.actor, J.actor, g, LR)


def _bridge_draft(J, P):
    """The JAX trainer's draft (``_draft_model``, seed-7 JAX weights) carried
    into the port trainer's ``_spec_draft``."""
    from repro.engine import tasks as jtasks
    _, jd_params = jtasks._draft_model(J)
    td_cfg, _ = ttasks._draft_model(P)
    P._spec_draft = (td_cfg, bridge.from_numpy_params(
        jax.tree_util.tree_map(np.asarray, jd_params), td_cfg, "cpu"))


@pytest.fixture(scope="module")
def spec_grpo():
    """One greedy GRPO iteration with speculative GEN (spec_k 2, the
    default window-free draft) through both engines: 4 prompts x 4
    rollouts fit one decode wave, and spec_k forces the genserve
    engine anyway."""
    from repro.engine import tasks as jtasks
    J, P = _pair("grpo", 4, greedy=True, spec_k=2)
    _bridge_draft(J, P)
    prompts, answers = next(iter(PromptDataset(JTask(max_operand=9),
                                               batch=4, seed=1)))
    cj, cp = {}, {}
    _capture(J, cj)
    _capture(P, cp)
    # the engine pops GEN's stats into its timeline: keep a copy
    stats, mods = {}, {"J": jtasks.genserve, "P": ttasks.genserve}
    orig = {key: m.generate for key, m in mods.items()}

    def keeper(key):
        def generate(*a, **k):
            ro, st = orig[key](*a, **k)
            stats[key] = dict(st)
            return ro, st
        return generate
    for key, m in mods.items():
        m.generate = keeper(key)
    try:
        mj = J.iteration(prompts, answers, jax.random.PRNGKey(5))
        mp = P.iteration(prompts, answers, None)
    finally:
        for key, m in mods.items():
            m.generate = orig[key]
    return dict(J=J, P=P, mj=mj, mp=mp, bj=cj["bb"], bp=cp["bb"],
                sj=stats["J"], sp=stats["P"])


def test_greedy_spec_grpo_iteration_matches_reference(spec_grpo):
    bj, bp = spec_grpo["bj"], spec_grpo["bp"]
    roj, rop = bj["bundle"]["rollout"], bp["bundle"]["rollout"]
    for k in ("sequences", "gen_tokens", "mask"):
        np.testing.assert_array_equal(_np(rop[k]), np.asarray(roj[k]))
    _close(rop["logprobs"], roj["logprobs"])
    sj, sp = spec_grpo["sj"], spec_grpo["sp"]
    assert sp["engine"] == sj["engine"] and sj["spec_k"] == sp["spec_k"] == 2
    for k in ("decode_steps", "spec_proposed", "spec_accepted",
              "spec_tokens"):
        assert sp[k] == sj[k], k
    assert sp["spec_proposed"] > 0
    assert sp["accept_rate"] == pytest.approx(sj["accept_rate"], rel=1e-12)
    mj, mp = spec_grpo["mj"], spec_grpo["mp"]
    for k in ("gen_wave", "gen_wave_occupancy", "gen_decode_steps",
              "reward_mean", "gen_len"):
        assert mp[k] == mj[k], k


@pytest.mark.parametrize("draft_arch", ["", "qwen3-0.6b", "gemma2-27b"])
def test_draft_model_config_matches_reference(draft_arch):
    """``_draft_model``'s config, field for field: the target's
    window-free quarter-depth copy, or a named smoke (the target has at
    most 4 layers) with the target's vocab and dtype; cached on the
    trainer."""
    from repro.engine import tasks as jtasks

    class St:
        pass
    js, ts = St(), St()
    js.cfg, ts.cfg = CFG, TCFG
    js.rl = JRL(spec_k=2, draft_arch=draft_arch)
    ts.rl = TRL(spec_k=2, draft_arch=draft_arch)
    ts.device = torch.device("cpu")
    jd, _ = jtasks._draft_model(js)
    td, tparams = ttasks._draft_model(ts)
    assert dataclasses.asdict(td) == dataclasses.asdict(jd)
    assert ttasks._draft_model(ts)[1] is tparams
    if not draft_arch:
        assert all(s.window is None for s in td.pattern)
        assert td.n_layers == len(TCFG.pattern) * max(
            TCFG.n_pattern_repeats // 4, 1)
    assert td.vocab_size == VOCAB_SIZE and td.dtype == "float32"


def test_async_fill_then_one_step_staleness():
    """--async: the fill iteration trains nothing and syncs nothing; the
    next trains the fill's rollouts (generated at version 0, before any
    sync), and from then on the trained bundle is exactly one weight
    version behind."""
    P = TTrainer(TCFG, TRL(algorithm="grpo", n_rollouts=4,
                           max_new_tokens=ANSWER, asynchronous=True),
                 TTask(max_operand=9), seed=0, device="cpu")
    ds = iter(PromptDataset(JTask(max_operand=9), batch=2, seed=1))
    gen = torch.Generator().manual_seed(0)
    m0 = P.iteration(*next(ds), gen)
    assert m0["sync_gb"] == 0.0 and m0["pipeline_fill"] == 1.0
    assert P.weight_version == 0
    for it in (1, 2, 3):
        m = P.iteration(*next(ds), gen)
        assert m["sync_gb"] > 0
        rec = P.engine.pipeline.records[-1]
        assert rec.iteration == it
        assert rec.weight_version - rec.gen_version == (0 if it == 1 else 1)
    assert P.weight_version == 3


def test_colocated_plan_serializes_every_task():
    P = TTrainer(TCFG, TRL(algorithm="ppo", n_rollouts=4,
                           max_new_tokens=ANSWER, greedy=True),
                 TTask(max_operand=9), seed=0, device="cpu")
    assert len(P.plan.groups) == 1
    for stage in P.wf.stages():
        assert len(P.engine._lanes(stage)) == 1
    prompts, answers = next(iter(PromptDataset(JTask(max_operand=9),
                                               batch=2, seed=1)))
    P.iteration(prompts, answers, None)
    ev = sorted((e for e in P.engine.timeline if e.task >= 0),
                key=lambda e: (e.time, e.kind != "end"))
    busy = 0
    for e in ev:
        busy += 1 if e.kind == "start" else -1
        assert busy <= 1
        assert e.collision is None


def test_multi_device_execution_is_refused():
    """Several plain devices in a world of one rank: sharded execution
    runs one process per device (``parallel.dist``), so the trainer
    refuses such placements and a wide placement shards nothing.  The
    sharded steps on gloo ranks: ``tests/test_torch_sharded.py``."""
    P = TTrainer(TCFG, TRL(algorithm="grpo", n_rollouts=4,
                           max_new_tokens=ANSWER), TTask(max_operand=9),
                 seed=0, device="cpu")
    from repro_torch.engine.placement import build_placements
    (_, _, _), (tt, tw, tp) = _searched("grpo", 2)
    pl = build_placements(tp, range(tw.n_tasks),
                          [torch.device("cpu", 0), torch.device("cpu", 1)])
    with pytest.raises(RuntimeError, match="one process per device"):
        P.install_placements(pl, tw)
    wide = next(p for p in pl.values() if p.sharded)
    for fn in (wide.param_shardings, wide.shard_batch,
               wide.batch_shardings):
        with pytest.raises(RuntimeError, match="one process per device"):
            fn({})


def _launch(argv, capsys):
    out = tlaunch.main(argv + ["--device", "cpu", "--smoke",
                               "--search-budget", "16"])
    return out, capsys.readouterr().out.splitlines()


def test_launcher_grpo_smoke(capsys):
    out, lines = _launch(["--arch", "qwen3-0.6b", "--rl", "grpo",
                          "--steps", "2", "--batch", "4"], capsys)
    assert lines[0].startswith("plan: grouping=")
    assert [ln.split()[:2] for ln in lines if ln.startswith("iter")] == \
        [["iter", "0"], ["iter", "1"]]
    assert lines[-2].startswith("measured ") and lines[-1] == "done"
    assert len(out["metrics"]) == 2 and out["metrics"][1]["sync_gb"] > 0


def test_launcher_ppo_async_smoke(capsys):
    out, lines = _launch(["--arch", "qwen3-0.6b", "--rl", "ppo", "--async",
                          "--steps", "2", "--batch", "2"], capsys)
    iters = [ln for ln in lines if ln.startswith("iter")]
    assert len(iters) == 2 and "sync=0.0MB" in iters[0]
    assert "sync=0.0MB" not in iters[1]
    assert lines[-1] == "done"
    assert "critic_loss" in out["metrics"][1]


@pytest.mark.parametrize("flags", [
    ["--rl", "grpo", "--drift", "drop_tail"],
    ["--rl", "grpo", "--drift-at", "0"],
    ["--rl", "grpo", "--require-recover"],
    ["--rl", "grpo", "--fault", "transient_crash"],
    ["--rl", "grpo", "--calibrate"],
    ["--rl", "grpo", "--spec-k", "2"],
    ["--rl", "grpo", "--draft-arch", "qwen3-0.6b"],
    ["--steps", "2"],                                  # the LM mode
])
def test_launcher_refuses_what_is_not_ported(flags):
    """Every flag of the reference's launcher parses: the elastic, fault,
    calibration and speculative-GEN flags and the LM mode
    (``tests/test_torch_faults.py``, ``tests/test_torch_lm.py`` and
    ``test_launcher_spec_grpo_smoke`` run them)."""
    argv = ["--arch", "qwen3-0.6b"] + flags
    args = tlaunch.parse_args(argv)
    assert args.rl == ("grpo" if "--rl" in flags else None)
    assert (args.spec_k, args.draft_arch) == (
        2 if "--spec-k" in flags else 0,
        "qwen3-0.6b" if "--draft-arch" in flags else "")
    if len(flags) > 2:
        dest = flags[2].lstrip("-").replace("-", "_")
        assert getattr(args, dest) == {
            "--drift": "drop_tail", "--drift-at": 0, "--require-recover": True,
            "--fault": "transient_crash", "--calibrate": True, "--spec-k": 2,
            "--draft-arch": "qwen3-0.6b"}[flags[2]]


def test_launcher_spec_grpo_smoke(capsys):
    """``--spec-k 2``: GEN on the genserve engine with the default draft
    (the trainer's ``_spec_draft``)."""
    out, lines = _launch(["--arch", "qwen3-0.6b", "--rl", "grpo",
                          "--spec-k", "2", "--steps", "2", "--batch", "4"],
                         capsys)
    assert lines[-1] == "done"
    assert [ln.split()[:2] for ln in lines if ln.startswith("iter")] == \
        [["iter", "0"], ["iter", "1"]]
    trainer = out["trainer"]
    assert trainer.rl.spec_k == 2 and trainer._spec_draft is not None
    assert trainer._spec_draft[0].name == "qwen3-0.6b-smoke-draft"


def test_launcher_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default would run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlaunch.main(["--arch", "qwen3-0.6b", "--smoke", "--rl", "grpo",
                      "--steps", "1", "--search-budget", "8"])
