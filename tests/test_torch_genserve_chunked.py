"""The port's genserve engine beyond one-shot FIFO admission, against the
JAX engine on bridged weights: slot recycling, the vmapped per-slot
decode, shortest-job-first admission (with aging), chunked admission
(single wave, random traces, ragged prompts, honest occupancy), the
``valid=`` chunk paths of the recurrent mixers (RWKV6 and Jamba smokes),
slot failures and cancels, and GEN on chunked admission in the RL
engine.

Greedy decoding: tokens and masks identical to the JAX engine's,
log-probs within 2e-4 (fp32), and every engine statistic the reference
tests read equal.  The reference's sampled cases are held greedily here
(torch cannot replay threefry streams); within the port, two paths that
consume the generator identically are held token for token under
sampling too."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.archs import SMOKE  # noqa: E402
from repro.data.synthetic import AdditionTask as JTask  # noqa: E402
from repro.data.synthetic import EOS, VOCAB_SIZE  # noqa: E402
from repro.genserve.decoder import GenServeConfig as JG  # noqa: E402
from repro.genserve.decoder import serve as jserve  # noqa: E402
from repro.genserve.scheduler import Request as JRequest  # noqa: E402
from repro.genserve.scheduler import RequestQueue as JQueue  # noqa: E402
from repro.models import mamba as jmamba  # noqa: E402
from repro.models import rwkv as jrwkv  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.config import LayerSpec as JLayer  # noqa: E402
from repro.models.config import ModelConfig as JModel  # noqa: E402
from repro.rl.trainer import RLConfig as JRL  # noqa: E402
from repro.rl.trainer import RLTrainer as JTrainer  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import archs as tarchs  # noqa: E402
from repro_torch.core import plan as plan_mod  # noqa: E402
from repro_torch.data.synthetic import AdditionTask as TTask  # noqa: E402
from repro_torch.genserve.decoder import GenServeConfig as TG  # noqa: E402
from repro_torch.genserve.decoder import serve as tserve  # noqa: E402
from repro_torch.genserve.scheduler import (FREE, Request,  # noqa: E402
                                            RequestQueue, SlotTable)
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import mamba as tmamba  # noqa: E402
from repro_torch.models import rwkv as trwkv  # noqa: E402
from repro_torch.models.config import LayerSpec as TLayer  # noqa: E402
from repro_torch.models.config import ModelConfig as TModel  # noqa: E402
from repro_torch.rl import rollout as trollout  # noqa: E402
from repro_torch.rl.trainer import RLConfig as TRL  # noqa: E402
from repro_torch.rl.trainer import RLTrainer as TTrainer  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on the host's
    cores, and torch's default of one thread per core oversubscribes
    them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


KEY = jax.random.PRNGKey(0)
P, N = 8, 6
TOL = dict(rtol=2e-4, atol=2e-4)
STATS = ("decode_steps", "slot_steps", "occupancy_trace", "prefill_trace",
         "prefill_rounds", "prefill_slot_steps", "prefills", "admitted",
         "retired", "requeued", "cancelled", "prefix_hit_rate",
         "prefill_tokens_skipped", "prompt_tokens", "mean_occupancy",
         "busy_occupancy", "prefill_rounds_per_req")


def cfg_pair(name, window=None, n_heads=2, n_kv_heads=2, head_dim=32,
             softcap=None):
    """The same tiny attention config in both packages."""
    kw = dict(name=name, n_layers=2, d_model=64, n_heads=n_heads,
              n_kv_heads=n_kv_heads, head_dim=head_dim, d_ff=128,
              vocab_size=VOCAB_SIZE, dtype="float32", attn_softcap=softcap)
    return (JModel(pattern=(JLayer(window=window),), **kw),
            TModel(pattern=(TLayer(window=window),), **kw))


def params_pair(jcfg, tcfg, seed=0):
    jp = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    return jp, bridge.from_numpy_params(
        jax.tree_util.tree_map(np.asarray, jp), tcfg, "cpu")


def prompts_for(n, key, vocab=VOCAB_SIZE):
    return np.array(jax.random.randint(jax.random.PRNGKey(key), (n, P), 0,
                                       vocab, jnp.int32))


def both(jp, jcfg, tp, tcfg, prompts, gkw, **extra):
    """(JAX engine rollout + stats, port engine rollout + stats)."""
    ref = jserve(jp, jcfg, jnp.asarray(prompts), KEY, JG(**gkw), **extra)
    got = tserve(tp, tcfg, torch.as_tensor(prompts), None, TG(**gkw),
                 **extra)
    return ref, got


def assert_match(ref, got, keys=STATS):
    (r, rs), (g, gs) = ref, got
    mask = np.asarray(r["mask"])
    np.testing.assert_array_equal(g["mask"].numpy(), mask)
    np.testing.assert_array_equal(g["gen_tokens"].numpy(),
                                  np.asarray(r["gen_tokens"]))
    np.testing.assert_array_equal(g["sequences"].numpy(),
                                  np.asarray(r["sequences"]))
    np.testing.assert_allclose(g["logprobs"].numpy(),
                               np.asarray(r["logprobs"]), **TOL)
    for k in keys:
        if isinstance(rs[k], float):
            assert gs[k] == pytest.approx(rs[k], rel=1e-12), k
        else:
            assert gs[k] == rs[k], k


def assert_same_port(a, b):
    """Two port rollouts: identical tokens and masks, close log-probs."""
    assert torch.equal(a["mask"], b["mask"])
    assert torch.equal(a["gen_tokens"] * a["mask"].long(),
                       b["gen_tokens"] * b["mask"].long())
    torch.testing.assert_close(a["logprobs"] * a["mask"],
                               b["logprobs"] * b["mask"], **TOL)


# ---------------------------------------------------------------------------
# One-shot admission: recycling, vmapped decode, shortest-job-first
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [None, 4])
def test_slot_recycling_matches_reference(window):
    """batch >> wave, greedy: recycled slots (fresh cache rows, per-slot
    positions, ring windows) match the JAX engine and the port's own
    single-wave rollout for every request."""
    jcfg, tcfg = cfg_pair(f"gs-rec-{window}", window=window)
    jp, tp = params_pair(jcfg, tcfg)
    prompts = prompts_for(14, 5)
    gkw = dict(wave=4, max_new_tokens=N, greedy=True, eos_token=3)
    ref, got = both(jp, jcfg, tp, tcfg, prompts, gkw)
    assert_match(ref, got)
    ro = trollout.generate(tp, tcfg, torch.as_tensor(prompts), None,
                           trollout.SamplerConfig(max_new_tokens=N,
                                                  greedy=True, eos_token=3))
    assert_same_port(ro, got[0])
    stats = got[1]
    assert stats["admitted"] == stats["retired"] == 14
    assert stats["prefills"] >= 2 and max(stats["occupancy_trace"]) <= 4


@pytest.mark.parametrize("window", [None, 4])
def test_batched_decode_matches_vmapped_per_slot(window):
    """The per-slot decode loop (``decode_path="vmapped"``) against the
    JAX engine's vmapped path, and against the port's batched step."""
    jcfg, tcfg = cfg_pair(f"gs-vm-{window}", window=window)
    jp, tp = params_pair(jcfg, tcfg)
    prompts = prompts_for(14, 5)
    kw = dict(wave=4, max_new_tokens=N, greedy=True, eos_token=3)
    ref, got = both(jp, jcfg, tp, tcfg, prompts,
                    dict(kw, decode_path="vmapped"))
    assert_match(ref, got)
    batched, stats = tserve(tp, tcfg, torch.as_tensor(prompts), None,
                            TG(decode_path="batched", **kw))
    assert_same_port(got[0], batched)
    assert stats["prefills"] >= 2


def test_batched_decode_matches_vmapped_gqa_softcap():
    """GQA 4:2 with a logit softcap: greedy against the JAX engine, and
    sampled batched against sampled vmapped from the same generator."""
    jcfg, tcfg = cfg_pair("gs-gqa", n_heads=4, head_dim=16, softcap=30.0)
    jp, tp = params_pair(jcfg, tcfg)
    prompts = prompts_for(9, 8)
    kw = dict(wave=3, max_new_tokens=N, eos_token=EOS)
    assert_match(*both(jp, jcfg, tp, tcfg, prompts,
                       dict(kw, greedy=True, decode_path="vmapped")))
    runs = [tserve(tp, tcfg, torch.as_tensor(prompts),
                   torch.Generator().manual_seed(6),
                   TG(decode_path=path, **kw))[0]
            for path in ("vmapped", "batched")]
    assert_same_port(*runs)


def test_sjf_admission_policy():
    """Shortest budgets first (arrival order breaks ties) in the queue,
    the same order as the JAX queue; greedy outputs equal the FIFO run
    request for request, and the JAX engine's under sjf."""
    budgets = [5, 2, 5, 1, 2]
    q = RequestQueue([Request(i, b) for i, b in enumerate(budgets)],
                     policy="sjf")
    jq = JQueue([JRequest(i, b) for i, b in enumerate(budgets)],
                policy="sjf")
    assert [r.rid for r in q.pop(5)] == [r.rid for r in jq.pop(5)] \
        == [3, 1, 4, 0, 2]
    jcfg, tcfg = cfg_pair("gs-sjf")
    jp, tp = params_pair(jcfg, tcfg)
    lens = [N, 1, N, 2, 1, N, 2, N, 1, N]
    prompts = prompts_for(10, 21)
    kw = dict(wave=3, max_new_tokens=N, greedy=True)
    ref, got = both(jp, jcfg, tp, tcfg, prompts, dict(kw, admission="sjf"),
                    gen_lens=lens)
    assert_match(ref, got)
    fifo, _ = tserve(tp, tcfg, torch.as_tensor(prompts), None, TG(**kw),
                     gen_lens=lens)
    assert_same_port(fifo, got[0])
    assert got[0]["mask"].sum(1).tolist() == lens


def test_sjf_aging_anti_starvation():
    """``aging=K``: a long request passed over K times jumps ahead of every
    shorter newcomer (the JAX queue's order pop by pop); outputs still
    equal the FIFO run and the JAX engine's."""
    budgets = [5, 1, 1, 1, 1]
    for aging, want in ((2, [1, 2, 0, 3, 4]), (0, [1, 2, 3, 4, 0])):
        q = RequestQueue([Request(i, b) for i, b in enumerate(budgets)],
                         policy="sjf", aging=aging)
        jq = JQueue([JRequest(i, b) for i, b in enumerate(budgets)],
                    policy="sjf", aging=aging)
        got = [q.pop(1)[0].rid for _ in range(5)]
        assert got == [jq.pop(1)[0].rid for _ in range(5)] == want
    jcfg, tcfg = cfg_pair("gs-sjf")
    jp, tp = params_pair(jcfg, tcfg)
    lens = [N, 1, N, 2, 1, N, 2, N, 1, N]
    prompts = prompts_for(10, 21)
    kw = dict(wave=3, max_new_tokens=N, greedy=True)
    ref, got = both(jp, jcfg, tp, tcfg, prompts,
                    dict(kw, admission="sjf", sjf_aging=1), gen_lens=lens)
    assert_match(ref, got)
    fifo, _ = tserve(tp, tcfg, torch.as_tensor(prompts), None, TG(**kw),
                     gen_lens=lens)
    assert_same_port(fifo, got[0])


def test_scheduler_push_cancel_and_books():
    """``push`` / ``cancel`` and the table's failure, cancel, prefill and
    prefix books, step by step against the JAX scheduler."""
    from repro.genserve.scheduler import SlotTable as JTable
    for policy in ("fifo", "sjf"):
        q = RequestQueue([Request(i, b) for i, b in enumerate([4, 2, 3])],
                         policy=policy)
        jq = JQueue([JRequest(i, b) for i, b in enumerate([4, 2, 3])],
                    policy=policy)
        for qq, R in ((q, Request), (jq, JRequest)):
            qq.push(R(7, 1))
            assert qq.cancel(2) and not qq.cancel(9)
        assert [r.rid for r in q.pop(4)] == [r.rid for r in jq.pop(4)]
    t, jt = SlotTable(3), JTable(3)
    for tab in (t, jt):
        tab.admit([0, 1], [Request(5, 3), Request(6, 3)])
        assert tab.fail_slot(0) == 5 and tab.fail_slot(2) == FREE
        assert tab.cancel_slot(1) == 6
        tab.record_round([0, 2], [3, 1])
        tab.record_step([1])
        tab.record_prefix(3, 8)
        tab.record_prefix(0, 4)
    for k in ("requeued", "cancelled", "retired", "decode_steps",
              "slot_steps", "prefill_rounds", "prefill_slot_steps"):
        assert getattr(t, k) == getattr(jt, k), k
    assert t.busy_occupancy() == jt.busy_occupancy() == pytest.approx(7 / 3)
    assert t.prefix_hit_rate() == jt.prefix_hit_rate() == 0.25


# ---------------------------------------------------------------------------
# Chunked admission (mixed wave-steps)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg = cfg_pair("gs-tiny")
    jp, tp = params_pair(jcfg, tcfg)
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("chunk,dchunk", [(1, 1), (3, 1), (5, 1), (8, 1),
                                          (3, 3), (2, 4)])
def test_chunked_admission_single_wave_exact(tiny, chunk, dchunk):
    """A single-wave batch under chunked admission matches the JAX engine
    (stats included: every prompt takes ceil(P / chunk) chunk steps) and
    the port's own rollout; every request gets a first-token time."""
    jcfg, tcfg, jp, tp = tiny
    prompts = prompts_for(4, 3)
    gkw = dict(wave=4, max_new_tokens=N, eos_token=EOS, greedy=True,
               prefill_chunk=chunk, decode_chunk=dchunk)
    ref, got = both(jp, jcfg, tp, tcfg, prompts, gkw)
    assert_match(ref, got)
    ro = trollout.generate(tp, tcfg, torch.as_tensor(prompts), None,
                           trollout.SamplerConfig(max_new_tokens=N,
                                                  greedy=True, eos_token=EOS))
    assert_same_port(ro, got[0])
    _, stats = tserve(tp, tcfg, torch.as_tensor(prompts), None,
                      TG(measure_ttft=True, **gkw))
    assert stats["prefill_slot_steps"] == 4 * -(-P // chunk)
    assert len(stats["ttft"]) == 4 and all(t > 0
                                           for t in stats["ttft"].values())


def _random_trace_case(rng, case):
    """One random admission trace: mixed windows and GQA, random budgets,
    random EOS, prompts longer than the chunk."""
    window = rng.choice([None, 4])
    gqa = bool(rng.integers(0, 2))
    jcfg, tcfg = cfg_pair(f"gs-prop-{case}", window=window,
                          n_heads=4 if gqa else 2,
                          head_dim=16 if gqa else 32)
    jp, tp = params_pair(jcfg, tcfg, seed=case)
    B = int(rng.integers(6, 12))
    W = int(rng.integers(2, 5))
    chunk = int(rng.integers(1, P))
    dchunk = int(rng.integers(1, 5))
    eos = int(rng.integers(0, VOCAB_SIZE)) if rng.integers(0, 2) else None
    lens = rng.integers(1, N + 1, B).tolist() if rng.integers(0, 2) \
        else None
    prompts = prompts_for(B, 100 + case)
    return jcfg, tcfg, jp, tp, prompts, B, W, chunk, dchunk, eos, lens


@pytest.mark.parametrize("case", range(4))
def test_chunked_admission_random_traces(case):
    """Random traces (recycling, ring windows, GQA, random EOS and
    budgets, prompts longer than the chunk): chunked admission matches
    the JAX engine's and the port's one-shot admission."""
    rng = np.random.default_rng(1234 + case)
    jcfg, tcfg, jp, tp, prompts, B, W, chunk, dchunk, eos, lens = \
        _random_trace_case(rng, case)
    kw = dict(wave=W, max_new_tokens=N, greedy=True, eos_token=eos)
    ref, got = both(jp, jcfg, tp, tcfg, prompts,
                    dict(kw, prefill_chunk=chunk, decode_chunk=dchunk),
                    gen_lens=lens)
    assert_match(ref, got)
    one, _ = tserve(tp, tcfg, torch.as_tensor(prompts), None, TG(**kw),
                    gen_lens=lens)
    assert_same_port(one, got[0])
    assert got[1]["admitted"] == got[1]["retired"] == B
    assert got[1]["prefill_slot_steps"] >= B * (P // chunk)


def test_chunked_admission_ragged_prompts(tiny):
    """Per-request prompt lengths: each request equals its own unpadded
    rollout, and the engine matches the JAX engine."""
    jcfg, tcfg, jp, tp = tiny
    pl = [8, 3, 5, 8, 2, 6]
    prompts = prompts_for(6, 17)
    gkw = dict(wave=3, max_new_tokens=N, greedy=True, prefill_chunk=3)
    ref, got = both(jp, jcfg, tp, tcfg, prompts, gkw, prompt_lens=pl)
    assert_match(ref, got)
    for i, L in enumerate(pl):
        ro = trollout.generate(
            tp, tcfg, torch.as_tensor(prompts[i:i + 1, :L]), None,
            trollout.SamplerConfig(max_new_tokens=N, greedy=True))
        assert torch.equal(ro["gen_tokens"][0], got[0]["gen_tokens"][i])
    assert got[1]["prefill_slot_steps"] == sum(-(-L // 3) for L in pl)


def test_mixed_rounds_honest_occupancy(tiny):
    """Prefill-only sub-rounds count as zero decode progress, prefill work
    is credited in busy occupancy, and busy occupancy respects the
    prefill-aware ideal; the traces equal the JAX engine's."""
    jcfg, tcfg, jp, tp = tiny
    B, W, C = 10, 4, 2
    lens = [1, 2, N, 3, N, 1, 2, N, 3, N]
    prompts = prompts_for(B, 23)
    ref, got = both(jp, jcfg, tp, tcfg, prompts,
                    dict(wave=W, max_new_tokens=N, greedy=True,
                         prefill_chunk=C), gen_lens=lens)
    assert_match(ref, got)
    stats = got[1]
    assert got[0]["mask"].sum(1).tolist() == lens
    assert stats["prefill_rounds"] <= stats["decode_steps"]
    assert stats["prefill_slot_steps"] == B * -(-P // C)
    ideal = plan_mod.predicted_occupancy(
        B, wave=W, gen_lens=lens,
        prefill_rounds=plan_mod.prefill_rounds(P, C))
    assert 0 < stats["busy_occupancy"] <= ideal + 1e-9
    assert stats["mean_occupancy"] < plan_mod.predicted_occupancy(
        B, wave=W, gen_lens=lens)


# ---------------------------------------------------------------------------
# Recurrent mixers: the valid= chunk path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["rwkv6-3b", "jamba-1.5-large-398b"])
def test_chunked_admission_recurrent_smokes(name):
    """RWKV6 (state, token shift, channel-mix shift) and Jamba (Mamba conv
    and SSM state, MoE) under chunked admission with ragged prompts and
    budgets: equal to the JAX engine.  With uniform prompts, chunked
    equals one-shot in the port; for Jamba at MoE capacity_factor
    E / top_k, since a chunk is an MoE group of its own and the default
    capacity drops tokens per group (chunked and one-shot differ there
    in the JAX package too)."""
    jcfg, tcfg = SMOKE[name], tarchs.SMOKE[name]
    jp, tp = params_pair(jcfg, tcfg, seed=2)
    prompts = np.random.default_rng(9).integers(0, jcfg.vocab_size, (6, 12))
    lens = [10, 3, 7, 1, 10, 6]
    gkw = dict(wave=4, max_new_tokens=10, greedy=True, prefill_chunk=4,
               decode_chunk=2)
    ref, got = both(jp, jcfg, tp, tcfg, prompts, gkw, gen_lens=lens,
                    prompt_lens=[12, 5, 9, 12, 3, 7])
    assert_match(ref, got)
    if jcfg.n_experts:
        tcfg = dataclasses.replace(
            tcfg, capacity_factor=tcfg.n_experts / tcfg.top_k)
    kw = dict(wave=4, max_new_tokens=10, greedy=True)
    one, _ = tserve(tp, tcfg, torch.as_tensor(prompts), None, TG(**kw),
                    gen_lens=lens)
    chunked, _ = tserve(tp, tcfg, torch.as_tensor(prompts), None,
                        TG(prefill_chunk=5, decode_chunk=3, **kw),
                        gen_lens=lens)
    assert_same_port(one, chunked)


@pytest.mark.parametrize("mixer", ["rwkv", "mamba"])
def test_valid_chunk_mixers_vs_jax(mixer):
    """``apply_rwkv`` / ``apply_mamba`` with ``valid=`` on a carried state
    (ragged valid prefixes, one all-invalid row): outputs at valid
    positions and the new state equal the JAX package's; the all-invalid
    row's recurrent state passes through."""
    name = "rwkv6-3b" if mixer == "rwkv" else "jamba-1.5-large-398b"
    jcfg, tcfg = SMOKE[name], tarchs.SMOKE[name]
    jp = JT.init_params(jax.random.PRNGKey(1), jcfg)
    layer = 0 if mixer == "rwkv" else 1
    key = "rwkv" if mixer == "rwkv" else "mamba"
    p = jax.tree_util.tree_map(lambda l: np.asarray(l[0]),
                               jp["blocks"][f"layer{layer}"][key])
    rng = np.random.default_rng(3)
    B, S = 3, 5
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    valid = np.arange(S)[None, :] < np.array([5, 2, 0])[:, None]
    if mixer == "rwkv":
        H, Nh = jcfg.rwkv_n_heads, jcfg.rwkv_head_dim
        state = {"tm_shift": rng.standard_normal((B, jcfg.d_model)),
                 "wkv": rng.standard_normal((B, H, Nh, Nh))}
        jf, tf = jrwkv.apply_rwkv, trwkv.apply_rwkv
    else:
        state = {"conv": rng.standard_normal(
                     (B, jcfg.mamba_d_conv - 1, jcfg.mamba_d_inner)),
                 "ssm": rng.standard_normal(
                     (B, jcfg.mamba_d_inner, jcfg.mamba_d_state))}
        jf, tf = jmamba.apply_mamba, tmamba.apply_mamba
    state = {k: v.astype(np.float32) for k, v in state.items()}
    yj, sj = jf(p, jcfg, x, state=state, return_state=True,
                valid=jnp.asarray(valid))
    t = lambda a: torch.from_numpy(np.array(a))
    tattn.set_attention_impl("kernel")      # a carried state: plain scan
    yt, st = tf(jax.tree_util.tree_map(t, p), tcfg, t(x),
                state={k: t(v) for k, v in state.items()},
                return_state=True, valid=t(valid))
    np.testing.assert_allclose(yt.numpy()[valid], np.asarray(yj)[valid],
                               **TOL)
    for k in state:
        np.testing.assert_allclose(st[k].numpy(), np.asarray(sj[k]), **TOL,
                                   err_msg=k)
        if k != "tm_shift":      # both take token 0 there; the engine
            #                      keeps an idle row's whole state
            np.testing.assert_allclose(st[k].numpy()[2], state[k][2], **TOL)


# ---------------------------------------------------------------------------
# Slot failures and cancels (tests/test_faults.py's genserve cases)
# ---------------------------------------------------------------------------

def _faults_setup():
    jcfg, tcfg = cfg_pair("ft-gs")
    jp, tp = params_pair(jcfg, tcfg)
    prompts = prompts_for(6, 3)
    gkw = dict(wave=4, max_new_tokens=N, eos_token=EOS, prefill_chunk=4,
               greedy=True, page_size=4, prefix_cache=True)
    return jcfg, tcfg, jp, tp, prompts, gkw


def test_slot_failure_requeues_without_leaks(monkeypatch):
    """Two slots die at round 2: their requests requeue and regenerate
    exactly the undisturbed rollout; strict mode proves zero leaked pages
    at teardown; the run equals the JAX engine's with the same
    failures."""
    monkeypatch.setenv("REPRO_OBS_STRICT", "1")
    jcfg, tcfg, jp, tp, prompts, gkw = _faults_setup()
    undisturbed, _ = tserve(tp, tcfg, torch.as_tensor(prompts), None,
                            TG(**gkw))
    ref, got = both(jp, jcfg, tp, tcfg, prompts, gkw,
                    slot_failures={2: [0, 1]})
    assert_match(ref, got)
    stats = got[1]
    assert stats["requeued"] == 2
    assert stats["retired"] == 6 and stats["cancelled"] == 0
    assert_same_port(undisturbed, got[0])


def test_cancel_retires_requests_without_leaks(monkeypatch):
    """Cancel rid 2 (in flight) and rid 5 (queued) at round 3: their rows
    are all zero, the rest equal the undisturbed run and the JAX
    engine's."""
    monkeypatch.setenv("REPRO_OBS_STRICT", "1")
    jcfg, tcfg, jp, tp, prompts, gkw = _faults_setup()
    undisturbed, _ = tserve(tp, tcfg, torch.as_tensor(prompts), None,
                            TG(**gkw))
    ref, got = both(jp, jcfg, tp, tcfg, prompts, gkw, cancels={3: [2, 5]})
    assert_match(ref, got)
    g = got[0]
    assert got[1]["cancelled"] == 2 and got[1]["requeued"] == 0
    for k in ("gen_tokens", "mask", "logprobs"):
        assert float(g[k][[2, 5]].abs().sum()) == 0, k
    keep = [0, 1, 3, 4]
    assert_same_port({k: v[keep] for k, v in undisturbed.items()},
                     {k: v[keep] for k, v in g.items()})


# ---------------------------------------------------------------------------
# GEN in the RL engine on chunked admission
# ---------------------------------------------------------------------------

def test_engine_gen_executor_chunked_prefill_parity():
    """``RLConfig(gen_engine="genserve", decode_chunk=2, prefill_chunk=2)``:
    greedy GEN tokens, prefill rounds and busy occupancy equal the JAX
    trainer's (bridged state), and the measured-vs-predicted occupancy
    report charges admission."""
    jcfg, tcfg = cfg_pair("gs-rl")
    rl = dict(algorithm="grpo", n_rollouts=4, max_new_tokens=4,
              gen_engine="genserve", decode_chunk=2, prefill_chunk=2,
              greedy=True)
    J = JTrainer(jcfg, JRL(**rl), JTask(max_operand=9), KEY)
    T_ = TTrainer(tcfg, TRL(**rl), TTask(max_operand=9), seed=0,
                  device="cpu")
    T_.load_state_tree(bridge.from_numpy_state_tree(
        jax.tree_util.tree_map(np.asarray, J.state_tree()), tcfg, "cpu"))
    prompts, answers = JTask(max_operand=9).sample_batch(
        np.random.default_rng(0), 3)
    bbs = {}
    orig = T_.before_stage

    def hook(stage, bb):
        bbs["bb"] = bb
        return orig(stage, bb)
    T_.before_stage = hook
    mj = J.iteration(prompts, answers, jax.random.PRNGKey(7))
    mt = T_.iteration(prompts, answers, None)
    for k in ("gen_prefill_rounds", "gen_busy_occupancy", "gen_wave",
              "gen_wave_occupancy", "gen_len"):
        assert mt[k] == pytest.approx(mj[k], rel=1e-9), k
    assert mt["gen_prefill_rounds"] >= 1
    assert 0 < mt["gen_busy_occupancy"] <= mt["gen_wave"]
    summary = T_.engine.wave_occupancy_summary()
    assert summary["measured_occupancy"] > 0
    assert summary["predicted_occupancy"] <= plan_mod.predicted_occupancy(
        12, wave=mt["gen_wave"])
    assert bbs["bb"]["bundle"]["rollout"]["gen_tokens"].shape == (12, 4)
