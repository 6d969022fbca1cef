"""Speculative decoding on the port against the JAX package
(``tests/test_speculative.py``'s cases, one to one): draft-k propose, one
batched verify.

- greedy speculation equals the JAX engine's token for token (and the
  port's plain engine) across one-shot and chunked admission, ring
  windows, GQA, the paged cache, prefix sharing, recycled slots, ragged
  prompts, budgets and EOS, with the same proposed / accepted counts;
- sampled speculation keeps the rollout contract, and
  ``speculative_accept``'s rejection resampling preserves the target
  distribution (a total-variation bound);
- a draft that agrees with the target accepts (nearly) everything and
  finishes in fewer rounds;
- ``verify_chunk_step`` scores exactly what C sequential ``decode_step``
  calls score (and equals the JAX step), and writes nothing;
- the gates (support predicates, configuration errors) and the
  short-validity chunk writes (``write_kv``, ``paged_update_chunk``)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.data.synthetic import EOS, VOCAB_SIZE  # noqa: E402
from repro.genserve.decoder import GenServeConfig as JG  # noqa: E402
from repro.genserve.decoder import serve as jserve  # noqa: E402
from repro.models import cache as jcache  # noqa: E402
from repro.models import sampling as jsampling  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.config import LayerSpec as JLayer  # noqa: E402
from repro.models.config import Mixer as JMixer  # noqa: E402
from repro.models.config import ModelConfig as JModel  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.genserve.decoder import GenServeConfig as TG  # noqa: E402
from repro_torch.genserve.decoder import serve as tserve  # noqa: E402
from repro_torch.models import cache as tcache  # noqa: E402
from repro_torch.models import sampling as tsampling  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.config import LayerSpec as TLayer  # noqa: E402
from repro_torch.models.config import Mixer as TMixer  # noqa: E402
from repro_torch.models.config import ModelConfig as TModel  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402


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
         "prefill_rounds", "admitted", "retired", "spec_k", "spec_proposed",
         "spec_accepted", "spec_tokens", "prefix_hit_rate",
         "prefill_tokens_skipped")


def spec_cfg(window=None, kv=2, n_heads=2, softcap=None, n_layers=2):
    kw = dict(name=f"sp-w{window}-kv{kv}-h{n_heads}-sc{softcap}",
              n_layers=n_layers, d_model=64, n_heads=n_heads, n_kv_heads=kv,
              head_dim=32, d_ff=128, vocab_size=VOCAB_SIZE, dtype="float32",
              attn_softcap=softcap)
    return (JModel(pattern=(JLayer(window=window),), **kw),
            TModel(pattern=(TLayer(window=window),), **kw))


def draft_for(jcfg, tcfg, key=5):
    """A 1-layer full-attention draft sharing the target's vocab, in both
    packages on the same weights."""
    djc = dataclasses.replace(jcfg, name=f"{jcfg.name}-draft", n_layers=1,
                              pattern=(JLayer(window=None),))
    dtc = dataclasses.replace(tcfg, name=f"{tcfg.name}-draft", n_layers=1,
                              pattern=(TLayer(window=None),))
    djp = JT.init_params(jax.random.PRNGKey(key), djc)
    return (djc, djp), (dtc, _bridge(djp, dtc))


def _bridge(jp, tcfg):
    return bridge.from_numpy_params(jax.tree_util.tree_map(np.asarray, jp),
                                    tcfg, "cpu")


def prompts_for(n, key):
    return np.array(jax.random.randint(jax.random.PRNGKey(key), (n, P), 0,
                                       VOCAB_SIZE, jnp.int32))


def assert_match(ref, got, keys=STATS):
    (r, rs), (g, gs) = ref, got
    np.testing.assert_array_equal(g["mask"].numpy(), np.asarray(r["mask"]))
    np.testing.assert_array_equal(g["gen_tokens"].numpy(),
                                  np.asarray(r["gen_tokens"]))
    np.testing.assert_allclose(g["logprobs"].numpy(),
                               np.asarray(r["logprobs"]), **TOL)
    for k in keys:
        assert gs[k] == rs[k], k


def assert_same_port(a, b):
    assert torch.equal(a["mask"], b["mask"])
    assert torch.equal(a["gen_tokens"] * a["mask"].long(),
                       b["gen_tokens"] * b["mask"].long())
    torch.testing.assert_close(a["logprobs"] * a["mask"],
                               b["logprobs"] * b["mask"], **TOL)


def run_spec(jcfg, tcfg, gkw, spec_k, *, n_reqs=8, pkey=11, gen_lens=None,
             prompt_lens=None, prompts=None):
    """((JAX spec, port spec), port plain), each a (rollout, stats)."""
    jp = JT.init_params(KEY, jcfg)
    tp = _bridge(jp, tcfg)
    (djc, djp), (dtc, dtp) = draft_for(jcfg, tcfg)
    if prompts is None:
        prompts = prompts_for(n_reqs, pkey)
    extra = dict(gen_lens=gen_lens, prompt_lens=prompt_lens)
    ref = jserve(jp, jcfg, jnp.asarray(prompts), jax.random.PRNGKey(7),
                 JG(**gkw, spec_k=spec_k), draft_params=djp, draft_cfg=djc,
                 **extra)
    got = tserve(tp, tcfg, torch.as_tensor(prompts), None,
                 TG(**gkw, spec_k=spec_k), draft_params=dtp, draft_cfg=dtc,
                 **extra)
    plain = tserve(tp, tcfg, torch.as_tensor(prompts), None, TG(**gkw),
                   **extra)
    return (ref, got), plain


# ---------------------------------------------------------------------------
# Greedy parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window,kv,ps,k,C", [
    (None, 2, 0, 2, 0),   # one-shot admission, full attention
    (None, 2, 0, 4, 3),   # chunked ragged admission
    (6, 2, 0, 3, 3),      # ring-window target (wraps mid-run)
    (None, 1, 4, 2, 3),   # paged + GQA
    (6, 1, 4, 4, 3),      # ring + GQA + paged
])
def test_spec_greedy_parity_matrix(window, kv, ps, k, C):
    """Greedy speculation equals the JAX engine's (accept counts
    included) and the port's plain engine, with recycled slots, budgets,
    EOS and, when chunked, ragged prompt lengths."""
    jcfg, tcfg = spec_cfg(window, kv)
    lens = [N, 1, N, 2, 1, N, 2, N]
    plens = [8, 5, 3, 8, 4, 8, 6, 3] if C else None
    gkw = dict(wave=3, max_new_tokens=N, eos_token=EOS, temperature=0.0,
               greedy=True, prefill_chunk=C, page_size=ps)
    (ref, got), plain = run_spec(jcfg, tcfg, gkw, k, gen_lens=lens,
                                 prompt_lens=plens)
    assert_match(ref, got)
    assert_same_port(plain[0], got[0])
    stats = got[1]
    assert stats["spec_k"] == k
    assert 0 <= stats["spec_accepted"] <= stats["spec_proposed"]
    assert stats["accept_rate"] == pytest.approx(ref[1]["accept_rate"])


def test_spec_greedy_parity_gqa_softcap():
    """Softcapped logits and 4:2 grouped-query heads through the verify
    step."""
    jcfg, tcfg = spec_cfg(None, kv=2, n_heads=4, softcap=30.0)
    gkw = dict(wave=3, max_new_tokens=N, eos_token=EOS, temperature=0.0,
               greedy=True)
    (ref, got), plain = run_spec(jcfg, tcfg, gkw, 3)
    assert_match(ref, got)
    assert_same_port(plain[0], got[0])


def test_spec_greedy_parity_prefix_sharing():
    """Radix prefix reuse with speculation: shared prompt prefixes skip
    their prefill (the draft still ingests the whole prompt) and the
    tokens stay exact."""
    jcfg, tcfg = spec_cfg()
    prompts = prompts_for(6, 13)
    prompts[:, :6] = prompts[0, :6]          # shared system prompt
    gkw = dict(wave=3, max_new_tokens=N, eos_token=EOS, temperature=0.0,
               greedy=True, prefill_chunk=4, page_size=4, prefix_cache=True)
    (ref, got), plain = run_spec(jcfg, tcfg, gkw, 2, prompts=prompts)
    assert_match(ref, got)
    assert_same_port(plain[0], got[0])
    assert got[1]["prefix_hit_rate"] > 0.0
    assert got[1]["prefix_hit_rate"] == plain[1]["prefix_hit_rate"]


def test_spec_high_accept_draft_accepts_everything():
    """A target whose second layer is zeroed agrees with the 1-layer draft
    built from its own first layer: acceptance is (nearly) total and the
    wave needs fewer rounds than plain decode takes steps; the counts
    equal the JAX engine's."""
    jcfg, tcfg = spec_cfg(n_layers=2)
    jp = JT.init_params(KEY, jcfg)
    jp = dict(jp, blocks=jax.tree_util.tree_map(
        lambda x: x.at[1].set(0.0) if x.shape[0] == 2 else x, jp["blocks"]))
    djc = dataclasses.replace(jcfg, name=f"{jcfg.name}-self", n_layers=1)
    dtc = dataclasses.replace(tcfg, name=f"{tcfg.name}-self", n_layers=1)
    djp = {"embed": jp["embed"], "final_norm": jp["final_norm"],
           "blocks": jax.tree_util.tree_map(lambda x: x[:1], jp["blocks"])}
    tp, dtp = _bridge(jp, tcfg), _bridge(djp, dtc)
    prompts = prompts_for(4, 9)
    NN = 8
    kw = dict(wave=4, max_new_tokens=NN, temperature=0.0, greedy=True)
    ref = jserve(jp, jcfg, jnp.asarray(prompts), KEY, JG(**kw, spec_k=4),
                 draft_params=djp, draft_cfg=djc)
    got = tserve(tp, tcfg, torch.as_tensor(prompts), None, TG(**kw, spec_k=4),
                 draft_params=dtp, draft_cfg=dtc)
    plain, pstats = tserve(tp, tcfg, torch.as_tensor(prompts), None,
                           TG(**kw))
    assert_match(ref, got)
    assert_same_port(plain, got[0])
    stats = got[1]
    assert stats["accept_rate"] >= 0.9
    assert stats["decode_steps"] < pstats["decode_steps"]
    assert stats["decode_steps"] <= NN // 2


# ---------------------------------------------------------------------------
# Sampled mode: contract invariants + distribution preservation
# ---------------------------------------------------------------------------

def test_spec_sampled_mode_contract():
    """Sampled speculation keeps the rollout contract: monotone masks, the
    first EOS valid and last, finite logprobs on valid positions, prompts
    untouched."""
    _, tcfg = spec_cfg()
    tp = TT.init_params(tcfg, seed=0)
    dtc = dataclasses.replace(tcfg, name="sp-draft", n_layers=1)
    dtp = TT.init_params(dtc, seed=5)
    prompts = torch.as_tensor(prompts_for(6, 17))
    ro, stats = tserve(tp, tcfg, prompts, torch.Generator().manual_seed(7),
                       TG(wave=3, max_new_tokens=N, eos_token=EOS,
                          temperature=1.0, greedy=False, spec_k=4),
                       draft_params=dtp, draft_cfg=dtc)
    mask = ro["mask"].numpy()
    assert np.all(np.diff(mask, axis=1) <= 0), "mask must be monotone"
    lp = ro["logprobs"].numpy()
    assert np.all(np.isfinite(lp[mask.astype(bool)]))
    assert np.all(lp[mask.astype(bool)] <= 1e-6)
    assert torch.equal(ro["sequences"][:, :P], prompts)
    gen = ro["gen_tokens"].numpy()
    for b, t in zip(*np.nonzero(mask.astype(bool) & (gen == EOS))):
        assert mask[b, t + 1:].sum() == 0
    assert stats["spec_proposed"] > 0
    assert 0 <= stats["spec_accepted"] <= stats["spec_proposed"]
    assert 0.0 <= stats["accept_rate"] <= 1.0


def test_speculative_accept_greedy_unit():
    """Hand-built logits: longest-prefix match, bonus = target argmax at
    the first mismatch (or position k after a clean sweep) — the same
    answer as the JAX function."""
    B, k, V = 3, 3, 6
    tgt = np.array([[1, 2, 3, 4], [0, 0, 0, 0], [5, 1, 2, 3]])
    logits = np.full((B, k + 1, V), -10.0, np.float32)
    for b in range(B):
        for j in range(k + 1):
            logits[b, j, tgt[b, j]] = 10.0
    drafts = np.array([[1, 2, 0], [1, 0, 0], [5, 1, 2]])
    a, cand = tsampling.speculative_accept(
        None, torch.as_tensor(logits), torch.as_tensor(drafts),
        torch.zeros((B, k, V)), temperature=0.0, greedy=True)
    ja, jc = jsampling.speculative_accept(
        KEY, jnp.asarray(logits), jnp.asarray(drafts, jnp.int32),
        jnp.zeros((B, k, V)), temperature=0.0, greedy=True)
    assert a.tolist() == [2, 0, 3] == np.asarray(ja).tolist()
    np.testing.assert_array_equal(cand.numpy(), np.asarray(jc))
    assert cand[0, :3].tolist() == [1, 2, 3] and cand[1, 0] == 0
    assert cand[2].tolist() == [5, 1, 2, 3]


def test_speculative_accept_sampled_preserves_target():
    """Rejection resampling emits the *target* distribution at the first
    speculated position although proposals come from a very different
    draft (total variation < 0.03 over 20000 draws), and a position-k
    bonus follows the target at k (all drafts accepted)."""
    B, V = 20000, 4
    p_logits = torch.tensor([0.5, -0.5, 1.5, 0.0])
    q_logits = torch.tensor([2.0, 0.0, -2.0, 1.0])
    g = torch.Generator().manual_seed(42)
    ql = q_logits.expand(B, 1, V)
    drafts = torch.multinomial(torch.softmax(q_logits, -1).expand(B, V), 1,
                               replacement=True, generator=g)
    a, cand = tsampling.speculative_accept(g, p_logits.expand(B, 2, V),
                                           drafts, ql, temperature=1.0,
                                           greedy=False)
    emp = np.bincount(cand[:, 0].numpy(), minlength=V) / B
    target = torch.softmax(p_logits, -1).numpy()
    assert 0.5 * np.abs(emp - target).sum() < 0.03
    assert int(a.min()) >= 0 and int(a.max()) <= 1
    # a draft equal to the target is always accepted; the bonus is p_k's
    same = tsampling.speculative_accept(
        g, p_logits.expand(B, 2, V), drafts, p_logits.expand(B, 1, V),
        temperature=1.0, greedy=False)
    assert int(same[0].min()) == 1
    emp = np.bincount(same[1][:, 1].numpy(), minlength=V) / B
    assert 0.5 * np.abs(emp - target).sum() < 0.03


# ---------------------------------------------------------------------------
# verify_chunk_step == C sequential decode steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [None, 4])
def test_verify_chunk_step_matches_sequential(window):
    """Verify over a [B, C] chunk scores what C decode steps score, equals
    the JAX verify step (logits and chunk k/v), and leaves the cache
    untouched."""
    jcfg, tcfg = spec_cfg(window)
    jp = JT.init_params(KEY, jcfg)
    tp = _bridge(jp, tcfg)
    B, C = 3, 4
    prompts = torch.as_tensor(prompts_for(B, 21))
    out = TT.forward(tp, tcfg, {"tokens": prompts}, return_cache=True,
                     max_cache_len=P + C)
    chunk = np.array(jax.random.randint(jax.random.PRNGKey(23), (B, C), 0,
                                        VOCAB_SIZE, jnp.int32))
    base = out["cache"]["blocks"]
    before = tree_map(torch.clone, base)
    pos0 = torch.full((B,), P, dtype=torch.int64)
    vlogits, deltas = TT.verify_chunk_step(
        tp, tcfg, torch.as_tensor(chunk), {"blocks": base, "pos": pos0})
    for x, y in zip(tree_leaves(base), tree_leaves(before)):
        assert torch.equal(x, y)
    jblocks = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), base)
    jl, jd = JT.verify_chunk_step(jp, jcfg, jnp.asarray(chunk),
                                  {"blocks": jblocks,
                                   "pos": jnp.asarray(pos0.numpy())})
    np.testing.assert_allclose(vlogits.numpy(), np.asarray(jl), **TOL)
    for name, d in deltas.items():
        assert set(d) == {"k", "v"} and d["k"].shape[2] == C
        for kk in d:
            np.testing.assert_allclose(d[kk].numpy(), np.asarray(jd[name][kk]),
                                       **TOL)
    cache = {"blocks": base, "pos": pos0}
    seq = []
    for c in range(C):
        lg, cache = TT.decode_step(
            tp, tcfg, torch.as_tensor(chunk[:, c:c + 1]), cache)
        seq.append(lg)
    torch.testing.assert_close(vlogits, torch.stack(seq, dim=1), **TOL)


# ---------------------------------------------------------------------------
# Gating: what can(not) speculate, and why
# ---------------------------------------------------------------------------

def test_spec_support_predicates():
    for jc, tc in (spec_cfg(None), spec_cfg(6)):
        for fn in ("supports_speculative_target",
                   "supports_speculative_draft"):
            assert getattr(tcache, fn)(tc) == getattr(jcache, fn)(jc), fn
    full, ring = spec_cfg(None)[1], spec_cfg(6)[1]
    mamba = dataclasses.replace(full,
                                pattern=(TLayer(mixer=TMixer.MAMBA),))
    jmamba = dataclasses.replace(spec_cfg(None)[0],
                                 pattern=(JLayer(mixer=JMixer.MAMBA),))
    assert tcache.supports_speculative_target(full)
    assert tcache.supports_speculative_target(ring)
    assert tcache.supports_speculative_draft(full)
    assert not tcache.supports_speculative_draft(ring)
    assert not tcache.supports_speculative_target(mamba)
    assert not jcache.supports_speculative_target(jmamba)


def test_spec_gating_errors():
    """A ring draft, a draft of another vocabulary, a missing draft and
    the vmapped path with spec_k are refused (ValueError here, where the
    JAX engine asserts)."""
    _, tcfg = spec_cfg()
    tp = TT.init_params(tcfg, seed=0)
    prompts = torch.as_tensor(prompts_for(2, 3))
    gcfg = TG(wave=2, max_new_tokens=2, temperature=0.0, greedy=True,
              spec_k=2)
    ring = dataclasses.replace(tcfg, name="rd", pattern=(TLayer(window=4),))
    with pytest.raises(ValueError, match="full-window"):
        tserve(tp, tcfg, prompts, None, gcfg,
               draft_params=TT.init_params(ring), draft_cfg=ring)
    bad = dataclasses.replace(tcfg, name="bv", vocab_size=tcfg.vocab_size + 1)
    with pytest.raises(ValueError, match="vocabulary"):
        tserve(tp, tcfg, prompts, None, gcfg,
               draft_params=TT.init_params(bad), draft_cfg=bad)
    with pytest.raises(ValueError, match="draft_params"):
        tserve(tp, tcfg, prompts, None, gcfg)
    with pytest.raises(ValueError, match="batched"):
        TG(wave=2, max_new_tokens=2, spec_k=2,
           decode_path="vmapped").validate()
    rw = dataclasses.replace(tcfg, name="rw", pattern=(
        TLayer(mixer=TMixer.RWKV6),))
    with pytest.raises(ValueError, match="attention-only"):
        tserve(TT.init_params(rw), rw, prompts, None, gcfg,
               draft_params=tp, draft_cfg=tcfg)


# ---------------------------------------------------------------------------
# Short-validity chunk writes (the machinery accepts ride on)
# ---------------------------------------------------------------------------

def _ref_write(cache, new, pos, window, valid):
    """Token-by-token reference for write_kv's scatter semantics."""
    B, C = new.shape[:2]
    L = cache.shape[1]
    ref = np.array(cache)
    for b in range(B):
        wrote_end = False
        for c in range(C):
            if not valid[b, c]:
                continue
            p = pos[b] + c
            if window is not None:
                ref[b, p % L] = new[b, c]
            elif p < L - 1:
                ref[b, p] = new[b, c]
            elif not wrote_end:
                ref[b, L - 1] = new[b, c]   # keep-first clamp
                wrote_end = True
    return ref


@pytest.mark.parametrize("window,pos,n_valid", [
    (4, [2, 3, 0], [3, 5, 0]),     # accept < k wrapping the ring mid-chunk
    (4, [0, 1, 2], [0, 0, 0]),     # accept 0 everywhere: cache untouched
    (None, [3, 6, 0], [4, 3, 2]),  # full cache, clamped tail keep-first
])
def test_write_kv_short_validity(window, pos, n_valid):
    """Per-row chunk writes with short validity masks (as the verify
    commit makes them) against a token-by-token reference and the JAX
    function; the one-token masked decode write as well."""
    B, C, L, KV, hd = 3, 5, 8 if window is None else window, 2, 4
    rng = np.random.default_rng(0)
    cache = rng.standard_normal((B, L, KV, hd)).astype(np.float32)
    k_new = rng.standard_normal((B, C, KV, hd)).astype(np.float32)
    v_new = rng.standard_normal((B, C, KV, hd)).astype(np.float32)
    valid = np.arange(C)[None, :] < np.asarray(n_valid)[:, None]
    ck, cv = tcache.write_kv(torch.tensor(cache), torch.tensor(cache),
                             torch.tensor(k_new), torch.tensor(v_new),
                             torch.tensor(pos), window,
                             valid=torch.tensor(valid))
    np.testing.assert_array_equal(ck.numpy(),
                                  _ref_write(cache, k_new, pos, window, valid))
    np.testing.assert_array_equal(cv.numpy(),
                                  _ref_write(cache, v_new, pos, window, valid))
    jk, _ = jcache.write_kv(jnp.asarray(cache), jnp.asarray(cache),
                            jnp.asarray(k_new), jnp.asarray(v_new),
                            jnp.asarray(pos, jnp.int32), window,
                            valid=jnp.asarray(valid))
    np.testing.assert_array_equal(ck.numpy(), np.asarray(jk))
    one = valid[:, :1]
    ck1, _ = tcache.write_kv(torch.tensor(cache), torch.tensor(cache),
                             torch.tensor(k_new[:, :1]),
                             torch.tensor(v_new[:, :1]), torch.tensor(pos),
                             window, valid=torch.tensor(one))
    np.testing.assert_array_equal(
        ck1.numpy(), _ref_write(cache, k_new[:, :1], pos, window, one))


def test_paged_update_chunk_short_validity():
    """Live chunk tokens land at btab[slot // ps] pages, a zero-valid row
    leaves its pool pages untouched."""
    cfg = TModel(name="pgu", n_layers=1, d_model=16, n_heads=2, n_kv_heads=2,
                 head_dim=8, d_ff=32, vocab_size=VOCAB_SIZE, dtype="float32",
                 pattern=(TLayer(window=None),))
    B, C, ps, max_seq = 3, 4, 2, 8
    L = tcache.kv_cache_len(cfg, cfg.pattern[0], max_seq, False)
    n_pool, KV, hd = B * (L // ps), 2, 8
    rng = np.random.default_rng(1)
    pool = np.zeros((1, n_pool + tcache.SCRATCH_PAGES, ps, KV, hd),
                    np.float32)
    view = rng.standard_normal((1, B, L, KV, hd)).astype(np.float32)
    btab = np.arange(B * (L // ps)).reshape(B, L // ps)
    pcur, n_valid = [0, 3, 5], [4, 2, 0]
    out = tcache.paged_update_chunk(
        cfg, {"layer0": {"k": torch.tensor(pool), "v": torch.tensor(pool)}},
        {"layer0": {"k": torch.tensor(view), "v": torch.tensor(view)}},
        torch.as_tensor(btab), torch.as_tensor(pcur),
        torch.as_tensor(n_valid), C, max_seq, page_size=ps)
    ref = pool.copy()
    for b in range(B):
        for c in range(n_valid[b]):
            slot = min(pcur[b] + c, L - 1)
            ref[0, btab[b, slot // ps], slot % ps] = view[0, b, slot]
    np.testing.assert_array_equal(out["layer0"]["k"].numpy()[:, :n_pool],
                                  ref[:, :n_pool])
    np.testing.assert_array_equal(out["layer0"]["v"].numpy()[:, :n_pool],
                                  ref[:, :n_pool])
    np.testing.assert_array_equal(out["layer0"]["k"].numpy()[0, btab[2]],
                                  pool[0, btab[2]])
