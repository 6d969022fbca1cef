"""The port's paged KV cache and radix prefix reuse against the JAX
package (``tests/test_paged.py``'s cases, one to one):

- the identity block table is invisible: paged equals contiguous chunked
  admission across ring windows, GQA, recycled slots, ragged prompts and
  EOS (sampled, within the port; greedy, against the JAX engine), and a
  single-wave paged batch equals the rollout;
- prefix sharing: greedy tokens and the skipped-token counts equal the
  JAX engine's, copy-on-write on a divergent partial page included;
- the host allocator (the port's copy of ``genserve.pagepool``) takes
  the same refcounts and free lists as the reference under a randomized
  admit / insert / evict / retire sequence;
- the device indirection: identity view == gather view, the paged
  scatters against the JAX functions on the same data, ``copy_pages``'s
  sentinel semantics, ``zero_paged_slots`` leaves the pool alone, and
  the sharing predicate.

Pool leaves carry two scratch pages past the allocator's ``n_pages``
(``cache.SCRATCH_PAGES``): page ``n_pages`` reads zeros, the last takes
the dropped writes."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.data.synthetic import EOS, VOCAB_SIZE  # noqa: E402
from repro.genserve.decoder import GenServeConfig as JG  # noqa: E402
from repro.genserve.decoder import serve as jserve  # noqa: E402
from repro.genserve.pagepool import PagePool as JPool  # noqa: E402
from repro.genserve.pagepool import RadixCache as JRadix  # noqa: E402
from repro.models import cache as jcache  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.config import LayerSpec as JLayer  # noqa: E402
from repro.models.config import ModelConfig as JModel  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.genserve.decoder import GenServeConfig as TG  # noqa: E402
from repro_torch.genserve.decoder import serve as tserve  # noqa: E402
from repro_torch.genserve.pagepool import PagePool, RadixCache  # noqa: E402
from repro_torch.models import cache as tcache  # noqa: E402
from repro_torch.models.config import LayerSpec as TLayer  # noqa: E402
from repro_torch.models.config import ModelConfig as TModel  # noqa: E402
from repro_torch.rl import rollout as trollout  # noqa: E402
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
         "prefill_rounds", "prefill_slot_steps", "prefills", "admitted",
         "retired", "prefix_hit_rate", "prefill_tokens_skipped",
         "prompt_tokens", "page_size", "prefix_cache")


def cfg_pair(window=None, n_kv_heads=2, pattern=None):
    kw = dict(name=f"pg-w{window}-kv{n_kv_heads}", n_layers=2, d_model=64,
              n_heads=2, n_kv_heads=n_kv_heads, head_dim=32, d_ff=128,
              vocab_size=VOCAB_SIZE, dtype="float32")
    windows = pattern or (window,)
    return (JModel(pattern=tuple(JLayer(window=w) for w in windows), **kw),
            TModel(pattern=tuple(TLayer(window=w) for w in windows), **kw))


def params_pair(jcfg, tcfg, seed=0):
    jp = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    return jp, bridge.from_numpy_params(
        jax.tree_util.tree_map(np.asarray, jp), tcfg, "cpu")


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
    assert torch.equal(a["sequences"][:, :P], b["sequences"][:, :P])


def both(jp, jcfg, tp, tcfg, prompts, gkw, **extra):
    ref = jserve(jp, jcfg, jnp.asarray(prompts), KEY, JG(**gkw), **extra)
    got = tserve(tp, tcfg, torch.as_tensor(prompts), None, TG(**gkw),
                 **extra)
    return ref, got


# ---------------------------------------------------------------------------
# Paged (identity block table) == contiguous, across the admission matrix
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window,kv,ps", [
    (None, 2, 4),     # full attention
    (6, 2, 4),        # ring window (< max_seq: wraps mid-run)
    (None, 1, 2),     # GQA, page smaller than any prompt
    (6, 1, 3),        # ring + GQA + page not dividing the window
])
def test_paged_noshare_matrix_exact(window, kv, ps):
    """Behind an identity block table the paged cache equals the
    contiguous chunked engine under sampling (one generator, the same
    draws) with recycled slots, prompts longer than the chunk, ragged
    prompt lengths and EOS; greedily it equals the JAX paged engine."""
    jcfg, tcfg = cfg_pair(window, kv)
    jp, tp = params_pair(jcfg, tcfg)
    B, W, C = 10, 3, 3
    prompts = prompts_for(B, 11)
    plens = [8, 5, 3, 8, 4, 8, 6, 3, 8, 5]
    lens = [N, 1, N, 2, 1, N, 2, N, 1, N]
    kw = dict(wave=W, max_new_tokens=N, eos_token=EOS, prefill_chunk=C,
              temperature=1.0, greedy=False)
    runs = [tserve(tp, tcfg, torch.as_tensor(prompts),
                   torch.Generator().manual_seed(7), TG(**kw, page_size=p),
                   gen_lens=lens, prompt_lens=plens) for p in (0, ps)]
    assert_same_port(runs[0][0], runs[1][0])
    stats = runs[1][1]
    assert stats["page_size"] == ps and not stats["prefix_cache"]
    assert stats["prefix_hit_rate"] == 0.0
    assert_match(*both(jp, jcfg, tp, tcfg, prompts,
                       dict(kw, greedy=True, page_size=ps),
                       gen_lens=lens, prompt_lens=plens))


def test_paged_single_wave_exact_vs_rollout():
    """A single-wave paged batch with sharing off equals the port's
    rollout (greedy) and the JAX paged engine."""
    jcfg, tcfg = cfg_pair()
    jp, tp = params_pair(jcfg, tcfg)
    prompts = prompts_for(4, 3)
    gkw = dict(wave=4, max_new_tokens=N, eos_token=EOS, prefill_chunk=3,
               greedy=True, page_size=4)
    ref, got = both(jp, jcfg, tp, tcfg, prompts, gkw)
    assert_match(ref, got)
    ro = trollout.generate(tp, tcfg, torch.as_tensor(prompts), None,
                           trollout.SamplerConfig(max_new_tokens=N,
                                                  greedy=True, eos_token=EOS))
    assert_same_port(ro, got[0])
    assert got[1]["admitted"] == got[1]["retired"] == 4


# ---------------------------------------------------------------------------
# Prefix sharing (greedy): exactness, hit accounting, copy-on-write
# ---------------------------------------------------------------------------

def test_prefix_sharing_greedy_exact_and_hits():
    """Staggered re-admissions of two hot prompts hit everything but the
    capped last token (8 x (P - 1) tokens skipped): tokens equal the
    contiguous run and the JAX engine's, hit counts included."""
    jcfg, tcfg = cfg_pair()
    jp, tp = params_pair(jcfg, tcfg)
    B, W, C, ps = 10, 2, 4, 2
    prompts = prompts_for(2, 5)[np.arange(B) % 2]
    lens = [3, 2, 4, 3, 2, 3, 4, 2, 3, 3]
    kw = dict(wave=W, max_new_tokens=N, prefill_chunk=C, greedy=True)
    ref, got = both(jp, jcfg, tp, tcfg, prompts,
                    dict(kw, page_size=ps, prefix_cache=True), gen_lens=lens)
    assert_match(ref, got)
    contiguous, _ = tserve(tp, tcfg, torch.as_tensor(prompts), None,
                           TG(**kw), gen_lens=lens)
    assert_same_port(contiguous, got[0])
    stats = got[1]
    assert stats["prefill_tokens_skipped"] == 8 * (P - 1)
    assert stats["prefix_hit_rate"] == pytest.approx(8 * 7 / (10 * 8))
    stats["_pagepool"].check()


def test_prefix_sharing_cow_divergent_page():
    """A prompt diverging inside the last matched partial page is served
    from a copy of the shared page: the donor's output is untouched and
    both equal the contiguous run and the JAX engine."""
    jcfg, tcfg = cfg_pair()
    jp, tp = params_pair(jcfg, tcfg)
    ps, C, W = 4, 4, 2
    rng = np.random.default_rng(9)
    base = rng.integers(0, VOCAB_SIZE, P)
    other = rng.integers(0, VOCAB_SIZE, P)
    div = base.copy()
    div[-1] = (div[-1] + 1) % VOCAB_SIZE     # diverge in page 1
    prompts = np.stack([base, other, div, base]).astype(np.int32)
    lens = [2, 6, 3, 3]
    kw = dict(wave=W, max_new_tokens=N, prefill_chunk=C, greedy=True)
    ref, got = both(jp, jcfg, tp, tcfg, prompts,
                    dict(kw, page_size=ps, prefix_cache=True), gen_lens=lens)
    assert_match(ref, got)
    contiguous, _ = tserve(tp, tcfg, torch.as_tensor(prompts), None,
                           TG(**kw), gen_lens=lens)
    assert_same_port(contiguous, got[0])
    assert got[1]["prefill_tokens_skipped"] == 2 * 7
    got[1]["_pagepool"].check()


# ---------------------------------------------------------------------------
# Host allocator invariants, step by step against the reference
# ---------------------------------------------------------------------------

def test_pagepool_radix_random_invariants():
    """The decoder's allocation discipline, randomized, on the port's
    PagePool / RadixCache and the reference's side by side: identical
    matches, allocations, refcounts and free lists at every step, the
    invariants hold, eviction always makes room (pool = 2*W*MP), and a
    full drain + evict returns every page."""
    ps, MP, W = 2, 4, 2
    NP = 2 * W * MP
    sides = [(PagePool(NP, ps),), (JPool(NP, ps),)]
    sides = [(pool, Radix(pool), {}) for (pool,), Radix in
             zip(sides, (RadixCache, JRadix))]
    rng = np.random.default_rng(0)
    for _ in range(300):
        admit = len(sides[0][2]) < W and (not sides[0][2]
                                          or rng.random() < 0.6)
        if admit:
            toks = rng.integers(0, 3, P).tolist()
            slot = min(set(range(W)) - set(sides[0][2]))
        else:
            victim = int(rng.choice(sorted(sides[0][2])))
        for pool, radix, live in sides:
            if admit:
                full, part = radix.match(toks, len(toks) - 1)
                pool.incref(full)
                cow = []
                if part is not None:
                    pool.incref([part[0]])
                    cow = [part[0]]
                need = MP - len(full)
                if pool.available() < need:
                    radix.evict(need - pool.available())
                fresh = pool.alloc(need)
                assert fresh is not None, "2*W*MP pool must always admit"
                pool.decref(cow)
                row = full + fresh
                live[slot] = row
                radix.insert(toks, row[:len(toks) // ps])
            else:
                pool.decref(live.pop(victim))
            pool.check()
            assert all(rc <= W + 1 for rc in pool.refcount)
        (a, ra, la), (b, rb, lb) = sides
        assert a.refcount == b.refcount and a._free == b._free
        assert la == lb and ra.page_refs() == rb.page_refs()
    for pool, radix, live in sides:
        for row in live.values():
            pool.decref(row)
        radix.evict(NP)
        assert pool.available() == NP
        pool.check()


def test_leak_check_strict(monkeypatch):
    """A reference beyond the expected ones is a leak: warned, counted,
    and raised under REPRO_OBS_STRICT=1, as the reference's."""
    pool = PagePool(4, 2)
    pages = pool.alloc(2)
    with pytest.warns(RuntimeWarning, match="page pool leak"):
        assert pool.leak_check({pages[0]: 1}) == [pages[1]]
    monkeypatch.setenv("REPRO_OBS_STRICT", "1")
    with pytest.raises(RuntimeError, match="page pool leak"):
        pool.leak_check({})
    assert pool.leak_check({p: 1 for p in pages}) == []


# ---------------------------------------------------------------------------
# Device-side indirection units
# ---------------------------------------------------------------------------

def _random_paged(cfg, W, max_seq, ps, seed=0, n_pages=0):
    blocks = tcache.init_paged_cache(cfg, W, max_seq, page_size=ps,
                                     n_pages=n_pages,
                                     dtype=torch.float32)["blocks"]
    g = torch.Generator().manual_seed(seed)
    out = tree_map(lambda l: torch.randn(l.shape, generator=g), blocks)
    for layer in out.values():           # scratch pages as the engine
        for kk in ("k", "v"):            # leaves them: never written
            layer[kk][:, tcache.pool_pages(layer[kk]):] = 0
    return out


def test_identity_view_matches_gather_view():
    """The identity view (a view of the pool) equals the gather through
    an identity block table — windowed layers, whose page count is below
    the table's width, included — and is the JAX package's view of the
    same pool."""
    jcfg, tcfg = cfg_pair(pattern=(None, 6))
    W, max_seq, ps = 3, 14, 4
    blocks = _random_paged(tcfg, W, max_seq, ps)
    MP = tcache.max_pages_per_slot(tcfg, max_seq, ps)
    btab = torch.as_tensor(tcache.identity_block_table(W, MP))
    a = tcache.paged_view(tcfg, blocks, btab, max_seq, page_size=ps)
    b = tcache.paged_view(tcfg, blocks, btab, max_seq, page_size=ps,
                          identity=True)
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)
    # the JAX package on the same pool (its leaves carry no scratch pages)
    jblocks = jax.tree_util.tree_map(
        lambda l: jnp.asarray(l[:, :W * MP].numpy()
                              if l.shape[1] == W * MP + 2 else l.numpy()),
        blocks)
    j = jcache.paged_view(jcfg, jblocks, jnp.asarray(btab.numpy()), max_seq,
                          page_size=ps)
    for x, y in zip(tree_leaves(a), jax.tree_util.tree_leaves(j)):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def test_paged_updates_match_jax():
    """paged_update_decode / paged_update_chunk on a scattered block table
    (unmapped entries and masked rows included) leave the pool exactly as
    the JAX functions do."""
    jcfg, tcfg = cfg_pair(pattern=(None, 6))
    W, max_seq, ps = 3, 14, 4
    MP = tcache.max_pages_per_slot(tcfg, max_seq, ps)
    NP = 2 * W * MP
    blocks = _random_paged(tcfg, W, max_seq, ps, seed=1, n_pages=NP)
    rng = np.random.default_rng(4)
    btab = rng.permutation(NP)[:W * MP].reshape(W, MP).astype(np.int32)
    btab[2, -1] = NP                                     # unmapped
    view = tree_map(lambda l: torch.randn(l.shape, generator=torch.Generator(
        ).manual_seed(2)), tcache.paged_view(tcfg, blocks,
                                            torch.as_tensor(btab), max_seq,
                                            page_size=ps))
    to_j = lambda t: jnp.asarray(t.numpy())
    strip = lambda tree: jax.tree_util.tree_map(
        lambda l: to_j(l[:, :NP]) if l.shape[1] == NP + 2 else to_j(l), tree)
    pos = np.array([3, 13, 9])
    emit = np.array([True, True, False])
    ref = jcache.paged_update_decode(jcfg, strip(blocks), strip(view),
                                     jnp.asarray(btab), jnp.asarray(pos),
                                     jnp.asarray(emit), max_seq, page_size=ps)
    got = tcache.paged_update_decode(
        tcfg, tree_map(torch.clone, blocks), view, torch.as_tensor(btab),
        torch.as_tensor(pos), torch.as_tensor(emit), max_seq, page_size=ps)
    for x, y in zip(tree_leaves(got), jax.tree_util.tree_leaves(ref)):
        np.testing.assert_array_equal(x.numpy()[:, :y.shape[1]],
                                      np.asarray(y))
    pcur, n_valid = np.array([0, 9, 4]), np.array([4, 3, 0])
    ref = jcache.paged_update_chunk(jcfg, strip(blocks), strip(view),
                                    jnp.asarray(btab), jnp.asarray(pcur),
                                    jnp.asarray(n_valid), 4, max_seq,
                                    page_size=ps)
    got = tcache.paged_update_chunk(
        tcfg, tree_map(torch.clone, blocks), view, torch.as_tensor(btab),
        torch.as_tensor(pcur), torch.as_tensor(n_valid), 4, max_seq,
        page_size=ps)
    for x, y in zip(tree_leaves(got), jax.tree_util.tree_leaves(ref)):
        np.testing.assert_array_equal(x.numpy()[:, :y.shape[1]],
                                      np.asarray(y))


def test_copy_pages_sentinel_semantics():
    """copy_pages: a sentinel source writes zeros, a sentinel destination
    is dropped, real pairs copy exactly."""
    _, tcfg = cfg_pair()
    W, max_seq, ps = 2, 14, 4
    blocks = _random_paged(tcfg, W, max_seq, ps)
    NP = tcache.pool_pages(blocks["layer0"]["k"])
    assert NP == W * tcache.max_pages_per_slot(tcfg, max_seq, ps)
    old = tree_map(torch.clone, blocks)
    out = tcache.copy_pages(tcfg, blocks, torch.as_tensor([0, NP, 1]),
                            torch.as_tensor([2, 3, NP]))
    for name in old:
        for leaf in ("k", "v"):
            o, n = old[name][leaf], out[name][leaf]
            assert torch.equal(n[:, 2], o[:, 0])
            assert torch.equal(n[:, 3], torch.zeros_like(o[:, 3]))
            keep = [i for i in range(NP) if i not in (2, 3)]
            assert torch.equal(n[:, keep], o[:, keep])
            assert torch.equal(n[:, NP], torch.zeros_like(o[:, NP]))


def test_zero_paged_slots_leaves_pool_untouched():
    """Zeroing a recycled slot must not clobber the pool: its pages may
    be shared with (or reallocated to) other slots."""
    _, tcfg = cfg_pair()
    blocks = _random_paged(tcfg, 2, 14, 4)
    old = tree_map(torch.clone, blocks)
    out = tcache.zero_paged_slots(tcfg, blocks, torch.as_tensor([True, False]))
    for name in old:
        for leaf in ("k", "v"):
            assert torch.equal(out[name][leaf], old[name][leaf])


def test_supports_prefix_sharing_predicate():
    """Equal to the reference's predicate: full-window attention only."""
    from repro.configs.archs import SMOKE
    from repro_torch.configs import archs as tarchs
    for window in (None, 6):
        jcfg, tcfg = cfg_pair(window)
        assert tcache.supports_prefix_sharing(tcfg) \
            == jcache.supports_prefix_sharing(jcfg) == (window is None)
    for name in SMOKE:
        assert tcache.supports_prefix_sharing(tarchs.SMOKE[name]) \
            == jcache.supports_prefix_sharing(SMOKE[name]), name
        assert tcache.max_pages_per_slot(tarchs.SMOKE[name], 40, 8) \
            == jcache.max_pages_per_slot(SMOKE[name], 40, 8), name
