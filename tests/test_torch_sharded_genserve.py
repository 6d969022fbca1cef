"""The genserve engine on a device mesh: ``genserve.generate(mesh=)`` on 4
gloo ranks (a 2x2 ("data", "model") mesh) in every engine mode, against
the port's world of one and the JAX engine on one device, on the JAX
package's smoke weights; the JAX engine's own ``generate(mesh=)`` on 4
forced host devices; and the RL engine's sharded GEN beyond one decode
wave (plain and chunked admission) and ``RLTrainer.evaluate`` on 8
ranks, against the world of one.

The ranks run in subprocesses with timeouts of their own
(``tests/torch_sharded_ranks.py``, ``tests/jax_mesh_serve.py``), started
together so that the JAX references compute while they run.  Greedy
decoding throughout: tokens, masks and the engine statistics the
reference tests read identical, log-probs within 2e-4 (fp32), zero
leaked pages under ``REPRO_OBS_STRICT=1``.  After serving, every cache
leaf is still a DTensor with its declared placements, and no all-gather
of the run took a cache shard's shape (the slot-indexed writes land in
each rank's own shard).
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

from repro.configs.archs import SMOKE  # noqa: E402
from repro.genserve import adapter as jadapter  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.rl.rollout import SamplerConfig as JSampler  # noqa: E402
from repro_torch.configs import archs as tarchs  # noqa: E402
from repro_torch.launch import sharded_exec  # noqa: E402

from test_torch_sharded import HELPER, REPO  # noqa: E402

ARCH, RWKV = "qwen3-0.6b", "rwkv6-3b"
B, P, N = 10, 8, 6
TOL = dict(rtol=2e-4, atol=2e-4)
STATS = ("decode_steps", "slot_steps", "occupancy_trace", "prefill_trace",
         "prefill_rounds", "prefill_slot_steps", "prefills", "admitted",
         "retired", "requeued", "cancelled", "prefix_hit_rate",
         "prefill_tokens_skipped", "prompt_tokens", "mean_occupancy",
         "busy_occupancy", "prefill_rounds_per_req", "spec_proposed",
         "spec_accepted", "spec_tokens", "accept_rate")
GEN_LENS = [6, 2, 5, 1, 6, 3, 4, 6, 2, 5]


def _prompts():
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, SMOKE[ARCH].vocab_size, (B, P))
    shared = prompts.copy()
    shared[:, :5] = prompts[0, :5]          # one page and a part shared
    shared[5:8] = prompts[0]                # whole prompts repeated
    return prompts, shared


def modes():
    """name -> (arch, prompts, generate keywords): every engine mode."""
    prompts, shared = _prompts()
    m = {
        "oneshot": (ARCH, prompts, dict(gen_lens=GEN_LENS, decode_chunk=2)),
        "chunked": (ARCH, prompts, dict(
            prefill_chunk=3, prompt_lens=[8, 3, 5, 8, 2, 7, 6, 8, 4, 1])),
        "paged": (ARCH, prompts, dict(prefill_chunk=4, page_size=4)),
        "prefix": (ARCH, shared, dict(prefill_chunk=4, page_size=4,
                                      prefix_cache=True)),
        "spec": (ARCH, prompts, dict(spec_k=2)),
        "faults": (ARCH, prompts, dict(slot_failures={3: [1], 6: [0, 2]},
                                       cancels={2: [7], 5: [1]})),
        "prefix_faults": (ARCH, shared, dict(
            prefill_chunk=4, page_size=4, prefix_cache=True,
            slot_failures={4: [1, 3]}, cancels={3: [6]})),
        "sjf": (ARCH, prompts, dict(admission="sjf", sjf_aging=2,
                                    gen_lens=GEN_LENS)),
        "vmapped": (ARCH, prompts, dict(decode_path="vmapped")),
        # a wave that ``data`` does not divide: slots replicated over it
        "odd_wave": (ARCH, prompts, dict(wave=3, prefill_chunk=4)),
        # the recurrent slot state on ``data``: 6 requests, 4 new tokens
        "rwkv_oneshot": (RWKV, prompts[:6], dict()),
        "rwkv_chunked": (RWKV, prompts[:6], dict(prefill_chunk=4)),
    }
    return {k: {"arch": a, "prompts": p, "N": 4 if a == RWKV else N,
                "kw": {"wave": 4, **kw}}
            for k, (a, p, kw) in m.items()}


MODES = tuple(modes())


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _start(helper, job, tmp_path, env_extra):
    """Start ``helper IN OUT`` on the job; (process, output path)."""
    inp, out = tmp_path / "job.pkl", tmp_path / "out.pkl"
    with open(inp, "wb") as f:
        pickle.dump(job, f)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(REPO, "src"), os.path.join(REPO, "tests"),
         env.get("PYTHONPATH", "")])
    env.update(env_extra)
    proc = subprocess.Popen([sys.executable, helper, str(inp), str(out)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env, cwd=REPO)
    return proc, out


def _finish(started, timeout):
    proc, out = started
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    assert proc.returncode == 0, f"stdout:\n{stdout}\nstderr:\n{stderr}"
    with open(out, "rb") as f:
        return pickle.load(f)


def _draft_cfgs():
    import dataclasses
    jd = dataclasses.replace(SMOKE[ARCH], name="mesh-draft", n_layers=1)
    td = dataclasses.replace(tarchs.SMOKE[ARCH], name="mesh-draft",
                             n_layers=1)
    return jd, td


RL_BATCH, RL_ITERS = 9, 2               # 9 prompts x 4 rollouts = 36 rows


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """Every world of the file, started at once (each a subprocess with
    its own timeout): the 4-rank mesh run with the port's world of one,
    the JAX engine's mesh run, and ``sharded_exec``'s gen | rest plan on
    8 ranks with 36 GEN rows (waves of 32 and 4: genserve on the DP 2 /
    TP 2 GEN mesh), greedy, with one-shot and chunked admission and with
    speculative decoding, from the seeded weights, with the same folded
    onto one device; and the JAX params the references share."""
    jparams = {a: JT.init_params(jax.random.PRNGKey(2), SMOKE[a])
               for a in (ARCH, RWKV)}
    jd, td = _draft_cfgs()
    jdraft = JT.init_params(jax.random.PRNGKey(5), jd)
    ms = modes()
    job = {"kind": "genserve", "world": 4, "timeout": 240,
           "cfgs": {a: tarchs.SMOKE[a] for a in (ARCH, RWKV)},
           "params": {a: _np_tree(p) for a, p in jparams.items()},
           "draft": _np_tree(jdraft), "draft_cfg": td, "modes": ms}
    ranks = _start(HELPER, job, tmp_path_factory.mktemp("mesh_serve"),
                   {"REPRO_OBS_STRICT": "1"})
    jjob = {"arch": ARCH, "params": _np_tree(jparams[ARCH]),
            "modes": {k: ms[k] for k in ("chunked", "prefix")}}
    jmesh = _start(os.path.join(REPO, "tests", "jax_mesh_serve.py"), jjob,
                   tmp_path_factory.mktemp("jax_mesh"),
                   {"XLA_FLAGS": "--xla_force_host_platform_device_count=4",
                    "JAX_PLATFORMS": "cpu"})
    rjob = {"kind": "gen_rl", "world": 8, "timeout": 300,
            "cfg": sharded_exec.tiny_cfg(), "iters": RL_ITERS,
            "batch": RL_BATCH, "n_rollouts": 4, "state": None,
            "variants": {"greedy": {"greedy": True},
                         "chunked": {"greedy": True, "prefill_chunk": 4},
                         "spec": {"greedy": True, "spec_k": 2}}}
    rl = _start(HELPER, rjob, tmp_path_factory.mktemp("gen_rl"), {})
    yield {"ranks": ranks, "jmesh": jmesh, "rl": rl, "jparams": jparams,
           "jdraft": (jd, jdraft), "modes": ms}
    for proc, _ in (ranks, jmesh, rl):
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.fixture(scope="module")
def served(started):
    """The mesh runs, and the JAX engine on one device (computed here
    while the worlds run), on the same weights and traffic."""
    jparams, (jd, jdraft), ms = (started["jparams"], started["jdraft"],
                                 started["modes"])
    ref = {}
    for name, m in ms.items():
        kw = dict(m["kw"])
        if kw.get("spec_k"):
            kw.update(draft_params=jdraft, draft_cfg=jd)
        ro, st = jadapter.generate(
            jparams[m["arch"]], SMOKE[m["arch"]], jnp.asarray(m["prompts"]),
            jax.random.PRNGKey(1),
            JSampler(max_new_tokens=m["N"], greedy=True),
            fast_path=False, **kw)
        ref[name] = ({k: np.asarray(v) for k, v in ro.items()},
                     {k: st[k] for k in STATS if k in st})
    res = _finish(started["ranks"], 400)
    return res["ranks"], res["world1"], ref, _finish(started["jmesh"], 400)


def _same_rollout(got, want, lp=True):
    for k in ("gen_tokens", "mask", "sequences"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if lp:
        np.testing.assert_allclose(got["logprobs"], want["logprobs"], **TOL)


@pytest.mark.parametrize("mode", MODES)
def test_mesh_matches_world_of_one(served, mode):
    """Every rank's rollout and statistics are the world of one's."""
    ranks, one, _, _ = served
    for r in ranks:
        got, want = r[mode], one[mode]
        _same_rollout(got["rollout"], want["rollout"])
        for k in STATS:
            assert got["stats"].get(k) == want["stats"].get(k), (mode, k)
    assert ranks[0][mode]["rollout"]["mask"].sum() > 0


@pytest.mark.parametrize("mode", MODES)
def test_mesh_matches_jax_engine(served, mode):
    ranks, _, ref, _ = served
    got, (want, wstats) = ranks[0][mode], ref[mode]
    _same_rollout(got["rollout"], want)
    for k, v in wstats.items():
        g = got["stats"][k]
        if isinstance(v, float):
            assert g == pytest.approx(v, rel=1e-12), (mode, k)
        else:
            assert list(np.asarray(g).reshape(-1)) == \
                list(np.asarray(v).reshape(-1)), (mode, k)


def test_modes_exercise_their_paths(served):
    """The traffic reaches what each mode is about: recycling, prefix
    hits, speculation, requeues and cancels."""
    ranks, _, _, _ = served
    s = {m: ranks[0][m]["stats"] for m in MODES}
    assert s["oneshot"]["prefills"] > 1 and s["oneshot"]["admitted"] == B
    assert s["chunked"]["prefill_rounds"] > 0
    assert s["prefix"]["prefix_hit_rate"] > 0
    assert s["spec"]["spec_proposed"] > 0
    assert s["faults"]["requeued"] > 0 and s["faults"]["cancelled"] == 2
    assert s["prefix_faults"]["requeued"] > 0
    assert s["prefix_faults"]["prefix_hit_rate"] > 0
    assert s["rwkv_chunked"]["prefill_rounds"] > 0


@pytest.mark.parametrize("mode", ["prefix", "prefix_faults"])
def test_no_leaked_pages(served, mode):
    """The radix cache's page pool: under ``REPRO_OBS_STRICT=1`` a leak
    raises on the rank; none reports one either (slot failures and
    cancels decref their pages)."""
    ranks, one, _, _ = served
    assert one[mode]["leaked"] == []
    for r in ranks:
        assert r[mode]["leaked"] == []


@pytest.mark.parametrize("mode", MODES)
def test_caches_stay_sharded(served, mode):
    """After serving, each cache leaf is a DTensor in its declared
    layout: contiguous k/v slots over ``data`` and kv heads over
    ``model``, page pools whole over ``data`` and heads over ``model``,
    recurrent state slots over ``data`` (slots replicated where the wave
    does not divide ``data``, as ``sh.kernel_specs`` replicates the
    rows); and no all-gather of the run took a cache shard (a gather of
    the cache would)."""
    ranks, _, _, _ = served
    kw = modes()[mode]["kw"]
    paged = "page_size" in kw
    slots = "Shard(dim=1)" if kw["wave"] % 2 == 0 else "Replicate()"
    for r in ranks:
        rec = r[mode]
        assert rec["placements"], mode
        for path, (is_d, pl) in rec["placements"].items():
            assert is_d, path
            leaf = path.rsplit("/", 1)[1]
            if leaf in ("k", "v"):
                want = "(Replicate(), Shard(dim=3))" if paged \
                    and path.startswith("cache/") \
                    else f"({slots}, Shard(dim=3))"
            else:
                want = f"({slots}, Replicate())"
            assert pl == want, (path, pl)
        assert rec["cache_gathered"] == [], rec["cache_gathered"]
        assert rec["n_gathers"] > 0


@pytest.mark.parametrize("mode", ["chunked", "prefix"])
def test_jax_mesh_engine_agrees(served, mode):
    """The JAX engine's ``generate(mesh=)`` on 4 forced host devices
    gives the port's mesh tokens."""
    ranks, _, _, jmesh = served
    for k in ("gen_tokens", "mask"):
        np.testing.assert_array_equal(ranks[0][mode]["rollout"][k],
                                      jmesh[mode][k])


# ---------------------------------------------------------------------------
# The RL engine: sharded GEN beyond one decode wave, evaluate on ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rl_world(started):
    res = _finish(started["rl"], 500)
    return res["ranks"], res["world1"]


@pytest.mark.parametrize("variant", ["greedy", "chunked", "spec"])
def test_sharded_gen_beyond_one_wave(rl_world, variant):
    """GEN's 36 rows run on genserve (wave 32) on the GEN mesh, with
    one-shot and chunked admission and speculative decoding (the draft
    built alike on every GEN rank); every assertion of the example
    holds against the world of one, greedy tokens identical in every
    iteration."""
    ranks, one = rl_world
    s = ranks[0][variant]
    sharded_exec.check(s, one[variant], greedy=True)
    assert s["gen_wave"][1:] == [32.0] * (RL_ITERS - 1)
    assert s["gen_decode_steps"] == one[variant]["gen_decode_steps"]
    if variant == "chunked":
        assert all(x > 0 for x in s["gen_prefill_rounds"][1:])
    for r in ranks[1:4]:
        for a, b in zip(r[variant]["tokens"], s["tokens"]):
            np.testing.assert_array_equal(a, b)


def test_evaluate_on_ranks(rl_world):
    """``RLTrainer.evaluate``: the GEN ranks decode on their mesh and
    every rank gets the GEN lead's score, the world of one's."""
    ranks, one = rl_world
    for variant in ("greedy", "chunked", "spec"):
        want = one[variant]["eval"]
        assert 0.0 <= want <= 1.0
        assert all(r[variant]["eval"] == want for r in ranks)
