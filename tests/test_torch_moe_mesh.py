"""MoE models and attention heads that the ``model`` axis does not
divide, on a mesh of ranks: ``genserve.generate(mesh=)`` on 4 gloo ranks
(a 2x2 ("data", "model") mesh) against the port's world of one and the
JAX engine's ``generate(mesh=)`` on 4 forced host devices, on the JAX
package's weights; and ``launch.steps``' LM train step on DTensors over
the same ranks against the world of one.

The configs: the mixtral-8x7b, jamba-1.5-large-398b and
granite-moe-3b-a800m smokes (4 experts top-2: tensor parallel on the
experts' FFN dimension), granite's with 16 experts (expert parallel:
experts over ``model``), and qwen3-0.6b's with 3 query heads over 1 KV
head (``model`` 2 divides neither).  Greedy decoding, one-shot and
chunked admission, the default ``capacity_factor``: tokens and masks
identical, log-probs within 2e-4 (fp32).  The kernel wrappers run per
rank on local shards: on the CPU their plain versions, whose operand
shapes the ranks record.  The train step (remat, fp32 Adam) is held as
``test_torch_sharded.py`` holds the sharded actor step: the loss within
1e-5 relative, Adam's first moments within 1e-5 relative plus 1e-5 of
each leaf's scale, and the stepped parameters within 1e-5 relative
where the gradient stands above the fp32 noise of the partial sums,
within 2 lr + 2e-6 below it (Adam's first step divides g by |g|).

The ranks and the JAX mesh engine run in subprocesses with timeouts of
their own (``tests/torch_sharded_ranks.py``, ``tests/jax_mesh_serve.py``),
started together.
"""
import dataclasses
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.archs import SMOKE  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import archs as tarchs  # noqa: E402
from repro_torch.optim import adam  # noqa: E402

from test_torch_sharded import HELPER, REPO  # noqa: E402
from test_torch_sharded_genserve import _finish, _np_tree, _start  # noqa

# name -> (smoke arch, overrides of its config)
VARIANTS = {
    "mixtral": ("mixtral-8x7b", {}),
    "jamba": ("jamba-1.5-large-398b", {}),
    "granite": ("granite-moe-3b-a800m", {}),
    "granite_ep16": ("granite-moe-3b-a800m", {"n_experts": 16}),
    "qwen3_3to1": ("qwen3-0.6b", {"n_heads": 3, "n_kv_heads": 1}),
    "qwen3_8to2": ("qwen3-0.6b", {"n_heads": 8, "n_kv_heads": 2}),
}
# the configs served on a 1x4 mesh (``model`` 4 divides the query heads
# but not the KV heads, as phi3-medium-14b's 40:10 over 16); the rest 2x2
MESH_SHAPES = {"qwen3_8to2": (1, 4)}
TRAIN = ("mixtral", "qwen3_3to1")
B, P, N = 8, 8, 4
TOL = dict(rtol=2e-4, atol=2e-4)
MODES = {"oneshot": {"wave": 4}, "chunked": {"wave": 4, "prefill_chunk": 4}}
CASES = [(n, m) for n in VARIANTS for m in MODES]


def jax_cfg(name):
    arch, ov = VARIANTS[name]
    return dataclasses.replace(SMOKE[arch], **ov)


def torch_cfg(name):
    arch, ov = VARIANTS[name]
    return dataclasses.replace(tarchs.SMOKE[arch], **ov)


def _modes(name, prompts):
    return {f"{name}/{m}": {"arch": name, "prompts": prompts, "N": N,
                            "kw": kw} for m, kw in MODES.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 4-rank run with its world of one, and the JAX mesh engine's."""
    prompts = np.random.default_rng(0).integers(0, 512, (B, P))
    params = {n: _np_tree(JT.init_params(jax.random.PRNGKey(2),
                                         jax_cfg(n))) for n in VARIANTS}
    rng = np.random.default_rng(1)
    mask = np.ones((4, 16), np.float32)
    mask[:, :3] = 0.0
    modes = {}
    for n in VARIANTS:
        modes.update(_modes(n, prompts))
    job = {"kind": "moe_mesh", "world": 4, "timeout": 300,
           "mesh_shapes": MESH_SHAPES,
           "cfgs": {n: torch_cfg(n) for n in VARIANTS}, "params": params,
           "modes": modes, "train": TRAIN,
           "train_batch": {"tokens": rng.integers(0, 512, (4, 16)),
                           "labels": rng.integers(0, 512, (4, 16)),
                           "loss_mask": mask}}
    ranks = _start(HELPER, job, tmp_path_factory.mktemp("moe_mesh"), {})
    jjob = {"runs": {n: {"arch": VARIANTS[n][0],
                         "overrides": VARIANTS[n][1], "params": params[n],
                         "mesh_shape": MESH_SHAPES.get(n, (2, 2)),
                         "modes": _modes(n, prompts)} for n in VARIANTS}}
    jmesh = _start(os.path.join(REPO, "tests", "jax_mesh_serve.py"), jjob,
                   tmp_path_factory.mktemp("jax_moe_mesh"),
                   {"XLA_FLAGS": "--xla_force_host_platform_device_count=4",
                    "JAX_PLATFORMS": "cpu"})
    try:
        res = _finish(ranks, 400)
        yield res["ranks"], res["world1"], _finish(jmesh, 400), params
    finally:
        for proc, _ in (ranks, jmesh):
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


@pytest.mark.parametrize("name,mode", CASES)
def test_mesh_serves_as_the_world_of_one(runs, name, mode):
    ranks, one, _, _ = runs
    key = f"{name}/{mode}"
    want = one["served"][key]["rollout"]
    assert want["mask"].sum() > 0
    for r in ranks:
        got = r["served"][key]["rollout"]
        for k in ("gen_tokens", "mask", "sequences"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_allclose(got["logprobs"], want["logprobs"], **TOL)
        assert r["served"][key]["stats"]["decode_steps"] == \
            one["served"][key]["stats"]["decode_steps"]


@pytest.mark.parametrize("name,mode", CASES)
def test_mesh_serves_as_the_jax_mesh_engine(runs, name, mode):
    ranks, _, jmesh, _ = runs
    got = ranks[0]["served"][f"{name}/{mode}"]["rollout"]
    want = jmesh[name][f"{name}/{mode}"]
    for k in ("gen_tokens", "mask"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_kernels_run_per_rank_on_local_shards(runs):
    """Each rank's kernel calls take its own shard.  On the 2x2 mesh:
    heads that ``model`` divides split over it (the smokes' 4:2 heads, 2
    query heads a rank), the 3:1 heads whole with their rows split over
    ``model`` as well (one row of each 4-row admission batch a rank),
    Jamba's Mamba channels split over ``model`` (256 of 512 a rank).  On
    the 1x4 mesh the 8:2 heads whole (``model`` 4 divides the 8 query
    heads but not the 2 KV heads) and the rows split 4 ways.  In the
    world of one, every call whole."""
    ranks, one, _, _ = runs
    for r in ranks:
        k22, k14 = r["kernels"]["(2, 2)"], r["kernels"]["(1, 4)"]
        flash, dec = k22["flash_attention"], k22["decode_attention"]
        assert {s[2] for s in flash} == {2, 3}, set(flash)
        assert {s[1] for s in dec} == {2, 3}, set(dec)
        assert {s[0] for s in flash if s[2] == 3} == {1}
        assert {s[2] for s in k22["mamba_scan"]} == {256}
        assert {s[2] for s in k14["flash_attention"]} == {8}
        assert {s[0] for s in k14["flash_attention"]} == {1}
        assert {s[1] for s in k14["decode_attention"]} == {8}
    whole = one["kernels"]["(2, 2)"]
    assert {s[2] for s in whole["flash_attention"]} == {3, 4}
    assert {s[2] for s in whole["mamba_scan"]} == {512}


@pytest.mark.parametrize("name", TRAIN)
def test_train_step_on_ranks_matches_the_world_of_one(runs, name):
    ranks, one, _, _ = runs
    want, cfg = one["train"][name], adam.AdamConfig()
    leaves = jax.tree_util.tree_leaves
    for r in ranks:
        got = r["train"][name]
        assert np.isfinite(got["loss"])
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        trees = [leaves(t[k]) for t in (got, want) for k in ("params", "m")]
        assert len({len(t) for t in trees}) == 1 and trees[0]
        for p, m, p1, m1 in zip(*trees):
            assert p.shape == p1.shape and m.shape == m1.shape
            scale = float(np.abs(m1).max(initial=0.0))
            assert scale > 0.0
            np.testing.assert_allclose(m, m1, rtol=1e-5, atol=1e-5 * scale)
            # Adam's first step moves a parameter by lr * g / |g|
            firm = np.abs(m1) >= max(1e-4 * scale,
                                     1e-6 * (1 - cfg.beta1))
            np.testing.assert_allclose(p[firm], p1[firm], rtol=1e-5,
                                       atol=1e-7)
            np.testing.assert_allclose(p, p1, rtol=0,
                                       atol=2 * cfg.lr + 2e-6)
