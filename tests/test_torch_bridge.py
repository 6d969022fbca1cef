"""Port hygiene and the weight bridge: JAX params -> repro_torch -> JAX is
bit-exact; the port imports no JAX and nothing of ``repro``; importing the
kernel build module needs no ``nvcc``."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.archs import (JAMBA_1_5_LARGE, QWEN3_0_6B, RWKV6_3B,  # noqa: E402
                                 SMOKE)
from repro.models import transformer as JT  # noqa: E402
from repro.models.config import reduced  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import archs as tarchs  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


@pytest.mark.parametrize("name", ["qwen3-smoke", "gemma2-smoke",
                                  "qwen3-reduced-bf16", "rwkv6-smoke",
                                  "rwkv6-reduced-bf16", "jamba-smoke",
                                  "jamba-3layer-bf16", "mixtral-smoke",
                                  "granite-moe-smoke"])
def test_round_trip_bit_exact(name):
    cfg = {"qwen3-smoke": SMOKE["qwen3-0.6b"],
           "gemma2-smoke": SMOKE["gemma2-27b"],
           "qwen3-reduced-bf16": dataclasses.replace(
               reduced(QWEN3_0_6B), dtype="bfloat16"),
           "rwkv6-smoke": SMOKE["rwkv6-3b"],
           "rwkv6-reduced-bf16": dataclasses.replace(
               reduced(RWKV6_3B), dtype="bfloat16"),
           "jamba-smoke": SMOKE["jamba-1.5-large-398b"],
           "jamba-3layer-bf16": dataclasses.replace(
               reduced(JAMBA_1_5_LARGE, n_layers=3), dtype="bfloat16"),
           "mixtral-smoke": SMOKE["mixtral-8x7b"],
           "granite-moe-smoke": SMOKE["granite-moe-3b-a800m"]}[name]
    params = JT.init_params(jax.random.PRNGKey(3), cfg)
    tree = jax.tree_util.tree_map(np.asarray, params)
    tp = bridge.from_numpy_params(tree, cfg, "cpu")
    back = bridge.to_numpy_params(tp)
    src = dict(_leaves(tree))
    dst = dict(_leaves(back))
    assert src.keys() == dst.keys()
    for path, a in src.items():
        b = dst[path]
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), path
    # the stacked [R, ...] block layout is kept
    R = cfg.n_pattern_repeats
    assert all(t.shape[0] == R for p, t in _leaves(tp) if p[0] == "blocks")
    if cfg.dtype == "bfloat16":
        assert tp["embed"]["tokens"].dtype == torch.bfloat16
        assert back["embed"]["tokens"].dtype.name == "bfloat16"
    if cfg.has_moe:    # the expert leaves keep [R, E, ...]
        moe = next(l["moe"] for l in tp["blocks"].values() if "moe" in l)
        assert tuple(moe["experts"]["w_down"].shape) == (
            R, cfg.n_experts, cfg.d_ff, cfg.d_model)
    if cfg.has_rwkv:   # the token-shift mixes and the bonus keep [R, ...]
        rw = tp["blocks"]["layer0"]["rwkv"]
        assert tuple(rw["mu"].shape) == (R, 5, cfg.d_model)
        assert tuple(rw["bonus_u"].shape) == (R, cfg.rwkv_n_heads,
                                              cfg.rwkv_head_dim)


def _state_tree(alg, moment_dtype, gen_is_actor):
    """A reference trainer's ``state_tree()`` shape after one Adam step
    (non-zero moments), built from the JAX package's own functions."""
    from repro.optim import adam as jadam
    from repro.rl import rewards as jrewards
    cfg = dataclasses.replace(SMOKE["qwen3-0.6b"], vocab_size=16,
                              dtype="float32")
    ks = jax.random.split(jax.random.PRNGKey(5), 4)
    ocfg = jadam.AdamConfig(lr=1e-2, moment_dtype=moment_dtype)

    @jax.jit
    def stepped(params, key):
        grads = jax.tree_util.tree_map(
            lambda p: jax.random.normal(key, p.shape, p.dtype), params)
        return jadam.adam_update(params, grads,
                                 jadam.init_adam_state(params, ocfg), ocfg)
    actor0 = JT.init_params(ks[0], cfg)
    actor, actor_opt, _ = stepped(actor0, ks[1])
    tree = {"actor": actor, "ref": actor0, "actor_opt": actor_opt,
            "gen_params": actor if gen_is_actor else actor0,
            "weight_version": jax.numpy.asarray(3, jax.numpy.int32)}
    if alg == "ppo":
        cp = (JT.init_params(ks[2], cfg), jrewards.init_value_head(ks[3],
                                                                   cfg))
        (tree["critic"], tree["value_head"]), tree["critic_opt"], _ = \
            stepped(cp, ks[3])
    return cfg, jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("alg,moment_dtype,gen_is_actor", [
    ("grpo", "float32", True), ("grpo", "bfloat16", False),
    ("ppo", "float32", False), ("ppo", "bfloat16", True)])
def test_state_tree_round_trip_bit_exact(alg, moment_dtype, gen_is_actor):
    """The RL trainer's whole state: actor, ref and generation params,
    Adam's step and moments (bf16 included), PPO's critic, value head and
    tuple-shaped critic moments, the weight version."""
    from repro_torch.configs.archs import SMOKE as TSMOKE
    from repro_torch.data.synthetic import AdditionTask
    from repro_torch.rl.trainer import RLConfig, RLTrainer
    cfg, tree = _state_tree(alg, moment_dtype, gen_is_actor)
    tcfg = dataclasses.replace(TSMOKE["qwen3-0.6b"], vocab_size=16,
                               dtype="float32")
    ts = bridge.from_numpy_state_tree(tree, tcfg, "cpu")
    assert (ts["gen_params"] is ts["actor"]) == gen_is_actor
    trainer = RLTrainer(tcfg, RLConfig(algorithm=alg), AdditionTask(9),
                        device="cpu")
    trainer.load_state_tree(ts)
    assert trainer.weight_version == 3
    back = bridge.to_numpy_state_tree(trainer.state_tree())
    src = jax.tree_util.tree_leaves_with_path(tree)
    dst = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in src] == [p for p, _ in dst]
    for (path, a), (_, b) in zip(src, dst):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path
    if alg == "ppo":
        assert isinstance(back["critic_opt"]["m"], tuple)
        assert set(back["value_head"]) == {"w"}
    if moment_dtype == "bfloat16":
        assert ts["actor_opt"]["m"]["embed"]["tokens"].dtype == torch.bfloat16


def test_bridge_rejects_unstacked_blocks():
    cfg = SMOKE["qwen3-0.6b"]
    tree = jax.tree_util.tree_map(
        np.asarray, JT.init_params(jax.random.PRNGKey(0), cfg))
    tree["blocks"]["layer0"]["norm1"]["scale"] = np.ones((7, cfg.d_model))
    with pytest.raises(ValueError, match="repeats"):
        bridge.from_numpy_params(tree, cfg, "cpu")


def test_configs_copy_matches_reference():
    from repro.configs import archs as jarchs
    assert set(tarchs.ARCHS) == set(jarchs.ARCHS)
    for name in jarchs.ARCHS:
        for smoke in (False, True):
            a = dataclasses.asdict(jarchs.get(name, smoke=smoke))
            b = dataclasses.asdict(tarchs.get(name, smoke=smoke))
            assert repr(a) == repr(b), name


def _run(code, env=None):
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": str(SRC),
                               **(env or {})})


def test_port_imports_no_jax_and_no_repro():
    """Nor msgpack: the port writes the checkpoint format with its own
    codec.  The walk covers genserve's copies of the framework-free
    scheduler and page pool."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,"
        " 'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' "
        "or k.startswith('jax.') or k == 'repro' or k.startswith('repro.') "
        "or k == 'msgpack' or k.startswith('msgpack.'))\n"
        "new = [m for m in ('repro_torch.genserve.pagepool', "
        "'repro_torch.genserve.scheduler', 'repro_torch.genserve.decoder') "
        "if m not in mods]\n"
        "print(len(mods), bad, new)\n")
    r = _run(code)
    assert r.returncode == 0, r.stderr
    n, rest = r.stdout.split(" ", 1)
    assert int(n) >= 20 and rest.strip() == "[] []", r.stdout


def test_kernel_build_module_needs_no_nvcc(tmp_path):
    """Importing the build module, the kernel wrappers and the model compiles
    nothing and looks for no compiler (PATH and CUDA_HOME hold none)."""
    code = ("import subprocess\n"
            "subprocess.Popen = None   # any compiler launch would fail\n"
            "import repro_torch.kernels.build as b, "
            "repro_torch.kernels.ops, repro_torch.models.attention\n"
            "assert not b._LIBS\n"
            "print('imported')\n")
    r = _run(code, env={"PATH": str(tmp_path), "CUDA_HOME": str(tmp_path)})
    assert r.returncode == 0, r.stderr
    assert "imported" in r.stdout
