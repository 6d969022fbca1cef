"""The port's dry-run counts (``repro_torch.launch.{op_analysis, dryrun,
roofline, reanalyze, op_profile}``, ``configs.shapes.input_specs``,
``launch.{mesh, steps}``'s sharding trees) against the JAX package's.

Per-device FLOPs of the smoke configs' train, prefill and decode steps
within 10% of ``hlo_analysis.analyze`` on the reference's jitted step
(the JAX package's own CPU lowering); on fake meshes, data-parallel
counts divide by the data size; records, roofline terms and input specs
as the reference's.  Everything runs on fake tensors: no device, and no
process group survives a test."""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro.configs import archs as jarchs  # noqa: E402
from repro.configs.shapes import SHAPES as JSHAPES  # noqa: E402
from repro.configs.shapes import input_specs as j_input_specs  # noqa: E402
from repro.launch import hlo_analysis, steps as jsteps  # noqa: E402
from repro.models import cache as jcache, transformer as JT  # noqa: E402
from repro.optim import adam as jadam  # noqa: E402
from repro_torch.configs import archs  # noqa: E402
from repro_torch.configs.shapes import (SHAPES, InputShape,  # noqa: E402
                                        input_specs, skip_reason)
from repro_torch.launch import dryrun, op_profile, reanalyze  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import fake_world, production_world  # noqa
from repro_torch.launch.roofline import roofline_terms  # noqa: E402

B, S = 2, 64
ARCHS = ["qwen3-0.6b", "rwkv6-3b", "jamba-1.5-large-398b"]
PHASES = ["prefill", "decode", "train"]
_MATMUL = {"mm", "bmm", "addmm", "baddbmm", "convolution"}


def _reference_flops(name: str, phase: str) -> float:
    """``hlo_analysis`` on the reference's jitted smoke step at [B, S]
    (decode: one token against an S-position cache), as
    ``tests/test_launch.py`` builds it."""
    cfg = jarchs.get(name, smoke=True)
    params = jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(0),
                                                   cfg))
    sds = jax.ShapeDtypeStruct
    if phase == "train":
        oc = jadam.AdamConfig()
        opt = jax.eval_shape(lambda: jadam.init_adam_state(params, oc))
        batch = {"tokens": sds((B, S), jnp.int32),
                 "labels": sds((B, S), jnp.int32),
                 "loss_mask": sds((B, S), jnp.bfloat16)}
        step, args = jsteps.make_train_step(cfg, oc), (params, opt, batch)
    elif phase == "prefill":
        step = jsteps.make_prefill_step(cfg, max_cache_len=S)
        args = (params, {"tokens": sds((B, S), jnp.int32)})
    else:
        cache = jax.eval_shape(lambda: jcache.init_cache(
            cfg, B, S, dtype=jnp.bfloat16))
        step = jsteps.make_serve_step(cfg)
        args = (params, {"tokens": sds((B, 1), jnp.int32), "cache": cache})
    hlo = jax.jit(step).lower(*args).compile().as_text()
    return hlo_analysis.analyze(hlo).flops


@pytest.mark.parametrize("phase", PHASES)
@pytest.mark.parametrize("name", ARCHS)
def test_flops_per_device_within_ten_percent_of_the_reference(name, phase):
    rec = dryrun.count_step(archs.get(name, smoke=True),
                            InputShape("smoke", S, B, phase))
    want = _reference_flops(name, phase)
    got = rec["flops_per_device"]
    dots = sum(r[0] for (op, _), r in rec["_rows"].items() if op in _MATMUL)
    assert abs(got - want) <= 0.10 * want, (
        f"{name} {phase}: port {got:.4e} (dot {dots:.4e}, elementwise "
        f"{got - dots:.4e}) vs reference {want:.4e}")
    assert rec["n_devices"] == 1
    assert rec["counted_by"] == "torch dispatch"
    assert rec["attention"] == "plain"
    assert sum(rec["collective_bytes_per_device"].values()) == 0.0


def test_depth_extrapolation_equals_the_direct_count():
    """Counting one and two repeats and extrapolating gives the count of
    the whole depth (every repeat does the same work)."""
    cfg = dataclasses.replace(archs.get("qwen3-0.6b", smoke=True),
                              n_layers=5)
    shape = InputShape("smoke", 4, 2, "train")
    got = dryrun.count_step(cfg, shape)
    assert cfg.n_pattern_repeats == 5
    direct = dryrun._count_once(cfg, shape, None)
    for k in ("flops_per_device", "bytes_per_device",
              "argument_size_in_bytes", "output_size_in_bytes"):
        assert got[k] == pytest.approx(direct[k], rel=1e-12), k


def _data_parallel_step(cfg, shape, mesh, batch_dims):
    """``shape``'s step with every parameter replicated and the batch
    split over the mesh dimensions ``batch_dims``: pure data
    parallelism over them."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard
    fake_mode = FakeTensorMode(allow_non_fake_inputs=True)
    step, (params, batch) = dryrun.build_step(cfg, shape, fake_mode)
    rep = (Replicate(),) * mesh.ndim
    split = tuple(Shard(0) if i in batch_dims else Replicate()
                  for i in range(mesh.ndim))
    with fake_mode:
        params = steps.distribute_tree(
            params, mesh, dryrun.sh.map_with_path(lambda p, x: rep, params))
        batch = steps.distribute_tree(
            batch, mesh, dryrun.sh.map_with_path(lambda p, x: split, batch))
    with fake_mode, dryrun.plain_path():
        from torch.distributed.tensor.experimental import \
            implicit_replication
        with implicit_replication():
            _, cost = dryrun.op_analysis.analyze(step, params, batch)
    return cost


def _tp16():
    """qwen3-0.6b's smoke config with heads that divide a ``model`` axis
    of 16 (DTensor splits heads evenly only): 16 query and 8 kv heads of
    16 (d_model 256)."""
    return dataclasses.replace(archs.get("qwen3-0.6b", smoke=True),
                               n_heads=16, n_kv_heads=8, head_dim=16)


@pytest.mark.parametrize("where", ["fake_2x2", "production"])
def test_data_parallel_counts_divide_by_the_data_size(where):
    """Pure data parallelism on the mesh's ``data`` axis (its 1-D
    sub-mesh): the parameters replicated, the batch split over it.  (On
    the whole mesh DTensor may shard a replicated weight over the free
    ``model`` axis, which is no longer pure data parallelism.)"""
    cfg = archs.get("qwen3-0.6b", smoke=True)
    shape = InputShape("smoke", 16, 32, "prefill")
    whole = dryrun.count_step(cfg, shape)["flops_per_device"]
    ctx, n_data = ((production_world(), 16) if where == "production"
                   else (fake_world(4), 2))
    with ctx as mesh:
        if mesh is None:
            from torch.distributed.device_mesh import init_device_mesh
            mesh = init_device_mesh("cpu", (2, 2),
                                    mesh_dim_names=("data", "model"))
        data = mesh["data"]
        assert data.size() == n_data and data.mesh.numel() == n_data
        cost = _data_parallel_step(cfg, shape, data, (0,))
    assert cost.flops == pytest.approx(whole / n_data, rel=0.01)
    assert not dist.is_initialized()


def test_counts_come_from_the_local_shards():
    """A product on the production mesh counts each device's share: the
    whole product replicated, a sixteenth with its rows over ``data``,
    a 256th with its columns over ``model`` too (a mode entered outside
    DTensor would count the global product each time)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    M, K, N = 4096, 1024, 4096
    with production_world() as mesh, FakeTensorMode():
        a, b = torch.empty(M, K), torch.empty(K, N)
        R, mk, kn, mn = Replicate(), M * K, K * N, M * N
        for pa, pb, share, elems in (
                ((R, R), (R, R), 1, mk + kn + mn),
                ((Shard(0), R), (R, R), 16, mk / 16 + kn + mn / 16),
                ((Shard(0), R), (R, Shard(1)), 256,
                 mk / 16 + kn / 16 + mn / 256)):
            A = distribute_tensor(a, mesh, pa, src_data_rank=None)
            Bm = distribute_tensor(b, mesh, pb, src_data_rank=None)
            _, cost = dryrun.op_analysis.analyze(lambda: A @ Bm)
            assert cost.flops == 2 * M * K * N / share
            assert cost.bytes == 4 * elems


@pytest.fixture
def mesh_2x2():
    from torch.distributed.device_mesh import init_device_mesh
    with fake_world(4):
        yield init_device_mesh("cpu", (2, 2),
                               mesh_dim_names=("data", "model"))
    assert not dist.is_initialized()


def test_train_step_on_a_mesh_moves_gathers_or_scatters(mesh_2x2):
    rec = dryrun.count_step(archs.get("qwen3-0.6b", smoke=True),
                            InputShape("smoke", 16, 4, "train"), mesh_2x2)
    coll = rec["collective_bytes_per_device"]
    assert rec["n_devices"] == 4
    assert coll["all-gather"] + coll["reduce-scatter"] > 0
    whole = dryrun.count_step(archs.get("qwen3-0.6b", smoke=True),
                              InputShape("smoke", 16, 4, "train"))
    assert rec["flops_per_device"] < whole["flops_per_device"]
    assert rec["argument_size_in_bytes"] < whole["argument_size_in_bytes"]


def test_long_decode_cache_shards_kv_over_model(mesh_2x2):
    from torch.distributed.tensor import Replicate, Shard
    cfg = archs.get("jamba-1.5-large-398b", smoke=True)
    for L, want in ((8192, (Shard(1), Replicate())),
                    (16384, (Shard(1), Shard(2)))):
        shape = InputShape("long", L, 4, "decode")
        pl = steps.batch_shardings(mesh_2x2, input_specs(cfg, shape), shape)
        layer = pl["cache"]["blocks"]["layer0"]
        assert layer["k"] == layer["v"] == want, L
        assert pl["cache"]["pos"] is None
        assert pl["tokens"] == (Shard(0), Replicate())
        mamba = pl["cache"]["blocks"]["layer1"]
        assert mamba["ssm"] == (Shard(1), Shard(2))
        assert mamba["conv"] == (Shard(1), Shard(3))
    rec = dryrun.count_step(_tp16(), InputShape("long", 16384, 4, "decode"),
                            mesh_2x2)
    assert rec["flops_per_device"] > 0


def test_dryrun_one_leaves_no_process_group_and_keeps_a_live_one():
    rec = dryrun.dryrun_one("qwen3-0.6b", "decode_32k", False, verbose=False)
    assert rec["n_devices"] == 256 and rec["phase"] == "decode"
    assert rec["flops_per_device"] > 0
    assert not dist.is_initialized()
    skip = dryrun.dryrun_one("hubert-xlarge", "decode_32k", False,
                             verbose=False)
    assert skip["skipped"] == skip_reason(archs.get("hubert-xlarge"),
                                          SHAPES["decode_32k"])
    with fake_world(256):
        dryrun.dryrun_one("qwen3-0.6b", "decode_32k", False, verbose=False)
        assert dist.is_initialized()
    assert not dist.is_initialized()


def test_two_pods_split_the_batch():
    """The multi-pod mesh replicates the parameters over ``pod`` and
    splits the batch: half the single pod's work per device."""
    cfg, shape = _tp16(), SHAPES["decode_32k"]
    counts = {}
    for multi_pod in (False, True):
        with production_world(multi_pod=multi_pod) as mesh:
            counts[multi_pod] = dryrun.count_step(cfg, shape, mesh)
        assert not dist.is_initialized()
    assert counts[True]["n_devices"] == 512
    assert counts[True]["flops_per_device"] == pytest.approx(
        counts[False]["flops_per_device"] / 2, rel=0.01)


def test_roofline_terms_on_the_reference_record():
    rec = {
        "n_devices": 256, "phase": "train", "seq_len": 4096,
        "global_batch": 256, "active_params": int(1e9),
        "flops_per_device": 1e13, "bytes_per_device": 1e11,
        "collective_bytes_per_device": {"all-reduce": 5e9},
    }
    t = roofline_terms(rec)
    assert t["dominant"] in ("compute", "memory", "collective")
    assert t["compute_s"] > 0 and t["memory_s"] > 0
    assert 0 < t["useful_ratio"] < 10
    assert t["compute_s"] == pytest.approx(1e13 / 989e12)
    assert t["memory_s"] == pytest.approx(1e11 / 3.35e12)
    fp32 = roofline_terms({**rec, "dtype": "f32"})
    assert fp32["compute_s"] == pytest.approx(1e13 / 67e12)


def test_reanalyze_rewrites_a_record(tmp_path, monkeypatch):
    def count(arch, shape_name, multi_pod, verbose=True):
        """``dryrun_one`` on the 16-head smoke config (seconds, not the
        full width's count)."""
        with production_world(multi_pod=multi_pod) as mesh:
            rec = dryrun.count_step(_tp16(), SHAPES[shape_name], mesh)
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                **rec}

    rec = dryrun.public(count("qwen3-0.6b", "decode_32k", False))
    stale = {**rec, "flops_per_device": 1.0, "bytes_per_device": 2.0,
             "collective_bytes_per_device": {"all-gather": 3.0}}
    path = dryrun.record_path(str(tmp_path), "qwen3-0.6b", "decode_32k",
                              False)
    with open(path, "w") as f:
        json.dump(stale, f)
    with open(tmp_path / "hubert-xlarge__decode_32k__single.json", "w") as f:
        json.dump({"arch": "hubert-xlarge", "skipped": "encoder-only"}, f)
    seen = []
    monkeypatch.setattr(dryrun, "dryrun_one", lambda a, s, m, verbose=True: (
        seen.append((a, s, m)) or count(a, s, m)))
    n = reanalyze.reanalyze(str(tmp_path))
    assert n == 1 and seen == [("qwen3-0.6b", "decode_32k", False)]
    with open(path) as f:
        new = json.load(f)
    assert new == rec


def test_op_profile_rows_sum_to_the_totals():
    rec = dryrun.count_step(archs.get("qwen3-0.6b", smoke=True),
                            InputShape("smoke", S, B, "prefill"))
    rows = op_profile.op_contributions(rec)
    assert sum(r[0] for r in rows) == pytest.approx(rec["flops_per_device"])
    assert sum(r[1] for r in rows) == pytest.approx(rec["bytes_per_device"])
    text = op_profile.render(rows, 3, "flops").splitlines()
    assert text[0].startswith("totals: flops=") and len(text) == 5
    assert text[2].split()[3] == "mm"


def test_input_specs_match_real_batches():
    """Shapes of every leaf as the reference's ``input_specs`` (token ids
    int64 where the reference's are int32), as ``tests/test_launch.py``
    checks the reference's."""
    cfg = archs.get("mixtral-8x7b")
    specs = input_specs(cfg, SHAPES["train_4k"])
    assert specs["tokens"].shape == (256, 4096)
    assert specs["labels"].shape == (256, 4096)
    dspecs = input_specs(cfg, SHAPES["decode_32k"])
    assert dspecs["tokens"].shape == (128, 1)
    kv = dspecs["cache"]["blocks"]["layer0"]["k"]
    assert kv.shape[2] == 4096          # SWA ring cache bounded by 4096
    long = input_specs(cfg, SHAPES["long_500k"])
    assert long["cache"]["blocks"]["layer0"]["k"].shape[2] == 4096
    to_torch = {"int32": torch.int64, "bfloat16": torch.bfloat16,
                "float32": torch.float32}
    for name in archs.ARCHS:
        for sname, shape in SHAPES.items():
            if skip_reason(archs.get(name), shape):
                continue
            got = input_specs(archs.get(name), shape)
            want = j_input_specs(jarchs.get(name), JSHAPES[sname])
            gl = [(p, x) for p, x in jax.tree_util.tree_leaves_with_path(
                got, is_leaf=lambda x: isinstance(x, torch.Tensor))
                if isinstance(x, torch.Tensor)]
            # the cache position: an int here, a scalar leaf there
            wl = {p: x for p, x in jax.tree_util.tree_leaves_with_path(want)
                  if jax.tree_util.keystr(p) != "['cache']['pos']"}
            assert len(gl) == len(wl), (name, sname)
            for path, leaf in gl:
                w = wl[path]
                assert tuple(leaf.shape) == tuple(w.shape), (name, sname,
                                                             path)
                assert leaf.dtype == to_torch[str(w.dtype)], (name, sname,
                                                              path)
                assert leaf.device.type == "cpu"
                assert type(leaf).__name__ == "FakeTensor"
