"""The dry-run on meshes the smokes' MoE layers and heads make uneven,
and its per-device peak memory (``repro_torch.launch.{dryrun,
op_analysis, roofline, dryrun_all}``).

* Per-device FLOPs of the mixtral, jamba, granite, granite-with-16-
  experts (expert parallel), 3:1-head qwen3 and rwkv6 smokes' prefill,
  train and decode steps on a fake 2x2 ("data", "model") mesh within 10%
  of the reference's ``hlo_analysis`` of the same steps, jitted with the
  reference dry-run's shardings and activation rules on a 2x2
  ``jax.sharding.Mesh`` of 4 forced host devices (``tests/
  jax_mesh_serve.py``, in a subprocess).  The ratio of the port's
  ``temp_size_in_bytes`` to XLA's is printed, not bounded: the eager
  step keeps what XLA's buffer assignment reuses.
* ``decode_32k`` counts on the production mesh (256 fake ranks) for the
  architectures whose heads or experts ``model`` 16 does not divide.
* The peak: extrapolated in depth (``dryrun.CUTS``), equal within 2% to
  a count at the whole depth on deeper qwen3, rwkv6 and jamba smokes in
  all three phases; ``temp_size_in_bytes`` + arguments + outputs less
  their aliases is the peak.
"""
import dataclasses
import os

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch.configs import archs  # noqa: E402
from repro_torch.configs.shapes import InputShape  # noqa: E402
from repro_torch.launch import dryrun, dryrun_all, roofline  # noqa: E402
from repro_torch.launch.mesh import fake_world, production_world  # noqa

from test_torch_moe_mesh import VARIANTS  # noqa: E402
from test_torch_sharded import REPO  # noqa: E402
from test_torch_sharded_genserve import _finish, _start  # noqa: E402

B, S = 4, 64
PHASES = ("prefill", "train", "decode")
COUNTED = {**VARIANTS, "rwkv6": ("rwkv6-3b", {})}


def _cfg(name):
    arch, ov = COUNTED[name]
    return dataclasses.replace(archs.get(arch, smoke=True), **ov)


@pytest.fixture(scope="module", autouse=True)
def reference(tmp_path_factory):
    """The reference's per-device counts of every (config, phase) on its
    2x2 mesh, computed in a subprocess started with the file's first
    test, while the port counts (the tests that read it come last)."""
    job = {"kind": "counts", "configs": COUNTED, "phases": PHASES,
           "batch": B, "seq": S}
    started = _start(os.path.join(REPO, "tests", "jax_mesh_serve.py"), job,
                     tmp_path_factory.mktemp("jax_counts"),
                     {"XLA_FLAGS": "--xla_force_host_platform_device_count=4",
                      "JAX_PLATFORMS": "cpu"})
    box = {}
    yield lambda: box.setdefault("res", _finish(started, 300))
    if started[0].poll() is None:
        started[0].kill()
        started[0].communicate()


@pytest.mark.parametrize("arch", ["phi3-medium-14b", "granite-moe-3b-a800m",
                                  "mixtral-8x7b", "jamba-1.5-large-398b",
                                  "rwkv6-3b"])
def test_decode_32k_counts_on_the_production_mesh(arch):
    """Heads (phi3's 40:10, granite's 24:8, rwkv6's 40) or experts
    (mixtral's 8) that ``model`` 16 does not divide."""
    rec = dryrun.dryrun_one(arch, "decode_32k", False, verbose=False)
    assert not dist.is_initialized()
    assert rec["n_devices"] == 256 and rec["flops_per_device"] > 0
    assert rec["peak_bytes_per_device"] >= rec["argument_size_in_bytes"] > 0
    assert roofline.roofline_terms(rec)["peak_bytes"] == \
        rec["peak_bytes_per_device"]


def test_rwkv6_prefill_counts_on_the_production_mesh():
    """rwkv6-3b's first layer at full width, prefill [16, 64]: the decay
    LoRA's rank-64 product is a partial sum over ``model``, which DTensor
    would reduce-scatter along the flattened tokens ahead of its tanh (a
    strided shard it cannot multiply on fake tensors; prefill_32k's
    failure)."""
    cfg = dataclasses.replace(archs.get("rwkv6-3b"), n_layers=1)
    with production_world() as mesh:
        rec = dryrun.count_step(cfg, InputShape("p", 64, 16, "prefill"),
                                mesh)
    assert not dist.is_initialized()
    assert rec["flops_per_device"] > 0


def test_train_loss_keeps_the_vocabulary_split_on_the_production_mesh():
    """qwen3-0.6b's first layer at full width, train [32, 256]: the loss
    reduces over the vocabulary shards (``steps._vocab_parallel_nll``).
    A log-softmax and gather over the split vocabulary gathered it whole
    and allocated the gather's backward zeros at the global batch's
    shape, [32, 256, 151936] fp32, on every device: a 5.9 GB peak."""
    cfg = dataclasses.replace(archs.get("qwen3-0.6b"), n_layers=1)
    with production_world() as mesh:
        rec = dryrun.count_step(cfg, InputShape("t", 256, 32, "train"),
                                mesh)
    assert not dist.is_initialized()
    assert 0 < rec["peak_bytes_per_device"] < 0.5e9


@pytest.mark.parametrize("S,chunk", [(1, 64), (2, 2), (7, 4), (13, 64),
                                     (40, 16), (100, 64)])
def test_chunked_mamba_scan_matches_the_per_token_recurrence(S, chunk):
    """``models.mamba.ssm_scan`` (the count's form: chunks of associative
    scans, as the reference's) against the kernel's plain per-token
    recurrence, odd and even lengths, from a carried state."""
    from repro_torch.kernels.mamba_scan.ops import mamba_scan_plain
    from repro_torch.models import mamba
    g = torch.Generator().manual_seed(S)
    n = lambda *shape: torch.randn(shape, generator=g)  # noqa: E731
    B, di, ds = 2, 12, 8
    dt = torch.nn.functional.softplus(n(B, S, di) - 1)
    x, Bm, Cm = n(B, S, di), n(B, S, ds), n(B, S, ds)
    A, D, h0 = -torch.exp(n(di, ds) * 0.3), n(di), n(B, di, ds)
    y, h = mamba.ssm_scan(dt, Bm, Cm, x, A, D, h0, chunk=chunk)
    yr, hr = mamba_scan_plain(dt, x, Bm, Cm, A, h0)
    torch.testing.assert_close(y, yr + x * D, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(h, hr, rtol=1e-5, atol=1e-5)


DEEP = {"qwen3-0.6b": 5, "rwkv6-3b": 5, "jamba-1.5-large-398b": 10}


@pytest.mark.parametrize("phase", PHASES)
@pytest.mark.parametrize("arch", list(DEEP))
def test_peak_extrapolates_to_the_whole_depths_count(arch, phase):
    cfg = dataclasses.replace(archs.get(arch, smoke=True),
                              n_layers=DEEP[arch])
    assert cfg.n_pattern_repeats == 5 > dryrun.CUTS[-1]
    shape = InputShape("smoke", 16, 2, phase)
    rec = dryrun.count_step(cfg, shape)
    direct = dryrun._count_once(cfg, shape, None)
    assert rec["peak_counted"] == "affine in depth"
    assert rec["peak_bytes_per_device"] == pytest.approx(
        direct["peak_bytes_per_device"], rel=0.02)
    assert rec["temp_size_in_bytes"] + rec["argument_size_in_bytes"] + \
        rec["output_size_in_bytes"] - rec["alias_size_in_bytes"] == \
        rec["peak_bytes_per_device"]
    assert rec["temp_size_in_bytes"] > 0
    # a decode step writes its cache in place: the cache is the alias
    assert (rec["alias_size_in_bytes"] > 0) == (phase == "decode")


def test_dryrun_all_names_the_exception_of_a_failed_count(monkeypatch,
                                                          capsys):
    """A count that raises a bare ``AssertionError`` reports its type."""
    def fail(*a, **k):
        raise AssertionError()
    monkeypatch.setattr(dryrun, "dryrun_one", fail)
    with pytest.raises(AssertionError):
        dryrun.main(["--arch", "qwen3-0.6b", "--shape", "decode_32k"])
    err = "Traceback (most recent call last):\n  ...\n" + \
        capsys.readouterr().err + "AssertionError\n"
    assert dryrun_all.failure(err) == "AssertionError"
    assert dryrun_all.failure(
        f"{dryrun.FAILED}RuntimeError: Cannot unflatten\nmore\n") == \
        "RuntimeError: Cannot unflatten"
    assert dryrun_all.failure("x\nValueError: bad\n\n") == \
        "ValueError: bad"


def test_roofline_marks_a_peak_above_the_card():
    rec = {"arch": "a", "shape": "s", "n_devices": 1, "phase": "decode",
           "seq_len": 8, "global_batch": 1, "active_params": 1,
           "flops_per_device": 1.0, "bytes_per_device": 1.0,
           "collective_bytes_per_device": {}}
    assert roofline.row(rec).endswith(" -")
    assert "NO FIT" not in roofline.row({**rec,
                                         "peak_bytes_per_device": 80e9})
    big = {**rec, "peak_bytes_per_device": 100.34e9}
    assert roofline.row(big).endswith("100.34 NO FIT")
    assert roofline.roofline_terms(big)["fits"] is False


@pytest.mark.parametrize("phase", PHASES)
@pytest.mark.parametrize("name", list(COUNTED))
def test_mesh_flops_within_ten_percent_of_the_reference(reference, name,
                                                        phase):
    from torch.distributed.device_mesh import init_device_mesh
    with fake_world(4):
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        rec = dryrun.count_step(_cfg(name), InputShape("smoke", S, B, phase),
                                mesh)
    assert not dist.is_initialized()
    want = reference()[(name, phase)]
    got = rec["flops_per_device"]
    assert abs(got - want["flops_per_device"]) <= \
        0.10 * want["flops_per_device"], (name, phase, got, want)
    assert rec["n_devices"] == 4
    print(f"{name} {phase}: FLOPs {got:.4e} vs the reference's "
          f"{want['flops_per_device']:.4e}; temp {rec['temp_size_in_bytes']}"
          f" B vs XLA's {want['temp_size_in_bytes']} B (ratio "
          f"{rec['temp_size_in_bytes'] / want['temp_size_in_bytes']:.3f})")
