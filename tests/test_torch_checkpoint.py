"""Checkpoints: the port's msgpack-free codec and ``checkpoint.io`` against
the JAX package's ``repro.checkpoint.io`` (and msgpack itself).

- the codec packs the format's objects byte for byte as ``msgpack.packb``
  and reads what ``msgpack.packb`` writes;
- files cross both ways bit-exactly (fp32, bf16 and int32 leaves, the
  GRPO and PPO trainer state trees); for trees of dicts, tuples, lists
  and None the port's file is the reference's byte for byte;
- the legacy wrapper-less format loads; truncated, empty,
  crc-mismatched and leaf-count-mismatched files raise
  ``CheckpointError`` in both packages;
- ``load_latest`` falls back past a corrupt newest file and
  ``retain_last`` keeps the same files as the reference's;
- a payload over the format's 4 GiB raises before anything is written
  (meta tensors: nothing is allocated).
"""
import dataclasses
import os
import zlib

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import msgpack  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import io as jio  # noqa: E402
from repro.data.synthetic import VOCAB_SIZE  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.checkpoint import codec, io as tio  # noqa: E402
from repro_torch.configs import archs as tarchs  # noqa: E402
from repro_torch.data.synthetic import AdditionTask as TTask  # noqa: E402
from repro_torch.rl.trainer import RLConfig as TRL, RLTrainer as TTrainer  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402


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


TCFG = dataclasses.replace(tarchs.SMOKE["qwen3-0.6b"], vocab_size=VOCAB_SIZE,
                           dtype="float32")


def _plain(obj):
    """A decoded object with its memoryviews as bytes (what
    ``msgpack.unpackb`` returns)."""
    if isinstance(obj, memoryview):
        return bytes(obj)
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_plain(v) for v in obj]
    return obj


def _np(tree):
    """numpy leaves (bf16 as ``ml_dtypes.bfloat16``), None kept."""
    return tree_map(bridge.to_numpy_params, tree)


def _tree(seed=0):
    """fp32, bf16 and int32 leaves, a tuple, a list and None."""
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn((4, 3), generator=g),
            "h": torch.randn((2, 5), generator=g).to(torch.bfloat16),
            "b": torch.arange(5, dtype=torch.int32) + seed,
            "t": (torch.randn((3,), generator=g), None),
            "l": [torch.randn((2, 2), generator=g)]}


def _assert_bitwise(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.view(torch.int16) if x.dtype == torch.bfloat16
                           else x, y.view(torch.int16)
                           if y.dtype == torch.bfloat16 else y)


def _assert_np_bitwise(a, b):
    fa = jax.tree_util.tree_leaves(a)
    fb = jax.tree_util.tree_leaves(b)
    assert len(fa) == len(fb)
    for x, y in zip(fa, fb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


def _to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, _np(tree))


def _trainer(alg, seed=0):
    return TTrainer(TCFG, TRL(algorithm=alg, n_rollouts=4, max_new_tokens=3),
                    TTask(max_operand=9), seed=seed, device="cpu")


# ---------------------------------------------------------------------------
# the codec against msgpack
# ---------------------------------------------------------------------------

PAYLOADS = {
    "leaves": {b"treedef": b"PyTreeDef(*)",
               b"leaves": [{b"dtype": b"float32", b"shape": [2, 3],
                            b"data": bytes(range(24))}]},
    "widths": {b"treedef": b"x" * 300,
               b"leaves": [{b"dtype": b"int32", b"shape": [0, 255, 256,
                                                             65535, 65536,
                                                             2**32 - 1,
                                                             2**32],
                            b"data": b"\x07" * 70000},
                           {b"dtype": b"bool", b"shape": [], b"data": b""}]},
    "many": {b"leaves": [{b"k%d" % i: [i] * i for i in range(20)}] * 17},
    "wrapper": {b"crc32": 0xFFFFFFFF, b"payload": b"\x01" * 256},
}


@pytest.mark.parametrize("name", sorted(PAYLOADS))
def test_codec_matches_msgpack_bytes(name):
    obj = PAYLOADS[name]
    raw = msgpack.packb(obj)
    assert codec.packb(obj) == raw
    assert _plain(codec.unpackb(raw)) == msgpack.unpackb(raw)


@pytest.mark.parametrize("raw", [b"", b"\xc6\x00\x00\x01\x00abc",
                                 msgpack.packb({b"a": 1}) + b"\x00",
                                 b"\xc1", b"\x82\xa1a",
                                 msgpack.packb(-1), msgpack.packb("str"),
                                 msgpack.packb(1.5)])
def test_codec_rejects_damaged_input(raw):
    with pytest.raises(ValueError):
        codec.unpackb(raw)


def test_port_file_is_msgpack_and_crc_wrapped(tmp_path):
    """The port's file: a msgpack map {crc32, payload} that msgpack
    re-packs to the same bytes, the crc32 over the payload, and a payload
    whose leaves are the reference's ``_pack_leaf`` of the same arrays."""
    p = str(tmp_path / "t.msgpack")
    tree = _tree()
    n = tio.save(p, tree)
    raw = open(p, "rb").read()
    assert n == len(raw)
    outer = msgpack.unpackb(raw)
    assert list(outer) == [b"crc32", b"payload"]
    assert msgpack.packb(outer) == raw
    assert outer[b"crc32"] == zlib.crc32(outer[b"payload"])
    inner = msgpack.unpackb(outer[b"payload"])
    assert msgpack.packb(inner) == outer[b"payload"]
    assert inner[b"treedef"] == str(
        jax.tree_util.tree_flatten(_to_jax(tree))[1]).encode()
    want = [jio._pack_leaf(x)
            for x in jax.tree_util.tree_leaves(_np(tree))]
    assert inner[b"leaves"] == want


def test_port_file_is_the_reference_file(tmp_path):
    tree = _tree()
    jio.save(str(tmp_path / "j.msgpack"), _to_jax(tree))
    tio.save(str(tmp_path / "t.msgpack"), tree)
    assert open(tmp_path / "j.msgpack", "rb").read() == \
        open(tmp_path / "t.msgpack", "rb").read()


# ---------------------------------------------------------------------------
# files cross both ways
# ---------------------------------------------------------------------------

def _state(name):
    if name == "tree":
        return _tree(), _tree(1)
    tr = _trainer(name)
    other = _trainer(name, seed=5)
    # a stepped optimizer and a gen replica of its own, as after a sync
    state = tr.state_tree()
    state["actor_opt"] = dict(state["actor_opt"],
                              step=torch.tensor(3, dtype=torch.int32))
    state["gen_params"] = tree_map(lambda t: t + 1.0, state["actor"])
    return state, other.state_tree()


@pytest.mark.parametrize("name", ["tree", "grpo", "ppo"])
def test_port_written_restores_in_reference(name, tmp_path):
    state, _ = _state(name)
    p = str(tmp_path / "s.msgpack")
    tio.save(p, state)
    like = jax.tree_util.tree_map(jnp.zeros_like, _to_jax(state))
    got = jio.restore(p, like)
    _assert_np_bitwise(jax.tree_util.tree_map(np.asarray, got), _np(state))


@pytest.mark.parametrize("name", ["tree", "grpo", "ppo"])
def test_reference_written_restores_in_port(name, tmp_path):
    state, like = _state(name)
    p = str(tmp_path / "s.msgpack")
    jio.save(p, _to_jax(state))
    got = tio.restore(p, like)
    _assert_bitwise(got, state)
    for a, b in zip(tree_leaves(got), tree_leaves(like)):
        assert a.device == b.device and a.dtype == b.dtype


def test_restore_casts_to_like_dtype(tmp_path):
    p = str(tmp_path / "s.msgpack")
    tree = {"w": torch.randn(3, 4), "b": torch.arange(3, dtype=torch.int32)}
    tio.save(p, tree)
    like = {"w": torch.zeros(12, dtype=torch.bfloat16),
            "b": torch.zeros(3, dtype=torch.int64)}
    got = tio.restore(p, like)
    assert got["w"].dtype == torch.bfloat16 and got["w"].shape == (12,)
    assert torch.equal(got["w"], tree["w"].to(torch.bfloat16).reshape(12))
    assert torch.equal(got["b"], tree["b"].long())
    with pytest.raises(tio.CheckpointError, match="shape"):
        tio.restore(p, {"w": torch.zeros(5), "b": torch.zeros(3)})


def test_legacy_wrapperless_format_loads(tmp_path):
    p = str(tmp_path / "legacy.msgpack")
    tree = _tree()
    jt = _to_jax(tree)
    flat, treedef = jax.tree_util.tree_flatten(jt)
    payload = {b"treedef": str(treedef).encode(),
               b"leaves": [jio._pack_leaf(x) for x in flat]}
    open(p, "wb").write(msgpack.packb(payload))
    _assert_bitwise(tio.restore(p, _tree(1)), tree)
    _assert_np_bitwise(jio.restore(p, jt), jt)


def _damage(kind, p, tmp_path):
    raw = bytearray(open(p, "rb").read())
    if kind == "truncated":
        raw = raw[:len(raw) - 7]
    elif kind == "empty":
        raw = b""
    elif kind == "crc":
        mid = len(raw) // 2
        raw[mid:mid + 8] = bytes(b ^ 0xFF for b in raw[mid:mid + 8])
    elif kind == "not_msgpack":
        raw = b"\x00garbage"
    open(p, "wb").write(bytes(raw))


@pytest.mark.parametrize("kind", ["truncated", "empty", "crc", "not_msgpack",
                                  "leaf_count"])
def test_damaged_files_raise_in_both(kind, tmp_path):
    p = str(tmp_path / "d.msgpack")
    tree = _tree()
    tio.save(p, tree)
    like_t, like_j = _tree(1), _to_jax(_tree(1))
    if kind == "leaf_count":
        like_t = dict(like_t, extra=torch.zeros(1))
        like_j = dict(like_j, extra=jnp.zeros(1))
    else:
        _damage(kind, p, tmp_path)
    with pytest.raises(tio.CheckpointError) as et:
        tio.restore(p, like_t)
    with pytest.raises(jio.CheckpointError) as ej:
        jio.restore(p, like_j)
    # the same diagnosis: the message up to the first parenthesis
    assert str(et.value).split("(")[0] == str(ej.value).split("(")[0]


def test_load_latest_fallback_and_retain(tmp_path):
    dt, dj = tmp_path / "t", tmp_path / "j"
    for i in range(4):
        tio.save(str(dt / f"ck_{i:05d}.msgpack"), _tree(i), retain=3)
        jio.save(str(dj / f"ck_{i:05d}.msgpack"), _to_jax(_tree(i)),
                 retain=3)
    files = tio._checkpoint_files(str(dt))
    assert [os.path.basename(p) for p in files] == \
        [os.path.basename(p) for p in jio._checkpoint_files(str(dj))] == \
        ["ck_00001.msgpack", "ck_00002.msgpack", "ck_00003.msgpack"]
    # damage the newest -> load_latest warns and falls back to ck_00002
    open(files[-1], "wb").write(b"\x00garbage")
    with pytest.warns(RuntimeWarning, match="skipping checkpoint"):
        tree, path = tio.load_latest(str(dt), _tree(9))
    assert path == files[-2]
    _assert_bitwise(tree, _tree(2))
    for p in files:
        open(p, "wb").write(b"")
    with pytest.warns(RuntimeWarning), \
            pytest.raises(tio.CheckpointError, match="no loadable"):
        tio.load_latest(str(dt), _tree(9))
    with pytest.raises(tio.CheckpointError, match="no checkpoint files"):
        tio.load_latest(str(tmp_path / "none"), _tree(9))


def test_payload_over_the_cap_raises_before_any_write(tmp_path):
    assert issubclass(tio.CheckpointError, ValueError)
    with pytest.raises(ValueError, match="bin 32"):
        codec.bin_header(codec.BIN_MAX + 1)
    assert len(codec.bin_header(codec.BIN_MAX)) == 5
    # meta tensors have sizes and no storage: nothing is allocated
    big = {"a": torch.empty(2**29, dtype=torch.float32, device="meta"),
           "b": torch.empty(2**29, dtype=torch.float32, device="meta")}
    p = str(tmp_path / "sub" / "big.msgpack")
    with pytest.raises(tio.CheckpointError, match="4 GiB"):
        tio.save(p, big)
    assert not os.path.exists(tmp_path / "sub")
    assert not os.path.exists(p + ".tmp")
