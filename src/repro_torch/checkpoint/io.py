"""Checkpointing: msgpack-serialized trees of tensors.

Supports periodic saves during RL training — the paper leans on this for
online redeployment (§6: reschedule at checkpoint boundaries).

Integrity: every checkpoint wraps the packed payload with a crc32
content checksum, verified on restore.  ``restore`` raises a clear
``CheckpointError`` for truncated / corrupt / mismatched files instead
of a decoder stack trace; ``load_latest`` walks a directory newest-first
and falls back past damaged files.  Pre-checksum checkpoints (payload
packed directly, no wrapper) still load.

Port of ``repro.checkpoint.io``, writing and reading the same file format
without msgpack (``checkpoint.codec`` encodes the subset the format
uses, byte for byte as ``msgpack.packb`` does): a file written by either
package restores bit-exactly in the other.

- Leaves are ``{b"dtype", b"shape", b"data"}`` in ``tree.tree_leaves``
  order, which is ``jax.tree_util``'s (dict keys sorted, ``None`` an
  empty subtree).  The dtype is numpy's name; bfloat16 leaves travel as
  their raw 16 bits under the name ``"bfloat16"``, as the reference
  writes them.
- ``b"treedef"`` holds this package's structure string, which for trees
  of dicts, tuples, lists and ``None`` is the string ``str(treedef)``
  gives in JAX, so such a file is byte for byte the reference's.  Neither
  package reads it back: ``restore`` takes the structure from ``like``.
- The payload is one msgpack bin, and bin 32 holds at most 0xFFFFFFFF
  bytes: a tree whose payload would exceed 4 GiB raises
  ``CheckpointError`` before anything is written.  The reference hits the
  same limit inside msgpack (``ValueError``), so ``CheckpointError`` is a
  ``ValueError`` too.
- Leaves are copied to the host once, the crc32 runs over those copies,
  and the file is written from them without packing the payload into one
  buffer.  ``restore`` reads the file into one buffer and returns
  tensors on ``like``'s devices and dtypes.
"""
from __future__ import annotations

import os
import warnings
import zlib
from typing import Any, List, Tuple

import torch

from repro_torch.checkpoint import codec
from repro_torch.tree import tree_leaves, tree_unflatten


class CheckpointError(ValueError):
    """A checkpoint file is corrupt, truncated, or shape-mismatched, or a
    tree is too large for the format."""


# numpy's dtype names, which the format stores
_DTYPE_NAMES = {torch.float32: "float32", torch.float64: "float64",
                torch.float16: "float16", torch.bfloat16: "bfloat16",
                torch.int8: "int8", torch.int16: "int16",
                torch.int32: "int32", torch.int64: "int64",
                torch.uint8: "uint8", torch.bool: "bool"}
_DTYPES = {v: k for k, v in _DTYPE_NAMES.items()}


def treedef_str(tree) -> str:
    """The tree's structure in the style of a ``PyTreeDef`` (``*`` for a
    leaf, dict keys sorted)."""
    def s(node):
        if node is None:
            return "None"
        if isinstance(node, dict):
            return "{" + ", ".join(f"{k!r}: {s(node[k])}"
                                   for k in sorted(node)) + "}"
        if isinstance(node, tuple):
            inner = ", ".join(s(x) for x in node)
            return f"({inner},)" if len(node) == 1 else f"({inner})"
        if isinstance(node, list):
            return "[" + ", ".join(s(x) for x in node) + "]"
        return "*"
    return f"PyTreeDef({s(tree)})"


def _leaf_nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _host_bytes(x: torch.Tensor) -> memoryview:
    """The leaf's bytes on the host (one device-to-host copy)."""
    t = x.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return memoryview(t.reshape(-1).numpy()).cast("B")


def _pack_leaf(x: torch.Tensor, data) -> dict:
    if x.dtype not in _DTYPE_NAMES:
        raise CheckpointError(f"dtype {x.dtype} is not in the format")
    return {b"dtype": _DTYPE_NAMES[x.dtype].encode(),
            b"shape": list(x.shape),
            b"data": data}


def _unpack_leaf(d) -> torch.Tensor:
    dt = _DTYPES[bytes(d[b"dtype"]).decode()]
    shape = [int(n) for n in d[b"shape"]]
    data = d[b"data"]
    n = 1
    for s in shape:
        n *= s
    if len(data) != n * torch.empty((), dtype=dt).element_size():
        raise ValueError(f"{len(data)} bytes for shape {shape} of {dt}")
    if n == 0:
        return torch.empty(shape, dtype=dt)
    return torch.frombuffer(data, dtype=dt).reshape(shape)


def save(path: str, tree: Any, *, retain: int = 0) -> int:
    """Write ``tree`` atomically (tmp + rename) with a crc32 checksum
    over the packed payload.  ``retain > 0`` additionally prunes the
    checkpoint directory down to the ``retain`` newest files sharing
    this checkpoint's prefix-up-to-digits naming. Returns bytes written.
    A payload over the format's 4 GiB raises ``CheckpointError`` before
    any leaf is copied or any file opened."""
    flat = tree_leaves(tree)
    # the payload's size from the leaves' sizes: headers as they will be
    # packed, data as empty placeholders of the right length
    sizes = [_leaf_nbytes(x) for x in flat]
    head = {b"treedef": treedef_str(tree).encode(),
            b"leaves": [_pack_leaf(x, b"") for x in flat]}
    inner_len = codec.chunks_len(codec.pack_chunks(head)) + sum(
        codec.bin_header_len(n) - codec.bin_header_len(0) + n
        for n in sizes)
    if inner_len > codec.BIN_MAX:
        raise CheckpointError(
            f"{path}: the payload of {inner_len} bytes ({inner_len / 2**30:.2f}"
            f" GiB, {len(flat)} leaves) exceeds the format's cap of "
            f"{codec.BIN_MAX} bytes (4 GiB: one msgpack bin 32); nothing "
            f"was written")
    payload = {b"treedef": head[b"treedef"],
               b"leaves": [_pack_leaf(x, _host_bytes(x)) for x in flat]}
    inner = codec.pack_chunks(payload)
    assert codec.chunks_len(inner) == inner_len
    crc = 0
    for c in inner:
        crc = zlib.crc32(c, crc)
    outer = (codec.map_header(2) + codec.packb(b"crc32")
             + codec.pack_uint(crc) + codec.packb(b"payload")
             + codec.bin_header(inner_len))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(outer)
        for c in inner:
            f.write(c)
    os.replace(tmp, path)
    if retain > 0:
        retain_last(os.path.dirname(os.path.abspath(path)), retain)
    return len(outer) + inner_len


def _read_payload(path: str) -> dict:
    """Read + verify a checkpoint file, returning the unpacked payload
    dict.  Raises CheckpointError on any damage."""
    try:
        with open(path, "rb") as f:
            raw = bytearray(os.fstat(f.fileno()).st_size)
            n = f.readinto(raw)
        del raw[n:]
    except OSError as e:
        raise CheckpointError(f"{path}: unreadable ({e})") from e
    if not raw:
        raise CheckpointError(f"{path}: empty file")
    try:
        outer = codec.unpackb(raw)
    except Exception as e:
        raise CheckpointError(f"{path}: truncated or not msgpack "
                              f"({type(e).__name__})") from e
    if isinstance(outer, dict) and b"payload" in outer:
        inner = outer[b"payload"]
        if not isinstance(inner, memoryview):
            raise CheckpointError(f"{path}: payload is not a bin")
        crc = zlib.crc32(inner)
        if crc != outer.get(b"crc32"):
            raise CheckpointError(
                f"{path}: checksum mismatch (stored "
                f"{outer.get(b'crc32')}, computed {crc}) — corrupt")
        try:
            payload = codec.unpackb(inner)
        except Exception as e:
            raise CheckpointError(f"{path}: corrupt payload "
                                  f"({type(e).__name__})") from e
    elif isinstance(outer, dict) and b"leaves" in outer:
        payload = outer  # legacy pre-checksum format
    else:
        raise CheckpointError(f"{path}: unrecognized checkpoint format")
    if not isinstance(payload, dict) or b"leaves" not in payload:
        raise CheckpointError(f"{path}: payload missing leaves")
    return payload


def restore(path: str, like: Any) -> Any:
    """Restore into the structure of `like` (treedef source of truth):
    each leaf on its ``like`` leaf's device, in its dtype and shape."""
    payload = _read_payload(path)
    try:
        leaves = [_unpack_leaf(d) for d in payload[b"leaves"]]
    except Exception as e:
        raise CheckpointError(f"{path}: corrupt leaf encoding "
                              f"({type(e).__name__})") from e
    flat = tree_leaves(like)
    if len(flat) != len(leaves):
        raise CheckpointError(
            f"{path}: checkpoint has {len(leaves)} leaves, "
            f"model has {len(flat)}")
    restored = []
    for i, (l, x) in enumerate(zip(leaves, flat)):
        if l.numel() != x.numel():
            raise CheckpointError(
                f"{path}: leaf {i} has shape {tuple(l.shape)}, the model's "
                f"{tuple(x.shape)}")
        # a copy: the leaves must not keep the whole file's buffer alive
        restored.append(l.to(device=x.device, dtype=x.dtype, copy=True)
                        .reshape(x.shape))
    return tree_unflatten(like, restored)


def _checkpoint_files(dirpath: str) -> List[str]:
    """Checkpoint files in ``dirpath``, oldest→newest.  Zero-padded
    iteration numbers in the names make lexicographic == chronological;
    mtime breaks ties for mixed naming schemes."""
    try:
        names = [n for n in os.listdir(dirpath)
                 if n.endswith(".msgpack") and not n.endswith(".tmp")]
    except OSError:
        return []
    paths = [os.path.join(dirpath, n) for n in names]
    return sorted(paths, key=lambda p: (os.path.basename(p),))


def retain_last(dirpath: str, keep: int) -> List[str]:
    """Delete all but the ``keep`` newest checkpoints in ``dirpath``.
    Returns the paths removed."""
    files = _checkpoint_files(dirpath)
    removed = []
    for p in files[:max(0, len(files) - keep)]:
        try:
            os.remove(p)
            removed.append(p)
        except OSError:
            pass
    return removed


def load_latest(dirpath: str, like: Any) -> Tuple[Any, str]:
    """Restore the newest loadable checkpoint in ``dirpath``, skipping
    corrupt / truncated files with a warning.  Returns ``(tree, path)``;
    raises CheckpointError listing every file tried if none loads."""
    files = _checkpoint_files(dirpath)
    if not files:
        raise CheckpointError(f"{dirpath}: no checkpoint files")
    errors: List[str] = []
    for path in reversed(files):
        try:
            return restore(path, like), path
        except CheckpointError as e:
            warnings.warn(f"skipping checkpoint: {e}", RuntimeWarning,
                          stacklevel=2)
            errors.append(str(e))
    raise CheckpointError(
        f"{dirpath}: no loadable checkpoint among {len(files)} files:\n  "
        + "\n  ".join(errors))
