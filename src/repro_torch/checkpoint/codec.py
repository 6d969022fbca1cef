"""The part of msgpack that the checkpoint format uses, with no msgpack.

``checkpoint.io`` writes and reads the reference's file format: msgpack
maps with bytes keys, arrays, bin 8/16/32 and non-negative integers (the
crc32 and the shapes).  Every value is written in the smallest encoding,
as ``msgpack.packb`` writes it, so the bytes are the same.

Bins decode to ``memoryview`` slices of the buffer (no copy); map keys
decode to ``bytes``.  Every error is a ``ValueError``: a type byte outside
that subset, a length past the end of the buffer, bytes after the object,
and a bin of more than ``BIN_MAX`` bytes on write (bin 32 holds at most
0xFFFFFFFF bytes, so one file holds at most 4 GiB of payload).
"""
from __future__ import annotations

import struct
from typing import Any, Iterable, List

BIN_MAX = 0xFFFFFFFF


def pack_uint(n: int) -> bytes:
    """A non-negative integer in its smallest msgpack encoding."""
    if n < 0:
        raise ValueError(f"negative integer {n}: not in the format")
    if n < 0x80:
        return bytes((n,))
    if n <= 0xFF:
        return b"\xcc" + struct.pack(">B", n)
    if n <= 0xFFFF:
        return b"\xcd" + struct.pack(">H", n)
    if n <= 0xFFFFFFFF:
        return b"\xce" + struct.pack(">I", n)
    if n <= 0xFFFFFFFFFFFFFFFF:
        return b"\xcf" + struct.pack(">Q", n)
    raise ValueError(f"integer {n} does not fit uint64")


def bin_header_len(n: int) -> int:
    """Bytes of ``bin_header(n)``, without the size check."""
    return 2 if n <= 0xFF else 3 if n <= 0xFFFF else 5


def bin_header(n: int) -> bytes:
    """The header of a bin of ``n`` bytes; more than ``BIN_MAX`` raises."""
    if n < 0:
        raise ValueError(f"negative bin length {n}")
    if n <= 0xFF:
        return b"\xc4" + struct.pack(">B", n)
    if n <= 0xFFFF:
        return b"\xc5" + struct.pack(">H", n)
    if n <= BIN_MAX:
        return b"\xc6" + struct.pack(">I", n)
    raise ValueError(f"bin of {n} bytes is too large: msgpack's bin 32 "
                     f"holds at most {BIN_MAX} bytes (4 GiB)")


def _container_header(n: int, fix: int, b16: bytes, b32: bytes) -> bytes:
    if n < 16:
        return bytes((fix | n,))
    if n <= 0xFFFF:
        return b16 + struct.pack(">H", n)
    if n <= 0xFFFFFFFF:
        return b32 + struct.pack(">I", n)
    raise ValueError(f"container of {n} entries is too large")


def map_header(n: int) -> bytes:
    return _container_header(n, 0x80, b"\xde", b"\xdf")


def array_header(n: int) -> bytes:
    return _container_header(n, 0x90, b"\xdc", b"\xdd")


def pack_chunks(obj: Any) -> List[Any]:
    """``obj`` encoded as a list of buffers whose concatenation is
    ``msgpack.packb(obj)``; bins are passed through uncopied.  Takes
    dicts, lists, tuples, bytes-like objects and non-negative ints."""
    out: List[Any] = []
    _pack(obj, out)
    return out


def _pack(obj: Any, out: List[Any]) -> None:
    if isinstance(obj, bool) or obj is None:
        raise TypeError(f"{obj!r}: not in the checkpoint format")
    if isinstance(obj, int):
        out.append(pack_uint(obj))
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        n = memoryview(obj).nbytes
        out.append(bin_header(n))
        if n:
            out.append(obj)
    elif isinstance(obj, dict):
        out.append(map_header(len(obj)))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, (list, tuple)):
        out.append(array_header(len(obj)))
        for v in obj:
            _pack(v, out)
    else:
        raise TypeError(f"{type(obj).__name__}: not in the checkpoint "
                        f"format")


def chunks_len(chunks: Iterable[Any]) -> int:
    return sum(memoryview(c).nbytes for c in chunks)


def packb(obj: Any) -> bytes:
    """``msgpack.packb(obj)`` for the format's types."""
    return b"".join(bytes(c) if isinstance(c, memoryview) else c
                    for c in pack_chunks(obj))


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------

_UINT = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q"}
_LEN = {0xc4: ">B", 0xc5: ">H", 0xc6: ">I",       # bin 8/16/32
        0xdc: ">H", 0xdd: ">I",                   # array 16/32
        0xde: ">H", 0xdf: ">I"}                   # map 16/32


class _Reader:
    def __init__(self, buf):
        self.mv = memoryview(buf).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.mv):
            raise ValueError(f"truncated: {n} bytes wanted at offset "
                             f"{self.pos} of {len(self.mv)}")
        out = self.mv[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self) -> Any:
        b = self.take(1)[0]
        if b < 0x80:
            return b
        if b < 0x90:
            return self.read_map(b & 0x0f)
        if b < 0xa0:
            return [self.read() for _ in range(b & 0x0f)]
        if b in _UINT:
            return self.unpack(_UINT[b])
        if b in _LEN:
            n = self.unpack(_LEN[b])
            if b <= 0xc6:
                return self.take(n)
            if b <= 0xdd:
                return [self.read() for _ in range(n)]
            return self.read_map(n)
        raise ValueError(f"type byte 0x{b:02x} at offset {self.pos - 1} is "
                         f"not in the checkpoint format")

    def read_map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[bytes(k) if isinstance(k, memoryview) else k] = self.read()
        return out


def unpackb(buf) -> Any:
    """Decode one object that fills ``buf`` exactly (bins as memoryview
    slices of ``buf``)."""
    r = _Reader(buf)
    obj = r.read()
    if r.pos != len(r.mv):
        raise ValueError(f"{len(r.mv) - r.pos} bytes after the object")
    return obj

