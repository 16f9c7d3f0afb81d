"""A reader and a writer of the msgpack files that ``flax.serialization``
writes.

The JAX package saves its checkpoints with ``flax.serialization.to_bytes``
/ ``msgpack_serialize`` (``pixelpick_tpu/engine/checkpoint.py``,
``pixelpick_tpu/models/convert.py``). This module decodes them with neither
flax nor msgpack installed: a small decoder of the msgpack subset flax
writes, and flax's two array extensions.

- nil, bool, positive and negative fixint, int8-64, uint8-64, float32/64;
- fixstr, str8/16/32 (UTF-8) and bin8/16/32;
- fixmap, map16/32 and fixarray, array16/32;
- fixext1-16 and ext8/16/32 of type 1 (an ndarray) and type 3 (a numpy
  scalar): each payload is itself msgpack, the array
  ``(shape, dtype name, C-order bytes)`` (flax's ``_ndarray_to_bytes``).

Anything else raises ``ValueError`` naming what was met: extension type 2
(a complex number), a ``bfloat16`` array (numpy has no such dtype; convert
through ``torch.bfloat16`` in the caller instead), a
``__msgpack_chunked_array__`` dict (flax's split of arrays over 1 GiB), or
a byte outside the subset.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3

# fixed-width scalars: format byte -> (struct format, size)
_FIXED = {
    0xca: (">f", 4), 0xcb: (">d", 8),
    0xcc: (">B", 1), 0xcd: (">H", 2), 0xce: (">I", 4), 0xcf: (">Q", 8),
    0xd0: (">b", 1), 0xd1: (">h", 2), 0xd2: (">i", 4), 0xd3: (">q", 8),
}
# length-prefixed formats: format byte -> (kind, length's struct format)
_SIZED = {
    0xc4: ("bin", ">B"), 0xc5: ("bin", ">H"), 0xc6: ("bin", ">I"),
    0xc7: ("ext", ">B"), 0xc8: ("ext", ">H"), 0xc9: ("ext", ">I"),
    0xd9: ("str", ">B"), 0xda: ("str", ">H"), 0xdb: ("str", ">I"),
    0xdc: ("array", ">H"), 0xdd: ("array", ">I"),
    0xde: ("map", ">H"), 0xdf: ("map", ">I"),
}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError(f"msgpack: truncated at byte {self.pos} "
                             f"({n} more bytes wanted, "
                             f"{len(self.data) - self.pos} left)")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str, n: int):
        return struct.unpack(fmt, self.take(n))[0]

    def value(self, raw: bool = False) -> Any:
        at = self.pos
        b = self.unpack(">B", 1)
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self._map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return [self.value(raw) for _ in range(b & 0x0f)]
        if 0xa0 <= b <= 0xbf:
            return self._str(b & 0x1f, raw)
        if b == 0xc0:
            return None
        if b in (0xc2, 0xc3):
            return b == 0xc3
        if b in _FIXED:
            return self.unpack(*_FIXED[b])
        if b in _FIXEXT:
            return self._ext(_FIXEXT[b], at)
        if b in _SIZED:
            kind, fmt = _SIZED[b]
            n = self.unpack(fmt, struct.calcsize(fmt))
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return self._str(n, raw)
            if kind == "ext":
                return self._ext(n, at)
            if kind == "array":
                return [self.value(raw) for _ in range(n)]
            return self._map(n)
        raise ValueError(f"msgpack: byte 0x{b:02x} at offset {at} is outside "
                         f"the subset flax.serialization writes")

    def _str(self, n: int, raw: bool):
        s = bytes(self.take(n))
        return s if raw else s.decode("utf-8")

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        if "__msgpack_chunked_array__" in out:
            raise ValueError("msgpack: a __msgpack_chunked_array__ dict (flax "
                             "splits arrays over 1 GiB into chunks); reading "
                             "it is not supported")
        return out

    def _ext(self, n: int, at: int):
        code = self.unpack(">b", 1)
        payload = bytes(self.take(n))
        if code == EXT_NDARRAY:
            return _ndarray(payload)
        if code == EXT_NPSCALAR:
            return _ndarray(payload)[()]
        if code == EXT_COMPLEX:
            raise ValueError(f"msgpack: extension type 2 (a complex number) "
                             f"at offset {at}; not supported")
        raise ValueError(f"msgpack: extension type {code} at offset {at} is "
                         f"not one flax.serialization writes")


def _ndarray(payload: bytes) -> np.ndarray:
    """flax's ``_ndarray_from_bytes``: ``(shape, dtype name, bytes)``."""
    r = _Reader(payload)
    shape, dtype_name, buf = r.value(raw=True)
    name = dtype_name.decode("ascii")
    if name == "bfloat16":
        raise ValueError("msgpack: a bfloat16 array; numpy has no bfloat16 "
                         "dtype, so this reader does not guess one (read the "
                         "bytes as torch.bfloat16 instead)")
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape).copy()


def msgpack_restore(data: bytes) -> Any:
    """Decode ``flax.serialization.msgpack_serialize`` bytes: nested dicts
    of numpy arrays, numpy scalars and Python values."""
    r = _Reader(data)
    out = r.value()
    if r.pos != len(r.data):
        raise ValueError(f"msgpack: {len(r.data) - r.pos} trailing bytes "
                         f"after the top-level object")
    return out


def is_msgpack_map(head: bytes) -> bool:
    """Whether ``head`` (a file's first bytes) starts a msgpack map: the
    top-level object of every file flax writes."""
    return bool(head) and (0x80 <= head[0] <= 0x8f or head[0] in (0xde, 0xdf))


def flatten(tree: dict, prefix: Tuple[str, ...] = ()) -> dict:
    """{path tuple: leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _sized(n: int, fix_tag, fix_max: int, tags) -> bytes:
    if fix_tag is not None and n <= fix_max:
        return bytes([fix_tag | n])
    for tag, fmt, top in tags:
        if n <= top:
            return bytes([tag]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack: length {n} too large")


def msgpack_serialize(obj: Any) -> bytes:
    """msgpack of a checkpoint tree, as ``flax.serialization.
    msgpack_serialize`` encodes it: an ndarray is extension type 1 over the
    msgpack of ``(shape, dtype name, C-order bytes)``."""
    if isinstance(obj, dict):
        return _sized(len(obj), 0x80, 15, ((0xde, ">H", 0xffff),
                                            (0xdf, ">I", 0xffffffff))) \
            + b"".join(msgpack_serialize(k) + msgpack_serialize(v)
                       for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return _sized(len(obj), 0x90, 15, ((0xdc, ">H", 0xffff),
                                            (0xdd, ">I", 0xffffffff))) \
            + b"".join(msgpack_serialize(v) for v in obj)
    if isinstance(obj, str):
        b = obj.encode()
        return _sized(len(b), 0xa0, 31, ((0xd9, ">B", 0xff),
                                          (0xda, ">H", 0xffff),
                                          (0xdb, ">I", 0xffffffff))) + b
    if isinstance(obj, bytes):
        return _sized(len(obj), None, 0, ((0xc4, ">B", 0xff),
                                           (0xc5, ">H", 0xffff),
                                           (0xc6, ">I", 0xffffffff))) + obj
    if isinstance(obj, (int, np.integer)) and not isinstance(obj, bool) \
            and obj >= 0:
        return _sized(int(obj), 0x00, 127, ((0xcc, ">B", 0xff),
                                             (0xcd, ">H", 0xffff),
                                             (0xce, ">I", 0xffffffff),
                                             (0xcf, ">Q", 2 ** 64 - 1)))
    if isinstance(obj, float):
        return b"\xcb" + struct.pack(">d", obj)
    if isinstance(obj, np.ndarray):
        payload = msgpack_serialize([list(obj.shape), obj.dtype.name,
                                     np.ascontiguousarray(obj).tobytes()])
        n = len(payload)
        fixext = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
        head = bytes([fixext[n]]) if n in fixext else _sized(
            n, None, 0, ((0xc7, ">B", 0xff), (0xc8, ">H", 0xffff),
                         (0xc9, ">I", 0xffffffff)))
        return head + bytes([EXT_NDARRAY]) + payload
    raise TypeError(f"msgpack: cannot write a {type(obj).__name__}")
