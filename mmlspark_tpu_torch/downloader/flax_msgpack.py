"""flax's msgpack checkpoint format, read and written without flax or msgpack.

The zoo stores weights as ``flax.serialization.msgpack_serialize`` bytes
(``<name>.msgpack``), and a model either package installs must load in the
other. The port runs where neither ``flax`` nor ``msgpack`` is installed, so
this module carries the part of both that those files use:

- maps, arrays, str, bin, ints, floats, bool and nil, in msgpack's encodings
  (the writer picks the same smallest encoding ``msgpack.packb`` does, so
  ``msgpack_serialize`` returns the same bytes as flax's);
- ext type 1, an ndarray: a packed ``(shape, dtype name, C-order bytes)``
  tuple; ext type 3, a numpy scalar, the same for a 0-d array;
- flax's ``__msgpack_chunked_array__`` maps, which split an array above
  2**30 bytes into flat chunks.

``msgpack_restore`` returns numpy arrays (read-only views of the blob, as
flax's are) and numpy scalars. A ``bfloat16`` array, which numpy cannot
hold, is widened to ``float32`` exactly. Tuples are refused on write, as
flax refuses them (``strict_types``), and so are complex numbers (flax's
ext type 2), which no checkpoint holds.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
MAX_CHUNK_SIZE = 2**30
CHUNKED = "__msgpack_chunked_array__"


# -- writing ---------------------------------------------------------------


def _pack_int(v: int, out: bytearray) -> None:
    if 0 <= v < 0x80:
        out.append(v)
    elif -32 <= v < 0:
        out += struct.pack(">b", v)
    elif v >= 0:
        for lim, code, fmt in ((0xFF, 0xCC, ">B"), (0xFFFF, 0xCD, ">H"),
                               (0xFFFFFFFF, 0xCE, ">I"), (2**64 - 1, 0xCF, ">Q")):
            if v <= lim:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"int {v} is too large for msgpack")
    else:
        for lim, code, fmt in ((-0x80, 0xD0, ">b"), (-0x8000, 0xD1, ">h"),
                               (-0x80000000, 0xD2, ">i"), (-2**63, 0xD3, ">q")):
            if v >= lim:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"int {v} is too small for msgpack")


def _pack_len(n: int, fix: "tuple | None", codes: tuple, out: bytearray) -> None:
    """A length header: ``fix`` = (base, limit) of the fix form, ``codes`` the
    8/16/32-bit forms' type bytes (None where the type has no such form)."""
    if fix is not None and n < fix[1]:
        out.append(fix[0] | n)
        return
    for lim, code, fmt in ((0xFF, codes[0], ">B"), (0xFFFF, codes[1], ">H"),
                           (0xFFFFFFFF, codes[2], ">I")):
        if code is not None and n <= lim:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack object of length {n} is too large")


def _pack_str(s: str, out: bytearray) -> None:
    b = s.encode("utf-8")
    _pack_len(len(b), (0xA0, 32), (0xD9, 0xDA, 0xDB), out)
    out += b


def _pack_bin(b: bytes, out: bytearray) -> None:
    _pack_len(len(b), None, (0xC4, 0xC5, 0xC6), out)
    out += b


def _pack_ext(code: int, data: bytes, out: bytearray) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixed:
        out.append(fixed[len(data)])
    else:
        _pack_len(len(data), None, (0xC7, 0xC8, 0xC9), out)
    out += struct.pack(">b", code)
    out += data


def _ndarray_bytes(arr: np.ndarray) -> bytes:
    """flax's ``_ndarray_to_bytes``: packb((shape, dtype name, bytes))."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be serialized")
    out = bytearray([0x93])  # the 3-tuple
    _pack_len(arr.ndim, (0x90, 16), (None, 0xDC, 0xDD), out)
    for d in arr.shape:
        _pack_int(int(d), out)
    _pack_str(arr.dtype.name, out)
    _pack_bin(arr.tobytes("C"), out)
    return bytes(out)


def _pack(v: Any, out: bytearray) -> None:
    # exact types, as msgpack's strict_types: a subclass takes the ext path
    t = type(v)
    if v is None:
        out.append(0xC0)
    elif t is bool:
        out.append(0xC3 if v else 0xC2)
    elif t is int:
        _pack_int(v, out)
    elif t is float:
        out.append(0xCB)
        out += struct.pack(">d", v)
    elif t is str:
        _pack_str(v, out)
    elif t in (bytes, bytearray):
        _pack_bin(bytes(v), out)
    elif t is dict:
        _pack_len(len(v), (0x80, 16), (None, 0xDE, 0xDF), out)
        for k, x in v.items():
            _pack(k, out)
            _pack(x, out)
    elif t is list:
        _pack_len(len(v), (0x90, 16), (None, 0xDC, 0xDD), out)
        for x in v:
            _pack(x, out)
    elif isinstance(v, np.ndarray):
        _pack_ext(EXT_NDARRAY, _ndarray_bytes(v), out)
    elif isinstance(v, np.generic):
        _pack_ext(EXT_NPSCALAR, _ndarray_bytes(np.asarray(v)), out)
    else:
        raise TypeError(f"can not serialize {t.__name__!r} object")


def _chunk(arr: np.ndarray) -> dict:
    size = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    chunks = [flat[i: i + size] for i in range(0, flat.size, size)]
    return {CHUNKED: True, "shape": {str(i): d for i, d in enumerate(arr.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _chunk_leaves(tree: Any) -> Any:
    """Oversized arrays -> chunked maps, where flax chunks them: as the whole
    tree or as a value of a dict, not inside a list."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if isinstance(v, np.ndarray):
                out[k] = _chunk(v) if v.size * v.dtype.itemsize > MAX_CHUNK_SIZE else v
            elif isinstance(v, dict):
                out[k] = _chunk_leaves(v)
            else:
                out[k] = v
        return out
    if isinstance(tree, np.ndarray) and tree.size * tree.dtype.itemsize > MAX_CHUNK_SIZE:
        return _chunk(tree)
    return tree


def _sorted_keys(tree: Any) -> Any:
    """Every dict rebuilt in sorted key order, as flax's copy of the tree
    through ``jax.tree_util`` leaves it (chunk maps, made after, are not)."""
    if isinstance(tree, dict):
        return {k: _sorted_keys(tree[k]) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_sorted_keys(x) for x in tree]
    return tree


def msgpack_serialize(tree: Any) -> bytes:
    """The bytes ``flax.serialization.msgpack_serialize(tree)`` returns for a
    tree of dicts, lists, Python scalars and numpy arrays or scalars."""
    out = bytearray()
    _pack(_chunk_leaves(_sorted_keys(tree)), out)
    return bytes(out)


# -- reading ---------------------------------------------------------------


class _Reader:
    def __init__(self, data: bytes, raw: bool = False):
        self.buf = memoryview(data)
        self.pos = 0
        self.raw = raw  # str as bytes (flax reads the ndarray tuple so)

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos: self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str) -> Any:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int) -> Any:
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def ext(self, n: int) -> Any:
        code = self.unpack(">b")
        data = self.take(n)
        if code == EXT_NDARRAY:
            return _ndarray_from(data)
        if code == EXT_NPSCALAR:
            return _ndarray_from(data)[()]
        raise ValueError(f"unknown msgpack ext type {code}")

    def read(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map_(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.str_(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        scalars = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                   0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in scalars:
            return self.unpack(scalars[b])
        lens = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xC7: ">B", 0xC8: ">H", 0xC9: ">I",
                0xD9: ">B", 0xDA: ">H", 0xDB: ">I", 0xDC: ">H", 0xDD: ">I",
                0xDE: ">H", 0xDF: ">I"}
        if b in lens:
            n = self.unpack(lens[b])
            if b <= 0xC6:
                return bytes(self.take(n))
            if b <= 0xC9:
                return self.ext(n)
            if b <= 0xDB:
                return self.str_(n)
            if b <= 0xDD:
                return [self.read() for _ in range(n)]
            return self.map_(n)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        raise ValueError(f"invalid msgpack type byte 0x{b:02x}")

    def map_(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out


def _ndarray_from(data: memoryview) -> np.ndarray:
    shape, name, buf = _Reader(data, raw=True).read()
    if name == b"bfloat16":
        bits = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(name.decode())).reshape(shape, order="C")


def _unchunk(d: dict) -> np.ndarray:
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    return np.concatenate(chunks).reshape(shape)


def _unchunk_leaves(tree: Any) -> Any:
    if isinstance(tree, dict):
        if CHUNKED in tree:
            return _unchunk(tree)
        for k, v in tree.items():
            if isinstance(v, dict):
                tree[k] = _unchunk(v) if CHUNKED in v else _unchunk_leaves(v)
    return tree


def msgpack_restore(blob: bytes) -> Any:
    """The tree ``flax.serialization.msgpack_restore(blob)`` returns."""
    r = _Reader(blob)
    tree = r.read()
    if r.pos != len(r.buf):
        raise ValueError("trailing bytes after the msgpack object")
    return _unchunk_leaves(tree)
