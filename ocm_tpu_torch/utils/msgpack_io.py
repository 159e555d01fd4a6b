"""The msgpack file format of the JAX package's model files, read and
written with the standard library and numpy alone.

``ocm_tpu`` persists its models with flax's ``msgpack_serialize`` /
``msgpack_restore`` (flax 0.12.3, ``flax/serialization.py``), which is
plain msgpack with two extension types:

- ext 1, an ndarray: the msgpack of ``(shape, dtype name, C-order
  bytes)``;
- ext 3, a numpy scalar: the same encoding of the 0-d array.

Arrays above ``MAX_CHUNK_SIZE`` bytes that are values of a map are written
as ``{"__msgpack_chunked_array__": True, "shape": {"0": ..}, "chunks":
{"0": flat chunk, ..}}``.  This module reads and writes that subset: maps,
str, bin, int, float, bool, nil, arrays (lists and tuples), ext 1 and ext
3, each encoded as msgpack-python packs it with ``use_bin_type=True`` and
``strict_types=True``, so that a tree written here is byte-equal to the
one flax writes.  A dtype outside numpy's own (flax's ``bfloat16``) raises.
"""

from __future__ import annotations

import struct

import numpy as np

# flax's limit: arrays larger than this many bytes are written in chunks
MAX_CHUNK_SIZE = 2 ** 30
_CHUNKED = "__msgpack_chunked_array__"
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3

# the dtypes numpy itself names (flax also writes bfloat16, through
# ml_dtypes; that name is refused even where another import registered it)
_DTYPES = {np.dtype(t).name: np.dtype(t) for t in (
    np.bool_, np.int8, np.int16, np.int32, np.int64, np.uint8, np.uint16,
    np.uint32, np.uint64, np.float16, np.float32, np.float64, np.complex64,
    np.complex128)}


# --- writing ----------------------------------------------------------------

def _pack_int(v: int, out: bytearray):
    if 0 <= v < 0x80 or -32 <= v < 0:
        out += struct.pack(">b" if v < 0 else ">B", v)
    elif v >= 0:
        for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                               (0xCE, ">I", 0xFFFFFFFF),
                               (0xCF, ">Q", 2 ** 64 - 1)):
            if v <= top:
                out += bytes([code]) + struct.pack(fmt, v)
                return
        raise OverflowError(f"int {v} does not fit in msgpack's uint64")
    else:
        for code, fmt, low in ((0xD0, ">b", -2 ** 7), (0xD1, ">h", -2 ** 15),
                               (0xD2, ">i", -2 ** 31), (0xD3, ">q", -2 ** 63)):
            if v >= low:
                out += bytes([code]) + struct.pack(fmt, v)
                return
        raise OverflowError(f"int {v} does not fit in msgpack's int64")


def _pack_len(n: int, fix_code, fix_max, codes, out: bytearray):
    """A length header: the fix form below ``fix_max``, else the first of
    ``codes`` ((code, struct format, largest length)) that holds ``n``."""
    if fix_code is not None and n < fix_max:
        out.append(fix_code | n)
        return
    for code, fmt, top in codes:
        if n <= top:
            out += bytes([code]) + struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack object of length {n} is too long")


_STR = ((0xD9, ">B", 0xFF), (0xDA, ">H", 0xFFFF), (0xDB, ">I", 0xFFFFFFFF))
_BIN = ((0xC4, ">B", 0xFF), (0xC5, ">H", 0xFFFF), (0xC6, ">I", 0xFFFFFFFF))
_ARR = ((0xDC, ">H", 0xFFFF), (0xDD, ">I", 0xFFFFFFFF))
_MAP = ((0xDE, ">H", 0xFFFF), (0xDF, ">I", 0xFFFFFFFF))
_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
_EXT = ((0xC7, ">B", 0xFF), (0xC8, ">H", 0xFFFF), (0xC9, ">I", 0xFFFFFFFF))


def _ndarray_bytes(arr: np.ndarray) -> bytes:
    if arr.dtype.name not in _DTYPES:
        raise ValueError(f"cannot write an array of dtype {arr.dtype.name!r}:"
                         f" this writer maps only {sorted(_DTYPES)}")
    out = bytearray()
    _pack((tuple(int(d) for d in arr.shape), arr.dtype.name,
           arr.tobytes("C")), out)
    return bytes(out)


def _pack_ext(code: int, data: bytes, out: bytearray):
    if len(data) in _FIXEXT:
        out.append(_FIXEXT[len(data)])
    else:
        _pack_len(len(data), None, 0, _EXT, out)
    out += struct.pack(">b", code) + data


def _pack(v, out: bytearray):
    t = type(v)
    if v is None:
        out.append(0xC0)
    elif t is bool:
        out.append(0xC3 if v else 0xC2)
    elif t is int:
        _pack_int(v, out)
    elif t is float:
        out += b"\xcb" + struct.pack(">d", v)
    elif t is str:
        b = v.encode("utf-8")
        _pack_len(len(b), 0xA0, 32, _STR, out)
        out += b
    elif t is bytes:
        _pack_len(len(v), None, 0, _BIN, out)
        out += v
    elif t in (list, tuple):
        _pack_len(len(v), 0x90, 16, _ARR, out)
        for item in v:
            _pack(item, out)
    elif t is dict:
        _pack_len(len(v), 0x80, 16, _MAP, out)
        for key, item in v.items():
            _pack(key, out)
            _pack(item, out)
    elif isinstance(v, np.ndarray):
        _pack_ext(_EXT_NDARRAY, _ndarray_bytes(v), out)
    elif isinstance(v, np.generic):
        _pack_ext(_EXT_NPSCALAR, _ndarray_bytes(np.asarray(v)), out)
    else:
        raise TypeError(f"cannot write an object of type {t.__name__}")


def _chunk(arr: np.ndarray) -> dict:
    size = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    return {_CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(arr.shape)},
            "chunks": {str(i): flat[s:s + size] for i, s in
                       enumerate(range(0, flat.size, size))}}


def _big(v) -> bool:
    return isinstance(v, np.ndarray) and v.size * v.dtype.itemsize > \
        MAX_CHUNK_SIZE


def _chunk_leaves(tree):
    """flax's ``_chunk_array_leaves_in_place`` on a copy: oversized arrays
    that are the tree itself or values of (nested) maps go in chunks."""
    if isinstance(tree, dict):
        return {k: _chunk(v) if _big(v) else _chunk_leaves(v)
                if isinstance(v, dict) else v for k, v in tree.items()}
    return _chunk(tree) if _big(tree) else tree


def _sorted(tree):
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    if type(tree) in (list, tuple):
        return type(tree)(_sorted(v) for v in tree)
    return tree


def serialize(tree, sort_keys: bool = True) -> bytes:
    """flax's ``msgpack_serialize(tree)`` (maps in sorted key order, as
    JAX's ``tree_map`` rebuilds them), or with ``sort_keys=False`` its
    ``to_bytes(tree)`` (maps in insertion order); oversized arrays in
    chunks."""
    out = bytearray()
    _pack(_chunk_leaves(_sorted(tree) if sort_keys else tree), out)
    return bytes(out)


# --- reading ----------------------------------------------------------------

def _dtype(name: bytes) -> np.dtype:
    text = name.decode("utf-8")
    if text not in _DTYPES:
        raise ValueError(f"cannot read an array of dtype {text!r}: this "
                         f"reader maps only {sorted(_DTYPES)}")
    return _DTYPES[text]


def _ndarray(data: bytes) -> np.ndarray:
    shape, name, buf = _Reader(data, raw=True).read_all()
    return np.frombuffer(buf, dtype=_dtype(name)).reshape(shape,
                                                          order="C").copy()


class _Reader:
    """A msgpack decoder over one buffer; ``raw`` leaves str as bytes."""

    def __init__(self, data: bytes, raw: bool = False):
        self.data, self.pos, self.raw = memoryview(data), 0, raw

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        b = self.data[self.pos:self.pos + n].tobytes()
        self.pos += n
        return b

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read_all(self):
        v = self.read()
        if self.pos != len(self.data):
            raise ValueError("extra bytes after the msgpack object")
        return v

    def _str(self, n):
        b = self.take(n)
        return b if self.raw else b.decode("utf-8")

    def _ext(self, n):
        code = self.unpack(">b")
        data = self.take(n)
        if code == _EXT_NDARRAY:
            return _ndarray(data)
        if code == _EXT_NPSCALAR:
            return _ndarray(data)[()]
        raise ValueError(f"unsupported msgpack extension type {code}")

    def read(self):
        c = self.take(1)[0]
        if c < 0x80:
            return c
        if c >= 0xE0:
            return c - 0x100
        if 0x80 <= c <= 0x8F:
            return self._map(c & 0x0F)
        if 0x90 <= c <= 0x9F:
            return [self.read() for _ in range(c & 0x0F)]
        if 0xA0 <= c <= 0xBF:
            return self._str(c & 0x1F)
        if c == 0xC0:
            return None
        if c in (0xC2, 0xC3):
            return c == 0xC3
        fixed = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if c in fixed:
            return self.unpack(fixed[c])
        lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xC7: ">B",
                   0xC8: ">H", 0xC9: ">I", 0xD9: ">B", 0xDA: ">H",
                   0xDB: ">I", 0xDC: ">H", 0xDD: ">I", 0xDE: ">H",
                   0xDF: ">I"}
        if c in _FIXEXT.values():
            return self._ext({v: k for k, v in _FIXEXT.items()}[c])
        if c not in lengths:
            raise ValueError(f"unsupported msgpack type byte 0x{c:02x}")
        n = self.unpack(lengths[c])
        if c <= 0xC6:
            return self.take(n)
        if c <= 0xC9:
            return self._ext(n)
        if c <= 0xDB:
            return self._str(n)
        if c <= 0xDD:
            return [self.read() for _ in range(n)]
        return self._map(n)

    def _map(self, n):
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out


def _unchunk_leaves(tree):
    """flax's ``_unchunk_array_leaves_in_place``."""
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk_leaves(v) for k, v in tree.items()}


def restore(data: bytes):
    """flax's ``msgpack_restore(data)``: numpy arrays (writable copies,
    where flax gives read-only views of the buffer), chunked arrays
    joined."""
    return _unchunk_leaves(_Reader(data).read_all())


def save(path, tree, sort_keys: bool = True) -> None:
    """Write ``tree`` (dicts of numpy arrays) to ``path`` as flax would
    (``serialize``)."""
    data = serialize(tree, sort_keys)
    with open(path, "wb") as fh:
        fh.write(data)


def load(path):
    """The tree of a file written by ``save`` or by flax."""
    with open(path, "rb") as fh:
        return restore(fh.read())
