"""Flax's msgpack parameter files, read and written without msgpack or flax.

``to_bytes`` writes what ``flax.serialization.to_bytes`` writes for a tree of
nested dicts (lists and tuples become dicts keyed "0", "1", ...) with array
leaves, byte for byte; ``from_bytes`` reads what ``msgpack_restore`` reads.
The subset of msgpack that flax uses: maps, arrays, str, bin, ints, floats,
nil and bools, and two extension types: 1, an ndarray (a packed
``(shape, dtype name, C-order bytes)``), and 3, a numpy scalar (the same,
shape ``()``). Flax splits a leaf of more than ``MAX_CHUNK_SIZE`` bytes into a
``{"__msgpack_chunked_array__": True, "shape": ..., "chunks": ...}`` dict;
the writer does the same and the reader joins them.

The scripts' ``.msgpack`` files (``scripts/export_params.py`` in both
packages) hold the JAX parameter tree, ``{"params": {...}}`` with f32 leaves.
"""

from __future__ import annotations

import struct
from typing import Any, Mapping

import numpy as np
import torch

MAX_CHUNK_SIZE = 2 ** 30  # flax.serialization.MAX_CHUNK_SIZE
CHUNKED = "__msgpack_chunked_array__"
EXT_NDARRAY, EXT_NPSCALAR = 1, 3


# ---------------------------------------------------------------------------
# Writing
# ---------------------------------------------------------------------------


def _state_dict(tree):
    """flax ``to_state_dict``: dicts keep their order with str keys, lists
    and tuples become dicts keyed by position; tensors become numpy."""
    if isinstance(tree, Mapping):
        if len({str(k) for k in tree}) != len(tree):
            raise ValueError(f"dict keys have no unique string form: {list(tree)}")
        return {str(k): _state_dict(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): _state_dict(v) for i, v in enumerate(tree)}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


def _chunk(arr: np.ndarray) -> dict:
    size = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    return {CHUNKED: True, "shape": {str(i): d for i, d in enumerate(arr.shape)},
            "chunks": {str(i): flat[j:j + size]
                       for i, j in enumerate(range(0, flat.size, size))}}


def _chunk_leaves(tree):
    if isinstance(tree, dict):
        return {k: _chunk_leaves(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray) and tree.size * tree.dtype.itemsize > MAX_CHUNK_SIZE:
        return _chunk(tree)
    return tree


def _header(out, n, fix_base, fix_max, codes):
    """A length header: fix form below ``fix_max``, else 8/16/32-bit lengths."""
    if n < fix_max:
        out.append(fix_base | n)
        return
    for code, fmt, limit in codes:
        if limit is None or n < limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"length {n} too large for msgpack")


def _pack_int(out, v: int):
    if v > 0:
        if v < 128:
            out.append(v)
        elif v < 2 ** 8:
            out += b"\xcc" + struct.pack(">B", v)
        elif v < 2 ** 16:
            out += b"\xcd" + struct.pack(">H", v)
        elif v < 2 ** 32:
            out += b"\xce" + struct.pack(">I", v)
        else:
            out += b"\xcf" + struct.pack(">Q", v)
    elif v >= -32:
        out += struct.pack(">b", v)
    elif v >= -2 ** 7:
        out += b"\xd0" + struct.pack(">b", v)
    elif v >= -2 ** 15:
        out += b"\xd1" + struct.pack(">h", v)
    elif v >= -2 ** 31:
        out += b"\xd2" + struct.pack(">i", v)
    else:
        out += b"\xd3" + struct.pack(">q", v)


def _pack_str(out, s: str):
    b = s.encode("utf-8")
    _header(out, len(b), 0xA0, 32, ((0xD9, ">B", 2 ** 8), (0xDA, ">H", 2 ** 16),
                                    (0xDB, ">I", None)))
    out += b


def _pack_bin(out, b: bytes):
    _header(out, len(b), 0, 0, ((0xC4, ">B", 2 ** 8), (0xC5, ">H", 2 ** 16), (0xC6, ">I", None)))
    out += b


def _pack_ext(out, code: int, data: bytes):
    n = len(data)
    if n in _FIXEXT_BY_SIZE:
        out.append(_FIXEXT_BY_SIZE[n])
    else:
        _header(out, n, 0, 0, ((0xC7, ">B", 2 ** 8), (0xC8, ">H", 2 ** 16), (0xC9, ">I", None)))
    out.append(code)
    out += data


def _ndarray_bytes(arr: np.ndarray) -> bytes:
    """flax ``_ndarray_to_bytes``: msgpack of (shape, dtype name, C bytes)."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be serialised")
    out = bytearray()
    _pack(out, [list(arr.shape), arr.dtype.name, arr.tobytes("C")])
    return bytes(out)


def _pack(out, obj):
    # The order of the tests is msgpack's with strict_types: numpy scalars
    # (float and int subclasses) are extension values, not floats and ints.
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, np.ndarray):
        _pack_ext(out, EXT_NDARRAY, _ndarray_bytes(obj))
    elif isinstance(obj, np.generic):
        _pack_ext(out, EXT_NPSCALAR, _ndarray_bytes(np.asarray(obj)))
    elif type(obj) is int:
        _pack_int(out, obj)
    elif type(obj) is float:
        out += b"\xcb" + struct.pack(">d", obj)
    elif type(obj) is str:
        _pack_str(out, obj)
    elif type(obj) is bytes:
        _pack_bin(out, obj)
    elif type(obj) is dict:
        _header(out, len(obj), 0x80, 16, ((0xDE, ">H", 2 ** 16), (0xDF, ">I", None)))
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    elif type(obj) is list:
        _header(out, len(obj), 0x90, 16, ((0xDC, ">H", 2 ** 16), (0xDD, ">I", None)))
        for v in obj:
            _pack(out, v)
    else:
        raise TypeError(f"cannot serialise {type(obj).__name__} to msgpack")


def to_bytes(tree) -> bytes:
    """``flax.serialization.to_bytes(tree)`` for nested dicts, lists and
    tuples with numpy, tensor or Python scalar leaves."""
    out = bytearray()
    _pack(out, _chunk_leaves(_state_dict(tree)))
    return bytes(out)


# ---------------------------------------------------------------------------
# Reading
# ---------------------------------------------------------------------------


# Type bytes with a fixed meaning, and those followed by a big-endian length
# or value of the given struct format.
_CONSTANTS = {0xC0: None, 0xC2: False, 0xC3: True}
_NUMBERS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_BIN = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
_STR = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
_ARRAY = {0xDC: ">H", 0xDD: ">I"}
_MAP = {0xDE: ">H", 0xDF: ">I"}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
_FIXEXT_BY_SIZE = {size: code for code, size in _FIXEXT.items()}
_EXT = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError(f"truncated msgpack data: {n} bytes wanted at offset {self.pos} "
                             f"of {len(self.data)}")
        view = self.data[self.pos:self.pos + n]
        self.pos += n
        return view

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        if b in _CONSTANTS:
            return _CONSTANTS[b]
        if b in _NUMBERS:
            return self.unpack(_NUMBERS[b])
        if b in _BIN:
            return bytes(self.take(self.unpack(_BIN[b])))
        if b in _STR:
            return str(self.take(self.unpack(_STR[b])), "utf-8")
        if b in _ARRAY:
            return [self.value() for _ in range(self.unpack(_ARRAY[b]))]
        if b in _MAP:
            return self.map(self.unpack(_MAP[b]))
        if b in _FIXEXT:
            return self.ext(_FIXEXT[b])
        if b in _EXT:
            return self.ext(self.unpack(_EXT[b]))
        raise ValueError(f"msgpack type byte 0x{b:02x} at offset {self.pos - 1} is not one "
                         "flax writes")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, n: int):
        code = self.unpack(">B")
        data = bytes(self.take(n))
        if code == EXT_NDARRAY:
            return _ndarray_from_bytes(data)
        if code == EXT_NPSCALAR:
            return _ndarray_from_bytes(data)[()]
        raise ValueError(f"msgpack extension type {code} is not one this reader takes "
                         "(1: ndarray, 3: numpy scalar)")


def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    shape, name, buf = _loads(data)
    try:
        dtype = np.dtype(name)
    except TypeError:
        raise ValueError(f"array dtype {name!r} is not one numpy has") from None
    return np.frombuffer(buf, dtype=dtype).reshape(shape)


def _loads(data: bytes):
    r = _Reader(data)
    value = r.value()
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} bytes of extra data after the msgpack value")
    return value



def _unchunk(tree):
    if isinstance(tree, dict):
        if tree.get(CHUNKED) is True:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def from_bytes(data: bytes):
    """``flax.serialization.msgpack_restore(data)``: the tree of dicts with
    numpy leaves (chunked leaves joined). Raises on truncated data."""
    return _unchunk(_loads(bytes(data)))
