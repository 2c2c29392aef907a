"""A msgpack decoder for the JAX package's checkpoints, in plain Python.

The JAX package writes ``flax.serialization.to_bytes({"step", "params",
"opt_state"})`` (tlsan_tpu/train/checkpoint.py): msgpack, with flax's
extension types for arrays.  Neither msgpack nor flax is a dependency of
the port (the card's machine has neither), so this module reads the
format itself:

  - nil, bool, integers, floats, str, bin, arrays and maps (the msgpack
    specification's types, big-endian);
  - flax's ext types (flax/serialization.py ``_MsgpackExtType``): 1 an
    ndarray, packed as the msgpack array (shape, dtype name, raw bytes,
    C order); 2 a Python complex, packed as (real, imag); 3 a numpy scalar,
    packed as a 0-d ndarray;
  - flax's chunked arrays: an array above flax's ``MAX_CHUNK_SIZE`` bytes is
    written as the map ``{"__msgpack_chunked_array__": True, "shape":
    {"0": ...}, "chunks": {"0": flat chunk, ...}}`` and is joined back.

`loads` gives the restored tree: dicts (flax writes lists and tuples as
maps keyed "0", "1", ...), numpy arrays and Python scalars.  Arrays are
copies, so they do not hold the input alive and are writable.  Only bytes
this program or the JAX package wrote should be read: it trusts the
sizes it is given no more than the input's length.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

# the marker of a chunked array's map (flax chunks arrays above
# flax/serialization.py's MAX_CHUNK_SIZE, 2**30 bytes)
CHUNKED = "__msgpack_chunked_array__"

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3

# first byte → value (nil, false, true), or → the struct format of what
# follows: a bin's or str's length, a number, an ext's length, an array's
# or map's entry count
_CONSTANTS = {0xc0: None, 0xc2: False, 0xc3: True}
_BIN = {0xc4: ">B", 0xc5: ">H", 0xc6: ">I"}
_NUMBERS = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I",
            0xcf: ">Q", 0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
_EXT = {0xc7: ">B", 0xc8: ">H", 0xc9: ">I"}
_STR = {0xd9: ">B", 0xda: ">H", 0xdb: ">I"}
_ARRAY = {0xdc: ">H", 0xdd: ">I"}
_MAP = {0xde: ">H", 0xdf: ">I"}


class MsgpackError(ValueError):
    """The bytes are not the msgpack this decoder reads."""


def _ndarray(data: bytes) -> np.ndarray:
    shape, dtype, buffer = _Reader(data).read()
    if isinstance(dtype, bytes):
        dtype = dtype.decode()
    if dtype == "bfloat16":  # not a numpy type: widen it exactly to f32
        bits = np.frombuffer(buffer, "<u2").astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buffer, np.dtype(dtype)).reshape(shape).copy()


def _ext(code: int, data: bytes) -> Any:
    if code == EXT_NDARRAY:
        return _ndarray(data)
    if code == EXT_COMPLEX:
        real, imag = _Reader(data).read()
        return complex(real, imag)
    if code == EXT_NPSCALAR:
        return _ndarray(data)[()]
    raise MsgpackError(f"unknown msgpack ext type {code}")


class _Reader:
    """One pass over `data`, a value at a time."""

    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def _take(self, n: int) -> memoryview:
        if n < 0 or self.pos + n > len(self.data):
            raise MsgpackError(f"msgpack data ends early: {n} bytes wanted at "
                               f"offset {self.pos} of {len(self.data)}")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def _unpack(self, fmt: str) -> Tuple:
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))

    def read(self) -> Any:
        (b,) = self._take(1)
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self._map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return self._array(b & 0x0f)
        if 0xa0 <= b <= 0xbf:
            return self._str(b & 0x1f)
        if b in _CONSTANTS:
            return _CONSTANTS[b]
        if b in _NUMBERS:
            return self._unpack(_NUMBERS[b])[0]
        if b in _BIN:
            return bytes(self._take(self._unpack(_BIN[b])[0]))
        if b in _STR:
            return self._str(self._unpack(_STR[b])[0])
        if b in _ARRAY:
            return self._array(self._unpack(_ARRAY[b])[0])
        if b in _MAP:
            return self._map(self._unpack(_MAP[b])[0])
        if 0xd4 <= b <= 0xd8 or b in _EXT:  # fixext 1, 2, 4, 8, 16; ext 8/16/32
            n = 1 << (b - 0xd4) if b >= 0xd4 else self._unpack(_EXT[b])[0]
            (code,) = self._unpack(">b")
            return _ext(code, bytes(self._take(n)))
        raise MsgpackError(f"byte 0x{b:02x} at offset {self.pos - 1} starts no "
                           "msgpack value")

    def _str(self, n: int) -> str:
        return bytes(self._take(n)).decode("utf-8")

    def _array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out


def _unchunk(tree: Any) -> Any:
    """flax's chunked arrays (`CHUNKED` maps) joined back into arrays."""
    if not isinstance(tree, dict):
        return tree
    if tree.get(CHUNKED) is True:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def loads(data: bytes) -> Any:
    """The tree `flax.serialization.msgpack_restore` gives for `data`."""
    reader = _Reader(data)
    tree = reader.read()
    if reader.pos != len(reader.data):
        raise MsgpackError(f"{len(reader.data) - reader.pos} bytes after the "
                           "msgpack value")
    return _unchunk(tree)
