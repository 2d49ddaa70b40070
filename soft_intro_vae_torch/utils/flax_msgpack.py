"""A reader of the JAX package's checkpoint files: flax msgpack, decoded here.

The JAX package writes its checkpoints with ``flax.serialization.to_bytes``
(soft_intro_vae_tpu/utils/checkpoint.py:59-84): msgpack of the state pytree
as nested maps, with flax's extension types for arrays. The card's machine
has no ``msgpack``, ``flax`` or ``jax``, so this module decodes the bytes
itself, in Python and numpy, and returns what ``flax.serialization.
msgpack_restore`` returns: nested dicts whose leaves are numpy arrays and
scalars, Python ints, floats, strings, bytes, bools, complex numbers and None.

Covered, as flax 0.12 writes them:

  * every msgpack type: maps, arrays (as lists), str, bin, ints of every
    width, float32/float64, bool, nil;
  * flax's extension types (``serialization._MsgpackExtType``): ``ndarray``
    (1: a msgpack ``(shape, dtype name, C-order bytes)``), ``native_complex``
    (2: a msgpack ``(real, imag)``) and ``npscalar`` (3: an ndarray of shape
    (), returned as a numpy scalar);
  * leaves above ``MAX_CHUNK_SIZE`` (2**30 bytes), which flax writes as maps
    marked ``'__msgpack_chunked_array__'`` holding the shape and the flat
    chunks: they come back as one array of that shape.

numpy on the card has no ``ml_dtypes``: a ``bfloat16`` leaf is decoded as
its uint16 words and returned as a ``torch.bfloat16`` tensor (a 0-dim one
for a bfloat16 scalar). Arrays are read-only views of the file's bytes; copy
one to write to it.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np
import torch

EXT_NDARRAY, EXT_NATIVE_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED = "__msgpack_chunked_array__"


class FormatError(ValueError):
    """The bytes are not msgpack as flax writes it."""


def is_msgpack_map(head: bytes) -> bool:
    """True where ``head`` (a file's first bytes) opens a msgpack map of at
    least one entry, as every flax checkpoint does (fixmap 0x81-0x8f, map16
    0xde, map32 0xdf). An empty fixmap (0x80) is left out: it is also the
    first byte of a pickle, and a checkpoint is never empty."""
    return bool(head) and (0x81 <= head[0] <= 0x8F or head[0] in (0xDE, 0xDF))


def _array(shape, dtype_name: str, data: memoryview):
    shape = tuple(int(d) for d in shape)
    if dtype_name == "bfloat16":
        words = np.frombuffer(data, dtype="<u2").reshape(shape)
        return torch.from_numpy(words.copy()).view(torch.bfloat16)
    try:
        dtype = np.dtype(dtype_name)
    except TypeError as e:
        raise FormatError(f"an array of dtype {dtype_name!r}, which numpy does not know") from e
    if dtype.hasobject:
        raise FormatError(f"an array of dtype {dtype_name!r}: flax writes no object arrays")
    count = int(np.prod(shape, dtype=np.int64))
    if count * dtype.itemsize != len(data):
        raise FormatError(f"an array of shape {shape} and dtype {dtype_name} holds "
                          f"{len(data)} bytes")
    return np.frombuffer(data, dtype=dtype).reshape(shape)


# msgpack's fixed-size values and sized objects by first byte: struct formats,
# and for sized objects the format of their length and what they hold
_CONSTANTS = {0xC0: None, 0xC2: False, 0xC3: True}
_NUMBERS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_SIZED = {0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
          0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
          0xDC: (">H", "list"), 0xDD: (">I", "list"), 0xDE: (">H", "map"), 0xDF: (">I", "map")}
_EXT_SIZES = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}


class _Reader:
    """One pass over a msgpack buffer."""

    def __init__(self, data):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise FormatError(f"the data ends at byte {len(self.buf)}, inside an object "
                              f"that needs {end}")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b <= 0x8F:
            return self.map(b & 0x0F)
        if b <= 0x9F:
            return self.list(b & 0x0F)
        if b <= 0xBF:
            return self.str(b & 0x1F)
        if b in _CONSTANTS:
            return _CONSTANTS[b]
        if b in _NUMBERS:
            return self.unpack(_NUMBERS[b])
        if b in _SIZED:
            fmt, kind = _SIZED[b]
            n = self.unpack(fmt)
            return bytes(self.take(n)) if kind == "bin" else getattr(self, kind)(n)
        if b in _EXT_SIZES:  # ext 8/16/32: length, then the type
            n = self.unpack(_EXT_SIZES[b])
            return self.ext(self.unpack(">b"), self.take(n))
        if 0xD4 <= b <= 0xD8:  # fixext 1/2/4/8/16
            code = self.unpack(">b")
            return self.ext(code, self.take(1 << (b - 0xD4)))
        raise FormatError(f"byte 0x{b:02x} at offset {self.pos - 1} begins no msgpack object")

    def str(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def list(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    def bin_view(self) -> memoryview:
        """A bin object's bytes as a view of the buffer (an array's data: no copy)."""
        b = self.unpack(">B")
        if b not in (0xC4, 0xC5, 0xC6):
            raise FormatError(f"byte 0x{b:02x} where an array's bytes (msgpack bin) belong")
        return self.take(self.unpack(_SIZED[b][0]))

    def ext(self, code: int, data: memoryview) -> Any:
        if code == EXT_NATIVE_COMPLEX:
            real, imag = _Reader(data).whole()
            return complex(real, imag)
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise FormatError(f"msgpack extension type {code}, which flax does not write")
        r = _Reader(data)
        if r.unpack(">B") != 0x93:  # a fixarray of 3
            raise FormatError("an array extension that is not (shape, dtype, bytes)")
        shape, name, raw = r.read(), r.read(), r.bin_view()
        if r.pos != len(r.buf) or not isinstance(shape, list) or not isinstance(name, str):
            raise FormatError("an array extension that is not (shape, dtype, bytes)")
        arr = _array(shape, name, raw)
        if code == EXT_NPSCALAR:
            return arr.reshape(()) if isinstance(arr, torch.Tensor) else arr[()]
        return arr

    def whole(self) -> Any:
        out = self.read()
        if self.pos != len(self.buf):
            raise FormatError(f"{len(self.buf) - self.pos} bytes after the first msgpack "
                              f"object, which ends at byte {self.pos}")
        return out


def _indexed(d: dict) -> Tuple:
    """flax's ``_dict_to_tuple``: a map keyed "0", "1", ... as a tuple."""
    return tuple(d[str(i)] for i in range(len(d)))


def _unchunk(d: dict):
    shape = tuple(int(n) for n in _indexed(d["shape"]))
    chunks = _indexed(d["chunks"])
    if chunks and isinstance(chunks[0], torch.Tensor):
        return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)
    return np.concatenate([np.asarray(c).reshape(-1) for c in chunks]).reshape(shape)


def _restore_chunks(tree: Any) -> Any:
    """Chunked leaves (maps marked ``CHUNKED``) back to arrays, as flax's
    ``_unchunk_array_leaves_in_place`` does, at any depth."""
    if isinstance(tree, dict):
        if CHUNKED in tree:
            return _unchunk(tree)
        return {k: _restore_chunks(v) for k, v in tree.items()}
    return tree


def loads(data) -> Any:
    """The tree that ``flax.serialization.msgpack_restore(data)`` returns."""
    return _restore_chunks(_Reader(data).whole())


def load(path: str) -> Any:
    """``loads`` of a file's bytes."""
    with open(path, "rb") as f:
        return loads(f.read())
