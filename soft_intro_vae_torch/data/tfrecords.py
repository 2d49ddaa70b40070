"""TFRecord shards: writer, CRC32C and reader (port of data/tfrecords.py).

The reference's style variant reads per-LOD TFRecord shards through the
DareBlopy C++ package (style_soft_intro_vae/dataloader.py:16,73-102) with
per-rank shard assignment (:53-67). The port's native layer is its own copy
of the JAX package's C++ reader (``native/tfrecord_reader.cpp``: TFRecord
framing, CRC32C and a minimal tf.Example parser), built with ``g++`` at first
use into ``soft_intro_vae_torch/_build/`` by ``ops/cuda_build.py`` (a name
keyed by a hash of the source and flags, renamed into place atomically) and
loaded with ``ctypes``.

The reader takes ``impl="native" | "python"``, as the kernel wrappers take
``impl=``. ``native`` is the default, and a failed build raises with the
compiler's output: there is no quiet fallback to Python (the JAX package
falls back). ``python`` is the plain reference the native reader is held
to: the same records, the same examples, and a CRC mismatch raises in both.
The writer needs no TensorFlow and computes its CRCs with the native
library; its files are byte for byte the JAX package's.
"""

from __future__ import annotations

import ctypes
import os
import struct
import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

NATIVE_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "native", "tfrecord_reader.cpp")
IMPLS = ("native", "python")

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def _check_impl(impl: str) -> str:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    return impl


def _declare(lib: ctypes.CDLL) -> None:
    lib.tfr_open.restype = ctypes.c_void_p
    lib.tfr_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.tfr_close.argtypes = [ctypes.c_void_p]
    lib.tfr_next.restype = ctypes.c_long
    lib.tfr_next.argtypes = [ctypes.c_void_p]
    lib.tfr_record_data.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.tfr_record_data.argtypes = [ctypes.c_void_p]
    lib.tfr_feature_bytes.restype = ctypes.c_long
    lib.tfr_feature_bytes.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                      ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))]
    lib.tfr_feature_int64s.restype = ctypes.c_int
    lib.tfr_feature_int64s.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                       ctypes.POINTER(ctypes.c_int64), ctypes.c_int]
    lib.tfr_masked_crc.restype = ctypes.c_uint32
    lib.tfr_masked_crc.argtypes = [ctypes.c_char_p, ctypes.c_size_t]


def native_library() -> ctypes.CDLL:
    """The native reader, built on first use; raises if it cannot be built."""
    global _lib
    with _lib_lock:
        if _lib is None:
            from soft_intro_vae_torch.ops import cuda_build

            lib = ctypes.CDLL(cuda_build.build_host_library(NATIVE_SRC, "tfrecord"))
            _declare(lib)
            _lib = lib
        return _lib


# ------------------------------------------------------------------ CRC32C --
def _crc32c_table() -> List[int]:
    poly = 0x82F63B78  # Castagnoli, reflected
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (poly ^ (c >> 1)) if (c & 1) else (c >> 1)
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    c = 0xFFFFFFFF
    for b in data:
        c = _CRC_TABLE[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def masked_crc(data: bytes, impl: str = "python") -> int:
    """TFRecord's masked CRC32C of ``data``."""
    if _check_impl(impl) == "native":
        return int(native_library().tfr_masked_crc(bytes(data), len(data)))
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------------------------ writer --
def _varint(v: int) -> bytes:
    out = b""
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _len_delim(field: int, payload: bytes) -> bytes:
    return _varint((field << 3) | 2) + _varint(len(payload)) + payload


def make_example(features: Dict[str, object]) -> bytes:
    """Serialize a tf.Example with bytes / int64-list features (no TF)."""
    entries = b""
    for key, val in features.items():
        if isinstance(val, (bytes, bytearray)):
            bl = _len_delim(1, bytes(val))           # BytesList.value
            feat = _len_delim(1, bl)                 # Feature.bytes_list
        else:
            ints = b"".join(_varint(int(v) & 0xFFFFFFFFFFFFFFFF) for v in val)
            il = _len_delim(1, ints)                 # Int64List.value (packed)
            feat = _len_delim(3, il)                 # Feature.int64_list
        entry = _len_delim(1, key.encode()) + _len_delim(2, feat)
        entries += _len_delim(1, entry)              # Features.feature map entry
    return _len_delim(1, entries)                    # Example.features


class TFRecordWriter:
    """Incremental TFRecord writer (context manager): dataset preparation
    streams arbitrarily large folders at constant memory. The CRCs come from
    the native library, built before the file is opened."""

    def __init__(self, path: str):
        self.path = path
        native_library()
        self._f = open(path, "wb")
        self.count = 0

    def write(self, record: bytes):
        header = struct.pack("<Q", len(record))
        self._f.write(header)
        self._f.write(struct.pack("<I", masked_crc(header, "native")))
        self._f.write(record)
        self._f.write(struct.pack("<I", masked_crc(record, "native")))
        self.count += 1

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_tfrecord(path: str, examples: Sequence[bytes]):
    with TFRecordWriter(path) as w:
        for ex in examples:
            w.write(ex)


# ------------------------------------------------------------------ reader --
class TFRecordFile:
    """Iterate the records of one TFRecord shard, raw or as parsed examples.

    ``impl="native"`` reads through the C++ library, ``"python"`` through the
    plain parser below; both validate CRCs when ``check_crc``, raise
    ``IOError`` on a corrupt or truncated record, and end at a partial header.
    """

    def __init__(self, path: str, check_crc: bool = True, impl: str = "native"):
        self.path = path
        self.check_crc = check_crc
        self.impl = _check_impl(impl)

    def _native(self) -> Iterator[Tuple[ctypes.CDLL, int, int]]:
        """(library, handle, record length) with the handle on each record."""
        lib = native_library()
        h = lib.tfr_open(self.path.encode(), int(self.check_crc))
        if not h:
            raise FileNotFoundError(self.path)
        try:
            while True:
                n = lib.tfr_next(h)
                if n == -1:
                    return
                if n == -2:
                    raise IOError(f"corrupt TFRecord: {self.path}")
                yield lib, h, n
        finally:
            lib.tfr_close(h)

    def records(self) -> Iterator[bytes]:
        if self.impl == "python":
            yield from self._records_py()
            return
        for lib, h, n in self._native():
            yield ctypes.string_at(lib.tfr_record_data(h), n)

    def _records_py(self) -> Iterator[bytes]:
        with open(self.path, "rb") as f:
            while True:
                header = f.read(12)
                if len(header) < 12:  # the end, as the native reader takes it
                    return
                (length,) = struct.unpack("<Q", header[:8])
                (len_crc,) = struct.unpack("<I", header[8:12])
                if self.check_crc and masked_crc(header[:8]) != len_crc:
                    raise IOError(f"corrupt TFRecord length: {self.path}")
                data = f.read(length)
                tail = f.read(4)
                if len(data) < length or len(tail) < 4:
                    raise IOError(f"corrupt TFRecord (truncated record): {self.path}")
                (data_crc,) = struct.unpack("<I", tail)
                if self.check_crc and masked_crc(data) != data_crc:
                    raise IOError(f"corrupt TFRecord data: {self.path}")
                yield data

    def _native_fields(self, bytes_key: str, shape_key: str, label_key: Optional[str]):
        out_ptr = ctypes.POINTER(ctypes.c_uint8)()
        ints = (ctypes.c_int64 * 8)()
        bkey, skey = bytes_key.encode(), shape_key.encode()
        lkey = label_key.encode() if label_key is not None else None
        for lib, h, _ in self._native():
            blen = lib.tfr_feature_bytes(h, bkey, ctypes.byref(out_ptr))
            data = ctypes.string_at(out_ptr, blen) if blen >= 0 else b""
            cnt = lib.tfr_feature_int64s(h, skey, ints, 8)
            shape = tuple(int(ints[i]) for i in range(cnt)) if cnt > 0 else None
            if lkey is None:
                yield data, shape
                continue
            lcnt = lib.tfr_feature_int64s(h, lkey, ints, 1)
            yield data, shape, (int(ints[0]) if lcnt > 0 else None)

    def examples(self, bytes_key: str = "data", shape_key: str = "shape"
                 ) -> Iterator[Tuple[bytes, Optional[Tuple[int, ...]]]]:
        """(data bytes, shape) of each tf.Example; shape None when absent."""
        if self.impl == "native":
            yield from self._native_fields(bytes_key, shape_key, None)
            return
        for rec in self._records_py():
            yield _parse_example_py(rec, bytes_key, shape_key)

    def examples_with_label(self, bytes_key: str = "data", shape_key: str = "shape",
                            label_key: str = "label"
                            ) -> Iterator[Tuple[bytes, Optional[Tuple[int, ...]], Optional[int]]]:
        """Like examples() but also yields the int64 ``label`` field (None
        when absent): the ImageNet needs_labels layout
        (style_soft_intro_vae/dataloader.py:205-213)."""
        if self.impl == "native":
            yield from self._native_fields(bytes_key, shape_key, label_key)
            return
        for rec in self._records_py():
            data, shape, labels = _parse_example_py(rec, bytes_key, shape_key, label_key)
            yield data, shape, (labels[0] if labels else None)


def _read_varint_py(buf: bytes, i: int) -> Tuple[int, int]:
    v = 0
    shift = 0
    while True:
        b = buf[i]
        i += 1
        v |= (b & 0x7F) << shift
        if not (b & 0x80):
            return v, i
        shift += 7


def _fields_py(buf: bytes) -> Iterator[Tuple[int, int, object, int]]:
    """Yield (field, wire_type, value, next_index) over a proto buffer."""
    i = 0
    n = len(buf)
    while i < n:
        tag, i = _read_varint_py(buf, i)
        field, wt = tag >> 3, tag & 7
        if wt == 0:
            v, i = _read_varint_py(buf, i)
            yield field, wt, v, i
        elif wt == 2:
            ln, i = _read_varint_py(buf, i)
            yield field, wt, buf[i : i + ln], i + ln
            i += ln
        elif wt == 5:
            yield field, wt, buf[i : i + 4], i + 4
            i += 4
        elif wt == 1:
            yield field, wt, buf[i : i + 8], i + 8
            i += 8
        else:
            raise IOError(f"unsupported wire type {wt}")


def _parse_int64_list(feat) -> tuple:
    vals = []
    for f4, wt4, v4, _ in _fields_py(feat):
        if f4 == 3 and wt4 == 2:  # int64_list
            for f5, wt5, v5, _ in _fields_py(v4):
                if f5 == 1 and wt5 == 2:  # packed
                    j = 0
                    while j < len(v5):
                        x, j = _read_varint_py(v5, j)
                        vals.append(x)
                elif f5 == 1 and wt5 == 0:
                    vals.append(v5)
    return tuple(vals)


def _parse_example_py(rec: bytes, bytes_key: str, shape_key: str,
                      label_key: Optional[str] = None):
    """One pass over the proto: (data, shape), or (data, shape, labels) when
    ``label_key`` is given."""
    data, shape, label = b"", None, None
    for f, wt, v, _ in _fields_py(rec):
        if f == 1 and wt == 2:  # features
            for f2, wt2, entry, _ in _fields_py(v):
                if f2 == 1 and wt2 == 2:
                    key, feat = None, None
                    for f3, wt3, v3, _ in _fields_py(entry):
                        if f3 == 1 and wt3 == 2:
                            key = v3.decode()
                        elif f3 == 2 and wt3 == 2:
                            feat = v3
                    if key == bytes_key and feat is not None:
                        for f4, wt4, v4, _ in _fields_py(feat):
                            if f4 == 1 and wt4 == 2:  # bytes_list
                                for f5, wt5, v5, _ in _fields_py(v4):
                                    if f5 == 1 and wt5 == 2:
                                        data = v5
                    elif key == shape_key and feat is not None:
                        shape = _parse_int64_list(feat)
                    elif label_key is not None and key == label_key and feat is not None:
                        label = _parse_int64_list(feat)
    if label_key is not None:
        return data, shape, label
    return data, shape


def shard_paths_for_rank(paths: Sequence[str], rank: int, world_size: int) -> List[str]:
    """Per-rank TFRecord shard assignment (dataloader.py:53-67): requires
    len(paths) % world_size == 0, round-robin by part index."""
    if len(paths) % world_size != 0:
        raise ValueError(f"{len(paths)} shards not divisible by world_size {world_size}")
    return [p for i, p in enumerate(sorted(paths)) if i % world_size == rank]


def chw_record_to_hwc(data: bytes, shape: Optional[Tuple[int, ...]], channels: int) -> np.ndarray:
    """One image record (CHW uint8, the reference's per-LOD layout,
    dataloader.py:92-96) as an HWC view; a record without a 3-D shape is
    taken as square."""
    arr = np.frombuffer(data, np.uint8)
    if shape is not None and len(shape) == 3:
        arr = arr.reshape(shape)
    else:
        side = int(round((arr.size / channels) ** 0.5))
        arr = arr.reshape(channels, side, side)
    return arr.transpose(1, 2, 0)


def load_uint8_images(paths: Sequence[str], channels: int = 3, bytes_key: str = "data",
                      shape_key: str = "shape", impl: str = "native") -> np.ndarray:
    """Read CHW uint8 image records and return NHWC uint8."""
    return np.stack([chw_record_to_hwc(data, shape, channels)
                     for p in paths
                     for data, shape in TFRecordFile(p, impl=impl).examples(bytes_key, shape_key)])
