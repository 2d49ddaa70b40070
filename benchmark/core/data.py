"""The benchmark's data: random uint8 images, and TFRecord shards of them.

Images are made from a data seed with numpy, record ``i`` from its own
``SeedSequence([seed, i])``, so the check can make any of them again. A
shard set is written once per checkout, under ``benchmark/.data/<key>``
(git-ignored), the key a hash of everything that made it: a later run finds
it and writes nothing. A set is written into a directory of its own name
plus ``.part`` and renamed when complete.

The TFRecord format is written here, with its masked CRC32C computed over
all records of a shard at once in numpy: nothing of the program writes the
data it is fed.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import struct
from typing import Sequence

import numpy as np

DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".data")
PATTERN = "bench-r%02d.tfrecords.%03d"


def images(seed: int, count: int, side: int, channels: int = 3, first: int = 0) -> np.ndarray:
    """Records ``first .. first + count - 1`` as (count, side, side, C) uint8 HWC."""
    out = np.empty((count, side, side, channels), np.uint8)
    for j in range(count):
        rng = np.random.default_rng(np.random.SeedSequence([seed, first + j]))
        out[j] = rng.integers(0, 256, (side, side, channels), dtype=np.uint8)
    return out


def image_set(seed: int, count: int, side: int, channels: int = 3) -> np.ndarray:
    """``count`` images from one generator, for an in-memory dataset."""
    rng = np.random.default_rng(np.random.SeedSequence([seed]))
    return rng.integers(0, 256, (count, side, side, channels), dtype=np.uint8)


# ------------------------------------------------------------------ CRC --
def _crc_tables() -> np.ndarray:
    """CRC32C (Castagnoli, reflected) lookup tables for 4 bytes a step."""
    poly = 0x82F63B78
    t0 = np.zeros(256, np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (poly ^ (c >> 1)) if (c & 1) else (c >> 1)
        t0[i] = c
    tables = [t0]
    for _ in range(3):
        tables.append((tables[-1] >> np.uint32(8)) ^ t0[tables[-1] & 0xFF])
    return np.stack(tables)


_T = _crc_tables()
CRC_ROWS = 2048  # rows a pass: enough to spread numpy's per-call cost


def crc32c_rows(rows: np.ndarray) -> np.ndarray:
    """CRC32C of each row of a (N, L) uint8 array, (N,) uint32."""
    out = np.empty(rows.shape[0], np.uint32)
    for lo in range(0, rows.shape[0], CRC_ROWS):
        out[lo:lo + CRC_ROWS] = _crc32c_block(rows[lo:lo + CRC_ROWS])
    return out


def _crc32c_block(rows: np.ndarray) -> np.ndarray:
    n, length = rows.shape
    whole = length - length % 4
    words = np.ascontiguousarray(rows[:, :whole]).view("<u4").T.copy()
    crc = np.full(n, 0xFFFFFFFF, np.uint32)
    for w in words:
        c = crc ^ w
        crc = _T[3][c & 0xFF] ^ _T[2][(c >> 8) & 0xFF] ^ _T[1][(c >> 16) & 0xFF] ^ _T[0][c >> 24]
    for col in rows[:, whole:].T:
        crc = _T[0][(crc ^ col) & 0xFF] ^ (crc >> np.uint32(8))
    return crc ^ np.uint32(0xFFFFFFFF)


def masked(crc: np.ndarray) -> np.ndarray:
    crc = crc.astype(np.uint64)
    return ((((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF).astype(np.uint32)


# -------------------------------------------------------------- records --
def _varint(v: int) -> bytes:
    out = b""
    while True:
        b = v & 0x7F
        v >>= 7
        if not v:
            return out + bytes([b])
        out += bytes([b | 0x80])


def _ld(field: int, payload: bytes) -> bytes:
    return _varint((field << 3) | 2) + _varint(len(payload)) + payload


def example_prefix(shape: Sequence[int], nbytes: int) -> bytes:
    """The bytes of a tf.Example {shape: int64 list, data: bytes} before its
    ``nbytes`` of image data, which end it: the same for every record of one
    shape."""
    ints = b"".join(_varint(int(v)) for v in shape)
    shape_entry = _ld(1, b"shape") + _ld(2, _ld(3, _ld(1, ints)))
    data_entry = _ld(1, b"data") + _ld(2, _ld(1, _ld(1, bytes(nbytes))))
    return _ld(1, _ld(1, shape_entry) + _ld(1, data_entry))[:-nbytes]


def tfrecords(chw: np.ndarray) -> np.ndarray:
    """(N, C, H, W) uint8 images -> (N, L) uint8: each row one whole TFRecord
    (length, its masked CRC, the tf.Example, its masked CRC)."""
    n = chw.shape[0]
    flat = chw.reshape(n, -1)
    prefix = np.frombuffer(example_prefix(chw.shape[1:], flat.shape[1]), np.uint8)
    rec = np.concatenate([np.broadcast_to(prefix, (n, prefix.size)), flat], axis=1)
    length = struct.pack("<Q", rec.shape[1])
    len_crc = masked(crc32c_rows(np.frombuffer(length, np.uint8)[None]))[0]
    data_crc = masked(crc32c_rows(rec))
    head = np.frombuffer(length + struct.pack("<I", int(len_crc)), np.uint8)
    return np.concatenate([np.broadcast_to(head, (n, head.size)), rec,
                           data_crc.astype("<u4").view(np.uint8).reshape(n, 4)], axis=1)


def shard_set(seed: int, count: int, level: int, parts: int, channels: int = 3) -> str:
    """The path pattern (level, part) of ``count`` level-``level`` records in
    ``parts`` shards, written on the first call in this checkout."""
    key = hashlib.sha256(json.dumps(
        {"format": 1, "seed": seed, "count": count, "level": level, "parts": parts,
         "channels": channels}, sort_keys=True).encode()).hexdigest()[:16]
    final = os.path.join(DATA_DIR, key)
    if not os.path.isdir(final):
        tmp = final + ".part"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        hwc = images(seed, count, 2 ** level, channels)
        recs = tfrecords(np.ascontiguousarray(hwc.transpose(0, 3, 1, 2)))
        del hwc
        bounds = np.linspace(0, count, parts + 1).astype(int)
        for p in range(parts):
            recs[bounds[p]:bounds[p + 1]].tofile(os.path.join(tmp, PATTERN % (level, p)))
        os.replace(tmp, final)
    return os.path.join(final, PATTERN)


def box_downscale(hwc: np.ndarray, res: int) -> np.ndarray:
    """(N, S, S, C) uint8 -> (N, res, res, C): the mean of each (S/res)^2
    block, rounded half to even."""
    n, s, _, c = hwc.shape
    f = s // res
    sums = hwc.reshape(n, res, f, res, f, c).sum(axis=(2, 4), dtype=np.int64)
    return np.rint(sums / float(f * f)).astype(np.uint8)
