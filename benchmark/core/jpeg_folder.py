"""The benchmark's folder of JPEG files, written once per checkout.

Picture ``i`` of a data seed comes from its own ``SeedSequence([seed, i])``:
a smooth field (a 9 x 9 grid of random levels per channel, bilinear over the
picture) plus noise (random bytes shifted down by three bits), like the
program's ``SyntheticImages``, so that a file compresses and decodes as a
photograph does (~35-40 KB at quality 95 for 256 x 256 x 3) rather than as
white noise. Each picture is saved with PIL as ``%05d.jpg`` (so the sorted
names are the pictures' order) into ``benchmark/.data/<key>/<name>``, the
key a hash of everything that made the files, written into ``<key>.part``
and renamed when complete, as ``benchmark/core/data.py`` writes its shards:
a later run finds the folder and writes nothing. Nothing of the program
writes the data it is fed.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from benchmark.core import data

GRID = 9
# what makes a picture, hashed into the key: change it with the generator
CONTENT = "v1: bilinear 9x9 grid of levels in [0, 224) per channel + (random bytes >> 3)"
NAME = "%05d.jpg"
THREADS = 8


def _bilinear(n: int, side: int) -> np.ndarray:
    """(side, n) float32 weights of ``n`` grid points at ``side`` pixels."""
    pos = np.linspace(0.0, n - 1.0, side)
    lo = np.minimum(pos.astype(np.int64), n - 2)
    frac = pos - lo
    m = np.zeros((side, n), np.float32)
    m[np.arange(side), lo] = 1.0 - frac
    m[np.arange(side), lo + 1] = frac
    return m


def picture(seed: int, i: int, side: int) -> np.ndarray:
    """Picture ``i`` as (side, side, 3) uint8 HWC."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, i]))
    m = _bilinear(GRID, side)
    levels = rng.random((3, GRID, GRID), dtype=np.float32) * np.float32(224.0)
    field = np.matmul(np.matmul(m, levels), m.T).astype(np.uint8)  # (3, side, side), < 224
    noise = np.frombuffer(rng.bytes(3 * side * side), np.uint8).reshape(3, side, side) >> 3
    return np.ascontiguousarray((field + noise).transpose(1, 2, 0))


def key(seed: int, count: int, side: int, quality: int) -> str:
    return hashlib.sha256(json.dumps(
        {"format": "jpeg-folder", "content": CONTENT, "seed": seed, "count": count, "side": side,
         "quality": quality}, sort_keys=True).encode()).hexdigest()[:16]


def folder(seed: int, count: int, side: int, name: str, quality: int) -> str:
    """The data root holding ``name/`` with ``count`` pictures at JPEG
    ``quality``, written on the first call in this checkout by up to
    ``THREADS`` threads (PIL's encoder and the file writes let go of the
    interpreter's lock: 30,000 files of 256 x 256 x 3 take ~72 s on the
    H100 machine's 8 cores)."""
    from PIL import Image

    final = os.path.join(data.DATA_DIR, key(seed, count, side, quality))
    if not os.path.isdir(final):
        tmp = final + ".part"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(os.path.join(tmp, name))

        def write(i: int) -> None:
            Image.fromarray(picture(seed, i, side)).save(
                os.path.join(tmp, name, NAME % i), format="JPEG", quality=quality)

        with ThreadPoolExecutor(max_workers=min(THREADS, os.cpu_count() or 1)) as pool:
            for _ in pool.map(write, range(count)):  # reading each result raises its error
                pass
        os.replace(tmp, final)
    return final
