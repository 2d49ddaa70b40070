"""Constant-host-memory per-LOD TFRecord streaming for the style trainer
(port of data/streaming.py; host-side numpy, as in the JAX package).

Capability parity with the reference's streaming input
(style_soft_intro_vae/dataloader.py:30-102): per-LOD shard files addressed as
``path_pattern % (resolution_level, part)``, per-rank shard assignment
(:53-67), and a byte-budgeted shuffle buffer (:95-100). The reference uses
DareBlopy's C++ iterator with ``buffer_size_mb``; here records stream through
the port's native TFRecord reader (data/tfrecords.py) into a reservoir-style
shuffle buffer of the same byte budget.

Host memory is O(buffer_size_mb + one batch) whatever the dataset's size, so
the FFHQ-256 recipe (70k x 256^2 x 3 ~ 13 GB uint8) streams from disk instead
of sitting in RAM.

``epoch(..., epoch_index=k)`` seeds the shuffle from (seed, k, level) alone,
so a resumed run replays the batches of an uninterrupted one (the
reference's resume replays different data). At world 1 the batches are byte
for byte the JAX package's.

``path_pattern`` needs two %-fields, the level and the part
(``ffhq-r%02d.tfrecords.%03d``, the names ``prepare_tfrecords`` writes); a
pattern with another count raises ``ValueError`` here, where the JAX package
raises Python's ``TypeError`` while formatting it.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional

import numpy as np

from soft_intro_vae_torch.data.tfrecords import TFRecordFile, chw_record_to_hwc


def _downscale_u8_to(img_hwc: np.ndarray, res: int) -> np.ndarray:
    """Box-downscale an HWC uint8 image to res x res (power-of-two ratio)."""
    cur = img_hwc.astype(np.float32)
    while cur.shape[0] > res:
        h, w, c = cur.shape
        cur = cur.reshape(h // 2, 2, w // 2, 2, c).mean(axis=(1, 3))
    return np.clip(np.rint(cur), 0, 255).astype(np.uint8)


class StreamingTFRecords:
    """Stream per-LOD TFRecord shards as NHWC batches in [0, 255] —
    float32 by default, or source-byte uint8 with ``storage="uint8"``
    (lossless: per-LOD records store uint8 pixels; shipping bytes quarters
    host RAM churn and H2D traffic — the trainer normalizes on device,
    see train/style.py's feed).

    Parameters mirror the reference's TFRecordsDataset ctor
    (dataloader.py:31-67): ``path_pattern`` with two %-fields (level, part),
    ``part_count`` shards per level, ``dataset_size`` total images,
    ``max_resolution_level`` the highest stored level, rank/world_size for
    shard assignment, ``buffer_size_mb`` the shuffle-buffer byte budget.

    When a requested resolution has no stored shards, max-resolution records
    are streamed and box-downscaled per record (still constant memory) — this
    lets single-resolution shard sets (e.g. from prepare_tfrecords
    --min-level = max) serve every LOD.
    """

    def __init__(self, path_pattern: str, part_count: int, dataset_size: int,
                 max_resolution_level: int, rank: int = 0, world_size: int = 1,
                 buffer_size_mb: int = 200, channels: int = 3, seed: int = 0,
                 flip: bool = True, min_resolution_level: int = 2,
                 storage: str = "float32"):
        check_pattern(path_pattern)
        if not 0 <= rank < world_size:
            raise ValueError(f"rank {rank} is not in a world of {world_size}")
        if part_count % world_size != 0:
            raise ValueError(f"part_count {part_count} not divisible by world_size {world_size}")
        self.path_pattern = path_pattern
        self.part_count = part_count
        self.part_count_local = part_count // world_size
        self.dataset_size = dataset_size
        self.max_level = max_resolution_level
        self.channels = channels
        self.seed = seed
        self.flip = flip
        self.rank = rank
        self.world_size = world_size
        self.buffer_bytes = buffer_size_mb * 1024 * 1024
        self.batch_dtype = np.uint8 if storage == "uint8" else np.float32
        self._epoch_counter = 0

        # per-level shard lists for THIS rank (dataloader.py:60-67)
        self.filenames: Dict[int, List[str]] = {}
        for r in range(min_resolution_level, max_resolution_level + 1):
            files = [path_pattern % (r, i)
                     for i in range(self.part_count_local * rank,
                                    self.part_count_local * (rank + 1))]
            if all(os.path.exists(f) for f in files):
                self.filenames[r] = files
        if self.max_level not in self.filenames:
            raise FileNotFoundError(
                f"no shards at max level {self.max_level}: "
                f"{path_pattern % (self.max_level, self.part_count_local * rank)}")

    def __len__(self) -> int:
        return self.dataset_size // (self.part_count // self.part_count_local)

    # ------------------------------------------------------------- stream --
    def _record_stream(self, level: int, rng: np.random.Generator,
                       res: int) -> Iterator[np.ndarray]:
        """Yield HWC uint8 images at ``res`` from the level's shards,
        shard order shuffled per epoch; downscales when level > target."""
        files = list(self.filenames[level])
        rng.shuffle(files)
        for path in files:
            for data, shape in TFRecordFile(path).examples():
                img = chw_record_to_hwc(data, shape, self.channels)
                if img.shape[0] > res:
                    img = _downscale_u8_to(img, res)
                yield img

    def epoch(self, res: int, batch_size: int, drop_last: bool = True,
              epoch_index: Optional[int] = None) -> Iterator[np.ndarray]:
        """One pass over this rank's shards at resolution ``res``:
        (B, res, res, C) batches in [0, 255] (dtype = ctor ``storage``),
        shuffle-buffered."""
        level = int(np.log2(res))
        assert 2 ** level == res, f"resolution {res} not a power of two"
        src_level = level if level in self.filenames else self.max_level

        if epoch_index is None:
            epoch_index = self._epoch_counter
            self._epoch_counter += 1
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, epoch_index, level]))

        record_bytes = res * res * self.channels
        cap = max(2 * batch_size, self.buffer_bytes // record_bytes)

        buffer: List[np.ndarray] = []
        pending: List[np.ndarray] = []

        def flush() -> Optional[np.ndarray]:
            if len(pending) < batch_size:
                return None
            batch = np.asarray(pending[:batch_size], self.batch_dtype)
            del pending[:batch_size]
            if self.flip:
                flips = rng.random(batch.shape[0]) < 0.5
                batch[flips] = batch[flips][:, :, ::-1, :]
            return batch

        for img in self._record_stream(src_level, rng, res):
            if len(buffer) < cap:
                buffer.append(img)
                continue
            j = int(rng.integers(len(buffer)))
            pending.append(buffer[j])
            buffer[j] = img
            b = flush()
            if b is not None:
                yield b
        # drain the buffer in shuffled order
        order = rng.permutation(len(buffer))
        for j in order:
            pending.append(buffer[j])
            b = flush()
            if b is not None:
                yield b
        if not drop_last:
            while pending:
                pad = pending[: batch_size]
                del pending[: len(pad)]
                batch = np.asarray(pad, self.batch_dtype)
                if self.flip:  # same augmentation on the tail as on full batches
                    flips = rng.random(batch.shape[0]) < 0.5
                    batch[flips] = batch[flips][:, :, ::-1, :]
                yield batch


def check_pattern(path_pattern: str) -> str:
    """``path_pattern`` if it formats (level, part); else ``ValueError``."""
    try:
        path_pattern % (2, 0)
    except TypeError as e:
        raise ValueError(
            f"DATASET.PATH {path_pattern!r} must hold two %-fields, the resolution level and "
            f"the part (e.g. 'ffhq-r%02d.tfrecords.%03d', the names prepare_tfrecords "
            f"writes): {e}") from None
    return path_pattern


def find_part_count(path_pattern: str, level: int, limit: int = 4096) -> int:
    """Count consecutive existing parts at a level (split-tool output probe)."""
    n = 0
    while n < limit and os.path.exists(path_pattern % (level, n)):
        n += 1
    return n
