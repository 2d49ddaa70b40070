"""ImageNet-style TFRecord loader: oversized sources, random crops, labels
(the port's copy of the JAX package's data/imagenet.py, host-side numpy).

The equivalent of the reference's ImageNet dataloader variants
(style_soft_intro_vae/dataloader.py:153-305):

* ``TFRecordsDatasetImageNet`` stores TRAINING records oversized by 1/8 —
  source side = 2**lod + 2**(lod-3) (dataloader.py:200-201) — so the
  collator can take random ``target_size`` crops each epoch; eval records
  are exactly 2**lod. Records are CHW uint8, optionally with an int64
  ``label`` field (needs_labels, dataloader.py:205-213).
* ``make_imagenet_dataloader`` / ``make_imagenet_dataloader_y``
  (dataloader.py:234-305) apply per-image random crop + random horizontal
  flip and emit float batches (the _y variant also yields labels).

Here both collators collapse into ``ImageNetTFRecords.epoch``: crops and
flips are vectorized numpy on the uint8 batch (no per-image Python loop),
the output is NHWC float32 in [0, 255] ready for the device, and shard
assignment is the same per-rank round-robin as the main streaming layer.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from soft_intro_vae_torch.data.streaming import check_pattern
from soft_intro_vae_torch.data.tfrecords import TFRecordFile, chw_record_to_hwc


def imagenet_source_size(target_size: int, train: bool = True) -> int:
    """Stored record side for a target crop size (dataloader.py:200-203,
    239-241): training sources carry a 1/8 margin for random crops."""
    p = int(np.log2(target_size))
    if 2 ** p != target_size:
        raise ValueError(f"target_size {target_size} not a power of two")
    return 2 ** p + 2 ** (p - 3) if train else target_size


class ImageNetTFRecords:
    """Per-LOD ImageNet shards -> randomly-cropped NHWC float32 batches.

    Ctor parameters mirror TFRecordsDatasetImageNet (dataloader.py:154-193):
    ``path_pattern`` with two %-fields (resolution level, part index),
    ``part_count`` shards per level, ``dataset_size`` images across all
    ranks, rank/world_size shard assignment (part_count % world_size == 0),
    ``train`` selecting oversized vs exact sources, ``needs_labels``
    switching on the int64 label field, ``impl`` the TFRecord reader.
    """

    def __init__(self, path_pattern: str, part_count: int, dataset_size: int,
                 max_resolution_level: int, rank: int = 0, world_size: int = 1,
                 channels: int = 3, seed: int = 0, train: bool = True,
                 needs_labels: bool = False, flip: bool = True,
                 min_resolution_level: int = 2, impl: str = "native"):
        check_pattern(path_pattern)
        if part_count % world_size != 0:
            raise ValueError(
                f"part_count {part_count} not divisible by world_size {world_size}")
        self.path_pattern = path_pattern
        self.part_count = part_count
        self.part_count_local = part_count // world_size
        self.dataset_size = dataset_size
        self.channels = channels
        self.seed = seed
        self.train = train
        self.needs_labels = needs_labels
        self.flip = flip
        self.impl = impl
        self._epoch_counter = 0

        self.filenames: Dict[int, List[str]] = {}
        for r in range(min_resolution_level, max_resolution_level + 1):
            files = [path_pattern % (r, i)
                     for i in range(self.part_count_local * rank,
                                    self.part_count_local * (rank + 1))]
            if all(os.path.exists(f) for f in files):
                self.filenames[r] = files
        if not self.filenames:
            raise FileNotFoundError(
                f"no complete shard level under {path_pattern!r} for rank {rank}")

    def __len__(self) -> int:
        # images served by THIS rank (dataloader.py:230-232)
        return self.dataset_size // (self.part_count // self.part_count_local)

    def _records(self, level: int, rng: np.random.Generator
                 ) -> Iterator[Tuple[np.ndarray, Optional[int]]]:
        files = list(self.filenames[level])
        rng.shuffle(files)
        for path in files:
            for data, shape, label in TFRecordFile(path, impl=self.impl).examples_with_label():
                yield chw_record_to_hwc(data, shape, self.channels), label

    def epoch(self, target_size: int, batch_size: int, drop_last: bool = True,
              do_random_crops: bool = True, epoch_index: Optional[int] = None
              ) -> Iterator[object]:
        """One pass at ``target_size``: yields (B, t, t, C) float32 batches
        in [0, 255], or (batch, labels) when needs_labels. Each image gets
        an independent random crop out of the oversized source and an
        independent horizontal flip (dataloader.py:247-262)."""
        level = int(np.log2(target_size))
        if level not in self.filenames:
            raise FileNotFoundError(
                f"no shards for resolution level {level} "
                f"({sorted(self.filenames)} available)")
        if epoch_index is None:
            epoch_index = self._epoch_counter
            self._epoch_counter += 1
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch_index, level]))
        src = imagenet_source_size(target_size, self.train)

        imgs: List[np.ndarray] = []
        labels: List[int] = []

        def flush():
            n = len(imgs)
            batch = np.stack(imgs[:batch_size])
            del imgs[:batch_size]
            lab = np.asarray(labels[:batch_size], np.int64)
            del labels[:batch_size]
            if do_random_crops and batch.shape[1] > target_size:
                delta = batch.shape[1] - target_size
                offy = rng.integers(0, delta + 1, size=batch.shape[0])
                offx = rng.integers(0, delta + 1, size=batch.shape[0])
                rows = offy[:, None] + np.arange(target_size)[None, :]
                cols = offx[:, None] + np.arange(target_size)[None, :]
                batch = batch[np.arange(batch.shape[0])[:, None, None],
                              rows[:, :, None], cols[:, None, :]]
            else:
                batch = batch[:, :target_size, :target_size]
            if self.flip:
                flips = rng.random(batch.shape[0]) < 0.5
                batch[flips] = batch[flips][:, :, ::-1, :]
            batch = batch.astype(np.float32)
            return (batch, lab) if self.needs_labels else batch

        for img, label in self._records(level, rng):
            if img.shape[0] != src or img.shape[1] != src:
                raise ValueError(
                    f"record is {img.shape[0]}x{img.shape[1]}, expected "
                    f"{src}x{src} (train={self.train}, target={target_size})")
            if label is None and self.needs_labels:
                # the reference's FixedLenFeature parse hard-fails on a record
                # missing 'label' (dataloader.py:205-213) — match that rather
                # than silently training on a sentinel
                raise ValueError(
                    "needs_labels=True but a record has no int64 'label' "
                    f"field (resolution level {level}); re-build the shards")
            imgs.append(img)
            labels.append(-1 if label is None else int(label))
            if len(imgs) >= batch_size:
                yield flush()
        if imgs and not drop_last:
            yield flush()
