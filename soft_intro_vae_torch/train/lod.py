"""Progressive LOD schedule driver (a copy of soft_intro_vae_tpu/train/lod.py).

Capability parity with the reference style_soft_intro_vae/lod_driver.py:
per-mesh-size LOD->batch tables (:24-31), lod = epoch // EPOCHS_PER_LOD
capped at layer_count-1 (:103), sine-eased blend over the first half of each
LOD cycle (:62-72), optimizer-state reset on LOD switch (signalled to the
trainer, :111-112), report/snapshot cadence in k-images (:74-85).
"""

from __future__ import annotations

import math
from typing import List, Sequence


class LODDriver:
    def __init__(self, *, lod_2_batch: Sequence[int], epochs_per_lod: int, layer_count: int,
                 dataset_size: int, world_size: int = 1,
                 report_freq: Sequence[int] = (100, 80, 60, 30, 20, 10, 10, 5, 5),
                 snapshot_freq: Sequence[int] = (300, 300, 300, 100, 50, 30, 20, 20, 10)):
        self.lod_2_batch = list(lod_2_batch)
        self.epochs_per_lod = epochs_per_lod
        self.layer_count = layer_count
        self.dataset_size = dataset_size
        self.world_size = world_size
        self.reports = list(report_freq)
        self.snapshots = list(snapshot_freq)
        self.current_epoch = 0
        self.lod = -1
        self.in_transition = False
        self.iteration = 0  # images seen this epoch
        self.tick_start_nimg_report = 0
        self.tick_start_nimg_snapshot = 0

    # ----------------------------------------------------------- queries ---
    def get_lod_power2(self) -> int:
        return self.lod + 2

    def get_batch_size(self) -> int:
        return self.lod_2_batch[min(self.lod, len(self.lod_2_batch) - 1)]

    def get_per_device_batch_size(self) -> int:
        return self.get_batch_size() // self.world_size

    def blend_factor_at(self, iteration: int) -> float:
        """Blend at an arbitrary images-seen count this epoch — a pure
        function of (current_epoch, iteration), so an input-pipeline producer
        can compute blends ahead of the training loop without mutating the
        driver (the loop's own ``step()`` cadence stays authoritative for
        report/snapshot ticks)."""
        if self.epochs_per_lod == 0:
            return 1.0
        blend = float((self.current_epoch % self.epochs_per_lod) * self.dataset_size + iteration)
        # max(1, …): EPOCHS_PER_LOD=1 has no first-half transition window and
        # the reference's unguarded `// 2` (lod_driver.py:66) divides by zero
        blend /= float(max(1, self.epochs_per_lod // 2) * self.dataset_size)
        blend = math.sin(blend * math.pi - 0.5 * math.pi) * 0.5 + 0.5
        return blend if self.in_transition else 1.0

    def get_blend_factor(self) -> float:
        return self.blend_factor_at(self.iteration)

    def is_time_to_report(self) -> bool:
        freq = self.reports[min(self.lod, len(self.reports) - 1)] * 1000
        if self.iteration >= self.tick_start_nimg_report + freq:
            self.tick_start_nimg_report = self.iteration
            return True
        return False

    def is_time_to_save(self) -> bool:
        freq = self.snapshots[min(self.lod, len(self.snapshots) - 1)] * 1000
        if self.iteration >= self.tick_start_nimg_snapshot + freq:
            self.tick_start_nimg_snapshot = self.iteration
            return True
        return False

    # ------------------------------------------------------------- state ---
    def step(self):
        self.iteration += self.get_batch_size()

    def set_epoch(self, epoch: int) -> bool:
        """Advance to ``epoch``. Returns True when the LOD switched (the
        caller must reset optimizer state, lod_driver.py:111-112)."""
        self.current_epoch = epoch
        self.iteration = 0
        self.tick_start_nimg_report = 0
        self.tick_start_nimg_snapshot = 0
        switched = False

        if self.epochs_per_lod == 0:
            self.lod = self.layer_count - 1
            return False

        new_lod = min(self.layer_count - 1, epoch // self.epochs_per_lod)
        if new_lod != self.lod:
            self.lod = new_lod
            self.in_transition = True
            switched = True

        is_first_half = (epoch % self.epochs_per_lod) < (self.epochs_per_lod // 2)
        is_growing = (epoch // self.epochs_per_lod == self.lod) and self.lod > 0
        self.in_transition = is_first_half and is_growing
        return switched


def pick_batch_table(cfg_tables: dict, world_size: int) -> List[int]:
    """LOD_2_BATCH_{8,4,2,1}GPU table selection (lod_driver.py:24-31).

    The tables are GLOBAL batch sizes (the reference divides by world size,
    lod_driver.py:59-60; our mesh shards the same way). With no exact table
    for this mesh size, the largest table not exceeding it is used as-is —
    scaling up would silently outgrow small datasets."""
    key = {8: "8GPU", 4: "4GPU", 2: "2GPU", 1: "1GPU"}.get(world_size)
    if key is not None and key in cfg_tables:
        return list(cfg_tables[key])
    for ws in (8, 4, 2, 1):
        if ws <= world_size and f"{ws}GPU" in cfg_tables:
            return list(cfg_tables[f"{ws}GPU"])
    return list(cfg_tables.get("1GPU", [128, 128, 128, 32, 16, 8, 4]))
