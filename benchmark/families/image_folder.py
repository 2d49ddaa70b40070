"""The image recipe fed out of core from a folder of JPEG files.

Set-up writes the folder once per checkout (benchmark/core/jpeg_folder.py)
and builds the data as the trainer does (train/image.py
``train_soft_intro_vae``): ``make_dataset(<dataset>, <data root>,
storage="uint8")``, which streams a folder larger than its residency bound
(4 GiB as uint8) through ``FolderDataset`` (data/images.py: a pool of 8
threads decodes each batch's files); set-up fails where it picked anything
else, or where the registry's widths are not the configuration's. Then what
the trainer builds (``build_image_training`` with its ``intro_step``,
``device_put_fn``) and the benchmark's weights, as the image cells.

The loop is the trainer's (train/image.py:298-320): each epoch
``host_batches`` (the dataset's epoch shuffled by ``(seed, epoch)``, this
rank's rows, and with ``mirror_augment`` the random left-right flips drawn
by ``(seed + 1, epoch)``), through ``device_prefetch`` two batches ahead,
one call a batch (``scan_steps`` 1: one graph replay), a NaN check every
``nan_check_iter`` steps, inside the benchmark's own feed spans.

The checked rows: each row of a checked batch must be the file that the
epoch's permutation ``np.random.default_rng((seed, epoch)).permutation(n)``
puts there, decoded here with PIL, or that image mirrored; the reference is
fed the row as the program had it. Only the checked files are decoded.
"""

from __future__ import annotations

import os
from typing import Iterator, List

import numpy as np
import torch

from benchmark.core import jpeg_folder, weights
from benchmark.core.timing import step_span
from benchmark.families.image import ImageCell


def decode(path: str) -> np.ndarray:
    """One file as (H, W, 3) uint8, by PIL."""
    from PIL import Image

    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"), np.uint8)


class ImageFolderCell(ImageCell):

    # --------------------------------------------------------------- program --
    def setup(self) -> None:
        # host_batches first: a program without it cannot run the cell
        from soft_intro_vae_torch.train.image import (  # noqa: F401
            ImageConfig, build_image_training, host_batches)
        from soft_intro_vae_torch.data.images import FolderDataset, ImageSpec, make_dataset

        m, t, d = self.cfg["model"], self.cfg["train"], self.cfg["data"]
        icfg = ImageConfig(dataset=m["dataset"], z_dim=m["z_dim"], lr_e=t["lr_e"], lr_d=t["lr_d"],
                           batch_size=self.batch, beta_kl=t["beta_kl"], beta_rec=t["beta_rec"],
                           beta_neg=t["beta_neg"], gamma_r=t["gamma_r"],
                           seed=self.seeds["shuffle"] % (2 ** 31), scan_steps=t["scan_steps"],
                           compute_dtype=t["compute_dtype"],
                           matmul_precision=t["matmul_precision"],
                           mirror_augment=t["mirror_augment"], device=str(self.device),
                           verbose=False)
        self.icfg = icfg
        self.root = jpeg_folder.folder(d["seed"], d["files"], m["image_size"], m["dataset"],
                                       quality=d["quality"])
        spec, dataset = make_dataset(m["dataset"], self.root, seed=max(icfg.seed, 0),
                                     synthetic_fallback=False, storage="uint8")
        if not isinstance(dataset, FolderDataset):
            raise RuntimeError(f"make_dataset picked {type(dataset).__name__}, not FolderDataset")
        want = ImageSpec(m["dataset"], m["image_size"], tuple(m["channels"]), m["cdim"])
        if spec != want:
            raise RuntimeError(f"the registry's {spec} is not the configuration's {want}")
        self.dataset = dataset
        state, _, self.step_fn = build_image_training(icfg, spec)
        weights.load_into(state.model, self.make_weights())
        state.generator.manual_seed(self.seeds["draws"])
        self.state = state
        self._start()

    def _loop(self) -> Iterator:
        from soft_intro_vae_torch.data.prefetch import device_prefetch, device_put_fn
        from soft_intro_vae_torch.train.image import host_batches

        mine = self.rows()
        put_fn = device_put_fn(self.state.device)
        every = self.icfg.nan_check_iter
        cur_iter, epoch = 0, 0
        while True:
            host = host_batches(self.dataset, self.icfg, epoch, mine)
            fed = device_prefetch(self.spans.producer(host), size=2, put_fn=put_fn)
            try:
                it = iter(fed)
                while True:
                    with self.spans.wait():
                        x = next(it, None)
                    if x is None:
                        break
                    with step_span():
                        self.state, mets = self.step_fn(self.state, x)
                    if every and cur_iter % every == 0:
                        if not bool(torch.isfinite(torch.stack(list(mets.values()))).all()):
                            raise SystemError("loss is NaN")
                    cur_iter += 1
                    yield x, mets
            finally:
                fed.close()
            epoch += 1

    def rows(self) -> slice:
        """This rank's rows of a batch."""
        from soft_intro_vae_torch.parallel.mesh import current_world, host_local_batch_size

        world = current_world()
        return world.rows(host_local_batch_size(self.batch, world))

    # ----------------------------------------------------------------- check --
    def expected_files(self, step: int) -> List[str]:
        """The files the trainer's rule puts in step ``step`` (from 0)."""
        n = self.cfg["data"]["files"]
        per_epoch = n // self.batch
        epoch, at = step // per_epoch, (step % per_epoch) * self.batch
        perm = np.random.default_rng((max(self.icfg.seed, 0), epoch)).permutation(n)
        folder = os.path.join(self.root, self.cfg["model"]["dataset"])
        return [os.path.join(folder, jpeg_folder.NAME % i)
                for i in perm[at:at + self.batch][self.rows()]]

    def check_feed(self):
        """Each checked row against the file it must be: the decoded files of
        the matched rows, in order; each checked step's [index, flipped]
        rows; the count of rows that are neither their file nor its mirror
        (and of rows missing or in excess)."""
        recs, matched, wrong = [], [], 0
        for s in range(sum(st.stop - st.start for st in self.stages())):
            rows = self.batches[s].numpy()
            files = self.expected_files(s)
            idx = np.full((rows.shape[0], 2), -1, np.int64)
            wrong += abs(rows.shape[0] - len(files))
            for j, (row, path) in enumerate(zip(rows, files)):
                img = decode(path)
                flipped = next((f for f, cand in ((0, img), (1, img[:, ::-1]))
                                if np.array_equal(row, cand)), None)
                if flipped is None:
                    wrong += 1
                    continue
                idx[j] = (len(recs), flipped)
                recs.append(img)
            matched.append(idx)
        return np.array(recs, np.uint8), matched, wrong

    def reference_input(self, recs: np.ndarray, idx: np.ndarray, half: bool) -> torch.Tensor:
        rows = recs[idx[:, 0]]
        flip = idx[:, 1] == 1
        rows[flip] = rows[flip][:, :, ::-1]
        if half:
            rows = rows[: rows.shape[0] // 2]
        return torch.from_numpy(np.ascontiguousarray(rows)).to(self.device)


Cell = ImageFolderCell
