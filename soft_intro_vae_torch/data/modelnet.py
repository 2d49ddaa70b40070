"""ModelNet40 point-cloud dataset (HDF5; the port's copy of the JAX package's
data/modelnet.py, with h5py imported when a file is read).

Capability parity with the reference's soft_intro_vae_3d/datasets/modelnet40.py:
reads the standard modelnet40_ply_hdf5_2048 shards (ply_data_{train,test}*.h5
with 'data'/'label'), offers train/valid/test splits (valid carved from train
like the reference's valid_percent) and an optional supervised fraction.
No auto-download (hermetic environment).
"""

from __future__ import annotations

import glob
import os
from typing import Optional, Tuple

import numpy as np


def _load_h5_files(paths) -> Tuple[np.ndarray, np.ndarray]:
    import h5py

    pts, labels = [], []
    for p in sorted(paths):
        with h5py.File(p, "r") as f:
            pts.append(np.asarray(f["data"][:], np.float32))
            labels.append(np.asarray(f["label"][:], np.int32).reshape(-1))
    if not pts:
        raise FileNotFoundError("no ModelNet40 h5 shards found")
    return np.concatenate(pts), np.concatenate(labels)


class ModelNet40:
    def __init__(self, root_dir: str, split: str = "train", valid_percent: float = 0.05,
                 n_points: Optional[int] = None, seed: int = 0):
        if split not in ("train", "valid", "test"):
            raise ValueError("Invalid split. Should be train, valid or test.")
        pattern = "ply_data_test*.h5" if split == "test" else "ply_data_train*.h5"
        paths = glob.glob(os.path.join(root_dir, pattern))
        pts, labels = _load_h5_files(paths)
        if split in ("train", "valid"):
            rng = np.random.default_rng(seed)
            idx = rng.permutation(len(pts))
            n_valid = int(len(pts) * valid_percent)
            sel = idx[:n_valid] if split == "valid" else idx[n_valid:]
            pts, labels = pts[sel], labels[sel]
        if n_points is not None:
            pts = pts[:, :n_points]
        self.points = pts
        self.labels = labels

    def __len__(self):
        return len(self.points)

    def __getitem__(self, i):
        return self.points[i], int(self.labels[i])

    def load_all(self):
        return self.points, self.labels
