"""ShapeNet point-cloud data layer + minimal PLY reader (numpy-only copy of
soft_intro_vae_tpu/data/shapenet.py).

Capability parity with reference soft_intro_vae_3d/datasets/shapenet.py:
category map, per-class 85/5/10 train/valid/test split, (points, class_id)
samples. The vendored 941-line plyfile module is replaced by a compact reader
covering the ShapeNet-core sample format (binary/ascii vertex-only PLY).

No auto-download (hermetic environment): point ``root_dir`` at an existing
``shape_net_core_uniform_samples_2048`` tree, or use ``SyntheticClouds``.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

SYNTH_ID_TO_CATEGORY: Dict[str, str] = {
    "02691156": "airplane", "02773838": "bag", "02801938": "basket",
    "02808440": "bathtub", "02818832": "bed", "02828884": "bench",
    "02834778": "bicycle", "02843684": "birdhouse", "02871439": "bookshelf",
    "02876657": "bottle", "02880940": "bowl", "02924116": "bus",
    "02933112": "cabinet", "02747177": "can", "02942699": "camera",
    "02954340": "cap", "02958343": "car", "03001627": "chair",
    "03046257": "clock", "03207941": "dishwasher", "03211117": "monitor",
    "04379243": "table", "04401088": "telephone", "02946921": "tin_can",
    "04460130": "tower", "04468005": "train", "03085013": "keyboard",
    "03261776": "earphone", "03325088": "faucet", "03337140": "file",
    "03467517": "guitar", "03513137": "helmet", "03593526": "jar",
    "03624134": "knife", "03636649": "lamp", "03642806": "laptop",
    "03691459": "speaker", "03710193": "mailbox", "03759954": "microphone",
    "03761084": "microwave", "03790512": "motorcycle", "03797390": "mug",
    "03928116": "piano", "03938244": "pillow", "03948459": "pistol",
    "03991062": "pot", "04004475": "printer", "04074963": "remote_control",
    "04090263": "rifle", "04099429": "rocket", "04225987": "skateboard",
    "04256520": "sofa", "04330267": "stove", "04530566": "vessel",
    "04554684": "washer", "02858304": "boat", "02992529": "cellphone",
}
CATEGORY_TO_SYNTH_ID = {v: k for k, v in SYNTH_ID_TO_CATEGORY.items()}
SYNTH_ID_TO_NUMBER = {k: i for i, k in enumerate(SYNTH_ID_TO_CATEGORY)}

_PLY_TYPES = {
    "float": ("f", 4), "float32": ("f", 4), "double": ("d", 8), "float64": ("d", 8),
    "int": ("i", 4), "int32": ("i", 4), "uint": ("I", 4), "uint32": ("I", 4),
    "short": ("h", 2), "ushort": ("H", 2), "char": ("b", 1), "uchar": ("B", 1),
    "int8": ("b", 1), "uint8": ("B", 1), "int16": ("h", 2), "uint16": ("H", 2),
}


def load_ply(path: str) -> np.ndarray:
    """Read vertex x/y/z from an ascii or binary-little-endian PLY -> (N, 3)."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        n_vertices = 0
        props: List[Tuple[str, str]] = []
        in_vertex = False
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unexpected EOF in header")
            parts = line.decode("ascii", "replace").strip().split()
            if not parts:
                continue
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                in_vertex = parts[1] == "vertex"
                if in_vertex:
                    n_vertices = int(parts[2])
            elif parts[0] == "property" and in_vertex:
                props.append((parts[1], parts[2]))
            elif parts[0] == "end_header":
                break
        names = [n for _, n in props]
        ix, iy, iz = names.index("x"), names.index("y"), names.index("z")
        if fmt == "ascii":
            rows = []
            for _ in range(n_vertices):
                vals = f.readline().split()
                rows.append((float(vals[ix]), float(vals[iy]), float(vals[iz])))
            return np.asarray(rows, np.float32)
        if fmt != "binary_little_endian":
            raise ValueError(f"{path}: unsupported PLY format {fmt}")
        codes = [_PLY_TYPES[t] for t, _ in props]
        size = sum(w for _, w in codes)
        raw = f.read(n_vertices * size)
        dtype = np.dtype([(f"f{i}", "<" + c) for i, (c, _) in enumerate(codes)])
        arr = np.frombuffer(raw, dtype=dtype, count=n_vertices)
        out = np.empty((n_vertices, 3), np.float32)
        out[:, 0] = arr[f"f{ix}"]
        out[:, 1] = arr[f"f{iy}"]
        out[:, 2] = arr[f"f{iz}"]
        return out


class ShapeNetDataset:
    """Per-class 85/5/10 split over a directory of {synth_id}/{name}.ply files
    (shapenet.py:61-63). File order is sorted for determinism (the reference
    inherits filesystem listdir order)."""

    def __init__(self, root_dir: str, classes: Sequence[str] = (), split: str = "train"):
        if split not in ("train", "valid", "test"):
            raise ValueError("Invalid split. Should be train, valid or test.")
        self.root_dir = root_dir
        self.split = split
        if classes:
            ids = [c if c in SYNTH_ID_TO_CATEGORY else CATEGORY_TO_SYNTH_ID[c] for c in classes]
        else:
            ids = list(SYNTH_ID_TO_CATEGORY)
        self.entries: List[Tuple[str, str]] = []
        for cid in ids:
            d = os.path.join(root_dir, cid)
            if not os.path.isdir(d):
                continue
            files = sorted(f for f in os.listdir(d) if f.endswith(".ply"))
            n = len(files)
            lo, hi = {"train": (0, int(0.85 * n)),
                      "valid": (int(0.85 * n), int(0.9 * n)),
                      "test": (int(0.9 * n), n)}[split]
            self.entries += [(cid, f) for f in files[lo:hi]]
        if not self.entries:
            raise FileNotFoundError(
                f"no ShapeNet .ply files under {root_dir!r} for classes {list(classes)!r} "
                f"(expected shape_net_core_uniform_samples_2048 layout; downloads are disabled)")

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, int]:
        cid, name = self.entries[idx]
        pts = load_ply(os.path.join(self.root_dir, cid, name))
        return pts, SYNTH_ID_TO_NUMBER[cid]

    def load_all(self) -> Tuple[np.ndarray, np.ndarray]:
        pts = np.stack([self[i][0] for i in range(len(self))])
        labels = np.asarray([SYNTH_ID_TO_NUMBER[c] for c, _ in self.entries], np.int32)
        return pts, labels


class SyntheticClouds:
    """Deterministic stand-in: smooth random blobs inside the unit sphere."""

    def __init__(self, n: int, n_points: int = 2048, seed: int = 0):
        rng = np.random.default_rng(seed)
        centers = rng.normal(0, 0.15, (n, 8, 3))
        which = rng.integers(0, 8, (n, n_points))
        jitter = rng.normal(0, 0.05, (n, n_points, 3))
        pts = np.take_along_axis(centers, which[..., None], axis=1) + jitter
        norms = np.linalg.norm(pts, axis=-1, keepdims=True)
        pts = np.where(norms > 0.5, pts * (0.5 / norms), pts)
        self.points = pts.astype(np.float32)
        self.labels = np.zeros(n, np.int32)

    def __len__(self):
        return len(self.points)

    def load_all(self):
        return self.points, self.labels


def rotate_z(points: np.ndarray, angles_deg: np.ndarray) -> np.ndarray:
    """Random Z-axis rotation augment (reference RotateAxisAngle usage,
    train_soft_intro_vae_3d.py:256-260). points: (B, N, 3)."""
    th = np.deg2rad(angles_deg).astype(np.float32)
    c, s = np.cos(th), np.sin(th)
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    out = np.empty_like(points)
    out[..., 0] = c[:, None] * x - s[:, None] * y
    out[..., 1] = s[:, None] * x + c[:, None] * y
    out[..., 2] = z
    return out
