"""Image data layer: dataset registry, disk loaders, synthetic fallback.

A numpy copy of soft_intro_vae_tpu/data/images.py, so the port feeds its
steps the same batches as the JAX package for the same seed and epoch; the
out-of-core folder's decode is a span of the port's tracing.
Reference: the dataset selection table (soft_intro_vae/
train_soft_intro_vae.py:376-440) and ImageDatasetFromFile (soft_intro_vae/
dataset.py:50-93).

All loaders return NHWC batches, float32 in [0, 1] or the source's uint8
bytes (``storage="uint8"``); the port's step turns them into the NCHW float32
batches the nets take (ops/u8norm.py). Downloads are never attempted: data
is read from local roots when present; ``SyntheticImages`` is a
deterministic stand-in so training, tests and benchmarks run hermetically.
The folder loaders need PIL and behave as if the folder were absent without
it; SVHN needs scipy.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from soft_intro_vae_torch.utils.profiling import span


def to_unit_float(batch: np.ndarray) -> np.ndarray:
    """uint8 [0,255] -> float32 [0,1]; float batches pass through unchanged.

    The uint8 round-trip is exact for every loader here (all sources are
    natively 8-bit), so f32 and u8 storage produce bit-identical training
    batches once normalized."""
    if batch.dtype == np.uint8:
        return batch.astype(np.float32) / 255.0
    return batch


@dataclasses.dataclass(frozen=True)
class ImageSpec:
    """One row of the reference dataset registry: sizes + channel schedule."""

    name: str
    image_size: int
    channels: Tuple[int, ...]
    cdim: int

    @property
    def scale(self) -> float:
        # per-pixel loss normalizer (train_soft_intro_vae.py:456)
        return 1.0 / (self.cdim * self.image_size**2)


# (train_soft_intro_vae.py:376-440)
DATASETS: Dict[str, ImageSpec] = {
    "cifar10": ImageSpec("cifar10", 32, (64, 128, 256), 3),
    "svhn": ImageSpec("svhn", 32, (64, 128, 256), 3),
    "mnist": ImageSpec("mnist", 28, (64, 128), 1),
    "fmnist": ImageSpec("fmnist", 28, (64, 128), 1),
    "monsters128": ImageSpec("monsters128", 128, (64, 128, 256, 512, 512), 3),
    "celeb128": ImageSpec("celeb128", 128, (64, 128, 256, 512, 512), 3),
    "celeb256": ImageSpec("celeb256", 256, (64, 128, 256, 512, 512, 512), 3),
    "celeb1024": ImageSpec("celeb1024", 1024, (16, 32, 64, 128, 256, 512, 512, 512), 3),
}


class ArrayDataset:
    """In-memory NHWC dataset with shuffled epoch iteration.

    ``augment_fn(batch, rng) -> batch`` runs per batch at iteration time —
    the analog of the reference's per-sample torchvision transform pipeline
    (dataset.py:129-134), vectorized."""

    def __init__(self, images: np.ndarray, seed: int = 0, augment_fn=None):
        assert images.ndim == 4, "expect (N, H, W, C)"
        self.images = images
        self._seed = seed
        self.rng = np.random.default_rng(seed)
        self.augment_fn = augment_fn

    def __len__(self) -> int:
        return self.images.shape[0]

    def epoch(self, batch_size: int, shuffle: bool = True, drop_last: bool = False,
              epoch_index: Optional[int] = None,
              rows: Optional[slice] = None) -> Iterator[np.ndarray]:
        """epoch_index, when given, seeds the shuffle/augment draws for this
        epoch deterministically (replay-identical resume — a resumed run at
        epoch E replays an uninterrupted run's exact batches); when None the
        sequential internal stream is used (legacy behavior). ``rows``: yield
        only those rows of each batch (a rank's, parallel/mesh.py), gathering
        only them unless ``augment_fn`` must see the whole batch."""
        n = len(self)
        rng = self.rng if epoch_index is None else np.random.default_rng((self._seed, epoch_index))
        idx = rng.permutation(n) if shuffle else np.arange(n)
        end = n - (n % batch_size) if drop_last else n
        for i in range(0, end, batch_size):
            take = idx[i : i + batch_size]
            if self.augment_fn is None:
                yield self.images[take if rows is None else take[rows]]
                continue
            batch = self.augment_fn(self.images[take], rng)
            yield batch if rows is None else batch[rows]


class SyntheticImages(ArrayDataset):
    """Deterministic synthetic images — hermetic stand-in for smoke/bench."""

    def __init__(self, n: int, image_size: int, cdim: int, seed: int = 0):
        rng = np.random.default_rng(seed)
        # smooth blobs rather than white noise so the VAE has structure to fit
        base = rng.random((n, 8, 8, cdim)).astype(np.float32)
        reps = image_size // 8 + 1
        up = np.repeat(np.repeat(base, reps, axis=1), reps, axis=2)[:, :image_size, :image_size, :]
        noise = rng.random((n, image_size, image_size, cdim)).astype(np.float32)
        super().__init__(np.clip(0.8 * up + 0.2 * noise, 0.0, 1.0), seed=seed)


def load_cifar10(root: str, dtype: str = "float32") -> Optional[np.ndarray]:
    """Read the standard ``cifar-10-batches-py`` pickles -> (50000,32,32,3).

    dtype="uint8" keeps the source bytes (4x less host RAM and host-to-device
    traffic; the step then normalizes on the device, ops/u8norm.py)."""
    d = os.path.join(root, "cifar-10-batches-py")
    if not os.path.isdir(d):
        return None
    chunks = []
    for i in range(1, 6):
        with open(os.path.join(d, f"data_batch_{i}"), "rb") as f:
            batch = pickle.load(f, encoding="bytes")
        chunks.append(batch[b"data"])
    data = np.concatenate(chunks).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    if dtype == "uint8":
        return np.ascontiguousarray(data)
    return (data.astype(np.float32) / 255.0)


def load_mnist_idx(root: str, name: str = "train-images-idx3-ubyte",
                   dtype: str = "float32") -> Optional[np.ndarray]:
    """Read raw MNIST/FashionMNIST idx files -> (N, 28, 28, 1) in [0,1]
    (or raw uint8 with dtype="uint8")."""
    import gzip

    for candidate in (os.path.join(root, name), os.path.join(root, name + ".gz")):
        if os.path.exists(candidate):
            opener = gzip.open if candidate.endswith(".gz") else open
            with opener(candidate, "rb") as f:
                raw = f.read()
            n = int.from_bytes(raw[4:8], "big")
            data = np.frombuffer(raw, np.uint8, offset=16).reshape(n, 28, 28, 1)
            if dtype == "uint8":
                return data.copy()
            return data.astype(np.float32) / 255.0
    return None


def load_image_folder(
    root: str,
    output_size: int,
    input_size: Optional[int] = None,
    crop_size: Optional[int] = None,
    mirror: bool = True,
    limit: Optional[int] = None,
    seed: int = 0,
    dtype: str = "float32",
) -> Optional[np.ndarray]:
    """Folder-of-images loader (ImageDatasetFromFile parity: RGB convert,
    optional center crop, bicubic resize; random mirror is applied at batch
    time by ``augment_mirror``). Requires PIL. dtype="uint8" stores source
    bytes (4x less RAM; device-side normalization via the trainers' put)."""
    try:
        from PIL import Image
    except ImportError:
        return None
    if not os.path.isdir(root):
        return None
    exts = (".jpg", ".png", ".jpeg", ".bmp")
    files = sorted(x for x in os.listdir(root) if x.lower().endswith(exts))
    if limit:
        files = files[:limit]
    if not files:
        return None
    np_dtype = np.uint8 if dtype == "uint8" else np.float32
    out = np.empty((len(files), output_size, output_size, 3), np_dtype)
    for i, name in enumerate(files):
        img = Image.open(os.path.join(root, name)).convert("RGB")
        if input_size:
            img = img.resize((input_size, input_size), Image.BICUBIC)
        if crop_size:
            w, h = img.size
            left, top = (w - crop_size) // 2, (h - crop_size) // 2
            img = img.crop((left, top, left + crop_size, top + crop_size))
        img = img.resize((output_size, output_size), Image.BICUBIC)
        raw = np.asarray(img, np.uint8)
        out[i] = raw if np_dtype == np.uint8 else raw.astype(np.float32) / 255.0
    return out


class FolderDataset:
    """Out-of-core folder-of-images dataset: holds file paths, decodes per batch.

    The reference trains celeb256/celeb1024 from disk via DataLoader workers
    over ImageDatasetFromFile (soft_intro_vae/dataset.py:50-93,
    train_soft_intro_vae.py:458). ``load_image_folder`` materializes the whole
    folder as float32 — fine for small sets, impossible at reference scale
    (celeb1024 ~30k images = 377 GiB f32). This class keeps host RAM at batch
    scale: a small thread pool decodes each shuffled index batch (PIL releases
    the GIL around decode/resize), and the trainers' ``device_prefetch``
    overlaps the next batch's decode and copy with the running step.

    Iteration interface and (seed, epoch_index) determinism match
    ``ArrayDataset.epoch`` exactly, so every trainer accepts either.

    Each batch's decode (the pool's reads and decodes of its files and the
    stack) is a ``feed.decode`` span (utils/profiling.py), the batch's index
    in its epoch its ``batch``; ``decoded_images`` and ``decoded_bytes``
    count the images decoded and their files' bytes.
    """

    def __init__(self, files, output_size: int, input_size: Optional[int] = None,
                 crop_size: Optional[int] = None, seed: int = 0, augment_fn=None,
                 workers: int = 8, dtype: str = "float32"):
        from PIL import Image  # hard requirement for a folder dataset

        self._Image = Image
        self.files = list(files)
        if not self.files:
            raise ValueError("FolderDataset: empty file list")
        self.output_size = output_size
        self.input_size = input_size
        self.crop_size = crop_size
        self._seed = seed
        self.rng = np.random.default_rng(seed)
        self.augment_fn = augment_fn
        self._workers = max(1, workers)
        self._pool = None  # lazily created; kept for the dataset's lifetime
        self._dtype = np.uint8 if dtype == "uint8" else np.float32
        self.decoded_images = 0
        self.decoded_bytes = 0

    def __len__(self) -> int:
        return len(self.files)

    def _decode(self, path: str) -> np.ndarray:
        """One image -> (H, W, 3) float32 in [0,1] — or uint8 when built with
        dtype="uint8" (ImageDatasetFromFile semantics: RGB convert, optional
        resize-to-input, optional center crop, bicubic resize to output)."""
        Image = self._Image
        img = Image.open(path).convert("RGB")
        if self.input_size:
            img = img.resize((self.input_size, self.input_size), Image.BICUBIC)
        if self.crop_size:
            w, h = img.size
            left, top = (w - self.crop_size) // 2, (h - self.crop_size) // 2
            img = img.crop((left, top, left + self.crop_size, top + self.crop_size))
        if img.size != (self.output_size, self.output_size):
            img = img.resize((self.output_size, self.output_size), Image.BICUBIC)
        raw = np.asarray(img, np.uint8)
        return raw if self._dtype == np.uint8 else raw.astype(np.float32) / 255.0

    def _ensure_pool(self):
        if self._pool is None and self._workers > 1:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(max_workers=self._workers,
                                            thread_name_prefix="folder-decode")
        return self._pool

    def epoch(self, batch_size: int, shuffle: bool = True, drop_last: bool = False,
              epoch_index: Optional[int] = None,
              rows: Optional[slice] = None) -> Iterator[np.ndarray]:
        """Decode-on-demand epoch stream; seeding semantics and ``rows``
        identical to ``ArrayDataset.epoch`` (replay-identical resume)."""
        n = len(self)
        rng = self.rng if epoch_index is None else np.random.default_rng((self._seed, epoch_index))
        idx = rng.permutation(n) if shuffle else np.arange(n)
        end = n - (n % batch_size) if drop_last else n
        pool = self._ensure_pool()
        for b, i in enumerate(range(0, end, batch_size)):
            take = idx[i : i + batch_size]
            if rows is not None and self.augment_fn is None:
                take = take[rows]
            paths = [self.files[j] for j in take]
            with span("feed.decode", batch=b):
                batch = np.stack(list(pool.map(self._decode, paths)) if pool
                                 else [self._decode(p) for p in paths])
            self.decoded_images += len(paths)
            self.decoded_bytes += sum(os.path.getsize(p) for p in paths)
            if self.augment_fn is not None:
                batch = self.augment_fn(batch, rng)
                batch = batch if rows is None else batch[rows]
            yield batch


def open_image_folder(
    root: str,
    output_size: int,
    input_size: Optional[int] = None,
    crop_size: Optional[int] = None,
    seed: int = 0,
    augment_fn=None,
    max_resident_bytes: Optional[int] = None,
    limit: Optional[int] = None,
    storage: str = "float32",
):
    """Folder loader that picks residency by size: small folders are decoded
    once into an in-RAM ``ArrayDataset`` (fastest epoch iteration), folders
    whose resident footprint exceeds ``max_resident_bytes`` (default 4 GiB;
    env SIV_MAX_RESIDENT_BYTES overrides; 0 forces out-of-core) stream
    through ``FolderDataset``. storage="uint8" quarters both the residency
    footprint and the per-batch host-to-device bytes (see ``to_unit_float``).
    Returns None when the folder is absent/empty."""
    try:
        from PIL import Image  # noqa: F401
    except ImportError:
        return None
    if not os.path.isdir(root):
        return None
    exts = (".jpg", ".png", ".jpeg", ".bmp")
    files = sorted(x for x in os.listdir(root) if x.lower().endswith(exts))
    if limit:
        files = files[:limit]
    if not files:
        return None
    if max_resident_bytes is None:
        max_resident_bytes = int(os.environ.get("SIV_MAX_RESIDENT_BYTES", 4 << 30))
    px_bytes = 1 if storage == "uint8" else 4
    resident_bytes = len(files) * output_size * output_size * 3 * px_bytes
    paths = [os.path.join(root, f) for f in files]
    if resident_bytes > max_resident_bytes:
        return FolderDataset(paths, output_size, input_size=input_size,
                             crop_size=crop_size, seed=seed, augment_fn=augment_fn,
                             dtype=storage)
    arr = load_image_folder(root, output_size, input_size=input_size,
                            crop_size=crop_size, limit=limit, seed=seed, dtype=storage)
    return ArrayDataset(arr, seed=seed, augment_fn=augment_fn) if arr is not None else None


def augment_mirror(batch: np.ndarray, rng: np.random.Generator, rows: Optional[slice] = None,
                   global_batch: Optional[int] = None) -> np.ndarray:
    """Random horizontal flip per image (dataset.py is_mirror semantics).
    With ``rows``, ``batch`` holds those rows of a global batch of
    ``global_batch`` images: the flips are drawn for all of them, so every
    rank's draws stay in step, and this batch takes its rows' flips."""
    flip = rng.random(batch.shape[0] if rows is None else global_batch) < 0.5
    if rows is not None:
        flip = flip[rows]
    out = batch.copy()
    out[flip] = out[flip][:, :, ::-1, :]
    return out


def augment_translate(batch: np.ndarray, rng: np.random.Generator,
                      max_shift: Optional[int] = None, fill: float = 1.0) -> np.ndarray:
    """Random affine translation (DigitalMonstersDataset's
    RandomAffine(0, translate=(5/H, 5/H), fillcolor=(255,255,255)),
    dataset.py:129-134): +-5px shifts, vacated pixels filled white."""
    n, h, w, _ = batch.shape
    if max_shift is None:
        max_shift = 5  # the reference's fixed 5-pixel budget (5/H of H)
    out = np.full_like(batch, fill)
    dys = rng.integers(-max_shift, max_shift + 1, n)
    dxs = rng.integers(-max_shift, max_shift + 1, n)
    for i in range(n):
        dy, dx = int(dys[i]), int(dxs[i])
        ys = slice(max(dy, 0), h + min(dy, 0))
        xs = slice(max(dx, 0), w + min(dx, 0))
        ys_src = slice(max(-dy, 0), h + min(-dy, 0))
        xs_src = slice(max(-dx, 0), w + min(-dx, 0))
        out[i, ys, xs] = batch[i, ys_src, xs_src]
    return out


def augment_hue(batch: np.ndarray, rng: np.random.Generator, max_hue: float = 0.5) -> np.ndarray:
    """Random hue rotation (ColorJitter hue=0.5 parity) for RGB in [0,1].

    Implemented as a rotation in the YIQ chroma plane — cheap, vectorized,
    and matches torchvision's hue shift semantics to good approximation."""
    n = batch.shape[0]
    theta = rng.uniform(-max_hue, max_hue, n).astype(np.float32) * 2.0 * np.pi
    # RGB->YIQ / YIQ->RGB
    m1 = np.array([[0.299, 0.587, 0.114],
                   [0.596, -0.274, -0.322],
                   [0.211, -0.523, 0.312]], np.float32)
    m2 = np.linalg.inv(m1).astype(np.float32)
    yiq = np.einsum("nhwc,dc->nhwd", batch, m1)
    c, s = np.cos(theta), np.sin(theta)
    i, q = yiq[..., 1].copy(), yiq[..., 2].copy()
    yiq[..., 1] = c[:, None, None] * i - s[:, None, None] * q
    yiq[..., 2] = s[:, None, None] * i + c[:, None, None] * q
    rgb = np.einsum("nhwd,cd->nhwc", yiq, m2)
    return np.clip(rgb, 0.0, 1.0)


def load_svhn(root: str, split: str = "train", dtype: str = "float32") -> Optional[np.ndarray]:
    """Read the SVHN ``{split}_32x32.mat`` (the file torchvision's SVHN
    dataset downloads; reference train_soft_intro_vae.py:424-427)
    -> (N, 32, 32, 3) float32 in [0, 1] (or raw uint8 with dtype="uint8")."""
    path = os.path.join(root, f"{split}_32x32.mat")
    if not os.path.exists(path):
        return None
    from scipy.io import loadmat

    x = loadmat(path)["X"]  # (32, 32, 3, N) uint8
    x = np.ascontiguousarray(x.transpose(3, 0, 1, 2))
    if dtype == "uint8":
        return x
    return x.astype(np.float32) / 255.0


def monsters_augment(batch: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """DigitalMonstersDataset's training transform (dataset.py:129-134):
    RandomAffine 5px white-fill translate + ColorJitter(hue=0.5) +
    RandomHorizontalFlip. Mirror is folded in here so the trainer needs no
    special-casing."""
    batch = augment_translate(batch, rng, max_shift=5, fill=1.0)
    batch = augment_hue(batch, rng, max_hue=0.5)
    return augment_mirror(batch, rng)


def make_dataset(name: str, data_root: str = "./data", seed: int = 0,
                 synthetic_fallback: bool = True, synthetic_n: int = 2048,
                 storage: str = "float32"):
    """Resolve a dataset name to (spec, dataset) — an ``ArrayDataset`` (in
    RAM) or ``FolderDataset`` (out-of-core), same epoch interface; falls back to
    synthetic data when the files aren't on disk (hermetic environments) —
    LOUDLY, via warnings.warn, and the returned dataset is a
    ``SyntheticImages`` instance callers can (and should) check for.

    storage="uint8" keeps host batches in source bytes: 4x less RAM and 4x
    fewer host-to-device bytes; the step normalizes on the device
    (ops/u8norm.py). monsters128 always stores float32 — its hue-rotation
    augment runs in float on host."""
    if name not in DATASETS:
        raise NotImplementedError(f"dataset {name!r} is not supported")
    spec = DATASETS[name]
    arr = None
    augment_fn = None
    if name == "cifar10":
        arr = load_cifar10(os.path.join(data_root, "cifar10_ds"), dtype=storage)
        if arr is None:
            arr = load_cifar10(data_root, dtype=storage)
    elif name == "svhn":
        arr = load_svhn(os.path.join(data_root, "svhn"), dtype=storage)
        if arr is None:
            arr = load_svhn(data_root, dtype=storage)
    elif name in ("mnist", "fmnist"):
        sub = {"mnist": "mnist_ds", "fmnist": "fmnist_ds"}[name]
        arr = load_mnist_idx(os.path.join(data_root, sub), dtype=storage)
        if arr is None:
            arr = load_mnist_idx(data_root, dtype=storage)
    elif name in ("celeb128", "celeb256", "celeb1024", "monsters128"):
        if name == "monsters128":
            # the reference trains monsters with its augmentation pipeline on;
            # the hue rotation is float math — keep float storage here
            augment_fn = monsters_augment
            storage = "float32"
        # size-aware residency: big folders stream out-of-core (FolderDataset),
        # small ones decode once into RAM — celeb1024 at reference scale never
        # materializes as f32 (reference analog: DataLoader over
        # ImageDatasetFromFile, dataset.py:50-93)
        ds = open_image_folder(os.path.join(data_root, name), spec.image_size,
                               seed=seed, augment_fn=augment_fn, storage=storage)
        if ds is not None:
            return spec, ds
    if arr is None:
        if not synthetic_fallback:
            raise FileNotFoundError(f"no local data for {name!r} under {data_root!r}")
        import warnings

        warnings.warn(
            f"no local data for {name!r} under {data_root!r} — SUBSTITUTING "
            f"{synthetic_n} synthetic images. Results are NOT {name} results. "
            "Pass synthetic_fallback=False (CLI: --no-synthetic-fallback) to "
            "fail instead.", stacklevel=2)
        return spec, SyntheticImages(synthetic_n, spec.image_size, spec.cdim, seed=seed)
    return spec, ArrayDataset(arr, seed=seed, augment_fn=augment_fn)
