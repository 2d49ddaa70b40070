"""Dataset preparation: image folders -> per-LOD TFRecord shards (the port's
copy of the JAX package's cli/prepare_tfrecords.py; it writes the same bytes).

Capability parity with the reference's dataset_preparation tools
(style_soft_intro_vae/dataset_preparation/dataset_tool.py
create_from_images + prepare_celeba_hq_tfrecords.py + split_tfrecords_ffhq.py)
WITHOUT TensorFlow: records are written by our own writer
(data/tfrecords.py), one file set per resolution level r (4..2^max_level),
split into ``parts`` shards per level so the per-rank shard assignment
(dataloader.py:53-67) works.

Record schema matches the reference reader: 'shape' int64 [C,H,W],
'data' bytes (CHW uint8).

Usage:
  python -m soft_intro_vae_torch.cli.prepare_tfrecords -i ./images -o ./tfr \
      --max-level 8 --parts 16 --name celeba
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np

from soft_intro_vae_torch.data.lmdb_reader import LMDBReader
from soft_intro_vae_torch.data.tfrecords import (
    TFRecordFile, TFRecordWriter, make_example, write_tfrecord)


def downscale_u8(img: np.ndarray) -> np.ndarray:
    """2x box downscale of an HWC uint8 image."""
    h, w, c = img.shape
    f = img.astype(np.float32).reshape(h // 2, 2, w // 2, 2, c).mean(axis=(1, 3))
    return np.clip(np.rint(f), 0, 255).astype(np.uint8)


def load_folder(path: str, size: int, limit: Optional[int] = None) -> np.ndarray:
    from PIL import Image

    exts = (".jpg", ".jpeg", ".png", ".bmp")
    files = sorted(f for f in os.listdir(path) if f.lower().endswith(exts))
    if limit:
        files = files[:limit]
    if not files:
        raise FileNotFoundError(f"no images under {path}")
    out = np.empty((len(files), size, size, 3), np.uint8)
    for i, name in enumerate(files):
        img = Image.open(os.path.join(path, name)).convert("RGB")
        if img.size != (size, size):
            img = img.resize((size, size), Image.LANCZOS)
        out[i] = np.asarray(img, np.uint8)
    return out


def write_multires_shards(images_u8: np.ndarray, out_dir: str, name: str,
                          max_level: int, min_level: int = 2, parts: int = 1) -> List[str]:
    """images (N, H, W, C) uint8 at 2^max_level -> shard files
    '{name}-r{level:02d}.tfrecords.{part:03d}' for level in [min..max]."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    cur = images_u8
    n = cur.shape[0]
    order = np.arange(n)
    for level in range(max_level, min_level - 1, -1):
        res = 2 ** level
        assert cur.shape[1] == res, (cur.shape, res)
        for part in range(parts):
            sel = order[part::parts]
            examples = []
            for i in sel:
                chw = cur[i].transpose(2, 0, 1)
                examples.append(make_example({
                    "shape": list(chw.shape),
                    "data": chw.tobytes(),
                }))
            p = os.path.join(out_dir, f"{name}-r{level:02d}.tfrecords.{part:03d}")
            write_tfrecord(p, examples)
            paths.append(p)
        if level > min_level:
            cur = np.stack([downscale_u8(im) for im in cur])
    return paths


def write_multires_shards_streaming(image_paths: List[str], out_dir: str, name: str,
                                    max_level: int, min_level: int = 2,
                                    parts: int = 1) -> List[str]:
    """Streaming variant of write_multires_shards: one image in memory at a
    time (the reference's dataset_tool.py processes FFHQ image-by-image the
    same way) — constant host memory for arbitrarily large folders."""
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    size = 2 ** max_level
    writers = {
        (level, part): TFRecordWriter(
            os.path.join(out_dir, f"{name}-r{level:02d}.tfrecords.{part:03d}"))
        for level in range(min_level, max_level + 1)
        for part in range(parts)
    }
    try:
        for i, path in enumerate(image_paths):
            img = Image.open(path).convert("RGB")
            if img.size != (size, size):
                img = img.resize((size, size), Image.LANCZOS)
            cur = np.asarray(img, np.uint8)
            part = i % parts
            for level in range(max_level, min_level - 1, -1):
                chw = cur.transpose(2, 0, 1)
                writers[(level, part)].write(make_example({
                    "shape": list(chw.shape), "data": chw.tobytes()}))
                if level > min_level:
                    cur = downscale_u8(cur)
    finally:
        for w in writers.values():
            w.close()
    return [w.path for w in writers.values()]


# ------------------------------------------------------- per-source loaders
# Parity with dataset_tool.py:537-658 (create_mnist/mnistrgb/cifar10/
# cifar100/svhn) and :741-755 (create_celeba): same file layouts, shape
# asserts, pad/crop specifics, and the exporter's RandomState(123) shuffle
# (dataset_tool.py:301-303). Labels ride along as '{name}-rNN.labels' (.npy),
# matching TFRecordExporter.add_labels' sidecar.
#
# NB the `_u8` suffix is deliberate: these return (uint8 images, onehot
# labels) for the TFRecord exporter — NOT the float32-[0,1] unlabeled
# trainer loaders of the same datasets in data/images.py.

_SHUFFLE_SEED = 123  # TFRecordExporter.choose_shuffled_order


def _shuffled_order(n: int) -> np.ndarray:
    order = np.arange(n)
    np.random.RandomState(_SHUFFLE_SEED).shuffle(order)
    return order


def _onehot(labels: np.ndarray) -> np.ndarray:
    out = np.zeros((labels.size, int(np.max(labels)) + 1), np.float32)
    out[np.arange(labels.size), labels] = 1.0
    return out


def load_mnist_u8(mnist_dir: str) -> tuple:
    """idx3/idx1 gz files -> ((60000,32,32,1) u8 zero-padded from 28, onehot)."""
    import gzip

    with gzip.open(os.path.join(mnist_dir, "train-images-idx3-ubyte.gz"), "rb") as f:
        images = np.frombuffer(f.read(), np.uint8, offset=16)
    with gzip.open(os.path.join(mnist_dir, "train-labels-idx1-ubyte.gz"), "rb") as f:
        labels = np.frombuffer(f.read(), np.uint8, offset=8)
    images = images.reshape(-1, 28, 28, 1)
    images = np.pad(images, [(0, 0), (2, 2), (2, 2), (0, 0)], constant_values=0)
    assert images.shape == (60000, 32, 32, 1) and images.dtype == np.uint8
    assert labels.shape == (60000,) and 0 == np.min(labels) and np.max(labels) == 9
    return images, _onehot(labels)


def load_mnistrgb_u8(mnist_dir: str, num_images: int = 1_000_000,
                  random_seed: int = 123) -> tuple:
    """Random MNIST digit triplets as RGB channels (dataset_tool.py:562-576)."""
    images, _ = load_mnist_u8(mnist_dir)
    images = images[..., 0]
    rnd = np.random.RandomState(random_seed)
    idx = rnd.randint(images.shape[0], size=(num_images, 3))
    return images[idx].transpose(0, 2, 3, 1), None  # (N,32,32,3)


def load_cifar10_u8(cifar10_dir: str) -> tuple:
    import pickle

    images, labels = [], []
    for batch in range(1, 6):
        with open(os.path.join(cifar10_dir, f"data_batch_{batch}"), "rb") as f:
            data = pickle.load(f, encoding="latin1")
        images.append(data["data"].reshape(-1, 3, 32, 32))
        labels.append(data["labels"])
    images = np.concatenate(images).transpose(0, 2, 3, 1)
    labels = np.concatenate(labels)
    assert images.shape == (50000, 32, 32, 3) and images.dtype == np.uint8
    assert 0 == np.min(labels) and np.max(labels) == 9
    return images, _onehot(labels)


def load_cifar100_u8(cifar100_dir: str) -> tuple:
    import pickle

    with open(os.path.join(cifar100_dir, "train"), "rb") as f:
        data = pickle.load(f, encoding="latin1")
    images = data["data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    labels = np.asarray(data["fine_labels"])
    assert images.shape == (50000, 32, 32, 3) and images.dtype == np.uint8
    assert 0 == np.min(labels) and np.max(labels) == 99
    return images, _onehot(labels)


def load_svhn_u8(svhn_dir: str) -> tuple:
    import pickle

    images, labels = [], []
    for batch in range(1, 4):
        with open(os.path.join(svhn_dir, f"train_{batch}.pkl"), "rb") as f:
            data = pickle.load(f, encoding="latin1")
        images.append(data[0])
        labels.append(data[1])
    images = np.concatenate(images)
    labels = np.concatenate(labels)
    assert images.shape[1:] == (3, 32, 32) and images.dtype == np.uint8
    return images.transpose(0, 2, 3, 1), _onehot(labels)


def load_celeba_u8(celeba_dir: str, cx: int = 89, cy: int = 121,
                expected_images: Optional[int] = 202599) -> tuple:
    """img_align_celeba_png/*.png -> 128x128 center crops at (cx, cy)."""
    import glob

    from PIL import Image

    files = sorted(glob.glob(os.path.join(celeba_dir, "img_align_celeba_png", "*.png")))
    if expected_images is not None and len(files) != expected_images:
        raise FileNotFoundError(
            f"expected {expected_images} images, found {len(files)}")
    out = np.empty((len(files), 128, 128, 3), np.uint8)
    for i, path in enumerate(files):
        img = np.asarray(Image.open(path))
        assert img.shape == (218, 178, 3), (path, img.shape)
        out[i] = img[cy - 64: cy + 64, cx - 64: cx + 64]
    return out, None


def _iter_lsun_images(lmdb_dir: str, max_images: Optional[int] = None):
    """Decode LSUN LMDB values to HWC RGB uint8 arrays, skipping bad records
    (dataset_tool.py:664-689 semantics: per-image try/except, cv2-or-PIL
    decode — we decode via PIL, which handles LSUN's webp/jpg payloads)."""
    import io
    import sys

    from PIL import Image

    count = 0
    with LMDBReader(lmdb_dir) as db:
        for _key, value in db.items():
            if max_images is not None and count >= max_images:
                return
            try:
                img = np.asarray(Image.open(io.BytesIO(value)).convert("RGB"))
            except Exception:
                print(sys.exc_info()[1])
                continue
            count += 1
            yield img


def create_lsun(out_dir: str, lmdb_dir: str, resolution: int = 256,
                max_images: Optional[int] = None, name: str = "lsun",
                parts: int = 1, min_level: int = 2) -> List[str]:
    """LSUN LMDB -> per-LOD shards (dataset_tool.py:658-690 create_lsun):
    center-crop to the short side, LANCZOS resize to ``resolution``, then
    the standard multi-resolution shard cascade. Constant memory: one image
    at a time through streaming writers."""
    from PIL import Image

    max_level = int(np.log2(resolution))
    assert 2 ** max_level == resolution, f"resolution {resolution} not a power of 2"
    os.makedirs(out_dir, exist_ok=True)
    writers = {
        (level, part): TFRecordWriter(
            os.path.join(out_dir, f"{name}-r{level:02d}.tfrecords.{part:03d}"))
        for level in range(min_level, max_level + 1)
        for part in range(parts)
    }
    try:
        for i, img in enumerate(_iter_lsun_images(lmdb_dir, max_images)):
            crop = min(img.shape[:2])
            img = img[(img.shape[0] - crop) // 2: (img.shape[0] + crop) // 2,
                      (img.shape[1] - crop) // 2: (img.shape[1] + crop) // 2]
            pimg = Image.fromarray(img, "RGB").resize(
                (resolution, resolution), Image.LANCZOS)
            cur = np.asarray(pimg, np.uint8)
            part = i % parts
            for level in range(max_level, min_level - 1, -1):
                chw = cur.transpose(2, 0, 1)
                writers[(level, part)].write(make_example({
                    "shape": list(chw.shape), "data": chw.tobytes()}))
                if level > min_level:
                    cur = downscale_u8(cur)
    finally:
        for w in writers.values():
            w.close()
    return [w.path for w in writers.values()]


def create_lsun_wide(out_dir: str, lmdb_dir: str, width: int = 512,
                     height: int = 384, max_images: Optional[int] = None,
                     name: str = "lsun-wide", parts: int = 1,
                     min_level: int = 2) -> List[str]:
    """LSUN LMDB -> width*width shards with the image letterboxed on a black
    canvas (dataset_tool.py:694-740 create_lsun_wide): crop vertically to the
    width aspect, resize to (width, height), skip too-small sources."""
    from PIL import Image

    max_level = int(np.log2(width))
    assert 2 ** max_level == width, f"width {width} not a power of 2"
    assert height <= width
    os.makedirs(out_dir, exist_ok=True)
    writers = {
        (level, part): TFRecordWriter(
            os.path.join(out_dir, f"{name}-r{level:02d}.tfrecords.{part:03d}"))
        for level in range(min_level, max_level + 1)
        for part in range(parts)
    }
    written = 0
    try:
        for img in _iter_lsun_images(lmdb_dir, None):
            if max_images is not None and written >= max_images:
                break
            ch = int(np.round(width * img.shape[0] / img.shape[1]))
            if img.shape[1] < width or ch < height:
                continue  # too small for the target aspect (dataset_tool.py:719)
            img = img[(img.shape[0] - ch) // 2: (img.shape[0] + ch) // 2]
            pimg = Image.fromarray(img, "RGB").resize((width, height), Image.LANCZOS)
            arr = np.asarray(pimg, np.uint8)
            canvas = np.zeros((width, width, 3), np.uint8)
            canvas[(width - height) // 2: (width + height) // 2] = arr
            part = written % parts
            cur = canvas
            for level in range(max_level, min_level - 1, -1):
                chw = cur.transpose(2, 0, 1)
                writers[(level, part)].write(make_example({
                    "shape": list(chw.shape), "data": chw.tobytes()}))
                if level > min_level:
                    cur = downscale_u8(cur)
            written += 1
    finally:
        for w in writers.values():
            w.close()
    return [w.path for w in writers.values()]


def create_celeba_hq(input_dir: str, out_dir: str, train_size: int = 70000,
                     test_size: int = 10000, parts: int = 1,
                     max_level: int = 8, name: str = "celeba-hq",
                     min_level: int = 2) -> List[str]:
    """Pre-generated CelebA-HQ image folder -> per-LOD train/test fold shards
    (prepare_celeba_hq_tfrecords.py:99-165 prepare_celeba): integer filenames
    become the int64 'label' field, train = first ``train_size`` images by
    index, test = the next ``test_size``; each split is seed-0 shuffled and
    dealt round-robin into ``parts`` folds; per-LOD cascade is a 2x avg-pool
    with truncating uint8 cast (the reference's F.avg_pool2d().to(uint8)).

    (The reference takes images in os.listdir order, which is filesystem-
    dependent; we sort by index so shards are reproducible.)
    """
    import random

    from PIL import Image

    size = 2 ** max_level
    exts = (".jpg", ".jpeg", ".png", ".bmp", ".webp")
    images = sorted(
        (int(os.path.splitext(f)[0]), f)
        for f in os.listdir(input_dir)
        if f.lower().endswith(exts) and os.path.splitext(f)[0].isdigit())
    if not images:
        raise FileNotFoundError(f"no integer-named images under {input_dir}")
    os.makedirs(out_dir, exist_ok=True)
    paths: List[str] = []
    splits = (("", images[:train_size]),
              ("-test", images[train_size: train_size + test_size]))
    for suffix, split in splits:
        if not split:
            continue
        split = list(split)
        random.Random(0).shuffle(split)  # random.seed(0) in the reference
        count_per_fold = len(split) // parts
        writers = {
            (level, part): TFRecordWriter(os.path.join(
                out_dir, f"{name}{suffix}-r{level:02d}.tfrecords.{part:03d}"))
            for level in range(min_level, max_level + 1)
            for part in range(parts)
        }
        try:
            for part in range(parts):
                fold = split[part * count_per_fold: (part + 1) * count_per_fold] \
                    if parts > 1 else split
                for label, filename in fold:
                    img = Image.open(os.path.join(input_dir, filename)).convert("RGB")
                    if img.size != (size, size):
                        img = img.resize((size, size), Image.LANCZOS)
                    cur = np.asarray(img, np.uint8)
                    for level in range(max_level, min_level - 1, -1):
                        chw = cur.transpose(2, 0, 1)
                        writers[(level, part)].write(make_example({
                            "shape": list(chw.shape),
                            "label": [label],
                            "data": chw.tobytes()}))
                        if level > min_level:
                            # truncating cast, not rint: float mean -> uint8
                            f = cur.astype(np.float32).reshape(
                                cur.shape[0] // 2, 2, cur.shape[1] // 2, 2, 3
                            ).mean(axis=(1, 3))
                            cur = np.clip(f, 0, 255).astype(np.uint8)
        finally:
            for w in writers.values():
                w.close()
        paths.extend(w.path for w in writers.values())
    return paths


SOURCE_CREATORS = {
    "mnist": (load_mnist_u8, 5),
    "mnistrgb": (load_mnistrgb_u8, 5),
    "cifar10": (load_cifar10_u8, 5),
    "cifar100": (load_cifar100_u8, 5),
    "svhn": (load_svhn_u8, 5),
    "celeba": (load_celeba_u8, 7),
}


def create_from_source(source: str, input_dir: str, out_dir: str,
                       name: Optional[str] = None, parts: int = 1,
                       min_level: int = 2, **loader_kwargs) -> List[str]:
    """One per-source creator: load + shuffled order + per-LOD shards
    (+ '{name}-rNN.labels' sidecar when the source carries labels)."""
    loader, max_level = SOURCE_CREATORS[source]
    images, labels = loader(input_dir, **loader_kwargs)
    order = _shuffled_order(images.shape[0])
    images = images[order]
    name = name or source
    paths = write_multires_shards(images, out_dir, name, max_level,
                                  min_level=min_level, parts=parts)
    if labels is not None:
        lp = os.path.join(out_dir, f"{name}-r{max_level:02d}.labels")
        np.save(lp, labels[order])
        paths.append(lp + ".npy")
    return paths


def split_tfrecords(source_pattern: str, out_pattern: str, part_count: int,
                    train_size: int, min_level: int = 2, max_level: int = 10,
                    out_test_pattern: Optional[str] = None,
                    part_count_test: int = 1) -> int:
    """Split one-file-per-level TFRecords into per-part shards (capability
    parity with split_tfrecords_ffhq.py:96-130, without TensorFlow): the
    first ``train_size`` records of each level go round into ``part_count``
    train parts of train_size//part_count records; the remainder goes to
    test parts."""
    if train_size < part_count:
        raise ValueError(f"train_size {train_size} < part_count {part_count}")
    part_size = train_size // part_count
    total = 0  # records actually written (dropped tails are not counted)
    for level in range(min_level, max_level + 1):
        src = source_pattern % level
        if not os.path.exists(src):
            continue
        writers = []
        for part in range(part_count):
            path = out_pattern % (level, part)
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            writers.append(TFRecordWriter(path))
        test_writers = []
        if out_test_pattern:
            for part in range(part_count_test):
                path = out_test_pattern % (level, part)
                os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
                test_writers.append(TFRecordWriter(path))
        try:
            for n, rec in enumerate(TFRecordFile(src).records()):
                if n < train_size:
                    writers[min(n // part_size, part_count - 1)].write(rec)
                    total += 1
                elif test_writers:
                    test_writers[(n - train_size) % len(test_writers)].write(rec)
                    total += 1
        finally:
            for w in writers + test_writers:
                w.close()
    return total


def main(argv=None):
    ap = argparse.ArgumentParser(prog="prepare-tfrecords")
    sub = ap.add_subparsers(dest="command", required=True)

    p_create = sub.add_parser("create", help="image folder -> per-LOD shards")
    p_create.add_argument("-i", "--input", required=True, help="image folder")
    p_create.add_argument("-o", "--output", required=True, help="output dir")
    p_create.add_argument("--name", default="data")
    p_create.add_argument("--max-level", type=int, default=8)
    p_create.add_argument("--parts", type=int, default=1)
    p_create.add_argument("--limit", type=int, default=None)
    p_create.add_argument("--streaming", action="store_true",
                          help="constant-memory, one image at a time")

    p_src = sub.add_parser("create-source",
                           help="known source layout -> per-LOD shards "
                                "(mnist/mnistrgb/cifar10/cifar100/svhn/celeba)")
    p_src.add_argument("source", choices=sorted(SOURCE_CREATORS))
    p_src.add_argument("-i", "--input", required=True, help="source data dir")
    p_src.add_argument("-o", "--output", required=True, help="output dir")
    p_src.add_argument("--name", default=None)
    p_src.add_argument("--parts", type=int, default=1)
    p_src.add_argument("--num-images", type=int, default=1_000_000,
                       help="mnistrgb only: synthetic RGB triplet count")

    p_lsun = sub.add_parser("create-lsun", help="LSUN LMDB -> per-LOD shards")
    p_lsun.add_argument("-i", "--input", required=True,
                        help="LMDB env dir (or data.mdb path)")
    p_lsun.add_argument("-o", "--output", required=True)
    p_lsun.add_argument("--name", default="lsun")
    p_lsun.add_argument("--resolution", type=int, default=256)
    p_lsun.add_argument("--parts", type=int, default=1)
    p_lsun.add_argument("--max-images", type=int, default=None)
    p_lsun.add_argument("--wide", action="store_true",
                        help="letterboxed width x height variant (create_lsun_wide)")
    p_lsun.add_argument("--width", type=int, default=512)
    p_lsun.add_argument("--height", type=int, default=384)

    p_chq = sub.add_parser("create-celeba-hq",
                           help="pre-generated CelebA-HQ folder -> labeled "
                                "per-LOD train/test fold shards")
    p_chq.add_argument("-i", "--input", required=True, help="image folder")
    p_chq.add_argument("-o", "--output", required=True)
    p_chq.add_argument("--name", default="celeba-hq")
    p_chq.add_argument("--train-size", type=int, default=70000)
    p_chq.add_argument("--test-size", type=int, default=10000)
    p_chq.add_argument("--parts", type=int, default=1)
    p_chq.add_argument("--max-level", type=int, default=8)

    p_split = sub.add_parser("split", help="one-file-per-level -> per-part shards")
    p_split.add_argument("--source", required=True, help="pattern with one %%d (level)")
    p_split.add_argument("--out", required=True, help="pattern with two %% fields (level, part)")
    p_split.add_argument("--out-test", default=None)
    p_split.add_argument("--parts", type=int, required=True)
    p_split.add_argument("--parts-test", type=int, default=1)
    p_split.add_argument("--train-size", type=int, required=True)
    p_split.add_argument("--min-level", type=int, default=2)
    p_split.add_argument("--max-level", type=int, default=10)

    args = ap.parse_args(argv)
    if args.command == "create-source":
        kwargs = {"num_images": args.num_images} if args.source == "mnistrgb" else {}
        paths = create_from_source(args.source, args.input, args.output,
                                   name=args.name, parts=args.parts, **kwargs)
        print(f"wrote {len(paths)} files to {args.output}")
        return
    if args.command == "create-lsun":
        if args.wide:
            paths = create_lsun_wide(args.output, args.input, args.width,
                                     args.height, args.max_images,
                                     name=args.name, parts=args.parts)
        else:
            paths = create_lsun(args.output, args.input, args.resolution,
                                args.max_images, name=args.name, parts=args.parts)
        print(f"wrote {len(paths)} shards to {args.output}")
        return
    if args.command == "create-celeba-hq":
        paths = create_celeba_hq(args.input, args.output,
                                 train_size=args.train_size,
                                 test_size=args.test_size, parts=args.parts,
                                 max_level=args.max_level, name=args.name)
        print(f"wrote {len(paths)} shards to {args.output}")
        return
    if args.command == "split":
        n = split_tfrecords(args.source, args.out, args.parts, args.train_size,
                            args.min_level, args.max_level, args.out_test, args.parts_test)
        print(f"split {n} records")
        return
    # default / "create"
    if args.streaming:
        exts = (".jpg", ".jpeg", ".png", ".bmp")
        files = sorted(os.path.join(args.input, f) for f in os.listdir(args.input)
                       if f.lower().endswith(exts))
        if args.limit:
            files = files[: args.limit]
        paths = write_multires_shards_streaming(files, args.output, args.name,
                                                args.max_level, parts=args.parts)
    else:
        imgs = load_folder(args.input, 2 ** args.max_level, args.limit)
        paths = write_multires_shards(imgs, args.output, args.name, args.max_level,
                                      parts=args.parts)
    print(f"wrote {len(paths)} shards to {args.output}")


if __name__ == "__main__":
    main()
