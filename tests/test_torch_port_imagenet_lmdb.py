"""Port parity: soft_intro_vae_torch.data.imagenet and data.lmdb_reader (and
the LSUN creators that read through it) against the JAX package.

  * ``LMDBReader.items()`` equals the JAX reader's on the environments that
    tests/lmdb_fixture.py writes (inline, overflow and multi-leaf values, a
    directory path, an empty environment), and a bad file raises in both;
  * ``create_lsun`` and ``create_lsun_wide`` write byte-identical shards;
  * ``ImageNetTFRecords.epoch`` yields byte-identical batches (and labels) to
    the JAX package's for the same (seed, epoch_index): training crops,
    evaluation records, with and without labels, at world 1 and at rank 0
    and 1 of 2, through the native and the Python reader.
"""

import io

import numpy as np
import pytest

from soft_intro_vae_tpu.cli import prepare_tfrecords as jprep
from soft_intro_vae_tpu.data import imagenet as jimagenet
from soft_intro_vae_tpu.data import lmdb_reader as jlmdb
from soft_intro_vae_torch.cli import prepare_tfrecords as prep
from soft_intro_vae_torch.data import imagenet, lmdb_reader
from soft_intro_vae_torch.data.tfrecords import TFRecordWriter, make_example
from tests.lmdb_fixture import write_lmdb
from tests.torch_port_fixtures import one_torch_thread  # noqa: F401


def _items(kind):
    rs = np.random.RandomState(0)
    if kind == "inline":
        return [(f"k{i:03d}".encode(), bytes([i]) * (10 + i)) for i in range(20)]
    if kind == "overflow":
        return [(f"{i:08d}".encode(), rs.bytes(3000 + 4096 * i)) for i in range(4)] + [
            (b"small", b"xy")]
    if kind == "multi-leaf":
        return [(f"key-{i:05d}".encode(), bytes([i % 256]) * 200) for i in range(100)]
    return []


@pytest.mark.parametrize("kind", ["inline", "overflow", "multi-leaf", "empty"])
def test_lmdb_items_are_the_jax_readers(tmp_path, kind):
    write_lmdb(str(tmp_path / "data.mdb"), _items(kind))
    for path in (str(tmp_path / "data.mdb"), str(tmp_path)):  # the file or its directory
        with lmdb_reader.LMDBReader(path) as db, jlmdb.LMDBReader(path) as ref:
            got = list(db.items())
            assert got == list(ref.items()) == sorted(_items(kind))
            assert len(db) == len(ref) and list(db.keys()) == list(ref.keys())
            assert db.meta.main_depth == ref.meta.main_depth


def test_a_bad_lmdb_file_raises_in_both(tmp_path):
    p = str(tmp_path / "data.mdb")
    with open(p, "wb") as f:
        f.write(b"\0" * 8192)
    for reader in (lmdb_reader, jlmdb):
        with pytest.raises(reader.LMDBFormatError, match="magic"):
            reader.LMDBReader(p)


def _webp(arr):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="WEBP", lossless=True)
    return buf.getvalue()


def test_lsun_creators_are_the_jax_package_bytes(tmp_path):
    rs = np.random.RandomState(7)
    items = [(f"{i:040x}".encode(), _webp(rs.randint(0, 255, (48, 64, 3), np.uint8)))
             for i in range(5)]
    items.insert(2, (b"%040x" % 99, b"not an image"))  # skipped by both
    env = str(tmp_path / "data.mdb")
    write_lmdb(env, items)
    for mod, tag in ((prep, "p"), (jprep, "j")):
        mod.create_lsun(str(tmp_path / tag / "sq"), env, resolution=16, max_images=4,
                        name="lsun", parts=2)
        mod.create_lsun_wide(str(tmp_path / tag / "wide"), env, width=32, height=24,
                             name="wide")
    for sub in ("sq", "wide"):
        names = sorted(p.name for p in (tmp_path / "p" / sub).iterdir())
        assert names == sorted(p.name for p in (tmp_path / "j" / sub).iterdir()) and names
        for name in names:
            assert (tmp_path / "p" / sub / name).read_bytes() == \
                (tmp_path / "j" / sub / name).read_bytes(), name


def _write_shards(root, level, parts, n_per_part, src, with_labels, seed=0):
    rng = np.random.default_rng(seed)
    idx = 0
    for part in range(parts):
        with TFRecordWriter(str(root / f"imagenet-r{level:02d}.tfrecords.{part:03d}")) as w:
            for _ in range(n_per_part):
                img = rng.integers(0, 256, (3, src, src), dtype=np.uint8)
                feats = {"data": img.tobytes(), "shape": list(img.shape)}
                if with_labels:
                    feats["label"] = [idx % 7]
                w.write(make_example(feats))
                idx += 1
    return str(root / "imagenet-r%02d.tfrecords.%03d")


def test_source_size_is_the_jax_formula():
    for target in (4, 8, 16, 256):
        for train in (True, False):
            assert imagenet.imagenet_source_size(target, train) == \
                jimagenet.imagenet_source_size(target, train)
    with pytest.raises(ValueError):
        imagenet.imagenet_source_size(100)


@pytest.mark.parametrize("impl", ["native", "python"])
@pytest.mark.parametrize("rank,world", [(0, 1), (0, 2), (1, 2)], ids=["world1", "r0of2", "r1of2"])
@pytest.mark.parametrize("train,labels", [(True, True), (True, False), (False, True)],
                         ids=["train-labels", "train", "eval-labels"])
def test_imagenet_epochs_are_the_jax_package_batches(tmp_path, train, labels, rank, world, impl):
    target = 16
    src = imagenet.imagenet_source_size(target, train)
    pattern = _write_shards(tmp_path, 4, 2, 5, src, labels)
    kw = dict(part_count=2, dataset_size=10, max_resolution_level=4, rank=rank,
              world_size=world, seed=3, train=train, needs_labels=labels)
    port = imagenet.ImageNetTFRecords(pattern, impl=impl, **kw)
    ref = jimagenet.ImageNetTFRecords(pattern, **kw)
    assert len(port) == len(ref) == 10 // world
    for epoch, drop_last in ((0, True), (2, False), (None, True), (None, True)):
        a = list(port.epoch(target, 3, drop_last=drop_last, epoch_index=epoch))
        b = list(ref.epoch(target, 3, drop_last=drop_last, epoch_index=epoch))
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            if labels:
                np.testing.assert_array_equal(x[1], y[1])
                x, y = x[0], y[0]
            assert x.dtype == y.dtype == np.float32 and x.shape[1:] == (target, target, 3)
            np.testing.assert_array_equal(x, y)


def test_imagenet_checks_are_the_jax_packages(tmp_path):
    pattern = _write_shards(tmp_path, 4, 2, 2, 16, with_labels=False)
    port = imagenet.ImageNetTFRecords(pattern, 2, 4, 4, train=True, needs_labels=True)
    with pytest.raises(ValueError, match="expected 18x18"):
        next(port.epoch(16, 2))
    evals = imagenet.ImageNetTFRecords(pattern, 2, 4, 4, train=False, needs_labels=True)
    with pytest.raises(ValueError, match="no int64 'label'"):
        next(evals.epoch(16, 2))
    with pytest.raises(ValueError, match="two %-fields"):
        imagenet.ImageNetTFRecords(pattern.replace("%02d", "04"), 2, 4, 4)
    with pytest.raises(FileNotFoundError, match="no shards for resolution level 3"):
        next(evals.epoch(8, 2))
