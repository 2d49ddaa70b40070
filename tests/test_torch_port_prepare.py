"""Port parity: soft_intro_vae_torch.cli.prepare_tfrecords against
cli/prepare_tfrecords.py.

Every writer of the port and of the JAX package runs on the same inputs,
made from a numpy seed at small sizes (8-24 images of 8-32 px, 1-3 parts),
and the files they write must be byte-identical: the per-LOD shards in
memory and streamed from an image folder, the per-source creators (svhn
from pickled batches, celeba from 218x178 PNGs, as tests/test_prepare_sources.py
makes them) with their label sidecars, CelebA-HQ's labelled train/test folds,
the split tool, and the ``create`` and ``split`` subcommands of ``main``.
"""

import os
import pickle

import numpy as np
import pytest

from soft_intro_vae_tpu.cli import prepare_tfrecords as jprep
from soft_intro_vae_torch.cli import prepare_tfrecords as prep
from soft_intro_vae_torch.data.tfrecords import TFRecordFile, make_example, write_tfrecord
from tests.torch_port_fixtures import one_torch_thread  # noqa: F401


def _images(n, side, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, side, side, 3), dtype=np.uint8)


def _same_tree(a, b):
    """Both directories hold the same files with the same bytes."""
    names = sorted(os.listdir(a))
    assert names and names == sorted(os.listdir(b))
    for name in names:
        with open(os.path.join(a, name), "rb") as fa, open(os.path.join(b, name), "rb") as fb:
            assert fa.read() == fb.read(), name
    return names


def test_downscale_is_the_jax_package_rounding():
    img = _images(1, 16, seed=3)[0]
    np.testing.assert_array_equal(prep.downscale_u8(img), jprep.downscale_u8(img))


@pytest.mark.parametrize("parts,min_level", [(1, 2), (2, 2), (3, 3), (2, 5)])
def test_multires_shards_are_the_jax_package_bytes(tmp_path, parts, min_level):
    images = _images(12, 32, seed=parts)
    got = prep.write_multires_shards(images, str(tmp_path / "p"), "d", 5, min_level, parts)
    want = jprep.write_multires_shards(images, str(tmp_path / "j"), "d", 5, min_level, parts)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    names = _same_tree(tmp_path / "p", tmp_path / "j")
    assert len(names) == parts * (6 - min_level)
    # level 5's part 0 holds images 0, parts, 2 parts, ... as CHW bytes
    recs = list(TFRecordFile(str(tmp_path / "p" / "d-r05.tfrecords.000")).examples())
    assert recs[1] == (images[parts].transpose(2, 0, 1).tobytes(), (3, 32, 32))


def _png_folder(path, n, side, seed):
    from PIL import Image

    os.makedirs(path)
    for i, img in enumerate(_images(n, side, seed)):
        Image.fromarray(img).save(os.path.join(path, f"{i:03d}.png"))
    return path


def test_streaming_writer_and_load_folder_are_the_jax_package_bytes(tmp_path):
    folder = _png_folder(str(tmp_path / "png"), 8, 24, seed=4)  # resized to 16 (LANCZOS)
    files = sorted(os.path.join(folder, f) for f in os.listdir(folder))
    prep.write_multires_shards_streaming(files, str(tmp_path / "p"), "s", 4, parts=2)
    jprep.write_multires_shards_streaming(files, str(tmp_path / "j"), "s", 4, parts=2)
    _same_tree(tmp_path / "p", tmp_path / "j")
    np.testing.assert_array_equal(prep.load_folder(folder, 16, limit=5),
                                  jprep.load_folder(folder, 16, limit=5))


def _write_svhn(d, n_per_batch=3):
    rng = np.random.RandomState(1)
    for batch in range(1, 4):
        images = rng.randint(0, 256, (n_per_batch, 3, 32, 32), dtype=np.uint8)
        labels = rng.randint(0, 10, n_per_batch).astype(np.uint8)
        labels[0] = 9  # every class index up to 9 appears in the one-hot width
        with open(os.path.join(d, f"train_{batch}.pkl"), "wb") as f:
            pickle.dump((images, labels), f)


def _write_celeba(d, n=4):
    from PIL import Image

    src = os.path.join(d, "img_align_celeba_png")
    os.makedirs(src)
    rng = np.random.RandomState(2)
    for i in range(n):
        Image.fromarray(rng.randint(0, 256, (218, 178, 3), dtype=np.uint8)).save(
            os.path.join(src, f"{i:06d}.png"))


@pytest.mark.parametrize("source,parts", [("svhn", 1), ("svhn", 3), ("celeba", 2)])
def test_create_from_source_is_the_jax_package_bytes(tmp_path, source, parts):
    src = tmp_path / source
    if source == "svhn":
        src.mkdir()
        _write_svhn(str(src))
        kw = {}
    else:
        _write_celeba(str(src))
        kw = {"expected_images": None}
    got = prep.create_from_source(source, str(src), str(tmp_path / "p"), parts=parts, **kw)
    jprep.create_from_source(source, str(src), str(tmp_path / "j"), parts=parts, **kw)
    names = _same_tree(tmp_path / "p", tmp_path / "j")
    assert (source == "svhn") == any(n.endswith(".labels.npy") for n in names)
    assert len(got) == len(names)
    assert set(prep.SOURCE_CREATORS) == set(jprep.SOURCE_CREATORS)


def test_celeba_hq_folds_are_the_jax_package_bytes(tmp_path):
    from PIL import Image

    src = tmp_path / "hq"
    src.mkdir()
    for i, img in enumerate(_images(9, 16, seed=6)):
        Image.fromarray(img).save(src / f"{i * 3}.png")
    kw = dict(train_size=6, test_size=3, parts=2, max_level=4, name="chq")
    got = prep.create_celeba_hq(str(src), str(tmp_path / "p"), **kw)
    jprep.create_celeba_hq(str(src), str(tmp_path / "j"), **kw)
    names = _same_tree(tmp_path / "p", tmp_path / "j")
    assert len(got) == len(names) == 2 * 2 * 3  # train and test, 2 parts, levels 2-4
    labels = [lab for _, _, lab in TFRecordFile(
        str(tmp_path / "p" / "chq-r04.tfrecords.000")).examples_with_label()]
    assert labels and all(lab % 3 == 0 for lab in labels)


def _level_files(root, n=10, side=16, seed=7):
    """One file a level (2-4) of ``n`` records, as the reference's exporter writes."""
    os.makedirs(root)
    images = _images(n, side, seed)
    for level in (4, 3, 2):
        write_tfrecord(os.path.join(root, f"src-r{level:02d}.tfrecords"),
                       [make_example({"shape": [3, 2 ** level, 2 ** level],
                                      "data": img.transpose(2, 0, 1).tobytes()})
                        for img in images])
        images = np.stack([prep.downscale_u8(im) for im in images])
    return os.path.join(root, "src-r%02d.tfrecords")


@pytest.mark.parametrize("with_test", [False, True], ids=["train", "train-test"])
def test_split_is_the_jax_package_bytes(tmp_path, with_test):
    source = _level_files(str(tmp_path / "src"))
    out = {k: str(tmp_path / k / "d-r%02d.tfrecords.%03d") for k in ("p", "j")}
    test = {k: str(tmp_path / k / "d-test-r%02d.tfrecords.%03d") if with_test else None
            for k in ("p", "j")}
    n = prep.split_tfrecords(source, out["p"], 3, 7, 2, 4, test["p"], 2)
    assert n == jprep.split_tfrecords(source, out["j"], 3, 7, 2, 4, test["j"], 2)
    names = _same_tree(tmp_path / "p", tmp_path / "j")
    assert len(names) == 3 * (3 + 2 * with_test)


def test_main_create_and_split_are_the_jax_package_bytes(tmp_path, capsys):
    folder = _png_folder(str(tmp_path / "png"), 6, 16, seed=8)
    for main, tag in ((prep.main, "p"), (jprep.main, "j")):
        main(["create", "-i", folder, "-o", str(tmp_path / tag / "c"), "--name", "x",
              "--max-level", "4", "--parts", "2"])
        main(["create", "-i", folder, "-o", str(tmp_path / tag / "s"), "--name", "x",
              "--max-level", "4", "--parts", "2", "--streaming", "--limit", "4"])
        main(["split", "--source", os.path.join(str(tmp_path / tag / "c"), "x-r%02d.tfrecords.000"),
              "--out", os.path.join(str(tmp_path / tag / "split"), "y-r%02d.tfrecords.%03d"),
              "--parts", "1", "--train-size", "3", "--max-level", "4"])
    for sub in ("c", "s", "split"):
        _same_tree(tmp_path / "p" / sub, tmp_path / "j" / sub)
    out = capsys.readouterr().out
    assert "wrote 6 shards" in out and "split 9 records" in out
