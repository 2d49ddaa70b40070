"""Port parity: the image data layer (data/images.py, data/prefetch.py).

The port's numpy copy of the JAX package's data layer must give the same
batches for the same seed and epoch: exact equality, no tolerance. The
loaders read files written here. ``device_prefetch`` runs on the CPU put.
"""

import pickle

import numpy as np
import pytest
import torch

from soft_intro_vae_tpu.data import images as jax_images
from soft_intro_vae_torch.data import images
from soft_intro_vae_torch.data.prefetch import device_prefetch, device_put_fn
from tests.torch_port_fixtures import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("drop_last", [True, False])
def test_epoch_order_equals_the_jax_package(drop_last):
    data = np.random.default_rng(0).integers(0, 256, (37, 4, 4, 3), dtype=np.uint8)
    port, ref = images.ArrayDataset(data, seed=5), jax_images.ArrayDataset(data, seed=5)
    for epoch in (0, 1, 7):
        a = list(port.epoch(8, drop_last=drop_last, epoch_index=epoch))
        b = list(ref.epoch(8, drop_last=drop_last, epoch_index=epoch))
        assert len(a) == len(b) == (4 if drop_last else 5)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    # an epoch is a pure function of (seed, epoch): a resumed run replays it
    again = list(images.ArrayDataset(data, seed=5).epoch(8, epoch_index=7))
    for x, y in zip(again, port.epoch(8, epoch_index=7)):
        np.testing.assert_array_equal(x, y)


def test_mirror_and_monsters_augments_draw_as_the_jax_package():
    batch = np.random.default_rng(1).random((6, 8, 8, 3)).astype(np.float32)
    for fn, ref in ((images.augment_mirror, jax_images.augment_mirror),
                    (images.monsters_augment, jax_images.monsters_augment)):
        a = fn(batch, np.random.default_rng((3, 4)))
        b = ref(batch, np.random.default_rng((3, 4)))
        np.testing.assert_array_equal(a, b)
    flipped = images.augment_mirror(batch, np.random.default_rng(0))
    assert any(np.array_equal(f, x[:, ::-1]) and not np.array_equal(f, x)
               for f, x in zip(flipped, batch))


def test_specs_and_synthetic_images_equal_the_jax_package():
    assert images.DATASETS.keys() == jax_images.DATASETS.keys()
    for name, spec in images.DATASETS.items():
        ref = jax_images.DATASETS[name]
        assert (spec.image_size, spec.channels, spec.cdim, spec.scale) == (
            ref.image_size, ref.channels, ref.cdim, ref.scale)
    assert images.DATASETS["cifar10"] == images.ImageSpec("cifar10", 32, (64, 128, 256), 3)
    np.testing.assert_array_equal(images.SyntheticImages(4, 32, 3, seed=2).images,
                                  jax_images.SyntheticImages(4, 32, 3, seed=2).images)


def test_make_dataset_falls_back_to_synthetic_loudly(tmp_path):
    with pytest.warns(UserWarning, match="synthetic"):
        spec, ds = images.make_dataset("mnist", str(tmp_path), synthetic_n=8)
    assert isinstance(ds, images.SyntheticImages) and ds.images.shape == (8, 28, 28, 1)
    assert spec.channels == (64, 128)
    with pytest.raises(FileNotFoundError):
        images.make_dataset("cifar10", str(tmp_path), synthetic_fallback=False)
    with pytest.raises(NotImplementedError):
        images.make_dataset("imagenet", str(tmp_path))


def _write_cifar(root, rng):
    d = root / "cifar10_ds" / "cifar-10-batches-py"
    d.mkdir(parents=True)
    for i in range(1, 6):
        with open(d / f"data_batch_{i}", "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (2, 3072), dtype=np.uint8)}, f)


@pytest.mark.parametrize("name", ["cifar10", "mnist", "svhn"])
def test_uint8_loaders_keep_bytes_and_equal_the_jax_package(tmp_path, name):
    rng = np.random.default_rng(9)
    if name == "cifar10":
        _write_cifar(tmp_path, rng)
    elif name == "mnist":
        d = tmp_path / "mnist_ds"
        d.mkdir()
        imgs = rng.integers(0, 256, (5, 28, 28), dtype=np.uint8)
        header = b"\x00\x00\x08\x03" + b"".join(v.to_bytes(4, "big") for v in (5, 28, 28))
        (d / "train-images-idx3-ubyte").write_bytes(header + imgs.tobytes())
    else:
        from scipy.io import savemat

        d = tmp_path / "svhn"
        d.mkdir()
        savemat(str(d / "train_32x32.mat"),
                {"X": rng.integers(0, 256, (32, 32, 3, 4), dtype=np.uint8)})
    _, u8 = images.make_dataset(name, str(tmp_path), storage="uint8", synthetic_fallback=False)
    _, f32 = images.make_dataset(name, str(tmp_path), synthetic_fallback=False)
    _, ref = jax_images.make_dataset(name, str(tmp_path), storage="uint8",
                                     synthetic_fallback=False)
    assert u8.images.dtype == np.uint8 and f32.images.dtype == np.float32
    np.testing.assert_array_equal(u8.images, ref.images)
    np.testing.assert_array_equal(images.to_unit_float(u8.images), f32.images)


def test_make_dataset_monsters_forces_float(tmp_path):
    from PIL import Image

    d = tmp_path / "monsters128"
    d.mkdir()
    rng = np.random.default_rng(11)
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, (128, 128, 3), dtype=np.uint8)).save(d / f"m{i}.png")
    _, ds = images.make_dataset("monsters128", str(tmp_path), storage="uint8")
    _, ref = jax_images.make_dataset("monsters128", str(tmp_path), storage="uint8")
    assert ds.images.dtype == np.float32 and ds.augment_fn is images.monsters_augment
    np.testing.assert_array_equal(ds.images, ref.images)


def test_folder_dataset_streams_uint8(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(12)
    for i in range(5):
        Image.fromarray(rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)).save(tmp_path / f"i{i}.png")
    lazy = images.open_image_folder(str(tmp_path), 16, storage="uint8", max_resident_bytes=0)
    resident = images.open_image_folder(str(tmp_path), 16, storage="uint8")
    assert isinstance(lazy, images.FolderDataset) and isinstance(resident, images.ArrayDataset)
    a = next(lazy.epoch(4, epoch_index=0))
    b = next(resident.epoch(4, epoch_index=0))
    assert a.dtype == np.uint8
    np.testing.assert_array_equal(a, b)


def test_device_prefetch_keeps_order_and_copies():
    batches = [np.full((2, 3), i, dtype=np.uint8) for i in range(7)]
    got = list(device_prefetch(iter(batches), size=2, put_fn=device_put_fn("cpu")))
    assert len(got) == 7
    for i, (t, b) in enumerate(zip(got, batches)):
        assert isinstance(t, torch.Tensor) and t.dtype == torch.uint8
        np.testing.assert_array_equal(t.numpy(), b)
        b[...] = 99  # the put copied: the host batch can be reused
        assert int(t[0, 0]) == i


def test_device_prefetch_raises_the_workers_exception():
    def batches():
        yield np.zeros((1,), np.float32)
        raise RuntimeError("decode failed")

    it = device_prefetch(batches(), put_fn=device_put_fn("cpu"))
    assert next(it).shape == (1,)
    with pytest.raises(RuntimeError, match="decode failed"):
        next(it)


def test_the_cuda_put_needs_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        device_put_fn("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        next(device_prefetch(iter([np.zeros(1)])))

