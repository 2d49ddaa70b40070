"""Port parity: soft_intro_vae_torch.data.tfrecords against data/tfrecords.py.

The port's writer and readers on small shards (a few records of 8-16 px
images made from a numpy seed): files byte-identical to the JAX package's,
records and examples equal between the native reader (built with g++ into
soft_intro_vae_torch/_build/) and the Python parser and equal to the JAX
package's, CRC corruption and truncation raising in both impls, a failed
build raising instead of falling back, and the in-memory
``MultiResImages.from_tfrecords`` route. Tolerance: none, every comparison
is exact.
"""

import os

import numpy as np
import pytest

from soft_intro_vae_tpu.data import tfrecords as jtfr
from soft_intro_vae_tpu.train.style import MultiResImages as JaxMultiResImages
from soft_intro_vae_torch.data import tfrecords as tfr
from soft_intro_vae_torch.ops import cuda_build
from soft_intro_vae_torch.train.style import MultiResImages
from tests.torch_port_fixtures import one_torch_thread  # noqa: F401

IMPLS = ("native", "python")


def _examples(seed=0, n=5, side=8, labels=True):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        chw = rng.integers(0, 256, (3, side, side), dtype=np.uint8)
        feats = {"shape": list(chw.shape), "data": chw.tobytes()}
        if labels and i % 2 == 0:  # every other record has no label
            feats["label"] = [int(rng.integers(0, 1000))]
        out.append((tfr.make_example(feats), chw))
    return out


@pytest.fixture
def shard(tmp_path):
    exs = _examples()
    path = str(tmp_path / "a.tfrecords")
    tfr.write_tfrecord(path, [e for e, _ in exs])
    return path, exs


def test_native_library_is_built_from_the_port_source_into_its_build_dir():
    lib = tfr.native_library()
    path = cuda_build.library_path(tfr.NATIVE_SRC, "tfrecord",
                                   base_flags=("g++", *cuda_build.HOST_FLAGS))
    assert os.path.exists(path) and path.startswith(cuda_build.BUILD_DIR)
    assert tfr.NATIVE_SRC.endswith(os.path.join("soft_intro_vae_torch", "native",
                                                "tfrecord_reader.cpp"))
    assert lib is tfr.native_library()


@pytest.mark.parametrize("impl", IMPLS)
def test_written_files_are_the_jax_package_bytes(tmp_path, impl):
    exs = [e for e, _ in _examples(seed=1, n=7, side=16)]
    assert [tfr.make_example({"k": b"\x00\x01", "i": [3, -1, 2**40]})] == \
        [jtfr.make_example({"k": b"\x00\x01", "i": [3, -1, 2**40]})]
    tfr.write_tfrecord(str(tmp_path / "port"), exs)
    jtfr.write_tfrecord(str(tmp_path / "jax"), exs)
    assert (tmp_path / "port").read_bytes() == (tmp_path / "jax").read_bytes()
    # each reader takes the written CRCs and returns the records
    assert list(tfr.TFRecordFile(str(tmp_path / "port"), impl=impl).records()) == exs


@pytest.mark.parametrize("n", [0, 1, 7, 8, 4097])
def test_masked_crc_native_python_and_jax_agree(n):
    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8).tobytes()
    want = jtfr.masked_crc(data)
    assert tfr.masked_crc(data, "python") == tfr.masked_crc(data, "native") == want
    # the TFRecord convention: CRC32C("123456789") is 0xE3069283
    assert tfr.crc32c(b"123456789") == 0xE3069283


@pytest.mark.parametrize("impl", IMPLS)
def test_records_and_examples_match_the_jax_reader(shard, impl):
    path, exs = shard
    f = tfr.TFRecordFile(path, impl=impl)
    ref = jtfr.TFRecordFile(path)
    assert list(f.records()) == list(ref.records()) == [e for e, _ in exs]
    got = list(f.examples())
    assert got == list(ref.examples())
    for (data, shape), (_, chw) in zip(got, exs):
        assert shape == (3, 8, 8) and data == chw.tobytes()
    labelled = list(f.examples_with_label())
    assert labelled == list(ref.examples_with_label())
    assert [lab is None for _, _, lab in labelled] == [i % 2 == 1 for i in range(len(exs))]
    # a key that no record holds: empty data and no shape, as in the JAX package
    assert list(f.examples("nope", "none")) == [(b"", None)] * len(exs)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("where", ["length", "data"])
def test_crc_corruption_raises(shard, tmp_path, impl, where):
    path, _ = shard
    raw = bytearray(open(path, "rb").read())
    raw[3 if where == "length" else 40] ^= 0x10
    bad = tmp_path / "bad.tfrecords"
    bad.write_bytes(bytes(raw))
    with pytest.raises(IOError, match="corrupt"):
        list(tfr.TFRecordFile(str(bad), impl=impl).records())
    if where == "data":  # without the check the framing still reads
        assert len(list(tfr.TFRecordFile(str(bad), check_crc=False, impl=impl).records())) == 5


@pytest.mark.parametrize("impl", IMPLS)
def test_truncation_and_missing_files(shard, tmp_path, impl):
    path, _ = shard
    raw = open(path, "rb").read()
    cut = tmp_path / "cut.tfrecords"
    cut.write_bytes(raw[:-10])  # the last record's data is short
    with pytest.raises(IOError, match="corrupt"):
        list(tfr.TFRecordFile(str(cut), impl=impl).records())
    cut.write_bytes(raw + raw[:5])  # a partial header ends the file
    assert len(list(tfr.TFRecordFile(str(cut), impl=impl).records())) == 5
    with pytest.raises(FileNotFoundError):
        list(tfr.TFRecordFile(str(tmp_path / "none"), impl=impl).records())


def test_unknown_impl_raises(shard):
    with pytest.raises(ValueError, match="impl"):
        tfr.TFRecordFile(shard[0], impl="jax")
    with pytest.raises(ValueError, match="impl"):
        tfr.masked_crc(b"x", "fast")


def test_a_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    tfr.write_tfrecord(str(tmp_path / "w"), [b"x"])
    src = tmp_path / "broken.cpp"
    src.write_text("this is not C++\n")
    monkeypatch.setattr(tfr, "NATIVE_SRC", str(src))
    monkeypatch.setattr(tfr, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as err:
        tfr.native_library()
    assert "broken.cpp" in str(err.value)
    # the Python reader does not need the library; the native reader and the
    # writer raise again, and the writer opens no file
    assert list(tfr.TFRecordFile(str(tmp_path / "w"), impl="python").records()) == [b"x"]
    with pytest.raises(RuntimeError):
        list(tfr.TFRecordFile(str(tmp_path / "w")).records())
    with pytest.raises(RuntimeError):
        tfr.write_tfrecord(str(tmp_path / "w2"), [b"x"])
    assert not (tmp_path / "w2").exists()


@pytest.mark.parametrize("world", [1, 2, 4])
def test_shard_assignment_matches_the_jax_package(world):
    paths = [f"d-r08.tfrecords.{i:03d}" for i in (3, 0, 7, 1, 2, 6, 5, 4)]
    for rank in range(world):
        assert tfr.shard_paths_for_rank(paths, rank, world) == \
            jtfr.shard_paths_for_rank(paths, rank, world)
    with pytest.raises(ValueError, match="divisible"):
        tfr.shard_paths_for_rank(paths, 0, 3)


@pytest.mark.parametrize("impl", IMPLS)
def test_load_uint8_images_and_from_tfrecords_match_the_jax_package(tmp_path, impl):
    rng = np.random.default_rng(7)
    paths = []
    for part in range(2):
        p = str(tmp_path / f"x-r04.tfrecords.{part:03d}")
        exs = [tfr.make_example({"shape": [3, 16, 16],
                                 "data": rng.integers(0, 256, (3, 16, 16), np.uint8).tobytes()})
               for _ in range(3)]
        # a record without a shape is taken as square
        exs.append(tfr.make_example({"data": rng.integers(0, 256, 3 * 16 * 16, np.uint8).tobytes()}))
        tfr.write_tfrecord(p, exs)
        paths.append(p)
    got = tfr.load_uint8_images(paths, impl=impl)
    assert got.shape == (8, 16, 16, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, jtfr.load_uint8_images(paths))
    for rank in range(2):
        port = MultiResImages.from_tfrecords(paths, rank=rank, world_size=2, seed=3,
                                             storage="uint8")
        ref = JaxMultiResImages.from_tfrecords(paths, rank=rank, world_size=2, seed=3,
                                               storage="uint8")
        for res in (16, 8):
            a = list(port.epoch(res, 2, epoch_index=1))
            b = list(ref.epoch(res, 2, epoch_index=1))
            assert len(a) == len(b) == 2
            for x, y in zip(a, b):
                assert x.dtype == y.dtype == np.uint8
                np.testing.assert_array_equal(x, y)
