"""The JPEG-folder family on the CPU at a tiny size (32x32 files, channels
(4, 8, 8), z 8, batch 4, 40 files streamed by ``FolderDataset``, the
residency bound set to 0 so that the tiny folder streams as the full one
does): a whole run is correct and tight; a row from another file than the
permutation names, beta_neg 256 in place of 1024 and half the batch each
turn ``correct`` false; the folder's writer; ``feed.decode_share`` on a
hand-made ring."""

import copy
import dataclasses
import os
import time

import numpy as np
import pytest

from benchmark.core import harness, jpeg_folder

from .test_bench_program_spans import _run as _spans_run, ring  # noqa: F401
from .test_bench_reference import _half

SEED = 2 ** 33 + 29
WORKLOAD = "image-celeb256.b8"


@pytest.fixture
def tiny_registry(monkeypatch, data_dir):
    """The registry's celeb256 at the tiny widths, and a residency bound of 0."""
    from soft_intro_vae_torch.data import images

    monkeypatch.setitem(images.DATASETS, "celeb256", images.ImageSpec("celeb256", 32, (4, 8, 8), 3))
    monkeypatch.setenv("SIV_MAX_RESIDENT_BYTES", "0")
    return data_dir


def tiny_folder_cell():
    cfg = copy.deepcopy(harness.load_json(harness.HERE, "configs", "image-celeb256.json"))
    cfg["model"].update(image_size=32, channels=[4, 8, 8], z_dim=8)
    cfg["data"].update(files=40)
    cell = {"batch": 4, "warmup_steps": 6, "trace_steps": 2,
            "limits": {"feed_rows_wrong": 0, "loss1_e_gap": 1e-4, "grad_d_gap": 1e-4,
                       "change_median_gap": 1e-4, "replay_loss_e_gap": 1e-4,
                       "replay_change_median_gap": 1e-4}}
    return cfg, cell


def run(cfg, cell, trace=0, seconds=0.5):
    args = harness.parse(["--workload", WORKLOAD, "--seed", str(SEED), "--seconds", str(seconds),
                          "--trace", str(trace)])
    return harness.run_cell(args, harness.manifest(), cfg, cell, time.perf_counter(), "cpu",
                            harness.peaks("H100"))


def test_folder_run_is_correct_and_tight(tiny_registry):
    """Every number at most a third of its limit: the losses and gradients
    within 1e-6 (both sides compute the same float32 step on the same rows),
    the changes within ~3e-5 (Adam's first steps move a coordinate of
    round-off-sized gradient by a whole learning rate); the decode span's
    share is read."""
    cfg, cell = tiny_folder_cell()
    res = run(cfg, cell, trace=1, seconds=1.0)
    assert res["correct"], res["checks"]
    assert res["checks"]["feed_rows_wrong"]["value"] == 0
    for k, v in res["checks"].items():
        assert v["value"] <= v["limit"] / 3, (k, v)
    assert {"step.mfu", "device.idle_share", "feed.decode_share",
            "feed.wait_share"} <= set(res["metrics"])
    assert 0 < res["metrics"]["feed.decode_share"]["value"] < 100


def test_the_checked_rows_are_the_permutations_files_some_mirrored(tiny_registry):
    from benchmark.core.timing import Spans

    cfg, cell = tiny_folder_cell()
    fam = harness.family_class("image_folder")(cfg, cell, SEED, Spans(), "cpu")
    fam.setup()
    try:
        from soft_intro_vae_torch.data.images import FolderDataset

        assert isinstance(fam.dataset, FolderDataset)
        assert fam.dataset.decoded_images >= 6 * 4
    finally:
        fam.close()
    recs, matched, wrong = fam.check_feed()
    assert wrong == 0 and len(matched) == 6 and recs.shape == (24, 32, 32, 3)
    flips = np.concatenate(matched)[:, 1]
    assert 0 < flips.sum() < flips.size
    perm = np.random.default_rng((max(fam.icfg.seed, 0), 0)).permutation(40)
    # the first checked row's file is, of all 40 pictures, nearest the
    # permutation's first (JPEG keeps a picture near its source)
    gaps = [np.abs(recs[0].astype(int) - jpeg_folder.picture(cfg["data"]["seed"], i, 32)).mean()
            for i in range(40)]
    assert int(np.argmin(gaps)) == int(perm[0])


def _swap_rows(batches):
    def fed(*a, **kw):
        for batch in batches(*a, **kw):
            batch = batch.copy()
            batch[[0, 1]] = batch[[1, 0]]  # each row another file than its place names
            yield batch
    return fed


def _beta_neg_256(build):
    def built(cfg, *a, **kw):
        return build(dataclasses.replace(cfg, beta_neg=256.0), *a, **kw)
    return built


@pytest.mark.parametrize("fault", ["row_of_another_file", "beta_neg_256", "half_batch"])
def test_a_broken_folder_path_is_not_correct(fault, tiny_registry, monkeypatch):
    import soft_intro_vae_torch.train.graph as graph
    import soft_intro_vae_torch.train.image as image
    import soft_intro_vae_torch.train.step as step

    if fault == "row_of_another_file":
        monkeypatch.setattr(image, "host_batches", _swap_rows(image.host_batches))
    elif fault == "beta_neg_256":
        monkeypatch.setattr(image, "build_image_training",
                            _beta_neg_256(image.build_image_training))
    else:
        for mod in (graph, step):
            real = mod.one_step
            monkeypatch.setattr(mod, "one_step", lambda s, real=real: real(_half(s)))
    cfg, cell = tiny_folder_cell()
    res = run(cfg, cell)
    assert not res["correct"], res["checks"]
    if fault == "row_of_another_file":
        assert res["checks"]["feed_rows_wrong"]["value"] == 2 * 6
    else:
        assert res["checks"]["feed_rows_wrong"]["value"] == 0
        assert res["checks"]["loss1_e_gap"]["value"] > cell["limits"]["loss1_e_gap"]


def test_the_writer_is_deterministic(data_dir, tmp_path, monkeypatch):
    """Two writes of one key into two data directories hold the same bytes;
    a second call finds the folder and writes nothing."""
    from benchmark.core import data

    a = jpeg_folder.folder(7, 5, 16, "celeb256", 95)
    monkeypatch.setattr(data, "DATA_DIR", str(tmp_path / "other"))
    b = jpeg_folder.folder(7, 5, 16, "celeb256", 95)
    names = sorted(os.listdir(os.path.join(a, "celeb256")))
    assert names == [jpeg_folder.NAME % i for i in range(5)]
    for n in names:
        with open(os.path.join(a, "celeb256", n), "rb") as fa, \
                open(os.path.join(b, "celeb256", n), "rb") as fb:
            assert fa.read() == fb.read()
    stamp = os.path.getmtime(os.path.join(b, "celeb256", names[0]))
    assert jpeg_folder.folder(7, 5, 16, "celeb256", 95) == b
    assert os.path.getmtime(os.path.join(b, "celeb256", names[0])) == stamp
    assert not os.path.exists(b + ".part")


def test_the_key_changes_with_the_content(monkeypatch):
    base = jpeg_folder.key(7, 5, 16, 95)
    assert len({base, jpeg_folder.key(8, 5, 16, 95), jpeg_folder.key(7, 6, 16, 95),
                jpeg_folder.key(7, 5, 32, 95), jpeg_folder.key(7, 5, 16, 90)}) == 5
    monkeypatch.setattr(jpeg_folder, "CONTENT", jpeg_folder.CONTENT + " changed")
    assert jpeg_folder.key(7, 5, 16, 95) != base


def test_pictures_are_smooth_fields_with_noise():
    """Neighbouring pixels differ by the noise's few levels, not by white
    noise's ~85; each picture is its own."""
    a, b = jpeg_folder.picture(3, 0, 64), jpeg_folder.picture(3, 1, 64)
    assert a.dtype == np.uint8 and a.shape == (64, 64, 3)
    step = np.abs(np.diff(a.astype(int), axis=1)).mean()
    assert 5 < step < 20
    assert not np.array_equal(a, b)
    assert np.array_equal(a, jpeg_folder.picture(3, 0, 64))


def test_decode_share_sums_the_decodes_inside_the_window(ring):  # noqa: F811
    ring("feed.decode", 99.5, 100.5, 2, parent=7)   # half inside
    ring("feed.decode", 104.0, 104.25, 2)
    ring("feed.produce", 104.0, 104.5, 2, child=0.25)  # not a decode
    ring("feed.decode", 109.9, 110.3, 2)      # 0.1 s inside
    got = harness.load_reader("feed.decode_share")(_spans_run())
    assert got == pytest.approx(100.0 * 0.85 / 10.0)
    ring.ring.records.clear()
    ring("feed.produce", 101.0, 102.0, 2)
    assert harness.load_reader("feed.decode_share")(_spans_run()) is None
