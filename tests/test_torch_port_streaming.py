"""Port parity: soft_intro_vae_torch.data.streaming and the style trainer fed
from TFRecord shards, against data/streaming.py and train/style.py.

Shards of 12 images of 32x32 made from a numpy seed, in 2 parts, written by
the port's ``write_multires_shards`` (byte-identical to the JAX package's,
tests/test_torch_port_prepare.py): at levels 2-5, and at level 5 alone (every
LOD box-downscaled from the max level on the host).

  * ``StreamingTFRecords.epoch`` yields byte-identical batches to the JAX
    package's for the same (seed, epoch_index): with and without stored
    levels, uint8 and float32 storage, at world 1 and at rank 0 and 1 of 2,
    with a shuffle buffer that holds the level and one of two batches;
  * a one-field DATASET.PATH raises ValueError (the JAX package: TypeError);
  * a 2-epoch style run from the shards at a tiny width (LOD 1 and LOD 2;
    one vanilla and one intro epoch of 2 steps) against the JAX trainer from
    the same shards, both from the JAX package's initial weights moved by
    0.05 randn and with the same injected latents (decoder noise_mode
    "none", no style mixing): every step's input bit-equal (the streamed
    bytes through each package's table), and the metrics within the
    tolerances of tests/test_torch_port_style_step.py: the first step's
    losses and KLs rel 1e-4 (measured 2.4e-7), loss_e and loss_d of later
    steps rel 2e-3 (measured 1.8e-4);
  * two gloo ranks: each reads its own shards (disjoint, together the world-1
    set) and its rows of each global batch from them; with world_size 1 set
    each reads the whole set and keeps its rows of each global batch; and a
    2-rank style run from the shards ends with the ranks bit-equal.
"""

import dataclasses
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import soft_intro_vae_tpu.train.style as jax_style
from soft_intro_vae_tpu.parallel import mesh as jax_mesh
import soft_intro_vae_torch.train.style as port_style
from soft_intro_vae_tpu.data.streaming import StreamingTFRecords as JaxStreaming
from soft_intro_vae_tpu.data.streaming import find_part_count as jax_find_part_count
from soft_intro_vae_torch.cli.prepare_tfrecords import write_multires_shards
from soft_intro_vae_torch.data.streaming import StreamingTFRecords, check_pattern, find_part_count
from soft_intro_vae_torch.parallel.launch import run_ranks
from soft_intro_vae_torch.parallel.mesh import World
from soft_intro_vae_torch.train.style import StyleConfig, make_style_dataset, rank_batches
from soft_intro_vae_torch.train.style_step import NZ_KEYS
from soft_intro_vae_torch.utils.from_jax import style_state_dict_from_jax
from tests.torch_port_fixtures import one_torch_thread  # noqa: F401

N, SIDE, PARTS, TOP = 12, 32, 2, 5
NAME = "ffhq-r%02d.tfrecords.%03d"


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    root = tmp_path_factory.mktemp("shards")
    images = np.random.default_rng(5).integers(0, 256, (N, SIDE, SIDE, 3), dtype=np.uint8)
    write_multires_shards(images, str(root / "all"), "ffhq", TOP, parts=PARTS)
    write_multires_shards(images, str(root / "top"), "ffhq", TOP, min_level=TOP, parts=PARTS)
    return {"all": str(root / "all" / NAME), "top": str(root / "top" / NAME)}


def _pair(pattern, rank=0, world=1, **kw):
    args = dict(part_count=PARTS, dataset_size=N, max_resolution_level=TOP, rank=rank,
                world_size=world, seed=9, **kw)
    return StreamingTFRecords(pattern, **args), JaxStreaming(pattern, **args)


def _same_batches(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b) and a
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)
    return a


@pytest.mark.parametrize("rank,world", [(0, 1), (0, 2), (1, 2)], ids=["world1", "r0of2", "r1of2"])
@pytest.mark.parametrize("storage", ["uint8", "float32"])
@pytest.mark.parametrize("levels", ["all", "top"], ids=["stored-levels", "max-level-only"])
def test_epochs_are_the_jax_package_batches(shards, levels, storage, rank, world):
    port, ref = _pair(shards[levels], rank, world, storage=storage, buffer_size_mb=0)
    assert sorted(port.filenames) == sorted(ref.filenames)
    assert port.filenames == ref.filenames and len(port) == len(ref) == N // world
    for res in (4, 8, 32):
        for epoch in (0, 3):
            got = _same_batches(port.epoch(res, 2, epoch_index=epoch),
                                ref.epoch(res, 2, epoch_index=epoch))
            assert got[0].dtype == np.dtype(storage) and got[0].shape == (2, res, res, 3)
    # the tail without drop_last, and the epoch counter when no index is given
    _same_batches(port.epoch(8, 4, drop_last=False, epoch_index=1),
                  ref.epoch(8, 4, drop_last=False, epoch_index=1))
    for _ in range(2):
        _same_batches(port.epoch(16, 3), ref.epoch(16, 3))


def test_a_large_buffer_holds_the_level(shards):
    port, ref = _pair(shards["all"], buffer_size_mb=200)
    _same_batches(port.epoch(32, 4, epoch_index=2), ref.epoch(32, 4, epoch_index=2))


def test_a_pattern_needs_two_fields(shards, tmp_path):
    one_field = shards["all"].replace("r%02d", "r05")
    with pytest.raises(ValueError, match="two %-fields"):
        StreamingTFRecords(one_field, PARTS, N, TOP)
    with pytest.raises(TypeError):  # the JAX package formats it and fails there
        JaxStreaming(one_field, PARTS, N, TOP)
    assert check_pattern(NAME) == NAME
    with pytest.raises(ValueError, match="two %-fields"):
        make_style_dataset(StyleConfig(dataset_path=one_field, part_count=PARTS, device="cpu"))
    with pytest.raises(FileNotFoundError, match="no shards at max level"):
        StreamingTFRecords(str(tmp_path / NAME), PARTS, N, TOP)
    for level in (TOP, 2, 9):
        assert find_part_count(shards["all"], level) == jax_find_part_count(shards["all"], level)


def test_style_config_reads_the_dataset_keys(shards):
    cfg = StyleConfig.from_yaml(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "configs", "ffhq256.yaml"),
        ["DATASET.PATH", shards["all"], "DATASET.FLIP_IMAGES", "false"])
    assert (cfg.dataset_size, cfg.part_count, cfg.flip_images) == (60000, 16, False)
    assert (cfg.buffer_size_mb, cfg.rank, cfg.world_size, cfg.host_storage) == (200, None, None,
                                                                                  "uint8")
    ds = make_style_dataset(dataclasses.replace(cfg, part_count=PARTS, dataset_size=N,
                                                max_resolution_level=TOP))
    # no process group: the whole set, uint8 batches, no flips
    assert isinstance(ds, StreamingTFRecords) and (ds.rank, ds.world_size) == (0, 1)
    assert ds.batch_dtype == np.uint8 and not ds.flip
    mine = make_style_dataset(dataclasses.replace(cfg, part_count=PARTS, dataset_size=N,
                                                  max_resolution_level=TOP, rank=1, world_size=2))
    assert mine.filenames[3] == [shards["all"] % (3, 1)]
    with pytest.raises(ValueError, match="not in a world of 1"):
        make_style_dataset(dataclasses.replace(cfg, part_count=PARTS, dataset_size=N,
                                               max_resolution_level=TOP, rank=1, world_size=1))


def test_rank_batches_take_each_route(shards):
    split = StreamingTFRecords(shards["all"], PARTS, N, TOP, rank=1, world_size=2, seed=9)
    whole = StreamingTFRecords(shards["all"], PARTS, N, TOP, seed=9)
    two = World(rank=1, size=2, backend="gloo")
    # shards split over the ranks: this rank's B/N images a step, read from its own shards
    _same_batches(rank_batches(split, 8, 4, 3, two), split.epoch(8, 2, epoch_index=3))
    # every rank streams the whole set: its rows of each global batch
    want = [b[2:4] for b in whole.epoch(8, 4, epoch_index=3)]
    _same_batches(rank_batches(whole, 8, 4, 3, two), want)
    with pytest.raises(ValueError, match="split over 2 ranks"):
        rank_batches(split, 8, 4, 3, World(rank=0, size=4, backend="gloo"))
    with pytest.raises(ValueError, match="rank 2 is not in a world of 2"):
        StreamingTFRecords(shards["all"], PARTS, N, TOP, rank=2, world_size=2)


# -- the style trainer from the shards, against the JAX trainer ----------------

TINY = dict(start_channel_count=8, max_channel_count=16, latent_space_size=8, mapping_layers=2,
            style_mixing_prob=None, truncation_psi=None, epochs_per_lod=0, train_epochs=2,
            num_vae=1, learning_rates=(0.0015,), beta_kl=0.2, beta_rec=0.1,
            part_count=PARTS, dataset_size=N, max_resolution_level=TOP, seed=4,
            verbose=False, resume=False)
FIRST_KEYS = ("loss_e", "loss_d", "rec_loss", "real_kl", "fake_kl")


def _draws(step: int, batch: int, latent: int):
    rs = np.random.RandomState(1000 + step)
    return {k: rs.randn(batch, latent).astype(np.float32) for k in NZ_KEYS}


def _recording(build, record, jax_side: bool):
    """A build_style_steps whose steps take injected latents, noise_mode
    "none", and record (kind, lod, blend, NHWC input, metrics) each step."""

    def recording_build(model, scfg, lod, blended, *rest, **kw):
        steps = build(model, scfg, lod, blended, *rest, noise_mode="none")

        def wrap(fn, kind):
            def step(state, x, blend):
                nz = _draws(len(record), x.shape[0], scfg.latent_size)
                if jax_side:
                    state, m = fn(state, x, blend, {k: jnp.asarray(v) for k, v in nz.items()})
                    xn = np.asarray(x)
                else:
                    state, m = fn(state, x, blend, nz)
                    xn = x.permute(0, 2, 3, 1).numpy()
                record.append((kind, lod, float(blend), xn.copy(),
                               {k: float(v) for k, v in m.items()}))
                return state, m
            return step

        return wrap(steps[0], "vanilla"), wrap(steps[1], "intro")

    return recording_build


@pytest.mark.parametrize("layers", [2, 3], ids=["lod1", "lod2"])
def test_style_run_from_shards_matches_the_jax_trainer(shards, tmp_path, monkeypatch, layers):
    batch = 6
    fields = dict(TINY, layer_count=layers, dataset_path=shards["all"],
                  lod_2_batch_tables={"1GPU": [batch] * layers})
    jcfg = jax_style.StyleConfig(output_dir=str(tmp_path / "jax"), num_devices=1, **fields)
    cfg = StyleConfig(output_dir=str(tmp_path / "port"), device="cpu", **fields)

    # the JAX package's initial weights moved off the init by 0.05 randn, as
    # tests/test_torch_port_style_step.py moves them (at the init decoder
    # block 0's gradient is a sum of cancelling terms, ROADMAP Queue 3)
    jbuild, build = jax_style.build_style_training, port_style.build_style_training
    rs = np.random.RandomState(41)
    np_tree = lambda t: jax.tree_util.tree_map(lambda a: np.array(a, np.float32), t)
    bump = lambda t: jax.tree_util.tree_map(
        lambda a: a + 0.05 * rs.randn(*a.shape).astype(np.float32), np_tree(t))
    _, _, jstate, _ = jbuild(jcfg)
    pe, pd = bump(jstate.params_e), bump(jstate.params_d)
    init = style_state_dict_from_jax(pe, pd, np_tree(jstate.buffers))

    def jax_weights(c):
        model, opt, state, mesh = jbuild(c)
        j = lambda t: jax.tree_util.tree_map(jnp.asarray, t)
        state = state.replace(params_e=j(pe), params_d=j(pd), ema_e=j(pe), ema_d=j(pd))
        return model, opt, jax_mesh.shard_state(state, mesh), mesh

    def from_jax_weights(c):
        model, state = build(c)
        state.nets.load_state_dict(init, strict=True)
        state.ema.load_state_dict(init, strict=True)
        return model, state

    jrec, prec = [], []
    monkeypatch.setattr(jax_style, "build_style_steps",
                        _recording(jax_style.build_style_steps, jrec, True))
    monkeypatch.setattr(port_style, "build_style_steps",
                        _recording(port_style.build_style_steps, prec, False))
    monkeypatch.setattr(jax_style, "build_style_training", jax_weights)
    monkeypatch.setattr(port_style, "build_style_training", from_jax_weights)
    _, jsum = jax_style.train_style_soft_intro_vae(jcfg)
    state, summary = port_style.train_style_soft_intro_vae(cfg)

    steps = N // batch
    assert len(prec) == len(jrec) == 2 * steps == state.step
    assert [r[0] for r in prec] == ["vanilla"] * steps + ["intro"] * steps
    for i, (p, j) in enumerate(zip(prec, jrec)):
        assert p[:3] == j[:3] == (p[0], layers - 1, 1.0)
        assert p[3].shape == (batch, 2 ** (layers + 1), 2 ** (layers + 1), 3)
        np.testing.assert_array_equal(p[3], j[3], err_msg=f"step {i} input")
        keys = [k for k in (FIRST_KEYS if i == 0 else ("loss_e", "loss_d")) if k in j[4]]
        assert keys and set(keys) <= set(p[4]), (keys, sorted(p[4]))
        rel = 1e-4 if i == 0 else 2e-3
        for k in keys:
            assert p[4][k] == pytest.approx(j[4][k], rel=rel, abs=1e-7), f"step {i} {k}"
    assert all(math.isfinite(v) for v in summary["last_metrics"].values())
    assert jsum["epochs_run"] == summary["epochs_run"] == 2


def test_gloo_pair_reads_disjoint_shards(shards, tmp_path):
    config = dict(dataset_path=shards["all"], part_count=PARTS, dataset_size=N,
                  max_resolution_level=TOP, seed=9)
    style = dict(config, layer_count=2, start_channel_count=8, max_channel_count=16,
                 latent_space_size=8, mapping_layers=2, lod_2_batch_tables={"2GPU": [4, 4]},
                 epochs_per_lod=0, train_epochs=2, verbose=False, resume=False,
                 output_dir=str(tmp_path / "run{rank}"))
    res = run_ranks(2, [{"name": "stream", "probe": "stream_probe",
                         "kwargs": {"config": config, "res": 8, "batch": 4}},
                        {"name": "whole", "probe": "stream_probe",
                         "kwargs": {"config": dict(config, world_size=1), "res": 8,
                                    "batch": 4}},
                        {"name": "train", "probe": "training_probe",
                         "kwargs": {"variant": "style", "config": style}}],
                    str(tmp_path), timeout_s=120.0)
    files = [set(r["stream/files"].tolist()) for r in res]
    whole = StreamingTFRecords(shards["all"], PARTS, N, TOP, seed=9)
    assert not files[0] & files[1]
    assert files[0] | files[1] == {f for fs in whole.filenames.values() for f in fs}
    for rank, r in enumerate(res):
        mine = StreamingTFRecords(shards["all"], PARTS, N, TOP, rank=rank, world_size=2, seed=9)
        for e in range(2):
            want = np.stack(list(mine.epoch(8, 2, epoch_index=e)))
            assert r[f"stream/epoch{e}"].shape == (N // 4, 2, 8, 8, 3)
            np.testing.assert_array_equal(r[f"stream/epoch{e}"], want)
    # an explicit world_size 1: every rank streams the whole set and keeps its
    # rows of each global batch
    everything = sorted(f for fs in whole.filenames.values() for f in fs)
    for rank, r in enumerate(res):
        assert r["whole/files"].tolist() == everything
        for e in range(2):
            want = np.stack([b[2 * rank:2 * rank + 2] for b in whole.epoch(8, 4, epoch_index=e)])
            np.testing.assert_array_equal(r[f"whole/epoch{e}"], want)
    trained = [{k: v for k, v in r.items() if k.startswith("train/")} for r in res]
    assert trained[0].keys() == trained[1].keys() and trained[0]
    for k, v in trained[0].items():
        np.testing.assert_array_equal(v, trained[1][k], err_msg=k)
        assert np.all(np.isfinite(v)), k
