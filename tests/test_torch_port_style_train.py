"""The port's style trainer (soft_intro_vae_torch.train.style) on the CPU.

Tiny width (3 layers, 8 -> 32 channels, latent 16) on the synthetic images
of the JAX package's MultiResImages: vanilla -> intro, a LOD switch that
resets LREQAdam, a transition epoch with the input blend, checkpoints and a
resume that replays an uninterrupted run exactly; the config reader against
the JAX package's ``StyleConfig.from_yaml``; the CLI; and the options that
are not ported yet (the TFRecord streaming route is held to the JAX package
in tests/test_torch_port_streaming.py).
"""

import csv
import dataclasses
import math
import os

import numpy as np
import pytest
import torch

from soft_intro_vae_torch.cli import main as cli
from soft_intro_vae_torch.train.style import (
    MultiResImages,
    StyleConfig,
    _Feed,
    build_style_training,
    train_style_soft_intro_vae,
)
from tests.torch_port_fixtures import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = [os.path.join(ROOT, "configs", n) for n in ("ffhq256.yaml", "celeba-hq256.yaml")]


def _cfg(tmp_path, **kw):
    base = dict(layer_count=3, start_channel_count=8, max_channel_count=32, latent_space_size=16,
                mapping_layers=3, use_synthetic=True, synthetic_n=8,
                lod_2_batch_tables={"1GPU": [4, 4, 2]}, epochs_per_lod=2, train_epochs=4,
                num_vae=1, learning_rates=(0.0015,), output_dir=str(tmp_path / "run"),
                device="cpu", verbose=False, resume=False, seed=3)
    base.update(kw)
    return StyleConfig(**base)


def test_vanilla_intro_lod_switch_and_transition(tmp_path):
    state, summary = train_style_soft_intro_vae(_cfg(tmp_path))
    # epochs 0-1 at LOD 0 (4x4), 2-3 at LOD 1 (8x8); 2 steps each
    assert summary["epochs_run"] == 4 and summary["steps"] == state.step == 8
    assert summary["lods_seen"] == [0, 1]
    # epoch 2 is the first half of LOD 1's cycle: both its steps blend
    assert summary["blended_steps"] == 2
    # the LOD switch at epoch 2 reset both optimizers: 4 updates since
    assert state.opt_e.count == state.opt_d.count == 4
    assert all(math.isfinite(v) for v in summary["last_metrics"].values())
    with open(tmp_path / "run" / "log.csv") as f:
        rows = list(csv.DictReader(f))
    # epoch 0 is vanilla (no fake KL), epoch 1 on are introspective
    assert math.isnan(float(rows[0]["fake_kl"])) and math.isfinite(float(rows[1]["fake_kl"]))
    names = set(os.listdir(tmp_path / "run" / "training_artifacts"))
    assert {"_model_epoch_3_iter_8.ckpt", "_model_epoch_3_iter_8_final.ckpt",
            "_model_epoch_0_iter_2.ckpt.aux.json", "last_checkpoint"} <= names
    # the EMA twin followed the online nets
    online, ema = state.nets.state_dict(), state.ema.state_dict()
    assert any(not torch.equal(online[k], ema[k]) for k in online)


def test_resume_replays_an_uninterrupted_run(tmp_path):
    train_style_soft_intro_vae(_cfg(tmp_path, train_epochs=3))
    resumed, s_res = train_style_soft_intro_vae(_cfg(tmp_path, train_epochs=4, resume=True))
    straight, _ = train_style_soft_intro_vae(_cfg(tmp_path, train_epochs=4,
                                                  output_dir=str(tmp_path / "straight")))
    assert s_res["epochs_run"] == 4 and s_res["steps"] == 2  # one epoch of two steps
    assert resumed.step == straight.step == 8
    for which in ("nets", "ema"):
        a, b = getattr(resumed, which).state_dict(), getattr(straight, which).state_dict()
        for k in a:
            torch.testing.assert_close(a[k], b[k], rtol=0, atol=0, msg=f"{which} {k}")
    for u, v in zip(resumed.opt_d.nu, straight.opt_d.nu):
        torch.testing.assert_close(u, v, rtol=0, atol=0)
    torch.testing.assert_close(resumed.generator.get_state(), straight.generator.get_state())


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: os.path.basename(p))
def test_from_yaml_reads_configs_as_the_jax_package(path):
    from soft_intro_vae_tpu.train.style import StyleConfig as JaxStyleConfig

    opts = ["TRAIN.TRAIN_EPOCHS", "5", "DATASET.SYNTHETIC", "true", "MODEL.BETA_NEG", "[1, 2.5]",
            "TRAIN.LOD_2_BATCH_1GPU", "[8, 4]", "TRAIN.COMPUTE_DTYPE", "float32", "SEED", "0x10"]
    port = StyleConfig.from_yaml(path, opts)
    ref = JaxStyleConfig.from_yaml(path, opts)
    shared = {f.name for f in dataclasses.fields(JaxStyleConfig)} & {
        f.name for f in dataclasses.fields(StyleConfig)}
    assert {"truncation_psi", "adam_beta2", "lod_2_batch_tables", "beta_neg"} <= shared
    for name in sorted(shared):
        assert getattr(port, name) == getattr(ref, name), name
    assert port.train_epochs == 5 and port.seed == 16 and port.beta_neg == (1, 2.5)
    with pytest.raises(ValueError, match="pairs"):
        StyleConfig.from_yaml(path, ["TRAIN.TRAIN_EPOCHS"])


def test_cli_style_on_cpu(tmp_path):
    out = tmp_path / "cli"
    cli.main(["style", "-c", CONFIGS[0], "--device", "cpu",
              "MODEL.LAYER_COUNT", "2", "MODEL.START_CHANNEL_COUNT", "8",
              "MODEL.MAX_CHANNEL_COUNT", "16", "MODEL.LATENT_SPACE_SIZE", "8",
              "MODEL.MAPPING_LAYERS", "2", "DATASET.SYNTHETIC", "true", "DATASET.SYNTHETIC_N", "4",
              "TRAIN.EPOCHS_PER_LOD", "0", "TRAIN.TRAIN_EPOCHS", "2",
              "TRAIN.LOD_2_BATCH_1GPU", "[2, 2]", "TRAIN.COMPUTE_DTYPE", "bfloat16",
              "OUTPUT_DIR", str(out)])
    # EPOCHS_PER_LOD 0 starts at the top LOD; epoch 0 vanilla, epoch 1 intro
    names = os.listdir(out / "training_artifacts")
    assert "ffhq_model_epoch_1_iter_4_final.ckpt" in names
    payload = torch.load(out / "training_artifacts" / "ffhq_model_epoch_1_iter_4.ckpt",
                         weights_only=True)
    assert {"nets", "ema", "opt_e", "opt_d", "step", "lr", "ema_beta", "rng", "epoch"} <= set(payload)
    assert payload["nets"]["decoder.const"].shape == (1, 16, 4, 4)


def test_uint8_feed_is_exact_for_every_byte():
    feed = _Feed(torch.device("cpu"))
    raw = np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1)
    via_table = feed(raw, 1.0, False)
    on_host = feed(raw.astype(np.float32), 1.0, False)
    assert via_table.shape == (1, 1, 16, 16)
    torch.testing.assert_close(via_table, on_host, rtol=0, atol=0)


def test_transition_feed_blends_with_the_half_resolution_input():
    feed = _Feed(torch.device("cpu"))
    raw = (np.random.default_rng(0).random((2, 4, 4, 3)) * 255).astype(np.float32)
    x = raw / 127.5 - 1.0
    coarse = np.repeat(np.repeat(x.reshape(2, 2, 2, 2, 2, 3).mean(axis=(2, 4)), 2, 1), 2, 2)
    got = feed(raw, 0.25, True).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, 0.25 * x + 0.75 * coarse, rtol=1e-6, atol=1e-6)


def test_dataset_replays_an_epoch_and_downscales_by_boxes():
    ds = MultiResImages.synthetic(6, 16, seed=2)
    a = [b.copy() for b in ds.epoch(8, 2, epoch_index=3)]
    b = [b.copy() for b in ds.epoch(8, 2, epoch_index=3)]
    assert len(a) == 3 and all(np.array_equal(x, y) for x, y in zip(a, b))
    full = ds.at_resolution(16)
    np.testing.assert_allclose(ds.at_resolution(8),
                               full.reshape(6, 8, 2, 8, 2, 3).mean(axis=(2, 4)), rtol=1e-6)


def test_entry_points_default_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; the check is for machines without one")
    assert StyleConfig().device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_style_soft_intro_vae(dataclasses.replace(_cfg(tmp_path), device="cuda"))


@pytest.mark.parametrize("change", [dict(num_devices=2),
                                    dict(use_synthetic=False, dataset_path="r%02d.tfrecords")],
                         ids=["data-parallel", "tfrecords"])
def test_unported_options_name_their_roadmap_item(tmp_path, change):
    # data parallelism is ported: num_devices must be the world size; so is
    # TFRecord streaming: DATASET.PATH needs two %-fields, the level and the
    # part; and TRAIN.REMAT (tests/test_torch_port_remat.py)
    err, match = ((ValueError, "num_devices=2 but the world has 1") if "num_devices" in change
                  else (ValueError, "two %-fields"))
    with pytest.raises(err, match=match):
        train_style_soft_intro_vae(_cfg(tmp_path, **change))


def test_norm_impl_plain_and_auto_agree_on_the_cpu(tmp_path):
    _, a = build_style_training(_cfg(tmp_path, norm_impl="plain"))
    _, b = build_style_training(_cfg(tmp_path))
    for k, v in a.nets.state_dict().items():
        torch.testing.assert_close(v, b.nets.state_dict()[k], rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA"):
        x = torch.zeros(1, 3, 4, 4)
        _, c = build_style_training(_cfg(tmp_path, norm_impl="cuda"))
        c.nets.encoder(x, 0, None)


def test_save_figures_writes_ema_grids_at_the_report_cadence(tmp_path):
    """save_figures: an EMA sample grid each time the LOD driver reports (here
    every 4 images: after each step of batch 4, each of batch 2 from 4 images
    on), as the JAX trainer names them; the run's weights stay as they are."""
    kw = dict(report_freq=(0.004,) * 3, train_epochs=3)
    plain, _ = train_style_soft_intro_vae(_cfg(tmp_path, output_dir=str(tmp_path / "a"), **kw))
    state, _ = train_style_soft_intro_vae(_cfg(tmp_path, save_figures=True, **kw))
    names = sorted(os.listdir(tmp_path / "run" / "samples"))
    assert names == ["epoch0_nimg4.jpg", "epoch0_nimg8.jpg", "epoch1_nimg4.jpg", "epoch1_nimg8.jpg",
                     "epoch2_nimg4.jpg", "epoch2_nimg8.jpg"], names
    for k, v in state.nets.state_dict().items():
        torch.testing.assert_close(v, plain.nets.state_dict()[k], rtol=0, atol=0, msg=k)
