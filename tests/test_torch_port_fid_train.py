"""The image and style trainers with ``with_fid=True`` on the CPU, at a tiny width.

FID is taken at the JAX trainers' cadence, named ``fid_selfconsistent``
without the pt_inception weights on disk (``fid`` with them), and the best
score's state is saved under a tagged name. With FID on, every loss,
weight and the generator's state equal those of the same run with it off:
the FID draws from a generator of its own and reads the decoder in eval
mode. The feature network is the Inception stem's first tap here (a real
InceptionV3FID, 64 features), since the full network's 2048x2048
Newton-Schulz and 299x299 forwards take minutes on one CPU thread;
test_torch_port_fid.py holds each block to the JAX package and
test_torch_port_fid_slow.py the whole network.
"""

import csv
import math
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from soft_intro_vae_torch.data.images import ArrayDataset, ImageSpec
from soft_intro_vae_torch.metrics import fid
from soft_intro_vae_torch.train.image import ImageConfig, build_image_training, train_soft_intro_vae
from soft_intro_vae_torch.train.style import StyleConfig, train_style_soft_intro_vae
from tests.torch_port_fixtures import one_torch_thread  # noqa: F401

SPEC = ImageSpec("cifar10", 16, (8, 16), 3)


class _Stem(torch.nn.Module):
    """The Inception stem to its first tap at 75x75, averaged: (B, 64)."""

    def __init__(self):
        super().__init__()
        torch.manual_seed(0)
        self.net = fid.InceptionV3FID(output_blocks=(0,), resize_input=False)

    def forward(self, x):
        x = F.interpolate(x, size=(75, 75), mode="bilinear", align_corners=False)
        return self.net(x)[0].mean(dim=(2, 3))


@pytest.fixture
def stem_fid(monkeypatch, tmp_path):
    """The trainers' FID network is the stem; no weights file is on disk."""
    feats = fid.InceptionFeatures(_Stem(), torch.device("cpu"))
    monkeypatch.setattr(fid, "load_fid_network", lambda *a, **k: feats)
    monkeypatch.setattr(fid, "CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.chdir(tmp_path)
    return feats


def _image_cfg(tmp_path, name, **kw):
    base = dict(dataset="cifar10", z_dim=8, batch_size=4, num_epochs=3, num_vae=1, beta_neg=16.0,
                seed=0, verbose=False, result_dir=str(tmp_path / name), device="cpu",
                fid_num_images=6)
    return ImageConfig(**{**base, **kw})


def _u8(n=8, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, 16, 16, 3), dtype=np.uint8)


def _assert_same_run(a, b):
    (sa, ma), (sb, mb) = a, b
    assert ma["last_metrics"] == mb["last_metrics"]
    for k, v in sa.model.state_dict().items():
        torch.testing.assert_close(v, sb.model.state_dict()[k], rtol=0, atol=0, msg=k)
    torch.testing.assert_close(sa.generator.get_state(), sb.generator.get_state())


def _csv(path):
    with open(path) as f:
        return list(csv.DictReader(f))


@pytest.mark.parametrize("scan_steps", [1, 2])
def test_image_run_with_fid_equals_the_run_without(tmp_path, stem_fid, scan_steps):
    plain = train_soft_intro_vae(_image_cfg(tmp_path, "plain", scan_steps=scan_steps),
                                 ArrayDataset(_u8(), seed=1), SPEC)
    with_fid = train_soft_intro_vae(_image_cfg(tmp_path, "fid", with_fid=True, scan_steps=scan_steps),
                                    ArrayDataset(_u8(), seed=1), SPEC)
    _assert_same_run(with_fid, plain)
    state, summary = with_fid
    assert summary["fid_metric"] == "fid_selfconsistent" and plain[1]["best_fid"] is None
    assert math.isfinite(summary["best_fid"]) and summary["best_fid"] > 0
    assert state.decoder.training  # back in train mode after the evaluations
    # the cadence: epoch 0 and the last, not epoch 1
    rows = _csv(tmp_path / "fid" / "log.csv")
    fids = [float(r["fid_selfconsistent"]) for r in rows]
    assert math.isfinite(fids[0]) and math.isnan(fids[1]) and math.isfinite(fids[2])
    assert summary["best_fid"] == min(fids[0], fids[2])
    tagged = [n for n in os.listdir(tmp_path / "fid" / "saves") if "_fid_selfconsistent_" in n]
    assert f"_fid_selfconsistent_{summary['best_fid']:.3f}.ckpt" in " ".join(tagged)


def test_image_fid_is_named_fid_with_the_weights_on_disk(tmp_path, stem_fid):
    (tmp_path / fid.FID_WEIGHTS_FILENAME).write_bytes(b"")  # found by fid_weights_path
    _, summary = train_soft_intro_vae(_image_cfg(tmp_path, "w", with_fid=True, num_epochs=1),
                                      ArrayDataset(_u8(), seed=1), SPEC)
    assert summary["fid_metric"] == "fid" and math.isfinite(summary["best_fid"])
    assert "fid" in _csv(tmp_path / "w" / "log.csv")[0]


def test_training_fid_hook_caches_the_real_statistics(tmp_path, stem_fid):
    cfg = _image_cfg(tmp_path, "hook")
    state, _, _ = build_image_training(cfg, SPEC)
    fid_fn = fid.make_training_fid(cfg)
    with pytest.raises(ValueError, match="dataset"):
        fid_fn(state, None, num_images=4, batch_size=4)
    before = state.generator.get_state()
    first = fid_fn(state, ArrayDataset(_u8(), seed=1), num_images=4, batch_size=4)
    assert fid_fn(state, None, num_images=4, batch_size=4) == first  # cached reals, same draws
    torch.testing.assert_close(state.generator.get_state(), before)
    state.decoder.eval()
    assert fid_fn(state, None, num_images=4, batch_size=4) == first
    assert not state.decoder.training  # the mode it was given is restored


def _style_cfg(tmp_path, name, **kw):
    base = dict(layer_count=3, start_channel_count=8, max_channel_count=32, latent_space_size=16,
                mapping_layers=3, use_synthetic=True, synthetic_n=8,
                lod_2_batch_tables={"1GPU": [4, 4, 4]}, epochs_per_lod=1, train_epochs=5,
                num_vae=1, learning_rates=(0.0015,), output_dir=str(tmp_path / name),
                device="cpu", verbose=False, resume=False, seed=3, fid_every=1, fid_num_images=4)
    base.update(kw)
    return StyleConfig(**base)


def test_style_run_with_fid_equals_the_run_without(tmp_path, stem_fid):
    plain, _ = train_style_soft_intro_vae(_style_cfg(tmp_path, "plain"))
    state, summary = train_style_soft_intro_vae(_style_cfg(tmp_path, "fid", with_fid=True))
    for which in ("nets", "ema"):
        a, b = getattr(state, which).state_dict(), getattr(plain, which).state_dict()
        for k in a:
            torch.testing.assert_close(a[k], b[k], rtol=0, atol=0, msg=f"{which} {k}")
    torch.testing.assert_close(state.generator.get_state(), plain.generator.get_state())
    # FID from epoch epochs_per_lod * (layer_count - 1) + 1 = 3 on, at the last LOD (16x16)
    rows = _csv(tmp_path / "fid" / "log.csv")
    fids = [float(r["fid_selfconsistent"]) for r in rows]
    assert [math.isfinite(v) for v in fids] == [False, False, False, True, True]
    assert summary["fid_metric"] == "fid_selfconsistent" and summary["best_fid"] == min(fids[3:])
    names = os.listdir(tmp_path / "fid" / "training_artifacts")
    assert any(f"_lod2_fid_selfconsistent_{summary['best_fid']:.2f}.ckpt" in n for n in names)
