"""Tiny configurations of the benchmark's two families, for CPU tests."""

import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def data_dir(tmp_path, monkeypatch):
    from benchmark.core import data

    monkeypatch.setattr(data, "DATA_DIR", str(tmp_path / "data"))
    return tmp_path / "data"


def tiny_style(dtype: str = "float32"):
    """The style configuration at 3 blocks, 4 -> 16 channels, latent 16; LOD 2
    (16x16) from level-5 shards, so the max-level route downscales."""
    from benchmark.core import harness

    cfg = copy.deepcopy(harness.load_json(harness.HERE, "configs", "style-ffhq256.json"))
    cfg["model"].update(LATENT_SPACE_SIZE=16, LAYER_COUNT=3, MAX_CHANNEL_COUNT=16,
                        START_CHANNEL_COUNT=4, MAPPING_LAYERS=2)
    cfg["train"]["COMPUTE_DTYPE"] = dtype
    cfg["data"].update(level=5, parts=2, buffer_mb=1)
    cell = {"lod": 2, "batch": 4, "records": 24, "warmup_steps": 6, "trace_steps": 2,
            "limits": {"feed_rows_wrong": 0, "loss1_e_gap": 1e-2, "grad_e_median_gap": 0.1,
                       "change_median_gap": 0.5, "ema_median_gap": 0.5,
                       "replay_grad_e_median_gap": 0.1, "replay_change_median_gap": 0.5}}
    return cfg, cell


def tiny_image():
    """The image configuration at 16x16, channels (4, 8), z 8, batch 4."""
    from benchmark.core import harness

    cfg = copy.deepcopy(harness.load_json(harness.HERE, "configs", "image-cifar10.json"))
    cfg["model"].update(image_size=16, channels=[4, 8], z_dim=8)
    cell = {"batch": 4, "records": 64, "warmup_steps": 6, "trace_steps": 2,
            "limits": {"feed_rows_wrong": 0, "loss1_e_gap": 1e-4, "grad_d_gap": 1e-4,
                       "change_median_gap": 1e-4, "replay_loss_gap": 1e-4,
                       "replay_change_median_gap": 1e-4}}
    return cfg, cell
