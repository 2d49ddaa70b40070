"""Port: the 3D trainer, its CLI, checkpoints and data on the CPU, plus the
package's import rules.

Small runs (64 points, batch 4, z 8) on the synthetic stand-in clouds.
"""

import ast
import dataclasses
import json
import os
import struct

import numpy as np
import pytest
import torch

from soft_intro_vae_tpu.data import shapenet as jax_shapenet
from soft_intro_vae_tpu.metrics.jsd import jsd_between_point_cloud_sets as jax_jsd
from soft_intro_vae_tpu.train.threed import ThreeDConfig as JaxThreeDConfig
from soft_intro_vae_tpu.utils.torch_compat import load_reference_3d_checkpoint
from soft_intro_vae_torch.cli import main as cli
from soft_intro_vae_torch.data.shapenet import ShapeNetDataset, SyntheticClouds, load_ply
from soft_intro_vae_torch.metrics.jsd import jsd_between_point_cloud_sets
from soft_intro_vae_torch.train.threed import (
    ThreeDConfig, build_3d_training, calc_jsd_valid, train_soft_intro_vae_3d)
from soft_intro_vae_torch.utils import plotting
from soft_intro_vae_torch.utils.checkpoint import Checkpointer
from soft_intro_vae_torch.utils.device import resolve_device
from tests.torch_port_fixtures import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HP_JSON = os.path.join(REPO, "configs", "soft_intro_vae_hp.json")


def _cfg(tmp_path, **kw):
    base = dict(n_points=64, batch_size=4, max_epochs=2, z_size=8, beta_neg=16.0, seed=0,
                valid_frequency=1, save_frequency=1, use_synthetic=True, synthetic_n=16,
                verbose=False, results_dir=str(tmp_path / "run"), device="cpu")
    base.update(kw)
    return ThreeDConfig(**base)


def test_two_epoch_run_checkpoints_and_exact_resume(tmp_path):
    state, summary = train_soft_intro_vae_3d(_cfg(tmp_path, resume=False))
    assert summary["epochs_run"] == 2 and state.step == 8
    assert np.isfinite(summary["best_jsd"])
    assert all(np.isfinite(v) for v in summary["last_metrics"].values())
    names = set(os.listdir(tmp_path / "run" / "weights"))
    assert {"model_epoch_1_iter_0.ckpt", "model_epoch_2_iter_0.ckpt", "last_checkpoint"} <= names
    assert any(n.startswith("model_epoch_") and "_jsd_" in n for n in names)
    assert (tmp_path / "run" / "log.csv").exists()

    # resuming to epoch 3 replays what an uninterrupted 3-epoch run does
    resumed, s_res = train_soft_intro_vae_3d(_cfg(tmp_path, max_epochs=3, resume=True))
    straight, _ = train_soft_intro_vae_3d(_cfg(tmp_path, max_epochs=3, resume=False,
                                               results_dir=str(tmp_path / "straight")))
    assert s_res["epochs_run"] == 3 and resumed.step == straight.step == 12
    for (k, a), b in zip(resumed.model.state_dict().items(), straight.model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)


def test_checkpoint_payload_loads_into_the_jax_package(tmp_path):
    state, _, _ = build_3d_training(_cfg(tmp_path))
    path = Checkpointer(str(tmp_path / "w")).save(state, 7, 0)
    payload = torch.load(path, weights_only=True)
    assert {"model", "opt_e", "opt_d", "epoch", "step", "lr_e", "lr_d"} <= set(payload)
    assert payload["epoch"] == 7
    out = load_reference_3d_checkpoint(path, n_points=64)
    np.testing.assert_array_equal(
        out["params_e"]["conv_0"]["kernel"], state.encoder.conv[0].weight.detach().numpy()[:, :, 0].T)
    assert out["params_d"]["out"]["kernel"].shape == (1024, 64 * 3)


def test_load_latest_restores_in_place(tmp_path):
    state, _, intro = build_3d_training(_cfg(tmp_path))
    ck = Checkpointer(str(tmp_path / "w"))
    assert ck.load_latest(state) is None
    x = torch.from_numpy(SyntheticClouds(4, 64, seed=3).points)
    intro(state, x)
    state.set_lr(1e-4, 2e-4)
    ck.save(state, 3)
    fresh, _, _ = build_3d_training(_cfg(tmp_path, seed=1))
    fresh, epoch = ck.load_latest(fresh)
    assert epoch == 3 and fresh.step == 1 and (fresh.lr_e, fresh.lr_d) == (1e-4, 2e-4)
    assert fresh.opt_d.param_groups[0]["lr"] == 2e-4
    for a, b in zip(fresh.model.state_dict().values(), state.model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(fresh.generator.get_state(), state.generator.get_state())


def test_cli_threed_on_cpu(tmp_path):
    with open(HP_JSON) as f:
        c = json.load(f)
    c.update(n_points=64, batch_size=4, max_epochs=1, z_size=8, use_synthetic=True, synthetic_n=8,
             valid_frequency=1, save_frequency=1, seed=0, verbose=False,
             results_root=str(tmp_path / "results"))
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(c))
    cli.main(["threed", "-c", str(path), "--device", "cpu"])
    weights = tmp_path / "results" / "vae" / "soft_intro_vae" / "weights"
    assert (weights / "model_epoch_1_iter_0.ckpt").exists()


def test_from_json_matches_the_jax_package():
    port = ThreeDConfig.from_json(HP_JSON)
    ref = JaxThreeDConfig.from_json(HP_JSON)
    for f in dataclasses.fields(JaxThreeDConfig):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert (port.n_points, port.batch_size, port.z_size, port.lr_e) == (2048, 32, 128, 5e-4)
    assert port.device == "cuda"


def test_cuda_default_entry_points_raise_without_a_gpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_3d_training(dataclasses.replace(_cfg(tmp_path), device="cuda"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_soft_intro_vae_3d(dataclasses.replace(_cfg(tmp_path), device="cuda"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["threed"])
    assert resolve_device("cpu") == torch.device("cpu")


def test_options_of_later_slices_raise(tmp_path):
    # data parallelism is ported: num_devices must be the world size
    with pytest.raises(ValueError, match="num_devices=2 but the world has 1"):
        build_3d_training(_cfg(tmp_path, num_devices=2))
    with pytest.raises(ValueError, match="chamfer"):
        build_3d_training(_cfg(tmp_path, reconstruction_loss="mse"))


def test_save_figures_writes_the_epoch_panel(tmp_path, monkeypatch):
    """save_figures: one real / reconstruction / sample panel an epoch (the
    JAX trainer's samples/figure_{epoch}.png), drawn without touching the
    training draws; without matplotlib the panel is skipped."""
    plain, _ = train_soft_intro_vae_3d(_cfg(tmp_path, resume=False, results_dir=str(tmp_path / "a")))
    state, summary = train_soft_intro_vae_3d(_cfg(tmp_path, resume=False, save_figures=True))
    assert sorted(os.listdir(tmp_path / "run" / "samples")) == ["figure_1.png", "figure_2.png"]
    for a, b in zip(state.model.state_dict().values(), plain.model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert plotting.save_pointcloud_panel([np.zeros((5, 8, 3))] * 3, str(tmp_path / "p.png"))
    monkeypatch.setattr(plotting, "_plt", lambda: None)
    assert plotting.save_pointcloud_panel([np.zeros((5, 8, 3))], str(tmp_path / "q.png")) is None


def test_calc_jsd_valid_is_deterministic(tmp_path):
    state, _, _ = build_3d_training(_cfg(tmp_path))
    valid = SyntheticClouds(8, 64, seed=1).points
    a = calc_jsd_valid(state, valid, _cfg(tmp_path))
    assert a == calc_jsd_valid(state, valid, _cfg(tmp_path)) and 0.0 <= a <= 1.0


def test_jsd_and_synthetic_clouds_match_the_jax_package():
    a = SyntheticClouds(6, 128, seed=0).points
    np.testing.assert_array_equal(a, jax_shapenet.SyntheticClouds(6, 128, seed=0).points)
    b = SyntheticClouds(6, 128, seed=9).points * 0.5
    assert jsd_between_point_cloud_sets(a, b, voxels=14) == jax_jsd(a, b, voxels=14)


def _write_ply_binary(path, pts):
    header = ("ply\nformat binary_little_endian 1.0\nelement vertex %d\n"
              "property float x\nproperty float y\nproperty float z\nproperty uchar red\n"
              "element face 0\nproperty list uchar int vertex_indices\nend_header\n" % len(pts))
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        for x, y, z in pts:
            f.write(struct.pack("<fffB", x, y, z, 7))


def _write_ply_ascii(path, pts):
    lines = ["ply", "format ascii 1.0", f"element vertex {len(pts)}", "property float nx",
             "property float x", "property float y", "property float z", "end_header"]
    lines += [f"0.5 {x!r} {y!r} {z!r}" for x, y, z in pts.tolist()]
    path.write_text("\n".join(lines) + "\n")


def test_ply_round_trip_and_split(tmp_path):
    pts = np.random.RandomState(0).randn(20, 3).astype(np.float32)
    _write_ply_binary(tmp_path / "b.ply", pts)
    _write_ply_ascii(tmp_path / "a.ply", pts)
    for name in ("b.ply", "a.ply"):
        got = load_ply(str(tmp_path / name))
        np.testing.assert_array_equal(got, pts)
        np.testing.assert_array_equal(got, jax_shapenet.load_ply(str(tmp_path / name)))
    (tmp_path / "bad.ply").write_text("not a ply\n")
    with pytest.raises(ValueError):
        load_ply(str(tmp_path / "bad.ply"))

    car = tmp_path / "shapenet" / "02958343"
    car.mkdir(parents=True)
    for i in range(20):
        _write_ply_binary(car / f"{i:03d}.ply", pts + i)
    ds = {s: ShapeNetDataset(str(tmp_path / "shapenet"), ("car",), s) for s in ("train", "valid", "test")}
    assert [len(ds[s]) for s in ("train", "valid", "test")] == [17, 1, 2]
    x, labels = ds["valid"].load_all()
    np.testing.assert_array_equal(x[0], pts + 17)
    assert labels.tolist() == [jax_shapenet.SYNTH_ID_TO_NUMBER["02958343"]]
    with pytest.raises(FileNotFoundError):
        ShapeNetDataset(str(tmp_path / "shapenet"), ("airplane",), "train")


FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "soft_intro_vae_tpu")


def _port_sources():
    root = os.path.join(REPO, "soft_intro_vae_torch")
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(REPO, "chip_smoke.py")
    yield os.path.join(REPO, "tools", "torch_profile_3d.py")
    yield os.path.join(REPO, "tools", "torch_profile_toy.py")


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    found = []
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            found += [(path, m) for m in mods if m.split(".")[0] in FORBIDDEN]
    assert not found, found
    assert len(list(_port_sources())) > 10
