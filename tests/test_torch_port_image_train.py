"""Port: the image and bootstrap trainers, their CLI and checkpoints on the CPU.

Small runs on synthetic images or uint8 arrays made from a seed (16x16 with
channels (8, 16) through ``train_soft_intro_vae``'s ``spec`` argument; the
CLI runs its dataset's own widths at z 8, batch 4, 8 images). Comparisons of
two runs of the port are exact.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from soft_intro_vae_tpu.utils.torch_compat import load_reference_image_checkpoint
from soft_intro_vae_torch.cli import main as cli
from soft_intro_vae_torch.data.images import ArrayDataset, ImageSpec
from soft_intro_vae_torch.train import image as image_trainer
from soft_intro_vae_torch.train.image import (
    ImageConfig, build_image_training, fires, sync_target_decoder, train_soft_intro_vae)
from soft_intro_vae_torch.train.state import TrainState
from soft_intro_vae_torch.utils import plotting
from soft_intro_vae_torch.utils.checkpoint import Checkpointer, load_pretrained
from tests.torch_port_fixtures import cuda_device, one_torch_thread  # noqa: F401

SPEC = ImageSpec("cifar10", 16, (8, 16), 3)
PREFIX = "cifar10_soft_intro_betas_1.0_16.0_1.0_"


def _cfg(tmp_path, name="run", **kw):
    base = dict(dataset="cifar10", z_dim=8, batch_size=4, num_epochs=2, num_vae=1, beta_neg=16.0,
                seed=0, verbose=False, result_dir=str(tmp_path / name), device="cpu")
    return ImageConfig(**{**base, **kw})


def _u8(n=8, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, 16, 16, 3), dtype=np.uint8)


def _weights(state):
    return {k: v.clone() for k, v in state.model.state_dict().items()}


def _assert_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0, msg=k)


@pytest.mark.parametrize("command, dataset, extra", [
    ("image", "cifar10", ["-v", "1"]),
    ("bootstrap", "mnist", ["-o", "1"]),
])
def test_cli_two_epochs_on_cpu_with_checkpoints(tmp_path, command, dataset, extra):
    out = tmp_path / "out"
    cli.main([command, "-d", dataset, "-n", "2", "-z", "8", "-b", "4", "-e", "16", "-s", "0",
              "--synthetic-n", "8", "--data_root", str(tmp_path / "none"), "--result_dir", str(out),
              "-c", "cpu", *extra])
    saved = out / "saves" / f"{dataset}_soft_intro_betas_1.0_16.0_1.0_model_epoch_1_iter_4.ckpt"
    assert saved.exists()
    assert (out / "log.csv").exists() and (out / "train_graphs_data.pickle").exists()
    payload = torch.load(saved, weights_only=True)
    assert payload["step"] == 4
    assert any(k.startswith("target_decoder.") for k in payload["model"]) == (command == "bootstrap")


def test_cli_parser_matches_the_reference_flags():
    args = cli.build_parser().parse_args(["bootstrap", "-d", "cifar10", "-c", "1"])
    assert (args.device, args.gamma_r, args.freq, args.batch_size, args.z_dim) == ("cuda:1", 1.0, 1, 32, 128)
    args = cli.build_parser().parse_args(["image", "-d", "cifar10"])
    assert (args.device, args.gamma_r) == ("cuda", 1e-8)
    assert cli.build_parser().parse_args(["image", "-d", "x", "--device", "cpu"]).device == "cpu"
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["image", "-d", "cifar10", "-c", "-1"])


def test_cuda_default_raises_without_a_gpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in ([], ["-c", "0"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(["image", "-d", "cifar10", "-n", "1", "--result_dir", str(tmp_path), *device])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_soft_intro_vae(dataclasses.replace(_cfg(tmp_path), device="cuda"))


def test_checkpoint_then_resume_replays_the_straight_run(tmp_path):
    data = _u8(12)
    state, summary = train_soft_intro_vae(_cfg(tmp_path, "first"), ArrayDataset(data, seed=1), SPEC)
    assert summary["epochs_run"] == 2 and summary["steps"] == state.step == 6
    ckpt = tmp_path / "first" / "saves" / f"{PREFIX}model_epoch_1_iter_6.ckpt"
    assert ckpt.exists()
    resumed, _ = train_soft_intro_vae(
        _cfg(tmp_path, "resumed", pretrained=str(ckpt), start_epoch=2, num_epochs=3),
        ArrayDataset(data, seed=1), SPEC)
    straight, _ = train_soft_intro_vae(_cfg(tmp_path, "straight", num_epochs=3),
                                       ArrayDataset(data, seed=1), SPEC)
    assert resumed.step == straight.step == 9
    _assert_equal(_weights(resumed), _weights(straight))
    # the payload's model loads into the JAX package's reference converter
    out = load_reference_image_checkpoint(str(ckpt), SPEC.channels, SPEC.image_size)
    np.testing.assert_array_equal(out["params_d"]["predict"]["bias"],
                                  state.decoder.main.predict.bias.detach().numpy())


def test_pretrained_reference_pth_loads_strictly(tmp_path):
    src, _, _ = build_image_training(_cfg(tmp_path, seed=3), SPEC)
    path = tmp_path / "ref.pth"
    torch.save({"epoch": 5, "model": src.model.state_dict()}, path)
    dst, _, _ = build_image_training(_cfg(tmp_path, seed=4), SPEC)
    assert load_pretrained(str(path), dst) == 5
    _assert_equal(_weights(dst), _weights(src))
    bad = {k: v for k, v in src.model.state_dict().items() if "predict" not in k}
    torch.save({"epoch": 1, "model": bad}, path)
    with pytest.raises(RuntimeError, match="Missing key"):
        load_pretrained(str(path), dst)


@pytest.mark.parametrize("nan_check_iter", [1, 0])
def test_nan_aborts(tmp_path, nan_check_iter):
    data = np.full((8, 16, 16, 3), np.nan, np.float32)
    with pytest.raises(SystemError, match="NaN"):
        train_soft_intro_vae(_cfg(tmp_path, nan_check_iter=nan_check_iter),
                             ArrayDataset(data), SPEC)


def test_multistep_lr_drops_at_epoch_350(tmp_path):
    cfg = _cfg(tmp_path, start_epoch=348, num_epochs=350, num_vae=0, lr_e=1e-3, lr_d=3e-3)
    state, _ = train_soft_intro_vae(cfg, ArrayDataset(_u8(4)), SPEC)
    assert state.lr_e == pytest.approx(1e-4) and state.lr_d == pytest.approx(3e-4)
    assert state.opt_d.param_groups[0]["lr"] == pytest.approx(3e-4)
    cfg = _cfg(tmp_path, "before", start_epoch=347, num_epochs=349, num_vae=0, lr_e=1e-3)
    assert train_soft_intro_vae(cfg, ArrayDataset(_u8(4)), SPEC)[0].lr_e == 1e-3


def test_uint8_dataset_with_float32_storage_trains_on_unit_pixels(tmp_path):
    """A caller's uint8 dataset is normalized whatever host_storage says: it
    trains exactly as its host normalization x.astype(f32)/255 does."""
    data = _u8(8, seed=5)
    runs = []
    for images in (data, data.astype(np.float32) / np.float32(255)):
        runs.append(train_soft_intro_vae(_cfg(tmp_path, str(len(runs)), host_storage="float32"),
                                         ArrayDataset(images, seed=2), SPEC))
    (sa, ma), (sb, mb) = runs
    assert ma["last_metrics"] == mb["last_metrics"]
    # rec is a per-image sum over 16*16*3 = 768 pixels: of the order of 768
    # for [0, 1] pixels, ~1e7 for 0..255 ones
    assert ma["last_metrics"]["rec"] < 1e4
    _assert_equal(_weights(sa), _weights(sb))


def test_bootstrap_sync_is_a_copy(tmp_path):
    state, _, intro = build_image_training(_cfg(tmp_path, bootstrap=True, gamma_r=1.0), SPEC)
    intro(state, torch.from_numpy(_u8(4)))
    online, target = state.decoder.state_dict(), state.target_decoder.state_dict()
    assert any(not torch.equal(online[k], target[k]) for k in online)
    sync_target_decoder(state)
    for k, v in state.decoder.state_dict().items():
        assert torch.equal(v, target[k]) and v.data_ptr() != target[k].data_ptr(), k
    with torch.no_grad():
        state.decoder.main.predict.bias.add_(1.0)
    assert not torch.equal(state.decoder.main.predict.bias, state.target_decoder.main.predict.bias)
    assert all(not p.requires_grad for p in state.target_decoder.parameters())
    assert all(id(p) not in {id(q) for q in state.opt_d.param_groups[0]["params"]}
               for p in state.target_decoder.parameters())


def test_bootstrap_run_syncs_every_freq_epochs(tmp_path):
    cfg = _cfg(tmp_path, bootstrap=True, gamma_r=1.0, copy_to_target_freq=1, num_vae=0)
    state, summary = train_soft_intro_vae(cfg, ArrayDataset(_u8(8)), SPEC)
    _assert_equal(state.decoder.state_dict(), state.target_decoder.state_dict())
    cfg = dataclasses.replace(cfg, copy_to_target_freq=2, result_dir=str(tmp_path / "f2"))
    state, _ = train_soft_intro_vae(cfg, ArrayDataset(_u8(8)), SPEC)  # synced after epoch 0 only
    assert not torch.equal(state.decoder.main.predict.weight,
                           state.target_decoder.main.predict.weight)


def test_sample_grids_and_the_no_matplotlib_rule(tmp_path, monkeypatch):
    cfg = _cfg(tmp_path, save_figures=True, test_iter=2, num_epochs=1)
    train_soft_intro_vae(cfg, ArrayDataset(_u8(8)), SPEC)
    figs = sorted(os.listdir(tmp_path / "run" / "figures_cifar10"))
    assert figs == ["image_0.jpg"]
    grid = plotting.make_grid(np.ones((5, 4, 4, 3), np.float32), nrow=2)
    assert grid.shape == (3 * 6 + 2, 2 * 6 + 2, 3)
    monkeypatch.setattr(plotting, "_plt", lambda: None)
    assert plotting.save_image_grid(np.zeros((2, 4, 4, 1)), str(tmp_path / "x.png")) is None


@pytest.mark.parametrize("field, value, item", [
    ("num_devices", 2, "item 11"),
])
def test_options_of_later_slices_raise(tmp_path, field, value, item):
    cfg = _cfg(tmp_path, **{field: value})
    # item 11 (data parallelism) is ported: num_devices must be the world size;
    # so is item 13's remat (tests/test_torch_port_remat.py)
    err, match = ((ValueError, "num_devices=2 but the world has 1") if field == "num_devices"
                  else (NotImplementedError, f"ROADMAP.md Queue 1, {item}"))
    with pytest.raises(err, match=match):
        train_soft_intro_vae(cfg, ArrayDataset(_u8(4)), SPEC)
    with pytest.raises(err, match=match):
        build_image_training(cfg, SPEC)


def test_matmul_precision_sets_tf32(tmp_path):
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    try:
        build_image_training(_cfg(tmp_path, matmul_precision="float32"), SPEC)
        assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
        build_image_training(_cfg(tmp_path, matmul_precision=None), SPEC)
        assert not torch.backends.cudnn.allow_tf32  # None leaves the settings alone
        with pytest.raises(ValueError):
            build_image_training(_cfg(tmp_path, matmul_precision="bf16"), SPEC)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _runs_equal(a, b):
    (sa, ma), (sb, mb) = a, b
    assert sa.step == sb.step and ma["steps"] == mb["steps"]
    assert ma["last_metrics"] == mb["last_metrics"]
    _assert_equal(_weights(sa), _weights(sb))
    for oa, ob in ((sa.opt_e, sb.opt_e), (sa.opt_d, sb.opt_d)):
        for p, q in zip(oa.state.values(), ob.state.values()):
            for k in ("exp_avg", "exp_avg_sq", "step"):
                torch.testing.assert_close(p[k], q[k], rtol=0, atol=0, msg=k)
    torch.testing.assert_close(sa.generator.get_state(), sb.generator.get_state())


@pytest.mark.parametrize("boot", [False, True], ids=["image", "bootstrap"])
def test_scan_steps_epochs_equal_single_steps(tmp_path, boot):
    """scan_steps=3 over 8 batches an epoch (chunks 3 + 3 + 2), one vanilla
    and one intro epoch: the same run as scan_steps=1, to the bit (the port's
    form of tests/test_integration_extras.py's scan-vs-sequential check)."""
    data = _u8(32, seed=6)
    kw = dict(bootstrap=True, gamma_r=1.0) if boot else {}
    runs = [train_soft_intro_vae(_cfg(tmp_path, f"scan{k}", scan_steps=k, **kw),
                                 ArrayDataset(data, seed=1), SPEC) for k in (1, 3)]
    assert runs[1][1]["steps"] == runs[1][0].step == 16
    _runs_equal(runs[1], runs[0])


@pytest.mark.parametrize("k", [1, 3])
def test_cadence_matches_the_jax_trainer(k):
    """Figures and NaN checks fire where the JAX trainer fires them
    (soft_intro_vae_tpu/train/image.py:348-353), at k = 1 where the reference
    fires them (cur_iter % every == 0)."""
    for every in (1, 2, 5, 7, 200):
        for cur_iter in range(0, 61, k):
            jax_figures = cur_iter == 0 or (cur_iter + k - 1) // every != (cur_iter - 1) // every
            jax_nan = (cur_iter + k - 1) // every != (cur_iter - 1) // every
            assert fires(cur_iter, k, every) == jax_figures == jax_nan, (cur_iter, every)
            if k == 1:
                assert fires(cur_iter, k, every) == (cur_iter % every == 0)


def test_figures_at_scan_steps_fire_where_a_multiple_of_test_iter_falls(tmp_path):
    cfg = _cfg(tmp_path, save_figures=True, test_iter=2, num_epochs=1, scan_steps=3)
    train_soft_intro_vae(cfg, ArrayDataset(_u8(32)), SPEC)
    figs = sorted(os.listdir(tmp_path / "run" / "figures_cifar10"))
    # chunks start at 0, 3, 6 and hold steps {0,1,2}, {3,4,5}, {6,7}
    assert figs == ["image_0.jpg", "image_3.jpg", "image_6.jpg"]


@pytest.mark.parametrize("command", ["image", "bootstrap"])
def test_cli_scan_steps_reaches_the_config(monkeypatch, command):
    seen = []
    monkeypatch.setattr(image_trainer, "train_soft_intro_vae", seen.append)
    cli.main([command, "-d", "cifar10", "--scan-steps", "8", "-c", "cpu"])
    assert seen[0].scan_steps == 8 and seen[0].bootstrap == (command == "bootstrap")
    assert cli.build_parser().parse_args(["image", "-d", "cifar10"]).scan_steps == 1


def test_tensor_lr_equals_float_lr_across_a_change(tmp_path):
    """Two K-step calls (K = 2) with set_lr between them: the LR tensor that
    a graph reads gives the bits of torch.optim.Adam with a float LR."""
    xs = torch.from_numpy(_u8(16, seed=7).reshape(4, 4, 16, 16, 3))
    runs = []
    for form in ("tensor", "float"):
        state, _, intro = build_image_training(_cfg(tmp_path, scan_steps=2), SPEC)
        assert isinstance(state.opt_e.param_groups[0]["lr"], torch.Tensor)
        if form == "float":
            state.opt_e = torch.optim.Adam(state.encoder.parameters(), lr=state.lr_e)
            state.opt_d = torch.optim.Adam(state.decoder.parameters(), lr=state.lr_d)
        lr = state.opt_d.param_groups[0]["lr"]
        state, m1 = intro(state, xs[:2])
        state.set_lr(7e-4, 3e-5)
        state, m2 = intro(state, xs[2:])
        if form == "tensor":  # filled in place, the same tensor
            assert state.opt_d.param_groups[0]["lr"] is lr and float(lr) == 3e-5
        runs.append((state, {k: torch.cat([m1[k], m2[k]]) for k in m1}))
    (sa, ma), (sb, mb) = runs
    for k in ma:
        torch.testing.assert_close(ma[k], mb[k], rtol=0, atol=0, msg=k)
    _assert_equal(_weights(sa), _weights(sb))


def test_checkpoint_loads_across_adam_forms(tmp_path):
    """A checkpoint of the float-LR Adam (the form of earlier checkpoints)
    and one in the capturable, tensor-LR form of the card load into the
    port's Adam, which keeps its own LR tensor and form; a step after the
    load equals a step of the state that saved it."""
    x = torch.from_numpy(_u8(4, seed=8))
    saver, _, intro = build_image_training(_cfg(tmp_path, seed=3), SPEC)
    saver.opt_e = torch.optim.Adam(saver.encoder.parameters(), lr=saver.lr_e)
    saver.opt_d = torch.optim.Adam(saver.decoder.parameters(), lr=saver.lr_d)
    intro(saver, x)
    path = Checkpointer(str(tmp_path / "w")).save(saver, 1, 1)

    def payload():  # a fresh load each time: loading shares the payload's tensors
        return torch.load(path, weights_only=True)

    def card():
        sd = payload()
        return {**sd, "opt_e": _capturable_form(sd["opt_e"]), "opt_d": _capturable_form(sd["opt_d"])}

    for form in (payload, card):
        sd = form()
        state, _, step = build_image_training(_cfg(tmp_path, seed=4), SPEC)
        lr = state.opt_e.param_groups[0]["lr"]
        state.load_state_dict(sd)
        group = state.opt_e.param_groups[0]
        assert group["lr"] is lr and float(lr) == saver.lr_e and not group["capturable"]
        assert all(s["step"].device.type == "cpu" and float(s["step"]) == 1
                   for s in state.opt_e.state.values())
        _, m = step(state, x)
        saver_copy, _, _ = build_image_training(_cfg(tmp_path, seed=4), SPEC)
        saver_copy.load_state_dict(payload())
        saver_copy.opt_e = _float_adam(saver_copy.opt_e, saver_copy.encoder)
        saver_copy.opt_d = _float_adam(saver_copy.opt_d, saver_copy.decoder)
        _, want = intro(saver_copy, x)
        assert {k: float(v) for k, v in m.items()} == {k: float(v) for k, v in want.items()}
        _assert_equal(_weights(state), _weights(saver_copy))


def _capturable_form(sd):
    """An Adam state dict as the card's capturable Adam saves it."""
    groups = [{**g, "capturable": True, "lr": torch.tensor(float(g["lr"]), dtype=torch.float64)}
              for g in sd["param_groups"]]
    return {"state": sd["state"], "param_groups": groups}


def _float_adam(opt, module):
    """The float-LR torch.optim.Adam holding ``opt``'s moments and counts."""
    plain = torch.optim.Adam(module.parameters(), lr=float(opt.param_groups[0]["lr"]))
    sd = opt.state_dict()
    plain.load_state_dict({"state": sd["state"], "param_groups": [
        {**g, "lr": float(g["lr"]), "capturable": False} for g in sd["param_groups"]]})
    return plain


@pytest.mark.cuda
def test_graph_epochs_equal_single_steps_on_the_card(tmp_path, cuda_device):
    """On the card scan_steps=3 replays CUDA graphs; the run equals the
    scan_steps=1 run, one graph replay a step, to the bit (TF32 off, cuDNN
    deterministic)."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        data = _u8(32, seed=6)
        runs = [train_soft_intro_vae(_cfg(tmp_path, f"scan{k}", scan_steps=k, device="cuda",
                                          matmul_precision="float32"),
                                     ArrayDataset(data, seed=1), SPEC) for k in (1, 3)]
    finally:
        torch.backends.cudnn.deterministic = saved
    _runs_equal(runs[1], runs[0])


def test_a_checkpoint_of_nchw_nets_resumes_with_channels_last_moments(tmp_path):
    """A checkpoint written by NCHW image nets (the port's layout before its
    nets ran channels-last) holds NCHW Adam moments. Loading it re-strides
    each moment to its channels-last parameter (train/optim.py
    ``load_state_dict``), as the CUDA foreach Adam needs for its fused route;
    the next step equals the step of the same checkpoint resumed into NCHW
    nets within rtol 1e-6 (the layouts sum the convolutions in another order)."""
    x = torch.from_numpy(_u8(4, seed=9))
    saver, _, intro = build_image_training(_cfg(tmp_path, seed=5), SPEC)
    saver.model.to(memory_format=torch.contiguous_format)
    intro(saver, x)
    nchw = [s["exp_avg"] for s in saver.opt_e.state.values() if s["exp_avg"].dim() == 4
            and s["exp_avg"].shape[-1] > 1]
    assert nchw and all(m.is_contiguous() and m.stride(1) > 1 for m in nchw)
    path = Checkpointer(str(tmp_path / "w")).save(saver, 1, 1)
    runs = []
    for layout in (torch.channels_last, torch.contiguous_format):
        state, _, step = build_image_training(_cfg(tmp_path, seed=6), SPEC)
        state.model.to(memory_format=layout)
        state.load_state_dict(torch.load(path, weights_only=True))
        for opt in (state.opt_e, state.opt_d):
            for p, st in opt.state.items():
                assert st["exp_avg"].stride() == st["exp_avg_sq"].stride() == p.stride()
                if layout == torch.channels_last and p.dim() == 4:
                    assert st["exp_avg"].is_contiguous(memory_format=torch.channels_last)
        _, m = step(state, x)
        runs.append(({k: float(v) for k, v in m.items()}, _weights(state)))
    (ma, wa), (mb, wb) = runs
    assert ma == pytest.approx(mb, rel=1e-6)
    for k in wb:
        torch.testing.assert_close(wa[k], wb[k], rtol=1e-6, atol=0, msg=k)
