"""Port: runs of the JAX package continued by the port (3D and style).

* The committed fixtures (tests/torch_port_fixtures/jax_checkpoints/, the
  carry phase of chip_smoke.py) decode to what their generator,
  tests/torch_port_fixtures/make_jax_checkpoints.py, writes now: every leaf,
  the sidecar, the pointer and the recorded steps (``next_steps.npz``), bit
  for bit.
* From the generator's files: the port's ``Checkpointer.load_latest`` carries
  the 3D state (narrow PointNet widths, 256 points) and the style state (LOD
  1, tiny channels) bit for bit (held to flax's own decoding of the file
  through the converters), and the 2 intro steps after it on the recorded
  batches and draws agree with JAX's, as the step parity tests hold them:
  3D (tests/test_torch_port_step.py) the losses and every other metric within
  rel 1e-4 (abs 1e-6), each tensor's update within 1e-2 of its norm and at
  most 1e-4 of all elements beyond atol 1e-5, running means within 1e-5;
  style (tests/test_torch_port_style_step.py) step 1's loss_e, loss_d,
  rec_loss, real_kl and fake_kl within rel 1e-4, step 2's losses within rel
  2e-3, dlatent_avg within rtol 2e-3 atol 1e-4, every EMA element within
  0.6 lr and their mean difference under 0.02 lr.
* The committed 3D checkpoint, loaded through the port's ``Checkpointer``,
  encodes a recorded batch, in train and eval mode, as the reference's
  Conv1d chain does with those weights (``conv1d_encoder``,
  tests/test_torch_port_pointnet.py; within 1e-5 of each output's scale,
  the train-mode BN buffers too) and as the JAX encoder does with the
  file's tree (within 1e-5).
* The 3D trainer resumes a JAX run (``resume``, the latest file of its
  ``weights/``): its epoch runs on the batches the JAX trainer fed in that
  epoch, bit for bit (both shuffle by ``(seed + 2, epoch)``), and eval_3d's
  sweep over the JAX run's files picks JAX's best file with the JSD within
  1e-6, on the JAX package's prior draws.
* The style trainer resumes a JAX run from its epoch-1 checkpoint and
  sidecar: the LOD driver fast-forwards (the LOD switch at epoch 2 resets
  the optimizers, as JAX's did, and epoch 2 blends LOD 1 in), ``lods_seen``
  comes from the sidecar, and the batches and blends fed are the JAX
  trainer's, bit for bit.
"""

import copy
import dataclasses
import importlib.util
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from soft_intro_vae_tpu.cli import eval_3d as jax_eval_3d
from soft_intro_vae_tpu.models.pointnet import PointNetEncoder as JaxPointNetEncoder
from soft_intro_vae_tpu.train import style as jax_style
from soft_intro_vae_tpu.train import threed as jax_threed
from soft_intro_vae_torch.cli import eval_3d
from soft_intro_vae_torch.train import style as port_style
from soft_intro_vae_torch.train import threed as port_threed
from soft_intro_vae_torch.train.step import INTRO_NOISES
from soft_intro_vae_torch.train.style import StyleConfig, build_style_training
from soft_intro_vae_torch.train.style_step import NZ_KEYS, StyleStepConfig, build_style_steps
from soft_intro_vae_torch.train.threed import ThreeDConfig, build_3d_training
from soft_intro_vae_torch.utils import flax_msgpack
from soft_intro_vae_torch.utils.checkpoint import Checkpointer
from soft_intro_vae_torch.utils.from_jax import pointnet_state_dict_from_jax, style_state_dict_from_jax
from tests.test_torch_port_pointnet import conv1d_encoder
from tests.torch_port_fixtures import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HP = os.path.join(ROOT, "configs", "soft_intro_vae_hp.json")
FIXTURES = os.path.join(ROOT, "tests", "torch_port_fixtures")


def _generator():
    spec = importlib.util.spec_from_file_location(
        "make_jax_checkpoints", os.path.join(FIXTURES, "make_jax_checkpoints.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, dtype=np.float32), tree)


@pytest.fixture(scope="module")
def generated(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("jax_checkpoints"))
    return out, _generator().write_all(out)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _assert_same(a, b, where):
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), where
    else:
        assert type(a) is type(b) and a == b, where


def test_committed_fixtures_are_what_the_generator_writes(generated):
    out, _ = generated
    committed = os.path.join(FIXTURES, "jax_checkpoints")
    assert _files(committed) == _files(out)
    for name in _files(out):
        a, b = os.path.join(committed, name), os.path.join(out, name)
        if name.endswith(".ckpt"):
            _assert_same(flax_msgpack.load(a), flax_msgpack.load(b), name)
        elif name.endswith(".npz"):
            with np.load(a) as za, np.load(b) as zb:
                assert za.files == zb.files, name
                for k in za.files:
                    _assert_same(za[k], zb[k], f"{name}:{k}")
        else:
            with open(a) as fa, open(b) as fb:
                assert fa.read() == fb.read(), name
    total = sum(os.path.getsize(os.path.join(committed, n)) for n in _files(committed)
                if n.endswith(".ckpt"))
    assert total < 1_000_000, total


def _recorded(directory):
    with np.load(os.path.join(directory, "next_steps.npz")) as z:
        return {k: z[k] for k in z.files}


def _flax_state(path):
    with open(path, "rb") as f:
        return serialization.msgpack_restore(f.read())["state"]


def test_threed_fixture_carries_and_continues_as_jax(generated):
    out, final = generated
    directory = os.path.join(out, "threed")
    rec = _recorded(directory)
    cfg = dataclasses.replace(ThreeDConfig.from_json(HP), **json.loads(str(rec["config"])),
                              device="cpu")
    state, _, intro = build_3d_training(cfg)
    _, epoch = Checkpointer(directory).load_latest(state)
    saved = _flax_state(os.path.join(directory, "model_epoch_2_iter_4.ckpt"))
    want = pointnet_state_dict_from_jax(saved["params_e"], saved["stats_e"], saved["params_d"])
    got = state.model.state_dict()
    assert epoch == 2 and state.step == 4
    assert all(torch.equal(got[k], v) for k, v in want.items() if "num_batches" not in k)
    moments = pointnet_state_dict_from_jax(saved["opt_e"]["nu"], saved["stats_e"],
                                           saved["opt_d"]["nu"])
    for name, p in state.model.encoder.named_parameters():
        assert torch.equal(state.opt_e.state[p]["exp_avg_sq"], moments["encoder." + name]), name
    before = {k: v.clone() for k, v in got.items()}
    for i in range(2):
        nz = {k: torch.from_numpy(rec[f"draw_{k}"][i]) for k in INTRO_NOISES}
        _, m = intro(state, torch.from_numpy(rec["x"][i]), nz)
        for k in ("loss_e", "loss_d"):
            assert float(m[k]) == pytest.approx(float(rec[f"metric_{k}"][i]), rel=1e-4), (i, k)
        for k in ("rec", "kl_real", "kl_rec", "kl_fake", "diff_kl"):
            assert float(m[k]) == pytest.approx(float(rec[f"metric_{k}"][i]), rel=1e-4,
                                                abs=1e-6), (i, k)
    j = final["threed"]
    want = pointnet_state_dict_from_jax(_np_tree(j.params_e), _np_tree(j.stats_e),
                                        _np_tree(j.params_d))
    got = state.model.state_dict()
    beyond = total = 0
    for k, w in want.items():
        if k.endswith(("running_var", "num_batches_tracked")):
            continue
        g, w, b = got[k].numpy(), w.numpy(), before[k].numpy()
        beyond += int((np.abs(g - w) > 1e-5).sum())
        total += w.size
        if k.endswith("running_mean"):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5, err_msg=k)
        else:
            assert np.linalg.norm((g - b) - (w - b)) <= 1e-2 * np.linalg.norm(w - b) + 1e-7, k
    assert beyond <= 1e-4 * total, f"{beyond} of {total} elements beyond atol 1e-5"


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_threed_fixture_encodes_as_the_conv1d_chain_and_jax(train):
    directory = os.path.join(FIXTURES, "jax_checkpoints", "threed")
    rec = _recorded(directory)
    cfg = dataclasses.replace(ThreeDConfig.from_json(HP), **json.loads(str(rec["config"])),
                              device="cpu")
    state = build_3d_training(cfg)[0]
    Checkpointer(directory).load_latest(state)
    enc = state.model.encoder.train(train)
    oracle = copy.deepcopy(enc)
    x = torch.from_numpy(rec["x"][0])
    with torch.no_grad():
        got, want = enc(x), conv1d_encoder(oracle, x)
    saved = _flax_state(os.path.join(directory, "model_epoch_2_iter_4.ckpt"))
    jenc = JaxPointNetEncoder(z_dim=cfg.z_size, conv_channels=tuple(cfg.conv_channels))
    jout = jax.jit(lambda v, x: jenc.apply(v, x, train=train, mutable=["batch_stats"]))(
        {"params": saved["params_e"], "batch_stats": saved["stats_e"]}, jnp.asarray(rec["x"][0]))[0]
    for g, w, j in zip(got, want, jout):
        scale = float(w.abs().max())
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-5 * scale)
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=0, atol=1e-5 * scale)
    for (name, b), o in zip(enc.named_buffers(), oracle.buffers()):
        scale = float(o.abs().max()) or 1.0
        np.testing.assert_allclose(b.numpy(), o.numpy(), rtol=0, atol=1e-5 * scale, err_msg=name)


def test_style_fixture_carries_and_continues_as_jax(generated):
    out, final = generated
    directory = os.path.join(out, "style")
    rec = _recorded(directory)
    over = json.loads(str(rec["config"]))
    lod, _ = over.pop("lod"), over.pop("ema_beta")
    cfg = dataclasses.replace(StyleConfig(), **over, device="cpu")
    model, state = build_style_training(cfg)
    _, epoch = Checkpointer(directory).load_latest(state)
    saved = _flax_state(os.path.join(directory, "tiny_model_epoch_2_iter_2.ckpt"))
    for nets, keys in ((state.nets, ("params_e", "params_d", "buffers")),
                       (state.ema, ("ema_e", "ema_d", "ema_buffers"))):
        want = style_state_dict_from_jax(*(saved[k] for k in keys))
        assert all(torch.equal(nets.state_dict()[k], v) for k, v in want.items())
    nu = style_state_dict_from_jax(saved["opt_e"]["nu"], saved["opt_d"]["nu"], saved["buffers"])
    names = [f"decoder.{n}" for n, _ in state.nets.decoder.named_parameters()]
    assert all(torch.equal(v, nu[n]) for v, n in zip(state.opt_d.nu, names))
    assert epoch == 2 and state.step == 2 and int(state.opt_e.count) == 2
    assert float(state.lr) == float(saved["lr"]) and float(state.ema_beta) == float(saved["ema_beta"])
    scfg = StyleStepConfig(latent_size=cfg.latent_space_size, beta_rec=cfg.beta_rec,
                           beta_kl=cfg.beta_kl, beta_neg=float(cfg.beta_neg[lod]), scale=cfg.scale)
    _, intro = build_style_steps(model, scfg, lod, False, noise_mode="none")
    for i, (rel, keys) in enumerate(((1e-4, ("loss_e", "loss_d", "rec_loss", "real_kl", "fake_kl")),
                                     (2e-3, ("loss_e", "loss_d")))):
        x = torch.from_numpy(np.ascontiguousarray(rec["x"][i].transpose(0, 3, 1, 2)))
        _, m = intro(state, x, 1.0, {k: rec[f"draw_{k}"][i] for k in NZ_KEYS})
        for k in keys:
            assert float(m[k]) == pytest.approx(float(rec[f"metric_{k}"][i]), rel=rel,
                                                abs=1e-7), (i, k)
    j = final["style"]
    lr = float(saved["lr"])
    torch.testing.assert_close(state.nets.dlatent_avg.buff,
                               torch.tensor(np.asarray(j.buffers["dlatent_avg"])),
                               rtol=2e-3, atol=1e-4)
    ref = style_state_dict_from_jax(_np_tree(j.ema_e), _np_tree(j.ema_d), _np_tree(j.ema_buffers))
    ema = state.ema.state_dict()
    diff_sum = total = 0
    for k, r in ref.items():
        d = (ema[k] - r).abs()
        diff_sum += float(d.sum())
        total += d.numel()
        assert float(d.max()) <= 0.6 * lr, (k, float(d.max()))
    assert diff_sum / total <= 0.02 * lr


def _threed_cfgs(tmp_path):
    kw = dict(n_points=32, batch_size=4, z_size=8, seed=0, max_epochs=2, use_synthetic=True,
              synthetic_n=16, save_frequency=1, valid_frequency=1, verbose=False)
    jcfg = dataclasses.replace(jax_threed.ThreeDConfig.from_json(HP), **kw, num_devices=1,
                               results_dir=str(tmp_path / "jax"))
    cfg = dataclasses.replace(ThreeDConfig.from_json(HP), **kw, device="cpu",
                              results_dir=str(tmp_path / "port"))
    return jcfg, cfg


def _recording(module, name, fed, side, wrap_index):
    """``module.name`` (a build function) with the steps it returns wrapped
    to record the batches (and blends) they are fed under ``fed[side]``."""
    real = getattr(module, name)

    def build(*args, **kwargs):
        out = list(real(*args, **kwargs))

        def wrap(step):
            def run(state, x, *rest):
                x_host = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
                blend = [float(r) for r in rest[:1] if not isinstance(r, dict)]
                fed.setdefault(side, []).append((x_host.copy(), blend))
                return step(state, x, *rest)
            return run

        for i in wrap_index:
            out[i] = tuple(wrap(s) for s in out[i]) if isinstance(out[i], tuple) else wrap(out[i])
        return tuple(out)

    return real, build


def test_threed_trainer_resumes_a_jax_run_and_eval_picks_its_epoch(tmp_path, monkeypatch):
    jcfg, cfg = _threed_cfgs(tmp_path)
    fed = {}
    _, build = _recording(jax_threed, "build_3d_training", fed, "jax", (3, 4))
    monkeypatch.setattr(jax_threed, "build_3d_training", build)
    jax_threed.train_soft_intro_vae_3d(jcfg)
    monkeypatch.undo()
    weights = tmp_path / "jax" / "weights"
    resume = tmp_path / "port" / "weights"
    resume.mkdir(parents=True)
    shutil.copy(weights / "model_epoch_1_iter_0.ckpt", resume)
    _, build = _recording(port_threed, "build_3d_training", fed, "port", (1, 2))
    monkeypatch.setattr(port_threed, "build_3d_training", build)
    state, summary = port_threed.train_soft_intro_vae_3d(dataclasses.replace(cfg, resume=True))
    monkeypatch.undo()
    steps = jcfg.synthetic_n // jcfg.batch_size
    assert summary["epochs_run"] == 2 and state.step == 2 * steps
    assert len(fed["port"]) == steps
    for (got, _), (want, _) in zip(fed["port"], fed["jax"][steps:]):
        np.testing.assert_array_equal(got, want)

    # eval_3d's sweep over the JAX run's files, on the JAX package's draws
    want_path, want_jsd = jax_eval_3d.find_best_epoch(jcfg, str(weights))
    n = len(eval_3d._points(cfg, "valid"))
    noises = [np.asarray(jcfg.prior_std * jax.random.normal(
        jax.random.fold_in(jax.random.key(777), t), (3 * n, cfg.z_size), jnp.float32))
        for t in range(3)]
    path, jsd = eval_3d.find_best_epoch(cfg, str(weights), noises=noises)
    assert os.path.basename(path) == os.path.basename(want_path)
    assert jsd == pytest.approx(want_jsd, abs=1e-6)


STYLE = dict(name="tiny", layer_count=2, start_channel_count=4, max_channel_count=8,
             latent_space_size=8, mapping_layers=2, use_synthetic=True, synthetic_n=8,
             lod_2_batch_tables={"1GPU": [4, 4]}, epochs_per_lod=2, train_epochs=3, num_vae=0,
             verbose=False)


def test_style_trainer_resumes_a_jax_run(tmp_path, monkeypatch):
    fed = {}
    jcfg = dataclasses.replace(jax_style.StyleConfig(), **STYLE, num_devices=1,
                               output_dir=str(tmp_path / "jax"))
    real = jax_style.build_style_steps

    def recording_steps(*args, **kwargs):
        steps = real(*args, **kwargs)

        def wrap(step):
            def run(state, x, blend):
                fed.setdefault("jax", []).append((np.asarray(x), float(blend)))
                return step(state, x, blend)
            return run
        return tuple(wrap(s) for s in steps)

    monkeypatch.setattr(jax_style, "build_style_steps", recording_steps)
    jax_style.train_style_soft_intro_vae(jcfg)
    monkeypatch.undo()
    arts = tmp_path / "jax" / "training_artifacts"
    ours = tmp_path / "port" / "training_artifacts"
    ours.mkdir(parents=True)
    name = "tiny_model_epoch_1_iter_4.ckpt"
    for f in (name, name + ".aux.json"):
        shutil.copy(arts / f, ours)
    (ours / "last_checkpoint").write_text(name)

    port_real = port_style.build_style_steps

    def port_recording(*args, **kwargs):
        steps = port_real(*args, **kwargs)

        def wrap(step):
            def run(state, x, blend):
                x_nhwc = x.permute(0, 2, 3, 1).numpy().copy()
                fed.setdefault("port", []).append((x_nhwc, float(blend)))
                return step(state, x, blend)
            return run
        return tuple(wrap(s) for s in steps)

    monkeypatch.setattr(port_style, "build_style_steps", port_recording)
    cfg = dataclasses.replace(StyleConfig(), **STYLE, device="cpu",
                              output_dir=str(tmp_path / "port"))
    state, summary = port_style.train_style_soft_intro_vae(cfg)
    monkeypatch.undo()
    per_epoch = 2  # 8 images, batch 4
    assert summary["lods_seen"] == [0, 1] and summary["epochs_run"] == 3
    assert summary["steps"] == per_epoch and state.step == 3 * per_epoch
    assert int(state.opt_e.count) == per_epoch  # reset at the LOD switch of epoch 2
    assert summary["blended_steps"] == per_epoch  # epoch 2 is LOD 1's transition
    assert len(fed["port"]) == per_epoch
    for (got, b), (want, jb) in zip(fed["port"], fed["jax"][2 * per_epoch:]):
        np.testing.assert_array_equal(got, want)
        assert b == jb
