"""Port parity: the figures of soft_intro_vae_torch/cli/figures.py against
the JAX package's cli/figures.py.

The same tiny style weights (3 layers, 8 -> 32 channels, latent 16, moved
0.1 randn off the init) sit in a port checkpoint, loaded by the port's CLI
path (``load_model``), and in a JAX state handed to the JAX figures in place
of their checkpoint loader. The JAX figures' grids are caught where they
would be written. The two packages draw differently, so the JAX draws are
injected into the port: the latents as ``z`` arguments, and the decoder's
noise planes in place of the port's draws (each port generator is seeded
with the seed of the JAX key, so the planes follow from the generator's
seed and how many it has drawn, as tests/test_torch_port_threed_eval.py
injects the prior draws). Every figure kind's array agrees within 1e-4
(images in [0, 1]; f32 convolutions and moments summed in another order).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import soft_intro_vae_tpu.cli.figures as jfig
from soft_intro_vae_tpu.train.lreq_adam import scale_by_lreq_adam
from soft_intro_vae_tpu.train.style import StyleConfig as JaxStyleConfig
from soft_intro_vae_tpu.train.style_step import StyleModel as JaxStyleModel
from soft_intro_vae_tpu.train.style_step import StyleModelConfig as JaxStyleModelConfig
from soft_intro_vae_tpu.train.style_step import StyleTrainState as JaxStyleTrainState
from soft_intro_vae_torch.cli import figures
from soft_intro_vae_torch.models import style as port_style
from soft_intro_vae_torch.train.style import StyleConfig, build_style_training
from soft_intro_vae_torch.utils.checkpoint import Checkpointer
from soft_intro_vae_torch.utils.from_jax import style_state_dict_from_jax
from tests.torch_port_fixtures import one_torch_thread  # noqa: F401

LAYERS, STARTF, MAXF, LATENT, MAPPING = 3, 8, 32, 16, 2
RES = 2 ** (LAYERS + 1)
ATOL = 1e-4
YAML = f"""NAME: tiny
OUTPUT_DIR: OUT
MODEL:
  LATENT_SPACE_SIZE: {LATENT}
  LAYER_COUNT: {LAYERS}
  MAX_CHANNEL_COUNT: {MAXF}
  START_CHANNEL_COUNT: {STARTF}
  MAPPING_LAYERS: {MAPPING}
TRAIN:
  COMPUTE_DTYPE: float32
"""


def np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, dtype=np.float32), tree)


def _cfg(tmp):
    return StyleConfig(layer_count=LAYERS, start_channel_count=STARTF, max_channel_count=MAXF,
                       latent_space_size=LATENT, mapping_layers=MAPPING, output_dir=str(tmp),
                       device="cpu", verbose=False)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("figures")
    jmodel = JaxStyleModel(JaxStyleModelConfig(startf=STARTF, maxf=MAXF, layer_count=LAYERS,
                                               latent_size=LATENT, mapping_layers=MAPPING))
    pe, pd, buf = jax.jit(jmodel.init_params)(jax.random.key(7))
    rs = np.random.RandomState(8)
    bump = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda a: a + 0.1 * rs.randn(*a.shape).astype(np.float32), np_tree(t))
    pe, pd, buf = bump(pe), bump(pd), bump(buf)
    opt = scale_by_lreq_adam(beta2=0.99)
    j = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    jstate = JaxStyleTrainState(
        step=jnp.zeros([], jnp.int32), params_e=j(pe), params_d=j(pd), buffers=j(buf),
        ema_e=j(pe), ema_d=j(pd), ema_buffers=j(buf), opt_e=opt.init(j(pe)),
        opt_d=opt.init(j(pd)), lr=jnp.asarray(1e-3, jnp.float32),
        ema_beta=jnp.asarray(0.9, jnp.float32), rng=jax.random.key(0))
    # the port checkpoint: online and EMA nets both the JAX weights
    cfg = _cfg(tmp)
    _, state = build_style_training(cfg)
    sd = style_state_dict_from_jax(pe, pd, buf)
    state.nets.load_state_dict(sd, strict=True)
    state.ema.load_state_dict(sd, strict=True)
    ckpt = Checkpointer(str(tmp / "saves")).save(state, 0, 0)
    # sample images: 6 RGBA 32x32 PNGs, reduced 2x to the model's 16x16
    samples = tmp / "samples"
    samples.mkdir()
    for i in range(6):
        img = np.random.RandomState(20 + i).randint(0, 256, (2 * RES, 2 * RES, 4), np.uint8)
        Image.fromarray(img).save(samples / f"img{i}.png")
    jcfg = JaxStyleConfig(layer_count=LAYERS, start_channel_count=STARTF,
                          max_channel_count=MAXF, latent_space_size=LATENT,
                          mapping_layers=MAPPING)
    return dict(jmodel=jmodel, jstate=jstate, cfg=cfg, ckpt=ckpt, samples=str(samples),
                jcfg=jcfg, tmp=tmp)


def _jax_planes(seed: int, via_generate: bool, shape, index: int) -> np.ndarray:
    """The JAX decoder's noise plane ``index`` (block index // 2, stage
    index % 2) for a decode keyed by ``jax.random.key(seed)``: ``generate``
    hands the decoder the first of four splits of its key."""
    key = jax.random.key(seed)
    if via_generate:
        key = jax.random.split(key, 4)[0]
    block = jax.random.split(key, LAYERS)[index // 2]
    stage = jax.random.split(block)[index % 2]
    b, h, w = shape
    return np.asarray(jax.random.normal(stage, (b, h, w, 1), jnp.float32)[..., 0])


@pytest.fixture
def jax_noise(monkeypatch):
    """The port decoder's noise planes replaced by the JAX decoder's."""
    mode = {"via_generate": True}
    drawn = {}

    def planes(b, shape, generator=None, device=None):
        # the generator is kept alive, so a later one cannot take its id
        _, count = drawn.get(id(generator), (generator, 0))
        drawn[id(generator)] = (generator, count + 1)
        plane = _jax_planes(generator.initial_seed(), mode["via_generate"], (b,) + tuple(shape),
                            count)
        return torch.from_numpy(plane).to(device)

    monkeypatch.setattr(port_style, "randn_rows", planes)
    return mode


@pytest.fixture
def jax_grids(setup, monkeypatch):
    """The JAX figures' arrays, caught where they would be written."""
    caught = []
    monkeypatch.setattr(jfig, "_load", lambda cfg, path: (setup["jmodel"], setup["jstate"]))
    monkeypatch.setattr(jfig, "save_image_grid",
                        lambda images, path, nrow=8: caught.append(np.asarray(images)) or path)
    import matplotlib.pyplot as plt

    monkeypatch.setattr(plt, "imsave", lambda path, arr: caught.append(np.asarray(arr)))
    return caught


def _port(setup):
    return figures.load_model(setup["cfg"], setup["ckpt"])


def test_load_model_holds_the_checkpoint(setup):
    model, state = _port(setup)
    want = style_state_dict_from_jax(np_tree(setup["jstate"].params_e),
                                     np_tree(setup["jstate"].params_d),
                                     np_tree(setup["jstate"].buffers))
    for k, v in state.ema.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_samples_match_jax(setup, jax_grids, jax_noise, tmp_path):
    jfig.generate_samples(setup["jcfg"], "ckpt", str(tmp_path / "s.png"), count=4, seed=3)
    z = torch.from_numpy(np.asarray(jax.random.normal(jax.random.key(3), (4, LATENT))))
    model, state = _port(setup)
    got = figures.sample_images(model, state, count=4, seed=3, z=z)
    assert got.shape == (4, RES, RES, 3)
    np.testing.assert_allclose(got, jax_grids[0], rtol=0, atol=ATOL)


def test_reconstruction_matches_jax(setup, jax_grids, jax_noise, tmp_path):
    x255 = np.random.RandomState(5).rand(4, RES, RES, 3).astype(np.float32) * 255.0

    class Data:
        def epoch(self, res, count):
            assert (res, count) == (RES, 4)
            yield x255

    jfig.reconstruction_figure(setup["jcfg"], "ckpt", Data(), str(tmp_path / "r.png"), count=4)
    model, state = _port(setup)
    got = figures.reconstruction_images(model, state, x255 / 127.5 - 1.0)
    assert got.shape == (8, RES, RES, 3)
    np.testing.assert_allclose(got, jax_grids[0], rtol=0, atol=ATOL)


def test_interpolation_matches_jax(setup, jax_grids, jax_noise, tmp_path):
    jfig.interpolation_figure(setup["jcfg"], "ckpt", str(tmp_path / "i.png"), steps=5, seed=2)
    z = torch.from_numpy(np.asarray(jax.random.normal(jax.random.key(2), (2, LATENT))))
    model, state = _port(setup)
    got = figures.interpolation_images(model, state, steps=5, seed=2, z=z)
    assert got.shape == (5, RES, RES, 3)
    np.testing.assert_allclose(got, jax_grids[0], rtol=0, atol=ATOL)


def test_style_mixing_matches_jax(setup, jax_grids, jax_noise, tmp_path):
    jax_noise["via_generate"] = False
    jfig.style_mixing_figure(setup["jcfg"], "ckpt", str(tmp_path / "m.png"), n_src=3, n_dst=2,
                             seed=4)
    k1, k2 = jax.random.split(jax.random.key(4))
    z_src = torch.from_numpy(np.asarray(jax.random.normal(k1, (3, LATENT))))
    z_dst = torch.from_numpy(np.asarray(jax.random.normal(k2, (2, LATENT))))
    model, state = _port(setup)
    got = figures.style_mixing_images(model, state, n_src=3, n_dst=2, seed=4, z_src=z_src,
                                      z_dst=z_dst)
    assert got.shape == (9, RES, RES, 3)
    np.testing.assert_allclose(got, jax_grids[0], rtol=0, atol=ATOL)


def test_sample_loader_matches_jax(setup):
    names = figures.sample_names(setup["samples"], shuffle_seed=5)
    got = figures.load_sample_images(setup["samples"], RES, names=names)
    want = jfig._load_sample_images(setup["samples"], RES, shuffle_seed=5)
    assert got.shape == (6, RES, RES, 3)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="does not reduce"):
        figures.reduce_sample_image(np.zeros((20, 20, 3), np.uint8), RES)


def test_multires_matches_jax(setup, jax_grids, jax_noise, tmp_path):
    jax_noise["via_generate"] = False
    jfig.multires_reconstruction_figure(setup["jcfg"], "ckpt", setup["samples"],
                                        str(tmp_path / "mr.png"))
    names = figures.sample_names(setup["samples"], 5)[:20]
    x = figures.load_sample_images(setup["samples"], RES, names=names)
    model, state = _port(setup)
    got = figures.multires_canvas(model, state, x)
    assert got.shape == (2 * RES + 24, 4 * (2 * RES + 14), 3)
    np.testing.assert_allclose(got, np.clip(jax_grids[0], 0, 1), rtol=0, atol=ATOL)


def test_paged_matches_jax(setup, jax_grids, jax_noise, tmp_path):
    jax_noise["via_generate"] = False
    jfig.paged_reconstruction_figure(setup["jcfg"], "ckpt", setup["samples"],
                                     str(tmp_path / "pages"), per_page=4)
    names = figures.sample_names(setup["samples"], 1)
    model, state = _port(setup)
    for page, want in enumerate(jax_grids):
        x = figures.load_sample_images(setup["samples"], RES, names=names[4 * page: 4 * page + 4])
        got = figures.paged_cells(model, state, x)
        assert got.shape == (x.shape[0], RES, 2 * RES, 3)
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert len(jax_grids) == 2


def test_interpolation_two_images_matches_jax(setup, jax_grids, jax_noise, tmp_path):
    jax_noise["via_generate"] = False
    jfig.interpolation_2_images_figure(setup["jcfg"], "ckpt", setup["samples"], "img1.png",
                                       "img4.png", str(tmp_path / "i2.png"), steps=4, seed=6)
    x = figures.load_sample_images(setup["samples"], RES, names=["img1.png", "img4.png"])
    model, state = _port(setup)
    got = figures.interpolation_2_images(model, state, x, steps=4, seed=6)
    assert got.shape == (4, RES, RES, 3)
    np.testing.assert_allclose(got, jax_grids[0], rtol=0, atol=ATOL)


def _yaml(tmp):
    path = tmp / "tiny.yaml"
    path.write_text(YAML.replace("OUT", str(tmp / "out")))
    return str(path)


@pytest.mark.parametrize("kind", figures.KINDS)
def test_cli_writes_each_figure_on_a_tiny_checkpoint(setup, kind, tmp_path):
    out = str(tmp_path / ("pages" if kind == "recon-paged" else f"{kind}.png"))
    argv = [kind, "--yaml", _yaml(tmp_path), "-m", setup["ckpt"], "-o", out, "--device", "cpu"]
    if kind == "recon":
        argv += ["--count", "2"]
    if kind in figures.FOLDER_KINDS:
        argv += ["--samples", setup["samples"]]
    if kind == "interpolation-images":
        argv += ["--image-a", "img0.png", "--image-b", "img2.png"]
    figures.main(argv)
    written = (os.listdir(out) if kind == "recon-paged" else [out])
    assert written and all(os.path.getsize(os.path.join(out, w) if kind == "recon-paged" else w)
                           > 0 for w in written)


@pytest.mark.parametrize("missing, kind", [("matplotlib", "samples"), ("PIL", "recon-paged")])
def test_cli_raises_without_its_packages(setup, monkeypatch, tmp_path, missing, kind):
    real = figures.importlib.util.find_spec
    monkeypatch.setattr(figures.importlib.util, "find_spec",
                        lambda name, *a: None if name == missing else real(name, *a))
    out = tmp_path / "never.png"
    argv = [kind, "--yaml", _yaml(tmp_path), "-m", setup["ckpt"], "-o", str(out), "--device",
            "cpu"]
    if kind in figures.FOLDER_KINDS:
        argv += ["--samples", setup["samples"]]
    with pytest.raises(ImportError, match=missing):
        figures.main(argv)
    assert not out.exists()
    with pytest.raises(ImportError, match=missing):  # the writer checks too
        if missing == "matplotlib":
            figures.write_grid(np.zeros((1, 4, 4, 3)), str(out), nrow=1)
        else:
            figures.load_sample_images(setup["samples"], RES)
