"""Writes the JAX package's checkpoints that the port continues: the fixtures
of chip_smoke.py's carry phase and of tests/test_torch_port_jax_runs.py.

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/torch_port_fixtures/make_jax_checkpoints.py [OUT]

from the repository's root.

With the JAX package on the CPU, into OUT (default: ``jax_checkpoints/``
beside this file), each run through the JAX trainer's own build function and
``Checkpointer``:

  threed/  the 3D trainer's state at narrow PointNet widths and 256 points
           (the JAX modules' ``conv_channels``/``hidden`` fields), its decoder
           output scaled by ``SPREAD`` so its clouds are spread as a trained
           decoder's (the chamfer matches are then no near-ties, see
           tests/test_torch_port_step.py), after 2 and after 4 intro steps
           (``model_epoch_1_iter_2.ckpt``, ``model_epoch_2_iter_4.ckpt``);
  style/   the style trainer's state at LOD 1 with tiny channels after 2 intro
           steps (noise mode "none", no style mixing), with the trainer's
           ``.aux.json`` sidecar. Its init is moved by seeded noise of scale
           ``STYLE_BUMP``, as tests/test_torch_port_style_step.py moves its
           weights: from the init itself the losses are ill-conditioned, two
           float32 routes (the port's, the JAX package's) lie 2e-3 apart in
           loss_e and 20% in fake_kl at the step after the checkpoint; with
           the noise each lies within 2.3e-5 (loss_e) and 1.5e-4 (fake_kl)
           of the port's float64 route.

Beside each, ``next_steps.npz``: ``config`` (JSON of the overrides of the
trainer's config: of configs/soft_intro_vae_hp.json for threed, of the
defaults for style, with the widths and the step's LOD), the batches ``x``
and the injected draws ``draw_<name>`` of the 2 intro steps after the latest
checkpoint, and
JAX's metrics of those steps (``metric_<name>``); for threed also eval_3d's
valid-set JSD of each checkpoint (``jsd_<file>``) under the prior draws
``jsd_noise`` (3 trials), which the JAX package's ``_jsd_vs_samples`` draws.
Every value comes from fixed seeds, so a second run writes the same trees.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

from soft_intro_vae_tpu.cli import eval_3d as jax_eval_3d
from soft_intro_vae_tpu.models import pointnet as jax_pointnet
from soft_intro_vae_tpu.train import style as jax_style
from soft_intro_vae_tpu.train import threed as jax_threed
from soft_intro_vae_tpu.train.style_step import StyleStepConfig, build_style_steps
from soft_intro_vae_tpu.utils.checkpoint import Checkpointer

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
OUT = os.path.join(HERE, "jax_checkpoints")

INTRO_NOISES = ("noise", "eps_real", "eps_e_rec", "eps_e_fake", "eps_d_z", "eps_d_rec", "eps_d_fake")
NZ_KEYS = ("eps_real", "eps_e_rec", "eps_e_fake", "eps_d_rec", "eps_d_fake", "noise", "noise_d")

THREED = dict(n_points=256, batch_size=4, z_size=8, seed=0, use_synthetic=True, synthetic_n=64,
              num_devices=1, verbose=False, conv_channels=(16, 16, 32, 32, 32),
              hidden=(16, 32, 32, 16))
SPREAD = 20.0
STYLE = dict(name="tiny", layer_count=2, start_channel_count=4, max_channel_count=8,
             latent_space_size=8, mapping_layers=2, style_mixing_prob=None, truncation_psi=None,
             beta_kl=0.2, beta_rec=0.1, beta_neg=(8.0, 8.0), scale=1.0 / (3 * 8 * 8),
             base_learning_rate=1.5e-3, epochs_per_lod=2, num_devices=1, verbose=False)
STYLE_LOD, STYLE_BATCH, STYLE_EMA_BETA = 1, 2, 0.9
STYLE_BUMP = 0.05


@contextlib.contextmanager
def _narrow_pointnet(conv_channels, hidden):
    """The JAX 3D trainer builds its nets at the recipe's widths: for the
    time of the build, its module names the nets at these."""
    saved = jax_threed.PointNetEncoder, jax_threed.PointNetDecoder
    jax_threed.PointNetEncoder = functools.partial(jax_pointnet.PointNetEncoder,
                                                   conv_channels=conv_channels)
    jax_threed.PointNetDecoder = functools.partial(jax_pointnet.PointNetDecoder, hidden=hidden)
    try:
        yield
    finally:
        jax_threed.PointNetEncoder, jax_threed.PointNetDecoder = saved


def _intro_draws(rs, b: int, z: int, prior_std: float) -> dict:
    nz = {k: rs.randn(b, z).astype(np.float32) for k in INTRO_NOISES}
    nz["noise"] *= np.float32(prior_std)
    return nz


def _metrics(ms) -> dict:
    return {f"metric_{k}": np.array([float(m[k]) for m in ms], np.float32) for k in ms[0]}


def write_threed(out: str):
    """Writes threed/ into ``out``; returns JAX's state after the recorded steps."""
    widths = {k: THREED[k] for k in ("conv_channels", "hidden")}
    base = jax_threed.ThreeDConfig.from_json(os.path.join(ROOT, "configs", "soft_intro_vae_hp.json"))
    cfg = dataclasses.replace(base, **{k: v for k, v in THREED.items() if k not in widths},
                              results_dir=out)
    with _narrow_pointnet(**widths):
        _, dec, state, _, intro, _ = jax_threed.build_3d_training(cfg)
    params_d = dict(state.params_d)
    params_d["out"] = jax.tree_util.tree_map(lambda a: a * SPREAD, params_d["out"])
    state = state.replace(params_d=params_d)
    train = jax_threed.SyntheticClouds(cfg.synthetic_n, cfg.n_points, seed=0).load_all()[0]
    valid = jax_eval_3d._points(cfg, "valid")
    rs = np.random.RandomState(3)
    ckpt = Checkpointer(out)
    saved = {}

    def steps(state, n):
        batches, draws, ms = [], [], []
        for _ in range(n):
            x = train[rs.choice(len(train), cfg.batch_size, replace=False)]
            nz = _intro_draws(rs, cfg.batch_size, cfg.z_size, cfg.prior_std)
            state, m = intro(state, jnp.asarray(x), {k: jnp.asarray(v) for k, v in nz.items()})
            batches.append(x)
            draws.append(nz)
            ms.append(jax.device_get(m))
        return state, batches, draws, ms

    for epoch in (1, 2):
        state, *_ = steps(state, 2)
        path = ckpt.save(state, epoch, int(state.step))
        saved[os.path.basename(path)] = float(
            jax_eval_3d._jsd_vs_samples(dec, state, valid, cfg))
    state, batches, draws, ms = steps(state, 2)
    n = len(valid)
    noise = [np.asarray(cfg.prior_std * jax.random.normal(
        jax.random.fold_in(jax.random.key(777), t), (3 * n, cfg.z_size), jnp.float32))
        for t in range(3)]
    np.savez(os.path.join(out, "next_steps.npz"), config=json.dumps(THREED),
             x=np.stack(batches), **{f"draw_{k}": np.stack([d[k] for d in draws])
                                     for k in INTRO_NOISES},
             **_metrics(ms), jsd_noise=np.stack(noise),
             **{f"jsd_{name}": np.float64(v) for name, v in saved.items()})
    return state


def write_style(out: str):
    """Writes style/ into ``out``; returns JAX's state after the recorded steps."""
    cfg = dataclasses.replace(jax_style.StyleConfig(), **STYLE, output_dir=out)
    model, opt, state, _ = jax_style.build_style_training(cfg)
    rs = np.random.RandomState(4)
    params_e, params_d = (jax.tree_util.tree_map(
        lambda a: np.asarray(a) + STYLE_BUMP * rs.randn(*a.shape).astype(np.float32), t)
        for t in (state.params_e, state.params_d))
    on = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # a buffer each: the step donates
    state = state.replace(params_e=on(params_e), params_d=on(params_d), ema_e=on(params_e),
                          ema_d=on(params_d), lr=jnp.asarray(cfg.base_learning_rate, jnp.float32),
                          ema_beta=jnp.asarray(STYLE_EMA_BETA, jnp.float32))
    scfg = StyleStepConfig(latent_size=cfg.latent_space_size, beta_rec=cfg.beta_rec,
                           beta_kl=cfg.beta_kl, beta_neg=float(cfg.beta_neg[STYLE_LOD]),
                           gamma_r=1e-8, scale=cfg.scale)
    _, intro = build_style_steps(model, scfg, STYLE_LOD, False, opt, noise_mode="none")
    rs = np.random.RandomState(5)
    res = 2 ** (STYLE_LOD + 2)
    blend = jnp.asarray(1.0, jnp.float32)

    def steps(state, n):
        batches, draws, ms = [], [], []
        for _ in range(n):
            x = (rs.rand(STYLE_BATCH, res, res, cfg.channels) * 2.0 - 1.0).astype(np.float32)
            nz = {k: rs.randn(STYLE_BATCH, cfg.latent_space_size).astype(np.float32)
                  for k in NZ_KEYS}
            state, m = intro(state, jnp.asarray(x), blend, {k: jnp.asarray(v) for k, v in nz.items()})
            batches.append(x)
            draws.append(nz)
            ms.append(jax.device_get(m))
        return state, batches, draws, ms

    state, *_ = steps(state, 2)
    epoch = cfg.epochs_per_lod * STYLE_LOD  # the first epoch at LOD 1
    Checkpointer(out, prefix=cfg.name + "_").save(
        state, epoch, int(state.step),
        aux={"tracker": {}, "best_fid": None, "lods_seen": [0, 1], "lod": STYLE_LOD,
             "epoch_completed": True})
    state, batches, draws, ms = steps(state, 2)
    config = {**STYLE, "lod": STYLE_LOD, "ema_beta": STYLE_EMA_BETA}
    np.savez(os.path.join(out, "next_steps.npz"), config=json.dumps(config),
             x=np.stack(batches), **{f"draw_{k}": np.stack([d[k] for d in draws])
                                     for k in NZ_KEYS}, **_metrics(ms))
    return state


def write_all(out: str = OUT) -> dict:
    """Both fixtures into ``out``; returns JAX's states after their recorded steps."""
    return {"threed": write_threed(os.path.join(out, "threed")),
            "style": write_style(os.path.join(out, "style"))}


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    write_all(sys.argv[1] if len(sys.argv) > 1 else OUT)
