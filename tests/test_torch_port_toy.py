"""Port parity: the 2D toy variant (soft_intro_vae_torch) against the JAX package.

* ``ToyDataset``: the same batches, bit for bit, for every distribution and
  two seeds (numpy draws in the same order).
* ``EncoderMLP``/``DecoderMLP``: the JAX nets' weights carried across by
  ``mlp_state_dict_from_jax``; outputs within 1e-6 (measured: a few 1e-8).
* The toy step (the generic step at the toy ``StepConfig``, dim_scale 0.5):
  one vanilla and two chained intro steps from the JAX package's
  ``build_toy``, with the same weights and injected noises; loss_e, loss_d
  (and every metric) within rel 1e-5 (measured: 2.6e-7 at most, the intro
  losses equal).
* The metrics: ``setup_grid`` equal, ``sample_kl_2d`` (KL and JSD) equal on
  fixed samples, ``grid_normalized_elbo`` and ``vae_density`` within rel 1e-5.
* The trainer at a tiny width: the results line, checkpoints, the LR
  milestones, the NaN abort, and a reference state_dict with ``loggamma``.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soft_intro_vae_tpu.data.toy import DISTRIBUTIONS as JAX_DISTRIBUTIONS
from soft_intro_vae_tpu.data.toy import ToyDataset as JaxToyDataset
from soft_intro_vae_tpu.metrics import toy as jax_metrics
from soft_intro_vae_tpu.train.toy import ToyConfig as JaxToyConfig
from soft_intro_vae_tpu.train.toy import build_toy as jax_build_toy
from soft_intro_vae_tpu.train.toy import make_eval_fns
from soft_intro_vae_torch.data.toy import DISTRIBUTIONS, ToyDataset
from soft_intro_vae_torch.metrics import toy as metrics
from soft_intro_vae_torch.models.mlp import DecoderMLP, EncoderMLP, SoftIntroVAESimple
from soft_intro_vae_torch.train import toy as toy_trainer
from soft_intro_vae_torch.train.step import INTRO_NOISES
from soft_intro_vae_torch.train.toy import ToyConfig, build_toy, det_fwd, train_soft_intro_vae_toy
from soft_intro_vae_torch.utils.checkpoint import Checkpointer, load_pretrained
from soft_intro_vae_torch.utils.from_jax import mlp_state_dict_from_jax
from tests.torch_port_fixtures import one_torch_thread  # noqa: F401

NL, H, Z, B = 2, 16, 2, 8
BETAS = dict(beta_rec=0.2, beta_kl=0.3, beta_neg=0.9, gamma_r=1e-8)
LR = 1e-3


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, dtype=np.float32), tree)


def _port_cfg(tmp_path, **kw):
    base = dict(dataset="8Gaussians", z_dim=Z, batch_size=B, n_iter=6, num_vae=2, n_layers=NL,
                num_hidden=H, test_iter=3, save_interval=4, seed=0, lr_e=LR, lr_d=LR,
                result_dir=str(tmp_path / "run"), verbose=False, device="cpu", **BETAS)
    base.update(kw)
    return ToyConfig(**base)


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("distr", DISTRIBUTIONS)
def test_toy_dataset_is_bit_equal_to_the_jax_one(distr, seed):
    assert DISTRIBUTIONS == JAX_DISTRIBUTIONS
    port = ToyDataset(distr, seed=seed, iter_per_mode=2)
    ref = JaxToyDataset(distr, seed=seed, iter_per_mode=2)
    assert port.range == ref.range
    for n in (64, 64, 33, 64, 5):  # Sequential8Gaussians changes mode every 2 batches
        a, b = port.next_batch(n), ref.next_batch(n)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    assert port.curr_mode == ref.curr_mode


def test_unknown_distribution_raises():
    with pytest.raises(ValueError, match="unknown distribution"):
        ToyDataset("moons")


@pytest.fixture(scope="module")
def jax_toy():
    """The JAX package's toy nets, initial weights (numpy: the steps donate
    the state's buffers), state and steps at a tiny width."""
    cfg = JaxToyConfig(z_dim=Z, n_layers=NL, num_hidden=H, seed=0, lr_e=LR, lr_d=LR, **BETAS)
    enc, dec, state, vanilla, intro = jax_build_toy(cfg)
    params = (_np_tree(state.params_e), _np_tree(state.params_d))
    return params, enc, dec, state, vanilla, intro


def _port_model(params_e, params_d):
    model = SoftIntroVAESimple(x_dim=2, z_dim=Z, n_layers=NL, num_hidden=H)
    sd = {**mlp_state_dict_from_jax(params_e, NL, "encoder."),
          **mlp_state_dict_from_jax(params_d, NL, "decoder.")}
    model.load_state_dict(sd)
    return model


def test_mlps_match_the_jax_nets(jax_toy):
    (pe, pd), enc, dec, _, _, _ = jax_toy
    x = np.random.RandomState(0).randn(5, 2).astype(np.float32)
    z = np.random.RandomState(1).randn(5, Z).astype(np.float32)
    model = _port_model(pe, pd)
    mu_j, lv_j = enc.apply({"params": pe}, jnp.asarray(x))
    rec_j = dec.apply({"params": pd}, jnp.asarray(z))
    with torch.no_grad():
        mu, lv = model.encoder(torch.tensor(x))
        rec = model.decoder(torch.tensor(z))
    np.testing.assert_allclose(mu.numpy(), np.asarray(mu_j), rtol=0, atol=1e-6)
    np.testing.assert_allclose(lv.numpy(), np.asarray(lv_j), rtol=0, atol=1e-6)
    np.testing.assert_allclose(rec.numpy(), np.asarray(rec_j), rtol=0, atol=1e-6)
    # the reference's names, and the JAX package's reader of them
    from soft_intro_vae_tpu.utils.torch_compat import convert_mlp

    back = convert_mlp({k: v.numpy() for k, v in model.state_dict().items()}, NL, "encoder.")
    np.testing.assert_array_equal(back["hidden_2"]["kernel"], pe["hidden_2"]["kernel"])
    layers = ("input", "hidden_1", "hidden_2", "output")
    assert set(model.decoder.state_dict()) == {f"main.{n}.{p}" for n in layers
                                               for p in ("weight", "bias")}


def test_init_follows_the_fan_in_uniform_of_the_jax_nets():
    torch.manual_seed(0)
    enc = EncoderMLP(x_dim=2, z_dim=Z, n_layers=NL, num_hidden=256)
    w, b = enc.main.hidden_1.weight, enc.main.hidden_1.bias
    bound = 1.0 / np.sqrt(256)
    assert float(w.detach().abs().max()) <= bound and float(b.detach().abs().max()) <= bound
    assert float(w.detach().std()) == pytest.approx(bound / np.sqrt(3), rel=0.02)  # uniform(-b, b)


def test_one_vanilla_and_two_intro_steps_match_jax(jax_toy, tmp_path):
    (pe, pd), _, _, jstate, jvanilla, jintro = jax_toy
    state, vanilla, intro = build_toy(_port_cfg(tmp_path))
    state.model.load_state_dict(_port_model(pe, pd).state_dict())
    rs = np.random.RandomState(3)
    sampler = ToyDataset("8Gaussians", seed=5)

    x = sampler.next_batch(B)
    k = jax.random.fold_in(jstate.rng, jstate.step)
    eps = np.asarray(jax.random.normal(jax.random.fold_in(k, 0), (B, Z), jnp.float32))
    jstate, jm = jvanilla(jstate, jnp.asarray(x))
    state, m = vanilla(state, torch.tensor(x), {"eps": torch.tensor(eps)})
    assert set(m) == set(jm)
    for key in m:
        assert float(m[key]) == pytest.approx(float(jm[key]), rel=1e-5), f"vanilla {key}"

    for i in range(2):
        x = sampler.next_batch(B)
        nz = {name: rs.randn(B, Z).astype(np.float32) for name in INTRO_NOISES}
        jstate, jm = jintro(jstate, jnp.asarray(x), {k: jnp.asarray(v) for k, v in nz.items()})
        state, m = intro(state, torch.tensor(x), {k: torch.tensor(v) for k, v in nz.items()})
        assert set(m) == set(jm)
        for key in ("loss_e", "loss_d"):
            assert float(m[key]) == pytest.approx(float(jm[key]), rel=1e-5), f"step {i} {key}"
        for key in ("rec", "kl_real", "kl_rec", "kl_fake", "expelbo_r", "expelbo_f"):
            assert float(m[key]) == pytest.approx(float(jm[key]), rel=1e-5, abs=1e-7), \
                f"step {i} {key}"
    assert state.step == 3 == int(jstate.step)
    after = _port_model(_np_tree(jstate.params_e), _np_tree(jstate.params_d)).state_dict()
    for key, v in state.model.state_dict().items():
        torch.testing.assert_close(v, after[key], rtol=0, atol=1e-5, msg=key)


def test_grid_and_sample_kl_match_jax():
    np.testing.assert_array_equal(metrics.setup_grid(2.5, 17), jax_metrics.setup_grid(2.5, 17))
    fake = ToyDataset("8Gaussians", seed=9).next_batch(2000) * 1.1

    def sample_model(n):
        return fake[:n]

    for use_jsd in (False, True):
        got = metrics.sample_kl_2d(sample_model, ToyDataset("8Gaussians", seed=4), num_samples=2000,
                                   hist_bins=40, use_jsd=use_jsd, xy_range=(-2, 2))
        want = jax_metrics.sample_kl_2d(sample_model, JaxToyDataset("8Gaussians", seed=4),
                                        num_samples=2000, hist_bins=40, use_jsd=use_jsd,
                                        xy_range=(-2, 2))
        assert np.isfinite(got) and got > 0
        assert got == want, use_jsd


def test_kl_div_batchmean_is_torch_kl_div():
    rs = np.random.RandomState(2)
    p = rs.rand(6, 5)
    p[0, :2] = 0.0  # 0 * log 0 = 0
    log_q = np.log(rs.rand(6, 5) + 1e-3)
    want = torch.nn.functional.kl_div(torch.tensor(log_q), torch.tensor(p), reduction="batchmean")
    assert metrics._kl_div_batchmean(log_q, p) == pytest.approx(float(want), rel=1e-12)


def test_grid_elbo_and_density_match_jax(jax_toy):
    (pe, pd), enc, dec, _, _, _ = jax_toy
    jfwd, _ = make_eval_fns(enc, dec)
    model = _port_model(pe, pd)

    def fwd(x):
        mu, lv = model.encoder(x)
        return mu, lv, model.decoder(mu)

    grid = metrics.setup_grid(4.0, 48)
    got = metrics.vae_density(fwd, grid, 0.3, 0.2, chunk=1000, device="cpu")
    want = jax_metrics.vae_density(lambda x: jfwd(pe, pd, x), grid,
                                   0.3, 0.2, chunk=1000)
    assert got.shape == (48 * 48,)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    got = metrics.grid_normalized_elbo(fwd, ToyDataset(seed=1), grid, batch_size=16, num_iter=5,
                                       grid_chunk=1000, device="cpu")
    want = jax_metrics.grid_normalized_elbo(lambda x: jfwd(pe, pd, x),
                                            JaxToyDataset(seed=1), grid, batch_size=16, num_iter=5,
                                            grid_chunk=1000)
    assert got == pytest.approx(want, rel=1e-5)


def test_trainer_writes_the_results_line_and_checkpoints(tmp_path):
    cfg = _port_cfg(tmp_path, save_checkpoints=True)
    state, res = train_soft_intro_vae_toy(cfg)
    assert state.step == 6 and set(res) == {"sample_kl", "jsd", "gn_elbo"}
    assert all(np.isfinite(v) for v in res.values())
    with open(tmp_path / "run" / "results_log_soft_intro_vae.txt") as f:
        line = f.read()
    pattern = (r"8Gaussians_beta_kl_0\.3_beta_neg_0\.9_beta_rec_0\.2_gnelbo_(\S+)_kl_(\S+)_jsd_(\S+)"
               r"_seed_0\n")
    got = re.fullmatch(pattern, line)
    assert got, line
    assert [float(g) for g in got.groups()] == [res["gn_elbo"], res["sample_kl"], res["jsd"]]
    # save_interval 4: iteration 4's state; it loads back into a fresh state
    names = os.listdir(tmp_path / "run" / "saves")
    assert "model_epoch_4_iter_4.ckpt" in names
    fresh, _, _ = build_toy(_port_cfg(tmp_path, seed=1))
    loaded, epoch = Checkpointer(str(tmp_path / "run" / "saves")).load_latest(fresh)
    assert epoch == 4 and loaded.step == 5  # the 5th step ran at iteration 4
    # a second run appends its line
    train_soft_intro_vae_toy(cfg)
    with open(tmp_path / "run" / "results_log_soft_intro_vae.txt") as f:
        assert len(f.readlines()) == 2


def test_two_runs_of_a_seed_are_equal_and_the_metrics_leave_the_draws_alone(tmp_path):
    a, res_a = train_soft_intro_vae_toy(_port_cfg(tmp_path))
    assert train_soft_intro_vae_toy(_port_cfg(tmp_path))[1] == res_a
    # the figures draw their samples from generators of their own (the real
    # scatter's 1024 points come from the sampler, as in the JAX trainer, so
    # the final metrics then see other real points)
    b, _ = train_soft_intro_vae_toy(_port_cfg(tmp_path, save_figures=True,
                                              result_dir=str(tmp_path / "figs")))
    for k, v in a.model.state_dict().items():
        torch.testing.assert_close(v, b.model.state_dict()[k], rtol=0, atol=0, msg=k)
    torch.testing.assert_close(a.generator.get_state(), b.generator.get_state())
    figs = sorted(os.listdir(tmp_path / "figs"))
    assert "density_8Gaussians.png" in figs and "8Gaussians_real.png" in figs
    assert any(f.endswith("_iter_3.png") for f in figs)


def test_lr_follows_the_milestones_every_iteration(tmp_path, monkeypatch):
    monkeypatch.setattr(toy_trainer, "LR_MILESTONES", (2, 4))
    state, _ = train_soft_intro_vae_toy(_port_cfg(tmp_path, n_iter=3))
    assert state.lr_e == pytest.approx(LR * 0.1) and state.lr_d == pytest.approx(LR * 0.1)
    state, _ = train_soft_intro_vae_toy(_port_cfg(tmp_path, n_iter=4))
    assert state.lr_e == pytest.approx(LR * 0.01)
    assert float(state.opt_d.param_groups[0]["lr"]) == pytest.approx(LR * 0.01)
    assert toy_trainer.optim.multistep_lr(2e-4, (10000, 15000), 0.1)(15000) == pytest.approx(2e-6)


class _NanSampler:
    range = 1

    def next_batch(self, batch_size=64):
        return np.full((batch_size, 2), np.nan, np.float32)


def test_nan_loss_raises_system_error(tmp_path):
    with pytest.raises(SystemError, match="NaN"):
        train_soft_intro_vae_toy(_port_cfg(tmp_path), sampler=_NanSampler())


def test_reference_state_dict_with_loggamma_loads(tmp_path):
    model = SoftIntroVAESimple(x_dim=2, z_dim=Z, n_layers=NL, num_hidden=H)
    sd = {k: torch.randn_like(v) for k, v in model.state_dict().items()}
    sd["decoder.loggamma"] = torch.zeros(1)
    with pytest.warns(UserWarning, match="decoder.loggamma"):
        model.load_state_dict(dict(sd))
    torch.testing.assert_close(model.decoder.main.output.weight, sd["decoder.main.output.weight"])
    dec = DecoderMLP(x_dim=2, z_dim=Z, n_layers=NL, num_hidden=H)
    with pytest.warns(UserWarning, match="'loggamma'"):
        dec.load_state_dict({"loggamma": torch.zeros(1),
                             **{k[len("decoder."):]: v for k, v in sd.items() if k.startswith("decoder.main")}})
    # a reference .pth ({"epoch", "model"}) through the trainer's -p path
    path = tmp_path / "ref.pth"
    torch.save({"epoch": 7, "model": sd}, path)
    state, _, _ = build_toy(_port_cfg(tmp_path))
    with pytest.warns(UserWarning, match="loggamma"):
        assert load_pretrained(str(path), state) == 7
    torch.testing.assert_close(state.model.encoder.main.input.bias, sd["encoder.main.input.bias"])


def test_det_fwd_is_the_deterministic_forward(tmp_path):
    state, _, _ = build_toy(_port_cfg(tmp_path))
    x = torch.tensor(ToyDataset(seed=2).next_batch(4))
    mu, lv, rec = det_fwd(state)(x)
    torch.testing.assert_close(rec, state.decoder(state.encoder(x)[0]))
