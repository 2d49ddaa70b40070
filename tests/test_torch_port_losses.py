"""Port parity: soft_intro_vae_torch.ops.losses against soft_intro_vae_tpu.ops.losses.

Same numpy inputs through both; float32 elementwise math in both frameworks,
so rtol 1e-6 (a few ulp of the summed results).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soft_intro_vae_tpu.ops import losses as jl
from soft_intro_vae_torch.ops import losses as tl

RTOL = 1e-6


def _close(t, j, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=rtol, atol=atol)


def _xy(loss_type, seed=0):
    rs = np.random.RandomState(seed)
    if loss_type == "bce":
        return rs.rand(4, 3, 5, 5).astype(np.float32), rs.rand(4, 3, 5, 5).astype(np.float32)
    return rs.randn(4, 3, 5, 5).astype(np.float32), rs.randn(4, 3, 5, 5).astype(np.float32)


@pytest.mark.parametrize("reduction", ["sum", "mean", "none"])
@pytest.mark.parametrize("loss_type", ["mse", "l1", "bce"])
def test_reconstruction_loss(loss_type, reduction):
    x, r = _xy(loss_type)
    got = tl.reconstruction_loss(torch.tensor(x), torch.tensor(r), loss_type, reduction)
    ref = jl.reconstruction_loss(jnp.asarray(x), jnp.asarray(r), loss_type, reduction)
    assert tuple(got.shape) == tuple(ref.shape)
    _close(got, ref)


@pytest.mark.parametrize("loss_type", ["mse", "l1", "bce"])
def test_per_sample_recon(loss_type):
    x, r = _xy(loss_type, 1)
    got = tl.per_sample_recon(torch.tensor(x), torch.tensor(r), loss_type)
    ref = jl.per_sample_recon(jnp.asarray(x), jnp.asarray(r), loss_type)
    assert tuple(got.shape) == (4,)
    _close(got, ref)


@pytest.mark.parametrize("reduce", ["sum", "mean", "none"])
@pytest.mark.parametrize("logvar_o", [0.0, float(np.log(0.2**2))])
def test_kl_divergence(reduce, logvar_o):
    rs = np.random.RandomState(2)
    mu = rs.randn(4, 8).astype(np.float32)
    lv = (0.5 * rs.randn(4, 8)).astype(np.float32)
    got = tl.kl_divergence(torch.tensor(mu), torch.tensor(lv), logvar_o=logvar_o, reduce=reduce)
    ref = jl.kl_divergence(jnp.asarray(mu), jnp.asarray(lv), logvar_o=logvar_o, reduce=reduce)
    _close(got, ref)


def test_kl_divergence_general_prior_mean():
    rs = np.random.RandomState(3)
    mu, lv, mu_o = (rs.randn(4, 8).astype(np.float32) for _ in range(3))
    got = tl.kl_divergence(torch.tensor(mu), torch.tensor(lv), mu_o=torch.tensor(mu_o), logvar_o=-0.7)
    ref = jl.kl_divergence(jnp.asarray(mu), jnp.asarray(lv), mu_o=jnp.asarray(mu_o), logvar_o=-0.7)
    _close(got, ref)


def test_unknown_reduction_raises():
    x = torch.zeros(2, 3)
    with pytest.raises(NotImplementedError):
        tl.reconstruction_loss(x, x, "mse", "max")
    with pytest.raises(NotImplementedError):
        tl.reconstruction_loss(x, x, "huber")
    with pytest.raises(NotImplementedError):
        tl.kl_divergence(x, x, reduce="max")


def test_exp_elbo():
    rs = np.random.RandomState(4)
    rec = (5 * rs.rand(8)).astype(np.float32)
    kl = (3 * rs.rand(8)).astype(np.float32)
    got = tl.exp_elbo(torch.tensor(rec), torch.tensor(kl), 1.0 / 192, 20.0, 256.0)
    ref = jl.exp_elbo(jnp.asarray(rec), jnp.asarray(kl), 1.0 / 192, 20.0, 256.0)
    _close(got, ref)


def test_reparameterize_with_given_eps():
    rs = np.random.RandomState(5)
    mu, lv, eps = (rs.randn(4, 8).astype(np.float32) for _ in range(3))
    got = tl.reparameterize(torch.tensor(mu), torch.tensor(lv), eps=torch.tensor(eps))
    _close(got, mu + eps * np.exp(0.5 * lv), rtol=1e-6)
    gen = torch.Generator().manual_seed(0)
    drawn = tl.reparameterize(torch.tensor(mu), torch.tensor(lv), generator=gen)
    assert drawn.shape == (4, 8) and torch.isfinite(drawn).all()
