"""Quantitative 2D metrics: grid-normalized ELBO, histogram KL and JSD (port
of metrics/toy.py).

The reference (soft_intro_vae_2d/train_soft_intro_vae_2d.py): setup_grid
(:217-221), calculate_elbo_with_grid (:345-373), and calculate_sample_kl
(:376-394) with torch ``F.kl_div(reduction="batchmean")``'s semantics
(divided by the histogram's first dimension, 0 * log 0 = 0). The forwards run
on ``device`` in large chunks; the histograms and the reductions over them
stay numpy on the host, as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from soft_intro_vae_torch.ops.losses import kl_divergence, per_sample_recon

Tensor = torch.Tensor
# model_fwd(x) -> (mu, logvar, rec): the deterministic (z = mu) forward
DeterministicFwd = Callable[[Tensor], Tuple[Tensor, Tensor, Tensor]]


def setup_grid(range_lim: float = 4.0, n_pts: int = 1000) -> np.ndarray:
    """The flattened (n_pts^2, 2) grid over [-range_lim, range_lim]^2 (:217-221)."""
    x = np.linspace(-range_lim, range_lim, n_pts, dtype=np.float32)
    xx, yy = np.meshgrid(x, x, indexing="ij")
    return np.stack([xx.ravel(), yy.ravel()], axis=1)


@torch.no_grad()
def _neg_elbo(model_fwd: DeterministicFwd, x: np.ndarray, beta_kl: float, beta_rec: float,
              device) -> np.ndarray:
    xt = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)
    mu, logvar, rec = model_fwd(xt)
    kl = kl_divergence(mu, logvar, reduce="none")
    return (beta_kl * kl + beta_rec * per_sample_recon(xt, rec, "mse")).cpu().numpy()


def _chunked_vals(model_fwd: DeterministicFwd, grid: np.ndarray, beta_kl: float,
                  beta_rec: float, chunk: int, device) -> np.ndarray:
    return np.concatenate([_neg_elbo(model_fwd, grid[i:i + chunk], beta_kl, beta_rec, device)
                           for i in range(0, grid.shape[0], chunk)])


def grid_normalized_elbo(model_fwd: DeterministicFwd, sampler, grid: np.ndarray,
                         beta_kl: float = 1.0, beta_rec: float = 1.0, batch_size: int = 512,
                         num_iter: int = 100, grid_chunk: int = 65536, device="cuda") -> float:
    """calculate_elbo_with_grid (:345-373): the mean over data points of their
    neg-ELBO, each divided by the neg-ELBOs summed over the grid and the data.

    The grid goes through in ``grid_chunk``-point chunks (a point's value does
    not depend on its chunk); the data keeps the reference's ``num_iter``
    draws of ``batch_size``.
    """
    grid_sum = float(_chunked_vals(model_fwd, grid, beta_kl, beta_rec, grid_chunk, device).sum())
    elbos = np.concatenate([
        _neg_elbo(model_fwd, sampler.next_batch(batch_size=batch_size), beta_kl, beta_rec, device)
        for _ in range(num_iter)])
    normalizing = grid_sum + elbos.sum()
    return float((elbos / normalizing).mean())


def _kl_div_batchmean(log_q: np.ndarray, p: np.ndarray) -> float:
    """torch ``F.kl_div(input=log_q, target=p, reduction="batchmean")`` with
    0 * log 0 = 0; the batch is the histogram's first dimension."""
    term = np.where(p > 0, p * (np.log(np.where(p > 0, p, 1.0)) - log_q), 0.0)
    return float(term.sum() / p.shape[0])


def sample_kl_2d(sample_model: Callable[[int], np.ndarray], sampler, num_samples: int = 5000,
                 hist_bins: int = 100, use_jsd: bool = False,
                 xy_range: Tuple[float, float] = (-2, 2)) -> float:
    """calculate_sample_kl (:376-394): the histogram KL(fake || real), or the
    JSD with ``use_jsd``."""
    hist_range = [list(xy_range), list(xy_range)]
    real = np.asarray(sampler.next_batch(batch_size=num_samples))
    real_hist, _, _ = np.histogram2d(real[:, 0], real[:, 1], bins=hist_bins, density=True,
                                     range=hist_range)
    fake = np.asarray(sample_model(num_samples))
    fake_hist, _, _ = np.histogram2d(fake[:, 0], fake[:, 1], bins=hist_bins, density=True,
                                     range=hist_range)
    if use_jsd:
        m = 0.5 * (fake_hist + real_hist)
        kl_1 = _kl_div_batchmean(np.log(real_hist + 1e-14), m)
        kl_2 = _kl_div_batchmean(np.log(fake_hist + 1e-14), m)
        return 0.5 * (kl_1 + kl_2)
    return _kl_div_batchmean(np.log(fake_hist + 1e-14), real_hist)


def vae_density(model_fwd: DeterministicFwd, grid: np.ndarray, beta_kl: float = 1.0,
                beta_rec: float = 1.0, chunk: int = 65536, device="cuda") -> np.ndarray:
    """plot_vae_density's p(x) ~ exp(-(beta_kl * kl + beta_rec * rec)) on a grid (:232-258)."""
    return np.exp(-_chunked_vals(model_fwd, grid, beta_kl, beta_rec, chunk, device))
