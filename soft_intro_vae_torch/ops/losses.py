"""Core loss math for Soft-IntroVAE (port of soft_intro_vae_tpu/ops/losses.py).

Reference semantics (taldatech/soft-intro-vae-pytorch):
  * KL:   soft_intro_vae/train_soft_intro_vae.py:231-251 (general-prior form)
  * reparameterize: same file :254-265
  * reconstruction: same file :268-294
  * expELBO: same file :580-581

Loss scalars are computed in float32 whatever the network dtype.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

Tensor = torch.Tensor
Scalar = Union[float, Tensor]

_REDUCTIONS = ("sum", "mean", "none")


def _reduce(x: Tensor, reduction: str) -> Tensor:
    if reduction == "sum":
        return x.sum()
    if reduction == "mean":
        return x.mean()
    if reduction == "none":
        return x
    raise NotImplementedError(f"unknown reduction: {reduction!r}")


def kl_divergence(mu: Tensor, logvar: Tensor, mu_o: Scalar = 0.0, logvar_o: Scalar = 0.0,
                  reduce: str = "sum") -> Tensor:
    """KL(N(mu, e^logvar) || N(mu_o, e^logvar_o)), summed over latent dims.

    Returns a (B,) vector for reduce='none', else a scalar.
    """
    if reduce not in _REDUCTIONS:
        raise NotImplementedError(f"unknown reduce: {reduce!r}")
    mu = mu.float()
    logvar = logvar.float()
    if isinstance(logvar_o, Tensor):
        logvar_o = logvar_o.to(dtype=torch.float32, device=mu.device)
    else:  # a fill on the device, not a host copy: the step stays capturable
        logvar_o = torch.full((), float(logvar_o), dtype=torch.float32, device=mu.device)
    kl = -0.5 * torch.sum(
        1.0 + logvar - logvar_o - torch.exp(logvar - logvar_o)
        - torch.square(mu - mu_o) * torch.exp(-logvar_o),
        dim=-1,
    )
    return _reduce(kl, reduce)


def reparameterize(mu: Tensor, logvar: Tensor, eps: Optional[Tensor] = None,
                   generator: Optional[torch.Generator] = None) -> Tensor:
    """z = mu + eps * exp(0.5*logvar); eps ~ N(0, I) from ``generator`` unless given."""
    if eps is None:
        eps = torch.randn(mu.shape, generator=generator, device=mu.device, dtype=torch.float32)
    return mu.float() + eps * torch.exp(0.5 * logvar.float())


def reconstruction_loss(x: Tensor, x_rec: Tensor, loss_type: str = "mse",
                        reduction: str = "sum") -> Tensor:
    """Reconstruction error with the reference's reductions.

    'mse' sums squared error per sample, then reduces over the batch; 'l1' and
    'bce' reduce elementwise (torch F.l1_loss / F.binary_cross_entropy), so
    reduction='none' returns (B, D).
    """
    if reduction not in _REDUCTIONS:
        raise NotImplementedError(f"unknown reduction: {reduction!r}")
    b = x.shape[0]
    x = x.reshape(b, -1).float()
    x_rec = x_rec.reshape(b, -1).float()
    if loss_type == "mse":
        return _reduce(torch.sum(torch.square(x_rec - x), dim=1), reduction)
    if loss_type == "l1":
        return _reduce(torch.abs(x_rec - x), reduction)
    if loss_type == "bce":
        eps = 1e-12  # keep the log terms finite, as the JAX package does
        p = torch.clamp(x_rec, eps, 1.0 - eps)
        return _reduce(-(x * torch.log(p) + (1.0 - x) * torch.log1p(-p)), reduction)
    raise NotImplementedError(f"unknown loss_type: {loss_type!r}")


def per_sample_recon(x: Tensor, x_rec: Tensor, loss_type: str = "mse") -> Tensor:
    """Per-sample reconstruction error (B,), the expELBO ingredient."""
    err = reconstruction_loss(x, x_rec, loss_type=loss_type, reduction="none")
    while err.dim() > 1:
        err = err.sum(dim=-1)
    return err


def exp_elbo(rec_per_sample: Tensor, kl_per_sample: Tensor, scale: Scalar, beta_rec: Scalar,
             beta_neg: Scalar) -> Tensor:
    """mean_i exp(-2*scale*(beta_rec*rec_i + beta_neg*kl_i)), in float32."""
    arg = -2.0 * scale * (beta_rec * rec_per_sample + beta_neg * kl_per_sample)
    return torch.mean(torch.exp(arg.float()))
