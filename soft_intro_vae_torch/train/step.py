"""The generic introspective (Soft-IntroVAE) train step (port of train/step.py).

PyTorch runs eagerly, so a step is the reference's own sequence of forwards
and two optimizer updates, with ``requires_grad`` toggled per phase as the
reference does (train_soft_intro_vae.py:552-555, 592-595): the E-phase leaves
no gradient on the decoder and the D-phase none on the encoder.

Reference semantics (file:line into taldatech/soft-intro-vae-pytorch):
  * E-step: soft_intro_vae/train_soft_intro_vae.py:551-589; rec.detach() and
    fake.detach() at the encoder inputs (:567-568); the expELBO recon target
    ``rec`` is not detached (:573) unless ``detach_expelbo_targets`` (3D :293).
  * D-step: :591-624; the updated encoder; z from the E-phase (:598) or, with
    ``fresh_z_in_d`` (3D :318-320), re-sampled with fresh eps under no_grad;
    z_rec/z_fake and the recon targets detached (:607-613).
  * vanilla warm-up: :512-540 (unscaled ELBO, joint E+D update).

BatchNorm: every encoder forward runs in train mode and updates the running
statistics, in reference order: x, rec.detach(), fake.detach() in the E-phase,
then rec and fake in the D-phase.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn

from soft_intro_vae_torch.ops.chamfer import chamfer_distance
from soft_intro_vae_torch.ops.losses import (
    exp_elbo,
    kl_divergence,
    per_sample_recon,
    reconstruction_loss,
    reparameterize,
)
from soft_intro_vae_torch.train.state import TrainState

Tensor = torch.Tensor
Metrics = Dict[str, Tensor]
StepFn = Callable[..., Tuple[TrainState, Metrics]]

INTRO_NOISES = ("noise", "eps_real", "eps_e_rec", "eps_e_fake", "eps_d_z", "eps_d_rec", "eps_d_fake")


@dataclasses.dataclass(frozen=True)
class StepConfig:
    z_dim: int
    beta_rec: float = 1.0
    beta_kl: float = 1.0
    beta_neg: float = 1.0
    gamma_r: float = 1e-8
    scale: float = 1.0            # 1/(C*H*W) images; 0.5 2D; 1/(3N) 3D
    loss_type: str = "mse"        # mse | l1 | bce | chamfer
    prior_logvar: float = 0.0     # 3D: log(prior_std**2)
    prior_std: float = 1.0        # std of the z noise fed to the decoder
    fresh_z_in_d: bool = False    # 3D: re-sample z with fresh eps in D-phase
    detach_expelbo_targets: bool = False  # 3D: detach rec/fake expELBO targets
    bootstrap: bool = False       # frozen target decoder: not in this port yet
    chamfer_impl: str = "auto"    # auto | plain | cuda (see ops/chamfer.py)


def _make_recon_fns(loss_type: str, chamfer_impl: str = "auto"):
    if loss_type == "chamfer":
        # the 3D trainer shifts both clouds by +0.5 before chamfer
        # (train_soft_intro_vae_3d.py:226,280); kept for numeric parity
        def per_sample(x, r):
            return chamfer_distance(r + 0.5, x + 0.5, chamfer_impl)

        def mean_fn(x, r):
            return per_sample(x, r).mean()
    else:
        def per_sample(x, r):
            return per_sample_recon(x, r, loss_type)

        def mean_fn(x, r):
            return reconstruction_loss(x, r, loss_type, "mean")

    return mean_fn, per_sample


def _trainable(module: nn.Module, flag: bool) -> None:
    for p in module.parameters():
        p.requires_grad_(flag)


def build_train_steps(*, cfg: StepConfig, decode_target: Optional[nn.Module] = None,
                      scan_steps: int = 1, input_lut=None) -> Tuple[StepFn, StepFn]:
    """Returns ``(vanilla_step, intro_step)``:
    ``step(state, x, noises=None) -> (state, metrics)``, with ``state``
    updated in place and ``metrics`` a dict of 0-dim tensors left on the device.

    ``noises`` overrides the step's random draws by name: ``eps`` for the
    vanilla step, ``INTRO_NOISES`` for the intro step (the JAX package's
    golden-value hook). Missing draws come from ``state.generator``.
    """
    if cfg.bootstrap or decode_target is not None:
        raise NotImplementedError("the bootstrap variant is not ported yet (ROADMAP.md Queue 1, item 7)")
    if input_lut is not None:
        raise NotImplementedError("uint8 input (input_lut) is not ported yet (ROADMAP.md Queue 1, item 5)")
    if scan_steps != 1:
        raise NotImplementedError("scan_steps > 1 (a K-step CUDA graph) is not ported yet "
                                  "(ROADMAP.md Queue 1, item 4)")
    recon_mean, recon_per_sample = _make_recon_fns(cfg.loss_type, cfg.chamfer_impl)
    kl_mean = partial(kl_divergence, logvar_o=cfg.prior_logvar, reduce="mean")
    kl_none = partial(kl_divergence, logvar_o=cfg.prior_logvar, reduce="none")

    def draw(state: TrainState, nv, name: str, b: int, scale: float = 1.0) -> Tensor:
        if name in nv:
            return torch.as_tensor(nv[name], dtype=torch.float32, device=state.device)
        return scale * torch.randn((b, cfg.z_dim), generator=state.generator,
                                   device=state.device, dtype=torch.float32)

    # ---------------- vanilla VAE warm-up step ----------------
    def vanilla_step(state: TrainState, x: Tensor, noises=None):
        enc, dec = state.encoder, state.decoder
        state.model.train()
        _trainable(enc, True)
        _trainable(dec, True)
        eps = draw(state, noises or {}, "eps", x.shape[0])
        mu, logvar = enc(x)
        rec = dec(reparameterize(mu, logvar, eps))
        loss_rec = recon_mean(x, rec)
        loss_kl = kl_mean(mu, logvar)
        loss = cfg.beta_rec * loss_rec + cfg.beta_kl * loss_kl  # unscaled (:527)
        state.opt_e.zero_grad(set_to_none=True)
        state.opt_d.zero_grad(set_to_none=True)
        loss.backward()
        state.opt_e.step()
        state.opt_d.step()
        state.step += 1
        return state, dict(loss=loss.detach(), rec=loss_rec.detach(), kl_real=loss_kl.detach())

    # ---------------- introspective two-phase step ----------------
    def intro_step(state: TrainState, x: Tensor, noises=None):
        enc, dec = state.encoder, state.decoder
        state.model.train()
        nv = noises or {}
        b = x.shape[0]
        noise = draw(state, nv, "noise", b, cfg.prior_std)
        eps_real, eps_e_rec, eps_e_fake, eps_d_z, eps_d_rec, eps_d_fake = (
            draw(state, nv, name, b) for name in INTRO_NOISES[1:])

        # ===================== E phase =====================
        _trainable(enc, True)
        _trainable(dec, False)
        fake = dec(noise)
        mu, logvar = enc(x)
        z = reparameterize(mu, logvar, eps_real)
        rec = dec(z)
        loss_rec = recon_mean(x, rec)
        kl_real = kl_mean(mu, logvar)

        # full forwards on detached decoder outputs (:567-568)
        rmu, rlv = enc(rec.detach())
        z_r = reparameterize(rmu, rlv, eps_e_rec)
        fmu, flv = enc(fake.detach())
        z_f = reparameterize(fmu, flv, eps_e_fake)
        rec_rec = dec(z_r)
        rec_fake = dec(z_f)

        tgt_rec = rec.detach() if cfg.detach_expelbo_targets else rec
        rr = recon_per_sample(tgt_rec, rec_rec)
        rf = recon_per_sample(fake, rec_fake)  # fake has no E-grad path
        expelbo_rec = exp_elbo(rr, kl_none(rmu, rlv), cfg.scale, cfg.beta_rec, cfg.beta_neg)
        expelbo_fake = exp_elbo(rf, kl_none(fmu, flv), cfg.scale, cfg.beta_rec, cfg.beta_neg)
        loss_e = cfg.scale * (cfg.beta_rec * loss_rec + cfg.beta_kl * kl_real) + 0.25 * (
            expelbo_rec + expelbo_fake)
        state.opt_e.zero_grad(set_to_none=True)
        loss_e.backward()
        state.opt_e.step()

        # ===================== D phase =====================
        # the UPDATED encoder (the reference steps optimizer_e first, :589)
        # and the same noise batch (:597)
        _trainable(enc, False)
        _trainable(dec, True)
        with torch.no_grad():
            if cfg.fresh_z_in_d:
                z_d = reparameterize(mu, logvar, eps_d_z)  # 3d:318-320
            else:
                z_d = z.detach()  # :598
        fake = dec(noise)
        rec = dec(z_d)
        loss_rec = recon_mean(x, rec)

        rmu, rlv = enc(rec)    # rec NOT detached
        z_rec = reparameterize(rmu, rlv, eps_d_rec)
        fmu, flv = enc(fake)   # fake NOT detached
        z_fake = reparameterize(fmu, flv, eps_d_fake)
        rec_rec = dec(z_rec.detach())   # :607-608
        rec_fake = dec(z_fake.detach())

        loss_rec_rec = recon_mean(rec.detach(), rec_rec)  # :610-613
        loss_fake_rec = recon_mean(fake.detach(), rec_fake)
        kl_rec = kl_mean(rmu, rlv)
        kl_fake = kl_mean(fmu, flv)
        loss_d = cfg.scale * (
            cfg.beta_rec * loss_rec
            + 0.5 * cfg.beta_kl * (kl_rec + kl_fake)
            + cfg.gamma_r * 0.5 * cfg.beta_rec * (loss_rec_rec + loss_fake_rec)
        )
        state.opt_d.zero_grad(set_to_none=True)
        loss_d.backward()
        state.opt_d.step()
        _trainable(enc, True)
        state.step += 1

        kl_real = kl_real.detach()
        kl_fake = kl_fake.detach()
        metrics = dict(
            loss_e=loss_e.detach(),
            loss_d=loss_d.detach(),
            rec=loss_rec.detach(),
            kl_real=kl_real,
            kl_rec=kl_rec.detach(),
            kl_fake=kl_fake,
            expelbo_r=expelbo_rec.detach(),
            expelbo_f=expelbo_fake.detach(),
            diff_kl=kl_fake - kl_real,
        )
        return state, metrics

    return vanilla_step, intro_step
