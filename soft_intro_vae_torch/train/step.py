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

Bootstrap (soft_intro_vae_bootstrap/train_soft_intro_vae_bootstrap.py, the
JAX package's train/step.py:184-194,264-269,321-329): the vanilla
reconstruction and the E-phase's two extra decodes go through the frozen
target decoder (``state.target_decoder``); so do the D-phase's extra decodes,
with z_rec/z_fake and the recon targets NOT detached (:635-636). In the
bootstrap vanilla step the online decoder takes no gradient; the JAX step
still feeds its Adam zero gradients (optax's count is global, so the bias
correction advances and the moments decay), and so does the port: a
parameter whose ``.grad`` is None would be skipped by ``torch.optim.Adam``.

BatchNorm: every forward runs in train mode and updates the running
statistics, in reference order: x, rec.detach(), fake.detach() in the E-phase,
then rec and fake in the D-phase; the target decoder's on each of its decodes.

Image batches come as the JAX step takes them, NHWC (``nhwc=True``): a uint8
batch is normalized through ``input_lut`` (the canonical unit table selects
the CUDA kernel of ops/u8norm.py), a float batch is taken as it is; either
reaches the nets as the (B, C, H, W) view of its NHWC memory, channels-last,
the layout the image nets run in (models/conv.py).

Data parallelism (parallel/mesh.py): in a process group a step takes this
rank's rows of the global batch. Its draws are this rank's rows of draws for
the global batch (injected ``noises`` are global too), each phase's
gradients are all-reduced once between ``backward()`` and the optimizer's
step, the nets' BatchNorms take global statistics, and the metrics are the
global means. Without a process group none of this runs.

``remat=True`` (the JAX package's ``make_model_fns(remat=True)``, there for
the image trainer) runs every encoder, decoder and target-decoder forward
under activation checkpointing (models/remat.py): the backward recomputes
the activations it needs. BN buffers and metrics are those of the plain step.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Dict, Tuple

import numpy as np
import torch
import torch.nn as nn

from soft_intro_vae_torch.models.remat import maybe_checkpoint
from soft_intro_vae_torch.ops.chamfer import chamfer_distance
from soft_intro_vae_torch.ops.losses import (
    exp_elbo,
    kl_divergence,
    per_sample_recon,
    reconstruction_loss,
    reparameterize,
)
from soft_intro_vae_torch.ops.u8norm import u8_to_unit_nchw
from soft_intro_vae_torch.parallel.collectives import GradReducer, all_reduce_metrics
from soft_intro_vae_torch.parallel.mesh import local_rows, randn_rows
from soft_intro_vae_torch.train.graph import k_steps, one_step
from soft_intro_vae_torch.train.state import TrainState

Tensor = torch.Tensor
Metrics = Dict[str, Tensor]
StepFn = Callable[..., Tuple[TrainState, Metrics]]

INTRO_NOISES = ("noise", "eps_real", "eps_e_rec", "eps_e_fake", "eps_d_z", "eps_d_rec", "eps_d_fake")
# the canonical table: every byte's host value, x.astype(float32) / float32(255)
UNIT_LUT = np.arange(256, dtype=np.uint8).astype(np.float32) / np.float32(255)


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
    bootstrap: bool = False       # decodes through state.target_decoder (module doc)
    chamfer_impl: str = "auto"    # auto | plain | cuda (see ops/chamfer.py)
    u8norm_impl: str = "auto"     # auto | plain | cuda (see ops/u8norm.py)


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


def _channels_last(x: Tensor) -> Tensor:
    """(B, H, W, C) -> its (B, C, H, W) view, channels-last in memory: no copy
    when ``x`` is contiguous."""
    return x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _input_fn(input_lut, nhwc: bool, u8norm_impl: str = "auto") -> Callable[[Tensor], Tensor]:
    """The step's batch -> the nets' input (the JAX step's ``_norm``): NHWC
    images as (B, C, H, W) tensors, channels-last in memory like the nets."""
    lut = canonical = None
    if input_lut is not None:
        lut = np.asarray(input_lut, np.float32)
        if lut.shape != (256,):
            raise ValueError(f"input_lut must have shape (256,), got {lut.shape}")
        canonical = np.array_equal(lut, UNIT_LUT)
    tables: Dict[torch.device, Tensor] = {}

    def prepare(x: Tensor) -> Tensor:
        if x.dtype == torch.uint8:
            if lut is None:
                raise ValueError("a uint8 batch needs input_lut (e.g. arange(256)/255); without "
                                 "it the step would train on 0..255 pixels")
            if not nhwc:
                raise ValueError("uint8 batches are NHWC images: build the step with nhwc=True")
            if canonical:
                return u8_to_unit_nchw(x, u8norm_impl)  # the kernel on the card, one launch
            if x.device not in tables:
                tables[x.device] = torch.from_numpy(lut).to(x.device)
            return _channels_last(tables[x.device][x.long()])
        if nhwc:
            return _channels_last(x.float())
        return x

    return prepare


def build_train_steps(*, cfg: StepConfig, scan_steps: int = 1, input_lut=None,
                      nhwc: bool = False, remat: bool = False) -> Tuple[StepFn, StepFn]:
    """Returns ``(vanilla_step, intro_step)``:
    ``step(state, x, noises=None) -> (state, metrics)``, with ``state``
    updated in place and ``metrics`` a dict of 0-dim tensors left on the device.

    ``noises`` overrides the step's random draws by name: ``eps`` for the
    vanilla step, ``INTRO_NOISES`` for the intro step (the JAX package's
    golden-value hook). Missing draws come from ``state.generator``.

    ``nhwc=True``: ``x`` is a (B, H, W, C) image batch, uint8 or float. A
    uint8 batch needs ``input_lut``, a 256-entry table: the canonical
    ``UNIT_LUT`` runs ops/u8norm.py (the CUDA kernel on the card), any other
    table is looked up; without a table a uint8 batch raises.
    ``cfg.bootstrap`` needs a state with a ``target_decoder``.

    With ``scan_steps == 1`` each step is ``train/graph.py one_step`` of
    the eager step, the counterpart of the JAX package's jitted step: on the
    card a CUDA graph replayed once a call, one capture per batch shape and
    set of injected draws, and a failed capture raises; eager on the CPU and
    under gloo. ``.eager`` is the eager step itself. With ``scan_steps > 1``
    the signature becomes ``step(state, xs: (K, B, ...)) -> (state,
    metrics: (K,) each)``, as the JAX scan's: K steps a call, each a call of
    the one-step wrapper (``train/graph.py k_steps``).

    ``remat=True`` checkpoints each subnet forward (module doc); a graph
    then captures the recomputes inside its backward.
    """
    if scan_steps < 1:
        raise ValueError(f"scan_steps must be >= 1, got {scan_steps}")
    recon_mean, recon_per_sample = _make_recon_fns(cfg.loss_type, cfg.chamfer_impl)
    kl_mean = partial(kl_divergence, logvar_o=cfg.prior_logvar, reduce="mean")
    kl_none = partial(kl_divergence, logvar_o=cfg.prior_logvar, reduce="none")
    prepare = _input_fn(input_lut, nhwc, cfg.u8norm_impl)
    run = maybe_checkpoint(remat)  # run(net, input): the net's forward

    def target_of(state: TrainState) -> nn.Module:
        if state.target_decoder is None:
            raise ValueError("bootstrap=True needs a model with a target_decoder")
        return state.target_decoder

    reduce_grads = GradReducer()

    def draw(state: TrainState, nv, name: str, b: int, scale: float = 1.0) -> Tensor:
        if name in nv:
            return local_rows(torch.as_tensor(nv[name], dtype=torch.float32, device=state.device), b)
        return scale * randn_rows(b, (cfg.z_dim,), generator=state.generator, device=state.device)

    # ---------------- vanilla VAE warm-up step ----------------
    def vanilla_step(state: TrainState, x: Tensor, noises=None):
        enc, dec = state.encoder, state.decoder
        x = prepare(x)
        state.model.train()
        _trainable(enc, True)
        _trainable(dec, True)
        eps = draw(state, noises or {}, "eps", x.shape[0])
        mu, logvar = run(enc, x)
        # bootstrap: the target decoder reconstructs (the reference model's
        # forward with target=True)
        rec = run(target_of(state) if cfg.bootstrap else dec, reparameterize(mu, logvar, eps))
        loss_rec = recon_mean(x, rec)
        loss_kl = kl_mean(mu, logvar)
        loss = cfg.beta_rec * loss_rec + cfg.beta_kl * loss_kl  # unscaled (:527)
        state.opt_e.zero_grad(set_to_none=True)
        state.opt_d.zero_grad(set_to_none=True)
        loss.backward()
        reduce_grads(list(enc.parameters()) + list(dec.parameters()))
        if cfg.bootstrap:
            for p in dec.parameters():  # zero gradients, as the JAX step feeds optax
                p.grad = torch.zeros_like(p)
        state.opt_e.step()
        state.opt_d.step()
        state.step += 1
        return state, all_reduce_metrics(
            dict(loss=loss.detach(), rec=loss_rec.detach(), kl_real=loss_kl.detach()))

    # ---------------- introspective two-phase step ----------------
    def intro_step(state: TrainState, x: Tensor, noises=None):
        enc, dec = state.encoder, state.decoder
        dec_x = target_of(state) if cfg.bootstrap else dec  # the extra decodes' decoder
        x = prepare(x)
        state.model.train()
        nv = noises or {}
        b = x.shape[0]
        noise = draw(state, nv, "noise", b, cfg.prior_std)
        eps_real, eps_e_rec, eps_e_fake, eps_d_z, eps_d_rec, eps_d_fake = (
            draw(state, nv, name, b) for name in INTRO_NOISES[1:])

        # ===================== E phase =====================
        _trainable(enc, True)
        _trainable(dec, False)
        fake = run(dec, noise)  # nothing needs a gradient: never recomputed
        mu, logvar = run(enc, x)
        z = reparameterize(mu, logvar, eps_real)
        rec = run(dec, z)
        loss_rec = recon_mean(x, rec)
        kl_real = kl_mean(mu, logvar)

        # full forwards on detached decoder outputs (:567-568)
        rmu, rlv = run(enc, rec.detach())
        z_r = reparameterize(rmu, rlv, eps_e_rec)
        fmu, flv = run(enc, fake.detach())
        z_f = reparameterize(fmu, flv, eps_e_fake)
        rec_rec = run(dec_x, z_r)
        rec_fake = run(dec_x, z_f)

        tgt_rec = rec.detach() if cfg.detach_expelbo_targets else rec
        rr = recon_per_sample(tgt_rec, rec_rec)
        rf = recon_per_sample(fake, rec_fake)  # fake has no E-grad path
        expelbo_rec = exp_elbo(rr, kl_none(rmu, rlv), cfg.scale, cfg.beta_rec, cfg.beta_neg)
        expelbo_fake = exp_elbo(rf, kl_none(fmu, flv), cfg.scale, cfg.beta_rec, cfg.beta_neg)
        loss_e = cfg.scale * (cfg.beta_rec * loss_rec + cfg.beta_kl * kl_real) + 0.25 * (
            expelbo_rec + expelbo_fake)
        state.opt_e.zero_grad(set_to_none=True)
        loss_e.backward()
        reduce_grads(enc.parameters())
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
        fake = run(dec, noise)
        rec = run(dec, z_d)
        loss_rec = recon_mean(x, rec)

        rmu, rlv = run(enc, rec)    # rec NOT detached
        z_rec = reparameterize(rmu, rlv, eps_d_rec)
        fmu, flv = run(enc, fake)   # fake NOT detached
        z_fake = reparameterize(fmu, flv, eps_d_fake)
        if cfg.bootstrap:
            # the target decoder, z and the targets NOT detached (bootstrap:635-636)
            rec_rec, rec_fake = run(dec_x, z_rec), run(dec_x, z_fake)
            tgt_r, tgt_f = rec, fake
        else:
            rec_rec = run(dec, z_rec.detach())   # :607-608
            rec_fake = run(dec, z_fake.detach())
            tgt_r, tgt_f = rec.detach(), fake.detach()  # :610-613
        loss_rec_rec = recon_mean(tgt_r, rec_rec)
        loss_fake_rec = recon_mean(tgt_f, rec_fake)
        kl_rec = kl_mean(rmu, rlv)
        kl_fake = kl_mean(fmu, flv)
        loss_d = cfg.scale * (
            cfg.beta_rec * loss_rec
            + 0.5 * cfg.beta_kl * (kl_rec + kl_fake)
            + cfg.gamma_r * 0.5 * cfg.beta_rec * (loss_rec_rec + loss_fake_rec)
        )
        state.opt_d.zero_grad(set_to_none=True)
        loss_d.backward()
        reduce_grads(dec.parameters())
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
        return state, all_reduce_metrics(metrics)

    wrap = k_steps if scan_steps > 1 else one_step
    return wrap(vanilla_step), wrap(intro_step)
