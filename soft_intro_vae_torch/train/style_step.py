"""Style-SoftIntroVAE model ops and train steps (port of train/style_step.py).

Reference style_soft_intro_vae/model.py (SoftIntroVAEModelTL): generate
(style mixing, truncation, dlatent_avg tracking, :159-206), encode through
mapping_tl (:208-213), and the loss-computing forward's three branches (E
:215-263, D :265-299, vanilla :300-318) with every detach point of the JAX
package's ``sg`` calls.

PyTorch runs eagerly: a step is the reference's sequence of forwards and
LREQAdam updates, with ``requires_grad`` toggled per phase (the E phase
leaves no gradient on the decoder and mapping_fl, the D phase none on the
encoder and mapping_tl). The state is updated in place; the EMA twin of the
nets (parameters and the dlatent_avg buffer) follows every step.

Random draws come from ``state.generator``: the prior and reparameterisation
noise (fresh prior noise per phase, as each reference ``generate`` samples its
own z), style mixing, and the decoder's noise planes. A step's ``nz`` dict
injects the latent draws by name instead (``NZ_KEYS``), as the JAX step's
``nz`` hook does.

``StyleModelConfig.remat`` (TRAIN.REMAT) checkpoints two parts of every
forward, as the JAX package does (train/style_step.py:109-125,160-168): the
encoder with mapping_tl, and the decoder (models/remat.py). The decoder's
recompute draws its noise planes again from ``state.generator``'s state at
the forward, and leaves the generator where the forward left it, so a remat
step is the plain step bit for bit.

Data parallelism (parallel/mesh.py): in a process group every per-sample
draw (latents, the mixing latents, the decoder's noise planes) is this
rank's rows of a draw for the global batch, injected ``nz`` arrays are
global, each phase's gradients are all-reduced once before its optimizer
step, dlatent_avg follows the global style mean and the metrics are global
means. Without a process group none of this runs.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch
import torch.nn as nn

from soft_intro_vae_torch.models.remat import maybe_checkpoint
from soft_intro_vae_torch.models.style import (
    MappingFromLatent,
    MappingToLatent,
    StyleEncoder,
    StyleGenerator,
)
from soft_intro_vae_torch.ops.losses import (
    exp_elbo,
    kl_divergence,
    per_sample_recon,
    reconstruction_loss,
)
from soft_intro_vae_torch.parallel.collectives import (
    GradReducer,
    all_reduce_metrics,
    global_mean,
)
from soft_intro_vae_torch.parallel.mesh import local_rows, randn_rows
from soft_intro_vae_torch.train.lreq_adam import LreqAdam

Tensor = torch.Tensor
Metrics = Dict[str, Tensor]
StepFn = Callable[..., Tuple["StyleTrainState", Metrics]]

NZ_KEYS = ("eps_real", "eps_e_rec", "eps_e_fake", "eps_d_rec", "eps_d_fake", "noise", "noise_d")
ENCODER_VARIANTS = ("EncoderDefault", "EncoderWithStatistics", "EncoderWithFC")
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class StyleModelConfig:
    startf: int = 32
    maxf: int = 256
    layer_count: int = 6
    latent_size: int = 256
    mapping_layers: int = 5
    channels: int = 3
    dlatent_avg_beta: Optional[float] = 0.995
    style_mixing_prob: Optional[float] = 0.9
    truncation_psi: Optional[float] = 0.7
    truncation_cutoff: int = 8
    encoder_variant: str = "EncoderDefault"  # MODEL.ENCODER (defaults.py:60)
    # conv-path activation type; IN statistics, style heads and losses stay f32
    compute_dtype: str = "float32"
    # the fused norm's route: auto (the CUDA kernels for CUDA tensors) | plain
    # (the PyTorch version, for comparing the two on the card) | cuda
    norm_impl: str = "auto"
    # TRAIN.REMAT: checkpoint encoder + mapping_tl and the decoder (module doc)
    remat: bool = False


class DLatent(nn.Module):
    """The reference's dlatent_avg holder (model.py:24-28): one buffer ``buff``."""

    def __init__(self, num_layers: int, latent_size: int):
        super().__init__()
        self.register_buffer("buff", torch.zeros(num_layers, latent_size))


class StyleNets(nn.Module):
    """The four subnets and the dlatent_avg buffer, in the reference's names."""

    def __init__(self, encoder: StyleEncoder, decoder: StyleGenerator,
                 mapping_tl: MappingToLatent, mapping_fl: MappingFromLatent, dlatent_avg: DLatent):
        super().__init__()
        self.encoder = encoder
        self.decoder = decoder
        self.mapping_tl = mapping_tl
        self.mapping_fl = mapping_fl
        self.dlatent_avg = dlatent_avg

    def params_e(self) -> list:
        return list(self.encoder.parameters()) + list(self.mapping_tl.parameters())

    def params_d(self) -> list:
        return list(self.decoder.parameters()) + list(self.mapping_fl.parameters())


class StyleModel:
    """Builds the nets of a config and runs the model ops on a ``StyleNets``."""

    def __init__(self, mc: StyleModelConfig):
        if mc.encoder_variant not in ENCODER_VARIANTS:
            raise ValueError(f"unknown MODEL.ENCODER {mc.encoder_variant!r}")
        if mc.compute_dtype not in _DTYPES:
            raise ValueError(f"unknown compute dtype {mc.compute_dtype!r}")
        self.mc = mc
        self.num_layers = 2 * mc.layer_count
        self.layer_to_resolution = [2 ** (i + 2) for i in range(mc.layer_count)]
        self._run = maybe_checkpoint(mc.remat)

    def make_nets(self) -> StyleNets:
        """Fresh nets on the CPU, drawn from the global torch RNG."""
        mc = self.mc
        kw = dict(startf=mc.startf, maxf=mc.maxf, layer_count=mc.layer_count,
                  latent_size=mc.latent_size, channels=mc.channels,
                  dtype=_DTYPES[mc.compute_dtype], norm_impl=mc.norm_impl)
        lat = mc.latent_size
        encoder = StyleEncoder(with_fc_head=mc.encoder_variant == "EncoderWithFC",
                               last_block_dense=mc.encoder_variant == "EncoderWithStatistics",
                               **kw)
        return StyleNets(
            encoder, StyleGenerator(**kw),
            MappingToLatent(latent_size=lat, dlatent_size=lat, mapping_fmaps=lat, mapping_layers=3),
            MappingFromLatent(num_layers=self.num_layers, latent_size=lat, dlatent_size=lat,
                              mapping_fmaps=lat, mapping_layers=mc.mapping_layers),
            DLatent(self.num_layers, lat))

    def encode(self, nets: StyleNets, x: Tensor, lod: int, blend: Optional[float],
               eps: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
        """(z, mu, logvar) — model.py:208-213. EncoderWithFC's fc2 logit is
        dropped: only the styles feed mapping_tl (JAX train/style_step.py:109-118)."""

        def fwd(x):
            styles = nets.encoder(x, lod, blend)
            if isinstance(styles, tuple):
                styles = styles[0]
            return nets.mapping_tl(styles)

        y = self._run(fwd, x)
        mu, logvar = y[:, 0, :], y[:, 1, :]
        return mu + eps * torch.exp(0.5 * logvar), mu, logvar

    def generate(self, nets: StyleNets, generator: torch.Generator, lod: int,
                 blend: Optional[float], z: Tensor, *, mixing: bool, truncation: bool = False,
                 noise_mode: str = "batch", update_avg: bool = True) -> Tensor:
        """The decoded image (B, C, H, W) f32 — model.py:159-206. Updates the
        dlatent_avg buffer in place with the style batch mean."""
        mc = self.mc
        dev = z.device
        styles = nets.mapping_fl(z)[:, :1].expand(-1, self.num_layers, -1)
        avg = nets.dlatent_avg.buff
        if mc.dlatent_avg_beta is not None and update_avg:
            with torch.no_grad():
                avg.add_((global_mean(styles.mean(dim=0)) - avg) * (1.0 - mc.dlatent_avg_beta))
        layer_idx = torch.arange(self.num_layers, device=dev)[None, :, None]
        if mixing and mc.style_mixing_prob is not None:
            z2 = randn_rows(z.shape[0], z.shape[1:], generator=generator, device=dev)
            styles2 = nets.mapping_fl(z2)[:, :1].expand(-1, self.num_layers, -1)
            cur_layers = (lod + 1) * 2
            cutoff = torch.randint(1, cur_layers + 1, (), generator=generator, device=dev)
            mixed = torch.where(layer_idx < cutoff, styles, styles2)
            do_mix = torch.rand((), generator=generator, device=dev) < mc.style_mixing_prob
            styles = torch.where(do_mix, mixed, styles)
        if truncation and mc.truncation_psi is not None:
            coefs = torch.where(layer_idx < mc.truncation_cutoff, mc.truncation_psi, 1.0)
            styles = avg[None] + (styles - avg[None]) * coefs
        return self._run(nets.decoder, styles, lod, blend, noise_mode, generator,
                         generator=generator)


@dataclasses.dataclass(frozen=True)
class StyleStepConfig:
    latent_size: int
    beta_rec: float = 1.0
    beta_kl: float = 1.0
    beta_neg: float = 256.0
    gamma_r: float = 1e-8
    scale: float = 1.0 / (3 * 256**2)


@torch.no_grad()
def ema_update(ema: nn.Module, online: nn.Module, beta: float) -> None:
    """e <- e + (p - e) * (1 - beta) over parameters and buffers (:333-340)."""
    e_params, o_params = list(ema.parameters()), list(online.parameters())
    torch._foreach_lerp_(e_params, o_params, 1.0 - beta)
    for e, o in zip(ema.buffers(), online.buffers()):
        e.add_((o - e) * (1.0 - beta))


@dataclasses.dataclass
class StyleTrainState:
    nets: StyleNets       # online nets
    ema: StyleNets        # EMA twin (the reference's *_s models)
    opt_e: LreqAdam       # encoder + mapping_tl
    opt_d: LreqAdam       # decoder + mapping_fl
    generator: torch.Generator  # on ``device``; all of the steps' random draws
    device: torch.device
    step: int = 0
    lr: float = 0.0015
    ema_beta: float = 0.5 ** (32 / 10000.0)  # "betta" = 0.5 ** (batch / 10000) (:400)

    @classmethod
    def create(cls, nets: StyleNets, *, device: torch.device, seed: int, lr: float,
               beta2: float = 0.99, ema_beta: float = 0.5 ** (32 / 10000.0)
               ) -> "StyleTrainState":
        nets = nets.to(device)
        ema = copy.deepcopy(nets).requires_grad_(False)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        return cls(nets=nets, ema=ema, opt_e=LreqAdam(nets.params_e(), lr, beta2),
                   opt_d=LreqAdam(nets.params_d(), lr, beta2), generator=gen, device=device,
                   lr=lr, ema_beta=ema_beta)

    def set_lr(self, lr: float) -> None:
        self.lr = self.opt_e.lr = self.opt_d.lr = float(lr)

    def reset_optimizers(self) -> None:
        self.opt_e.reset()
        self.opt_d.reset()

    def state_dict(self) -> dict:
        return {"nets": self.nets.state_dict(), "ema": self.ema.state_dict(),
                "opt_e": self.opt_e.state_dict(), "opt_d": self.opt_d.state_dict(),
                "step": self.step, "lr": self.lr, "ema_beta": self.ema_beta,
                "rng": self.generator.get_state()}

    def load_state_dict(self, sd: dict) -> None:
        self.nets.load_state_dict(sd["nets"])
        self.ema.load_state_dict(sd["ema"])
        self.opt_e.load_state_dict(sd["opt_e"])
        self.opt_d.load_state_dict(sd["opt_d"])
        self.generator.set_state(sd["rng"])
        self.step = int(sd["step"])
        self.set_lr(float(sd["lr"]))
        self.ema_beta = float(sd["ema_beta"])


def _trainable(params: Iterable[nn.Parameter], flag: bool) -> None:
    for p in params:
        p.requires_grad_(flag)


def build_style_steps(model: StyleModel, cfg: StyleStepConfig, lod: int, blended: bool,
                      noise_mode: str = "batch") -> Tuple[StepFn, StepFn]:
    """(vanilla_step, intro_step) for one (lod, in_transition) pair.

    ``step(state, x, blend=1.0, nz=None) -> (state, metrics)``: x is the NCHW
    f32 batch on the state's device; ``blend`` is read only when ``blended``;
    metrics are 0-dim tensors left on the device. ``noise_mode`` selects the
    decoder noise ("batch": fresh planes per call, the reference trainer's
    noise=True; "none": the deterministic correction, net.py:176-178).
    """

    reduce_grads = GradReducer()

    def _b(blend):
        return float(blend) if blended else None

    def latents(state: StyleTrainState, nz, names, b: int):
        if nz is not None:
            return [local_rows(torch.as_tensor(nz[k], dtype=torch.float32, device=state.device), b)
                    for k in names]
        return [randn_rows(b, (cfg.latent_size,), generator=state.generator, device=state.device)
                for _ in names]

    def generate(state, z, blend, mixing):
        return model.generate(state.nets, state.generator, lod, _b(blend), z, mixing=mixing,
                              noise_mode=noise_mode)

    def encode(state, x, blend, eps):
        return model.encode(state.nets, x, lod, _b(blend), eps)

    def vanilla_step(state: StyleTrainState, x: Tensor, blend: float = 1.0, nz=None):
        (eps,) = latents(state, nz, ("eps_real",), x.shape[0])
        nets = state.nets
        _trainable(nets.parameters(), True)
        z, mu, logvar = encode(state, x, blend, eps)
        rec = generate(state, z, blend, mixing=False)
        loss_rec = reconstruction_loss(x, rec, "mse", "mean")
        loss_kl = kl_divergence(mu, logvar, reduce="mean")
        loss = cfg.beta_rec * loss_rec + cfg.beta_kl * loss_kl  # unscaled (:317)
        state.opt_e.zero_grad()
        state.opt_d.zero_grad()
        loss.backward()
        reduce_grads(nets.parameters())
        state.opt_e.step()
        state.opt_d.step()
        _finish(state)
        loss = loss.detach()
        return state, all_reduce_metrics(dict(loss_e=loss, loss_d=loss, rec_loss=loss_rec.detach(),
                                              real_kl=loss_kl.detach()))

    def intro_step(state: StyleTrainState, x: Tensor, blend: float = 1.0, nz=None):
        nets = state.nets
        eps_real, eps_e_rec, eps_e_fake, eps_d_rec, eps_d_fake, z_noise, z_noise_d = latents(
            state, nz, NZ_KEYS, x.shape[0])

        # ===== E phase (model.py:215-263) =====
        _trainable(nets.params_e(), True)
        _trainable(nets.params_d(), False)
        fake = generate(state, z_noise, blend, mixing=True)
        z_real, mu, logvar = encode(state, x, blend, eps_real)
        rec = generate(state, z_real, blend, mixing=False)
        loss_rec = reconstruction_loss(x, rec, "mse", "mean")
        kl_real = kl_divergence(mu, logvar, reduce="mean")
        z_rec, rmu, rlv = encode(state, rec.detach(), blend, eps_e_rec)
        rec_rec = generate(state, z_rec, blend, mixing=False)
        z_fake, fmu, flv = encode(state, fake.detach(), blend, eps_e_fake)
        rec_fake = generate(state, z_fake, blend, mixing=False)
        rr = per_sample_recon(rec, rec_rec, "mse")  # rec NOT detached (:244)
        rf = per_sample_recon(fake, rec_fake, "mse")
        expelbo_rec = exp_elbo(rr, kl_divergence(rmu, rlv, reduce="none"), cfg.scale,
                               cfg.beta_rec, cfg.beta_neg)
        expelbo_fake = exp_elbo(rf, kl_divergence(fmu, flv, reduce="none"), cfg.scale,
                                cfg.beta_rec, cfg.beta_neg)
        loss_e = (cfg.scale * (cfg.beta_rec * loss_rec + cfg.beta_kl * kl_real)
                  + 0.25 * (expelbo_rec + expelbo_fake))
        state.opt_e.zero_grad()
        loss_e.backward()
        reduce_grads(nets.params_e())
        state.opt_e.step()

        # ===== D phase (model.py:265-299): the updated encoder, fresh forwards =====
        _trainable(nets.params_e(), False)
        _trainable(nets.params_d(), True)
        fake = generate(state, z_noise_d, blend, mixing=True)
        rec = generate(state, z_real.detach(), blend, mixing=False)
        loss_rec = reconstruction_loss(x, rec, "mse", "mean")
        z_rec, rmu, rlv = encode(state, rec, blend, eps_d_rec)
        z_fake, fmu, flv = encode(state, fake, blend, eps_d_fake)
        rec_rec = generate(state, z_rec.detach(), blend, mixing=False)
        rec_fake = generate(state, z_fake.detach(), blend, mixing=False)
        loss_rec_rec = reconstruction_loss(rec.detach(), rec_rec, "mse", "mean")
        loss_fake_rec = reconstruction_loss(fake.detach(), rec_fake, "mse", "mean")
        kl_rec = kl_divergence(rmu, rlv, reduce="mean")
        kl_fake = kl_divergence(fmu, flv, reduce="mean")
        loss_d = cfg.scale * (cfg.beta_rec * loss_rec
                              + 0.5 * cfg.beta_kl * (kl_rec + kl_fake)
                              + cfg.gamma_r * 0.5 * cfg.beta_rec * (loss_rec_rec + loss_fake_rec))
        state.opt_d.zero_grad()
        loss_d.backward()
        reduce_grads(nets.params_d())
        state.opt_d.step()
        _trainable(nets.params_e(), True)
        _finish(state)

        kl_real, kl_fake = kl_real.detach(), kl_fake.detach()
        return state, all_reduce_metrics(dict(
            loss_e=loss_e.detach(), loss_d=loss_d.detach(), rec_loss=loss_rec.detach(),
            real_kl=kl_real, fake_kl=kl_fake, kl_diff=kl_fake - kl_real,
            expelbo_r=expelbo_rec.detach(), expelbo_f=expelbo_fake.detach()))

    def _finish(state: StyleTrainState) -> None:
        ema_update(state.ema, state.nets, state.ema_beta)
        state.step += 1

    return vanilla_step, intro_step
