"""Plain float32 reference of the 3D point-cloud Soft-IntroVAE intro step.

A frozen copy of the step's mathematics, written from the published recipe
(soft_intro_vae_3d/train_soft_intro_vae_3d.py:268-354 with
config/soft_intro_vae_hp.json, Daniel & Tamar, CVPR 2021):

* the PointNet encoder (models/vae.py:104-141): five Conv1d(k=1, no bias)
  layers, each followed by ReLU and then BatchNorm1d (the published order),
  a max-pool over the points, FC 512 -> 256 + ReLU, and two heads for mu
  and logvar; the MLP decoder (vae.py:21-47): z -> 64 -> 128 -> 512 -> 1024
  with ReLUs, then a linear layer to 3 N outputs read as (B, 3, N);
* the chamfer loss (losses/chamfer_loss.py:5-35) in the published
  matrix-product form ``batch_pairwise_dist``: xx, yy and xy by three
  ``bmm``s, P = diag(xx) + diag(yy) - 2 xy, the sum of the minima over both
  directions; both clouds shifted by +0.5 first, as the trainer does
  (3d:226,280);
* the KL against the narrow prior N(0, prior_std^2) with logvar_o = log
  prior_std^2 (3d:178-180: ``calc_kl`` with ``mu_o`` 0), the fake draw
  z = prior_std * eps;
* the E phase with the expELBO targets detached (3d:293-299), the D phase
  on the updated encoder with z drawn again without gradients (3d:318-320),
  z_rec, z_fake and their targets detached;
* torch's Adam for each phase. BN runs in training mode: batch statistics,
  running buffers moved with momentum 0.1.

It imports nothing of the program and nothing of JAX. Names are the
checkpoint's (``encoder.conv.0.weight`` ...). The seven latent draws come
from ``Draws`` in the step's order.

Departures: the program searches the nearest points in the difference form
(dx^2 + dy^2) + dz^2; the published form here loses digits to cancellation
for near points (|x|^2 + |y|^2 is 0.75-3 after the shift, the squared
nearest distances 1e-4 to 1e-2). Measured on the CPU at (8, 2048, 2048),
clouds uniform in the unit cube against the same clouds moved by normal
noise, the per-sample loss against float64's: 2.4e-7 relative for clouds
apart (an independent cloud of std 0.1), 1.4e-6 at noise 0.1, 1.2e-5 at
noise 0.01 (the difference form: 0); 0 or 1 argmin of 32,768 differs from
the difference form's. The chamfer always runs in float32 with TF32 off, in
the controls too: the precision a control changes is the nets'.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.common import (
    Draws, PlainAdam, Precision, exp_elbo, float32_matmuls, grads_of)
from benchmark.reference.image_ref import BN, Linear, Pass

Tensor = torch.Tensor
ChamferHook = Optional[Callable[[str, Tuple[int, int, int]], None]]
DRAW_KEYS = ("noise", "eps_real", "eps_e_rec", "eps_e_fake", "eps_d_z", "eps_d_rec",
             "eps_d_fake")


class Conv1x1(nn.Module):
    """Conv1d with a kernel of one point and no bias (vae.py:106-125)."""

    def __init__(self, fin: int, fout: int):
        super().__init__()
        self.fan_in = fin
        self.weight = nn.Parameter(torch.empty(fout, fin, 1))
        self.bias = None

    def forward(self, x: Tensor, p: Precision) -> Tensor:
        return p.q(F.conv1d(p.cast(x), p.cast(self.weight)))


class Encoder(nn.Module):
    def __init__(self, zdim: int, channels: Sequence[int]):
        super().__init__()
        self.conv = nn.Sequential()
        cin = 3
        for ch in channels:
            for m in (Conv1x1(cin, ch), Pass(F.relu), BN(ch)):
                self.conv.add_module(str(len(self.conv)), m)
            cin = ch
        self.fc = nn.Sequential(Linear(cin, 256), Pass(F.relu))
        self.mu_layer = Linear(256, zdim)
        self.std_layer = Linear(256, zdim)

    def forward(self, x: Tensor, p: Precision) -> Tuple[Tensor, Tensor]:
        h = x.float().transpose(1, 2)           # (B, 3, N), Conv1d's layout
        for m in self.conv:
            h = m(h, p)
        h = torch.max(h, dim=2)[0]              # vae.py:141
        for m in self.fc:
            h = m(h, p)
        return self.mu_layer(h, p), self.std_layer(h, p)


class Decoder(nn.Module):
    def __init__(self, zdim: int, n_points: int, hidden: Sequence[int]):
        super().__init__()
        self.n_points = n_points
        self.model = nn.Sequential()
        cin = zdim
        for ch in hidden:
            for m in (Linear(cin, ch), Pass(F.relu)):
                self.model.add_module(str(len(self.model)), m)
            cin = ch
        self.model.add_module(str(len(self.model)), Linear(cin, 3 * n_points))

    def forward(self, z: Tensor, p: Precision) -> Tensor:
        y = z.float()
        for m in self.model:
            y = m(y, p)
        return y.view(-1, 3, self.n_points).transpose(1, 2)   # (B, N, 3)


class ThreeDNets(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        m = cfg["model"]
        self.encoder = Encoder(cfg["z_size"], tuple(m["conv_channels"]))
        self.decoder = Decoder(cfg["z_size"], cfg["n_points"], tuple(m["hidden"]))


def init_rules(nets: nn.Module) -> Dict[str, Tuple[str, float]]:
    """How PyTorch initialises each leaf, as ("randn", std) or ("const", v):
    conv and linear weights and biases with the variance of their default
    uniform draw, 1 / (3 fan_in); BN weights 1, biases 0; BN buffers at their
    initial values."""
    rules = {}
    for mname, mod in nets.named_modules():
        pre = f"{mname}." if mname else ""
        if isinstance(mod, (Conv1x1, Linear)):
            std = 1.0 / math.sqrt(3.0 * mod.fan_in)
            rules[pre + "weight"] = ("randn", std)
            if mod.bias is not None:
                rules[pre + "bias"] = ("randn", std)
        elif isinstance(mod, BN):
            rules.update({pre + "weight": ("const", 1.0), pre + "bias": ("const", 0.0),
                          pre + "running_mean": ("const", 0.0),
                          pre + "running_var": ("const", 1.0),
                          pre + "num_batches_tracked": ("const", 0.0)})
    return rules


# ---------------------------------------------------------------- losses --
def batch_pairwise_dist(x: Tensor, y: Tensor) -> Tensor:
    """(B, N, 3), (B, M, 3) -> (B, N, M) squared distances in the published
    matrix-product form (chamfer_loss.py:19-35)."""
    xx = torch.bmm(x, x.transpose(2, 1))
    yy = torch.bmm(y, y.transpose(2, 1))
    zz = torch.bmm(x, y.transpose(2, 1))
    rx = torch.diagonal(xx, dim1=1, dim2=2).unsqueeze(1).expand_as(zz.transpose(2, 1))
    ry = torch.diagonal(yy, dim1=1, dim2=2).unsqueeze(1).expand_as(zz)
    return rx.transpose(2, 1) + ry - 2 * zz


def chamfer(preds: Tensor, gts: Tensor) -> Tensor:
    """The published ChamferLoss (chamfer_loss.py:11-17), per sample (B,):
    the sum over ``preds`` of each one's least squared distance to ``gts``,
    plus the sum over ``gts`` of each one's least distance to ``preds``. TF32
    off whatever the caller's setting."""
    with float32_matmuls(tf32=False):
        p = batch_pairwise_dist(gts.float(), preds.float())
        return torch.min(p, 1)[0].sum(1) + torch.min(p, 2)[0].sum(1)


def kl_narrow(mu: Tensor, logvar: Tensor, logvar_o: float) -> Tensor:
    """KL(N(mu, e^logvar) || N(0, e^logvar_o)) per sample (B,), as the
    published ``calc_kl`` with mu_o = 0 writes it."""
    mu, logvar = mu.float(), logvar.float()
    var_o = math.exp(logvar_o)
    return -0.5 * (1.0 + logvar - logvar_o - logvar.exp() / var_o - mu.pow(2) / var_o).sum(1)


class ThreeDReference:
    """The 3D intro step at one batch size in float32. ``hook(kind, shape)``
    is told of each chamfer call: ("chamfer", (B, N, M))."""

    def __init__(self, cfg: dict, device, prec: Precision = Precision(),
                 hook: ChamferHook = None):
        self.prec = prec
        self.hook = hook
        self.device = torch.device(device)
        self.beta_rec, self.beta_kl, self.beta_neg = cfg["beta_rec"], cfg["beta_kl"], cfg["beta_neg"]
        self.gamma_r = cfg["gamma_r"]
        self.scale = 1.0 / (3 * cfg["n_points"])     # 3d:156
        self.prior_std = cfg["prior_std"]
        self.logvar_o = math.log(cfg["prior_std"] ** 2)
        self.z_dim = cfg["z_size"]
        opt = cfg["optimizer"]
        with torch.device(self.device):
            self.nets = ThreeDNets(cfg)
        self.opt_e = PlainAdam(list(self.nets.encoder.parameters()),
                               opt["E"]["hyperparams"]["lr"])
        self.opt_d = PlainAdam(list(self.nets.decoder.parameters()),
                               opt["D"]["hyperparams"]["lr"])

    def load(self, weights: Dict[str, Tensor]) -> None:
        own = dict(self.nets.named_parameters())
        own.update(self.nets.named_buffers())
        if set(own) != set(weights):
            raise ValueError(f"weights differ from the reference's leaves: "
                             f"{sorted(set(own) ^ set(weights))[:8]}")
        with torch.no_grad():
            for k, t in own.items():
                t.copy_(weights[k])

    def load_state(self, state: Dict[str, dict], steps: int) -> None:
        """Another side's state after ``steps`` steps, by name: ``leaves``
        (every parameter and buffer) and ``moments`` (each parameter's Adam m
        and v)."""
        self.load(state["leaves"])
        names = {id(t): n for n, t in self.nets.named_parameters()}
        for opt in (self.opt_e, self.opt_d):
            opt.load([names[id(p)] for p in opt.params], state["moments"], steps)

    def rec_loss(self, preds: Tensor, gts: Tensor) -> Tensor:
        """Chamfer per sample on the clouds shifted by +0.5 (3d:226,280)."""
        if self.hook is not None:
            self.hook("chamfer", (gts.shape[0], gts.shape[1], preds.shape[1]))
        return chamfer(preds + 0.5, gts + 0.5)

    def kl(self, mu: Tensor, logvar: Tensor) -> Tensor:
        return kl_narrow(mu, logvar, self.logvar_o)

    def step(self, x: Tensor, draws: Draws, encoder_after=None) -> Dict[str, object]:
        """One intro step on a (B, N, 3) float32 batch of clouds."""
        p = self.prec
        enc, dec = self.nets.encoder, self.nets.decoder
        x = x.float()
        b = x.shape[0]
        d = {k: draws.randn((b, self.z_dim)) for k in DRAW_KEYS}
        noise = self.prior_std * d["noise"]
        pe, pd = list(enc.parameters()), list(dec.parameters())

        # E phase (3d:268-309)
        fake = dec(noise, p)
        mu, logvar = enc(x, p)
        z = mu + d["eps_real"] * torch.exp(0.5 * logvar)
        rec = dec(z, p)
        loss_rec = self.rec_loss(rec, x).mean()
        kl_real = self.kl(mu, logvar).mean()
        rmu, rlv = enc(rec.detach(), p)
        fmu, flv = enc(fake.detach(), p)
        rec_rec = dec(rmu + d["eps_e_rec"] * torch.exp(0.5 * rlv), p)
        rec_fake = dec(fmu + d["eps_e_fake"] * torch.exp(0.5 * flv), p)
        expelbo_rec = exp_elbo(self.rec_loss(rec_rec, rec.detach()), self.kl(rmu, rlv),
                               self.scale, self.beta_rec, self.beta_neg)
        expelbo_fake = exp_elbo(self.rec_loss(rec_fake, fake.detach()), self.kl(fmu, flv),
                                self.scale, self.beta_rec, self.beta_neg)
        loss_e = (self.scale * (self.beta_rec * loss_rec + self.beta_kl * kl_real)
                  + 0.25 * (expelbo_rec + expelbo_fake))
        g_e = grads_of(loss_e, pe)
        self.opt_e.step(g_e)
        if encoder_after is not None:  # the D phase from another side's E update
            with torch.no_grad():
                for k, t in self.nets.named_parameters():
                    if k in encoder_after:
                        t.copy_(encoder_after[k])

        # D phase (3d:311-354): the updated encoder, z drawn again
        with torch.no_grad():
            z_d = mu + d["eps_d_z"] * torch.exp(0.5 * logvar)
        fake = dec(noise, p)
        rec = dec(z_d, p)
        loss_rec = self.rec_loss(rec, x).mean()
        rmu, rlv = enc(rec, p)
        fmu, flv = enc(fake, p)
        z_rec = rmu + d["eps_d_rec"] * torch.exp(0.5 * rlv)
        z_fake = fmu + d["eps_d_fake"] * torch.exp(0.5 * flv)
        rec_rec = dec(z_rec.detach(), p)
        rec_fake = dec(z_fake.detach(), p)
        lrr = self.rec_loss(rec_rec, rec.detach()).mean()
        lfr = self.rec_loss(rec_fake, fake.detach()).mean()
        kl_rec = self.kl(rmu, rlv).mean()
        kl_fake = self.kl(fmu, flv).mean()
        loss_d = self.scale * (self.beta_rec * loss_rec + 0.5 * self.beta_kl * (kl_rec + kl_fake)
                               + self.gamma_r * 0.5 * self.beta_rec * (lrr + lfr))
        g_d = grads_of(loss_d, pd)
        self.opt_d.step(g_d)

        names = {id(t): n for n, t in self.nets.named_parameters()}
        grads = {names[id(t)]: g for t, g in zip(pe + pd, g_e + g_d)}
        return {"loss_e": loss_e.detach(), "loss_d": loss_d.detach(), "kl": kl_real.detach(),
                "grads": grads}
