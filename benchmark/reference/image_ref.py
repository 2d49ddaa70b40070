"""Plain float32 reference of the Soft-IntroVAE image intro step.

A frozen copy of the step's mathematics, written from the published
CIFAR-10 recipe (soft_intro_vae/train_soft_intro_vae.py, Daniel & Tamar,
CVPR 2021): the ResNet encoder (5x5 stem, BN, leaky ReLU, average pooling,
residual blocks with BN before the add) and decoder (FC + ReLU, residual
blocks, nearest upsampling, a 5x5 head), the reparameterisation, the E and
D phases' losses with the reference's detach points, and torch's Adam for
each phase. BN runs in training mode: batch statistics, running buffers
moved with momentum 0.1. It imports nothing of the program and nothing of
JAX. Names are the checkpoint's (``encoder.main.0.weight`` ...).

The seven latent draws come from ``Draws`` in the step's order.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.common import (
    Draws, PlainAdam, Precision, exp_elbo, grads_of, kl_per_sample, leaky, sq_err_per_sample)

Tensor = torch.Tensor
DRAW_KEYS = ("noise", "eps_real", "eps_e_rec", "eps_e_fake", "eps_d_z", "eps_d_rec",
             "eps_d_fake")


class Conv(nn.Module):
    def __init__(self, fin: int, fout: int, k: int, bias: bool):
        super().__init__()
        self.pad = k // 2
        self.fan_in = fin * k * k
        self.weight = nn.Parameter(torch.empty(fout, fin, k, k))
        self.bias = nn.Parameter(torch.empty(fout)) if bias else None

    def forward(self, x: Tensor, p: Precision) -> Tensor:
        b = None if self.bias is None else p.cast(self.bias)
        return p.q(F.conv2d(p.cast(x), p.cast(self.weight), b, padding=self.pad))


class Linear(nn.Module):
    def __init__(self, fin: int, fout: int):
        super().__init__()
        self.fan_in = fin
        self.weight = nn.Parameter(torch.empty(fout, fin))
        self.bias = nn.Parameter(torch.empty(fout))

    def forward(self, x: Tensor, p: Precision) -> Tensor:
        return p.q(F.linear(p.q(x), p.q(self.weight), p.q(self.bias)))


class BN(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.register_buffer("num_batches_tracked", torch.zeros((), dtype=torch.long))

    def forward(self, x: Tensor, p: Precision) -> Tensor:
        with torch.no_grad():
            self.num_batches_tracked.add_(1)
        return p.q(F.batch_norm(x.float(), self.running_mean, self.running_var, self.weight,
                                self.bias, True, 0.1, 1e-5).to(x.dtype))


class Pass(nn.Module):
    """A parameterless stage under the checkpoint's numbering."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, x: Tensor, p: Precision) -> Tensor:
        return p.q(self.fn(x))


class ResBlock(nn.Module):
    def __init__(self, fin: int, fout: int):
        super().__init__()
        if fin != fout:
            self.conv_expand = Conv(fin, fout, 1, bias=False)
        else:
            self.conv_expand = None
        self.conv1 = Conv(fin, fout, 3, bias=False)
        self.bn1 = BN(fout)
        self.conv2 = Conv(fout, fout, 3, bias=False)
        self.bn2 = BN(fout)

    def forward(self, x: Tensor, p: Precision) -> Tensor:
        identity = x if self.conv_expand is None else self.conv_expand(x, p)
        y = p.q(leaky(self.bn1(self.conv1(x, p), p)))
        y = self.bn2(self.conv2(y, p), p)
        return p.q(leaky(p.q(y + identity)))


def _avg(x: Tensor) -> Tensor:
    return F.avg_pool2d(x, 2, 2)


def _up(x: Tensor) -> Tensor:
    return F.interpolate(x, scale_factor=2, mode="nearest")


class Encoder(nn.Module):
    def __init__(self, cdim: int, zdim: int, channels: Sequence[int], size: int):
        super().__init__()
        cc = channels[0]
        self.main = nn.Sequential(Conv(cdim, cc, 5, bias=False), BN(cc), Pass(leaky), Pass(_avg))
        sz = size // 2
        for ch in channels[1:]:
            self.main.add_module(f"res_in_{sz}", ResBlock(cc, ch))
            self.main.add_module(f"down_to_{sz // 2}", Pass(_avg))
            cc, sz = ch, sz // 2
        self.main.add_module(f"res_in_{sz}", ResBlock(cc, cc))
        self.fc = Linear(cc * sz * sz, 2 * zdim)

    def forward(self, x: Tensor, p: Precision) -> Tuple[Tensor, Tensor]:
        for m in self.main:
            x = m(x, p)
        mu, logvar = self.fc(x.flatten(1).float(), p).chunk(2, dim=1)
        return mu, logvar


class Decoder(nn.Module):
    def __init__(self, cdim: int, zdim: int, channels: Sequence[int], size: int):
        super().__init__()
        cc = channels[-1]
        sz = size // 2 ** len(channels)
        self.shape = (cc, sz, sz)
        self.fc = nn.Sequential(Linear(zdim, cc * sz * sz), Pass(F.relu))
        self.main = nn.Sequential()
        for ch in reversed(channels):
            self.main.add_module(f"res_in_{sz}", ResBlock(cc, ch))
            self.main.add_module(f"up_to_{sz * 2}", Pass(_up))
            cc, sz = ch, sz * 2
        self.main.add_module(f"res_in_{sz}", ResBlock(cc, cc))
        self.main.add_module("predict", Conv(cc, cdim, 5, bias=True))

    def forward(self, z: Tensor, p: Precision) -> Tensor:
        y = z.float()
        for m in self.fc:
            y = m(y, p)
        y = y.view(z.shape[0], *self.shape)
        for m in self.main:
            y = m(y, p)
        return y.float()


class ImageNets(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        m = cfg["model"]
        args = (m["cdim"], m["z_dim"], tuple(m["channels"]), m["image_size"])
        self.encoder = Encoder(*args)
        self.decoder = Decoder(*args)


def init_rules(nets: nn.Module) -> Dict[str, Tuple[str, float]]:
    """How PyTorch initialises each leaf, as ("randn", std) or ("const", v):
    conv and linear weights and biases with the variance of their default
    uniform draw, 1 / (3 fan_in); BN weights 1, biases 0; BN buffers at their
    initial values."""
    rules = {}
    for mname, mod in nets.named_modules():
        pre = f"{mname}." if mname else ""
        if isinstance(mod, (Conv, Linear)):
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


class ImageReference:
    """The image intro step at one batch size in float32."""

    def __init__(self, cfg: dict, device, prec: Precision = Precision()):
        m, t = cfg["model"], cfg["train"]
        self.prec = prec
        self.device = torch.device(device)
        self.beta_rec, self.beta_kl, self.beta_neg = t["beta_rec"], t["beta_kl"], t["beta_neg"]
        self.gamma_r = t["gamma_r"]
        self.scale = 1.0 / (m["cdim"] * m["image_size"] ** 2)
        self.lr_e, self.lr_d = t["lr_e"], t["lr_d"]
        self.z_dim = m["z_dim"]
        with torch.device(self.device):
            self.nets = ImageNets(cfg)
        self.opt_e = PlainAdam(list(self.nets.encoder.parameters()), self.lr_e)
        self.opt_d = PlainAdam(list(self.nets.decoder.parameters()), self.lr_d)

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

    def step(self, x_u8: Tensor, draws: Draws, encoder_after=None) -> Dict[str, object]:
        """One intro step on a uint8 NHWC batch."""
        p = self.prec
        enc, dec = self.nets.encoder, self.nets.decoder
        x = x_u8.float().div(255.0).permute(0, 3, 1, 2)
        b = x.shape[0]
        d = {k: draws.randn((b, self.z_dim)) for k in DRAW_KEYS}
        pe, pd = list(enc.parameters()), list(dec.parameters())

        # E phase
        fake = dec(d["noise"], p)
        mu, logvar = enc(x, p)
        z = mu + d["eps_real"] * torch.exp(0.5 * logvar)
        rec = dec(z, p)
        loss_rec = sq_err_per_sample(x, rec).mean()
        kl_real = kl_per_sample(mu, logvar).mean()
        rmu, rlv = enc(rec.detach(), p)
        fmu, flv = enc(fake.detach(), p)
        rec_rec = dec(rmu + d["eps_e_rec"] * torch.exp(0.5 * rlv), p)
        rec_fake = dec(fmu + d["eps_e_fake"] * torch.exp(0.5 * flv), p)
        expelbo_rec = exp_elbo(sq_err_per_sample(rec, rec_rec), kl_per_sample(rmu, rlv),
                               self.scale, self.beta_rec, self.beta_neg)
        expelbo_fake = exp_elbo(sq_err_per_sample(fake, rec_fake), kl_per_sample(fmu, flv),
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

        # D phase, with the updated encoder and the same z
        z_d = z.detach()
        fake = dec(d["noise"], p)
        rec = dec(z_d, p)
        loss_rec = sq_err_per_sample(x, rec).mean()
        rmu, rlv = enc(rec, p)
        fmu, flv = enc(fake, p)
        rec_rec = dec((rmu + d["eps_d_rec"] * torch.exp(0.5 * rlv)).detach(), p)
        rec_fake = dec((fmu + d["eps_d_fake"] * torch.exp(0.5 * flv)).detach(), p)
        lrr = sq_err_per_sample(rec.detach(), rec_rec).mean()
        lfr = sq_err_per_sample(fake.detach(), rec_fake).mean()
        kl_rec = kl_per_sample(rmu, rlv).mean()
        kl_fake = kl_per_sample(fmu, flv).mean()
        loss_d = self.scale * (self.beta_rec * loss_rec + 0.5 * self.beta_kl * (kl_rec + kl_fake)
                               + self.gamma_r * 0.5 * self.beta_rec * (lrr + lfr))
        g_d = grads_of(loss_d, pd)
        self.opt_d.step(g_d)

        names = {id(t): n for n, t in self.nets.named_parameters()}
        grads = {names[id(t)]: g for t, g in zip(pe + pd, g_e + g_d)}
        return {"loss_e": loss_e.detach(), "loss_d": loss_d.detach(), "kl": kl_real.detach(),
                "grads": grads}
