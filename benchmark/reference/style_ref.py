"""Plain float32 reference of the Style-SoftIntroVAE intro step.

A frozen copy of the step's mathematics, written from the published model
(style_soft_intro_vae/net.py and model.py, Daniel & Tamar, CVPR 2021): the
ALAE-style encoder (per-block instance-norm statistics as styles), the
StyleGAN-style generator (constant input, noise injection, AdaIN, [1,2,1]
blur, fused up/down-scaling convolutions), the two mappings, equalized
learning rate by explicit scaling, the losses of the E and D phases, Adam
with beta1 = 0 for both phases, and the EMA twin. It imports nothing of the
program and nothing of JAX.

Parameter names are the ones a checkpoint of the recipe uses, so the
benchmark loads one set of weights into both sides by name. The random draws
come from ``Draws`` in the order the step makes them: seven latents, then
for every generator pass the mixing draws (mixing passes only) and two noise
planes a decoder block.

Every module computes in float32; ``Precision`` rounds the conv path for the
controls and types it for the FLOP count.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.common import (
    Draws, NormHook, PlainLreqAdam, Precision, exp_elbo, grads_of, kl_per_sample, leaky,
    sq_err_per_sample)

Tensor = torch.Tensor
SQRT2 = math.sqrt(2.0)
LATENT_KEYS = ("eps_real", "eps_e_rec", "eps_e_fake", "eps_d_rec", "eps_d_fake", "noise",
               "noise_d")


class Ctx:
    """What a forward needs besides weights: precision, draws, a norm hook."""

    def __init__(self, prec: Precision, draws: Draws, hook: NormHook = None):
        self.prec, self.draws, self.hook = prec, draws, hook


class Dense(nn.Module):
    """Equalized-lr linear: y = x (W std)^T + b lrmul, std = gain / sqrt(in) * lrmul."""

    def __init__(self, fin: int, fout: int, gain: float = SQRT2, lrmul: float = 1.0):
        super().__init__()
        self.lrmul, self.std = lrmul, gain / math.sqrt(fin) * lrmul
        self.weight = nn.Parameter(torch.empty(fout, fin))
        self.bias = nn.Parameter(torch.empty(fout))

    def forward(self, x: Tensor, c: Ctx) -> Tensor:
        return F.linear(x.float(), self.weight * self.std, self.bias * self.lrmul)


class Conv(nn.Module):
    """Equalized-lr conv (gain / sqrt(k^2 in)); ``down``: stride 2 with the
    box-filtered 4x4 kernel (the fused downscale)."""

    def __init__(self, fin: int, fout: int, k: int, pad: int, bias: bool, gain: float = SQRT2,
                 down: bool = False):
        super().__init__()
        self.pad, self.down = pad, down
        self.std = gain / math.sqrt(k * k * fin)
        self.weight = nn.Parameter(torch.empty(fout, fin, k, k))
        self.bias = nn.Parameter(torch.empty(fout)) if bias else None

    def forward(self, x: Tensor, c: Ctx) -> Tensor:
        w = self.weight
        if self.down:
            w = F.pad(w, (1, 1, 1, 1))
            w = 0.25 * (w[..., 1:, 1:] + w[..., :-1, 1:] + w[..., 1:, :-1] + w[..., :-1, :-1])
        p = c.prec
        b = None if self.bias is None else p.cast(self.bias)
        y = F.conv2d(p.cast(x), p.cast(w * self.std), b, stride=2 if self.down else 1,
                     padding=self.pad)
        return p.q(y)


class ConvUp(nn.Module):
    """The fused upscale: a stride-2 transposed conv with the 4x4 kernel that
    sums the four shifted copies of the 3x3 one, no bias."""

    def __init__(self, fin: int, fout: int):
        super().__init__()
        self.std = SQRT2 / math.sqrt(9 * fin)
        self.weight = nn.Parameter(torch.empty(fin, fout, 3, 3))

    def forward(self, x: Tensor, c: Ctx) -> Tensor:
        w = F.pad(self.weight, (1, 1, 1, 1))
        w = w[..., 1:, 1:] + w[..., :-1, 1:] + w[..., 1:, :-1] + w[..., :-1, :-1]
        p = c.prec
        return p.q(F.conv_transpose2d(p.cast(x), p.cast(w * self.std), stride=2, padding=1))


def blur(x: Tensor, c: Ctx) -> Tensor:
    f = torch.tensor([1.0, 2.0, 1.0], device=x.device)
    k = (f[:, None] * f[None, :] / 16.0).to(x.dtype)
    return c.prec.q(F.conv2d(x, k.expand(x.shape[1], 1, 3, 3), padding=1, groups=x.shape[1]))


def upscale(x: Tensor) -> Tensor:
    return F.interpolate(x, scale_factor=2, mode="nearest")


def norm_site(x: Tensor, bias: Tensor, c: Ctx, eps: float, noise_w: Optional[Tensor] = None,
              style: Optional[Tensor] = None) -> Tuple[Tensor, Tensor, Tensor]:
    """leaky_relu(x [+ noise_w * noise] + bias), instance-normalized per (b, c)
    plane (two-pass float32 statistics), then AdaIN where ``style`` (B, 2C)
    is given. Returns (y, mean, var); the encoder's style heads read the
    moments. The noise plane (B, H, W) is drawn here."""
    mode = "plain" if noise_w is None else "noise"
    key = (tuple(x.shape), mode)
    if c.hook is not None:
        c.hook("fwd", *key)
    e = x.float()
    if noise_w is not None:
        b, _, h, w = x.shape
        n = c.draws.randn((b, h, w))
        e = e + noise_w.view(1, -1, 1, 1) * n[:, None]
    e = leaky(e + bias.view(1, -1, 1, 1))
    m = e.mean(dim=(2, 3))
    v = ((e - m[:, :, None, None]) ** 2).mean(dim=(2, 3))
    y = (e - m[:, :, None, None]) * torch.rsqrt(v + eps)[:, :, None, None]
    if style is not None:
        s = style.view(style.shape[0], 2, -1)
        y = y * (s[:, 0, :, None, None] + 1.0) + s[:, 1, :, None, None]
    y = c.prec.cast(y)
    outs = [t for t in (y, m, v) if t.requires_grad]
    if c.hook is not None and outs:
        # the site's backward runs once any of its outputs gets a gradient
        torch.autograd.graph.register_multi_grad_hook(
            outs, lambda grads, hook=c.hook: hook("bwd", *key), mode="any")
    return y, m, v


class EncodeBlock(nn.Module):
    def __init__(self, fin: int, fout: int, latent: int, fused: bool):
        super().__init__()
        self.fused = fused
        self.conv_1 = Conv(fin, fin, 3, 1, bias=False)
        self.bias_1 = nn.Parameter(torch.empty(1, fin, 1, 1))
        self.style_1 = Dense(2 * fin, latent)
        self.conv_2 = Conv(fin, fout, 3, 1, bias=False, down=fused)
        self.bias_2 = nn.Parameter(torch.empty(1, fout, 1, 1))
        self.style_2 = Dense(2 * fout, latent)

    def forward(self, x: Tensor, c: Ctx):
        x, m1, v1 = norm_site(self.conv_1(x, c), self.bias_1.view(-1), c, 1e-5)
        s1 = self.style_1(torch.cat([m1, torch.sqrt(v1 + 1e-12)], dim=1), c)
        x = self.conv_2(blur(x, c), c)
        if not self.fused:
            x = c.prec.q(F.avg_pool2d(x, 2))
        x, m2, v2 = norm_site(x, self.bias_2.view(-1), c, 1e-5)
        s2 = self.style_2(torch.cat([m2, torch.sqrt(v2 + 1e-12)], dim=1), c)
        return x, s1, s2


class DecodeBlock(nn.Module):
    def __init__(self, fin: int, fout: int, latent: int, first: bool, fused: bool):
        super().__init__()
        self.first, self.fused = first, fused
        if not first:
            self.conv_1 = ConvUp(fin, fout) if fused else Conv(fin, fout, 3, 1, bias=False)
        self.noise_weight_1 = nn.Parameter(torch.empty(1, fout, 1, 1))
        self.bias_1 = nn.Parameter(torch.empty(1, fout, 1, 1))
        self.style_1 = Dense(latent, 2 * fout, gain=1.0)
        self.conv_2 = Conv(fout, fout, 3, 1, bias=False)
        self.noise_weight_2 = nn.Parameter(torch.empty(1, fout, 1, 1))
        self.bias_2 = nn.Parameter(torch.empty(1, fout, 1, 1))
        self.style_2 = Dense(latent, 2 * fout, gain=1.0)

    def forward(self, x: Tensor, s1: Tensor, s2: Tensor, c: Ctx) -> Tensor:
        x = c.prec.cast(x)
        if not self.first:
            x = self.conv_1(x, c) if self.fused else self.conv_1(upscale(x), c)
            x = blur(x, c)
        x, _, _ = norm_site(x, self.bias_1.view(-1), c, 1e-8, self.noise_weight_1.view(-1),
                            self.style_1(s1, c))
        x = self.conv_2(x, c)
        x, _, _ = norm_site(x, self.bias_2.view(-1), c, 1e-8, self.noise_weight_2.view(-1),
                            self.style_2(s2, c))
        return x


class FromRGB(nn.Module):
    def __init__(self, channels: int, fout: int):
        super().__init__()
        self.from_rgb = Conv(channels, fout, 1, 0, bias=True)

    def forward(self, x: Tensor, c: Ctx) -> Tensor:
        return c.prec.q(leaky(self.from_rgb(x, c)))


class ToRGB(nn.Module):
    def __init__(self, fin: int, channels: int):
        super().__init__()
        self.to_rgb = Conv(fin, channels, 1, 0, bias=True, gain=0.03)

    def forward(self, x: Tensor, c: Ctx) -> Tensor:
        return self.to_rgb(x, c).float()


class Encoder(nn.Module):
    def __init__(self, startf: int, maxf: int, layers: int, latent: int, channels: int):
        super().__init__()
        self.layers, self.latent = layers, latent
        self.from_rgb = nn.ModuleList()
        self.encode_block = nn.ModuleList()
        mul, fin, res = 2, startf, 2 ** (layers + 1)
        for _ in range(layers):
            fout = min(maxf, startf * mul)
            self.from_rgb.append(FromRGB(channels, fin))
            self.encode_block.append(EncodeBlock(fin, fout, latent, fused=res >= 128))
            res //= 2
            fin, mul = fout, mul * 2

    def forward(self, x: Tensor, lod: int, c: Ctx) -> Tensor:
        styles = torch.zeros((x.shape[0], self.latent), device=x.device)
        first = self.layers - lod - 1
        h = self.from_rgb[first](x, c)
        for i in range(first, self.layers):
            h, s1, s2 = self.encode_block[i](h, c)
            styles = styles + s1 + s2
        return styles


class Generator(nn.Module):
    def __init__(self, startf: int, maxf: int, layers: int, latent: int, channels: int):
        super().__init__()
        mul = 2 ** (layers - 1)
        fin = min(maxf, startf * mul)
        self.const = nn.Parameter(torch.empty(1, fin, 4, 4))
        self.decode_block = nn.ModuleList()
        self.to_rgb = nn.ModuleList()
        res = 2
        for i in range(layers):
            fout = min(maxf, startf * mul)
            self.decode_block.append(DecodeBlock(fin, fout, latent, first=i == 0,
                                                 fused=res * 2 >= 128))
            self.to_rgb.append(ToRGB(fout, channels))
            res *= 2
            fin, mul = fout, mul // 2

    def forward(self, styles: Tensor, lod: int, c: Ctx) -> Tensor:
        x = self.const.expand(styles.shape[0], -1, -1, -1)
        for i in range(lod + 1):
            x = self.decode_block[i](x, styles[:, 2 * i], styles[:, 2 * i + 1], c)
        return self.to_rgb[lod](x, c)


class MapBlock(nn.Module):
    def __init__(self, fin: int, fout: int):
        super().__init__()
        self.fc = Dense(fin, fout, lrmul=0.1)


class MappingToLatent(nn.Module):
    """styles (B, latent) -> (mu, logvar), three leaky-ReLU blocks."""

    def __init__(self, latent: int, layers: int = 3):
        super().__init__()
        self.map_blocks = nn.ModuleList(
            MapBlock(latent, 2 * latent if i == layers - 1 else latent) for i in range(layers))

    def forward(self, x: Tensor, c: Ctx) -> Tuple[Tensor, Tensor]:
        for blk in self.map_blocks:
            x = leaky(blk.fc(x, c))
        return x[:, : x.shape[1] // 2], x[:, x.shape[1] // 2:]


class MappingFromLatent(nn.Module):
    """z -> w: pixel norm, then leaky-ReLU blocks."""

    def __init__(self, latent: int, layers: int):
        super().__init__()
        self.map_blocks = nn.ModuleList(MapBlock(latent, latent) for _ in range(layers))

    def forward(self, z: Tensor, c: Ctx) -> Tensor:
        h = z * torch.rsqrt((z * z).mean(dim=-1, keepdim=True) + 1e-8)
        for blk in self.map_blocks:
            h = leaky(blk.fc(h, c))
        return h


class DLatent(nn.Module):
    def __init__(self, layers: int, latent: int):
        super().__init__()
        self.register_buffer("buff", torch.zeros(layers, latent))


class StyleNets(nn.Module):
    """encoder, decoder, mapping_tl, mapping_fl, dlatent_avg (checkpoint names)."""

    def __init__(self, cfg: dict):
        super().__init__()
        m = cfg["model"]
        args = (m["START_CHANNEL_COUNT"], m["MAX_CHANNEL_COUNT"], m["LAYER_COUNT"],
                m["LATENT_SPACE_SIZE"], m.get("CHANNELS", 3))
        self.encoder = Encoder(*args)
        self.decoder = Generator(*args)
        self.mapping_tl = MappingToLatent(m["LATENT_SPACE_SIZE"])
        self.mapping_fl = MappingFromLatent(m["LATENT_SPACE_SIZE"], m["MAPPING_LAYERS"])
        self.dlatent_avg = DLatent(2 * m["LAYER_COUNT"], m["LATENT_SPACE_SIZE"])

    def params_e(self) -> List[Tensor]:
        return list(self.encoder.parameters()) + list(self.mapping_tl.parameters())

    def params_d(self) -> List[Tensor]:
        return list(self.decoder.parameters()) + list(self.mapping_fl.parameters())


def init_rule(name: str, shape) -> Tuple[str, float]:
    """How the recipe initialises a leaf: ("randn", std) or ("const", value).
    Equalized-lr weights are N(0, 1/lrmul); biases, noise weights and the
    dlatent average start at 0, the generator's constant at 1."""
    if name.endswith("const"):
        return "const", 1.0
    if name.endswith(".weight"):
        return "randn", 10.0 if ".map_blocks." in name else 1.0
    return "const", 0.0


class StyleReference:
    """The intro step of one (lod, batch) in float32, over ``StyleNets``."""

    def __init__(self, cfg: dict, lod: int, batch: int, device, prec: Precision = Precision(),
                 hook: NormHook = None):
        m, t = cfg["model"], cfg["train"]
        self.cfg, self.lod, self.batch = cfg, lod, batch
        self.latent = m["LATENT_SPACE_SIZE"]
        self.num_layers = 2 * m["LAYER_COUNT"]
        self.prec, self.hook = prec, hook
        self.device = torch.device(device)
        self.beta_kl, self.beta_rec, self.scale = m["BETA_KL"], m["BETA_REC"], m["SCALE"]
        self.beta_neg = float(m["BETA_NEG"][min(lod, len(m["BETA_NEG"]) - 1)])
        self.gamma_r = t["GAMMA_R"]
        self.avg_beta = m["DLATENT_AVG_BETA"]
        self.mixing_prob = m["STYLE_MIXING_PROB"]
        self.lr = t["LEARNING_RATES"][min(lod, len(t["LEARNING_RATES"]) - 1)]
        self.b2 = t["ADAM_BETA_1"]
        self.ema_beta = 0.5 ** (batch / 10000.0)
        with torch.device(self.device):
            self.nets = StyleNets(cfg)
        self.ema = {k: t.detach().clone() for k, t in _leaves(self.nets).items()}
        self.opt_e = PlainLreqAdam(self.nets.params_e(), self.lr, self.b2)
        self.opt_d = PlainLreqAdam(self.nets.params_d(), self.lr, self.b2)

    def load(self, weights: Dict[str, Tensor]) -> None:
        """Weights by checkpoint name (every parameter and buffer), into the
        nets and their EMA twin."""
        own = _leaves(self.nets)
        if set(own) != set(weights):
            raise ValueError(f"weights differ from the reference's leaves: "
                             f"{sorted(set(own) ^ set(weights))[:8]}")
        with torch.no_grad():
            for k, t in own.items():
                t.copy_(weights[k])
                self.ema[k].copy_(weights[k])

    def load_state(self, state: Dict[str, dict], steps: int) -> None:
        """Another side's state after ``steps`` steps, by name: ``leaves``
        (every parameter and buffer), ``ema`` (the twin's leaves) and
        ``moments`` (each parameter's optimizer v)."""
        self.load(state["leaves"])
        with torch.no_grad():
            for k, e in self.ema.items():
                e.copy_(state["ema"][k])
        for opt in (self.opt_e, self.opt_d):
            opt.load([n for n, _ in _named(self.nets, opt.params)], state["moments"], steps)

    # ------------------------------------------------------------ model ops --
    def encode(self, x: Tensor, eps: Tensor, c: Ctx):
        mu, logvar = self.nets.mapping_tl(self.nets.encoder(x, self.lod, c), c)
        return mu + eps * torch.exp(0.5 * logvar), mu, logvar

    def generate(self, z: Tensor, mixing: bool, c: Ctx) -> Tensor:
        nets = self.nets
        w = nets.mapping_fl(z, c)
        styles = w[:, None, :].expand(-1, self.num_layers, -1)
        with torch.no_grad():
            avg = nets.dlatent_avg.buff
            avg.add_((styles.mean(dim=0) - avg) * (1.0 - self.avg_beta))
        if mixing:
            z2 = c.draws.randn(z.shape)
            styles2 = nets.mapping_fl(z2, c)[:, None, :].expand(-1, self.num_layers, -1)
            cutoff = c.draws.randint(1, (self.lod + 1) * 2 + 1)
            idx = torch.arange(self.num_layers, device=z.device)[None, :, None]
            mixed = torch.where(idx < cutoff, styles, styles2)
            styles = torch.where(c.draws.rand() < self.mixing_prob, mixed, styles)
        return nets.decoder(styles, self.lod, c)

    # ----------------------------------------------------------------- step --
    def step(self, x: Tensor, draws: Draws, encoder_after=None) -> Dict[str, object]:
        """One intro step on x (B, 3, H, W) in [-1, 1]. Returns the losses, the
        E phase's KL of the real batch and each parameter's gradient by name
        (the phase's own)."""
        c = Ctx(self.prec, draws, self.hook)
        nets = self.nets
        b = x.shape[0]
        lat = {k: draws.randn((b, self.latent)) for k in LATENT_KEYS}
        pe, pd = nets.params_e(), nets.params_d()

        # E phase: the encoder and mapping_tl step
        fake = self.generate(lat["noise"], True, c)
        z_real, mu, logvar = self.encode(x, lat["eps_real"], c)
        rec = self.generate(z_real, False, c)
        loss_rec = sq_err_per_sample(x, rec).mean()
        kl_real = kl_per_sample(mu, logvar).mean()
        z_rec, rmu, rlv = self.encode(rec.detach(), lat["eps_e_rec"], c)
        rec_rec = self.generate(z_rec, False, c)
        z_fake, fmu, flv = self.encode(fake.detach(), lat["eps_e_fake"], c)
        rec_fake = self.generate(z_fake, False, c)
        expelbo_rec = exp_elbo(sq_err_per_sample(rec, rec_rec), kl_per_sample(rmu, rlv),
                               self.scale, self.beta_rec, self.beta_neg)
        expelbo_fake = exp_elbo(sq_err_per_sample(fake, rec_fake), kl_per_sample(fmu, flv),
                                self.scale, self.beta_rec, self.beta_neg)
        loss_e = (self.scale * (self.beta_rec * loss_rec + self.beta_kl * kl_real)
                  + 0.25 * (expelbo_rec + expelbo_fake))
        g_e = grads_of(loss_e, pe)
        del fake, rec, rec_rec, rec_fake
        self.opt_e.step(g_e)
        if encoder_after is not None:  # the D phase from another side's E update
            with torch.no_grad():
                for k, t in self.nets.named_parameters():
                    if k in encoder_after:
                        t.copy_(encoder_after[k])

        # D phase: the decoder and mapping_fl step, with the updated encoder
        fake = self.generate(lat["noise_d"], True, c)
        rec = self.generate(z_real.detach(), False, c)
        loss_rec = sq_err_per_sample(x, rec).mean()
        z_rec, rmu, rlv = self.encode(rec, lat["eps_d_rec"], c)
        z_fake, fmu, flv = self.encode(fake, lat["eps_d_fake"], c)
        rec_rec = self.generate(z_rec.detach(), False, c)
        rec_fake = self.generate(z_fake.detach(), False, c)
        lrr = sq_err_per_sample(rec.detach(), rec_rec).mean()
        lfr = sq_err_per_sample(fake.detach(), rec_fake).mean()
        kl_rec = kl_per_sample(rmu, rlv).mean()
        kl_fake = kl_per_sample(fmu, flv).mean()
        loss_d = self.scale * (self.beta_rec * loss_rec + 0.5 * self.beta_kl * (kl_rec + kl_fake)
                               + self.gamma_r * 0.5 * self.beta_rec * (lrr + lfr))
        g_d = grads_of(loss_d, pd)
        del fake, rec, rec_rec, rec_fake
        self.opt_d.step(g_d)
        self._ema()

        names_e = [n for n, _ in _named(nets, pe)]
        names_d = [n for n, _ in _named(nets, pd)]
        grads = dict(zip(names_e, g_e))
        grads.update(zip(names_d, g_d))
        return {"loss_e": loss_e.detach(), "loss_d": loss_d.detach(), "kl": kl_real.detach(),
                "grads": grads}

    @torch.no_grad()
    def _ema(self) -> None:
        w = 1.0 - self.ema_beta
        own = _leaves(self.nets)
        for k, e in self.ema.items():
            e.add_((own[k] - e) * w)


def _leaves(module: nn.Module) -> Dict[str, Tensor]:
    own = dict(module.named_parameters())
    own.update(module.named_buffers())
    return own


def _named(module: nn.Module, params: Sequence[Tensor]):
    ids = {id(p): n for n, p in module.named_parameters()}
    return [(ids[id(p)], p) for p in params]
