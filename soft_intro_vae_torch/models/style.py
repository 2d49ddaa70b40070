"""ALAE/StyleGAN-style networks of Style-SoftIntroVAE (port of models/style.py).

Reference: style_soft_intro_vae/net.py. pixel_norm, Blur ([1,2,1]^2
depthwise), EncodeBlock (per-block style statistics -> w), DecodeBlock (noise
inject or the deterministic correction, two AdaIN stages), FromRGB/ToRGB,
EncoderDefault (styles sum, with the blended transition path),
GeneratorDefault (const 4x4 input, progressive decode with blend) and the
mappings. The encoder also builds the registry's other two variants
(MODEL.ENCODER): EncoderWithStatistics, whose last block replaces its second
conv with a dense layer on the flattened 4x4 map (``dense``), and
EncoderWithFC, the same with an ``fc2`` head (JAX models/style.py:161-168,
313-359). Module and parameter names are the reference's, as
``convert_style_encoder``/``convert_style_generator``/``convert_mapping``
(soft_intro_vae_tpu/utils/torch_compat.py:264-321) read them.

Layout NCHW. Every norm site goes through ``ops/adain.bias_act_norm``: the
hand-written CUDA kernels for CUDA tensors, the plain version on the CPU
(``norm_impl="plain"`` forces the plain version, to compare the two on the
card). ``dtype`` is the conv path's compute type (bfloat16 in
configs/ffhq256.yaml); the style heads, moments, mappings and ToRGB's output
stay float32, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from soft_intro_vae_torch.models.lreq import LreqConv2d, LreqConvTranspose2d, LreqDense
from soft_intro_vae_torch.ops.adain import bias_act_norm
from soft_intro_vae_torch.parallel.mesh import randn_rows

Tensor = torch.Tensor
NOISE_MODES = ("batch", "batch_constant", "none")


def pixel_norm(x: Tensor, epsilon: float = 1e-8) -> Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + epsilon)


def upscale2d(x: Tensor, factor: int = 2) -> Tensor:
    """Nearest-neighbour upscale (F.interpolate's default, net.py:570)."""
    b, c, h, w = x.shape
    x = x[:, :, :, None, :, None].expand(b, c, h, factor, w, factor)
    return x.reshape(b, c, h * factor, w * factor)


def downscale2d(x: Tensor, factor: int = 2) -> Tensor:
    return F.avg_pool2d(x, factor, factor)


_BLUR_KERNELS: Dict[Tuple[torch.dtype, torch.device], Tensor] = {}


def blur3x3(x: Tensor) -> Tensor:
    """Depthwise [1,2,1] x [1,2,1] / 16 blur (net.py:49-60), in x's type.

    The 3x3 filter is made once per (type, device) and kept: a step copies
    no host data to the device, which a CUDA graph's capture forbids."""
    key = (x.dtype, x.device)
    k = _BLUR_KERNELS.get(key)
    if k is None:
        f = torch.tensor([1.0, 2.0, 1.0], dtype=x.dtype)
        k = _BLUR_KERNELS.setdefault(key, ((f[:, None] * f[None, :]) / 16.0).to(x.device))
    c = x.shape[1]
    return F.conv2d(x, k.expand(c, 1, 3, 3), padding=1, groups=c)


def blend_lerp(prev: Tensor, x: Tensor, blend: Union[float, Tensor]) -> Tensor:
    """``prev + (x - prev) * blend``, the blend (a float32 0-dim tensor, or a
    float taken as one) first rounded to x's type, as the JAX package's
    ``blend.astype(h.dtype)`` (soft_intro_vae_tpu/models/style.py:353): a
    bf16 lerp multiplies by the bf16 blend, not by the float32 one."""
    if not isinstance(blend, Tensor):
        blend = torch.tensor(float(blend), dtype=torch.float32)
    return prev + (x - prev) * blend.to(x.dtype)


def _style_stats(m: Tensor, v: Tensor) -> Tensor:
    # (mean, std) per channel (net.py:97-101). +1e-12 inside the sqrt: at
    # v = 0 (the clamped one-pass variance of a constant channel) sqrt's
    # backward is inf, as in the JAX package (models/style.py:156-160)
    return torch.cat([m, torch.sqrt(v + 1e-12)], dim=1)


class EncodeBlock(nn.Module):
    """net.py:63-126. ``last``: the dense path of the variants' last block
    (net.py:103-108): after the first norm the (C, 4, 4) map is flattened in
    (C, H, W) order into ``dense``, then a leaky ReLU, and style_2 reads that
    output. There is no bias_2 on this path, and the JAX package's tree has
    none, so neither has the block."""

    def __init__(self, inputs: int, outputs: int, latent_size: int, fused_scale: bool = True,
                 dtype: torch.dtype = torch.float32, norm_impl: str = "auto", last: bool = False):
        super().__init__()
        self.fused_scale = fused_scale
        self.norm_impl = norm_impl
        self.last = last
        self.conv_1 = LreqConv2d(inputs, inputs, 3, 1, 1, bias=False, dtype=dtype)
        self.bias_1 = nn.Parameter(torch.zeros(1, inputs, 1, 1))
        self.style_1 = LreqDense(2 * inputs, latent_size)
        if last:
            self.dense = LreqDense(inputs * 4 * 4, outputs, dtype=dtype)
            self.style_2 = LreqDense(outputs, latent_size)
            return
        if fused_scale:
            self.conv_2 = LreqConv2d(inputs, outputs, 3, 2, 1, bias=False, transform_kernel=True,
                                     dtype=dtype)
        else:
            self.conv_2 = LreqConv2d(inputs, outputs, 3, 1, 1, bias=False, dtype=dtype)
        self.bias_2 = nn.Parameter(torch.zeros(1, outputs, 1, 1))
        self.style_2 = LreqDense(2 * outputs, latent_size)

    def forward(self, x: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
        # one moment sweep feeds both the style head and the instance norm
        # (torch's IN default eps 1e-5)
        x, m1, v1 = bias_act_norm(self.conv_1(x), self.bias_1.view(-1), mode="plain", eps=1e-5,
                                  impl=self.norm_impl)
        style_1 = _style_stats(m1, v1)
        if self.last:
            x = F.leaky_relu(self.dense(x.flatten(1)), 0.2)
            return x, self.style_1(style_1), self.style_2(x.float())
        x = self.conv_2(blur3x3(x))
        if not self.fused_scale:
            x = downscale2d(x)
        x, m2, v2 = bias_act_norm(x, self.bias_2.view(-1), mode="plain", eps=1e-5,
                                  impl=self.norm_impl)
        style_2 = _style_stats(m2, v2)
        return x, self.style_1(style_1), self.style_2(style_2)


class DecodeBlock(nn.Module):
    """net.py:129-207: inject + bias + leaky ReLU + IN + AdaIN, twice."""

    def __init__(self, inputs: int, outputs: int, latent_size: int, has_first_conv: bool = True,
                 fused_scale: bool = True, layer: int = 0, dtype: torch.dtype = torch.float32,
                 norm_impl: str = "auto"):
        super().__init__()
        self.has_first_conv = has_first_conv
        self.fused_scale = fused_scale
        self.layer = layer
        self.dtype = dtype
        self.norm_impl = norm_impl
        self.outputs = outputs
        if has_first_conv:
            if fused_scale:
                self.conv_1 = LreqConvTranspose2d(inputs, outputs, 3, 2, 1,
                                                  transform_kernel=True, dtype=dtype)
            else:
                self.conv_1 = LreqConv2d(inputs, outputs, 3, 1, 1, bias=False, dtype=dtype)
        self.noise_weight_1 = nn.Parameter(torch.zeros(1, outputs, 1, 1))
        self.bias_1 = nn.Parameter(torch.zeros(1, outputs, 1, 1))
        self.style_1 = LreqDense(latent_size, 2 * outputs, gain=1.0)
        self.conv_2 = LreqConv2d(outputs, outputs, 3, 1, 1, bias=False, dtype=dtype)
        self.noise_weight_2 = nn.Parameter(torch.zeros(1, outputs, 1, 1))
        self.bias_2 = nn.Parameter(torch.zeros(1, outputs, 1, 1))
        self.style_2 = LreqDense(latent_size, 2 * outputs, gain=1.0)

    def _styled_norm(self, x: Tensor, w: Tensor, nw: Tensor, bias: Tensor, noise_mode: str,
                     generator: Optional[torch.Generator]) -> Tensor:
        # IN (eps 1e-8) + AdaIN folded into one per-(b, c) affine: g = s0 + 1, b = s1
        w = w.view(w.shape[0], 2, self.outputs)
        g, bst = w[:, 0] + 1.0, w[:, 1]
        if noise_mode == "none":
            y, _, _ = bias_act_norm(x, bias.view(-1), g, bst, mode="corr", eps=1e-8,
                                    corr_scale=math.pow(self.layer + 1, 0.5), impl=self.norm_impl)
            return y
        # the noise is drawn in f32 outside the kernel; "batch_constant" draws
        # one plane and broadcasts it over the batch (net.py:160-167)
        # "batch" draws this rank's rows of the global batch's planes (parallel/mesh.py)
        b, _, h, wd = x.shape
        if noise_mode == "batch_constant":
            n = torch.randn((1, h, wd), generator=generator, device=x.device, dtype=torch.float32)
        else:
            n = randn_rows(b, (h, wd), generator=generator, device=x.device)
        y, _, _ = bias_act_norm(x, bias.view(-1), g, bst, n.expand(b, h, wd), nw.view(-1),
                                mode="noise", eps=1e-8, impl=self.norm_impl)
        return y

    def forward(self, x: Tensor, s1: Tensor, s2: Tensor, noise_mode: str = "batch",
                generator: Optional[torch.Generator] = None) -> Tensor:
        if noise_mode not in NOISE_MODES:
            raise ValueError(f"unknown noise_mode {noise_mode!r}")
        x = x.to(self.dtype)
        if self.has_first_conv:
            x = self.conv_1(x) if self.fused_scale else self.conv_1(upscale2d(x))
            x = blur3x3(x)
        x = self._styled_norm(x, self.style_1(s1), self.noise_weight_1, self.bias_1, noise_mode,
                              generator)
        x = self.conv_2(x)
        return self._styled_norm(x, self.style_2(s2), self.noise_weight_2, self.bias_2,
                                 noise_mode, generator)


class FromRGB(nn.Module):
    def __init__(self, channels: int, outputs: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.from_rgb = LreqConv2d(channels, outputs, 1, 1, 0, dtype=dtype)

    def forward(self, x: Tensor) -> Tensor:
        return F.leaky_relu(self.from_rgb(x), 0.2)


class ToRGB(nn.Module):
    def __init__(self, inputs: int, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.to_rgb = LreqConv2d(inputs, channels, 1, 1, 0, gain=0.03, dtype=dtype)

    def forward(self, x: Tensor) -> Tensor:
        # the image feeds f32 losses and blends
        return self.to_rgb(x).float()


class StyleEncoder(nn.Module):
    """EncoderDefault (net.py:234-319): styles-sum output (B, 1, latent).

    ``last_block_dense`` builds EncoderWithStatistics (net.py:412-497),
    ``with_fc_head`` EncoderWithFC (net.py:322-409), which also returns the
    ``fc2`` logit of the last block's output: ``(styles, (B, 1))``."""

    def __init__(self, startf: int = 32, maxf: int = 256, layer_count: int = 3,
                 latent_size: int = 128, channels: int = 3, dtype: torch.dtype = torch.float32,
                 norm_impl: str = "auto", with_fc_head: bool = False,
                 last_block_dense: bool = False):
        super().__init__()
        self.layer_count = layer_count
        self.latent_size = latent_size
        self.with_fc_head = with_fc_head
        self.from_rgb = nn.ModuleList()
        self.encode_block = nn.ModuleList()
        mul, inputs = 2, startf
        resolution = 2 ** (layer_count + 1)
        last_dense = with_fc_head or last_block_dense
        for i in range(layer_count):
            outputs = min(maxf, startf * mul)
            self.from_rgb.append(FromRGB(channels, inputs, dtype))
            self.encode_block.append(EncodeBlock(inputs, outputs, latent_size,
                                                 fused_scale=resolution >= 128, dtype=dtype,
                                                 norm_impl=norm_impl,
                                                 last=last_dense and i == layer_count - 1))
            resolution //= 2
            inputs, mul = outputs, mul * 2
        if with_fc_head:
            self.fc2 = LreqDense(inputs, 1, gain=1.0)

    def forward(self, x: Tensor, lod: int, blend: Optional[Union[float, Tensor]] = None
                ) -> Tensor:
        styles = torch.zeros((x.shape[0], self.latent_size), dtype=torch.float32,
                             device=x.device)
        first = self.layer_count - lod - 1
        h = self.from_rgb[first](x)
        if blend is None:
            start = first
        else:
            # encode2 (net.py:279-300): the new block's output lerps with the
            # half-resolution input's from_rgb
            h, s1, s2 = self.encode_block[first](h)
            styles = styles + (s1 + s2) * blend
            h_prev = self.from_rgb[first + 1](downscale2d(x))
            h = blend_lerp(h_prev, h, blend)
            start = first + 1
        for i in range(start, self.layer_count):
            h, s1, s2 = self.encode_block[i](h)
            styles = styles + s1 + s2
        if self.with_fc_head:
            return styles[:, None, :], self.fc2(h)
        return styles[:, None, :]


class StyleGenerator(nn.Module):
    """GeneratorDefault (net.py:500-595): const 4x4 start, styled decode blocks,
    a ToRGB head per LOD, the blended transition path (decode2)."""

    def __init__(self, startf: int = 32, maxf: int = 256, layer_count: int = 3,
                 latent_size: int = 128, channels: int = 3, dtype: torch.dtype = torch.float32,
                 norm_impl: str = "auto"):
        super().__init__()
        self.layer_count = layer_count
        mul = 2 ** (layer_count - 1)
        inputs = min(maxf, startf * mul)
        self.const = nn.Parameter(torch.ones(1, inputs, 4, 4))
        self.decode_block = nn.ModuleList()
        self.to_rgb = nn.ModuleList()
        resolution = 2
        for i in range(layer_count):
            outputs = min(maxf, startf * mul)
            self.decode_block.append(DecodeBlock(inputs, outputs, latent_size,
                                                 has_first_conv=i != 0,
                                                 fused_scale=resolution * 2 >= 128, layer=i,
                                                 dtype=dtype, norm_impl=norm_impl))
            self.to_rgb.append(ToRGB(outputs, channels, dtype))
            resolution *= 2
            inputs, mul = outputs, mul // 2

    @property
    def layer_to_resolution(self) -> List[int]:
        return [2 ** (i + 2) for i in range(self.layer_count)]

    def forward(self, styles: Tensor, lod: int, blend: Optional[Union[float, Tensor]] = None,
                noise_mode: str = "batch", generator: Optional[torch.Generator] = None) -> Tensor:
        x = self.const.expand(styles.shape[0], -1, -1, -1)
        last = lod if blend is None else lod - 1
        for i in range(last + 1):
            x = self.decode_block[i](x, styles[:, 2 * i], styles[:, 2 * i + 1], noise_mode,
                                     generator)
        if blend is None:
            return self.to_rgb[lod](x)
        x_prev = self.to_rgb[lod - 1](x)
        x = self.decode_block[lod](x, styles[:, 2 * lod], styles[:, 2 * lod + 1], noise_mode,
                                   generator)
        x = self.to_rgb[lod](x)
        return blend_lerp(upscale2d(x_prev), x, blend)


class MappingBlock(nn.Module):
    """net.py:674-681: the lrmul=0.1 linear, named ``fc``."""

    def __init__(self, inputs: int, outputs: int, lrmul: float = 0.1):
        super().__init__()
        self.fc = LreqDense(inputs, outputs, lrmul=lrmul)


class MappingToLatent(nn.Module):
    """net.py:707-727: leaky-ReLU blocks -> (B, 2, dlatent) (mu, logvar)."""

    def __init__(self, latent_size: int = 256, dlatent_size: int = 256, mapping_fmaps: int = 256,
                 mapping_layers: int = 3):
        super().__init__()
        self.map_blocks = nn.ModuleList()
        inputs = latent_size
        for i in range(mapping_layers):
            outputs = 2 * dlatent_size if i == mapping_layers - 1 else mapping_fmaps
            self.map_blocks.append(MappingBlock(inputs, outputs))
            inputs = outputs

    def forward(self, x: Tensor) -> Tensor:
        h = x.reshape(x.shape[0], -1)
        for blk in self.map_blocks:
            h = F.leaky_relu(blk.fc(h), 0.2)
        return h.view(h.shape[0], 2, h.shape[1] // 2)


class MappingToLatentNoStyle(nn.Module):
    """net.py:730-751: plain lrmul=0.1 linears with no activation, stored bare
    as ``map_blocks.{i}`` (JAX models/style.py:449-461). No config uses it."""

    def __init__(self, latent_size: int = 256, dlatent_size: int = 256, mapping_fmaps: int = 256,
                 mapping_layers: int = 3):
        super().__init__()
        self.map_blocks = nn.ModuleList()
        inputs = latent_size
        for i in range(mapping_layers):
            outputs = dlatent_size if i == mapping_layers - 1 else mapping_fmaps
            self.map_blocks.append(LreqDense(inputs, outputs, lrmul=0.1))
            inputs = outputs

    def forward(self, x: Tensor) -> Tensor:
        h = x.reshape(x.shape[0], -1)
        for blk in self.map_blocks:
            h = blk(h)
        return h


class MappingFromLatent(nn.Module):
    """net.py:754-775: pixel_norm + leaky-ReLU blocks, repeated to num_layers."""

    def __init__(self, num_layers: int = 6, latent_size: int = 256, dlatent_size: int = 256,
                 mapping_fmaps: int = 256, mapping_layers: int = 5):
        super().__init__()
        self.num_layers = num_layers
        self.map_blocks = nn.ModuleList()
        inputs = dlatent_size
        for i in range(mapping_layers):
            outputs = latent_size if i == mapping_layers - 1 else mapping_fmaps
            self.map_blocks.append(MappingBlock(inputs, outputs))
            inputs = outputs

    def forward(self, z: Tensor) -> Tensor:
        h = pixel_norm(z)
        for blk in self.map_blocks:
            h = F.leaky_relu(blk.fc(h), 0.2)
        return h[:, None, :].expand(-1, self.num_layers, -1)
