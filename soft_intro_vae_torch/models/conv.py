"""Convolutional ResNet Soft-IntroVAE for images (port of models/conv.py).

Reference image nets (soft_intro_vae/train_soft_intro_vae.py:38-223), with
the JAX package's architecture (soft_intro_vae_tpu/models/conv.py:69-226):
ResidualBlock (conv3x3-BN-LReLU(0.2)-conv3x3-BN, a 1x1 ``conv_expand`` skip
when the channels change, LReLU(0.2) after the add), a pooling encoder and a
nearest-upsampling decoder, an optional conditional concat.

The nets run channels-last, the JAX package's NHWC (its models/conv.py is
"NHWC layout throughout"): each net converts its parameters to
``torch.channels_last`` when it is built, the decoder makes its FC output
channels-last, and the step's input (ops/u8norm.py) comes so. Every conv is
a ``Conv2d`` whose route ``ops/conv_f32.py`` chooses from the call: in
float32 with cuDNN's TF32 off (the CelebA-HQ and CIFAR-10 configurations) the
hand-written NHWC implicit GEMMs run the forward and both gradients, with no
layout transposes; with TF32 on (the trainer's default) or in bfloat16 cuDNN
runs them on its tensor-core NHWC kernels (with TF32 off cuDNN would pick
FFT and NCHW float32 kernels and transpose around them); on the CPU
``F.conv2d``. Logical shapes stay (B, C, H, W), and the encoder flattens in
the reference's (C, H, W) order, so ``fc`` keeps the reference's weight.

The module names are the reference's, so a reference
``.pth`` state_dict loads strictly and ``utils/torch_compat.py`` of the JAX
package reads the port's weights: ``main.0`` (stem conv), ``main.1`` (stem
BN), ``main.res_in_{sz}``, ``main.down_to_{sz}``, ``fc`` in the encoder;
``fc.0``, ``main.res_in_{sz}``, ``main.up_to_{sz}``, ``main.predict`` in the
decoder. PyTorch's default Conv2d/Linear init is the one the JAX package's
``models/initializers.py`` imitates. BatchNorm2d keeps PyTorch's momentum 0.1
and eps 1e-5; the conv output size is computed, image_size // 2**len(channels).

``compute_dtype=torch.bfloat16`` casts as the JAX nets do: the input to the
compute type, parameters kept in float32 and cast at use, BN statistics and
the fully connected layers in float32, outputs in float32.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from soft_intro_vae_torch.models.remat import current_frame
from soft_intro_vae_torch.ops import conv_f32
from soft_intro_vae_torch.parallel.collectives import batch_norm
from soft_intro_vae_torch.parallel.mesh import current_world

Tensor = torch.Tensor


class Conv2d(nn.Conv2d):
    """nn.Conv2d whose parameters take the input's dtype at use, on the
    route ``ops/conv_f32.py conv2d`` picks (counted in its ``routes``)."""

    def forward(self, x: Tensor) -> Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        if self.padding_mode != "zeros":  # not the nets' (they pad with zeros)
            return self._conv_forward(x, self.weight.to(x.dtype), bias)
        return conv_f32.conv2d(x, self.weight.to(x.dtype), bias, self.stride, self.padding,
                               self.dilation, self.groups)


class RoutedBatchNorm:
    """The forward of the port's BatchNorm layers, put before a torch
    BatchNorm class: it normalizes in float32 (float64 input in float64) and
    returns the input's dtype. In train mode on the distributed route its
    statistics are the global batch's (parallel/collectives.py); without a
    process group it is PyTorch's.

    In the recompute of a checkpointed forward (models/remat.py) a train-mode
    BN normalizes with the batch's statistics and leaves its running buffers
    and ``num_batches_tracked`` as the forward left them; the global route
    reads back the sums the forward all-reduced."""

    def forward(self, x: Tensor) -> Tensor:
        world = current_world()
        frame = current_frame()
        h = x.to(torch.promote_types(x.dtype, torch.float32))
        if self.training and world.active:
            y = batch_norm(h, self, world, frame)
        elif self.training and frame is not None and frame.replaying:
            # scratch copies of the buffers take the update: the same call as
            # the forward's, so the backward finds the tensors it saved
            y = F.batch_norm(h, self.running_mean.clone(), self.running_var.clone(),
                             self.weight, self.bias, True, self.momentum, self.eps)
        else:
            y = super().forward(h)
        return y.to(x.dtype)


class BatchNorm2d(RoutedBatchNorm, nn.BatchNorm2d):
    """nn.BatchNorm2d (momentum 0.1, eps 1e-5) on the port's routes
    (``RoutedBatchNorm``); cuDNN's on the card without a process group."""


def avg_pool_2x(x: Tensor) -> Tensor:
    """2 x 2 average pool, stride 2, of a (B, C, H, W) tensor in either memory
    format (JAX models/conv.py:58-59); the nets use ``nn.AvgPool2d(2)``, the
    same call, under the reference's module names."""
    return F.avg_pool2d(x, 2, 2)


def upsample_nearest_2x(x: Tensor) -> Tensor:
    """Nearest-neighbour 2x upsample of a (B, C, H, W) tensor in either memory
    format (JAX models/conv.py:62-66; the decoder's ``nn.Upsample``)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class ResidualBlock(nn.Module):
    """Reference ResidualBlock (:38-75): BN on the branch before the add."""

    def __init__(self, inc: int, outc: int, scale: float = 1.0):
        super().__init__()
        midc = int(outc * scale)
        self.conv_expand = Conv2d(inc, outc, 1, 1, 0, bias=False) if inc != outc else None
        self.conv1 = Conv2d(inc, midc, 3, 1, 1, bias=False)
        self.bn1 = BatchNorm2d(midc)
        self.conv2 = Conv2d(midc, outc, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(outc)

    def forward(self, x: Tensor) -> Tensor:
        identity = x if self.conv_expand is None else self.conv_expand(x)
        y = F.leaky_relu(self.bn1(self.conv1(x)), 0.2)
        y = self.bn2(self.conv2(y))
        return F.leaky_relu(y + identity, 0.2)


class ConvEncoder(nn.Module):
    """(B, C, H, W), channels-last or not, -> (mu, logvar): conv5x5 stem + BN
    + LReLU + AvgPool2, then (ResBlock -> AvgPool2) per channel entry, a final
    ResBlock, FC -> 2*zdim (:78-122)."""

    def __init__(self, cdim: int = 3, zdim: int = 512,
                 channels: Sequence[int] = (64, 128, 256, 512, 512, 512), image_size: int = 256,
                 conditional: bool = False, cond_dim: int = 10,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conditional = conditional
        self.compute_dtype = compute_dtype
        cc = channels[0]
        self.main = nn.Sequential(Conv2d(cdim, cc, 5, 1, 2, bias=False), BatchNorm2d(cc),
                                  nn.LeakyReLU(0.2), nn.AvgPool2d(2))
        sz = image_size // 2
        for ch in channels[1:]:
            self.main.add_module(f"res_in_{sz}", ResidualBlock(cc, ch))
            self.main.add_module(f"down_to_{sz // 2}", nn.AvgPool2d(2))
            cc, sz = ch, sz // 2
        self.main.add_module(f"res_in_{sz}", ResidualBlock(cc, cc))
        self.conv_output_spatial = image_size // 2 ** len(channels)
        fc_in = cc * self.conv_output_spatial**2 + (cond_dim if conditional else 0)
        self.fc = nn.Linear(fc_in, 2 * zdim)
        self.to(memory_format=torch.channels_last)

    def forward(self, x: Tensor, o_cond: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
        # flatten copies the channels-last output into the reference's (C, H, W) order
        y = self.main(x.to(self.compute_dtype)).flatten(1).float()
        if self.conditional and o_cond is not None:
            y = torch.cat([y, o_cond.float()], dim=1)
        mu, logvar = self.fc(y).chunk(2, dim=1)
        return mu, logvar


class ConvDecoder(nn.Module):
    """z -> (B, C, H, W), channels-last: FC + ReLU, reshaped to the encoder's
    conv output, then (ResBlock -> nearest upsample 2x) per channel entry in
    reverse, a final ResBlock and a conv5x5 head with bias (:125-169)."""

    def __init__(self, cdim: int = 3, zdim: int = 512,
                 channels: Sequence[int] = (64, 128, 256, 512, 512, 512), image_size: int = 256,
                 conditional: bool = False, cond_dim: int = 10,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conditional = conditional
        self.compute_dtype = compute_dtype
        cc = channels[-1]
        sz = image_size // 2 ** len(channels)
        self.conv_input_shape = (cc, sz, sz)
        self.fc = nn.Sequential(nn.Linear(zdim + (cond_dim if conditional else 0), cc * sz * sz),
                                nn.ReLU(True))
        self.main = nn.Sequential()
        for ch in reversed(channels):
            self.main.add_module(f"res_in_{sz}", ResidualBlock(cc, ch))
            self.main.add_module(f"up_to_{sz * 2}", nn.Upsample(scale_factor=2, mode="nearest"))
            cc, sz = ch, sz * 2
        self.main.add_module(f"res_in_{sz}", ResidualBlock(cc, cc))
        self.main.add_module("predict", Conv2d(cc, cdim, 5, 1, 2))
        self.to(memory_format=torch.channels_last)

    def forward(self, z: Tensor, y_cond: Optional[Tensor] = None) -> Tensor:
        z = z.reshape(z.shape[0], -1).float()
        if self.conditional and y_cond is not None:
            z = torch.cat([z, y_cond.reshape(y_cond.shape[0], -1).float()], dim=1)
        y = self.fc(z).view(z.shape[0], *self.conv_input_shape)
        y = y.contiguous(memory_format=torch.channels_last)
        return self.main(y.to(self.compute_dtype)).float()


class SoftIntroVAE(nn.Module):
    """``encoder`` and ``decoder`` under the reference's names, plus a
    ``target_decoder`` for the bootstrap variant: its parameters never take a
    gradient; the trainer copies the decoder into it (train/image.py
    ``sync_target_decoder``). A container of the nets: the steps call them
    one by one (train/step.py)."""

    def __init__(self, cdim: int = 3, zdim: int = 512,
                 channels: Sequence[int] = (64, 128, 256, 512, 512, 512), image_size: int = 256,
                 conditional: bool = False, cond_dim: int = 10,
                 compute_dtype: torch.dtype = torch.float32, bootstrap: bool = False):
        super().__init__()
        kw = dict(cdim=cdim, zdim=zdim, channels=tuple(channels), image_size=image_size,
                  conditional=conditional, cond_dim=cond_dim, compute_dtype=compute_dtype)
        self.encoder = ConvEncoder(**kw)
        self.decoder = ConvDecoder(**kw)
        if bootstrap:
            self.target_decoder = ConvDecoder(**kw).requires_grad_(False)
