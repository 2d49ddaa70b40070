"""Equalized-learning-rate (lreq) layers, explicit scaling (port of models/lreq.py).

As in the JAX package (and the reference's explicit mode, lreq.py:86,165):
the raw weight is stored ~ N(0, 1/lrmul) and the forward multiplies it by
std = gain / sqrt(fan_in) * lrmul, and the bias by lrmul. With beta1 = 0
Adam (train/lreq_adam.py) stepping the raw weight by lr gives the implicit
mode's effective-weight step, so the optimizer needs no per-parameter tags.

PyTorch layouts: Linear weight (out, in), conv weight (out, in, kh, kw),
transposed-conv weight (in, out, kh, kw). ``dtype`` is the compute type of
the conv path: inputs and scaled weights are cast to it, as ``dtype=`` does
in the JAX layers; parameters stay float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

Tensor = torch.Tensor
SQRT2 = math.sqrt(2.0)


def _raw_weight(shape, lrmul: float) -> nn.Parameter:
    return nn.Parameter(torch.randn(shape) / lrmul)


class LreqDense(nn.Module):
    """lreq.Linear (lreq.py:52-88): y = x @ (W * std).T + b * lrmul, in float32
    or in ``dtype`` (the compute type, as the JAX layer's ``dtype=``)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 gain: float = SQRT2, lrmul: float = 1.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.lrmul = lrmul
        self.dtype = dtype
        self.std = gain / math.sqrt(in_features) * lrmul
        self.weight = _raw_weight((out_features, in_features), lrmul)
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def forward(self, x: Tensor) -> Tensor:
        bias = (self.bias * self.lrmul).to(self.dtype) if self.bias is not None else None
        return F.linear(x.to(self.dtype), (self.weight * self.std).to(self.dtype), bias)


def box_transform(w: Tensor) -> Tensor:
    """The fused-downscale kernel (lreq.py:158-160): 0.25 x the four shifted
    copies of the zero-padded kernel, k x k -> (k+1) x (k+1)."""
    w = F.pad(w, (1, 1, 1, 1))
    return 0.25 * (w[..., 1:, 1:] + w[..., :-1, 1:] + w[..., 1:, :-1] + w[..., :-1, :-1])


def shift_sum_transform(w: Tensor) -> Tensor:
    """The fused-upscale kernel (lreq.py:142-147): the plain sum of the four
    shifted copies, no 0.25 factor."""
    w = F.pad(w, (1, 1, 1, 1))
    return w[..., 1:, 1:] + w[..., :-1, 1:] + w[..., 1:, :-1] + w[..., :-1, :-1]


class LreqConv2d(nn.Module):
    """lreq.Conv2d (lreq.py:91-169); ``transform_kernel`` applies the box filter.
    (No config sets lrmul on a convolution, so it is 1 here.)"""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 0, bias: bool = True, gain: float = SQRT2,
                 transform_kernel: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.transform_kernel = transform_kernel
        self.dtype = dtype
        self.std = gain / math.sqrt(kernel_size * kernel_size * in_channels)
        self.weight = _raw_weight((out_channels, in_channels, kernel_size, kernel_size), 1.0)
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def forward(self, x: Tensor) -> Tensor:
        w = box_transform(self.weight) if self.transform_kernel else self.weight
        bias = self.bias.to(self.dtype) if self.bias is not None else None
        return F.conv2d(x.to(self.dtype), (w * self.std).to(self.dtype), bias,
                        stride=self.stride, padding=self.padding)


class LreqConvTranspose2d(nn.Module):
    """lreq.ConvTranspose2d without bias: the fused upscale of the decoder
    (stride 2, padding 1); ``transform_kernel`` sums the four shifted copies.
    fan_in is kernel^2 * in_channels (lreq.py:113)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 2, padding: int = 1, gain: float = SQRT2,
                 transform_kernel: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.transform_kernel = transform_kernel
        self.dtype = dtype
        self.std = gain / math.sqrt(kernel_size * kernel_size * in_channels)
        self.weight = _raw_weight((in_channels, out_channels, kernel_size, kernel_size), 1.0)

    def forward(self, x: Tensor) -> Tensor:
        w = shift_sum_transform(self.weight) if self.transform_kernel else self.weight
        return F.conv_transpose2d(x.to(self.dtype), (w * self.std).to(self.dtype),
                                  stride=self.stride, padding=self.padding)
