"""The style nets' 3x3 blur (port of ``blur3x3``, soft_intro_vae_tpu/models/style.py:55).

The depthwise [1,2,1] x [1,2,1] / 16 filter with zero padding (reference
style_soft_intro_vae/net.py:49-60) on a (B, C, H, W) tensor, in its type. Two
implementations of one function:

  * ``blur3x3_plain``: ``F.conv2d`` with groups = C, the filter made once per
    (type, device) and kept, so that a step copies no host data to the
    device (a CUDA graph's capture forbids it). It works on either layout;
    it is the CPU path, with ``F.conv2d``'s own gradient, and on an NCHW
    copy the kernel's yardstick on the card;
  * the hand-written CUDA kernel of ``ops/blur_cuda.py``, behind ``Blur3x3``.

``Blur3x3`` is an autograd Function that saves nothing: the filter is
symmetric and the padding zero, so the input gradient is the blur of the
output gradient, ``dx = blur(dy)``, exactly. Its backward runs the same
route on ``dy`` (the kernel sums the nine terms in the order of ATen's
depthwise backward, ``flip``, so dx has its bits too).

``blur3x3``, the nets' blur, dispatches on where x lies: the kernel for a
CUDA tensor, the plain version for a CPU tensor. Both routes run
channels-last (the kernel takes nothing else): an input in another layout is
copied once and counted in ``relayouts["x"]``, and on the kernel's route an
output gradient in another layout in ``relayouts["dy"]``; the style nets'
main path keeps both at 0.
"""

from __future__ import annotations

import collections
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from soft_intro_vae_torch.ops import blur_cuda
from soft_intro_vae_torch.ops.cuda_build import channels_last, use_kernel

Tensor = torch.Tensor

# copies of a blur's input or gradient into channels-last, by "x" and "dy"
relayouts: collections.Counter = collections.Counter()

_FILTERS: Dict[Tuple[torch.dtype, torch.device], Tensor] = {}


def blur3x3_plain(x: Tensor) -> Tensor:
    """The blur as PyTorch's depthwise convolution, in x's type."""
    key = (x.dtype, x.device)
    k = _FILTERS.get(key)
    if k is None:
        f = torch.tensor([1.0, 2.0, 1.0], dtype=x.dtype)
        k = _FILTERS.setdefault(key, ((f[:, None] * f[None, :]) / 16.0).to(x.device))
    c = x.shape[1]
    return F.conv2d(x, k.expand(c, 1, 3, 3), padding=1, groups=c)


class Blur3x3(torch.autograd.Function):
    """y = blur(x) by ``impl`` ("plain" or "cuda"); dx = blur(dy) by the same
    route, the terms summed in the backward's order (``flip``). Saves no
    tensor."""

    @staticmethod
    def forward(ctx, x: Tensor, impl: str, flip: bool = False) -> Tensor:
        ctx.impl, ctx.flip = impl, flip
        return blur3x3_plain(x) if impl == "plain" else blur_cuda.blur3x3_cuda(x, flip)

    @staticmethod
    def backward(ctx, dy: Tensor):
        # autograd, not the caller, picks dy's strides
        dy = channels_last(dy, relayouts, "dy")
        return Blur3x3.apply(dy, ctx.impl, not ctx.flip), None, None


def blur3x3(x: Tensor, impl: str = "auto") -> Tensor:
    """Depthwise [1,2,1] x [1,2,1] / 16 blur (net.py:49-60), in x's type,
    channels-last. ``impl="auto"`` launches the hand-written kernel on a CUDA
    tensor and runs the plain version, ``F.conv2d``, on a CPU tensor;
    ``"plain"`` forces the plain version (comparisons only); ``"cuda"`` needs
    a CUDA tensor (``ops/cuda_build.py use_kernel``). A CUDA tensor launches
    the kernel or raises, and never falls back."""
    kernel = use_kernel(impl, x, "blur")
    x = channels_last(x, relayouts, "x")
    return Blur3x3.apply(x, "cuda") if kernel else blur3x3_plain(x)
