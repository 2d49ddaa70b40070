"""uint8 NHWC -> float32 (B, C, H, W) in [0, 1], channels-last in memory (port of
soft_intro_vae_tpu/ops/u8norm.py).

The reference feeds images normalized on the host as ``x.astype(f32) / 255``
(soft_intro_vae/dataset.py:129-134), and the JAX package reproduces those
bits on the device. So does the port, with two implementations that give
the same bits:

  * ``u8_to_unit_nchw_plain``: float64 division rounded once to float32. The
    binary expansion of i/255 never terminates, so no rounding tie can arise
    and the double rounding is exact; it is the CPU path and the oracle the
    kernel is held to on the card;
  * the hand-written CUDA kernel of ``ops/u8norm_cuda.py``.

PyTorch's ``x.float() / 255`` on the card is not one of them: ATen divides
a tensor by a scalar as a multiply by its reciprocal there.

Both keep the host's NHWC byte order: the result is the (B, C, H, W) view
of an NHWC buffer, ``is_contiguous(memory_format=torch.channels_last)``, the
layout the image nets run in (models/conv.py), as the JAX package's nets
take NHWC.
"""

from __future__ import annotations

import torch

from soft_intro_vae_torch.ops import u8norm_cuda

Tensor = torch.Tensor
IMPLS = ("auto", "plain", "cuda")


def u8_to_unit_nchw_plain(x: Tensor) -> Tensor:
    """(B, H, W, C) uint8 -> (B, C, H, W) float32 with channels-last strides,
    ``x / 255`` correctly rounded."""
    u8norm_cuda.check_input(x)
    return (x.double() / 255).float().permute(0, 3, 1, 2)


def u8_to_unit_nchw(x: Tensor, impl: str = "auto") -> Tensor:
    """(B, H, W, C) uint8 -> (B, C, H, W) float32, channels-last in memory.
    ``impl="auto"`` launches the kernel on a CUDA tensor and runs the plain
    version on a CPU tensor; ``"plain"`` forces the plain version (comparisons
    only); ``"cuda"`` needs a CUDA tensor."""
    if impl not in IMPLS:
        raise NotImplementedError(f"unknown u8norm impl: {impl!r}")
    if impl == "cuda" and not x.is_cuda:
        raise ValueError("impl='cuda' needs a CUDA tensor")
    if impl == "plain" or not x.is_cuda:
        return u8_to_unit_nchw_plain(x)
    return u8norm_cuda.u8_to_unit_nchw_cuda(x)
