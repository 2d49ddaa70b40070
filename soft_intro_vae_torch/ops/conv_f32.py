"""The image nets' convolutions on their float32 route (``models/conv.py Conv2d``).

A stride-1 convolution with padding (k - 1) / 2 (every conv of the image
nets: the 5x5 stem and ``predict``, the 3x3 residual convs, the 1x1
``conv_expand``) has three routes, chosen from what a call can observe:

  * "kernel": a CUDA float32 tensor with ``torch.backends.cudnn.allow_tf32``
    off, the CelebA-HQ and CIFAR-10 configurations' stated precision. The
    hand-written implicit GEMMs of ``ops/conv_f32_cuda.py`` run the forward,
    the input gradient and the weight gradient (``ConvF32``) on channels-last
    tensors, in full float32 FFMA. On this route a CUDA tensor launches the
    kernels or raises, and never falls back;
  * "cudnn": any other CUDA call (the trainer's default TF32 route, bfloat16,
    another geometry): ``F.conv2d``, cuDNN's tensor-core kernels, as before;
  * "plain": a CPU tensor, ``F.conv2d``.

``routes`` counts the calls by route, so a run can show that its convs took
the kernels; ``relayouts`` counts the copies of an operand that was not
channels-last into that layout (the nets' main path keeps it at 0).

The kernels rest on two identities of the convolution, which ``dgrad_plain``
and ``wgrad_plain`` state in plain PyTorch (the CPU tests hold them to
``F.conv2d``'s autograd in float64):

  * the input gradient is the forward run on dy with the weight flipped in
    (r, s) and its in and out channels swapped (``flip_plain``);
  * the weight gradient is a (Cout) x (k*k*Cin) x (B*H*W) GEMM of dy and the
    patches of x, both as NHWC rows; the kernel splits its pixels over CTAs
    and sums the partial products in split order (``splits``).
"""

from __future__ import annotations

import collections
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from soft_intro_vae_torch.ops import conv_f32_cuda
from soft_intro_vae_torch.ops.cuda_build import channels_last

Tensor = torch.Tensor

# convolution calls by route: "kernel", "cudnn", "plain"
routes: collections.Counter = collections.Counter()
# copies of an operand into channels-last on the kernel's route: "x", "weight", "dy"
relayouts: collections.Counter = collections.Counter()


def _pair(v) -> Tuple[int, int]:
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def same_geometry(weight: Tensor, stride=1, padding=0, dilation=1, groups: int = 1) -> bool:
    """Whether a conv is one the kernels take: stride 1, no dilation, one
    group, an odd square filter and padding (k - 1) / 2 on both sides."""
    k = weight.shape[-1]
    return (weight.dim() == 4 and weight.shape[-2] == k and k % 2 == 1 and groups == 1
            and _pair(stride) == (1, 1) and _pair(dilation) == (1, 1)
            and _pair(padding) == ((k - 1) // 2,) * 2)


def route(x: Tensor, weight: Tensor, stride=1, padding=0, dilation=1, groups: int = 1) -> str:
    """The route of a convolution of ``x`` (module docstring)."""
    if not x.is_cuda:
        return "plain"
    if (x.dtype == torch.float32 and not torch.backends.cudnn.allow_tf32
            and same_geometry(weight, stride, padding, dilation, groups)):
        return "kernel"
    return "cudnn"


class ConvF32(torch.autograd.Function):
    """y = conv(x, weight) + bias on the hand-written kernels; the backward's
    input gradient is the forward kernel on dy with the flipped weight, its
    weight gradient the wgrad kernel, its bias gradient dy summed over the
    batch and the plane. Saves x and the weight."""

    @staticmethod
    def forward(ctx, x: Tensor, weight: Tensor, bias: Optional[Tensor]) -> Tensor:
        x = channels_last(x, relayouts, "x")
        weight = channels_last(weight, relayouts, "weight")
        ctx.save_for_backward(x, weight)
        ctx.has_bias = bias is not None
        return conv_f32_cuda.fprop(x, weight, None if bias is None else bias.contiguous())

    @staticmethod
    def backward(ctx, dy: Tensor):
        x, weight = ctx.saved_tensors
        # autograd, not the caller, picks dy's strides
        dy = channels_last(dy, relayouts, "dy")
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = conv_f32_cuda.dgrad(dy, weight)
        if ctx.needs_input_grad[1]:
            dw = conv_f32_cuda.wgrad(x, dy, weight.shape[-1])
        if ctx.has_bias and ctx.needs_input_grad[2]:
            db = dy.sum(dim=(0, 2, 3))
        return dx, dw, db


def conv2d(x: Tensor, weight: Tensor, bias: Optional[Tensor] = None, stride=1, padding=0,
           dilation=1, groups: int = 1) -> Tensor:
    """``F.conv2d`` by ``route``: the kernels on the float32, TF32-off route,
    ``F.conv2d`` (cuDNN on the card) on any other; counted in ``routes``."""
    r = route(x, weight, stride, padding, dilation, groups)
    routes[r] += 1
    if r == "kernel":
        return ConvF32.apply(x, weight, bias)
    return F.conv2d(x, weight, bias, stride, padding, dilation, groups)


# --- the kernels' algebra in plain PyTorch -----------------------------------

def flip_plain(weight: Tensor) -> Tensor:
    """The input gradient's weight: wt[c, n, r, s] = weight[n, c, k-1-r, k-1-s]."""
    return weight.flip(-2, -1).transpose(0, 1)


def dgrad_plain(dy: Tensor, weight: Tensor) -> Tensor:
    """The input gradient of a stride-1 'same' conv: the forward on dy with
    the flipped, channel-swapped weight."""
    k = weight.shape[-1]
    return F.conv2d(dy, flip_plain(weight), padding=(k - 1) // 2)


def patches(x: Tensor, ksize: int) -> Tensor:
    """The implicit GEMM's A operand: (B*H*W, k*k*Cin) rows, a pixel's row
    ordered (r, s, c) as the channels-last weight is, zeros beyond the image."""
    b, c, h, w = x.shape
    cols = F.unfold(x, ksize, padding=(ksize - 1) // 2)  # (B, C*k*k, H*W), (c, r, s) order
    cols = cols.view(b, c, ksize * ksize, h * w).permute(0, 3, 2, 1)  # (B, HW, rs, c)
    return cols.reshape(b * h * w, ksize * ksize * c)


def split_bounds(rows: int, splits: int, per_split: Optional[int] = None) -> Sequence[Tuple[int, int]]:
    """[start, end) of each split of ``rows`` reduction rows: ``per_split``
    rows each (by default as even as whole shares allow), the last ragged."""
    per = per_split if per_split is not None else -(-rows // splits)
    return [(s * per, min(rows, (s + 1) * per)) for s in range(splits) if s * per < rows]


def wgrad_plain(x: Tensor, dy: Tensor, ksize: int, splits: int = 1,
                per_split: Optional[int] = None) -> Tensor:
    """The weight gradient of a stride-1 'same' conv as the kernel forms it:
    dy's NHWC rows (B*H*W, Cout) against the patches (B*H*W, k*k*Cin), the
    pixels cut into ``splits`` shares whose partial products are summed in
    split order; returned as (Cout, Cin, k, k)."""
    b, cout, h, w = dy.shape
    cin = x.shape[1]
    rows = dy.permute(0, 2, 3, 1).reshape(b * h * w, cout)
    a = patches(x, ksize)
    total = None
    for lo, hi in split_bounds(b * h * w, splits, per_split):
        part = rows[lo:hi].t() @ a[lo:hi]
        total = part if total is None else total + part
    return total.view(cout, ksize, ksize, cin).permute(0, 3, 1, 2)
