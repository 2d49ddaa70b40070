"""PointNet-style Soft-IntroVAE for 3D point clouds (port of models/pointnet.py).

The module layout and ``state_dict`` names are the reference's
(soft_intro_vae_3d/models/vae.py:21-229), so a reference ``.pth`` loads
directly and ``utils/torch_compat.py`` of the JAX package reads the port's
weights. Public tensors keep the JAX package's (B, N, 3) layout.

The encoder runs points-major, as the JAX package does ("one big (B*N, C)
matmul", soft_intro_vae_tpu/models/pointnet.py:5-6): its per-point stack
takes the cloud as (B·N, C) rows, each ``Conv1d(k=1)`` is one GEMM of the
rows with its (out, in, 1) weight viewed as (out, in), BatchNorm normalizes
each channel over the B·N rows, and the global max-pool is over the points
axis of (B, N, C). The three products of a layer (forward, input and weight
gradients) run on cuBLAS, at the precision cuDNN would have run the Conv1d:
TF32 where ``torch.backends.cudnn.allow_tf32`` is on (PyTorch's default),
full float32 where it is off.

Faithful quirk: the reference encoder applies ReLU *before* BatchNorm
(vae.py:104-129). PyTorch's default Linear/Conv1d init is the kaiming-uniform
that the JAX package's ``models/initializers.py`` imitates.
"""

from __future__ import annotations

import contextlib
from typing import Sequence, Tuple

import torch
import torch.nn as nn

from soft_intro_vae_torch.models.conv import RoutedBatchNorm

Tensor = torch.Tensor

CONV_CHANNELS = (64, 128, 256, 256, 512)
HIDDEN = (64, 128, 512, 1024)


def _conv_tf32() -> bool:
    """Whether a float32 Conv1d would run in TF32 on the card: cuDNN's flag,
    or cuBLAS's where cuDNN is off (ATen's own convolution is a GEMM)."""
    if torch.backends.cudnn.enabled:
        return torch.backends.cudnn.allow_tf32
    return torch.backends.cuda.matmul.allow_tf32


@contextlib.contextmanager
def _cublas_tf32(allowed: bool):
    """cuBLAS's TF32 flag set to ``allowed`` inside, restored after; cuBLAS
    reads it at each call."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = allowed
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


class _PointGemm(torch.autograd.Function):
    """rows (M, in) -> rows @ W.T (M, out) for a Conv1d(k=1) weight W (out,
    in, 1); the backward's input and weight gradients are the other two
    GEMMs. All three run with cuBLAS's TF32 flag at ``tf32``, read once at
    the forward, so the backward keeps the forward's precision wherever the
    flags stand when autograd runs it."""

    @staticmethod
    def forward(ctx, rows: Tensor, weight: Tensor, tf32: bool) -> Tensor:
        with _cublas_tf32(tf32):
            y = rows.mm(weight.squeeze(2).t())
        ctx.save_for_backward(rows, weight)
        ctx.tf32 = tf32
        return y

    @staticmethod
    def backward(ctx, dy: Tensor):
        rows, weight = ctx.saved_tensors
        d_rows = d_weight = None
        with _cublas_tf32(ctx.tf32):
            if ctx.needs_input_grad[0]:
                d_rows = dy.mm(weight.squeeze(2))
            if ctx.needs_input_grad[1]:
                d_weight = dy.t().mm(rows).unsqueeze(2)
        return d_rows, d_weight, None


class _PointMax(torch.autograd.Function):
    """(B, N, C) -> (B, C), the max over the points axis, ``amax``'s forward
    and gradient: each output's gradient split evenly among the points that
    reach it. The backward forms the mask in the input's dtype and counts
    over it. ``amax``'s own backward sums a boolean mask as int64: on this
    layout, the points not innermost, it held a (B, N, C) int64 copy of the
    mask and a 272-MiB temporary at the recipe's batch of 32 on the card,
    ~0.27 GiB above the step's peak on the (B, C, N) layout."""

    @staticmethod
    def forward(ctx, h: Tensor) -> Tensor:
        y = h.amax(dim=1)
        ctx.save_for_backward(h, y)
        return y

    @staticmethod
    def backward(ctx, dy: Tensor) -> Tensor:
        h, y = ctx.saved_tensors
        mask = torch.eq(h, y.unsqueeze(1), out=torch.empty_like(h))
        return mask.mul_(dy.unsqueeze(1) / mask.sum(dim=1, keepdim=True))


class PointConv1d(nn.Conv1d):
    """The reference's ``Conv1d(in, out, 1, bias=False)``, parameters and all,
    applied to points-major rows: (M, in) -> (M, out), one GEMM (module doc)."""

    def forward(self, rows: Tensor) -> Tensor:
        return _PointGemm.apply(rows, self.weight, _conv_tf32())


class BatchNorm1d(RoutedBatchNorm, nn.BatchNorm1d):
    """nn.BatchNorm1d over the points-major rows (M, C), each channel's
    statistics over the M rows, on the port's routes (``RoutedBatchNorm``:
    the global batch's on the distributed route, the recompute's buffers
    left alone under remat)."""


class PointNetEncoder(nn.Module):
    """(B, N, 3) -> (mu, logvar); per-point conv 3->64->128->256->256->512,
    each conv -> ReLU -> BN, global max-pool, FC 512->256, two z heads.
    ``conv_channels`` are the per-point widths, as the JAX module's field."""

    def __init__(self, z_dim: int = 128, conv_channels: Sequence[int] = CONV_CHANNELS):
        super().__init__()
        layers = []
        in_ch = 3
        for ch in conv_channels:
            layers += [PointConv1d(in_ch, ch, 1, bias=False), nn.ReLU(inplace=True),
                       BatchNorm1d(ch, eps=1e-5, momentum=0.1)]
            in_ch = ch
        self.conv = nn.Sequential(*layers)
        self.fc = nn.Sequential(nn.Linear(in_ch, 256), nn.ReLU(inplace=True))
        self.mu_layer = nn.Linear(256, z_dim)
        self.std_layer = nn.Linear(256, z_dim)

    def forward(self, x: Tensor) -> Tuple[Tensor, Tensor]:
        b, n, c = x.shape
        h = self.conv(x.reshape(b * n, c))
        h = self.fc(_PointMax.apply(h.view(b, n, -1)))
        return self.mu_layer(h), self.std_layer(h)


class PointNetDecoder(nn.Module):
    """z -> (B, N, 3); MLP z->64->128->512->1024->(3*N) (vae.py:21-47);
    ``hidden`` are the MLP's widths, as the JAX module's field."""

    def __init__(self, z_dim: int = 128, n_points: int = 2048, hidden: Sequence[int] = HIDDEN):
        super().__init__()
        self.n_points = n_points
        layers = []
        in_ch = z_dim
        for ch in hidden:
            layers += [nn.Linear(in_ch, ch), nn.ReLU(inplace=True)]
            in_ch = ch
        layers.append(nn.Linear(in_ch, 3 * n_points))
        self.model = nn.Sequential(*layers)

    def forward(self, z: Tensor) -> Tensor:
        # the reference's channel-major view (B, 3, N), returned as (B, N, 3)
        return self.model(z.reshape(z.shape[0], -1)).view(-1, 3, self.n_points).transpose(1, 2)


class SoftIntroVAE3D(nn.Module):
    """Encoder + decoder under the reference's ``encoder.``/``decoder.`` names."""

    def __init__(self, z_dim: int = 128, n_points: int = 2048,
                 conv_channels: Sequence[int] = CONV_CHANNELS, hidden: Sequence[int] = HIDDEN):
        super().__init__()
        self.encoder = PointNetEncoder(z_dim=z_dim, conv_channels=conv_channels)
        self.decoder = PointNetDecoder(z_dim=z_dim, n_points=n_points, hidden=hidden)
