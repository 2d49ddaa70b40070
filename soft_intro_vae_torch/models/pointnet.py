"""PointNet-style Soft-IntroVAE for 3D point clouds (port of models/pointnet.py).

The module layout and ``state_dict`` names are the reference's
(soft_intro_vae_3d/models/vae.py:21-229), so a reference ``.pth`` loads
directly and ``utils/torch_compat.py`` of the JAX package reads the port's
weights. Public tensors keep the JAX package's (B, N, 3) layout; the encoder
transposes to Conv1d's (B, 3, N) inside.

Faithful quirk: the reference encoder applies ReLU *before* BatchNorm
(vae.py:104-129). PyTorch's default Linear/Conv1d init is the kaiming-uniform
that the JAX package's ``models/initializers.py`` imitates.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from soft_intro_vae_torch.parallel.collectives import batch_norm
from soft_intro_vae_torch.parallel.mesh import current_world

Tensor = torch.Tensor

CONV_CHANNELS = (64, 128, 256, 256, 512)
HIDDEN = (64, 128, 512, 1024)


class BatchNorm1d(nn.BatchNorm1d):
    """nn.BatchNorm1d whose train-mode statistics are the global batch's on
    the distributed route (parallel/collectives.py); PyTorch's otherwise."""

    def forward(self, x: Tensor) -> Tensor:
        world = current_world()
        if self.training and world.active:
            return batch_norm(x, self, world)
        return super().forward(x)


class PointNetEncoder(nn.Module):
    """(B, N, 3) -> (mu, logvar); per-point conv 3->64->128->256->256->512,
    each conv -> ReLU -> BN, global max-pool, FC 512->256, two z heads."""

    def __init__(self, z_dim: int = 128):
        super().__init__()
        layers = []
        in_ch = 3
        for ch in CONV_CHANNELS:
            layers += [nn.Conv1d(in_ch, ch, 1, bias=False), nn.ReLU(inplace=True),
                       BatchNorm1d(ch, eps=1e-5, momentum=0.1)]
            in_ch = ch
        self.conv = nn.Sequential(*layers)
        self.fc = nn.Sequential(nn.Linear(in_ch, 256), nn.ReLU(inplace=True))
        self.mu_layer = nn.Linear(256, z_dim)
        self.std_layer = nn.Linear(256, z_dim)

    def forward(self, x: Tensor) -> Tuple[Tensor, Tensor]:
        h = self.conv(x.transpose(1, 2)).amax(dim=2)
        h = self.fc(h)
        return self.mu_layer(h), self.std_layer(h)


class PointNetDecoder(nn.Module):
    """z -> (B, N, 3); MLP z->64->128->512->1024->(3*N) (vae.py:21-47)."""

    def __init__(self, z_dim: int = 128, n_points: int = 2048):
        super().__init__()
        self.n_points = n_points
        layers = []
        in_ch = z_dim
        for ch in HIDDEN:
            layers += [nn.Linear(in_ch, ch), nn.ReLU(inplace=True)]
            in_ch = ch
        layers.append(nn.Linear(in_ch, 3 * n_points))
        self.model = nn.Sequential(*layers)

    def forward(self, z: Tensor) -> Tensor:
        # the reference's channel-major view (B, 3, N), returned as (B, N, 3)
        return self.model(z.reshape(z.shape[0], -1)).view(-1, 3, self.n_points).transpose(1, 2)


class SoftIntroVAE3D(nn.Module):
    """Encoder + decoder under the reference's ``encoder.``/``decoder.`` names."""

    def __init__(self, z_dim: int = 128, n_points: int = 2048):
        super().__init__()
        self.encoder = PointNetEncoder(z_dim=z_dim)
        self.decoder = PointNetDecoder(z_dim=z_dim, n_points=n_points)
