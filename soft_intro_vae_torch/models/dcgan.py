"""DCGAN encoder/generator pair (port of models/dcgan.py).

The reference's registered but unused DCGAN nets (style_soft_intro_vae/
net.py:613-671), as the JAX package builds them: z = 24 and 32x32x3 images;
the generator takes z through four stride-2 transposed convolutions with
BatchNorm + ReLU and a tanh, the encoder takes an image through four strided
convolutions with BatchNorm + LeakyReLU(0.2) and a LeakyReLU(0.01) head.
Every convolution has a bias (PyTorch's default init, which the JAX
package's initializers imitate); BatchNorm keeps PyTorch's momentum 0.1 and
eps 1e-5 (flax's momentum 0.9). Each net is one ``main`` Sequential, in the
order of the JAX layers; ``utils/from_jax.py dcgan_state_dict_from_jax``
carries the JAX trees across. Layout NCHW.
"""

from __future__ import annotations

import torch
import torch.nn as nn

Tensor = torch.Tensor
NZ = 24


class DCGANGenerator(nn.Module):
    """z (B, 24) -> (B, 3, 32, 32) in [-1, 1] (net.py:613-641)."""

    def __init__(self, nz: int = NZ, nc: int = 3):
        super().__init__()
        self.nz = nz
        self.main = nn.Sequential(
            nn.ConvTranspose2d(nz, 512, 4, 1, 0), nn.BatchNorm2d(512), nn.ReLU(True),
            nn.ConvTranspose2d(512, 256, 4, 2, 1), nn.BatchNorm2d(256), nn.ReLU(True),
            nn.ConvTranspose2d(256, 128, 4, 2, 1), nn.BatchNorm2d(128), nn.ReLU(True),
            nn.ConvTranspose2d(128, nc, 4, 2, 1), nn.Tanh())

    def forward(self, z: Tensor) -> Tensor:
        return self.main(z.reshape(z.shape[0], self.nz, 1, 1))


class DCGANEncoder(nn.Module):
    """(B, 3, 32, 32) -> (B, 24) (net.py:644-671)."""

    def __init__(self, nz: int = NZ, nc: int = 3):
        super().__init__()
        self.main = nn.Sequential(
            nn.Conv2d(nc, 64, 4, 2, 1), nn.BatchNorm2d(64), nn.LeakyReLU(0.2, True),
            nn.Conv2d(64, 128, 4, 2, 1), nn.BatchNorm2d(128), nn.LeakyReLU(0.2, True),
            nn.Conv2d(128, 256, 4, 2, 1), nn.BatchNorm2d(256), nn.LeakyReLU(0.2, True),
            nn.Conv2d(256, nz, 4, 1, 0), nn.LeakyReLU(0.01, True))

    def forward(self, x: Tensor) -> Tensor:
        return self.main(x).reshape(x.shape[0], -1)
