"""MLP Soft-IntroVAE for the 2D toy distributions (port of models/mlp.py).

The reference's Simple trio (soft_intro_vae_2d/train_soft_intro_vae_2d.py:
402-483): ReLU MLPs of ``n_layers`` hidden layers, the encoder's output split
into (mu, logvar). The layers keep the reference's state_dict names
(``main.input``, ``main.hidden_{i}``, ``main.output``), which the JAX
package's ``convert_mlp`` (soft_intro_vae_tpu/utils/torch_compat.py:210-217)
reads. ``nn.Linear``'s default init is the distribution of the JAX package's
``torch_kaiming_uniform`` weights and ``torch_bias_uniform(fan_in)`` biases.

The reference decoder carries a ``loggamma`` parameter that takes no gradient
and changes nothing (:432). The port leaves it out, as the JAX package does;
a reference state_dict that holds it still loads, with the key dropped and
named in a warning.
"""

from __future__ import annotations

import warnings
from collections import OrderedDict
from typing import Tuple

import torch
import torch.nn as nn

Tensor = torch.Tensor


def _mlp(in_dim: int, out_dim: int, n_layers: int, num_hidden: int) -> nn.Sequential:
    layers = OrderedDict([("input", nn.Linear(in_dim, num_hidden)), ("act0", nn.ReLU())])
    for i in range(1, n_layers + 1):
        layers[f"hidden_{i}"] = nn.Linear(num_hidden, num_hidden)
        layers[f"act_{i}"] = nn.ReLU()
    layers["output"] = nn.Linear(num_hidden, out_dim)
    return nn.Sequential(layers)


class EncoderMLP(nn.Module):
    """x -> (mu, logvar); EncoderSimple (:402-421)."""

    def __init__(self, x_dim: int = 2, z_dim: int = 2, n_layers: int = 2, num_hidden: int = 64):
        super().__init__()
        self.main = _mlp(x_dim, 2 * z_dim, n_layers, num_hidden)

    def forward(self, x: Tensor) -> Tuple[Tensor, Tensor]:
        mu, logvar = self.main(x).chunk(2, dim=-1)
        return mu, logvar


class DecoderMLP(nn.Module):
    """z -> x_hat; DecoderSimple (:424-444), without ``loggamma``."""

    def __init__(self, x_dim: int = 2, z_dim: int = 2, n_layers: int = 2, num_hidden: int = 64):
        super().__init__()
        self.main = _mlp(z_dim, x_dim, n_layers, num_hidden)
        self._register_load_state_dict_pre_hook(_drop_loggamma)

    def forward(self, z: Tensor) -> Tensor:
        return self.main(z.reshape(z.shape[0], -1))


def _drop_loggamma(state_dict, prefix, *args, **kwargs) -> None:
    key = prefix + "loggamma"
    if key in state_dict:
        del state_dict[key]
        warnings.warn(f"dropped {key!r}: the reference decoder's unused loggamma "
                      "has no counterpart in the port")


class SoftIntroVAESimple(nn.Module):
    """The 2D model: ``encoder`` and ``decoder`` under the reference's names."""

    def __init__(self, x_dim: int = 2, z_dim: int = 2, n_layers: int = 2, num_hidden: int = 64):
        super().__init__()
        self.encoder = EncoderMLP(x_dim, z_dim, n_layers, num_hidden)
        self.decoder = DecoderMLP(x_dim, z_dim, n_layers, num_hidden)
