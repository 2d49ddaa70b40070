"""Train state (port of train/state.py): both subnets, their optimizers, the
step counter, the per-phase learning rates and the random generator.

PyTorch updates in place, so a step mutates the state it is given; the
steps still return it, as the JAX steps return the new state.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn

from soft_intro_vae_torch.train import optim


@dataclasses.dataclass
class TrainState:
    model: nn.Module  # holds ``encoder`` and ``decoder`` (reference state_dict names)
    opt_e: torch.optim.Optimizer
    opt_d: torch.optim.Optimizer
    generator: torch.Generator  # on ``device``; all of the steps' random draws
    device: torch.device
    step: int = 0
    lr_e: float = 2e-4
    lr_d: float = 2e-4

    @property
    def encoder(self) -> nn.Module:
        return self.model.encoder

    @property
    def decoder(self) -> nn.Module:
        return self.model.decoder

    @classmethod
    def create(cls, model: nn.Module, *, device: torch.device, seed: int, lr_e: float = 2e-4,
               lr_d: float = 2e-4) -> "TrainState":
        model = model.to(device)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        return cls(model=model, opt_e=optim.adam(model.encoder.parameters(), lr_e),
                   opt_d=optim.adam(model.decoder.parameters(), lr_d), generator=gen,
                   device=device, lr_e=lr_e, lr_d=lr_d)

    def set_lr(self, lr_e: float, lr_d: float) -> None:
        self.lr_e, self.lr_d = lr_e, lr_d
        optim.set_lr(self.opt_e, lr_e)
        optim.set_lr(self.opt_d, lr_d)
