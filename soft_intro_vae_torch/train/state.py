"""Train state (port of train/state.py): both subnets (and the bootstrap
variant's target decoder), their optimizers, the step counter, the per-phase
learning rates and the random generator.

PyTorch updates in place, so a step mutates the state it is given; the
steps still return it, as the JAX steps return the new state.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn

from soft_intro_vae_torch.train import optim


@dataclasses.dataclass
class TrainState:
    # holds ``encoder`` and ``decoder`` (reference state_dict names), and
    # ``target_decoder`` when bootstrapping (in ``state_dict()`` with them)
    model: nn.Module
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

    @property
    def target_decoder(self) -> Optional[nn.Module]:
        """The bootstrap variant's frozen decoder (``model.target_decoder``,
        no gradient, not in either optimizer), or None."""
        return getattr(self.model, "target_decoder", None)

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

    def state_dict(self) -> dict:
        """The checkpoint payload; ``model`` is in the reference's names."""
        return {"model": self.model.state_dict(), "opt_e": self.opt_e.state_dict(),
                "opt_d": self.opt_d.state_dict(), "step": self.step, "lr_e": self.lr_e,
                "lr_d": self.lr_d, "rng": self.generator.get_state()}

    def load_state_dict(self, sd: dict) -> None:
        self.model.load_state_dict(sd["model"])
        self.opt_e.load_state_dict(sd["opt_e"])
        self.opt_d.load_state_dict(sd["opt_d"])
        self.generator.set_state(sd["rng"])
        self.step = int(sd["step"])
        self.set_lr(float(sd["lr_e"]), float(sd["lr_d"]))
