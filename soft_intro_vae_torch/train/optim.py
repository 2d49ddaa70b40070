"""Optimizers and LR schedules (port of train/optim.py).

The reference's optimizer is torch.optim.Adam (train_soft_intro_vae.py:450-451);
the JAX package re-creates its semantics with optax. The schedule stays on the
host: the trainer writes each epoch's LR into the optimizer's param_groups.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import torch


def adam(params: Iterable[torch.nn.Parameter], lr: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=lr, betas=(b1, b2), eps=eps)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def multistep_lr(base_lr: float, milestones: Sequence[int], gamma: float = 0.1):
    """torch MultiStepLR: lr = base * gamma^(#milestones passed). Host-side."""

    def schedule(t: int) -> float:
        n = sum(1 for m in milestones if t >= m)
        return base_lr * (gamma**n)

    return schedule
