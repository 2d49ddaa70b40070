"""LREQAdam over parameter lists (port of train/lreq_adam.py).

The reference's custom_adam.py: beta1 forced to 0 (no first moment), second
moment EMA with a bias-corrected step size (the denominator uses the raw
sqrt(v) + eps):

    v <- beta2 * v + (1 - beta2) * g^2
    p <- p - lr * sqrt(1 - beta2^t) * g / (sqrt(v) + eps)

The per-parameter ``lr_equalization_coef`` of the reference is not needed:
the lreq layers scale explicitly at forward time (models/lreq.py). The LR is
held outside, as the JAX package's ``apply_updates_with_lr`` holds it: the
trainer writes each epoch's LR into ``lr``.

As the optax transform does for a whole tree, one step updates every
parameter of the list and counts once: a parameter that got no gradient in
this step (a block another LOD uses) is treated as having a zero gradient,
so its v decays and it does not move.
"""

from __future__ import annotations

import math
from typing import Iterable, List

import torch


class LreqAdam:
    def __init__(self, params: Iterable[torch.nn.Parameter], lr: float, beta2: float = 0.99,
                 eps: float = 1e-8):
        self.params: List[torch.nn.Parameter] = list(params)
        self.lr = lr
        self.beta2 = beta2
        self.eps = eps
        self.reset()

    def reset(self) -> None:
        """Fresh state: the trainer resets on a LOD switch (lod_driver.py:111-112)."""
        self.count = 0
        self.nu = [torch.zeros_like(p, memory_format=torch.preserve_format) for p in self.params]

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        self.count += 1
        b2 = self.beta2
        bc2 = math.sqrt(1.0 - b2 ** self.count)
        have = [i for i, p in enumerate(self.params) if p.grad is not None]
        idle = [self.nu[i] for i, p in enumerate(self.params) if p.grad is None]
        if idle:
            torch._foreach_mul_(idle, b2)
        if not have:
            return
        params = [self.params[i] for i in have]
        grads = [self.params[i].grad for i in have]
        nus = [self.nu[i] for i in have]
        torch._foreach_mul_(nus, b2)
        torch._foreach_addcmul_(nus, grads, grads, value=1.0 - b2)
        denom = torch._foreach_sqrt(nus)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_mul(grads, bc2)
        torch._foreach_div_(upd, denom)
        torch._foreach_add_(params, upd, alpha=-self.lr)

    def state_dict(self) -> dict:
        return {"count": self.count, "nu": [v.detach().clone() for v in self.nu], "lr": self.lr}

    def load_state_dict(self, sd: dict) -> None:
        if len(sd["nu"]) != len(self.params):
            raise ValueError(f"optimizer state holds {len(sd['nu'])} tensors for "
                             f"{len(self.params)} parameters")
        self.count = int(sd["count"])
        self.lr = float(sd["lr"])
        with torch.no_grad():
            for v, saved in zip(self.nu, sd["nu"]):
                v.copy_(saved)
