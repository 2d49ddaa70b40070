"""LREQAdam over parameter lists (port of train/lreq_adam.py).

The reference's custom_adam.py: beta1 forced to 0 (no first moment), second
moment EMA with a bias-corrected step size (the denominator uses the raw
sqrt(v) + eps):

    v <- beta2 * v + (1 - beta2) * g^2
    p <- p - lr * (sqrt(1 - beta2^t) * g / (sqrt(v) + eps))

The per-parameter ``lr_equalization_coef`` of the reference is not needed:
the lreq layers scale explicitly at forward time (models/lreq.py). The LR is
held outside the update, as the JAX package's ``apply_updates_with_lr`` holds
it.

Every scalar the update reads lives on the parameters' device, as in the
optax transform (soft_intro_vae_tpu/train/lreq_adam.py:32-41): the step count
``t`` is an int32 0-dim tensor, the bias correction is computed from it in
float32, and the LR is a float32 0-dim tensor filled in place (the style
state shares one LR tensor between its two optimizers and fills it in its
``set_lr``). So a CUDA graph of a step (train/graph.py) reads the count, the
LR and the moments the trainer last left, and ``reset`` zeroes them in
place. The CPU and the card run the same form.

As the optax transform does for a whole tree, one step updates every
parameter of the list and counts once: a parameter that got no gradient in
this step (a block another LOD uses) is treated as having a zero gradient,
so its v decays and it does not move.
"""

from __future__ import annotations

from typing import Iterable, List, Union

import torch


class LreqAdam:
    def __init__(self, params: Iterable[torch.nn.Parameter], lr: Union[float, torch.Tensor],
                 beta2: float = 0.99, eps: float = 1e-8):
        self.params: List[torch.nn.Parameter] = list(params)
        device = self.params[0].device if self.params else torch.device("cpu")
        self.lr = (lr if isinstance(lr, torch.Tensor)
                   else torch.full((), float(lr), dtype=torch.float32, device=device))
        self.beta2 = beta2
        self.eps = eps
        self.count = torch.zeros((), dtype=torch.int32, device=device)
        self.nu = [torch.zeros_like(p, memory_format=torch.preserve_format) for p in self.params]

    def reset(self) -> None:
        """Fresh state, in place: the trainer resets on a LOD switch (lod_driver.py:111-112)."""
        self.count.zero_()
        torch._foreach_zero_(self.nu)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        b2 = self.beta2
        self.count.add_(1)
        bc2 = torch.sqrt(1.0 - torch.pow(b2, self.count.float()))
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
        torch._foreach_mul_(upd, self.lr)
        torch._foreach_sub_(params, upd)

    def state_dict(self) -> dict:
        return {"count": self.count.detach().clone(), "nu": [v.detach().clone() for v in self.nu],
                "lr": self.lr.detach().clone()}

    def load_state_dict(self, sd: dict) -> None:
        """A state saved in this form (tensors) or in the earlier one (an int
        count, a float LR), copied into this optimizer's own tensors."""
        if len(sd["nu"]) != len(self.params):
            raise ValueError(f"optimizer state holds {len(sd['nu'])} tensors for "
                             f"{len(self.params)} parameters")
        with torch.no_grad():
            self.count.copy_(torch.as_tensor(sd["count"]))
            self.lr.copy_(torch.as_tensor(sd["lr"]))
            for v, saved in zip(self.nu, sd["nu"]):
                v.copy_(saved)
