"""Optimizers and LR schedules (port of train/optim.py).

The reference's optimizer is torch.optim.Adam (train_soft_intro_vae.py:450-451);
the JAX package re-creates its semantics with optax. The schedule stays on the
host and the LR lives in a 0-dim tensor that ``set_lr`` fills in place, as the
JAX state holds its LR outside the transform: a captured CUDA graph reads the
tensor, so a replay sees the LR the trainer last set.

On CUDA the Adam runs with ``capturable=True``: its step counts stay on the
device and the bias corrections are computed there in float32, so the update
can be captured (train/graph.py); every CUDA step, eager or replayed, uses
that form. Its LR is float32, as the JAX state's is: a float64 LR would
split each fused foreach division into one launch a parameter tensor. On the
CPU the Adam is the plain form with a float64 LR tensor, which gives the bits
of a float LR (the step size is ``lr / bc1`` in float64 either way).
"""

from __future__ import annotations

from typing import Iterable, Sequence

import torch


def adam(params: Iterable[torch.nn.Parameter], lr: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, device=None) -> torch.optim.Adam:
    """torch.optim.Adam with its LR in a tensor on ``device`` (the params'),
    capturable with a float32 LR when that device is CUDA."""
    device = torch.device(device if device is not None else "cpu")
    cuda = device.type == "cuda"
    lr_t = torch.tensor(lr, dtype=torch.float32 if cuda else torch.float64, device=device)
    return torch.optim.Adam(params, lr=lr_t, betas=(b1, b2), eps=eps, capturable=cuda)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Write ``lr`` into every group: in place where the group holds a tensor."""
    for group in optimizer.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr


def load_state_dict(optimizer: torch.optim.Optimizer, sd: dict) -> None:
    """Load an Adam state saved in either form (float or tensor LR,
    capturable or not, step counts on the host or the device) into
    ``optimizer``, which keeps its own form: its LR tensors (filled with the
    saved LR) and ``capturable`` flags, its step counts where that form keeps
    them (the params' device when capturable, the host otherwise)."""
    own = [(g["lr"], g.get("capturable", False)) for g in optimizer.param_groups]
    optimizer.load_state_dict(sd)
    for group, (lr, capturable) in zip(optimizer.param_groups, own):
        if isinstance(lr, torch.Tensor):
            lr.fill_(float(group["lr"]))
            group["lr"] = lr
        group["capturable"] = capturable
        for p in group["params"]:
            st = optimizer.state.get(p, {})
            if isinstance(st.get("step"), torch.Tensor):
                where = p.device if capturable else torch.device("cpu")
                st["step"] = st["step"].to(device=where, dtype=torch.float32)


def multistep_lr(base_lr: float, milestones: Sequence[int], gamma: float = 0.1):
    """torch MultiStepLR: lr = base * gamma^(#milestones passed). Host-side."""

    def schedule(t: int) -> float:
        n = sum(1 for m in milestones if t >= m)
        return base_lr * (gamma**n)

    return schedule
