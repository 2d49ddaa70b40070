"""Device selection for the port's entry points: CUDA unless asked otherwise,
and the float32 matmul precision the trainers' ``matmul_precision`` fields
set."""

from __future__ import annotations

from typing import Optional

import torch

from soft_intro_vae_torch.parallel.mesh import group_world


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``torch.device(device)``, raising if it names CUDA and none is present.

    There is no silent CPU fallback: a caller that wants the CPU says so. In
    a process group, ``cuda`` is this rank's card, ``cuda:LOCAL_RANK``: a
    rank without a card of its own raises, and so does an NCCL rank asked
    for another rank's card.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    world = group_world()
    if dev.type == "cuda" and world.active:
        if dev.index is None:
            if world.local_rank >= torch.cuda.device_count():
                raise RuntimeError(
                    f"rank {world.rank} (local rank {world.local_rank}) has no card: this "
                    f"machine has {torch.cuda.device_count()}; start no more ranks than cards")
            dev = torch.device("cuda", world.local_rank)
        elif world.backend == "nccl" and dev.index != world.local_rank:
            raise RuntimeError(f"rank {world.rank} drives cuda:{world.local_rank}, not {dev}")
    return dev


def set_matmul_precision(precision: Optional[str]) -> None:
    """A trainer's ``matmul_precision``: None keeps PyTorch's settings (by
    default cuDNN's convolutions in TF32, cuBLAS's matmuls in float32);
    "float32" turns TF32 off for both, the counterpart of the JAX field's
    full-precision matmuls; "tensorfloat32" turns it on for both."""
    if precision is None:
        return
    if precision not in ("float32", "tensorfloat32"):
        raise ValueError(f"matmul_precision must be None, 'float32' or 'tensorfloat32', "
                         f"got {precision!r}")
    tf32 = precision == "tensorfloat32"
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
