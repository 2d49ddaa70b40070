"""Device selection for the port's entry points: CUDA unless asked otherwise."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``torch.device(device)``, raising if it names CUDA and none is present.

    There is no silent CPU fallback: a caller that wants the CPU says so.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    return dev
