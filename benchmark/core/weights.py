"""Weights made on the device from the seed, and handed to both sides.

One ``torch.randn`` over every random leaf at once, from a generator on the
device, split into the leaves by name order and scaled by each leaf's
initialisation rule; constant leaves are fills. The program and the
reference each copy the same tensors into their own leaves.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch

Rule = Tuple[str, float]


def make(shapes: Mapping[str, Tuple[Tuple[int, ...], torch.dtype]], rules: Mapping[str, Rule],
         seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: tensor} for every leaf of ``shapes``, drawn by ``rules``."""
    names = sorted(shapes)
    random = [n for n in names if rules[n][0] == "randn"]
    total = sum(_numel(shapes[n][0]) for n in random)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for n in names:
        shape, dtype = shapes[n]
        kind, value = rules[n]
        if kind == "randn":
            k = _numel(shape)
            out[n] = (flat[at:at + k].view(shape) * value).to(dtype)
            at += k
        else:
            out[n] = torch.full(shape, value, dtype=dtype, device=device)
    return out


def _numel(shape) -> int:
    k = 1
    for s in shape:
        k *= int(s)
    return k


@torch.no_grad()
def load_into(module: torch.nn.Module, weights: Mapping[str, torch.Tensor]) -> None:
    """Copy ``weights`` into every parameter and buffer of ``module`` by name;
    the two sets of names must be the same."""
    own = dict(module.named_parameters())
    own.update(module.named_buffers())
    if set(own) != set(weights):
        raise ValueError(f"the program's leaves differ from the benchmark's weights: "
                         f"{sorted(set(own) ^ set(weights))[:8]}")
    for k, t in own.items():
        if tuple(t.shape) != tuple(weights[k].shape):
            raise ValueError(f"{k}: the program holds {tuple(t.shape)}, the weights "
                             f"{tuple(weights[k].shape)}")
        t.copy_(weights[k])
