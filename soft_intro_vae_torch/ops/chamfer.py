"""Chamfer distance for point clouds (ports ops/chamfer.py + ops/chamfer_pallas.py).

Reference ChamferLoss (soft_intro_vae_3d/losses/chamfer_loss.py:5-35): for
clouds preds (B, N, 3) and gts (B, M, 3) the per-sample loss (B,) is

    sum_j min_i ||gts_i - preds_j||^2  +  sum_i min_j ||gts_i - preds_j||^2.

The nearest-neighbour search, both directions from one distance block, has
two implementations with the same bits: ``nearest_pair_plain`` (PyTorch ops,
the CPU path and the oracle) and the CUDA kernel in ``ops/chamfer_cuda.py``
(one launch per chamfer call). Both compute the difference form
(dx*dx + dy*dy) + dz*dz, not xx + yy - 2xy, and keep the first index on ties.
``ChamferDistance`` adds the analytic backward of the JAX package's
``_chamfer_bwd`` (chamfer_pallas.py:128-140) from the saved argmins.
"""

from __future__ import annotations

from typing import Tuple

import torch

from soft_intro_vae_torch.ops import chamfer_cuda

Tensor = torch.Tensor
IMPLS = ("auto", "plain", "cuda")


def pairwise_sqdist(a: Tensor, b: Tensor) -> Tensor:
    """(B, N, 3), (B, M, 3) -> (B, N, M) squared distances in the difference form.

    One elementwise op at a time, so no step is fused into an FMA; the CUDA
    kernel rounds each step the same way.
    """
    a = a.float()
    b = b.float()
    dx = a[:, :, None, 0] - b[:, None, :, 0]
    dy = a[:, :, None, 1] - b[:, None, :, 1]
    dz = a[:, :, None, 2] - b[:, None, :, 2]
    return (dx * dx + dy * dy) + dz * dz


def nearest_plain(a: Tensor, b: Tensor) -> Tuple[Tensor, Tensor]:
    """(min, argmin) over b for every point of a: (B, N) f32 and (B, N) int64."""
    return pairwise_sqdist(a, b).min(dim=2)


def nearest_pair_plain(x: Tensor, y: Tensor) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """(min_x, amin_x, min_y, amin_y) from one distance block: per point of x
    over y, (B, N), and per point of y over x, (B, M); int64 argmins, first
    index on ties. The halves have the bits of ``nearest_plain(x, y)`` and
    ``nearest_plain(y, x)``: x - y is exactly -(y - x), so the squares agree."""
    d = pairwise_sqdist(x, y)
    min_x, amin_x = d.min(dim=2)
    min_y, amin_y = d.min(dim=1)
    return min_x, amin_x, min_y, amin_y


def _resolve_impl(impl: str, t: Tensor) -> str:
    if impl not in IMPLS:
        raise NotImplementedError(f"unknown chamfer impl: {impl!r}")
    if impl == "auto":
        return "cuda" if t.is_cuda else "plain"
    if impl == "cuda" and not t.is_cuda:
        raise ValueError("impl='cuda' needs CUDA tensors")
    return impl


def nearest_pair(x: Tensor, y: Tensor, impl: str = "auto") -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Both directions' nearest points, through one kernel launch on CUDA tensors."""
    if _resolve_impl(impl, x) == "cuda":
        return chamfer_cuda.nearest_pair_cuda(x.float().contiguous(), y.float().contiguous())
    return nearest_pair_plain(x, y)


class ChamferDistance(torch.autograd.Function):
    """Per-sample chamfer loss (B,) with the analytic backward."""

    @staticmethod
    def forward(ctx, preds: Tensor, gts: Tensor, impl: str = "auto") -> Tensor:
        # x = gts, as in the JAX package's _chamfer_fwd_impl: min_g per gt
        # over preds, min_p per pred over gts
        min_g, amin_g, min_p, amin_p = nearest_pair(gts, preds, impl)
        ctx.save_for_backward(preds, gts, amin_g, amin_p)
        return min_g.sum(dim=1) + min_p.sum(dim=1)

    @staticmethod
    def backward(ctx, g: Tensor):
        preds, gts, amin_g, amin_p = ctx.saved_tensors
        ig = amin_g[..., None].expand(-1, -1, 3)
        ip = amin_p[..., None].expand(-1, -1, 3)
        d_gts_direct = 2.0 * (gts - torch.gather(preds, 1, ig))
        d_preds_direct = 2.0 * (preds - torch.gather(gts, 1, ip))
        # CUDA scatter_add_ sums in no fixed order: gradients agree with the
        # JAX package to a tolerance, not bit for bit
        d_preds_scatter = torch.zeros_like(preds).scatter_add_(1, ig, -d_gts_direct)
        d_gts_scatter = torch.zeros_like(gts).scatter_add_(1, ip, -d_preds_direct)
        gb = g[:, None, None]
        return gb * (d_preds_direct + d_preds_scatter), gb * (d_gts_direct + d_gts_scatter), None


def chamfer_distance(preds: Tensor, gts: Tensor, impl: str = "auto") -> Tensor:
    """Reference-parity chamfer loss (B,).

    ``impl="auto"`` runs the CUDA kernel on CUDA tensors and ``nearest_plain``
    on CPU tensors; ``"plain"`` forces the PyTorch version (comparisons only);
    ``"cuda"`` requires CUDA tensors.
    """
    _resolve_impl(impl, preds)
    return ChamferDistance.apply(preds.float(), gts.float(), impl)
