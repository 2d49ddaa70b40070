"""The collectives of the port's data-parallel route (no JAX counterpart:
GSPMD inserts them into the JAX program).

  * ``GradReducer``: after each ``backward()`` and before the optimizer's
    step, the phase's gradients all-reduced once, as one flat float32
    buffer, and divided by N. The buffer is allocated at the first call, so
    a CUDA graph that captures the step keeps its address;
  * ``batch_norm``: BatchNorm over the global batch, as the JAX package's
    BN under a data-sharded mesh (soft_intro_vae_tpu/parallel/mesh.py:13-17):
    per channel the local sum and sum of squares as one 2C vector,
    all-reduced once a forward, flax's variance E[x^2] - E[x]^2 clamped at
    0; the backward all-reduces the two per-channel sums of the gradient
    once, so a rank's input gradient is that of the sum of all ranks' losses.
    The tensors stay float32; the per-channel sums are accumulated and
    all-reduced in float64, so where a rank's batch is cut does not show in
    the last bits of a cancelling sum (a BN weight's gradient is one): in
    float32 two ranks' deltas differed from one rank's by up to 1.3e-5
    (relative L2) after one SGD(lr=1) intro step at channels (8, 16), in
    float64 by 1.6e-6;
  * ``all_reduce_metrics``: the global mean of a step's metrics, one
    all-reduce of the stacked row;
  * ``global_mean``: the global mean of a per-rank mean, no gradient.

The BatchNorm's autograd Function is the port's all-reduce with autograd:
torch.distributed.nn.functional's warns that it is deprecated.

Each wrapper adds one to ``calls[kind]`` where it issues its collective and
nowhere else, so a step graph's launches can be counted as the kernels'
are (train/graph.py). Off the distributed route (parallel/mesh.py) every
function here is a no-op or the local computation, and issues nothing.
"""

from __future__ import annotations

import collections
from typing import Dict, Iterable, List

import torch
import torch.distributed as dist

from soft_intro_vae_torch.parallel.mesh import World, current_world, group_world

Tensor = torch.Tensor

# collectives issued, by kind
calls: collections.Counter = collections.Counter()
KINDS = ("grads", "bn_fwd", "bn_bwd", "metrics", "dlatent")


def _all_reduce_(t: Tensor, kind: str) -> Tensor:
    """Sum ``t`` over the ranks in place, counted under ``kind``."""
    calls[kind] += 1
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t


def _staged(t: Tensor, world: World) -> Tensor:
    """``t`` where the backend can move it: NCCL moves only CUDA tensors."""
    if world.backend == "nccl" and not t.is_cuda:
        return t.to(torch.device("cuda", torch.cuda.current_device()))
    return t


@torch.no_grad()
def broadcast_(t: Tensor, src: int = 0) -> Tensor:
    """Rank ``src``'s value into ``t`` on every rank, in place."""
    world = group_world()
    buf = _staged(t, world)
    dist.broadcast(buf, src=src)
    if buf is not t:
        t.copy_(buf)
    return t


@torch.no_grad()
def check_replicas_agree(tensors: Iterable[Tensor]) -> None:
    """Raise unless every rank holds the same values: each tensor's float64
    sum and sum of squares, their maximum and minimum over the ranks equal."""
    world = group_world()
    tensors = list(tensors)
    if not tensors:
        return
    dev = torch.device("cuda", torch.cuda.current_device()) if world.backend == "nccl" else None
    rows = []
    for t in tensors:
        d = t.detach().double()
        rows.append(torch.stack([d.sum(), (d * d).sum()]).to(dev or "cpu"))
    hi = torch.cat(rows)
    lo = hi.clone()
    dist.all_reduce(hi, op=dist.ReduceOp.MAX)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN)
    bad = torch.nonzero(hi != lo).flatten().tolist()
    if bad:
        raise RuntimeError(f"the ranks' states differ in {len(bad)} of {len(rows)} tensor "
                           f"statistics (first: tensor {bad[0] // 2})")


class GradReducer:
    """One flat-buffer all-reduce of the gradients a phase left (module doc)."""

    def __init__(self):
        self.buffers: Dict[tuple, Tensor] = {}

    @torch.no_grad()
    def __call__(self, params: Iterable[torch.nn.Parameter]) -> None:
        world = current_world()
        if not world.active:
            return
        have: List[torch.nn.Parameter] = [p for p in params if p.grad is not None]
        if not have:
            return
        key = tuple(id(p) for p in have)
        buf = self.buffers.get(key)
        if buf is None:
            buf = torch.empty(sum(p.numel() for p in have), dtype=torch.float32,
                              device=have[0].device)
            self.buffers[key] = buf
        views = [v.view(p.shape) for v, p in zip(buf.split([p.numel() for p in have]), have)]
        grads = [p.grad for p in have]
        torch._foreach_copy_(views, grads)
        _all_reduce_(buf, "grads")
        buf.div_(world.size)
        torch._foreach_copy_(grads, views)


def all_reduce_metrics(metrics: Dict[str, Tensor]) -> Dict[str, Tensor]:
    """The ranks' mean of each 0-dim metric, one all-reduce of the stacked row."""
    world = current_world()
    if not world.active:
        return metrics
    names = list(metrics)
    row = torch.stack([metrics[k].detach().float() for k in names])
    _all_reduce_(row, "metrics")
    row.div_(world.size)
    return dict(zip(names, row.unbind()))


@torch.no_grad()
def global_mean(t: Tensor) -> Tensor:
    """The ranks' mean of ``t`` (a per-rank mean over equal shards), no gradient."""
    world = current_world()
    if not world.active:
        return t
    t = t.detach().clone()
    _all_reduce_(t, "dlatent")
    return t.div_(world.size)


def _bcast(v: Tensor, dim: int) -> Tensor:
    return v.view((1, -1) + (1,) * (dim - 2))


class _GlobalBatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm over every rank's rows, float32 (module doc)."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, num_batches_tracked,
                momentum: float, eps: float, world_size: int, frame):
        c, dims = x.shape[1], (0,) + tuple(range(2, x.dim()))
        f64 = torch.float64
        replaying = frame is not None and frame.replaying
        if replaying:  # a checkpoint's recompute: the sums its forward all-reduced
            stats = frame.replay()
        else:
            stats = torch.cat([x.sum(dims, dtype=f64), (x * x).sum(dims, dtype=f64)])
            _all_reduce_(stats, "bn_fwd")
            if frame is not None:
                frame.record(stats)
        n = x.numel() // c * world_size
        mean64 = stats[:c] / n
        mean = mean64.float()
        var = (stats[c:] / n - mean64 * mean64).clamp_min(0.0).float()  # flax's fast variance
        invstd = torch.rsqrt(var + eps)
        y = (x - _bcast(mean, x.dim())) * _bcast(weight * invstd, x.dim()) + _bcast(bias, x.dim())
        if not replaying:
            # torch.nn.BatchNorm's update: the unbiased variance, n the global count
            running_mean.mul_(1.0 - momentum).add_(mean, alpha=momentum)
            running_var.mul_(1.0 - momentum).add_(var * (n / max(n - 1, 1)), alpha=momentum)
            num_batches_tracked.add_(1)
        ctx.save_for_backward(x, mean, invstd, weight)
        ctx.n, ctx.dims = n, dims
        return y

    @staticmethod
    def backward(ctx, dy):
        x, mean, invstd, weight = ctx.saved_tensors
        c, d = x.shape[1], x.dim()
        xhat = (x - _bcast(mean, d)) * _bcast(invstd, d)
        f64 = torch.float64
        local = torch.cat([dy.sum(ctx.dims, dtype=f64), (dy * xhat).sum(ctx.dims, dtype=f64)])
        total = _all_reduce_(local.clone(), "bn_bwd")
        mean_dy, mean_dy_xhat = (total[:c] / ctx.n).float(), (total[c:] / ctx.n).float()
        dx = (dy - _bcast(mean_dy, d) - xhat * _bcast(mean_dy_xhat, d)) * _bcast(weight * invstd, d)
        return dx, local[c:].float(), local[:c].float(), None, None, None, None, None, None, None


def batch_norm(x: Tensor, bn: torch.nn.modules.batchnorm._BatchNorm, world: World,
               frame=None) -> Tensor:
    """``bn``'s train-mode forward over the global batch of ``world``; float32
    ``x``. The running statistics of ``bn`` take the global statistics.

    ``frame``: the checkpointed call running (models/remat.py). Its forward
    records the all-reduced sums; its recompute reads them back, issues no
    collective and leaves the running statistics alone."""
    return _GlobalBatchNorm.apply(x, bn.weight, bn.bias, bn.running_mean, bn.running_var,
                                  bn.num_batches_tracked, bn.momentum, bn.eps, world.size, frame)
