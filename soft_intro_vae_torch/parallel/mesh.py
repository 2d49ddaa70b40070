"""Data parallelism over ``torch.distributed`` (port of parallel/mesh.py).

The JAX package runs one program on 1..N chips: parameters, optimizer state
and BN statistics replicated, the batch split along its leading axis, and
GSPMD inserting the gradient all-reduce. The port runs one process per GPU
instead, each holding the whole state:

  * every rank takes its rows ``[r B/N, (r+1) B/N)`` of the GLOBAL batch
    (``shard_batch``), as the JAX single-host route feeds the global batch
    and lets the mesh shard it (soft_intro_vae_tpu/train/style.py:410);
  * every per-sample random draw is taken for the global batch from the
    generator all ranks share, and each rank keeps its rows
    (``randn_rows``), so the noise a sample sees does not depend on N;
  * the gradient all-reduce, BatchNorm over the global batch and the
    metrics' global mean are explicit collectives (parallel/collectives.py).

So an N-rank run on a global batch B computes what the 1-rank run on B does.

A process group makes the route: without one, ``current_world()`` is the
inactive world of one rank and every step runs as it did before the port
had data parallelism, with no collective. ``unsharded()`` makes the world
inactive for the work that rank 0 does alone (FID, figures): its draws are
its own and its BatchNorms local.

The JAX module's ``replicated`` and ``batch_sharding`` have no counterpart:
a rank holds the whole state and only its rows of a batch, so there is no
sharding to name. ``make_data_mesh`` is ``current_world``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
from typing import Any, Iterator, Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"

_local = threading.local()


@dataclasses.dataclass(frozen=True)
class World:
    """This process's place among the ranks: ``size`` 1 and ``backend`` None
    without a process group."""

    rank: int = 0
    size: int = 1
    local_rank: int = 0
    backend: Optional[str] = None

    @property
    def active(self) -> bool:
        """True on the distributed route (a process group, even of one rank)."""
        return self.backend is not None

    def rows(self, local_batch: int) -> slice:
        """This rank's rows of a global batch of ``size * local_batch``."""
        return slice(self.rank * local_batch, (self.rank + 1) * local_batch)


def _group_world() -> World:
    if not (dist.is_available() and dist.is_initialized()):
        return World()
    return World(rank=dist.get_rank(), size=dist.get_world_size(),
                 local_rank=int(os.environ.get("LOCAL_RANK", dist.get_rank())),
                 backend=str(dist.get_backend()))


def current_world() -> World:
    """The world of the process group, or the inactive world of one rank when
    there is none or inside ``unsharded()``."""
    if getattr(_local, "unsharded", 0):
        return World()
    return _group_world()


def group_world() -> World:
    """The process group's world, also inside ``unsharded()``."""
    return _group_world()


@contextlib.contextmanager
def unsharded() -> Iterator[None]:
    """Work of one rank alone (FID, figures): no collective, local draws."""
    _local.unsharded = getattr(_local, "unsharded", 0) + 1
    try:
        yield
    finally:
        _local.unsharded -= 1


def make_data_mesh(num_devices: Optional[int] = None) -> World:
    """The world, checked against ``num_devices`` (None: any)."""
    world = current_world()
    if num_devices is not None and num_devices != world.size:
        raise ValueError(f"num_devices={num_devices} but the world has {world.size} rank(s): start "
                         f"{num_devices} processes (python -m torch.distributed.run "
                         f"--nproc_per_node {num_devices} ...) or leave num_devices unset")
    return world


def host_local_batch_size(global_batch_size: int, world: Optional[World] = None) -> int:
    """Per-rank slice of the global batch (reference lod_driver.py:59-60
    divides the global batch by world size the same way)."""
    n = (world or current_world()).size
    if global_batch_size % n != 0:
        raise ValueError(f"global batch {global_batch_size} not divisible by {n} devices")
    return global_batch_size // n


def shard_batch(batch: Any, world: Optional[World] = None) -> Any:
    """This rank's rows of a global (B, ...) batch (numpy or torch)."""
    world = world or current_world()
    return batch[world.rows(host_local_batch_size(batch.shape[0], world))]


def shard_scan_batch(batch: Any, world: Optional[World] = None) -> Any:
    """This rank's rows of K stacked global batches, (K, B, ...) -> (K, B/N, ...)."""
    world = world or current_world()
    return batch[:, world.rows(host_local_batch_size(batch.shape[1], world))]


def randn_rows(local_batch: int, rest, *, generator: torch.Generator, device,
               dtype=torch.float32) -> torch.Tensor:
    """A (local_batch, *rest) normal draw: on the distributed route this rank's
    rows of one draw for the global batch, so every rank's generator advances
    alike; otherwise the draw itself."""
    world = current_world()
    if not world.active:
        return torch.randn((local_batch, *rest), generator=generator, device=device, dtype=dtype)
    full = torch.randn((local_batch * world.size, *rest), generator=generator, device=device,
                       dtype=dtype)
    return full[world.rows(local_batch)]


def local_rows(x: torch.Tensor, local_batch: int) -> torch.Tensor:
    """This rank's rows of an injected global draw; the draw itself off the
    distributed route."""
    world = current_world()
    if not world.active:
        return x
    if x.shape[0] != local_batch * world.size:
        raise ValueError(f"an injected draw holds the global batch: expected "
                         f"{local_batch * world.size} rows, got {x.shape[0]}")
    return x[world.rows(local_batch)]


def _state_tensors(state: Any):
    """Every tensor of a train state in a fixed order: modules' parameters
    and buffers, optimizers' state, the LR tensors."""
    import torch.nn as nn

    out = []
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if isinstance(v, nn.Module):
            out += list(v.parameters()) + list(v.buffers())
        elif isinstance(v, torch.optim.Optimizer):
            for group in v.param_groups:
                if isinstance(group["lr"], torch.Tensor):
                    out.append(group["lr"])
                for p in group["params"]:
                    st = v.state.get(p, {})
                    out += [st[k] for k in sorted(st) if isinstance(st[k], torch.Tensor)]
        elif hasattr(v, "nu") and hasattr(v, "params"):  # LreqAdam and its kin
            out += list(v.nu) + [t for t in (getattr(v, "count", None), getattr(v, "lr", None))
                                 if isinstance(t, torch.Tensor)]
        elif isinstance(v, torch.Tensor):  # the style state's LR and EMA beta
            out.append(v)
    return out


@torch.no_grad()
def shard_state(state: Any, world: Optional[World] = None) -> Any:
    """Make every rank's train state rank 0's: broadcast its parameters,
    buffers, optimizer state, host scalars and generator state, then check
    that the ranks agree. Off the distributed route the state is returned as
    it is."""
    world = world or current_world()
    if not world.active:
        return state
    from soft_intro_vae_torch.parallel import collectives

    tensors = _state_tensors(state)
    for t in tensors:
        collectives.broadcast_(t)
    scalars = [{f.name: getattr(state, f.name) for f in dataclasses.fields(state)
                if isinstance(getattr(state, f.name), (int, float))}]
    # host counts (the probes' Sgd); LreqAdam's count is a tensor, broadcast above
    counts = [getattr(getattr(state, n), "count", None) for n in ("opt_e", "opt_d")]
    scalars[0]["opt_counts"] = [c if isinstance(c, int) else None for c in counts]
    dist.broadcast_object_list(scalars, src=0)
    for name, v in scalars[0].items():
        if name == "opt_counts":
            for n, c in zip(("opt_e", "opt_d"), v):
                if c is not None:
                    getattr(state, n).count = c
        else:
            setattr(state, name, v)
    gen_state = state.generator.get_state()
    collectives.broadcast_(gen_state)
    state.generator.set_state(gen_state)
    collectives.check_replicas_agree(tensors + [gen_state])
    return state
