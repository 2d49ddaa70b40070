"""Starting the ranks of a data-parallel run (port of parallel/multihost.py).

The JAX package calls ``jax.distributed.initialize`` once a host and lets the
global mesh span every chip. The port starts one process per GPU, as the
reference's style launcher does (DDP over NCCL): each calls
``initialize_multihost``, which joins the process group and binds the
process to ``cuda:LOCAL_RANK``. Under ``python -m torch.distributed.run``
the arguments come from the environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``).

``backend="auto"`` is NCCL for a CUDA device and gloo for the CPU. A
two-rank run on one card (gloo carries CUDA tensors for the collectives the
port uses) is a correctness check, not a way to train.

NCCL collectives are captured into the step's CUDA graph
(train/graph.py); PyTorch's CUDA-graph notes ask for
``TORCH_NCCL_ASYNC_ERROR_HANDLING=0`` before the group starts, which
``initialize_multihost`` sets unless the caller has set it.
"""

from __future__ import annotations

import datetime
import os
from typing import Callable, Optional, TypeVar

import torch
import torch.distributed as dist

from soft_intro_vae_torch.parallel.mesh import (
    World, current_world, group_world, host_local_batch_size, make_data_mesh, unsharded)

T = TypeVar("T")
DEFAULT_TIMEOUT_S = 1800.0


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: str = "auto", device: str = "cuda",
                         local_rank: Optional[int] = None,
                         timeout_s: float = DEFAULT_TIMEOUT_S) -> World:
    """Join the process group; returns this rank's ``World``.

    ``coordinator_address``: None for torchrun's ``env://``, a ``tcp://host:port``
    coordinator or a ``file://`` store path (then ``num_processes`` and
    ``process_id`` are required). ``device`` decides the ``auto`` backend and,
    when CUDA, binds the process to ``cuda:local_rank`` (default
    ``LOCAL_RANK``, else the rank); more ranks than cards raise. ``timeout_s``
    bounds every collective, so a mismatched one fails instead of hanging."""
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    dev = torch.device(device)
    if backend == "auto":
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be auto, nccl or gloo, got {backend!r}")
    if coordinator_address is None:
        init_method = "env://"
        rank = int(os.environ.get("RANK", -1))
        if rank < 0 or "WORLD_SIZE" not in os.environ:
            raise ValueError("no coordinator given and no RANK/WORLD_SIZE in the environment: "
                             "start the ranks with python -m torch.distributed.run or pass "
                             "coordinator_address, num_processes and process_id")
    else:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs num_processes and process_id")
        init_method = coordinator_address
        if not coordinator_address.startswith(("tcp://", "file://")):
            init_method = f"tcp://{coordinator_address}"
        rank = process_id
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
    os.environ["LOCAL_RANK"] = str(local_rank)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but CUDA is not available; "
                               "pass device='cpu' for gloo ranks on the CPU")
        if backend == "nccl" and local_rank >= torch.cuda.device_count():
            raise RuntimeError(f"local rank {local_rank} needs cuda:{local_rank}, but this machine "
                               f"has {torch.cuda.device_count()} card(s): start no more ranks a "
                               "machine than it has cards")
        torch.cuda.set_device(local_rank if backend == "nccl" else dev.index or 0)
    if backend == "nccl":
        os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "0")
    kwargs = dict(backend=backend, init_method=init_method,
                  timeout=datetime.timedelta(seconds=timeout_s))
    if coordinator_address is not None:
        kwargs.update(world_size=num_processes, rank=process_id)
    dist.init_process_group(**kwargs)
    return group_world()


def check_world(num_devices: Optional[int], global_batch: Optional[int] = None) -> World:
    """The trainers' check: the world, against ``num_devices`` (None: any) and
    the global batch, which must split evenly (None: not checked). Launcher
    variables without a process group raise: the ranks would train alone,
    each on its own."""
    if int(os.environ.get("WORLD_SIZE", "1")) > 1 and not dist.is_initialized():
        raise RuntimeError("WORLD_SIZE > 1 but no process group: call "
                           "soft_intro_vae_torch.parallel.multihost.initialize_multihost() first "
                           "(the CLI does)")
    world = make_data_mesh(num_devices)
    if global_batch is not None:
        host_local_batch_size(global_batch, world)
    return world


def shutdown() -> None:
    """Leave the process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def global_data_mesh() -> World:
    """The world of every rank (the JAX package's mesh across every chip)."""
    return current_world()


def host_shard_info() -> tuple[int, int]:
    """(rank, world size), the analog of jax's (process_index, process_count)."""
    world = current_world()
    return world.rank, world.size


def is_primary() -> bool:
    """True on the rank that writes checkpoints, logs and figures (the
    reference's ``local_rank == 0`` gates, train_style_soft_intro_vae.py:
    207-218,287-299); always off the distributed route."""
    return group_world().rank == 0


def per_host_slice(n_items: int) -> slice:
    """Contiguous per-rank slice of a dataset of n_items, for streaming
    sources that each rank reads on its own; the in-memory trainers take
    their rows of every global batch instead (parallel/mesh.py)."""
    rank, world = host_shard_info()
    per = n_items // world
    return slice(rank * per, (rank + 1) * per)


def on_primary(fn: Callable[[], T]) -> T:
    """``fn()`` on rank 0 alone, off the distributed route (``unsharded``);
    the other ranks wait for it and take its result. Nothing of the steps is
    in flight meanwhile: the card is synchronised first, and the wait is one
    broadcast of the result."""
    world = group_world()
    if not world.active:
        return fn()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    out = [None]
    if world.rank == 0:
        with unsharded():
            out[0] = fn()
    dist.broadcast_object_list(out, src=0)
    return out[0]
