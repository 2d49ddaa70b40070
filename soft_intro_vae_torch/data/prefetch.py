"""Input-pipeline overlap: a worker thread puts host batches on the device
ahead of the step (port of soft_intro_vae_tpu/data/prefetch.py).

The reference overlaps input with compute through DataLoader workers. Here a
small thread runs ``put_fn`` on each host batch and keeps ``size`` device
batches in flight, so the host's gather and the copy overlap the running
step. ``device_put_fn(device)`` is the put for a CUDA device: the batch is
copied into a pinned host buffer, then to the card with a non-blocking copy
on a side stream, and an event marks the copy's end; the consumer's stream
waits on that event before the step reads the batch. uint8 batches ship as
uint8, one byte a pixel; the step normalizes them (ops/u8norm.py). On the
CPU the put is a plain copy.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from soft_intro_vae_torch.utils.device import resolve_device


class Transfer:
    """A device tensor whose copy is still in flight on a side stream."""

    __slots__ = ("tensor", "event")

    def __init__(self, tensor: torch.Tensor, event: torch.cuda.Event):
        self.tensor = tensor
        self.event = event

    def ready(self) -> torch.Tensor:
        """The tensor, once the current stream has been made to wait for the
        copy; the caching allocator is told the current stream uses it, so
        its memory is not handed out again while the step still reads it."""
        stream = torch.cuda.current_stream(self.tensor.device)
        stream.wait_event(self.event)
        self.tensor.record_stream(stream)
        return self.tensor


class _PinnedPut:
    """Host batch -> CUDA tensor through pinned buffers, a side stream and an event.

    Each (shape, dtype) keeps a ring of ``slots`` pinned buffers. A buffer is
    written again only after the event recorded behind its last copy has
    completed, so a copy never reads a buffer the worker is refilling.
    """

    def __init__(self, device: torch.device, slots: int = 2):
        self.device = device
        self.slots = slots
        self.stream = torch.cuda.Stream(device)
        self.rings: Dict[Tuple, List] = {}
        self.turn: Dict[Tuple, int] = {}

    def __call__(self, batch: np.ndarray) -> Transfer:
        batch = np.asarray(batch)
        key = (batch.shape, batch.dtype.str)
        ring = self.rings.setdefault(key, [])
        i = self.turn.get(key, 0)
        self.turn[key] = (i + 1) % self.slots
        if len(ring) <= i:
            dtype = torch.from_numpy(np.empty(0, batch.dtype)).dtype
            ring.append([torch.empty(batch.shape, dtype=dtype, pin_memory=True), None])
        buf, last = ring[i]
        if last is not None:
            last.synchronize()  # the previous copy out of this buffer has ended
        np.copyto(buf.numpy(), batch)
        with torch.cuda.stream(self.stream):
            out = torch.empty(buf.shape, dtype=buf.dtype, device=self.device)
            out.copy_(buf, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.stream)
        ring[i][1] = done
        return Transfer(out, done)


def device_put_fn(device="cuda") -> Callable[[np.ndarray], object]:
    """The put of a host batch onto ``device``: pinned buffer, side-stream
    copy and event for CUDA (a ``Transfer``); a plain copy for the CPU."""
    device = resolve_device(device)
    if device.type == "cuda":
        return _PinnedPut(device)
    return lambda batch: torch.from_numpy(np.array(batch, copy=True))


def device_prefetch(batches: Iterable, size: int = 2,
                    put_fn: Optional[Callable] = None) -> Iterator[torch.Tensor]:
    """Wrap a host-batch iterable: a worker thread applies ``put_fn`` (default
    ``device_put_fn("cuda")``) and keeps ``size`` device batches in flight.
    Yields tensors ready for the consumer's current stream; an exception in
    the worker is raised in the consumer."""
    put_fn = put_fn or device_put_fn("cuda")
    q: "queue.Queue" = queue.Queue(maxsize=size)
    sentinel = object()
    err: list = []

    def worker():
        try:
            for b in batches:
                q.put(put_fn(b))
        except BaseException as e:  # propagate to the consumer
            err.append(e)
        finally:
            q.put(sentinel)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is sentinel:
            if err:
                raise err[0]
            return
        yield item.ready() if isinstance(item, Transfer) else item
