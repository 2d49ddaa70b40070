"""Input-pipeline overlap: a worker thread puts host batches on the device
ahead of the step (port of soft_intro_vae_tpu/data/prefetch.py).

The reference overlaps input with compute through DataLoader workers. Here a
small thread runs ``put_fn`` on each host batch and keeps ``size`` device
batches in flight, so the host's gather and the copy overlap the running
step. ``device_put_fn(device)`` is the put for a CUDA device: the batch is
copied into a pinned host buffer, then to the card with a non-blocking copy
on a side stream, and an event marks the copy's end; the consumer's stream
waits on that event before the step reads the batch. uint8 batches ship as
uint8, one byte a pixel; the step normalizes them (ops/u8norm.py), or the
put does on its side stream (the style feed, train/style.py). On the CPU
the put is a plain copy.

Spans (utils/profiling.py): the worker records each batch's production
(``feed.produce``) and put (``feed.put``, and inside it ``feed.slot_wait``,
a wait for a pinned buffer still being copied out of, and ``feed.launch``,
the put's CUDA calls), the consumer each hand-off from the queue
(``feed.wait``).
"""

from __future__ import annotations

import collections
import itertools
import queue
import threading
from typing import Callable, Iterable, Iterator, List, Optional

import numpy as np
import torch

from soft_intro_vae_torch.utils.device import resolve_device
from soft_intro_vae_torch.utils.profiling import span


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


class HostRings:
    """Host staging buffers: a ring of ``slots`` buffers per (shape, dtype),
    kept for the ``keys`` pairs used last.

    A slot is ``[buffer, event]``: its buffer is handed out again only after
    the event recorded behind its last copy has completed. A pair past the
    ``keys`` used last is dropped once its copies have ended: the style
    trainer's batch shape changes with each LOD and its transition epochs
    add float32 batches, and without the bound the pinned memory would grow
    with the LOD ladder.
    """

    def __init__(self, slots: int = 2, keys: int = 2, pin: bool = True):
        self.slots = slots
        self.keys = keys
        self.pin = pin
        self.rings: "collections.OrderedDict[tuple, List[list]]" = collections.OrderedDict()
        self.turn: dict = {}

    def slot(self, shape, dtype) -> list:
        """The next ``[buffer, event]`` of (shape, dtype)'s ring, its last copy ended."""
        dtype = np.dtype(dtype)
        key = (tuple(shape), dtype.str)
        if key in self.rings:
            self.rings.move_to_end(key)
        else:
            while len(self.rings) >= self.keys:
                old, ring = self.rings.popitem(last=False)
                del self.turn[old]
                for _, done in ring:
                    if done is not None:
                        done.synchronize()
            self.rings[key] = []
        ring = self.rings[key]
        i = self.turn.get(key, 0)
        self.turn[key] = (i + 1) % self.slots
        if len(ring) <= i:
            buf = torch.empty(key[0], dtype=torch.from_numpy(np.empty(0, dtype)).dtype,
                              pin_memory=self.pin)
            ring.append([buf, None])
        if ring[i][1] is not None:
            with span("feed.slot_wait"):  # the previous copy out of this buffer has ended
                ring[i][1].synchronize()
        return ring[i]


class _PinnedPut:
    """Host batch -> CUDA tensor through pinned buffers (``HostRings``), a
    side stream and an event.

    ``then``, where given, is device work on the copied tensor, queued on the
    side stream behind the copy (the style feed's normalize): the event
    marks its end, and its result is the ``Transfer``'s tensor.
    """

    def __init__(self, device: torch.device, slots: int = 2):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.rings = HostRings(slots)

    def __call__(self, batch: np.ndarray, then: Optional[Callable] = None) -> Transfer:
        batch = np.asarray(batch)
        slot = self.rings.slot(batch.shape, batch.dtype)
        buf = slot[0]
        np.copyto(buf.numpy(), batch)
        with span("feed.launch"), torch.cuda.stream(self.stream):
            out = torch.empty(buf.shape, dtype=buf.dtype, device=self.device)
            out.copy_(buf, non_blocking=True)
            if then is not None:
                out = then(out)
            done = torch.cuda.Event()
            done.record(self.stream)
        slot[1] = done
        return Transfer(out, done)


def device_put_fn(device="cuda") -> Callable[[np.ndarray], object]:
    """The put of a host batch onto ``device``: pinned buffer, side-stream
    copy and event for CUDA (a ``Transfer``); a plain copy for the CPU."""
    device = resolve_device(device)
    if device.type == "cuda":
        return _PinnedPut(device)
    return lambda batch: torch.from_numpy(np.array(batch, copy=True))


def _ready(item):
    """``item`` with each ``Transfer`` in it (itself, or a tuple's member)
    made ready for the current stream."""
    if isinstance(item, Transfer):
        return item.ready()
    if isinstance(item, tuple):
        return tuple(_ready(i) for i in item)
    return item


def _settle(item) -> None:
    """Wait until each copy of ``item``'s ``Transfer``s has ended."""
    if isinstance(item, Transfer):
        item.event.synchronize()
    elif isinstance(item, tuple):
        for i in item:
            _settle(i)


def device_prefetch(batches: Iterable, size: int = 2,
                    put_fn: Optional[Callable] = None) -> Iterator:
    """Wrap a host-batch iterable: a worker thread applies ``put_fn`` (default
    ``device_put_fn("cuda")``) and keeps ``size`` device batches in flight.
    Yields what the put returns, each ``Transfer`` in it (itself or a tuple's
    member) ready for the consumer's current stream; an exception in the
    worker is raised in the consumer.

    Closing the generator (``contextlib.closing``; an exception in the
    consumer's loop) stops the worker after the batch in hand and waits for
    it to end and for every copy it queued, so none is left in flight.
    """
    put_fn = put_fn or device_put_fn("cuda")
    q: "queue.Queue" = queue.Queue(maxsize=size)
    sentinel = object()
    stop = threading.Event()
    err: list = []

    def worker():
        try:
            it = iter(batches)
            for i in itertools.count():
                with span("feed.produce", i):
                    b = next(it, sentinel)
                if b is sentinel or stop.is_set():
                    break
                with span("feed.put", i):
                    item = put_fn(b)
                q.put(item)
        except BaseException as e:  # propagate to the consumer
            err.append(e)
        finally:
            q.put(sentinel)

    t = threading.Thread(target=worker, name="device_prefetch", daemon=True)
    t.start()
    try:
        for i in itertools.count():
            with span("feed.wait", i):
                item = q.get()
                if item is not sentinel:
                    item = _ready(item)
            if item is sentinel:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()
        while t.is_alive():  # a worker blocked on the full queue takes its put back
            try:
                _settle(q.get(timeout=0.05))
            except queue.Empty:
                pass
        t.join()
        while not q.empty():
            _settle(q.get_nowait())
