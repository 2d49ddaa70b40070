"""Activation checkpointing of a subnet forward (the port's counterpart of the
JAX package's ``jax.checkpoint``: soft_intro_vae_tpu/train/image.py:107-139,
train/style_step.py:109-125,160-168).

``checkpoint(fn, *args, generator=None)`` runs ``fn(*args)`` under
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``: the
forward keeps only its inputs, and the backward runs ``fn`` again to get the
activations it needs. ``jax.checkpoint`` recomputes a pure function; torch
recomputes a forward with side effects, and three of them are the port's:

  * **BatchNorm's running buffers.** A train-mode BN updates
    ``running_mean``, ``running_var`` and ``num_batches_tracked`` at every
    forward, so the recompute would update them a second time. Inside the
    recompute (``Frame.replaying``) the port's BNs (models/conv.py) normalize
    with the batch's statistics and leave the buffers as the forward left
    them: cuDNN's route makes the forward's call with scratch copies of the
    buffers, so the same function of the batch saves the same tensors.
  * **The global-batch BN's all-reduce.** In a process group a BN's
    statistics are the global batch's (parallel/collectives.py); the
    recompute would all-reduce them again, a collective the other ranks
    match only by doing the same. The forward records each BN's all-reduced
    sums in the frame (``Frame.stats``, in call order) and the recompute
    reads them back, so each BN all-reduces once a forward, and once a
    backward as before.
  * **An explicit generator.** ``preserve_rng_state`` restores only the
    default generators. The style decoder draws its noise planes from
    ``state.generator`` inside the forward, so the recompute would draw other
    planes and advance the generator a second time. With ``generator`` given,
    the forward notes the generator's state as it starts; the recompute runs
    from that state and puts the generator back where it found it, so a
    recomputed forward draws what the forward drew and the generator ends
    where a plain step leaves it.

The nets draw nothing from the default generators, so ``preserve_rng_state``
is off: it would read the CUDA generator's state, which a CUDA graph's
capture (train/graph.py) does not allow.

A forward whose inputs and parameters need no gradient (the E phase's
``fake = dec(noise)`` with the decoder frozen) saves nothing for a backward
and is never recomputed; under ``torch.no_grad`` ``fn`` runs as it is.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, List, Optional

import torch
from torch.utils.checkpoint import checkpoint as _torch_checkpoint

Tensor = torch.Tensor


class Frame:
    """One checkpointed call: the global BNs' all-reduced sums its forward
    recorded, and whether the recompute is running."""

    def __init__(self):
        self.stats: List[Tensor] = []
        self.replaying = False
        self._next = 0

    def record(self, stats: Tensor) -> None:
        self.stats.append(stats)

    def replay(self) -> Tensor:
        stats = self.stats[self._next]
        self._next += 1
        return stats


_local = threading.local()


def current_frame() -> Optional[Frame]:
    """The checkpointed call this thread is running, or None."""
    return getattr(_local, "frame", None)


@contextlib.contextmanager
def _in_frame(frame: Frame, replaying: bool):
    saved = current_frame()
    _local.frame = frame
    frame.replaying = replaying
    frame._next = 0
    try:
        yield
    finally:
        frame.replaying = False
        _local.frame = saved


def checkpoint(fn: Callable, *args, generator: Optional[torch.Generator] = None):
    """``fn(*args)``, its activations recomputed in the backward (module doc)."""
    frame = Frame()
    start = []  # the generator's state as the forward began

    @contextlib.contextmanager
    def forward_ctx():
        if generator is not None:
            start.append(generator.get_state())
        with _in_frame(frame, replaying=False):
            yield

    @contextlib.contextmanager
    def recompute_ctx():
        after = generator.get_state() if generator is not None else None
        if generator is not None:
            generator.set_state(start[0])
        try:
            with _in_frame(frame, replaying=True):
                yield
        finally:
            if generator is not None:
                generator.set_state(after)

    return _torch_checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False,
                             context_fn=lambda: (forward_ctx(), recompute_ctx()))


def maybe_checkpoint(remat: bool) -> Callable:
    """``checkpoint`` when ``remat``, else a plain call with the same signature."""
    if remat:
        return checkpoint

    def call(fn: Callable, *args, generator: Optional[torch.Generator] = None):
        return fn(*args)

    return call
