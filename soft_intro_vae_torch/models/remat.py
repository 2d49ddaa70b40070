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

**An explicit generator under a CUDA graph.** A capture can neither read
nor set a CUDA generator's state (``get_state``, ``set_state``,
``get_offset``). ``Restarts`` carries the restart across: in an eager
warm-up step of the graph (``recording``) each checkpointed call notes its
generator's offset relative to the step's start, the same in every step of
one program; before the capture the graph clones the generator's state once
a call (``clone_state``) and registers the clones with the graph; under the
capture (``capturing``) call i's recompute swaps the generator onto clone i
(``graphsafe_set_state``) and back. Before each replay the graph sets clone
i to the generator's seed and offset plus call i's, so the recompute draws
what the forward drew, and the generator ends where the eager step leaves it.

A forward whose inputs and parameters need no gradient (the E phase's
``fake = dec(noise)`` with the decoder frozen) saves nothing for a backward
and is never recomputed; under ``torch.no_grad`` ``fn`` runs as it is.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, List, Optional, Sequence

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


class Restarts:
    """The generator restarts of one step's checkpointed calls, for a CUDA
    graph of the step (module doc): ``offsets`` from an eager step, the
    graph's ``states`` under its capture."""

    def __init__(self):
        self.offsets: List[int] = []
        self.states: Sequence[torch.Generator] = ()
        self.capturing = False
        self._base = 0
        self._used = 0

    def note(self, generator: torch.Generator) -> None:
        self.offsets.append(generator.get_offset() - self._base)

    def take(self) -> torch.Generator:
        if self._used >= len(self.states):
            raise RuntimeError(f"the capture ran more than the {len(self.states)} checkpointed "
                               f"calls with a generator of the eager steps")
        self._used += 1
        return self.states[self._used - 1]


def _restarts() -> Optional[Restarts]:
    return getattr(_local, "restarts", None)


@contextlib.contextmanager
def _with_restarts(r: Restarts):
    _local.restarts = r
    try:
        yield r
    finally:
        _local.restarts = None


def recording(generator: torch.Generator):
    """Around an eager step: ``Restarts`` whose ``offsets`` hold each
    checkpointed call's generator offset from the step's start."""
    r = Restarts()
    r._base = generator.get_offset()
    return _with_restarts(r)


@contextlib.contextmanager
def capturing(states: Sequence[torch.Generator]):
    """Around a capture: call i's recompute draws from ``states[i]``, which
    the graph registered; raises unless every state was taken."""
    r = Restarts()
    r.states, r.capturing = states, True
    with _with_restarts(r):
        yield r
    if r._used != len(states):
        raise RuntimeError(f"the capture ran {r._used} checkpointed calls with a generator, "
                           f"the eager steps {len(states)}")


def checkpoint(fn: Callable, *args, generator: Optional[torch.Generator] = None):
    """``fn(*args)``, its activations recomputed in the backward (module doc)."""
    frame = Frame()
    start = []  # the generator's state as the forward began, or its clone under a capture
    restarts = _restarts() if generator is not None else None

    @contextlib.contextmanager
    def forward_ctx():
        if restarts is not None and restarts.capturing:
            start.append(restarts.take())
        elif generator is not None:
            start.append(generator.get_state())
            if restarts is not None:
                restarts.note(generator)
        with _in_frame(frame, replaying=False):
            yield

    @contextlib.contextmanager
    def recompute_ctx():
        if generator is None:
            with _in_frame(frame, replaying=True):
                yield
            return
        graphed = isinstance(start[0], torch.Generator)
        after = generator.graphsafe_get_state() if graphed else generator.get_state()
        if graphed:
            generator.graphsafe_set_state(start[0])
        else:
            generator.set_state(start[0])
        try:
            with _in_frame(frame, replaying=True):
                yield
        finally:
            if graphed:
                generator.graphsafe_set_state(after)
            else:
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
