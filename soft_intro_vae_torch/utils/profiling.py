"""Profiling hooks (port of utils/profiling.py), the same API on
torch.profiler: ``trace(log_dir)`` records a profile and writes it as a
Chrome trace (chrome://tracing, Perfetto), ``StepTimer`` gives steps/s after
a warm-up, ``annotate(name)`` names a region of the trace.

The program's own spans: ``span(name, batch=None)`` marks where the feed and
the graphed step spend host time. Each span is kept in one bounded ring
(``RING``, the last ``RING_SPANS`` records) as a ``Span``: its name, thread,
start and end on ``time.perf_counter_ns`` (the clock of ``time.perf_counter``),
its parent span on the same thread, the batch it serves where it has one,
and its time in child spans. While a torch profiler records, a span also
opens ``record_function("sivae.<name>")``, so it sits in the profile's
timeline beside the device's operations, on the profile's clock; outside a
profile nothing else is done. The profiler records the thread that started
it: the loop's spans reach its timeline, the prefetch worker's only the ring.

The spans, each read by a metric of the benchmark (``benchmark/metrics/``)
or taken out of its parent's time by one:

  * ``feed.produce`` (prefetch worker): one ``next`` of the host batches
    (read, decode, downscale, shuffle, flip), batch = the worker's count;
  * ``feed.decode`` (inside ``feed.produce``): an out-of-core folder's
    decode of one batch (data/images.py ``FolderDataset``: the thread
    pool's reads and decodes of the batch's files and their stack), batch =
    the batch's index in its epoch;
  * ``feed.put`` (prefetch worker): the put of that batch (the copy into a
    pinned buffer, the style feed's host side), same batch;
  * ``feed.slot_wait`` (inside ``feed.put``): the wait for a pinned buffer's
    last copy to end, the device's backpressure;
  * ``feed.launch`` (inside ``feed.put``): the put's CUDA calls (the side
    stream's copy, the style feed's lookup, the event record). They take
    microseconds, but wait while the loop's ``cudaGraphLaunch`` waits (on
    the H100 for most of a step), so their time is the device's pace, not
    the feed's work;
  * ``feed.wait`` (loop): the loop's hand-off from the prefetch queue (its
    ``get`` and the step stream's wait on the copy), batch = the consumer's
    count. Both counts run one past the last batch: the end of the stream is
    a ``next`` and a wait of their own;
  * ``feed.gather`` (loop): the 3D trainer's selection of one batch from
    its device-resident set (train/threed.py ``epoch_batches``: the rows of
    the epoch's permutation gathered on the device, or rotated on the host
    and copied), batch = the batch's index in its epoch;
  * ``graph.replay`` (loop): one replay of a captured step, its input copies
    and slot writes included;
  * ``graph.warmup``, ``graph.capture`` (loop): a graph's eager warm-up
    steps and its capture;
  * ``kernels.build`` (ops/cuda_build.py): a compile of kernels not built
    yet, on the thread whose first call needs them (inside the first
    ``graph.warmup``, on a checkout's first run).

How an operator reads them: note ``time.perf_counter_ns()`` before an epoch
and after it, and ``spans(t0, t1)`` gives the records that overlap it (sum
``dur_ns`` by name, or ``self_ns`` for the time outside child spans).
``spans`` raises ``SpansLost`` where the ring has dropped a record of that
stretch. ``tools/torch_capture_traces.py``'s traces carry the loop's
``sivae.*`` spans.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from typing import List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function

TRACE_FILE = "trace.json"
# ~5x the image benchmark cell's 51-s window (~1,900 steps at 6 spans each)
RING_SPANS = 1 << 16


def _activities():
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block on the host and, where there is a card, the device;
    on exit write ``log_dir/trace.json``. Yields the profiler (its
    ``key_averages()`` give time by operation and kernel)."""
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=_activities()) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def _fence(result) -> None:
    """Wait until ``result`` exists: a CUDA tensor (or a dict, list or tuple
    of them) by a device synchronize, anything else by fetching its value."""
    if isinstance(result, dict):
        result = list(result.values())
    if isinstance(result, (list, tuple)):
        for r in result:
            _fence(r)
        return
    if isinstance(result, torch.Tensor):
        if result.is_cuda:
            torch.cuda.synchronize(result.device)
        else:
            result.detach().cpu().numpy()


class StepTimer:
    """Wall-clock steps/s, the first ``warmup`` steps left out (their first
    calls build kernels, capture graphs and pick algorithms)."""

    def __init__(self, warmup: int = 3):
        self.warmup = warmup
        self.count = 0
        self.t0: Optional[float] = None

    def tick(self, result=None) -> None:
        """Call once a step, with a value of the step to wait for (optional)."""
        self.count += 1
        if self.count == self.warmup:
            if result is not None:
                _fence(result)
            self.t0 = time.perf_counter()

    def steps_per_sec(self, result=None) -> float:
        if result is not None:
            _fence(result)
        if self.t0 is None or self.count <= self.warmup:
            return float("nan")
        return (self.count - self.warmup) / (time.perf_counter() - self.t0)


def annotate(name: str):
    """A named region of the profiler's timeline."""
    return record_function(name)


# ---------------------------------------------------------------- spans --

class Span(NamedTuple):
    """One closed span (module doc); times in ``perf_counter_ns``."""

    name: str
    thread: int                # threading.get_ident() of the thread it ran on
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]      # the enclosing span's id on the same thread
    batch: Optional[int]       # the index of the batch it serves
    child_ns: int              # time inside its direct child spans

    @property
    def dur_ns(self) -> int:
        return self.end_ns - self.start_ns

    @property
    def self_ns(self) -> int:
        return self.end_ns - self.start_ns - self.child_ns


class SpansLost(LookupError):
    """The ring has dropped a record of the stretch asked for."""


class SpanRing:
    """The last ``size`` closed spans, kept as plain tuples (a ``Span`` on
    read). ``lost_ns`` is the latest end of a record dropped to make room: a
    stretch from ``t0`` is whole while ``lost_ns < t0``."""

    def __init__(self, size: int = RING_SPANS):
        self.records: collections.deque = collections.deque(maxlen=size)
        self.lost_ns = -1
        self._lock = threading.Lock()

    def append(self, rec: tuple) -> None:
        with self._lock:
            if len(self.records) == self.records.maxlen:  # the append drops the oldest
                self.lost_ns = max(self.lost_ns, self.records[0][3])
            self.records.append(rec)

    def spans(self, t0_ns: Optional[int] = None, t1_ns: Optional[int] = None) -> List[Span]:
        """The records that overlap [t0_ns, t1_ns] (either end open where
        None), in the order they closed; ``SpansLost`` where the ring no
        longer reaches back to ``t0_ns``."""
        with self._lock:
            records, lost = list(self.records), self.lost_ns
        if t0_ns is not None and lost >= t0_ns:
            raise SpansLost(f"the ring dropped a span that ended at {lost} ns, "
                            f"after the stretch's start at {t0_ns} ns")
        return [Span._make(r) for r in records if (t1_ns is None or r[2] <= t1_ns)
                and (t0_ns is None or r[3] >= t0_ns)]


RING = SpanRing()
_ids = itertools.count()
_local = threading.local()  # .top: the thread's innermost open span


class span:
    """``with span(name, batch=None):`` records the block as a ``Span`` named
    ``name`` in ``RING``, and while a torch profiler records, as
    ``record_function("sivae.<name>")``."""

    __slots__ = ("name", "batch", "id", "up", "start", "child", "rf")

    def __init__(self, name: str, batch: Optional[int] = None):
        self.name, self.batch = name, batch

    def __enter__(self) -> "span":
        self.up = getattr(_local, "top", None)
        _local.top = self
        self.id = next(_ids)
        self.child = 0
        self.rf = None
        if _autograd_profiler._is_profiler_enabled:
            self.rf = record_function("sivae." + self.name)
            self.rf.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        up = self.up
        _local.top = up
        if up is not None:
            up.child += end - self.start
        RING.append((self.name, threading.get_ident(), self.start, end, self.id,
                     None if up is None else up.id, self.batch, self.child))
        return False


def spans(t0_ns: Optional[int] = None, t1_ns: Optional[int] = None) -> List[Span]:
    """``RING``'s records that overlap [t0_ns, t1_ns] (``SpanRing.spans``)."""
    return RING.spans(t0_ns, t1_ns)
