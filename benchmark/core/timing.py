"""The measured window, the feed's spans, and the traced stretch.

Window: after set-up the device is synchronised, an event is recorded and
the host clock read; steps run until the host clock has passed the window's
length. A step counts when its completion, a CUDA event recorded after it,
falls inside the window on the device's clock. Nothing synchronises inside
the window but the program's own NaN check.

Spans: the benchmark's own host-clock spans around the calls into the feed:
each wait of the loop on the prefetch iterator, and on the worker thread
each batch's production (read, decode, downscale, shuffle, flip: the
producer's ``next``). The put is left out: its wait for a free pinned slot
is the device's backpressure, which reads the step's time in a cell the
device bounds.

Trace: ``torch.profiler`` over a stretch of whole steps after the window,
read from its raw device records: busy time as the union of the device's
operation intervals, operation time by name, and the longest idle gaps
labelled by the host span open at their start.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Dict, Iterator, List, Tuple

import torch


class Spans:
    """Host-clock spans of the feed, kept in memory."""

    def __init__(self):
        self.waits: List[Tuple[float, float]] = []
        self.batches: List[Tuple[float, float]] = []  # (start, seconds) of each production
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def wait(self):
        t0 = time.perf_counter()
        with torch.profiler.record_function("bench.feed_wait"):
            yield
        self.waits.append((t0, time.perf_counter()))

    def producer(self, it: Iterator) -> Iterator:
        """``it`` with the time to make each item recorded (worker thread)."""
        it = iter(it)
        while True:
            t0 = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            with self._lock:
                self.batches.append((t0, time.perf_counter() - t0))
            yield item

    def wait_seconds(self, t0: float, t1: float) -> float:
        """Seconds the loop waited on the feed within [t0, t1]."""
        return sum(max(0.0, min(b, t1) - max(a, t0)) for a, b in self.waits)

    def batch_seconds(self, t0: float, t1: float) -> List[float]:
        """Host seconds to produce each batch whose production started in [t0, t1]."""
        return [s for a, s in self.batches if t0 <= a <= t1]


class Window:
    """Steps completed in a window of ``seconds`` (module doc). Off the card
    (the harness's own tests) a step's end is the host clock's."""

    def __init__(self, seconds: float, cuda: bool = True):
        self.seconds, self.cuda = seconds, cuda
        self.events: list = []
        self.t0 = self.t1 = 0.0
        self.start = None

    def open(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record()
        self.t0 = time.perf_counter()

    def mark(self) -> bool:
        """Record a step's end; True while the window is open."""
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events.append(ev)
        else:
            self.events.append(time.perf_counter())
        return time.perf_counter() - self.t0 < self.seconds

    def close(self) -> None:
        self.t1 = time.perf_counter()
        if self.cuda:
            torch.cuda.synchronize()

    def ends_ms(self) -> List[float]:
        """Device ms from the window's start to each step's end."""
        if self.cuda:
            return [self.start.elapsed_time(e) for e in self.events]
        return [(t - self.t0) * 1e3 for t in self.events]

    def counted(self) -> int:
        limit = self.seconds * 1e3
        return sum(1 for t in self.ends_ms() if t <= limit)

    def step_ms(self) -> List[float]:
        """Each counted step's time: from the previous step's end (or the start)."""
        ends = [t for t in self.ends_ms() if t <= self.seconds * 1e3]
        return [b - a for a, b in zip([0.0] + ends[:-1], ends)]


def percentile(values: List[float], q: float) -> float:
    """The q-th percentile by linear interpolation between order statistics."""
    v = sorted(values)
    if not v:
        return float("nan")
    pos = (len(v) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


class Trace:
    """A profiled stretch of whole steps, reduced to what the readers need."""

    def __init__(self):
        self.ops: List[Tuple[str, float, float]] = []    # (name, start_us, dur_us) on the device
        self.host: List[Tuple[str, float, float]] = []   # host spans of the benchmark and torch
        self.seconds = 0.0
        self.steps = 0

    @classmethod
    def record(cls, run_steps: Callable[[int], None], steps: int, cuda: bool = True) -> "Trace":
        from torch.profiler import ProfilerActivity, profile

        tr = cls()
        sync = torch.cuda.synchronize if cuda else (lambda: None)
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        sync()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            run_steps(steps)
            sync()
            tr.seconds = time.perf_counter() - t0
        tr.steps = steps
        for e in prof.profiler.kineto_results.events():
            start, dur = e.start_ns() / 1e3, e.duration_ns() / 1e3
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                if not e.is_user_annotation():
                    tr.ops.append((e.name(), start, dur))
            else:
                tr.host.append((e.name(), start, dur))
        return tr

    def busy_seconds(self) -> float:
        """Union of the device's operation intervals."""
        busy, end = 0.0, None
        for _, s, d in sorted(self.ops, key=lambda o: o[1]):
            if end is None or s > end:
                busy += d
                end = s + d
            elif s + d > end:
                busy += s + d - end
                end = s + d
        return busy / 1e6

    def op_seconds(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, _, d in self.ops:
            out[name] = out.get(name, 0.0) + d / 1e6
        return out

    def gaps(self) -> List[Tuple[float, float]]:
        """(start_us, length_us) of each idle stretch between device operations."""
        out, end = [], None
        for _, s, d in sorted(self.ops, key=lambda o: o[1]):
            if end is not None and s > end:
                out.append((end, s - end))
            end = s + d if end is None else max(end, s + d)
        return out

    def label(self, t_us: float) -> str:
        """The innermost benchmark span open on the host at ``t_us``, else the
        innermost host operation, else "host"."""
        spans = [(d, name) for name, s, d in self.host if s <= t_us <= s + d]
        ours = [sp for sp in spans if sp[1].startswith("bench.")]
        pick = min(ours or spans, default=None)
        return pick[1] if pick else "host"

    def breakdown(self) -> dict:
        ops = sorted(self.op_seconds().items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.gaps(), key=lambda g: -g[1])[:10]
        return {"device_ops": [[n[:120], s] for n, s in ops],
                "idle_gaps": [[self.label(s), d / 1e6] for s, d in gaps]}


@contextlib.contextmanager
def step_span():
    with torch.profiler.record_function("bench.step"):
        yield
