"""Profiling hooks (port of utils/profiling.py), the same API on
torch.profiler: ``trace(log_dir)`` records a profile and writes it as a
Chrome trace (chrome://tracing, Perfetto), ``StepTimer`` gives steps/s after
a warm-up, ``annotate(name)`` names a region of the trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

TRACE_FILE = "trace.json"


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
