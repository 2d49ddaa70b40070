"""The program's own spans, as the readers of ``feed.loop_wait_share``,
``feed.busy_share``, ``step.capture_s`` and ``device.host_idle_share`` see
them: the ring of ``soft_intro_vae_torch/utils/profiling.py`` (host clock,
``time.perf_counter_ns``, the window's clock) and the ``sivae.*`` events a
profiled stretch holds (the profiler's clock).

A checkout whose program records no spans has no ``profiling.spans``: every
function here then returns None, and so does each reader, rather than a
number read from nothing.
"""

from __future__ import annotations

import bisect
import statistics
from typing import List, Optional, Tuple


def ring(t0_s: float, t1_s: Optional[float] = None) -> Optional[list]:
    """The program's spans that overlap [t0_s, t1_s] (``time.perf_counter``
    seconds; no end where ``t1_s`` is None); None where the program records
    none, or where its ring no longer reaches back to ``t0_s``."""
    from soft_intro_vae_torch.utils import profiling

    read = getattr(profiling, "spans", None)
    if read is None:
        return None
    try:
        return read(round(t0_s * 1e9), None if t1_s is None else round(t1_s * 1e9))
    except profiling.SpansLost:
        return None


def overlap_ns(rec, t0_ns: int, t1_ns: int) -> int:
    """The part of a span inside [t0_ns, t1_ns]."""
    return max(0, min(rec.end_ns, t1_ns) - max(rec.start_ns, t0_ns))


def seconds_within(records, names, t0_s: float, t1_s: float) -> Tuple[float, int]:
    """Seconds of the spans named ``names`` inside [t0_s, t1_s], each span's
    own time (``self_ns``: its child spans left out) taken in the share of it
    that lies inside; and how many of ``records`` carry those names. A span
    across an end of the stretch can count its self time on the wrong side,
    at most that span's self time."""
    t0, t1 = round(t0_s * 1e9), round(t1_s * 1e9)
    hits = [r for r in records if r.name in names]
    return sum(r.self_ns * overlap_ns(r, t0, t1) / r.dur_ns
               for r in hits if r.dur_ns > 0) / 1e9, len(hits)


def trace_events(trace, name: str) -> List[Tuple[float, float]]:
    """(start_us, end_us) of each ``sivae.<name>`` event of a profiled stretch."""
    full = "sivae." + name
    return sorted((s, s + d) for n, s, d in trace.host if n == full)


def ring_on_trace_clock(trace, records, name: str) -> List[Tuple[float, float]]:
    """The ring's spans named ``name`` as (start_us, end_us) on the
    profiler's clock. The offset between the two clocks is the median over
    the stretch's replays, paired in order (the ring's ``graph.replay``
    records after the window against the profile's ``sivae.graph.replay``
    events), of the mean of the start's and the end's differences: the
    profiler's event opens a little before the ring's clock is read and
    closes a little after, and the mean cancels the two. Empty where the two
    do not pair up."""
    ours = sorted((r.start_ns, r.end_ns) for r in records if r.name == "graph.replay")
    theirs = trace_events(trace, "graph.replay")
    if not ours or len(ours) != len(theirs):
        return []
    offset = statistics.median(((ts - rs / 1e3) + (te - re / 1e3)) / 2
                               for (rs, re), (ts, te) in zip(ours, theirs))
    return [(r.start_ns / 1e3 + offset, r.end_ns / 1e3 + offset)
            for r in records if r.name == name]


def contained(calls: List[Tuple[float, float]],
              spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The calls (start_us, end_us) that lie inside one of the spans."""
    spans = sorted(spans)
    starts = [a for a, _ in spans]
    reach, top = [], float("-inf")
    for _, b in spans:  # the latest end among the spans opened so far
        top = max(top, b)
        reach.append(top)
    out = []
    for s, e in calls:
        k = bisect.bisect_right(starts, s)
        if k and reach[k - 1] >= e:
            out.append((s, e))
    return out


def gaps_with_an_end(gaps: List[Tuple[float, float]], ends: List[float]) -> List[bool]:
    """For each gap (start_us, length_us): whether one of ``ends`` falls in it."""
    ends = sorted(ends)
    return [bisect.bisect_right(ends, s + length) > bisect.bisect_right(ends, s)
            for s, length in gaps]
