"""device.host_idle_share: the part of ``device.idle_share`` that waited on
the host, in %: the traced stretch's idle gaps between device operations
(``Trace.gaps``, as ``device.idle_share`` finds them) in which the program
was still issuing the work that ends them, over the stretch's length.

The rule: a gap counts, whole, where a CUDA call (a ``cuda*`` or ``cu*`` call
of the profile: ``cudaGraphLaunch``, ``cudaMemcpyAsync``, ``cudaLaunchKernel``,
...) made inside one of the program's launching spans returns within it: the
device ran out of queued work while the host was still issuing the next.
Inside is by time: the profile's events reach the reader without their
thread. The launching spans: ``sivae.graph.replay`` and ``sivae.graph.warmup`` (the
loop's calls that queue a step's work) and ``sivae.feed.put`` (the prefetch
worker's copy and its launches). What is left of ``device.idle_share`` is
idle with work queued (dependencies inside the graph, the wait on the feed's
copy event) and the stretch's two ends. The loop's spans are the profile's
own events; the worker's puts, on a thread the profiler does not record, come
from the program's span ring, moved onto the profile's clock by the offset
the stretch's replays show in both (``program_spans.ring_on_trace_clock``).

A span alone does not decide it: on the H100 the loop's replay call waits
for most of a step (its ``cudaGraphLaunch`` ~25 of the image cell's 27 ms),
so a replay span is open over most of the stretch, in-graph gaps included
(PERF.md §6). The call's return is the moment the work was queued.

The error: a gap in which a call made for other work returns by chance (a
put's copy, made ahead of its batch, while the graph runs; a call of another
thread while a launching span is open) is counted, at most one gap per such
call. The result is never above ``device.idle_share``:
the gaps are a part of the stretch's idle time. Nothing where the stretch
holds no launching span (a program that records none).
"""

import re

from benchmark.core import program_spans

LAUNCHING = ("graph.replay", "graph.warmup", "feed.put")
CUDA_CALL = re.compile(r"^cu(da)?[A-Z]")


def read(run):
    trace = run.trace
    if trace is None or trace.seconds <= 0:
        return None
    spans = [iv for name in LAUNCHING for iv in program_spans.trace_events(trace, name)]
    if not spans:
        return None
    if not program_spans.trace_events(trace, "feed.put"):
        records = program_spans.ring(run.window.t1)
        if records:
            spans += program_spans.ring_on_trace_clock(trace, records, "feed.put")
    calls = [(s, s + d) for name, s, d in trace.host if CUDA_CALL.match(name)]
    issued = [e for _, e in program_spans.contained(calls, spans)]
    gaps = trace.gaps()
    hit = program_spans.gaps_with_an_end(gaps, issued)
    idle_us = sum(length for (_, length), h in zip(gaps, hit) if h)
    return 100.0 * idle_us / 1e6 / trace.seconds
