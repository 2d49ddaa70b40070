"""feed.busy_share: the share of the window the feed's worker spent working,
in %: the program's ``feed.produce`` spans (each batch's ``next``: read,
decode, downscale, shuffle, flip) and the self time of its ``feed.put`` spans
(the copy into a pinned buffer, the style feed's host side), over the
window's seconds. Two children of a put are left out: ``feed.slot_wait``, the
wait for a pinned buffer still being copied out of (the device's
backpressure), and ``feed.launch``, the put's CUDA calls, which wait while
the loop's ``cudaGraphLaunch`` blocks on the H100 and so read the device's
pace (their own cost is microseconds). Each span counts for its part inside
the window: the inside counterpart of ``feed.host_ms_per_batch``, with the
put's host work added. 100% is a worker with no slack: the feed sets the
pace. Read from the program's span ring (host clock); nothing where the
program records no spans or its ring no longer reaches the window's start.
"""

from benchmark.core import program_spans


def read(run):
    t0, t1 = run.window.t0, run.window.t0 + run.window.seconds
    records = program_spans.ring(t0, t1)
    if records is None:
        return None
    work, n = program_spans.seconds_within(records, ("feed.produce", "feed.put"), t0, t1)
    return 100.0 * work / run.window.seconds if n else None
