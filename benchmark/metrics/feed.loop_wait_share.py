"""feed.loop_wait_share: the share of the window the training loop spent in
the program's own ``feed.wait`` spans (data/prefetch.py ``device_prefetch``:
the consumer's hand-off, its ``get`` on the prefetch queue and the step
stream's wait on the batch's copy event), in %: the inside counterpart of
``feed.wait_share``, which times the benchmark's span around the whole
``next``. Read from the program's span ring (host clock); nothing where the
program records no spans or its ring no longer reaches the window's start.
"""

from benchmark.core import program_spans


def read(run):
    t0, t1 = run.window.t0, run.window.t0 + run.window.seconds
    records = program_spans.ring(t0, t1)
    if records is None:
        return None
    secs, n = program_spans.seconds_within(records, ("feed.wait",), t0, t1)
    return 100.0 * secs / run.window.seconds if n else None
