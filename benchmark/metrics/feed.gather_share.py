"""feed.gather_share: the share of the window the training loop spent
selecting its batches, in %: the program's ``feed.gather`` spans
(train/threed.py ``epoch_batches``: the epoch's rows of one batch gathered
from the device-resident set) over the window's seconds, each span counted
for its part inside the window. Read from the program's span ring (host
clock); nothing where the program records no such span or its ring no longer
reaches the window's start.
"""

from benchmark.core import program_spans


def read(run):
    t0, t1 = run.window.t0, run.window.t0 + run.window.seconds
    records = program_spans.ring(t0, t1)
    if records is None:
        return None
    secs, n = program_spans.seconds_within(records, ("feed.gather",), t0, t1)
    return 100.0 * secs / run.window.seconds if n else None
