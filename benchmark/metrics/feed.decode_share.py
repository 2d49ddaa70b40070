"""feed.decode_share: the share of the window the feed spent decoding an
out-of-core folder's batches, in %: the program's ``feed.decode`` spans
(data/images.py ``FolderDataset.epoch``: the thread pool's reads and
decodes of one batch's files and their stack, on the prefetch worker inside
its ``feed.produce``) over the window's seconds, each span counted for its
part inside the window. Read from the program's span ring (host clock);
nothing where the program records no such span or its ring no longer
reaches the window's start.
"""

from benchmark.core import program_spans


def read(run):
    t0, t1 = run.window.t0, run.window.t0 + run.window.seconds
    records = program_spans.ring(t0, t1)
    if records is None:
        return None
    secs, n = program_spans.seconds_within(records, ("feed.decode",), t0, t1)
    return 100.0 * secs / run.window.seconds if n else None
