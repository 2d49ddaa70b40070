"""feed.host_ms_per_batch: host ms to produce one batch on the feed's
worker thread (the producer's ``next``: read, decode, downscale, shuffle and
flip), the mean over the batches begun in the window. The put is not in it:
its wait for a free pinned slot is the device's backpressure, not the feed's
work."""


def read(run):
    t0 = run.window.t0
    secs = run.spans.batch_seconds(t0, t0 + run.window.seconds)
    return 1e3 * sum(secs) / len(secs) if secs else None
