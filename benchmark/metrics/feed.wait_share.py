"""feed.wait_share: the share of the window the training loop spent waiting
on the prefetch iterator (the benchmark's host-clock span around each
``next``), in %. Layer: the feed (data/prefetch.py, data/streaming.py,
data/tfrecords.py, train/style.py ``_Feed``, data/images.py)."""


def read(run):
    t0 = run.window.t0
    return 100.0 * run.spans.wait_seconds(t0, t0 + run.window.seconds) / run.window.seconds
