"""device.idle_share: 1 - (union of the device's operation intervals) /
(the traced stretch's length), in %, from torch.profiler over the stretch of
whole steps that follows the window in a ``--trace 1`` run."""


def read(run):
    if run.trace is None or run.trace.seconds <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_seconds() / run.trace.seconds)
