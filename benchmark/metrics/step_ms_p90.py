"""step_ms_p90: the 90th percentile of the times of all steps completed in
the window, each from the previous step's end event (the window's start for
the first) to its own."""

from benchmark.core.timing import percentile


def read(run):
    times = run.window.step_ms()
    return percentile(times, 90) if times else None
