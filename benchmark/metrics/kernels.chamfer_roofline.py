"""kernels.chamfer_roofline: the chamfer search kernel's share of its
roofline over one step, in %.

Least time: the operations of every chamfer call of the step at half the
card's FP32 rate (peaks.json): B x N x M pairs a call, 8 FP32 operations a
pair (three differences, three squares, two adds; the minima's compares are
not counted), the count behind the kernel's bound in PERF.md §6. Half the
rate, since the data sheet's FP32 rate counts an FMA as two operations and
the kernel, bit-equal to the difference form, issues none. The calls and
their shapes are found by running the benchmark's reference step on the
meta device, each call told to its hook (as ``kernels.adain_norm_roofline``
finds its sites). Time: the traced device time of the kernel (KERNELS,
matched in the trace's kernel names) over the traced steps. Nothing to read
where no such kernel ran.
"""

import collections

KERNELS = ("nearest_pair_kernel",)
OPS_A_PAIR = 8


def step_calls(fam) -> collections.Counter:
    """The step's chamfer calls by (B, N, M)."""
    calls = collections.Counter()

    def hook(kind, shape):
        if kind == "chamfer":
            calls[tuple(shape)] += 1

    fam.meta_step(hook=hook)
    return calls


def step_ops(calls) -> int:
    return sum(n * OPS_A_PAIR * b * rows * cols for (b, rows, cols), n in calls.items())


def read(run):
    if run.trace is None:
        return None
    secs = sum(d for name, _, d in run.trace.ops if any(k in name for k in KERNELS)) / 1e6
    if secs <= 0:
        return None
    bound = step_ops(step_calls(run.fam)) / (run.peaks["fp32"] / 2)
    return 100.0 * bound / (secs / run.trace.steps)
