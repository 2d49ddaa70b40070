"""kernels.blur_roofline: the style nets' 3x3 blur kernel's share of its
roofline over one step, in %.

Least time: the bytes the step's blurs must move at the card's memory rate
(peaks.json): at every blur site of the step's LOD, forward and backward,
the input (x or dy) read once and the output (y or dx) written once, in the
type the site runs in (the conv path's). The sites are the grouped 3x3
convolutions with one filter a channel in the benchmark's reference step,
run on the meta device: each forward, and each backward that asks for the
input's gradient, counted by a dispatch mode. Time: the traced device time
of the kernels whose names hold KERNELS, over the traced steps. Nothing to
read where no such kernel ran.
"""

import collections

import torch
from torch.utils._python_dispatch import TorchDispatchMode

KERNELS = ("blur3x3_stencil",)
aten = torch.ops.aten


def _is_blur(x, w, stride, transposed, groups) -> bool:
    return (not transposed and list(stride) == [1, 1] and groups == x.shape[1] == w.shape[0]
            and tuple(w.shape[1:]) == (1, 3, 3))


class BlurSites(TorchDispatchMode):
    """Blur sites seen, keyed by (direction, shape, dtype)."""

    def __init__(self):
        super().__init__()
        self.sites = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is aten.convolution.default:
            x, w, _, stride, _, _, transposed, _, groups = args
            if _is_blur(x, w, stride, transposed, groups):
                self.sites[("fwd", tuple(x.shape), x.dtype)] += 1
        elif func is aten.convolution_backward.default:
            _, x, w, _, stride, _, _, transposed, _, groups, mask = args
            if mask[0] and _is_blur(x, w, stride, transposed, groups):
                self.sites[("bwd", tuple(x.shape), x.dtype)] += 1
        return func(*args, **kwargs)


def site_bytes(shape, dtype) -> int:
    """Bytes one site must move: its input read once, its output written once."""
    n = 1
    for s in shape:
        n *= s
    return 2 * n * torch.finfo(dtype).bits // 8


def step_sites(fam):
    counter = BlurSites()
    with counter:
        fam.meta_step()
    return counter.sites


def read(run):
    if run.trace is None:
        return None
    secs = sum(d for name, _, d in run.trace.ops if any(k in name for k in KERNELS)) / 1e6
    if secs <= 0:
        return None
    total = sum(n * site_bytes(s, t) for (_, s, t), n in step_sites(run.fam).items())
    bound = total / run.peaks["memory_bytes_per_s"]
    return 100.0 * bound / (secs / run.trace.steps)
