"""kernels.adain_norm_roofline: the fused noise+AdaIN norm's share of its
roofline over one step, in %.

Least time: the bytes the step's norm work must move at the card's memory
rate (peaks.json), forward and backward at every norm site of the step's
LOD: each input read once and each output written once (x, y, dy, dx in the
conv path's type, the rest float32), the sites and their shapes found by
running the benchmark's reference step on the meta device. Time: the traced
device time of the kernels that implement the norm (KERNELS, matched in the
trace's kernel names) over the traced steps. Nothing to read where no such
kernel ran.
"""

import collections

import torch

KERNELS = ("fwd_kernel", "bwd_kernel")


def norm_bytes(direction: str, shape, mode: str, elem: int) -> int:
    """Bytes one site must move: each input read once, each output written once."""
    bsz, ch, h, w = shape
    planes, n = bsz * ch, bsz * ch * h * w
    affine = mode == "noise"   # the decoder's sites carry AdaIN's g and b
    side = 4 * ch * (2 if mode == "noise" else 1) + (4 * bsz * h * w if mode == "noise" else 0)
    if direction == "fwd":  # x in, y out; g, b in; mean, var out
        return 2 * n * elem + side + 4 * planes * (2 * affine + 2)
    # dy, x in, dx out; g, mean, var, dm, dv in; four per-plane sums out
    return 3 * n * elem + side + 4 * planes * (affine + 4 + 4)


def step_sites(fam):
    sites = collections.Counter()

    def hook(direction, shape, mode):
        sites[(direction, shape, mode)] += 1

    fam.meta_step(hook=hook)
    return sites


def read(run):
    if run.trace is None:
        return None
    secs = sum(d for name, _, d in run.trace.ops if any(k in name for k in KERNELS)) / 1e6
    if secs <= 0:
        return None
    elem = torch.finfo(run.fam.compute_dtype).bits // 8
    total = sum(n * norm_bytes(d, s, m, elem) for (d, s, m), n in step_sites(run.fam).items())
    bound = total / run.peaks["memory_bytes_per_s"]
    return 100.0 * bound / (secs / run.trace.steps)
