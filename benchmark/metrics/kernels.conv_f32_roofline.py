"""kernels.conv_f32_roofline: the image nets' float32 convolution kernels'
share of their roofline over one step, in %.

Least time: the FLOPs of the step's float32 convolutions that the kernels
run (stride 1, no dilation, one group, an odd square filter with padding
(k - 1) / 2: every conv of the image nets), at the card's float32 peak
(peaks.json; the kernels run FFMA, no tensor cores). The convolutions are
those of the benchmark's reference step on the meta device, each forward and
each backward counted by torch's FLOP formulas (torch.utils.flop_counter),
as step.mfu counts them: 2 * M * N * K for the forward, and as much again for
each gradient the backward computes. Time: the traced device time of the
kernels whose names hold KERNELS (the forward and input-gradient GEMM, the
weight-gradient GEMM, the split reduction and the weight flip), over the
traced steps. Nothing to read where no such kernel ran.
"""

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

KERNELS = ("conv_f32_",)
aten = torch.ops.aten


def _pair(v):
    return list(v) if len(v) == 2 else [v[0], v[0]]


def covered(x, w, stride, padding, dilation, transposed, groups) -> bool:
    """A float32 convolution of the kernels' geometry."""
    k = w.shape[-1]
    return (x.dtype == torch.float32 and not transposed and groups == 1 and w.dim() == 4
            and w.shape[-2] == k and k % 2 == 1 and _pair(stride) == [1, 1]
            and _pair(dilation) == [1, 1] and _pair(padding) == [(k - 1) // 2] * 2)


class ConvFlops(TorchDispatchMode):
    """FLOPs of the covered convolutions seen, forward and backward."""

    def __init__(self):
        super().__init__()
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func is aten.convolution.default:
            x, w, _, stride, padding, dilation, transposed, _, groups = args
        elif func is aten.convolution_backward.default:
            _, x, w, _, stride, padding, dilation, transposed, _, groups, _ = args
        else:
            return out
        if covered(x, w, stride, padding, dilation, transposed, groups):
            self.flops += flop_registry[func._overloadpacket](*args, **kwargs, out_val=out)
        return out


def step_flops(fam) -> int:
    counter = ConvFlops()
    with counter:
        fam.meta_step()
    return counter.flops


def read(run):
    if run.trace is None:
        return None
    secs = sum(d for name, _, d in run.trace.ops if any(k in name for k in KERNELS)) / 1e6
    if secs <= 0:
        return None
    bound = step_flops(run.fam) / run.peaks["fp32"]
    return 100.0 * bound / (secs / run.trace.steps)
