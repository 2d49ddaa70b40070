"""step.mfu: the whole step's share of the card's peak, in %.

Model FLOPs: the matmuls and convolutions of one step of the benchmark's own
reference at the cell's shapes, run once on the meta device (no data, no
recompute), counted by torch's FLOP formulas (torch.utils.flop_counter) op
by op, with the type each runs in on the card: the conv path in the
configuration's compute type. Each op's FLOPs are weighed by the peak of its
type (peaks.json): bfloat16 at the bf16 peak; float32 convolutions at the
TF32 peak where cuDNN may use TF32 (PyTorch's default, which the image
recipe keeps), else at the float32 peak; float32 matmuls at the float32 peak
unless cuBLAS may use TF32. The step's least time is their sum; the metric is
steps completed in the window x that least time / the window's seconds.
"""

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

CONV_OPS = ("convolution", "convolution_backward", "_convolution")


class FlopsByType(TorchDispatchMode):
    """FLOPs of each op torch counts, keyed by (conv or matmul, dtype)."""

    def __init__(self):
        super().__init__()
        self.flops = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in flop_registry:
            n = flop_registry[packet](*args, **kwargs, out_val=out)
            first = next(a for a in args if isinstance(a, torch.Tensor))
            kind = "conv" if packet.__name__ in CONV_OPS else "matmul"
            key = (kind, first.dtype)
            self.flops[key] = self.flops.get(key, 0) + n
        return out


def least_time(flops, peaks) -> float:
    conv32 = peaks["tf32"] if torch.backends.cudnn.allow_tf32 else peaks["fp32"]
    mm32 = peaks["tf32"] if torch.backends.cuda.matmul.allow_tf32 else peaks["fp32"]
    secs = 0.0
    for (kind, dtype), n in flops.items():
        if dtype in (torch.bfloat16, torch.float16):
            secs += n / peaks["bf16"]
        else:
            secs += n / (conv32 if kind == "conv" else mm32)
    return secs


def step_flops(fam):
    counter = FlopsByType()
    with counter:
        fam.meta_step()
    return counter.flops


def read(run):
    if run.steps == 0:
        return None
    secs = least_time(step_flops(run.fam), run.peaks)
    return 100.0 * run.steps * secs / run.window.seconds
