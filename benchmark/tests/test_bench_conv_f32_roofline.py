"""kernels.conv_f32_roofline's arithmetic against hand counts: which
convolutions the kernels cover, their FLOPs forward and backward, and the
reader on a hand-made trace."""

import importlib.util
import os

import pytest
import torch
import torch.nn.functional as F

from benchmark.core import harness
from benchmark.core.timing import Spans, Trace

from .conftest import tiny_image


def reader():
    path = os.path.join(harness.HERE, "metrics", "kernels.conv_f32_roofline.py")
    spec = importlib.util.spec_from_file_location("t_conv_f32_roofline", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _meta(*shape, dtype=torch.float32, grad=False):
    return torch.empty(*shape, device="meta", dtype=dtype, requires_grad=grad)


def test_only_float32_same_stride1_convolutions_count():
    cr = reader()
    x = _meta(2, 4, 8, 8, grad=True)
    w3 = _meta(6, 4, 3, 3, grad=True)
    counter = cr.ConvFlops()
    with counter:
        y = F.conv2d(x, w3, padding=1)                                   # counted, and its backward
        F.conv2d(x.detach(), _meta(6, 4, 5, 5), padding=2)               # counted, no backward
        F.conv2d(x.detach(), _meta(6, 4, 1, 1))                          # counted (1x1)
        F.conv2d(x.detach(), w3.detach(), padding=1, stride=2)           # strided
        F.conv2d(x.detach(), w3.detach(), padding=0)                     # not "same"
        F.conv2d(x.detach(), _meta(4, 1, 3, 3), padding=1, groups=4)     # grouped
        F.conv2d(x.detach().bfloat16(), w3.detach().bfloat16(), padding=1)  # bfloat16
        y.sum().backward()
    m = 2 * 8 * 8
    fwd3, fwd5, fwd1 = 2 * m * 6 * 4 * 9, 2 * m * 6 * 4 * 25, 2 * m * 6 * 4
    assert counter.flops == fwd3 + 2 * fwd3 + fwd5 + fwd1


def test_the_image_steps_conv_flops():
    """Every conv of the tiny image step is covered: the count is step.mfu's
    float32 conv FLOPs."""
    cr = reader()
    cfg, cell = tiny_image()
    fam = harness.family_class("image")(cfg, cell, 1, Spans(), "cpu")
    mfu = harness._load("metrics", "step.mfu")
    flops = mfu.step_flops(fam)
    assert cr.step_flops(fam) == flops[("conv", torch.float32)] > 0


def _run(fam, ops, steps=2):
    tr = Trace()
    tr.ops = ops
    tr.steps = steps
    return harness.Run(trace=tr, fam=fam, peaks={"fp32": 1e9})


def test_reader_on_a_hand_made_trace():
    cr = reader()
    cfg, cell = tiny_image()
    fam = harness.family_class("image")(cfg, cell, 1, Spans(), "cpu")
    total = cr.step_flops(fam)
    names = ["void (anonymous namespace)::conv_f32_fprop_kernel<128, 128, 16, 8, 8, 4, 4>(...)",
             "void (anonymous namespace)::conv_f32_wgrad_kernel<64, 128, 16, 8, 8, 4, 4, 4>(...)"]
    # two steps; the kernels take 4 x the bound's time in all
    secs = 2 * 4 * total / 1e9
    ops = [(names[0], 0.0, secs / 4 * 1e6), (names[1], 10.0, 3 * secs / 4 * 1e6),
           ("sm80_xmma_fprop_implicit_gemm_f32f32", 20.0, 1e6)]
    assert cr.read(_run(fam, ops)) == pytest.approx(25.0)
    # nothing to read without the kernels (the parent's cuDNN convs), or a trace
    assert cr.read(_run(fam, [("sm80_xmma_fprop_implicit_gemm_f32f32", 0.0, 5.0)])) is None
    assert cr.read(harness.Run(trace=None, fam=fam)) is None
