"""The yardstick's arithmetic at small shapes against hand counts: FLOPs by
type (step.mfu), the fused norm's sites and bytes
(kernels.adain_norm_roofline), the window's percentile, the trace's busy
union."""

import importlib.util
import os

import pytest
import torch
import torch.nn.functional as F

from benchmark.core import harness
from benchmark.core.timing import Spans, Trace, percentile

from .conftest import tiny_style


def reader(name):
    path = os.path.join(harness.HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"t_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_flops_of_a_conv_and_a_matmul_by_type():
    mfu = reader("step.mfu")
    x = torch.empty(2, 3, 8, 8, device="meta", dtype=torch.bfloat16, requires_grad=True)
    w = torch.empty(5, 3, 3, 3, device="meta", dtype=torch.bfloat16, requires_grad=True)
    a = torch.empty(4, 6, device="meta")
    b = torch.empty(6, 7, device="meta")
    counter = mfu.FlopsByType()
    with counter:
        y = F.conv2d(x, w, padding=1)
        y.sum().backward()
        a @ b
    fwd = 2 * 2 * 5 * 8 * 8 * 3 * 3 * 3   # 2 x out elements x in-window MACs
    assert counter.flops[("conv", torch.bfloat16)] == 3 * fwd  # forward, dgrad, wgrad
    assert counter.flops[("matmul", torch.float32)] == 2 * 4 * 6 * 7
    peaks = {"bf16": 1e12, "tf32": 1e11, "fp32": 1e10}
    secs = mfu.least_time(counter.flops, peaks)
    assert secs == pytest.approx(3 * fwd / 1e12 + 2 * 4 * 6 * 7 / 1e10)


def test_norm_bytes_by_hand():
    nr = reader("kernels.adain_norm_roofline")
    b, c, h, w = 2, 3, 4, 4
    n, planes = b * c * h * w, b * c
    # forward, noise + AdaIN, bf16: x in, y out; bias, noise weight; the
    # noise plane; g, b in; mean, var out
    assert nr.norm_bytes("fwd", (b, c, h, w), "noise", 2) == \
        2 * n * 2 + 4 * c * 2 + 4 * b * h * w + 4 * planes * 4
    # backward, plain, f32: dy, x in, dx out; bias; mean, var, dm, dv in; sums out
    assert nr.norm_bytes("bwd", (b, c, h, w), "plain", 4) == \
        3 * n * 4 + 4 * c + 4 * planes * 8


@pytest.mark.parametrize("lod,fwd,bwd", [(2, 78, 72), (6, 182, 168)])
def test_norm_sites_of_an_intro_step(lod, fwd, bwd):
    """An intro step runs 5 encoder and 8 generator passes, 5 and 7 of them
    with a backward (the program's launches: 182 and 168 at LOD 6)."""
    nr = reader("kernels.adain_norm_roofline")
    cfg = harness.load_json(harness.HERE, "configs", "style-ffhq256.json")
    cell = {"lod": lod, "batch": 2, "records": 8, "warmup_steps": 4, "limits": {}}
    fam = harness.family_class("style")(cfg, cell, 1, Spans(), "cpu")
    sites = nr.step_sites(fam)
    per_pass = 2 * (lod + 1)
    assert sum(n for (d, _, _), n in sites.items() if d == "fwd") == 13 * per_pass == fwd
    assert sum(n for (d, _, _), n in sites.items() if d == "bwd") == 12 * per_pass == bwd


def test_step_flops_scale_with_the_batch():
    mfu = reader("step.mfu")
    cfg, cell = tiny_style("bfloat16")
    counts = []
    for batch in (2, 4):
        fam = harness.family_class("style")(cfg, dict(cell, batch=batch), 1, Spans(), "cpu")
        counts.append(mfu.step_flops(fam))
    assert set(counts[0]) == {("conv", torch.bfloat16), ("matmul", torch.float32)}
    conv = [c[("conv", torch.bfloat16)] for c in counts]
    assert conv[1] == 2 * conv[0]


def test_percentile_and_busy_union():
    assert percentile([1.0, 2.0, 3.0, 4.0, 5.0], 90) == pytest.approx(4.6)
    tr = Trace()
    tr.ops = [("a", 0.0, 10.0), ("b", 5.0, 10.0), ("c", 30.0, 5.0)]
    tr.seconds = 50e-6
    assert tr.busy_seconds() == pytest.approx(20e-6)
    assert tr.gaps() == [(15.0, 15.0)]
