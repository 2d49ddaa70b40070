"""kernels.blur_roofline's arithmetic against hand counts: which convolutions
are blur sites, their bytes, the sites of a LOD-6 intro step at batch 32 (83
forward, 77 backward, 25.70 GB), and the reader on a hand-made trace."""

import importlib.util
import os

import pytest
import torch
import torch.nn.functional as F

from benchmark.core import harness
from benchmark.core.timing import Spans, Trace

from .conftest import tiny_style


def reader():
    path = os.path.join(harness.HERE, "metrics", "kernels.blur_roofline.py")
    spec = importlib.util.spec_from_file_location("t_blur_roofline", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _meta(*shape, dtype=torch.bfloat16, grad=False):
    return torch.empty(*shape, device="meta", dtype=dtype, requires_grad=grad)


def test_only_the_depthwise_3x3_convolutions_are_sites():
    br = reader()
    x = _meta(2, 4, 8, 8, grad=True)
    blur_k = _meta(4, 1, 3, 3)
    counter = br.BlurSites()
    with counter:
        y = F.conv2d(x, blur_k, padding=1, groups=4)                  # a site, and its backward
        z = F.conv2d(y, _meta(4, 4, 3, 3), padding=1)                 # a full conv
        z = F.conv2d(z, _meta(4, 2, 3, 3), padding=1, groups=2)       # grouped, not depthwise
        z = F.conv2d(z, _meta(4, 1, 3, 3), padding=1, stride=2, groups=4)  # strided
        z = F.conv_transpose2d(z, _meta(4, 1, 3, 3), padding=1, groups=4)  # transposed
        F.conv2d(x.detach(), blur_k, padding=1, groups=4)             # a site, no backward
        z.float().sum().backward()
    assert counter.sites == {("fwd", (2, 4, 8, 8), torch.bfloat16): 2,
                             ("bwd", (2, 4, 8, 8), torch.bfloat16): 1}


def test_site_bytes_by_hand():
    br = reader()
    assert br.site_bytes((2, 3, 4, 5), torch.bfloat16) == 2 * 120 * 2
    assert br.site_bytes((2, 3, 4, 5), torch.float32) == 2 * 120 * 4


def test_sites_of_a_lod6_b32_intro_step():
    """5 encoder passes blur in 7 blocks, 8 generator passes in 6; all but the
    E phase's fake generation have a backward: 83 forward, 77 backward."""
    br = reader()
    cfg = harness.load_json(harness.HERE, "configs", "style-ffhq256.json")
    cell = {"lod": 6, "batch": 32, "records": 8, "warmup_steps": 4, "limits": {}}
    fam = harness.family_class("style")(cfg, cell, 1, Spans(), "cpu")
    sites = br.step_sites(fam)
    assert sum(n for (d, _, _), n in sites.items() if d == "fwd") == 83
    assert sum(n for (d, _, _), n in sites.items() if d == "bwd") == 77
    planes = {s for (_, s, _) in sites}
    assert planes == {(32, 64, 256, 256), (32, 128, 128, 128), (32, 256, 64, 64),
                      (32, 512, 32, 32), (32, 512, 16, 16), (32, 512, 8, 8), (32, 512, 4, 4)}
    assert {t for (_, _, t) in sites} == {torch.bfloat16}
    total = sum(n * br.site_bytes(s, t) for (_, s, t), n in sites.items())
    assert total / 1e9 == pytest.approx(25.70, abs=0.005)


def _run(fam, ops, steps=2):
    tr = Trace()
    tr.ops = ops
    tr.steps = steps
    return harness.Run(trace=tr, fam=fam, peaks={"memory_bytes_per_s": 1e9})


def test_reader_on_a_hand_made_trace():
    br = reader()
    cfg, cell = tiny_style("bfloat16")
    fam = harness.family_class("style")(cfg, cell, 1, Spans(), "cpu")
    total = sum(n * br.site_bytes(s, t) for (_, s, t), n in br.step_sites(fam).items())
    assert total > 0
    name = "void (anonymous namespace)::blur3x3_stencil<__nv_bfloat16, 8, false>(...)"
    # two steps; the blur kernels take 4 x the bound's time in all
    secs = 2 * 4 * total / 1e9
    ops = [(name, 0.0, secs / 2 * 1e6), (name, 10.0, secs / 2 * 1e6),
           ("void fwd_kernel<...>", 20.0, 1e6)]
    assert br.read(_run(fam, ops)) == pytest.approx(25.0)
    # nothing to read without the kernel (the parent's depthwise convs), or a trace
    assert br.read(_run(fam, [("conv_depthwise2d_forward_kernel", 0.0, 5.0)])) is None
    assert br.read(harness.Run(trace=None, fam=fam)) is None
