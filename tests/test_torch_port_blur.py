"""The style nets' 3x3 blur: ops/blur.py (the plain route and the autograd
Function), ops/blur_cuda.py (the kernel's launch plan and binding) and
csrc/blur3x3.cu.

On the CPU:
  * the Function's plain route against ``F.conv2d``, forward and gradient,
    in float32 and bfloat16; ``gradcheck`` (and ``gradgradcheck``) in float64;
  * the dispatcher: a CPU tensor takes ``F.conv2d`` as before, the nets call
    it, wrong routes raise;
  * the launch plan at every image of 1x1 to 256x256 (and odd ones) x C 1-512
    x B 1-128, walked as the kernel walks it: every output element written
    once, every element it reads inside the image or a zero of the padding,
    and the plan within the C entry point's checks;
  * the kernel's symbol and C signature: the name free of the fused norm's
    ``fwd_kernel``/``bwd_kernel`` (which the norm's roofline metric matches),
    the binding's argument list as long as the C function's;
  * the first build compiles the blur and the fused norm together.

On the card (``cuda`` marker; skipped here, decided inside each test): the
kernel on channels-last tensors against ``F.conv2d`` forward and input
gradient on NCHW copies at every LOD-6 b32 site in bfloat16 and float32, bit
for bit; the graphed LOD-6 style step
against its eager twin, bit for bit, with the blur's launches held to the
step's sites (83 forward, 77 backward an intro step). This file imports no
JAX, so on the card it runs as ``python -m pytest --noconftest -p
no:cacheprovider -m cuda tests/test_torch_port_blur.py``.
"""

import math
import os
import re

import pytest
import torch
import torch.nn.functional as F

from soft_intro_vae_torch.models import style as style_nets
from soft_intro_vae_torch.ops import adain_cuda, blur, blur_cuda, cuda_build
# by its own name: on the card, without the JAX conftest, ``tests`` may name
# an installed package (pytest puts this directory on the path either way)
from torch_port_fixtures import cuda_device, one_torch_thread  # noqa: F401

SRC = os.path.join(os.path.dirname(blur_cuda.__file__), "csrc", "blur3x3.cu")
# the blur's planes in the LOD-6 style step at batch 32 (ffhq256 width)
LOD6_B32_PLANES = ((32, 64, 256, 256), (32, 128, 128, 128), (32, 256, 64, 64),
                   (32, 512, 32, 32), (32, 512, 16, 16), (32, 512, 8, 8), (32, 512, 4, 4))


def conv_blur(x):
    """The blur as the nets ran it before the kernel: F.conv2d, groups = C."""
    f = torch.tensor([1.0, 2.0, 1.0], dtype=x.dtype)
    k = (f[:, None] * f[None, :] / 16.0).to(x.device)
    return F.conv2d(x, k.expand(x.shape[1], 1, 3, 3), padding=1, groups=x.shape[1])


def _grads(fn, x, dy):
    x = x.detach().clone().requires_grad_(True)
    y = fn(x)
    (dx,) = torch.autograd.grad(y, x, dy)
    return y.detach(), dx


# --- the plain route --------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 3, 8, 8), (1, 4, 5, 7), (3, 2, 1, 6), (2, 5, 16, 4)])
def test_plain_function_matches_conv2d(dtype, shape):
    g = torch.Generator().manual_seed(sum(shape))
    x = torch.randn(shape, generator=g).to(dtype)
    dy = torch.randn(shape, generator=g).to(dtype)
    y, dx = _grads(lambda t: blur.Blur3x3.apply(t, "plain"), x, dy)
    y_ref, dx_ref = _grads(conv_blur, x, dy)
    assert y.dtype == dx.dtype == dtype
    assert torch.equal(y, y_ref)
    # dx is conv2d's forward on dy; conv2d's own backward sums in another order
    tol = {"rtol": 0, "atol": 1e-6} if dtype == torch.float32 else {"rtol": 2 ** -7, "atol": 1e-6}
    torch.testing.assert_close(dx, dx_ref, **tol)
    # the gradient is the blur of dy: the filter is symmetric and the padding zero
    assert torch.equal(dx, conv_blur(dy))


def test_function_gradcheck_in_float64():
    x = torch.randn(2, 3, 6, 5, dtype=torch.float64, requires_grad=True)
    fn = lambda t: blur.Blur3x3.apply(t, "plain")  # noqa: E731
    assert torch.autograd.gradcheck(fn, (x,))
    assert torch.autograd.gradgradcheck(fn, (x,))


def test_function_saves_no_tensor():
    x = torch.randn(2, 3, 8, 8, requires_grad=True)
    y = blur.Blur3x3.apply(x, "plain")
    saved = [a for a in dir(y.grad_fn) if a.startswith("_saved_")]
    assert saved == [] and not getattr(y.grad_fn, "saved_tensors", ())


def test_dispatcher_on_the_cpu_is_conv2d():
    x = torch.randn(2, 4, 9, 9, requires_grad=True)
    y = style_nets.blur3x3(x)
    assert torch.equal(y, conv_blur(x))
    assert type(y.grad_fn).__name__.startswith("Convolution")  # F.conv2d's own backward
    assert torch.equal(style_nets.blur3x3(x, "plain"), y)


def test_dispatcher_refuses_wrong_routes():
    x = torch.zeros(1, 1, 4, 4)
    with pytest.raises(ValueError, match="CUDA"):
        style_nets.blur3x3(x, "cuda")
    with pytest.raises(NotImplementedError):
        style_nets.blur3x3(x, "triton")
    with pytest.raises(ValueError, match="CUDA"):
        blur_cuda.blur3x3_cuda(x)


@pytest.mark.parametrize("bad,err", [(torch.zeros(1, 2, 4, 4, dtype=torch.float64), TypeError),
                                     (torch.zeros(2, 4, 4), ValueError),
                                     (torch.zeros(1, 2, 4, 4), ValueError)])
def test_the_kernel_refuses_what_it_does_not_take(bad, err):
    with pytest.raises(err):
        blur_cuda.check_input(bad)
    # what it takes: the (B, C, H, W) view of an NHWC buffer
    blur_cuda.check_input(torch.zeros(1, 4, 4, 2).permute(0, 3, 1, 2))


def test_the_dispatcher_runs_channels_last_and_counts_relayouts():
    x = torch.randn(2, 4, 9, 7)
    before = dict(blur.relayouts)
    y = style_nets.blur3x3(x)  # NCHW: one copy into channels-last
    assert y.is_contiguous(memory_format=torch.channels_last)
    assert blur.relayouts["x"] == before.get("x", 0) + 1
    xc = x.contiguous(memory_format=torch.channels_last).requires_grad_(True)
    yc = style_nets.blur3x3(xc)
    yc.backward(torch.randn_like(yc))
    assert blur.relayouts["x"] == before.get("x", 0) + 1  # channels-last: no copy
    assert xc.grad.is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(y, yc, rtol=0, atol=1e-6)


# --- the launch plan, walked as the kernel walks it -------------------------

def _ceil_div(a, b):
    return -(-a // b)


def _entry_accepts(p, bsz, ch, h, w, es):
    """csrc/blur3x3.cu ``bad_plan``, negated."""
    units = ch // p.vec if p.vec and ch % p.vec == 0 else 0
    return (p.vec > 0 and p.vec * es <= 16 and p.vec & (p.vec - 1) == 0 and ch % p.vec == 0
            and p.cols > 0 and p.rows > 0 and p.threads == p.cols * units <= 256
            and blur_cuda.RING * (p.cols + 2) * ch * es <= p.smem <= 232448
            and p.grid == bsz * _ceil_div(h, p.rows) * _ceil_div(w, p.cols))


def _walk(p, bsz, ch, h, w):
    """The kernel's index arithmetic (blur3x3_stencil), one dimension at a
    time: the (image, row block, column block) of every CTA, the (column,
    unit) of every thread and the rows of every run. Returns the images, the
    rows, the columns and the (column, channel) pairs written, each with its
    count; every row and column it reads is in the image or is padding."""
    col_blocks, row_blocks = _ceil_div(w, p.cols), _ceil_div(h, p.rows)
    units = ch // p.vec
    images, rows, cols, chans = {}, {}, {}, {}
    for block in range(p.grid):
        cb, rest = block % col_blocks, block // col_blocks
        rb, image = rest % row_blocks, rest // row_blocks
        if cb == 0 and rb == 0:
            images[image] = images.get(image, 0) + 1
        if image == 0 and cb == 0:
            r0, r1 = rb * p.rows, min(rb * p.rows + p.rows, h)
            for r in range(r0, r1):
                rows[r] = rows.get(r, 0) + 1
        if image == 0 and rb == 0:
            for t in range(p.threads):
                col = cb * p.cols + t // units
                if col >= w:
                    continue
                unit = t - (t // units) * units
                if unit == 0:
                    cols[col] = cols.get(col, 0) + 1
                for j in range(p.vec):
                    chans[(col, unit * p.vec + j)] = chans.get((col, unit * p.vec + j), 0) + 1
    return images, rows, cols, chans


def _check_plan(bsz, ch, h, w, dtype):
    es = 2 if dtype == torch.bfloat16 else 4
    p = blur_cuda.plan(bsz, ch, h, w, dtype)
    assert _entry_accepts(p, bsz, ch, h, w, es), p
    images, rows, cols, chans = _walk(p, bsz, ch, h, w)
    assert images == {b: 1 for b in range(bsz)}, p
    assert rows == {r: 1 for r in range(h)}, p
    assert cols == {c: 1 for c in range(w)}, p
    assert chans == {(c, k): 1 for c in range(w) for k in range(ch)}, p
    return p


PLANE_SIDES = [1, 2, 4, 8, 16, 32, 64, 128, 256]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("side", PLANE_SIDES)
def test_plan_covers_every_square_plane(side, dtype):
    for bsz in (1, 32, 128):
        for ch in (1, 3, 64, 512):
            _check_plan(bsz, ch, side, side, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("hw", [(7, 9), (1, 300), (300, 1), (33, 65), (256, 24), (5, 1000),
                                (129, 127)])
def test_plan_covers_odd_planes(hw, dtype):
    for bsz, ch in ((1, 1), (5, 3), (2, 131), (3, 96)):
        _check_plan(bsz, ch, *hw, dtype)


def test_plan_at_the_lod6_b32_planes():
    """A pixel's channels go in 16-byte units; a CTA covers 256 threads of
    whole pixels; the rows above and below a band cost at most 7% of its rows
    at the two largest sites, which hold 75% of the bytes; every launch at the
    32x32 sites and larger fills the card with 4 CTAs an SM."""
    for bsz, ch, h, w in LOD6_B32_PLANES:
        for dtype in (torch.bfloat16, torch.float32):
            p = blur_cuda.plan(bsz, ch, h, w, dtype)
            es = 2 if dtype == torch.bfloat16 else 4
            assert p.vec * es == 16 and p.threads == 256
            if h >= 128:
                assert (p.rows + 2) / p.rows <= 1.07
            if h >= 32:
                assert p.grid >= blur_cuda.MIN_CTAS_PER_SM * blur_cuda.H100_SMS


def test_plan_refuses_what_does_not_fit():
    with pytest.raises(ValueError):
        blur_cuda.plan(0, 1, 4, 4, torch.float32)
    with pytest.raises(TypeError):
        blur_cuda.plan(1, 1, 4, 4, torch.float16)
    with pytest.raises(ValueError, match="threads"):
        blur_cuda.plan(1, 257, 4, 4, torch.float32)  # odd channels: one a thread


# --- the source and the binding ---------------------------------------------

def test_kernel_name_is_not_the_norms():
    src = open(SRC).read()
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(", src)
    assert names == ["blur3x3_stencil"]
    assert not any(k in names[0] for k in ("fwd_kernel", "bwd_kernel"))


def test_binding_matches_the_c_signature():
    src = open(SRC).read()
    params = re.search(r"\bint blur3x3\(([^)]*)\)", src).group(1).split(",")

    class Fake:
        class Fn:
            pass

        blur3x3, blur3x3_error_string = Fn(), Fn()

    lib = Fake()
    blur_cuda._declare(lib)
    assert len(lib.blur3x3.argtypes) == len(params) == 2 + 6 + len(blur_cuda.Plan._fields) + 1


def test_first_build_compiles_the_blur_and_the_norm_together(monkeypatch):
    calls = []
    monkeypatch.setattr(cuda_build, "build_many", lambda specs: calls.append(list(specs)) or
                        ["lib.so"] * len(specs))
    blur_cuda._library.build()
    adain_cuda._library.build()
    assert calls == [[blur_cuda.spec(), adain_cuda.spec()], [adain_cuda.spec(), blur_cuda.spec()]]


# --- on the card ------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_kernel_matches_conv2d_bit_for_bit_on_the_card(cuda_device, dtype):  # noqa: F811
    g = torch.Generator(device=cuda_device).manual_seed(24)
    cl = torch.channels_last
    for shape in LOD6_B32_PLANES:
        x = torch.randn(shape, generator=g, device=cuda_device).to(dtype)
        dy = torch.randn(shape, generator=g, device=cuda_device).to(dtype)
        y, dx = _grads(lambda t: style_nets.blur3x3(t, "cuda"), x.contiguous(memory_format=cl),
                       dy.contiguous(memory_format=cl))
        y_ref, dx_ref = _grads(blur.blur3x3_plain, x, dy)  # ATen's depthwise kernels, NCHW
        torch.cuda.synchronize()
        assert y.is_contiguous(memory_format=cl) and dx.is_contiguous(memory_format=cl)
        assert torch.equal(y, y_ref), (shape, dtype, int((y != y_ref).sum()))
        assert torch.equal(dx, dx_ref), (shape, dtype, int((dx != dx_ref).sum()))
        del x, dy, y, dx, y_ref, dx_ref


@pytest.mark.cuda
def test_graphed_lod6_style_step_equals_eager_with_the_blur_kernel(cuda_device):  # noqa: F811
    """The LOD-6 intro step at a small width, graphed and eager, bit for bit,
    and the blur's launches on the device: 83 + 77 an intro step."""
    import numpy as np

    from soft_intro_vae_torch.train import graph
    from soft_intro_vae_torch.train.graph import one_step
    from soft_intro_vae_torch.train.style_step import (
        StyleModel, StyleModelConfig, StyleStepConfig, StyleTrainState, build_style_steps)

    lod, steps = 6, 5
    mc = StyleModelConfig(layer_count=7, startf=4, maxf=16, latent_size=16, mapping_layers=2,
                          style_mixing_prob=0.9, compute_dtype="bfloat16")
    rs = np.random.RandomState(6)
    xs = [torch.tensor(rs.rand(2, 3, 256, 256).astype(np.float32) * 2 - 1, device=cuda_device)
          for _ in range(steps)]
    runs = []
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for graphed in (True, False):
            model = StyleModel(mc)
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(0)
                nets = model.make_nets()
            state = StyleTrainState.create(nets, device=cuda_device, seed=1, lr=1e-3,
                                           ema_beta=0.9)
            _, intro = build_style_steps(model, StyleStepConfig(latent_size=16), lod, False)
            step = one_step(intro) if graphed else intro
            graph.captured.clear()
            graph.replayed.clear()
            before = cuda_build.launches["blur3x3"]
            ms = [step(state, x, 1.0)[1] for x in xs]
            torch.cuda.synchronize()
            wrapper = cuda_build.launches["blur3x3"] - before
            on_device = wrapper - graph.captured["blur3x3"] + graph.replayed["blur3x3"]
            assert on_device == (83 + 77) * steps, (graphed, wrapper, dict(graph.captured))
            if graphed:
                assert graph.captured["blur3x3"] == 83 + 77
            runs.append((state, ms))
    finally:
        torch.backends.cudnn.deterministic = saved
    (sa, ma), (sb, mb) = runs
    for x, y in zip(ma, mb):
        assert all(torch.equal(x[k], y[k]) for k in x)
    for which in ("nets", "ema"):
        da, db = getattr(sa, which).state_dict(), getattr(sb, which).state_dict()
        assert all(torch.equal(da[k], db[k]) for k in da), which
    assert math.isfinite(float(ma[-1]["loss_e"]))
