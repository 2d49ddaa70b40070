"""The image nets' float32 convolutions: ops/conv_f32.py (the routes, the
autograd Function, the kernels' algebra in plain PyTorch), ops/conv_f32_cuda.py
(the launch plans and the binding) and csrc/conv_f32.cu.

On the CPU:
  * the algebra both kernels rest on, in float64 against ``F.conv2d``'s
    autograd, for k in {1, 3, 5} at the nets' channel counts scaled down and
    at odd sizes: the input gradient as the forward on dy with the weight
    flipped and its channels swapped; the weight gradient as the (Cout) x
    (k*k*Cin) x (B*H*W) GEMM on NHWC rows, its pixels split as a launch plan
    splits them and the partial products summed in split order;
  * the launch plans at every conv of the CelebA-HQ 256 and CIFAR-10 nets,
    forward, input gradient and weight gradient, and at odd shapes: the grid
    covers the output, the splits cover the reduction and none is empty, the
    threads and shared memory are the tile's;
  * the route: the kernels only for a CUDA float32 tensor with cuDNN's TF32
    off and the nets' geometry, cuDNN for TF32, bfloat16 or another geometry,
    the plain ``F.conv2d`` on the CPU; ``routes`` counts every conv of the
    nets; a reference-named ``state_dict`` loads strictly;
  * the binding against the source: each entry point's argument list as long
    as the C function's, and the kernels' names (which the profile tool and
    the benchmark's ``kernels.conv_f32_roofline`` match) apart from the other
    kernels' names.

On the card (``cuda`` marker; skipped here, decided inside each test): the
kernels against float64 at odd shapes and every tile, split and copy width,
two runs bit-equal; the nets' convs on the kernels' route through autograd;
the TF32 and bfloat16 routes on cuDNN. This file imports no JAX, so on the
card it runs as ``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_port_conv_f32.py``.
"""

import os
import re
import types

import pytest
import torch
import torch.nn.functional as F

from soft_intro_vae_torch.data.images import DATASETS
from soft_intro_vae_torch.models.conv import Conv2d, SoftIntroVAE
from soft_intro_vae_torch.ops import conv_f32, conv_f32_cuda, cuda_build
# by its own name: on the card, without the JAX conftest, ``tests`` may name
# an installed package (pytest puts this directory on the path either way)
from torch_port_fixtures import cuda_device, one_torch_thread  # noqa: F401

SRC = os.path.join(os.path.dirname(conv_f32_cuda.__file__), "csrc", "conv_f32.cu")
# (B, Cin, Cout, H, W, k): the nets' widths scaled down, and odd ones
SHAPES = [(2, 8, 16, 6, 6, 3), (1, 3, 8, 7, 5, 5), (2, 16, 3, 5, 7, 5), (3, 12, 10, 4, 4, 1),
          (1, 5, 7, 9, 3, 3), (2, 4, 4, 1, 1, 3), (1, 6, 2, 3, 2, 5)]


def _f64(shape, gen):
    return torch.randn(shape, generator=gen, dtype=torch.float64)


def _autograd(x, w, dy, k):
    x, w = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    y = F.conv2d(x, w, padding=(k - 1) // 2)
    dx, dw = torch.autograd.grad(y, (x, w), dy)
    return y.detach(), dx, dw


# --- the algebra --------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_the_input_gradient_is_the_flipped_channel_swapped_forward(shape):
    b, cin, cout, h, w, k = shape
    g = torch.Generator().manual_seed(sum(shape))
    x, wt, dy = _f64((b, cin, h, w), g), _f64((cout, cin, k, k), g), _f64((b, cout, h, w), g)
    _, dx, _ = _autograd(x, wt, dy, k)
    flipped = conv_f32.flip_plain(wt)
    assert flipped.shape == (cin, cout, k, k)
    assert torch.equal(flipped[1 % cin, 0, 0, k - 1], wt[0, 1 % cin, k - 1, 0])
    torch.testing.assert_close(conv_f32.dgrad_plain(dy, wt), dx, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_the_weight_gradient_is_a_split_gemm_of_nhwc_rows(shape, splits):
    b, cin, cout, h, w, k = shape
    g = torch.Generator().manual_seed(7 * sum(shape))
    x, wt, dy = _f64((b, cin, h, w), g), _f64((cout, cin, k, k), g), _f64((b, cout, h, w), g)
    _, _, dw = _autograd(x, wt, dy, k)
    a = conv_f32.patches(x, k)
    assert a.shape == (b * h * w, k * k * cin)
    # a pixel's row is ordered (r, s, c), as the channels-last weight is
    row = a[0].view(k, k, cin)
    pad = (k - 1) // 2
    assert torch.equal(row[pad, pad], x[0, :, 0, 0])
    got = conv_f32.wgrad_plain(x, dy, k, splits)
    torch.testing.assert_close(got, dw, rtol=1e-12, atol=1e-12)
    assert got.is_contiguous(memory_format=torch.channels_last) or got.shape[1] == 1


def test_split_bounds_cover_the_rows_once_in_order():
    for rows in (1, 5, 16, 100, 524288):
        for splits in (1, 2, 7, 128):
            for per in (None, 1, 3, 16 * 313):
                if per is not None and per * splits < rows:
                    continue  # no plan leaves rows out
                bounds = conv_f32.split_bounds(rows, splits, per)
                assert bounds[0][0] == 0 and bounds[-1][1] == rows
                assert all(lo < hi for lo, hi in bounds)
                assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))


# --- the launch plans -----------------------------------------------------------

def _net_convs():
    """(B, Cin, Cout, H, W, k) of every conv of the two image recipes' nets at
    their cells' batch, from one forward on the meta device."""
    seen = set()
    for dataset, batch in (("celeb256", 8), ("cifar10", 32)):
        spec = DATASETS[dataset]
        with torch.device("meta"):
            vae = SoftIntroVAE(cdim=spec.cdim, zdim=8, channels=spec.channels,
                               image_size=spec.image_size)
        hooks = [m.register_forward_hook(
            lambda mod, args, out: seen.add((args[0].shape[0], args[0].shape[1], mod.out_channels,
                                             args[0].shape[2], args[0].shape[3],
                                             mod.kernel_size[0])))
            for m in vae.modules() if isinstance(m, Conv2d)]
        x = torch.empty(batch, spec.cdim, spec.image_size, spec.image_size, device="meta")
        with torch.no_grad():
            vae.decoder(vae.encoder(x)[0])
        for h in hooks:
            h.remove()
    return sorted(seen)


NET_CONVS = _net_convs()


def _check_plan(p, rows, cols, reduction, tiles, smem_of):
    t = tiles[p.tile]
    assert p.threads == t.threads <= 256
    assert p.smem == smem_of(t) <= cuda_build.SM90_SMEM
    assert p.grid == (-(-rows // t.bm), -(-cols // t.bn), p.splits)
    slices = -(-reduction // conv_f32_cuda.BK)
    assert 1 <= p.splits <= conv_f32_cuda.MAX_SPLITS
    assert p.splits * p.per_split >= slices > (p.splits - 1) * p.per_split


def test_the_nets_convs_are_the_shapes_the_kernels_are_planned_for():
    assert len(NET_CONVS) >= 35
    assert {c[-1] for c in NET_CONVS} == {1, 3, 5}
    assert max(c[0] * c[3] * c[4] for c in NET_CONVS) == 8 * 256 * 256


@pytest.mark.parametrize("vec", [4, 1])
@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("conv", NET_CONVS + [(1, 1, 1, 1, 1, 1), (3, 7, 5, 33, 17, 5),
                                             (1, 4096, 2, 2, 2, 3), (64, 2, 4096, 3, 3, 1)],
                         ids=lambda c: "x".join(map(str, c)))
def test_plans_cover_the_output_and_the_reduction(conv, sms, vec):
    b, cin, cout, h, w, k = conv
    m = b * h * w
    for p, n, kk in ((conv_f32_cuda.plan_fprop(m, cout, k * k * cin, sms, vec), cout, k * k * cin),
                     (conv_f32_cuda.plan_fprop(m, cin, k * k * cout, sms, vec), cin, k * k * cout)):
        _check_plan(p, m, n, kk, conv_f32_cuda.FPROP_TILES, conv_f32_cuda.fprop_smem)
        # the register-staged tiles take 16-byte loads only, and outputs of a
        # few channels the K-major narrow tile
        assert not conv_f32_cuda.FPROP_TILES[p.tile].staged or vec == 4
        assert (p.tile == 2) == (n <= 4)
    wgrad = conv_f32_cuda.plan_wgrad(m, cout, k * k * cin, sms)
    _check_plan(wgrad, cout, k * k * cin, m, conv_f32_cuda.WGRAD_TILES, conv_f32_cuda.wgrad_smem)


def test_plans_split_where_the_tiles_leave_sms_idle():
    # the 4x4 planes of 512 channels: 4 CTAs of 128 x 128 without a split
    small = conv_f32_cuda.plan_fprop(8 * 4 * 4, 512, 9 * 512)
    assert small.grid[:2] == (1, 4) and small.splits >= 16
    # the 256x256 planes fill the card by their tiles alone
    assert conv_f32_cuda.plan_fprop(8 * 256 * 256, 64, 9 * 64).splits == 1
    # a weight gradient over 524,288 pixels into a 64 x 576 weight splits its pixels
    wide = conv_f32_cuda.plan_wgrad(8 * 256 * 256, 64, 9 * 64)
    assert wide.splits > 16 and wide.splits * wide.per_split * conv_f32_cuda.BK >= 8 * 256 * 256
    with pytest.raises(ValueError):
        conv_f32_cuda.plan_fprop(0, 8, 8)


@pytest.mark.parametrize("conv", [c for c in NET_CONVS if c[0] * c[3] * c[4] <= 2048][:4]
                         + [(2, 8, 16, 6, 6, 3)], ids=lambda c: "x".join(map(str, c)))
def test_the_plans_split_weight_gradient_sums_to_autograds(conv):
    """The kernel's split of the pixels (``per_split`` slices of BK pixels),
    summed in split order, in float64: the weight gradient's."""
    b, cin, cout, h, w, k = conv
    b, cin, cout = min(b, 2), min(cin, 16), min(cout, 16)
    g = torch.Generator().manual_seed(h * w + k)
    x, wt, dy = _f64((b, cin, h, w), g), _f64((cout, cin, k, k), g), _f64((b, cout, h, w), g)
    p = conv_f32_cuda.plan_wgrad(b * h * w, cout, k * k * cin, sms=4)
    got = conv_f32.wgrad_plain(x, dy, k, p.splits, p.per_split * conv_f32_cuda.BK)
    torch.testing.assert_close(got, _autograd(x, wt, dy, k)[2], rtol=1e-12, atol=1e-12)


# --- the route ------------------------------------------------------------------

@pytest.fixture
def tf32():
    saved = torch.backends.cudnn.allow_tf32
    yield
    torch.backends.cudnn.allow_tf32 = saved


def _fake(dtype, cuda=True):
    return types.SimpleNamespace(is_cuda=cuda, dtype=dtype)


def test_the_route_is_chosen_from_what_the_call_observes(tf32):
    w3, w1 = torch.empty(4, 4, 3, 3), torch.empty(4, 4, 1, 1)
    torch.backends.cudnn.allow_tf32 = False
    assert conv_f32.route(_fake(torch.float32), w3, 1, 1) == "kernel"
    assert conv_f32.route(_fake(torch.float32), w1, 1, 0) == "kernel"
    assert conv_f32.route(_fake(torch.bfloat16), w3, 1, 1) == "cudnn"
    assert conv_f32.route(_fake(torch.float16), w3, 1, 1) == "cudnn"
    assert conv_f32.route(_fake(torch.float32), w3, 2, 1) == "cudnn"  # stride
    assert conv_f32.route(_fake(torch.float32), w3, 1, 0) == "cudnn"  # padding
    assert conv_f32.route(_fake(torch.float32), w3, 1, 1, 2) == "cudnn"  # dilation
    assert conv_f32.route(_fake(torch.float32), w3, 1, 1, 1, 2) == "cudnn"  # groups
    assert conv_f32.route(_fake(torch.float32), torch.empty(4, 4, 2, 2), 1, 1) == "cudnn"
    assert conv_f32.route(_fake(torch.float32, cuda=False), w3, 1, 1) == "plain"
    torch.backends.cudnn.allow_tf32 = True
    assert conv_f32.route(_fake(torch.float32), w3, 1, 1) == "cudnn"
    assert conv_f32.route(_fake(torch.float32, cuda=False), w3, 1, 1) == "plain"


@pytest.mark.parametrize("bias", [False, True])
def test_a_cpu_tensor_takes_the_plain_conv2d_and_is_counted(bias):
    g = torch.Generator().manual_seed(3)
    conv = Conv2d(6, 5, 3, 1, 1, bias=bias).to(memory_format=torch.channels_last)
    x = torch.randn(2, 6, 7, 5, generator=g).contiguous(memory_format=torch.channels_last)
    conv_f32.routes.clear()
    y = conv(x)
    assert dict(conv_f32.routes) == {"plain": 1}
    assert torch.equal(y, F.conv2d(x, conv.weight, conv.bias, padding=1))


def test_routes_count_every_conv_of_the_nets_and_the_state_dict_is_the_references():
    vae = SoftIntroVAE(cdim=3, zdim=8, channels=(8, 16, 16), image_size=16)
    n_convs = sum(isinstance(m, Conv2d) for m in vae.modules())
    assert all(isinstance(m, Conv2d) for m in vae.modules() if isinstance(m, torch.nn.Conv2d))
    conv_f32.routes.clear()
    x = torch.randn(2, 3, 16, 16).contiguous(memory_format=torch.channels_last)
    mu, _ = vae.encoder(x)
    vae.decoder(mu).sum().backward()
    assert dict(conv_f32.routes) == {"plain": n_convs}
    # the module and parameter names are the reference's: a state_dict in the
    # reference's NCHW layout loads strictly and reads back the same values
    sd = {k: v.contiguous() for k, v in vae.state_dict().items()}
    twin = SoftIntroVAE(cdim=3, zdim=8, channels=(8, 16, 16), image_size=16)
    twin.load_state_dict(sd, strict=True)
    for k, v in twin.state_dict().items():
        assert torch.equal(v, sd[k]), k
    assert "decoder.main.predict.bias" in sd and "encoder.main.0.weight" in sd


# --- the binding ----------------------------------------------------------------

def _c_params(name: str) -> int:
    with open(SRC) as f:
        src = f.read()
    m = re.search(r"\bint %s\(([^)]*)\)\s*\{" % name, src)
    assert m, name
    return len([a for a in m.group(1).split(",") if a.strip()])


def test_each_entry_points_binding_is_as_long_as_its_c_signature():
    lib = types.SimpleNamespace(**{n: types.SimpleNamespace() for n in (
        "conv_f32_fprop", "conv_f32_wgrad", "conv_f32_reduce", "conv_f32_flip")})
    conv_f32_cuda._declare(lib)
    for name, fn in vars(lib).items():
        assert len(fn.argtypes) == _c_params(name), name


def test_the_kernels_names_are_their_own():
    with open(SRC) as f:
        names = set(re.findall(r"__global__ void(?: __launch_bounds__\(.*?\)\))?\s+(\w+)\(",
                               f.read(), re.S))
    assert names == {"conv_f32_fprop_kernel", "conv_f32_fprop_kmajor_kernel",
                     "conv_f32_wgrad_kernel", "conv_f32_reduce_kernel", "conv_f32_flip_kernel"}
    # the other kernels' metrics match these substrings; none may match here
    for other in ("fwd_kernel", "bwd_kernel", "blur3x3_stencil", "nearest_pair_kernel",
                  "u8norm_kernel"):
        assert not any(other in n for n in names), other


def test_nothing_is_built_at_import():
    assert conv_f32_cuda._library._lib is None
    assert conv_f32_cuda.spec()[1] == "conv_f32"


# --- on the card ------------------------------------------------------------------

@pytest.fixture
def no_tf32(cuda_device):
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield cuda_device
    torch.backends.cudnn.allow_tf32 = saved


def _rel(got, want):
    return float((got.double() - want).abs().max() / want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES + [(8, 512, 512, 4, 4, 3), (2, 64, 3, 33, 31, 5),
                                            (2, 3, 64, 31, 33, 5), (4, 64, 64, 64, 64, 3)],
                         ids=lambda s: "x".join(map(str, s)))
def test_kernels_match_float64_and_repeat_bit_for_bit_on_the_card(no_tf32, shape):
    b, cin, cout, h, w, k = shape
    dev = no_tf32
    g = torch.Generator(device=dev).manual_seed(sum(shape))
    cl = torch.channels_last
    x = torch.randn(b, cin, h, w, generator=g, device=dev).contiguous(memory_format=cl)
    wt = torch.randn(cout, cin, k, k, generator=g, device=dev).contiguous(memory_format=cl)
    bias = torch.randn(cout, generator=g, device=dev)
    dy = torch.randn(b, cout, h, w, generator=g, device=dev).contiguous(memory_format=cl)
    x64, w64 = x.double().requires_grad_(True), wt.double().requires_grad_(True)
    y64 = F.conv2d(x64, w64, bias.double(), padding=(k - 1) // 2)
    dx64, dw64 = torch.autograd.grad(y64, (x64, w64), dy.double())
    runs = {"fprop": (lambda: conv_f32_cuda.fprop(x, wt, bias), y64.detach()),
            "dgrad": (lambda: conv_f32_cuda.dgrad(dy, wt), dx64),
            "wgrad": (lambda: conv_f32_cuda.wgrad(x, dy, k), dw64)}
    for name, (run, want) in runs.items():
        a, a2 = run(), run()
        torch.cuda.synchronize()
        assert a.is_contiguous(memory_format=cl), name
        assert _rel(a, want) < 3e-5, name  # float32 sums in another order
        assert torch.equal(a, a2), name


@pytest.mark.cuda
def test_the_nets_take_the_kernels_with_tf32_off_and_cudnn_otherwise(no_tf32, tf32):
    dev = no_tf32
    torch.manual_seed(0)
    vae = SoftIntroVAE(cdim=3, zdim=8, channels=(8, 16, 16), image_size=16).to(dev)
    n_convs = sum(isinstance(m, Conv2d) for m in vae.modules())
    x = torch.randn(2, 3, 16, 16, device=dev).contiguous(memory_format=torch.channels_last)
    results = {}
    for name, allow in (("kernel", False), ("cudnn", True)):
        torch.backends.cudnn.allow_tf32 = allow
        conv_f32.routes.clear()
        cuda_build.launches.clear()
        vae.zero_grad()
        mu, _ = vae.encoder(x)
        out = vae.decoder(mu)
        out.sum().backward()
        assert dict(conv_f32.routes) == {name: n_convs}, name
        assert (cuda_build.launches["conv_f32_fprop"] > 0) == (name == "kernel")
        results[name] = (out.detach(), vae.encoder.main[0].weight.grad.clone())
    torch.backends.cudnn.allow_tf32 = False
    assert _rel(results["kernel"][0], results["cudnn"][0].double()) < 5e-2  # TF32's 10 bits
    half = SoftIntroVAE(cdim=3, zdim=8, channels=(8, 16, 16), image_size=16,
                        compute_dtype=torch.bfloat16).to(dev)
    conv_f32.routes.clear()
    half.decoder(half.encoder(x)[0])
    assert dict(conv_f32.routes) == {"cudnn": n_convs}
