"""Port parity: soft_intro_vae_torch.ops.adain against ops/adain_pallas.py.

The same numpy inputs (NHWC for the JAX package, transposed explicitly to the
port's NCHW) go through the port's plain forward and the JAX package's
``reference_bias_act_norm`` and interpret-mode Pallas kernel, for the three
modes with and without the AdaIN affine, plus a multi-tile shape: rtol 1e-5
(as tests/test_adain_pallas.py), atol 1e-5 on y and 1e-6 on m, v.

The port's written-out backward (through its autograd Function) is held to
``jax.grad`` of ``reference_bias_act_norm`` with y, m and v all in the loss:
rtol 2e-4, atol 2e-5 (as tests/test_adain_pallas.py). JAX's gradient is not
taken through the interpret-mode kernel: the JAX package marks that slow.
``torch.autograd.gradcheck`` checks the hand-written backward in float64.

The dispatcher runs channels-last on both routes: an NCHW input is copied
once and counted in ``relayouts``, a channels-last one is not, and y and the
input gradient come back channels-last; the plain functions give the same
values on either layout; an output nothing reads gets zeros in x's layout.

On the CPU the wrappers never reach the CUDA kernels; the kernels themselves
are held to these plain functions on the card by ``chip_smoke.py``.
"""

import collections
import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soft_intro_vae_tpu.ops.adain_pallas import fused_bias_act_norm, reference_bias_act_norm
from soft_intro_vae_torch.ops import adain, adain_cuda, cuda_build
from tests.torch_port_fixtures import one_torch_thread  # noqa: F401

MODES = ["plain", "noise", "corr"]


def _args(mode, affine, B=2, H=8, W=8, C=16, seed=7):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(B, H, W, C)) * 2 + 0.3).astype(np.float32)
    kw = dict(mode=mode, eps=1e-5, corr_scale=1.414)
    arrays = dict(bias=rng.normal(size=(C,)).astype(np.float32))
    if affine:
        arrays["g"] = (rng.normal(size=(B, C)) + 1).astype(np.float32)
        arrays["b"] = rng.normal(size=(B, C)).astype(np.float32)
    if mode == "noise":
        arrays["n"] = rng.normal(size=(B, H, W)).astype(np.float32)
        arrays["nw"] = rng.normal(size=(C,)).astype(np.float32)
    return x, arrays, kw


def _port(x_nhwc, arrays, dtype=torch.float32, grad=False):
    x = torch.tensor(x_nhwc.transpose(0, 3, 1, 2).copy(), dtype=dtype, requires_grad=grad)
    rest = {k: torch.tensor(v, dtype=dtype, requires_grad=grad and k != "n")
            for k, v in arrays.items()}
    return x, rest


def _nchw(a):
    return np.asarray(a).transpose(0, 3, 1, 2)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("affine", [True, False])
def test_plain_forward_matches_jax(mode, affine):
    x, arrays, kw = _args(mode, affine)
    jx = {k: jnp.asarray(v) for k, v in arrays.items()}
    y_ref, m_ref, v_ref = reference_bias_act_norm(jnp.asarray(x), jx.pop("bias"), **jx, **kw)
    jx = {k: jnp.asarray(v) for k, v in arrays.items()}
    y_ker, m_ker, v_ker = fused_bias_act_norm(jnp.asarray(x), jx.pop("bias"), interpret=True,
                                              **jx, **kw)
    xt, rest = _port(x, arrays)
    y, m, v = adain.bias_act_norm_plain(xt, rest.pop("bias"), **rest, **kw)
    for ref_y, ref_m, ref_v in ((y_ref, m_ref, v_ref), (y_ker, m_ker, v_ker)):
        np.testing.assert_allclose(y.numpy(), _nchw(ref_y), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(m.numpy(), np.asarray(ref_m), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(v.numpy(), np.asarray(ref_v), rtol=1e-5, atol=1e-6)


def test_plain_forward_multi_tile_matches_jax_kernel():
    # S = 2048 > the Pallas kernel's tile: its sequential-grid accumulation
    x, arrays, kw = _args("plain", True, B=1, H=64, W=32, C=128, seed=3)
    jx = {k: jnp.asarray(v) for k, v in arrays.items()}
    y_ker, m_ker, v_ker = fused_bias_act_norm(jnp.asarray(x), jx.pop("bias"), interpret=True,
                                              **jx, **kw)
    xt, rest = _port(x, arrays)
    y, m, v = adain.bias_act_norm_plain(xt, rest.pop("bias"), **rest, **kw)
    np.testing.assert_allclose(y.numpy(), _nchw(y_ker), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(m.numpy(), np.asarray(m_ker), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(v.numpy(), np.asarray(v_ker), rtol=1e-5, atol=1e-6)


def _loss_weights(shape_nhwc):
    size = int(np.prod(shape_nhwc))
    return np.arange(size, dtype=np.float32).reshape(shape_nhwc) / size


@pytest.mark.parametrize("mode,affine", [("noise", True), ("plain", False), ("corr", True),
                                         ("corr", False)])
def test_backward_matches_jax_grad(mode, affine):
    x, arrays, kw = _args(mode, affine)
    w = _loss_weights(x.shape)
    names = [k for k in arrays if k != "n"]

    def jloss(x, *diff):
        a = dict(zip(names, diff))
        if "n" in arrays:
            a["n"] = jnp.asarray(arrays["n"])
        y, m, v = reference_bias_act_norm(x, a.pop("bias"), **a, **kw)
        return jnp.sum(y * w) + 0.7 * jnp.sum(m) + jnp.sum(jnp.sqrt(v + 1e-12))

    jgrads = jax.grad(jloss, argnums=tuple(range(1 + len(names))))(
        jnp.asarray(x), *[jnp.asarray(arrays[k]) for k in names])

    xt, rest = _port(x, arrays, grad=True)
    y, m, v = adain.bias_act_norm(xt, rest["bias"], rest.get("g"), rest.get("b"),
                                  rest.get("n"), rest.get("nw"), **kw)
    loss = (y * torch.tensor(_nchw(w))).sum() + 0.7 * m.sum() + torch.sqrt(v + 1e-12).sum()
    tgrads = torch.autograd.grad(loss, [xt] + [rest[k] for k in names])
    np.testing.assert_allclose(tgrads[0].numpy(), _nchw(jgrads[0]), rtol=2e-4, atol=2e-5)
    for name, tg, jg in zip(names, tgrads[1:], jgrads[1:]):
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=2e-4, atol=2e-5,
                                   err_msg=name)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("affine", [True, False])
def test_gradcheck_float64(mode, affine):
    x, arrays, kw = _args(mode, affine, B=2, H=3, W=4, C=3, seed=11)
    xt, rest = _port(x, arrays, dtype=torch.float64, grad=True)
    n = rest.pop("n", None)
    names = list(rest)

    def fn(x, *diff):
        a = dict(zip(names, diff))
        return adain.bias_act_norm(x, a.pop("bias"), a.get("g"), a.get("b"), n, a.get("nw"),
                                   **kw)

    assert torch.autograd.gradcheck(fn, (xt, *[rest[k] for k in names]))


def test_backward_plain_sums_per_plane():
    # the per-(b, c) outputs the kernel also writes; the Function sums over b
    x, arrays, kw = _args("noise", True, B=3, C=4, seed=5)
    xt, rest = _port(x, arrays)
    y, m, v = adain.bias_act_norm_plain(xt, rest["bias"], rest["g"], rest["b"], rest["n"],
                                        rest["nw"], **kw)
    dy = torch.ones_like(y)
    dx, dbst, dg, dbias, dnw = adain.bias_act_norm_backward_plain(
        xt, rest["bias"], rest["g"], rest["n"], rest["nw"], m, v, dy, torch.zeros_like(m),
        torch.zeros_like(v), **kw)
    assert dx.shape == xt.shape and all(t.shape == (3, 4) for t in (dbst, dg, dbias, dnw))
    torch.testing.assert_close(dbst, torch.full((3, 4), 64.0))
    # sum(dy * ehat) of a normalised plane is 0 (up to the eps in rsqrt)
    torch.testing.assert_close(dg, torch.zeros(3, 4), rtol=0, atol=1e-4)


def test_bf16_keeps_its_type_and_stats_in_f32():
    x, arrays, kw = _args("corr", True, seed=9)
    xt, rest = _port(x, arrays)
    y, m, v = adain.bias_act_norm(xt.to(torch.bfloat16), rest["bias"], rest["g"], rest["b"], **kw)
    assert y.dtype == torch.bfloat16 and m.dtype == v.dtype == torch.float32
    y32, m32, _ = adain.bias_act_norm(xt.to(torch.bfloat16).float(), rest["bias"], rest["g"],
                                      rest["b"], **kw)
    torch.testing.assert_close(m, m32, rtol=0, atol=0)
    # bf16 output rounding: within one bf16 ulp (2^-7 relative) of the f32 result
    torch.testing.assert_close(y.float(), y32, rtol=2**-7, atol=1e-6)


def test_dispatcher_runs_channels_last_and_counts_relayouts():
    x, arrays, kw = _args("noise", True)
    xt, rest = _port(x, arrays)
    cl = torch.channels_last
    before = dict(adain.relayouts)
    y, _, _ = adain.bias_act_norm(xt, rest["bias"], rest["g"], rest["b"], rest["n"],
                                  rest["nw"], **kw)
    assert y.is_contiguous(memory_format=cl)
    assert adain.relayouts["x"] == before.get("x", 0) + 1
    xc = xt.contiguous(memory_format=cl).requires_grad_(True)
    yc, mc, _ = adain.bias_act_norm(xc, rest["bias"], rest["g"], rest["b"], rest["n"],
                                    rest["nw"], **kw)
    torch.testing.assert_close(yc, y, rtol=0, atol=0)
    (yc.float() * torch.randn_like(yc)).sum().add(mc.sum()).backward()
    assert xc.grad.is_contiguous(memory_format=cl)
    assert dict(adain.relayouts) == {**before, "x": before.get("x", 0) + 1}


@pytest.mark.parametrize("mode", MODES)
def test_plain_versions_agree_on_either_layout(mode):
    x, arrays, kw = _args(mode, True, seed=13)
    xt, rest = _port(x, arrays)
    xc = xt.contiguous(memory_format=torch.channels_last)
    args = (rest["bias"], rest["g"], rest["b"], rest.get("n"), rest.get("nw"))
    fwd_n = adain.bias_act_norm_plain(xt, *args, **kw)
    fwd_c = adain.bias_act_norm_plain(xc, *args, **kw)
    for a, b in zip(fwd_n, fwd_c):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    assert fwd_c[0].is_contiguous(memory_format=torch.channels_last)
    m, v = fwd_n[1], fwd_n[2]
    dy = torch.randn(xt.shape, generator=torch.Generator().manual_seed(2))
    bwd = [adain.bias_act_norm_backward_plain(
        t, rest["bias"], rest["g"], rest.get("n"), rest.get("nw"), m, v,
        dy.contiguous(memory_format=fmt), torch.ones_like(m), torch.ones_like(v), **kw)
        for t, fmt in ((xt, torch.contiguous_format), (xc, torch.channels_last))]
    for a, b in zip(*bwd):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_an_unread_output_gets_zeros_in_the_layout_of_x():
    # the style encoder's last block reads only m and v of its second norm:
    # y's gradient is zeros made in x's layout, not autograd's NCHW zeros
    x, arrays, kw = _args("plain", False, seed=17)
    xt, rest = _port(x, arrays)
    xc = xt.contiguous(memory_format=torch.channels_last).requires_grad_(True)
    before = dict(adain.relayouts)
    _, m, v = adain.bias_act_norm(xc, rest["bias"], **kw)
    (m.sum() + v.sum()).backward()
    assert dict(adain.relayouts) == before
    xr = xt.clone().requires_grad_(True)
    y, m, v = adain.bias_act_norm_plain(xr, rest["bias"], **kw)
    (m.sum() + v.sum() + 0 * y.sum()).backward()
    torch.testing.assert_close(xc.grad, xr.grad, rtol=1e-5, atol=1e-6)


def test_planes_of_equal_values_have_no_variance():
    """The generator's first norm sees its expanded const, every plane one
    value: the moments, taken about the image's first pixel, give m = e there
    and v = 0 exactly, and y is the shift b up to the rounding of m * a (the
    kernels are held to the same in chip_smoke.py's kernels phase)."""
    gen = torch.Generator().manual_seed(31)
    bsz, ch, size = 2, 16, 8
    x = (2 * torch.randn(bsz, ch, 1, 1, generator=gen) + 0.3).expand(bsz, ch, size, size)
    bias, g, b = (torch.randn(bsz, ch, generator=gen)[0], torch.randn(bsz, ch, generator=gen) + 1,
                  torch.randn(bsz, ch, generator=gen))
    xc = x.contiguous(memory_format=torch.channels_last)
    for mode in ("plain", "corr"):
        y, m, v = adain.bias_act_norm(xc, bias, g, b, mode=mode, eps=1e-8, corr_scale=1.414)
        e, _ = adain._producer(x, bias, None, None, mode, 0.2, 1.414)
        assert torch.equal(v, torch.zeros(bsz, ch)), mode
        assert torch.equal(m, e[:, :, 0, 0]), mode
        scale = (m * torch.rsqrt(v + 1e-8) * g).abs().max()
        atol = float(4 * torch.finfo(torch.float32).eps * scale)
        torch.testing.assert_close(y, b[:, :, None, None].expand(y.shape), rtol=0, atol=atol)


def test_dispatch_on_cpu_never_reaches_the_kernels():
    x, arrays, kw = _args("noise", True)
    xt, rest = _port(x, arrays)
    launches = cuda_build.launches
    before = (launches["bias_act_norm_fwd"], launches["bias_act_norm_bwd"])
    auto = adain.bias_act_norm(xt, rest["bias"], rest["g"], rest["b"], rest["n"], rest["nw"], **kw)
    plain = adain.bias_act_norm(xt, rest["bias"], rest["g"], rest["b"], rest["n"], rest["nw"],
                                impl="plain", **kw)
    for a, b in zip(auto, plain):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (launches["bias_act_norm_fwd"], launches["bias_act_norm_bwd"]) == before
    with pytest.raises(ValueError, match="CUDA"):
        adain.bias_act_norm(xt, rest["bias"], impl="cuda")
    with pytest.raises(NotImplementedError):
        adain.bias_act_norm(xt, rest["bias"], impl="triton")


def test_argument_errors():
    x, arrays, _ = _args("plain", True)
    xt, rest = _port(x, arrays)
    with pytest.raises(ValueError, match="unknown mode"):
        adain.bias_act_norm(xt, rest["bias"], mode="bogus")
    with pytest.raises(ValueError, match="noise"):
        adain.bias_act_norm(xt, rest["bias"], mode="noise")
    with pytest.raises(ValueError, match="together"):
        adain.bias_act_norm(xt, rest["bias"], g=rest["g"])


def test_kernel_wrappers_validate_their_inputs():
    x = torch.zeros(1, 2, 4, 4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        adain_cuda.forward(x, torch.zeros(2))
    with pytest.raises(ValueError, match="CUDA tensor"):
        z = torch.zeros(1, 2)
        adain_cuda.backward(x, x, torch.zeros(2), None, None, None, z, z, z, z)


def test_launch_counters_are_kept_one_a_stream(monkeypatch):
    # a launch's items meet through counters that no launch on another
    # stream, which may overlap it, ever touches
    monkeypatch.setattr(adain_cuda, "_FLAGS", {})
    cpu = torch.device("cpu")
    first, other = adain_cuda._flags(cpu, 1), adain_cuda._flags(cpu, 2)
    assert adain_cuda._flags(cpu, 1) is first and first.data_ptr() != other.data_ptr()
    assert first.dtype == torch.int32 and first.numel() == 2 + 3 * adain_cuda.MAX_IMAGES
    assert not first.any()
    # a stream's first launch under a CUDA graph's capture would put its
    # counters in the graph's memory pool: refused
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with pytest.raises(RuntimeError, match="captured"):
        adain_cuda._flags(torch.device("cuda", 0), 3)
    assert set(adain_cuda._FLAGS) == {(cpu, 1), (cpu, 2)}


def test_library_path_is_keyed_by_source(tmp_path, monkeypatch):
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    monkeypatch.setattr(adain_cuda, "_SRC", str(src))
    first = adain_cuda.library_path()
    src.write_text("// two\n")
    assert adain_cuda.library_path() != first
    assert first.startswith(cuda_build.BUILD_DIR)


def test_a_failed_launch_raises_with_the_library_error_and_counts_nothing(monkeypatch):
    """``Library.launch``, every kernel's launch: the entry point gets the
    arguments and then the current stream's handle, inside the tensors'
    device; a non-zero return raises with the library's own error string
    and the caller's context, and is not counted."""
    seen = []

    class Entry:
        def __init__(self, err):
            self.err = err

        def __call__(self, *args):
            seen.append(args)
            return self.err

    class Standin:
        good, bad = Entry(0), Entry(7)

        @staticmethod
        def standin_error_string(err):
            return f"stand-in error {err}".encode()

    devices = []
    monkeypatch.setattr(torch.cuda, "device", lambda d: devices.append(d) or
                        contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=99))
    monkeypatch.setattr(cuda_build, "launches", collections.Counter())
    monkeypatch.setattr(cuda_build, "_libraries", {})
    lib = cuda_build.Library(lambda: ("standin.cu", "standin", ()), lambda lib: None, "standin")
    lib._lib = Standin()
    with pytest.raises(RuntimeError, match=r"standin launch failed: stand-in error 7 \(plan 3\)"):
        lib.launch("standin", "bad", "cuda:1", 1, 2, context="plan 3")
    assert not cuda_build.launches
    lib.launch("standin", "good", "cuda:1", 4, context="plan 4")
    assert seen == [(1, 2, 99), (4, 99)] and devices == ["cuda:1", "cuda:1"]
    assert cuda_build.launches == {"standin": 1}


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    src = tmp_path / "k.cu"
    src.write_text("// never built\n")
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build_many([(str(src), "never_built", ())])
