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

On the CPU the wrappers never reach the CUDA kernels; the kernels themselves
are held to these plain functions on the card by ``chip_smoke.py``.
"""

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


def test_dispatch_on_cpu_never_reaches_the_kernels():
    x, arrays, kw = _args("noise", True)
    xt, rest = _port(x, arrays)
    before = (adain_cuda.launches_fwd, adain_cuda.launches_bwd)
    auto = adain.bias_act_norm(xt, rest["bias"], rest["g"], rest["b"], rest["n"], rest["nw"], **kw)
    plain = adain.bias_act_norm(xt, rest["bias"], rest["g"], rest["b"], rest["n"], rest["nw"],
                                impl="plain", **kw)
    for a, b in zip(auto, plain):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (adain_cuda.launches_fwd, adain_cuda.launches_bwd) == before
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


def test_library_path_is_keyed_by_source(tmp_path, monkeypatch):
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    monkeypatch.setattr(adain_cuda, "_SRC", str(src))
    first = adain_cuda.library_path()
    src.write_text("// two\n")
    assert adain_cuda.library_path() != first
    assert first.startswith(cuda_build.BUILD_DIR)


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    src = tmp_path / "k.cu"
    src.write_text("// never built\n")
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build_many([(str(src), "never_built", ())])
