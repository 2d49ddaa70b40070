"""Port parity: soft_intro_vae_torch.models.pointnet against the JAX PointNet nets.

JAX parameters (with randomised BN affine and statistics) go through
``pointnet_state_dict_from_jax`` into the port; the same numpy inputs then go
through both. Outputs agree at atol 1e-5 (float32 products summed in another
order).

The port's encoder runs points-major, each per-point layer a GEMM on
(B·N, C) rows; ``conv1d_encoder``, the reference's Conv1d chain on the
(B, C, N) layout with the same weights and BN modules, is its plain oracle:
in float64 the two agree to rounding in outputs, every gradient and the
running buffers, and the encoder dispatches no convolution. Each GEMM runs
with cuBLAS's TF32 flag at cuDNN's, the flag that governed the Conv1d.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from soft_intro_vae_tpu.models.pointnet import PointNetDecoder as JaxDecoder
from soft_intro_vae_tpu.models.pointnet import PointNetEncoder as JaxEncoder
from soft_intro_vae_tpu.utils.torch_compat import convert_pointnet_decoder, convert_pointnet_encoder
from soft_intro_vae_torch.models import remat
from soft_intro_vae_torch.models.pointnet import PointConv1d, SoftIntroVAE3D, _PointMax
from soft_intro_vae_torch.utils.from_jax import pointnet_state_dict_from_jax
from tests.torch_port_fixtures import one_torch_thread  # noqa: F401

B, N, Z = 4, 16, 8


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, dtype=np.float32), tree)


@pytest.fixture(scope="module")
def nets():
    enc, dec = JaxEncoder(z_dim=Z), JaxDecoder(z_dim=Z, n_points=N)
    # one compiled init each (an eager init compiles every op on its own)
    ve = jax.jit(lambda k: enc.init(k, jnp.zeros((1, N, 3)), train=False))(jax.random.key(0))
    vd = jax.jit(lambda k: dec.init(k, jnp.zeros((1, Z))))(jax.random.key(1))
    params_e, stats_e, params_d = _np_tree(ve["params"]), _np_tree(ve["batch_stats"]), _np_tree(vd["params"])
    rs = np.random.RandomState(3)
    for i in range(5):  # randomise BN so the test means something
        bn = params_e[f"bn_{i}"]
        bn["scale"] = (1 + 0.2 * rs.randn(*bn["scale"].shape)).astype(np.float32)
        bn["bias"] = (0.2 * rs.randn(*bn["bias"].shape)).astype(np.float32)
        st = stats_e[f"bn_{i}"]
        st["mean"] = (0.3 * rs.randn(*st["mean"].shape)).astype(np.float32)
        st["var"] = rs.uniform(0.5, 1.5, st["var"].shape).astype(np.float32)
    model = SoftIntroVAE3D(z_dim=Z, n_points=N)
    model.load_state_dict(pointnet_state_dict_from_jax(params_e, stats_e, params_d))
    x = (0.3 * np.random.RandomState(4).randn(B, N, 3)).astype(np.float32)
    return enc, dec, params_e, stats_e, params_d, model, x


def test_train_mode_forward_and_running_stats(nets):
    """Train mode normalises with the batch statistics in both frameworks and
    updates the running ones. running_mean agrees. running_var does not agree
    as it is: flax's BatchNorm folds in the *biased* batch variance, while
    torch.nn.BatchNorm1d (the reference's layer, kept by the port) folds in
    the *unbiased* one, so torch's (1 - momentum) term is n/(n-1) larger, with
    n = B*N points per channel. The check applies that factor explicitly; it
    is a property of the JAX package, not a fault of the port."""
    enc, _, params_e, stats_e, _, model, x = nets
    model = copy.deepcopy(model)  # the update below must not leak into other tests
    (mu_j, lv_j), upd = jax.jit(lambda v, x: enc.apply(v, x, train=True, mutable=["batch_stats"]))(
        {"params": params_e, "batch_stats": stats_e}, jnp.asarray(x))
    model.train()
    with torch.no_grad():
        mu_t, lv_t = model.encoder(torch.tensor(x))
    np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j), atol=1e-5)
    np.testing.assert_allclose(lv_t.numpy(), np.asarray(lv_j), atol=1e-5)

    n = B * N
    gaps = []  # the uncorrected difference, to show the factor is not lost in the noise
    for i in range(5):
        bn = model.encoder.conv[3 * i + 2]
        old_var = stats_e[f"bn_{i}"]["var"]
        new_j = upd["batch_stats"][f"bn_{i}"]
        np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(new_j["mean"]), atol=1e-5)
        biased = (np.asarray(new_j["var"], np.float64) - 0.9 * old_var) / 0.1
        expected = 0.9 * old_var + 0.1 * biased * n / (n - 1)
        np.testing.assert_allclose(bn.running_var.numpy(), expected, rtol=1e-5, atol=1e-5)
        assert int(bn.num_batches_tracked) == 1
        gaps.append(np.abs(bn.running_var.numpy() - np.asarray(new_j["var"])).max())
    assert max(gaps) > 10 * 1e-5  # well above the tolerance the corrected check uses


def test_eval_mode_forward_uses_carried_statistics(nets):
    enc, _, params_e, stats_e, _, model, x = nets
    mu_j, lv_j = jax.jit(lambda v, x: enc.apply(v, x, train=False))(
        {"params": params_e, "batch_stats": stats_e}, jnp.asarray(x))
    model.eval()
    with torch.no_grad():
        mu_t, lv_t = model.encoder(torch.tensor(x))
    np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j), atol=1e-5)
    np.testing.assert_allclose(lv_t.numpy(), np.asarray(lv_j), atol=1e-5)


def test_decoder_output(nets):
    _, dec, _, _, params_d, model, _ = nets
    z = np.random.RandomState(5).randn(B, Z).astype(np.float32)
    y_j = jax.jit(dec.apply)({"params": params_d}, jnp.asarray(z))
    with torch.no_grad():
        y_t = model.decoder(torch.tensor(z))
    assert tuple(y_t.shape) == (B, N, 3)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-5)
    # the reference's channel-major flat layout: coordinate c of point n at c*N + n
    with torch.no_grad():
        flat = model.decoder.model(torch.tensor(z))
    np.testing.assert_array_equal(flat.view(B, 3, N).transpose(1, 2).numpy(), y_t.numpy())


def test_round_trip_through_the_jax_converters(nets):
    _, _, params_e, stats_e, params_d, _, _ = nets
    sd = pointnet_state_dict_from_jax(params_e, stats_e, params_d)
    assert int(sd["encoder.conv.2.num_batches_tracked"]) == 0
    assert tuple(sd["encoder.conv.0.weight"].shape) == (64, 3, 1)
    pe, se = convert_pointnet_encoder(sd, use_batchnorm=True)
    pd = convert_pointnet_decoder(sd, n_points=N)
    for want, got in ((params_e, pe), (stats_e, se), (params_d, pd)):
        flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
        flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
        assert len(flat_w) == len(flat_g)
        for path, leaf in flat_w:
            np.testing.assert_array_equal(flat_g[path], leaf, err_msg=str(path))


def test_state_dict_names_are_the_references():
    names = set(SoftIntroVAE3D(z_dim=Z, n_points=N).state_dict())
    for i in range(5):
        assert f"encoder.conv.{3 * i}.weight" in names
        assert f"encoder.conv.{3 * i + 2}.running_var" in names
        assert f"encoder.conv.{3 * i}.bias" not in names  # conv has no bias before BN
    for i in (0, 2, 4, 6, 8):
        assert f"decoder.model.{i}.weight" in names and f"decoder.model.{i}.bias" in names
    assert {"encoder.fc.0.weight", "encoder.mu_layer.bias", "encoder.std_layer.weight"} <= names


# ------------------------------------------ points-major against Conv1d ---

def conv1d_encoder(enc, x):
    """The encoder as the reference runs it (vae.py:104-141): each per-point
    layer ``F.conv1d`` on the (B, C, N) layout with ``enc``'s weight, ReLU,
    then ``enc``'s BN module through torch's own BatchNorm1d forward; the
    max-pool over the points. The plain oracle of the points-major encoder."""
    h = x.transpose(1, 2)
    for i in range(0, len(enc.conv), 3):
        h = F.relu(F.conv1d(h, enc.conv[i].weight))
        h = torch.nn.BatchNorm1d.forward(enc.conv[i + 2], h)
    h = enc.fc(h.amax(dim=2))
    return enc.mu_layer(h), enc.std_layer(h)


def _random_encoder(dtype, seed=7):
    """A port encoder at the recipe's widths with BN affine and running
    statistics away from their initial values."""
    gen = torch.Generator().manual_seed(seed)
    enc = SoftIntroVAE3D(z_dim=Z, n_points=N).encoder.to(dtype)
    with torch.no_grad():
        for i in range(5):
            bn = enc.conv[3 * i + 2]
            bn.weight.copy_(1 + 0.2 * torch.randn(bn.weight.shape, generator=gen))
            bn.bias.copy_(0.2 * torch.randn(bn.bias.shape, generator=gen))
            bn.running_mean.copy_(0.3 * torch.randn(bn.running_mean.shape, generator=gen))
            bn.running_var.uniform_(0.5, 1.5, generator=gen)
    return enc


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_points_major_encoder_equals_the_conv1d_chain(train):
    """float64, one forward and backward of ``sum(mu * wm) + sum(logvar *
    wl)``: (mu, logvar), the gradients of every parameter and of the input
    cloud, and the running buffers after the step, within rounding."""
    ours = _random_encoder(torch.float64).train(train)
    oracle = copy.deepcopy(ours)
    gen = torch.Generator().manual_seed(8)
    x = 0.3 * torch.randn(B, N, 3, dtype=torch.float64, generator=gen)
    wm, wl = (torch.randn(B, Z, dtype=torch.float64, generator=gen) for _ in range(2))
    got, want = {}, {}
    for enc, fn, out in ((ours, ours, got), (oracle, lambda v: conv1d_encoder(oracle, v), want)):
        xg = x.clone().requires_grad_()
        mu, lv = fn(xg)
        ((mu * wm).sum() + (lv * wl).sum()).backward()
        out.update(mu=mu.detach(), logvar=lv.detach(), dx=xg.grad)
        out.update({f"grad/{k}": p.grad for k, p in enc.named_parameters()})
        out.update({f"buf/{k}": b for k, b in enc.named_buffers()})
    # 21 parameters (5 conv weights, 5 BN affine pairs, 3 Linear pairs), 15 BN buffers
    assert got.keys() == want.keys() and len(got) == 3 + 21 + 15
    for k, w in want.items():
        g = got[k]
        if k.endswith("num_batches_tracked"):
            assert int(g) == int(w) == int(train), k
            continue
        scale = float(w.abs().max())
        assert scale > 0, k
        torch.testing.assert_close(g, w, rtol=0, atol=1e-12 * scale, msg=k)


class _Dispatched(TorchDispatchMode):
    """Every aten op dispatched inside, with cuBLAS's TF32 flag as it stood."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append((func._schema.name, torch.backends.cuda.matmul.allow_tf32))
        return func(*args, **(kwargs or {}))


def test_encoder_dispatches_no_convolution():
    enc = _random_encoder(torch.float32).train()
    x = (0.3 * torch.randn(B, N, 3)).requires_grad_()
    with _Dispatched() as seen:
        mu, lv = enc(x)
        (mu.sum() + lv.square().sum()).backward()
    names = {name for name, _ in seen.ops}
    assert "aten::mm" in names and "aten::native_batch_norm_backward" in names, sorted(names)
    assert not [n for n in names if "conv" in n], sorted(names)


@pytest.mark.parametrize("tf32", [False, True], ids=["cudnn_fp32", "cudnn_tf32"])
def test_point_gemms_run_at_cudnn_precision(tf32):
    """The layer's three GEMMs (forward, input and weight gradients) each run
    with cuBLAS's TF32 flag at cuDNN's, set before the forward, though
    cuBLAS's stood the other way and the backward runs after the flags were
    put back; cuBLAS's flag is as it was after each call."""
    layer = PointConv1d(6, 5, 1, bias=False)
    rows = torch.randn(40, 6, requires_grad=True)
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32, not tf32
        with _Dispatched() as seen:
            y = layer(rows)
            assert torch.backends.cuda.matmul.allow_tf32 == (not tf32)
            torch.backends.cudnn.allow_tf32 = not tf32
            y.backward(torch.randn(40, 5))
        assert torch.backends.cuda.matmul.allow_tf32 == (not tf32)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    mms = [flag for name, flag in seen.ops if name == "aten::mm"]
    assert mms == [tf32] * 3
    w = layer.weight.detach()[:, :, 0]
    torch.testing.assert_close(y, rows.detach() @ w.t(), rtol=0, atol=0)


def test_remat_encoder_moves_bn_buffers_once():
    """Under activation checkpointing (models/remat.py) the backward runs the
    encoder's forward again; its BNs take the batch's statistics without
    moving their running buffers, so outputs, gradients and buffers equal a
    plain forward's, ``num_batches_tracked`` 1."""
    plain = _random_encoder(torch.float32).train()
    rematted = copy.deepcopy(plain)
    x = 0.3 * torch.randn(B, N, 3)
    runs = []
    for enc, call in ((plain, lambda v: plain(v)), (rematted, lambda v: remat.checkpoint(rematted, v))):
        xg = x.clone().requires_grad_()
        mu, lv = call(xg)
        (mu.sum() + lv.square().sum()).backward()
        runs.append([mu, lv, xg.grad] + [p.grad for p in enc.parameters()] + list(enc.buffers()))
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    assert all(int(rematted.conv[3 * i + 2].num_batches_tracked) == 1 for i in range(5))


def test_point_max_pool_splits_ties_as_amax():
    """The max-pool over the points: values and gradient bit-equal to
    ``amax``'s over the same axis, ties (a channel dead on every point of a
    cloud, as ReLU before BN makes it) sharing the gradient evenly."""
    gen = torch.Generator().manual_seed(9)
    h = torch.randint(0, 4, (3, 7, 5), generator=gen).float()
    h[1, :, 2] = -0.5  # a whole channel tied
    dy = torch.randn(3, 5, generator=gen)
    got_h, want_h = h.clone().requires_grad_(), h.clone().requires_grad_()
    got, want = _PointMax.apply(got_h), want_h.amax(dim=1)
    got.backward(dy)
    want.backward(dy)
    assert torch.equal(got, want) and torch.equal(got_h.grad, want_h.grad)
    assert torch.equal(got_h.grad[1, :, 2], torch.full((7,), float(dy[1, 2]) / 7))
