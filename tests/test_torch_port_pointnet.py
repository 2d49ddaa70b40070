"""Port parity: soft_intro_vae_torch.models.pointnet against the JAX PointNet nets.

JAX parameters (with randomised BN affine and statistics) go through
``pointnet_state_dict_from_jax`` into the port; the same numpy inputs then go
through both. Outputs agree at atol 1e-5 (float32 products summed in another
order).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soft_intro_vae_tpu.models.pointnet import PointNetDecoder as JaxDecoder
from soft_intro_vae_tpu.models.pointnet import PointNetEncoder as JaxEncoder
from soft_intro_vae_tpu.utils.torch_compat import convert_pointnet_decoder, convert_pointnet_encoder
from soft_intro_vae_torch.models.pointnet import SoftIntroVAE3D
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
