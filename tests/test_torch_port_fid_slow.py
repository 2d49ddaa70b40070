"""The whole FID network at 299x299 against the JAX package (slow: a full
Inception compile and 299x299 forwards on the CPU, as the JAX package's own
tests/test_fid_full_parity.py).

* pool3 of the JAX ``InceptionV3FID`` and of the port, the same variables
  (BN statistics and affine drawn at random) carried across by
  ``inception_state_dict_from_jax``, on 32x32 inputs resized to 299x299:
  within 1e-4 of the largest feature.
* The random-init fallback's calibration: the JAX package's
  ``_calibrate_random_init`` and the port's ``calibrate_random_init`` on the
  same variables and the same batch (``jax.random.uniform(key(1), (32, 64,
  64, 3))``): every BN's statistics within rtol 1e-3 + atol 1e-4, and the
  calibrated networks' pool3 within 1e-3 of the largest feature.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soft_intro_vae_tpu.metrics import fid as jfid
from soft_intro_vae_torch.metrics import fid
from soft_intro_vae_torch.utils.from_jax import inception_state_dict_from_jax
from tests.test_torch_port_fid import _carry, _nchw, _randomize_bn, _rel_err
from tests.torch_port_fixtures import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.slow


@pytest.fixture(scope="module")
def jax_net():
    model = jfid.InceptionV3FID()
    variables = jax.jit(model.init)(jax.random.key(0), jnp.zeros((1, 32, 32, 3)))
    return model, variables


def test_pool3_matches_jax_at_299(jax_net):
    model, variables = jax_net
    variables = _randomize_bn(variables)
    x = np.random.RandomState(9).rand(2, 32, 32, 3).astype(np.float32)
    want = np.asarray(jax.jit(model.apply)(variables, jnp.asarray(x)))
    net = _carry(variables, fid.InceptionV3FID())
    with torch.no_grad():
        got = net(_nchw(x)).numpy()
    assert got.shape == want.shape == (2, 2048)
    assert _rel_err(got, want) <= 1e-4, _rel_err(got, want)


def test_calibration_matches_calibrate_random_init(jax_net):
    model, variables = jax_net
    calibrated = jfid._calibrate_random_init(model, variables)
    batch = np.asarray(jax.random.uniform(jax.random.key(1), (32, 64, 64, 3)))
    net = _carry(jax.tree_util.tree_map(np.array, variables), fid.InceptionV3FID())
    fid.calibrate_random_init(net, _nchw(batch))
    got = net.state_dict()
    want = inception_state_dict_from_jax(jax.tree_util.tree_map(np.array, calibrated["params"]),
                                         jax.tree_util.tree_map(np.array, calibrated["batch_stats"]))
    for key, w in want.items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[key].numpy(), w.numpy(), rtol=1e-3, atol=1e-4,
                                       err_msg=key)
    x = np.random.RandomState(10).rand(2, 32, 32, 3).astype(np.float32)
    pool3 = np.asarray(jax.jit(model.apply)(calibrated, jnp.asarray(x)))
    with torch.no_grad():
        assert _rel_err(net(_nchw(x)).numpy(), pool3) <= 1e-3
