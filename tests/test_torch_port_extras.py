"""Port parity for the small modules: the DCGAN pair (models/dcgan.py),
``setup_logging`` (utils/logging.py) and the profiling hooks
(utils/profiling.py).

DCGAN: the JAX package's shapes (tests/test_data_extras.py::TestDCGAN), and
values on converted weights (``dcgan_state_dict_from_jax``) in eval and in
train mode (BatchNorm with batch statistics, running buffers updated at
PyTorch's momentum 0.1 = flax's 0.9), batch 4: within 1e-5 (f32 convolutions
summed in another order; the tanh output is bounded by 1).
"""

import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soft_intro_vae_tpu.models.dcgan import DCGANEncoder as JaxEncoder
from soft_intro_vae_tpu.models.dcgan import DCGANGenerator as JaxGenerator
from soft_intro_vae_torch.models.dcgan import NZ, DCGANEncoder, DCGANGenerator
from soft_intro_vae_torch.utils import profiling
from soft_intro_vae_torch.utils.from_jax import dcgan_state_dict_from_jax
from soft_intro_vae_torch.utils.logging import setup_logging
from tests.torch_port_fixtures import one_torch_thread  # noqa: F401

B = 4


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, dtype=np.float32), tree)


def test_dcgan_roundtrip_shapes():
    gen, enc = DCGANGenerator().eval(), DCGANEncoder().eval()
    with torch.no_grad():
        x = gen(torch.zeros(1, NZ))
        assert x.shape == (1, 3, 32, 32)
        assert float(x.abs().max()) <= 1.0  # tanh output
        assert enc(x).shape == (1, NZ)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_dcgan_generator_matches_jax(train):
    z = np.random.RandomState(0).randn(B, NZ).astype(np.float32)
    jg = JaxGenerator()
    v = jg.init(jax.random.key(0), jnp.asarray(z), train=False)
    gen = DCGANGenerator()
    gen.load_state_dict(dcgan_state_dict_from_jax(_np_tree(v["params"]),
                                                  _np_tree(v["batch_stats"]), "generator"))
    gen.train(train)
    if train:
        want, upd = jg.apply(v, jnp.asarray(z), train=True, mutable=["batch_stats"])
    else:
        want = jg.apply(v, jnp.asarray(z), train=False)
    got = gen(torch.tensor(z)).detach().numpy().transpose(0, 2, 3, 1)
    assert got.shape == (B, 32, 32, 3)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)
    if train:  # running means: same momentum (running variances differ by n/(n-1))
        for i in range(3):
            np.testing.assert_allclose(gen.main[3 * i + 1].running_mean.numpy(),
                                       np.asarray(upd["batch_stats"][f"bn{i}"]["mean"]),
                                       rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_dcgan_encoder_matches_jax(train):
    x = (np.random.RandomState(1).rand(B, 32, 32, 3) * 2 - 1).astype(np.float32)
    je = JaxEncoder()
    v = je.init(jax.random.key(1), jnp.asarray(x), train=False)
    enc = DCGANEncoder()
    enc.load_state_dict(dcgan_state_dict_from_jax(_np_tree(v["params"]),
                                                  _np_tree(v["batch_stats"]), "encoder"))
    enc.train(train)
    if train:
        want, _ = je.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    else:
        want = je.apply(v, jnp.asarray(x), train=False)
    got = enc(torch.tensor(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))).detach().numpy()
    assert got.shape == (B, NZ)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)


def test_dcgan_state_dict_names_and_momentum():
    gen = DCGANGenerator()
    names = [k for k in gen.state_dict() if k.endswith("weight")]
    assert names == ["main.0.weight", "main.1.weight", "main.3.weight", "main.4.weight",
                     "main.6.weight", "main.7.weight", "main.9.weight"]
    assert gen.main[0].weight.shape == (NZ, 512, 4, 4)  # ConvTranspose2d: (in, out, kh, kw)
    assert all(m.momentum == 0.1 for m in gen.modules() if isinstance(m, torch.nn.BatchNorm2d))


# ------------------------------------------------------------- logging --

def test_logging_file_and_console_handlers(tmp_path):
    log = setup_logging(str(tmp_path), name="sivae-torch-test")
    log.info("hello world")
    for h in log.handlers:
        h.flush()
    assert "hello world" in open(tmp_path / "log.txt").read()
    assert len(log.handlers) == 2
    assert not log.propagate


def test_logging_idempotent_setup(tmp_path):
    setup_logging(str(tmp_path), name="sivae-torch-test2")
    log = setup_logging(str(tmp_path), name="sivae-torch-test2")
    assert len(log.handlers) == 2  # no handler duplication


def test_logging_console_only_and_level():
    log = setup_logging(None, name="sivae-torch-test3", level=logging.WARNING)
    assert len(log.handlers) == 1 and log.level == logging.WARNING


# ----------------------------------------------------------- profiling --

def test_trace_writes_a_chrome_trace_with_annotations(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("port-region"):
            torch.randn(32, 32) @ torch.randn(32, 32)
    path = tmp_path / profiling.TRACE_FILE
    events = json.load(open(path))["traceEvents"]
    assert any(e.get("name") == "port-region" for e in events)
    assert any(e.key == "port-region" for e in prof.key_averages())


def test_step_timer_excludes_warmup():
    timer = profiling.StepTimer(warmup=2)
    assert np.isnan(timer.steps_per_sec())
    for _ in range(2):
        timer.tick(torch.ones(2))
    assert np.isnan(timer.steps_per_sec())  # only warm-up steps so far
    for _ in range(3):
        timer.tick({"loss": torch.ones(())})
    rate = timer.steps_per_sec([torch.ones(1), (torch.zeros(1),)])
    assert timer.count == 5 and np.isfinite(rate) and rate > 0


def test_profiling_imports_no_jax():
    src = open(os.path.join(os.path.dirname(profiling.__file__), "profiling.py")).read()
    assert "jax" not in src
