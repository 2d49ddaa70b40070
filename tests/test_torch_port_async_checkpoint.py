"""Async checkpoint saves of the port (utils/checkpoint.py ``save(...,
async_save=True)`` and ``wait()``), the JAX Checkpointer's behaviour
(soft_intro_vae_tpu/utils/checkpoint.py:102-150).

``torch.save`` writes a serialization id of its own into every archive, so
two saves of one dict differ in bytes: an async save is held to a
synchronous save's payload tensor by tensor (``torch.equal``), and its
``.aux.json`` and pointer file byte for byte.
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from soft_intro_vae_torch.data.images import ArrayDataset, ImageSpec
from soft_intro_vae_torch.models.conv import SoftIntroVAE
from soft_intro_vae_torch.train.image import ImageConfig, train_soft_intro_vae
from soft_intro_vae_torch.train.state import TrainState
from soft_intro_vae_torch.utils.checkpoint import Checkpointer, to_host
from tests.torch_port_fixtures import one_torch_thread  # noqa: F401


def _state(seed=0):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = SoftIntroVAE(cdim=3, zdim=8, channels=(8, 16), image_size=16)
    return TrainState.create(model, device=torch.device("cpu"), seed=seed, lr_e=2e-4, lr_d=2e-4)


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def _assert_payloads_equal(a, b):
    assert type(a) is type(b)
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_payloads_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_payloads_equal(x, y)
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b)
    else:
        assert a == b


def _step(state):
    """An in-place update of every parameter, as a step makes."""
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(1.0)


def test_async_save_equals_a_sync_save(tmp_path):
    state = _state()
    aux = {"tracker": {"loss": [1.0, 2.0]}, "best_fid": None}
    sync = Checkpointer(str(tmp_path / "sync"))
    asyn = Checkpointer(str(tmp_path / "async"))
    p_sync = sync.save(state, 3, 7, aux=aux)
    p_async = asyn.save(state, 3, 7, aux=aux, async_save=True)
    asyn.wait()
    _assert_payloads_equal(_load(p_sync), _load(p_async))
    for suffix in (".aux.json",):
        assert open(p_sync + suffix, "rb").read() == open(p_async + suffix, "rb").read()
    for d in ("sync", "async"):
        assert open(tmp_path / d / "last_checkpoint").read() == os.path.basename(p_sync)


def test_async_save_holds_the_state_at_the_call(tmp_path, monkeypatch):
    """The writer thread is held back until the state and aux have been
    changed in place: the file still holds the values at the call."""
    state = _state()
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    aux = {"tracker": {"loss": [1.0]}}
    gate = threading.Event()
    real_write = Checkpointer._write

    def held_write(self, path, payload, aux_):
        assert gate.wait(30)
        real_write(self, path, payload, aux_)

    monkeypatch.setattr(Checkpointer, "_write", held_write)
    ck = Checkpointer(str(tmp_path))
    path = ck.save(state, 1, 0, aux=aux, async_save=True)
    _step(state)                      # the next step updates the tensors in place
    aux["tracker"]["loss"].append(9.0)  # and the tracker moves on
    gate.set()
    ck.wait()
    got = _load(path)["model"]
    for k, v in before.items():
        assert torch.equal(got[k], v), k
    assert not torch.equal(got["encoder.fc.weight"], state.model.state_dict()["encoder.fc.weight"])
    assert json.load(open(path + ".aux.json")) == {"tracker": {"loss": [1.0]}}


def test_back_to_back_saves_wait_for_each_other(tmp_path, monkeypatch):
    """A second save waits for the one in flight: the pointer ends at the
    second file, and both files hold their own state."""
    state = _state()
    real_write = Checkpointer._write
    order = []

    def slow_write(self, path, payload, aux_):
        time.sleep(0.2)
        real_write(self, path, payload, aux_)
        order.append(os.path.basename(path))

    monkeypatch.setattr(Checkpointer, "_write", slow_write)
    ck = Checkpointer(str(tmp_path))
    first = {k: v.clone() for k, v in state.model.state_dict().items()}
    p1 = ck.save(state, 1, 0, async_save=True)
    _step(state)
    second = {k: v.clone() for k, v in state.model.state_dict().items()}
    p2 = ck.save(state, 2, 0, async_save=True)
    ck.wait()
    assert order == [os.path.basename(p1), os.path.basename(p2)]
    assert ck.latest_path() == p2
    for path, want in ((p1, first), (p2, second)):
        got = _load(path)["model"]
        for k, v in want.items():
            assert torch.equal(got[k], v), k


def test_wait_drains_and_reraises_a_failed_save(tmp_path, monkeypatch):
    ck = Checkpointer(str(tmp_path))
    ck.wait()  # nothing in flight
    state = _state()
    path = ck.save(state, 1, 0, async_save=True)
    ck.wait()
    assert ck._thread is None and os.path.exists(path)

    def broken_write(self, path, payload, aux_):
        raise OSError("disk full")

    monkeypatch.setattr(Checkpointer, "_write", broken_write)
    ck.save(state, 2, 0, async_save=True)
    with pytest.raises(RuntimeError, match="async checkpoint save failed"):
        ck.wait()
    ck.wait()  # the error is raised once


def test_latest_path_waits_for_the_save_in_flight(tmp_path, monkeypatch):
    real_write = Checkpointer._write

    def slow_write(self, path, payload, aux_):
        time.sleep(0.2)
        real_write(self, path, payload, aux_)

    monkeypatch.setattr(Checkpointer, "_write", slow_write)
    ck = Checkpointer(str(tmp_path))
    path = ck.save(_state(), 4, 0, async_save=True)
    assert ck.latest_path() == path


def test_to_host_copies_every_tensor():
    t = torch.arange(4.0)
    tree = {"a": t, "b": [t, (t, 3)], "c": "x"}
    out = to_host(tree)
    t.add_(1.0)
    assert torch.equal(out["a"], torch.arange(4.0))
    assert torch.equal(out["b"][1][0], torch.arange(4.0)) and out["b"][1][1] == 3
    assert isinstance(out["b"][1], tuple) and out["c"] == "x"


def test_image_trainer_async_interval_saves_reload_to_their_epoch(tmp_path, monkeypatch):
    """The image trainer's interval saves are async: each file holds the
    state of its epoch, the run returns with nothing in flight, and the
    checkpoint resumes."""
    saved = []
    real_save = Checkpointer.save

    def recording_save(self, state, epoch, iteration=0, tag="", aux=None, async_save=False):
        saved.append((epoch, async_save, {k: v.clone() for k, v in
                                          state.model.state_dict().items()}))
        return real_save(self, state, epoch, iteration, tag, aux, async_save)

    monkeypatch.setattr(Checkpointer, "save", recording_save)
    spec = ImageSpec("cifar10", 16, (8, 16), 3)
    data = np.random.default_rng(0).integers(0, 256, (8, 16, 16, 3), dtype=np.uint8)
    cfg = ImageConfig(dataset="cifar10", z_dim=8, batch_size=4, num_epochs=3, num_vae=1,
                      beta_neg=16.0, seed=0, save_interval=1, result_dir=str(tmp_path),
                      device="cpu", verbose=False)
    state, _ = train_soft_intro_vae(cfg, ArrayDataset(data, seed=1), spec)
    assert [(e, a) for e, a, _ in saved] == [(1, True), (2, True), (2, False)]
    saves = os.listdir(tmp_path / "saves")
    for epoch, _, want in saved[:2]:  # 2 steps an epoch
        names = [n for n in saves if n.endswith(f"model_epoch_{epoch}_iter_{2 * epoch}.ckpt")]
        assert len(names) == 1, saves
        got = _load(str(tmp_path / "saves" / names[0]))["model"]
        for k, v in want.items():
            assert torch.equal(got[k], v), (epoch, k)
