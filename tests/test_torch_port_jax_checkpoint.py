"""Port: the JAX package's checkpoint files read by the port.

* The reader (``utils/flax_msgpack.py``) against ``flax.serialization.
  msgpack_restore``, leaf by leaf and bit for bit (the bytes, the dtype and
  the shape of every array): a ``TrainState`` and a ``StyleTrainState`` as
  the JAX ``save_checkpoint`` writes them, bfloat16 arrays and scalars,
  numpy scalars, complex leaves, leaves chunked above a lowered
  ``MAX_CHUNK_SIZE``, and every msgpack type and width. In a fresh
  interpreter that cannot import ``jax``, ``flax``, ``msgpack`` or the JAX
  package, the reader and the port's ``Checkpointer`` load a committed JAX
  checkpoint.
* The format is told by the first bytes: a file in neither format raises,
  naming the path and both formats; a JAX tree that does not match the
  target's config raises, naming the first leaf that differs, and loads
  nothing; torch's zip and legacy pickle files still load. A load writes
  into the tensors the state holds (parameters, Adam's moments and counts,
  the LR tensors), which a captured CUDA graph reads.
* The image, bootstrap and toy states (the 3D and style ones are in
  tests/test_torch_port_jax_runs.py): the JAX trainer's build function makes
  the state at a tiny width, JAX trains 2 intro steps with injected draws and
  saves through its ``Checkpointer``; the port's build function makes its
  state and loads the file through ``Checkpointer.load_latest``. The carried
  weights, BN statistics, Adam moments and counts, LRs and step are the JAX
  tree's, bit for bit, and the generator is seeded from the key's words.
  Then both take 2 more intro steps on the same batches and draws, held as
  the step parity tests hold them: image and bootstrap
  (tests/test_torch_port_image_step.py) loss_e and loss_d within rel 1e-4,
  the other metrics rel 1e-4 abs 1e-6, every weight and running mean within
  atol 1e-6 and each tensor's update within 1e-3 of its norm; toy
  (tests/test_torch_port_toy.py) every metric within rel 1e-5 (abs 1e-7 for
  the non-losses), every weight within atol 1e-5.
* ``pretrained`` of the image and toy trainers and ``figures``' model load
  take a JAX file and run on from it.
"""

import dataclasses
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from soft_intro_vae_tpu.data.images import ArrayDataset as JaxArrayDataset
from soft_intro_vae_tpu.data.images import ImageSpec as JaxImageSpec
from soft_intro_vae_tpu.train import image as jax_image
from soft_intro_vae_tpu.train import toy as jax_toy
from soft_intro_vae_tpu.train.lreq_adam import scale_by_lreq_adam
from soft_intro_vae_tpu.train.style_step import StyleModel as JaxStyleModel
from soft_intro_vae_tpu.train.style_step import StyleModelConfig as JaxStyleModelConfig
from soft_intro_vae_tpu.train.style_step import StyleTrainState as JaxStyleTrainState
from soft_intro_vae_tpu.utils import checkpoint as jax_checkpoint
from soft_intro_vae_torch.cli import figures
from soft_intro_vae_torch.data.images import ArrayDataset, ImageSpec
from soft_intro_vae_torch.train.image import ImageConfig, build_image_training, train_soft_intro_vae
from soft_intro_vae_torch.train.step import INTRO_NOISES
from soft_intro_vae_torch.train.style import StyleConfig, build_style_training
from soft_intro_vae_torch.train.toy import ToyConfig, build_toy, train_soft_intro_vae_toy
from soft_intro_vae_torch.utils import flax_msgpack
from soft_intro_vae_torch.utils.checkpoint import Checkpointer, load_checkpoint, load_pretrained
from soft_intro_vae_torch.utils.from_jax import (
    image_state_dict_from_jax, mlp_state_dict_from_jax, seed_from_jax_key,
    style_state_dict_from_jax)
from tests.torch_port_fixtures import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "torch_port_fixtures", "jax_checkpoints")


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, dtype=np.float32), tree)


# ------------------------------------------------------------------ reader ---

def _assert_same_tree(want, got, where="root"):
    """``got`` (the port's reader) is ``want`` (flax's), leaf by leaf, bit for bit."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), where
        for k in want:
            _assert_same_tree(want[k], got[k], f"{where}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), where
        for i, (w, g) in enumerate(zip(want, got)):
            _assert_same_tree(w, g, f"{where}[{i}]")
    elif isinstance(want, (np.ndarray, np.generic)) and want.dtype == jnp.bfloat16:
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16, where
        assert tuple(got.shape) == np.shape(want), where
        assert np.array_equal(got.view(torch.int16).numpy().view(np.uint16),
                              np.asarray(want).view(np.uint16)), where
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want) and got.dtype == want.dtype, where
        assert got.shape == want.shape and got.tobytes() == want.tobytes(), where
    else:
        assert type(got) is type(want) and got == want, (where, got, want)


def _jax_toy_state(**kw):
    cfg = jax_toy.ToyConfig(z_dim=2, n_layers=1, num_hidden=8, seed=0, **kw)
    return jax_toy.build_toy(cfg)[2]


def _jax_style_state():
    jmodel = JaxStyleModel(JaxStyleModelConfig(startf=4, maxf=8, layer_count=2, latent_size=8,
                                               mapping_layers=2))
    pe, pd, buf = jax.jit(jmodel.init_params)(jax.random.key(3))
    opt = scale_by_lreq_adam(beta2=0.99)
    return JaxStyleTrainState(
        step=jnp.asarray(5, jnp.int32), params_e=pe, params_d=pd, buffers=buf, ema_e=pe,
        ema_d=pd, ema_buffers=buf, opt_e=opt.init(pe), opt_d=opt.init(pd),
        lr=jnp.asarray(1e-3, jnp.float32), ema_beta=jnp.asarray(0.9, jnp.float32),
        rng=jax.random.key(1))


def _saved_bytes(tmp_path, state):
    path = jax_checkpoint.save_checkpoint(str(tmp_path / "s.ckpt"), state, epoch=3, iteration=9,
                                          extra={"note": "x"})
    with open(path, "rb") as f:
        return f.read()


def _msgpack_types():
    """A tree of every msgpack type and width flax's writer emits."""
    return {"ints": [0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**63, -1, -32,
                     -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63],
            "floats": [0.5, -1e300, float("inf")], "flags": [True, False, None],
            "strs": ["", "é" * 20, "s" * 40, "t" * 300, "u" * 70000], "bins": b"\x00" * 70000,
            "nested": {str(i): {"x": [i, {"y": np.arange(i, dtype=np.int16)}]} for i in range(20)},
            "big_map": {f"k{i}": i for i in range(70000)},
            "arrays": {"f64": np.linspace(0, 1, 7), "u8": np.arange(300, dtype=np.uint8),
                       "bool": np.array([True, False]), "i64": np.array(-5, np.int64),
                       "empty": np.zeros((0, 3), np.float32), "f16": np.ones((2, 2), np.float16)}}


TREES = {
    "train_state": lambda tmp: _saved_bytes(tmp, _jax_toy_state()),
    "style_state": lambda tmp: _saved_bytes(tmp, _jax_style_state()),
    "bfloat16": lambda tmp: serialization.msgpack_serialize(
        {"a": jnp.arange(12, dtype=jnp.bfloat16).reshape(3, 4) / 7, "s": jnp.bfloat16(2.5)}),
    "npscalar": lambda tmp: serialization.msgpack_serialize(
        {"f": np.float32(1.25), "i": np.int64(-3), "u": np.uint8(7), "b": np.bool_(True),
         "c": np.complex64(1 - 2j)}),
    "complex": lambda tmp: serialization.msgpack_serialize(
        {"native": complex(1.5, -2.0), "array": np.array([1 + 2j, 3 - 4j], np.complex128)}),
    "msgpack_types": lambda tmp: serialization.msgpack_serialize(_msgpack_types()),
}


@pytest.mark.parametrize("name", list(TREES))
def test_reader_matches_flax_leaf_by_leaf(tmp_path, name):
    data = TREES[name](tmp_path)
    _assert_same_tree(serialization.msgpack_restore(data), flax_msgpack.loads(data))


def test_reader_restores_chunked_leaves(monkeypatch):
    """Leaves above MAX_CHUNK_SIZE (lowered here to 64 bytes) are written as
    chunk maps; they come back as the arrays, at any depth and at the top."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    for tree in ({"a": {"b": np.arange(101, dtype=np.float32).reshape(101, 1)},
                  "c": jnp.arange(70, dtype=jnp.bfloat16), "small": np.arange(3)},
                 np.arange(50, dtype=np.int64)):
        data = serialization.msgpack_serialize(tree)
        assert flax_msgpack.CHUNKED.encode() in data
        _assert_same_tree(serialization.msgpack_restore(data), flax_msgpack.loads(data))


BLOCKED = """
import importlib.abc, json, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "msgpack", "soft_intro_vae_tpu"):
            raise ImportError("blocked: " + name)

sys.meta_path.insert(0, Block())
import dataclasses
import numpy as np
from soft_intro_vae_torch.train.threed import ThreeDConfig, build_3d_training
from soft_intro_vae_torch.utils import flax_msgpack
from soft_intro_vae_torch.utils.checkpoint import Checkpointer

fixture = sys.argv[1]
tree = flax_msgpack.load(fixture + "/model_epoch_2_iter_4.ckpt")
over = json.loads(str(np.load(fixture + "/next_steps.npz")["config"]))
cfg = dataclasses.replace(ThreeDConfig.from_json("configs/soft_intro_vae_hp.json"), **over,
                          device="cpu")
state = build_3d_training(cfg)[0]
_, epoch = Checkpointer(fixture).load_latest(state)
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "msgpack"))
print(json.dumps({"epoch": epoch, "step": state.step, "tree_step": int(tree["state"]["step"]),
                  "loaded": loaded}))
"""


def test_reader_and_carry_need_no_jax_flax_or_msgpack():
    out = subprocess.run([sys.executable, "-c", BLOCKED, os.path.join(FIXTURES, "threed")],
                         capture_output=True, text=True, cwd=ROOT, timeout=300,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    import json

    assert json.loads(out.stdout.strip().splitlines()[-1]) == {
        "epoch": 2, "step": 4, "tree_step": 4, "loaded": []}


# ---------------------------------------------------------- format dispatch ---

TOY = dict(z_dim=2, batch_size=8, n_layers=2, num_hidden=16, seed=0, lr_e=1e-3, lr_d=1e-3,
           beta_rec=0.2, beta_kl=0.3, beta_neg=0.9, gamma_r=1e-8, verbose=False)


def _toy_port(**kw):
    cfg = dict(z_dim=2, n_layers=1, num_hidden=8, seed=1, device="cpu", verbose=False)
    return build_toy(ToyConfig(**{**cfg, **kw}))[0]


@pytest.mark.parametrize("contents", [b"not a checkpoint", pickle.dumps({"a": 1}, protocol=4),
                                      b"", np.float32(1).tobytes()],
                         ids=["text", "pickle", "empty", "raw"])
def test_a_file_in_neither_format_raises(tmp_path, contents):
    path = tmp_path / "x.ckpt"
    path.write_bytes(contents)
    with pytest.raises(ValueError, match="neither a torch checkpoint .* nor a JAX") as e:
        load_checkpoint(str(path), _toy_port())
    assert str(path) in str(e.value)


def test_torch_files_of_both_formats_still_load(tmp_path):
    """torch.save's zip archive and its pre-1.6 pickle stream go to torch.load."""
    src = _toy_port(seed=3)
    for legacy in (False, True):
        path = str(tmp_path / f"t{legacy}.ckpt")
        torch.save({**src.state_dict(), "epoch": 2}, path,
                   _use_new_zipfile_serialization=not legacy)
        dst = _toy_port()
        assert load_checkpoint(path, dst)[1] == 2
        assert all(torch.equal(v, src.model.state_dict()[k])
                   for k, v in dst.model.state_dict().items())


def test_malformed_msgpack_raises(tmp_path):
    data = _saved_bytes(tmp_path, _jax_toy_state())
    cases = {"truncated": (data[:len(data) // 2], "ends at byte"),
             "trailing": (data + b"\x00", "bytes after the first msgpack object"),
             "not a checkpoint": (serialization.msgpack_serialize({"a": 1}), "holds")}
    for name, (blob, match) in cases.items():
        path = tmp_path / f"{name}.ckpt"
        path.write_bytes(blob)
        with pytest.raises(ValueError, match=match):
            load_checkpoint(str(path), _toy_port())


def _state_tensors(state):
    sd = state.state_dict()
    out = {f"model.{k}": v.clone() for k, v in sd["model"].items()}
    for opt in ("opt_e", "opt_d"):
        for i, st in sd[opt]["state"].items():
            out.update({f"{opt}.{i}.{k}": v.clone() for k, v in st.items()})
    return out, (state.step, state.lr_e, state.lr_d, state.generator.get_state().clone())


@pytest.mark.parametrize("target, match", [
    (dict(num_hidden=16), r"encoder\.main\.input\.weight is \(8, 2\) in the JAX checkpoint, "
                          r"\(16, 2\) in the target"),
    (dict(n_layers=2), r"nothing for encoder\.main\.hidden_2\.weight"),
    (dict(z_dim=3), r"encoder\.main\.output\.weight is \(4, 8\) in the JAX checkpoint"),
], ids=["width", "depth", "latent"])
def test_a_mismatched_tree_raises_and_loads_nothing(tmp_path, target, match):
    jax_checkpoint.Checkpointer(str(tmp_path)).save(_jax_toy_state(), 1, 0)
    state = _toy_port(**target)
    before, scalars = _state_tensors(state)
    with pytest.raises(ValueError, match=match) as e:
        Checkpointer(str(tmp_path)).load_latest(state)
    assert "model_epoch_1_iter_0.ckpt" in str(e.value)
    after, scalars_after = _state_tensors(state)
    assert after.keys() == before.keys() and all(torch.equal(before[k], after[k]) for k in before)
    assert scalars[:3] == scalars_after[:3] and torch.equal(scalars[3], scalars_after[3])


def test_a_tree_of_another_state_class_raises(tmp_path):
    jax_checkpoint.save_checkpoint(str(tmp_path / "style.ckpt"), _jax_style_state())
    with pytest.raises(ValueError, match="no state/stats_e"):
        load_checkpoint(str(tmp_path / "style.ckpt"), _toy_port())
    _, state = build_style_training(_style_cfg(tmp_path))
    jax_checkpoint.save_checkpoint(str(tmp_path / "toy.ckpt"), _jax_toy_state())
    with pytest.raises(ValueError, match="no state/buffers"):
        load_checkpoint(str(tmp_path / "toy.ckpt"), state)
    with pytest.raises(TypeError, match="TrainState or a StyleTrainState, not a Linear"):
        load_checkpoint(str(tmp_path / "toy.ckpt"), torch.nn.Linear(2, 2))


def test_a_checkpoint_loads_into_the_tensors_a_graph_reads(tmp_path):
    """A state whose step ran (so a CUDA graph could hold its tensors) takes
    a checkpoint into those same tensors: parameters, BN-free nets' buffers,
    Adam's moments and counts, the LR tensors."""
    _, _, jstate, _, jintro = jax_toy.build_toy(jax_toy.ToyConfig(**TOY))
    jax_checkpoint.Checkpointer(str(tmp_path)).save(jstate, 1, 0)
    state, _, intro = build_toy(ToyConfig(**TOY, device="cpu"))
    rs = np.random.RandomState(0)
    intro(state, torch.from_numpy(rs.randn(8, 2).astype(np.float32)))
    held = [t for st in state.opt_e.state.values() for t in st.values()]
    held += list(state.model.parameters()) + [state.opt_e.param_groups[0]["lr"]]
    ptrs = [t.data_ptr() for t in held]
    Checkpointer(str(tmp_path)).load_latest(state)
    now = [t for st in state.opt_e.state.values() for t in st.values()]
    now += list(state.model.parameters()) + [state.opt_e.param_groups[0]["lr"]]
    assert [t.data_ptr() for t in now] == ptrs
    assert all(float(st["step"]) == 0 and not st["exp_avg"].any()
               for st in state.opt_e.state.values())
    want = _toy_sd(jstate)
    assert all(torch.equal(v, want[k]) for k, v in state.model.state_dict().items())


# ------------------------------------------------- image, bootstrap, toy ---

CH, IMG, Z, B = (8, 16), 16, 8, 4
SPEC = ("cifar10", IMG, CH, 3)


def _image_cfgs(tmp_path, boot: bool):
    kw = dict(dataset="cifar10", z_dim=Z, batch_size=B, seed=0, beta_neg=16.0, verbose=False,
              bootstrap=boot, gamma_r=1.0 if boot else 1e-8, num_devices=1,
              result_dir=str(tmp_path / "jax"))
    return jax_image.ImageConfig(**kw), ImageConfig(**{**kw, "result_dir": str(tmp_path / "port"),
                                                        "device": "cpu"})


def _image_sd(jstate, boot, which="params"):
    get = {"params": lambda: (jstate.params_e, jstate.params_d),
           "mu": lambda: (jstate.opt_e.mu, jstate.opt_d.mu),
           "nu": lambda: (jstate.opt_e.nu, jstate.opt_d.nu)}[which]
    pe, pd = get()
    t = (_np_tree(jstate.params_d_target), _np_tree(jstate.stats_d_target)) \
        if boot and which == "params" else (None, None)
    return image_state_dict_from_jax(_np_tree(pe), _np_tree(jstate.stats_e), _np_tree(pd),
                                     _np_tree(jstate.stats_d), CH, IMG, *t)


def _toy_sd(jstate, which="params"):
    get = {"params": lambda: (jstate.params_e, jstate.params_d),
           "mu": lambda: (jstate.opt_e.mu, jstate.opt_d.mu),
           "nu": lambda: (jstate.opt_e.nu, jstate.opt_d.nu)}[which]
    pe, pd = get()
    return {**mlp_state_dict_from_jax(_np_tree(pe), 2, "encoder."),
            **mlp_state_dict_from_jax(_np_tree(pd), 2, "decoder.")}


def _assert_carried(state, jstate, to_sd):
    """The port's state is the JAX tree's, bit for bit: weights and BN
    statistics, both Adams' moments and counts, the LRs and the step; the
    generator seeded from the key's words."""
    got = state.model.state_dict()
    for k, v in to_sd(jstate, "params").items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(got[k], v), k
    mu, nu = to_sd(jstate, "mu"), to_sd(jstate, "nu")
    for opt, net, count in (("opt_e", "encoder", jstate.opt_e.count),
                            ("opt_d", "decoder", jstate.opt_d.count)):
        o = getattr(state, opt)
        for name, p in getattr(state.model, net).named_parameters():
            st = o.state[p]
            assert torch.equal(st["exp_avg"], mu[f"{net}.{name}"]), name
            assert torch.equal(st["exp_avg_sq"], nu[f"{net}.{name}"]), name
            assert float(st["step"]) == int(count) == 2
    assert state.step == int(jstate.step) == 2
    assert (state.lr_e, state.lr_d) == (float(jstate.lr_e), float(jstate.lr_d))
    assert state.generator.initial_seed() == seed_from_jax_key(jax.random.key_data(jstate.rng))


def _two_then_two(tmp_path, jstate, jintro, state, intro, batches, draws, to_sd):
    """JAX's 2 intro steps and save, the port's load, then 2 more steps on
    each side: (port metrics, JAX metrics) of those, the port state before them."""
    for x, nz in zip(batches[:2], draws[:2]):
        jstate, _ = jintro(jstate, jnp.asarray(x), {k: jnp.asarray(v) for k, v in nz.items()})
    jax_checkpoint.Checkpointer(str(tmp_path / "saves")).save(jstate, 1, 2)
    _, epoch = Checkpointer(str(tmp_path / "saves")).load_latest(state)
    assert epoch == 1
    _assert_carried(state, jstate, to_sd)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    ms, jms = [], []
    for x, nz in zip(batches[2:], draws[2:]):
        jstate, jm = jintro(jstate, jnp.asarray(x), {k: jnp.asarray(v) for k, v in nz.items()})
        state, m = intro(state, torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in nz.items()})
        assert set(m) == set(jm)
        ms.append({k: float(v) for k, v in m.items()})
        jms.append({k: float(v) for k, v in jm.items()})
    assert state.step == int(jstate.step) == 4
    return ms, jms, jstate, before


@pytest.mark.parametrize("boot", [False, True], ids=["image", "bootstrap"])
def test_image_state_carries_and_continues_as_jax(tmp_path, boot):
    jcfg, cfg = _image_cfgs(tmp_path, boot)
    _, _, jstate, _, jintro, _ = jax_image.build_image_training(jcfg, JaxImageSpec(*SPEC))
    if boot:
        jstate = jax_image.sync_target_decoder(jstate)
    state, _, intro = build_image_training(cfg, ImageSpec(*SPEC))
    rs = np.random.RandomState(21)
    batches = [rs.randint(0, 256, (B, IMG, IMG, 3)).astype(np.uint8) for _ in range(4)]
    draws = [{k: rs.randn(B, Z).astype(np.float32) for k in INTRO_NOISES} for _ in range(4)]
    ms, jms, jstate, before = _two_then_two(tmp_path, jstate, jintro, state, intro, batches,
                                            draws, lambda j, w: _image_sd(j, boot, w))
    for i, (m, jm) in enumerate(zip(ms, jms)):
        for k in ("loss_e", "loss_d"):
            assert m[k] == pytest.approx(jm[k], rel=1e-4), f"step {i} {k}"
        for k in ("rec", "kl_real", "kl_rec", "kl_fake", "expelbo_r", "expelbo_f"):
            assert m[k] == pytest.approx(jm[k], rel=1e-4, abs=1e-6), f"step {i} {k}"
    want, got = _image_sd(jstate, boot), state.model.state_dict()
    for k, w in want.items():
        if k.endswith(("running_var", "num_batches_tracked")):
            continue
        g, b = got[k].numpy(), before[k].numpy()
        np.testing.assert_allclose(g, w.numpy(), rtol=0, atol=1e-6, err_msg=k)
        if not k.endswith("running_mean"):
            upd = np.linalg.norm(w.numpy() - b)
            assert np.linalg.norm((g - b) - (w.numpy() - b)) <= 1e-3 * upd + 1e-7, k


def test_toy_state_carries_and_continues_as_jax(tmp_path):
    _, _, jstate, _, jintro = jax_toy.build_toy(jax_toy.ToyConfig(**TOY))
    state, _, intro = build_toy(ToyConfig(**TOY, device="cpu"))
    rs = np.random.RandomState(3)
    batches = [(rs.randn(8, 2) * 2).astype(np.float32) for _ in range(4)]
    draws = [{k: rs.randn(8, 2).astype(np.float32) for k in INTRO_NOISES} for _ in range(4)]
    ms, jms, jstate, _ = _two_then_two(tmp_path, jstate, jintro, state, intro, batches, draws,
                                       _toy_sd)
    for i, (m, jm) in enumerate(zip(ms, jms)):
        for k in ("loss_e", "loss_d"):
            assert m[k] == pytest.approx(jm[k], rel=1e-5), f"step {i} {k}"
        for k in ("rec", "kl_real", "kl_rec", "kl_fake", "expelbo_r", "expelbo_f"):
            assert m[k] == pytest.approx(jm[k], rel=1e-5, abs=1e-7), f"step {i} {k}"
    want = _toy_sd(jstate)
    for k, v in state.model.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=1e-5, msg=k)


# --------------------------------------------------- pretrained, figures ---

def test_image_pretrained_takes_a_jax_file(tmp_path):
    """The JAX image trainer's checkpoint of epoch 1 as the port trainer's
    ``pretrained``, with ``start_epoch`` 1: the port runs epoch 1 on from the
    JAX state (its step goes on from JAX's) on the batches the JAX trainer
    feeds in its epoch 1."""
    data = np.random.default_rng(0).integers(0, 256, (12, IMG, IMG, 3), dtype=np.uint8)
    jcfg, cfg = _image_cfgs(tmp_path, False)
    jcfg = dataclasses.replace(jcfg, num_epochs=2, num_vae=1, save_interval=1)
    fed = {}
    real_build = jax_image.build_image_training

    def recording_build(*args, **kwargs):
        enc, dec, state, vanilla, intro, mesh = real_build(*args, **kwargs)

        def rec(step):
            def run(state, x, *rest):
                fed.setdefault("jax", []).append(np.asarray(x))
                return step(state, x, *rest)
            return run
        return enc, dec, state, rec(vanilla), rec(intro), mesh

    jax_image.build_image_training = recording_build
    try:
        jax_image.train_soft_intro_vae(jcfg, JaxArrayDataset(data, seed=1), JaxImageSpec(*SPEC))
    finally:
        jax_image.build_image_training = real_build
    path = tmp_path / "jax" / "saves" / "cifar10_soft_intro_betas_1.0_16.0_1.0_model_epoch_1_iter_3.ckpt"
    assert path.exists()
    from soft_intro_vae_torch.train import image as port_image

    real_port = port_image.build_image_training

    def recording_port(*args, **kwargs):
        state, vanilla, intro = real_port(*args, **kwargs)

        def run(state, x, *rest):
            fed.setdefault("port", []).append(x.numpy().copy())
            return intro(state, x, *rest)
        return state, vanilla, run

    port_image.build_image_training = recording_port
    try:
        state, summary = train_soft_intro_vae(
            dataclasses.replace(cfg, num_epochs=2, num_vae=1, pretrained=str(path), start_epoch=1),
            ArrayDataset(data, seed=1), ImageSpec(*SPEC))
    finally:
        port_image.build_image_training = real_port
    assert state.step == 6 and summary["epochs_run"] == 2
    assert len(fed["port"]) == 3
    for got, want in zip(fed["port"], fed["jax"][3:]):
        np.testing.assert_array_equal(got, want)


def test_toy_pretrained_takes_a_jax_file(tmp_path):
    _, _, jstate, _, jintro = jax_toy.build_toy(jax_toy.ToyConfig(**TOY))
    jax_checkpoint.Checkpointer(str(tmp_path / "saves")).save(jstate, 7, 7)
    path = str(tmp_path / "saves" / "model_epoch_7_iter_7.ckpt")
    state, _, _ = build_toy(ToyConfig(**TOY, device="cpu"))
    assert load_pretrained(path, state) == 7
    want = _toy_sd(jstate)
    assert all(torch.equal(v, want[k]) for k, v in state.model.state_dict().items())
    state, res = train_soft_intro_vae_toy(ToyConfig(**{**TOY, "n_iter": 3, "num_vae": 0},
                                                    test_iter=2, pretrained=path, device="cpu",
                                                    result_dir=str(tmp_path / "port")))
    assert state.step == 3 and all(np.isfinite(v) for v in res.values())


def _style_cfg(tmp_path):
    return StyleConfig(layer_count=2, start_channel_count=4, max_channel_count=8,
                       latent_space_size=8, mapping_layers=2, output_dir=str(tmp_path / "st"),
                       device="cpu", verbose=False)


def test_figures_load_a_jax_style_file(tmp_path):
    """``figures``' model load takes the JAX style state (its EMA nets draw
    the figures), and the samples come out finite."""
    jstate = _jax_style_state()
    path = jax_checkpoint.save_checkpoint(str(tmp_path / "style.ckpt"), jstate, epoch=4)
    model, state = figures.load_model(_style_cfg(tmp_path), path)
    want = style_state_dict_from_jax(_np_tree(jstate.ema_e), _np_tree(jstate.ema_d),
                                     _np_tree(jstate.ema_buffers))
    got = state.ema.state_dict()
    assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)
    images = figures.sample_images(model, state, 3, seed=1)
    assert images.shape == (3, 8, 8, 3) and np.isfinite(images).all()
