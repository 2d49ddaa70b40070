"""The style step's device scalars and its CUDA graph (train/lreq_adam.py,
train/style_step.py, models/style.py ``blend_lerp``, train/graph.py
``one_step``).

On the CPU:
  * LREQAdam with its count, bias correction and LR on the device against
    the JAX package's optax transform (train/lreq_adam.py) and
    ``apply_updates_with_lr``, five steps with a reset between them and a
    parameter left without a gradient in one step. Measured: the parameters
    bit-equal; ``nu`` within 2 float32 ulps (``addcmul`` rounds
    ``v * b2 + (1 - b2) * g * g`` in another order than XLA). Held at rtol
    1e-6 for both, the count exactly;
  * the state's scalar tensors keep their storage when the trainer fills them;
  * LREQAdam loads a state of the earlier form (an int count and a float
    LR), and the new form round-trips through a checkpoint;
  * a blended step given the blend as a float32 0-dim tensor equals the same
    step given the float, bit for bit, and both stay within
    tests/test_torch_port_style_step.py's tolerances of the JAX step;
  * the bf16 blend lerp of the encoder equals the JAX package's
    ``h_prev + (h - h_prev) * blend.astype(h.dtype)`` bit for bit.

On the card (``cuda`` marker; skipped here): graphed steps against eager
steps at a tiny width, bit-equal (stable, blended, remat), and each replay's
metrics kept apart.
"""

import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soft_intro_vae_tpu.train.lreq_adam import scale_by_lreq_adam
from soft_intro_vae_tpu.train.optim import apply_updates_with_lr
from soft_intro_vae_tpu.train.style_step import StyleStepConfig as JaxStyleStepConfig
from soft_intro_vae_tpu.train.style_step import build_style_steps as jax_build_style_steps
from soft_intro_vae_torch.models.style import blend_lerp
from soft_intro_vae_torch.train import style
from soft_intro_vae_torch.train.graph import one_step
from soft_intro_vae_torch.train.lreq_adam import LreqAdam
from soft_intro_vae_torch.train.style_step import (
    StyleModel,
    StyleModelConfig,
    StyleStepConfig,
    StyleTrainState,
    build_style_steps,
)
from soft_intro_vae_torch.utils.checkpoint import Checkpointer
from tests.test_torch_port_style_step import (  # noqa: F401  (weights: a fixture)
    LATENT,
    MODEL,
    STEP,
    _batch,
    _pair,
    _x,
    weights,
)
from tests.torch_port_fixtures import cuda_device, one_torch_thread  # noqa: F401

LR = 1.5e-3
RTOL_ADAM = 1e-6
SHAPES = {"a": (7, 5), "b": (3, 4, 4), "c": (11,)}


def _adam_runs(steps: int = 5, reset_at: int = 3, idle=(1, "c")):
    """The same gradients through optax + apply_updates_with_lr and through
    LreqAdam; yields (step, jax params, jax state, port params, port opt)."""
    rs = np.random.RandomState(0)
    p0 = {k: rs.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    opt = scale_by_lreq_adam(beta2=0.99)
    pj = {k: jnp.asarray(v) for k, v in p0.items()}
    st = opt.init(pj)
    names = sorted(SHAPES)
    ps = [torch.nn.Parameter(torch.tensor(p0[k])) for k in names]
    port = LreqAdam(ps, LR, 0.99)
    for step in range(steps):
        if step == reset_at:  # the trainer's LOD switch: a fresh optax state
            st = opt.init(pj)
            port.reset()
        g = {k: rs.randn(*s).astype(np.float32) * 10.0 ** rs.uniform(-3, 1)
             for k, s in SHAPES.items()}
        if step == idle[0]:  # no gradient: optax sees zeros
            g[idle[1]] = np.zeros(SHAPES[idle[1]], np.float32)
        u, st = opt.update({k: jnp.asarray(v) for k, v in g.items()}, st)
        pj = apply_updates_with_lr(pj, u, jnp.asarray(LR, jnp.float32))
        for p, k in zip(ps, names):
            p.grad = None if (step, k) == idle else torch.tensor(g[k])
        port.step()
        yield step, pj, st, dict(zip(names, ps)), port


def test_lreq_adam_device_scalars_match_optax():
    for step, pj, st, ps, port in _adam_runs():
        assert port.count.dtype == torch.int32 and int(port.count) == int(st.count), step
        for i, k in enumerate(sorted(SHAPES)):
            np.testing.assert_allclose(ps[k].detach().numpy(), np.asarray(pj[k]),
                                       rtol=RTOL_ADAM, atol=0, err_msg=f"step {step} {k}")
            np.testing.assert_allclose(port.nu[i].numpy(), np.asarray(st.nu[k]),
                                       rtol=RTOL_ADAM, atol=0, err_msg=f"step {step} nu {k}")
    assert int(port.count) == 2  # five steps, reset before the fourth


def test_lreq_adam_lr_is_read_from_its_tensor():
    # an LR filled in place between steps moves the next update, as it does in a graph
    ps = [torch.nn.Parameter(torch.ones(4))]
    opt = LreqAdam(ps, 1e-3)
    for lr in (1e-3, 0.0):
        ps[0].grad = torch.full((4,), 2.0)
        before = ps[0].detach().clone()
        opt.lr.fill_(lr)
        opt.step()
        assert bool((ps[0] != before).all()) == (lr > 0)


def _state():
    model = StyleModel(StyleModelConfig(**MODEL))
    nets = model.make_nets()
    return model, StyleTrainState.create(nets, device=torch.device("cpu"), seed=0, lr=LR,
                                         ema_beta=0.9)


def test_scalar_fills_keep_their_storage():
    _, state = _state()
    assert state.opt_e.lr is state.lr and state.opt_d.lr is state.lr
    held = [state.lr, state.ema_beta, state.opt_e.count, state.opt_d.count] + \
        state.opt_e.nu + state.opt_d.nu
    ptrs = [t.data_ptr() for t in held]
    for p in state.nets.parameters():
        p.grad = torch.ones_like(p)
    state.opt_e.step()
    state.opt_d.step()
    state.set_lr(2e-4)
    state.set_ema_beta(0.5)
    state.reset_optimizers()
    assert [t.data_ptr() for t in held] == ptrs
    assert float(state.lr) == pytest.approx(2e-4) and float(state.ema_beta) == 0.5
    assert int(state.opt_e.count) == int(state.opt_d.count) == 0
    assert all(not bool(v.any()) for v in state.opt_e.nu + state.opt_d.nu)
    for t in (state.lr, state.ema_beta):
        assert t.dtype == torch.float32 and t.dim() == 0


def test_lreq_adam_loads_the_earlier_form():
    ps = [torch.nn.Parameter(torch.zeros(3))]
    opt = LreqAdam(ps, 1e-3)
    nu = [torch.arange(3, dtype=torch.float32)]
    opt.load_state_dict({"count": 7, "nu": nu, "lr": 2.5e-4})  # an int count and a float LR
    assert opt.count.dtype == torch.int32 and int(opt.count) == 7
    assert opt.lr.dtype == torch.float32 and float(opt.lr) == np.float32(2.5e-4)
    assert torch.equal(opt.nu[0], nu[0])
    with pytest.raises(ValueError, match="2 tensors for 1"):
        opt.load_state_dict({"count": 1, "nu": nu * 2, "lr": 1e-3})


def test_style_state_round_trips_through_a_checkpoint(tmp_path):
    model, state = _state()
    _, intro = build_style_steps(model, StyleStepConfig(latent_size=LATENT, **STEP), 1, False)
    state, _ = intro(state, _x(_batch(np.random.RandomState(5), 1)[0]))
    state.set_lr(3e-4)
    state.set_ema_beta(0.75)
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save(state, epoch=0, iteration=1)
    payload = torch.load(ckpt.latest_path(), weights_only=True)
    assert {"nets", "ema", "opt_e", "opt_d", "step", "lr", "ema_beta", "rng"} <= set(payload)
    assert payload["opt_e"]["count"].dtype == torch.int32
    _, fresh = _state()
    fresh, epoch = ckpt.load_latest(fresh)
    assert epoch == 0 and fresh.step == state.step == 1
    for a, b in ((fresh.lr, state.lr), (fresh.ema_beta, state.ema_beta),
                 (fresh.opt_e.count, state.opt_e.count), (fresh.opt_d.count, state.opt_d.count)):
        assert torch.equal(a, b)
    assert fresh.opt_e.lr is fresh.lr  # loaded in place: the optimizers still share it
    for u, v in zip(fresh.opt_d.nu + fresh.opt_e.nu, state.opt_d.nu + state.opt_e.nu):
        assert torch.equal(u, v)


@pytest.mark.parametrize("phase", ["vanilla", "intro"])
def test_tensor_blend_equals_float_blend_and_jax(weights, phase):  # noqa: F811
    """LOD 2, blend 0.6 (not a bf16 or f32-exact value): two steps given the
    blend as a float32 0-dim tensor equal two given the float, bit for bit;
    the first step's losses stay within the JAX tolerance of
    tests/test_torch_port_style_step.py (rel 1e-4)."""
    scfg = dict(latent_size=LATENT, **STEP)
    runs = []
    for as_tensor in (False, True):
        jmodel, opt, jstate, model, state = _pair(weights)
        steps = build_style_steps(model, StyleStepConfig(**scfg), 2, True, noise_mode="none")
        step = steps[0] if phase == "vanilla" else steps[1]
        rs = np.random.RandomState(97)
        ms = []
        for _ in range(2):
            x, nz = _batch(rs, 2)
            blend = torch.tensor(0.6, dtype=torch.float32) if as_tensor else 0.6
            state, m = step(state, _x(x), blend, nz)
            ms.append(m)
        runs.append((state, ms))
    (sa, ma), (sb, mb) = runs
    for a, b in zip(ma, mb):
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    for which in ("nets", "ema"):
        da, db = getattr(sa, which).state_dict(), getattr(sb, which).state_dict()
        assert all(torch.equal(da[k], db[k]) for k in da), which
    jsteps = jax_build_style_steps(jmodel, JaxStyleStepConfig(**scfg), 2, True, opt,
                                   noise_mode="none")
    jstep = jsteps[0] if phase == "vanilla" else jsteps[1]
    x, nz = _batch(np.random.RandomState(97), 2)
    _, jm = jstep(jstate, jnp.asarray(x), jnp.asarray(0.6, jnp.float32),
                  {k: jnp.asarray(v) for k, v in nz.items()})
    for key in ("loss_e", "rec_loss", "real_kl"):
        assert float(mb[0][key]) == pytest.approx(float(jm[key]), rel=1e-4, abs=1e-7), key


# (blend, whether the unrounded float32 blend gives other bits on these inputs):
# 0.9991 rounds to bf16 1.0, and a product by 0.9991 rounds back to the same bf16
@pytest.mark.parametrize("blend,visible", [(0.6, True), (0.123456, True), (0.9991, False)])
def test_bf16_blend_lerp_matches_jax_bit_for_bit(blend, visible):
    rs = np.random.RandomState(7)
    h = rs.randn(2, 8, 5, 5).astype(np.float32)
    h_prev = rs.randn(2, 8, 5, 5).astype(np.float32)
    jh, jp = jnp.asarray(h, jnp.bfloat16), jnp.asarray(h_prev, jnp.bfloat16)
    jb = jnp.asarray(blend, jnp.float32)
    want = np.asarray((jp + (jh - jp) * jb.astype(jh.dtype)).astype(jnp.float32))
    th = torch.tensor(h).to(torch.bfloat16)
    tp = torch.tensor(h_prev).to(torch.bfloat16)
    for b in (torch.tensor(blend, dtype=torch.float32), blend):
        got = blend_lerp(tp, th, b)
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), want)
    # the unrounded float32 blend (the earlier form) rounds elsewhere: the test sees it
    unrounded = (tp + (th - tp) * blend).float().numpy()
    assert np.array_equal(unrounded, want) != visible


def test_one_step_runs_eagerly_on_the_cpu(weights):  # noqa: F811
    _, _, _, model, state = _pair(weights)
    _, intro = build_style_steps(model, StyleStepConfig(latent_size=LATENT, **STEP), 2, True,
                                 noise_mode="none")
    graphed = one_step(intro)
    x, nz = _batch(np.random.RandomState(4), 2)
    state, m = graphed(state, _x(x), 0.5)
    assert state.step == 1 and not graphed.graphed.graphs
    assert all(v.dim() == 0 and torch.isfinite(v) for v in m.values())


def test_trainer_wraps_every_step_and_drops_a_lods_steps(tmp_path, monkeypatch):
    """The trainer runs each (lod, blended) pair's steps through ``one_step``
    and lets go of a LOD's steps (on the card: its graphs and their memory
    pools) when the LOD driver moves on."""
    made, alive_at_make = [], []

    def recording(step):
        gc.collect()
        alive_at_make.append([r() is not None for r in made])
        wrapped = one_step(step)
        made.append(weakref.ref(wrapped))
        return wrapped

    monkeypatch.setattr(style, "one_step", recording)
    cfg = style.StyleConfig(layer_count=3, start_channel_count=8, max_channel_count=32,
                            latent_space_size=16, mapping_layers=3, use_synthetic=True,
                            synthetic_n=8, lod_2_batch_tables={"1GPU": [4, 4, 2]},
                            epochs_per_lod=2, train_epochs=4, output_dir=str(tmp_path / "run"),
                            device="cpu", verbose=False, resume=False, seed=3)
    state, summary = style.train_style_soft_intro_vae(cfg)
    assert summary["lods_seen"] == [0, 1] and state.step == 8
    # LOD 0 (its vanilla and intro pair), then LOD 1 blended and LOD 1 stable
    assert len(made) == 6
    assert alive_at_make[2] == [False, False]  # LOD 0's pair let go at the switch
    assert alive_at_make[4] == [False, False, True, True]  # LOD 1's blended pair kept


# --- on the card -------------------------------------------------------------

CUDA_MODEL = dict(MODEL, style_mixing_prob=0.9)


def _card_runs(device, lod: int, blended: bool, remat: bool, steps: int = 6):
    """The same seed's state twice on the card: ``steps`` intro steps
    through ``one_step`` (3 eager warm-up steps, a capture, replays) and
    through the eager step, each step its own blend; every tensor of both."""
    out = []
    rs = np.random.RandomState(8)
    res = 2 ** (lod + 2)
    xs = [torch.tensor(rs.rand(2, 3, res, res).astype(np.float32) * 2 - 1, device=device)
          for _ in range(steps)]
    blends = [0.1 + 0.13 * i for i in range(steps)] if blended else [1.0] * steps
    for graphed in (True, False):
        mc = StyleModelConfig(**{**CUDA_MODEL, "remat": remat})
        model = StyleModel(mc)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            nets = model.make_nets()
        state = StyleTrainState.create(nets, device=device, seed=1, lr=LR, ema_beta=0.9)
        _, intro = build_style_steps(model, StyleStepConfig(latent_size=LATENT, **STEP), lod,
                                     blended)
        step = one_step(intro) if graphed else intro
        ms = []
        for x, b in zip(xs, blends):
            state, m = step(state, x, b)
            ms.append(m)
        torch.cuda.synchronize()
        out.append((state, ms, step))
    return out


def _assert_bit_equal(a, b):
    (sa, ma, _), (sb, mb, _) = a, b
    assert sa.step == sb.step
    for x, y in zip(ma, mb):
        assert all(torch.equal(x[k], y[k]) for k in x)
    for which in ("nets", "ema"):
        da, db = getattr(sa, which).state_dict(), getattr(sb, which).state_dict()
        assert all(torch.equal(da[k], db[k]) for k in da), which
    for oa, ob in ((sa.opt_e, sb.opt_e), (sa.opt_d, sb.opt_d)):
        assert torch.equal(oa.count, ob.count)
        assert all(torch.equal(u, v) for u, v in zip(oa.nu, ob.nu))
    assert torch.equal(sa.generator.get_state(), sb.generator.get_state())


@pytest.mark.cuda
@pytest.mark.parametrize("lod,blended,remat", [(1, False, False), (2, True, False),
                                               (2, True, True)],
                         ids=["stable", "blended", "remat"])
def test_graphed_style_steps_equal_eager_on_the_card(cuda_device, lod, blended, remat):  # noqa: F811
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        graphed, eager = _card_runs(cuda_device, lod, blended, remat)
    finally:
        torch.backends.cudnn.deterministic = saved
    assert len(graphed[2].graphed.graphs) == 1
    _assert_bit_equal(graphed, eager)


@pytest.mark.cuda
def test_each_replay_keeps_its_own_metrics(cuda_device):  # noqa: F811
    graphed, _ = _card_runs(cuda_device, 1, False, False)
    ms = graphed[1]
    replays = ms[3:]  # after the warm-up steps
    ptrs = {v.data_ptr() for m in replays for v in m.values()}
    assert len(ptrs) == sum(len(m) for m in replays)
    losses = [float(m["loss_e"]) for m in replays]
    assert len(set(losses)) == len(losses)
