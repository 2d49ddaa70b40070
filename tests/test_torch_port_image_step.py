"""Port parity: the image and bootstrap steps of soft_intro_vae_torch.train.step
against the JAX package's ``intro_step``/``vanilla_step``.

The image StepConfig (mse, scale 1/(3*16*16), beta_neg 16), the same conv
weights and batch statistics (carried across by ``image_state_dict_from_jax``)
and the same injected noises go through both packages, fed the same uint8
NHWC batches: the JAX step normalizes them with its canonical ``input_lut``
(ops/u8norm.py), the port with its plain u8norm on the CPU. Tiny size:
channels (8, 16), 16x16 images, z 8, batch 4, float32. Two chained intro
steps and two chained vanilla steps, each for the plain config and with
``bootstrap=True`` (the JAX step built with ``decode_target``).

Losses: loss_e and loss_d within rel 1e-4 at every step (measured: < 6e-7);
the other metrics within rel 1e-4, abs 1e-6.

Parameters and running means after the last step: every element within atol
1e-6 (measured: <= 1.2e-7), and every tensor's update within 1e-3 of its norm
(measured: <= 1.3e-4; Adam's first steps move each weight by about lr *
g / |g|, so a gradient element that is rounding noise moves by a few 1e-7 in
one package and not the other). Running variances are left to
tests/test_torch_port_conv.py, which applies flax's biased-variance factor.
One intro step in bfloat16 is held to the JAX package's: see that test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soft_intro_vae_tpu.models.conv import ConvDecoder as JaxDecoder
from soft_intro_vae_tpu.models.conv import ConvEncoder as JaxEncoder
from soft_intro_vae_tpu.train import optim as joptim
from soft_intro_vae_tpu.train.image import make_model_fns
from soft_intro_vae_tpu.train.state import TrainState as JaxState
from soft_intro_vae_tpu.train.step import StepConfig as JaxStepConfig
from soft_intro_vae_tpu.train.step import build_train_steps as jax_build_train_steps
from soft_intro_vae_torch.models.conv import SoftIntroVAE
from soft_intro_vae_torch.train.state import TrainState
from soft_intro_vae_torch.train.step import INTRO_NOISES, UNIT_LUT, StepConfig, build_train_steps
from soft_intro_vae_torch.utils.from_jax import image_state_dict_from_jax
from tests.torch_port_fixtures import one_torch_thread  # noqa: F401

CH, IMG, CDIM, Z, B = (8, 16), 16, 3, 8, 4
LR = 2e-4
CFG = dict(z_dim=Z, beta_rec=1.0, beta_kl=1.0, beta_neg=16.0, scale=1.0 / (3 * IMG * IMG),
           loss_type="mse")
GAMMA_R = {False: 1e-8, True: 1.0}  # the image and bootstrap CLIs' defaults


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, dtype=np.float32), tree)


@pytest.fixture(scope="module")
def jax_setup():
    kw = dict(cdim=CDIM, zdim=Z, channels=CH, image_size=IMG)
    enc, dec = JaxEncoder(**kw), JaxDecoder(**kw)
    ve = jax.jit(lambda k: enc.init(k, jnp.zeros((1, IMG, IMG, CDIM)), train=False))(jax.random.key(0))
    vd = jax.jit(lambda k: dec.init(k, jnp.zeros((1, Z)), train=False))(jax.random.key(1))
    encode, decode = make_model_fns(enc, dec)
    opt = joptim.adam()
    steps = {}
    for boot in (False, True):
        steps[boot] = jax_build_train_steps(
            encode=encode, decode=decode, optimizer=opt, donate=False, input_lut=UNIT_LUT,
            decode_target=decode if boot else None,
            cfg=JaxStepConfig(gamma_r=GAMMA_R[boot], bootstrap=boot, **CFG))

    def fresh_state(boot):
        return JaxState.create(
            params_e=ve["params"], params_d=vd["params"], stats_e=ve["batch_stats"],
            stats_d=vd["batch_stats"],
            params_d_target=vd["params"] if boot else None,
            stats_d_target=vd["batch_stats"] if boot else None,
            opt_e=opt.init(ve["params"]), opt_d=opt.init(vd["params"]), rng=jax.random.key(2),
            lr_e=LR, lr_d=LR)

    return fresh_state, steps


def _sd(jstate, boot):
    t = (_np_tree(jstate.params_d_target), _np_tree(jstate.stats_d_target)) if boot else (None, None)
    return image_state_dict_from_jax(_np_tree(jstate.params_e), _np_tree(jstate.stats_e),
                                     _np_tree(jstate.params_d), _np_tree(jstate.stats_d), CH, IMG,
                                     *t)


def _port_state(jstate, boot):
    model = SoftIntroVAE(cdim=CDIM, zdim=Z, channels=CH, image_size=IMG, bootstrap=boot)
    model.load_state_dict(_sd(jstate, boot), strict=True)
    return TrainState.create(model, device=torch.device("cpu"), seed=0, lr_e=LR, lr_d=LR)


def _port_steps(boot):
    return build_train_steps(cfg=StepConfig(gamma_r=GAMMA_R[boot], bootstrap=boot, **CFG),
                             input_lut=UNIT_LUT, nhwc=True)


def _assert_same_weights(state, jstate, before, boot):
    want = _sd(jstate, boot)
    got = state.model.state_dict()
    assert set(got) == set(want)
    for k, w in want.items():
        if k.endswith(("running_var", "num_batches_tracked")):
            continue
        g, w, b = got[k].numpy(), w.numpy(), before[k].numpy()
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=k)
        if not k.endswith("running_mean"):
            upd = np.linalg.norm(w - b)
            assert np.linalg.norm((g - b) - (w - b)) <= 1e-3 * upd + 1e-7, k


def _batch(rs):
    return rs.randint(0, 256, (B, IMG, IMG, CDIM)).astype(np.uint8)


@pytest.mark.parametrize("boot", [False, True], ids=["image", "bootstrap"])
def test_two_intro_steps_match_jax(jax_setup, boot):
    fresh_state, steps = jax_setup
    jstate = fresh_state(boot)
    state = _port_state(jstate, boot)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    _, intro = _port_steps(boot)
    jintro = steps[boot][1]
    rs = np.random.RandomState(21)
    for i in range(2):
        x = _batch(rs)
        nz = {k: rs.randn(B, Z).astype(np.float32) for k in INTRO_NOISES}
        jstate, jm = jintro(jstate, jnp.asarray(x), {k: jnp.asarray(v) for k, v in nz.items()})
        state, m = intro(state, torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in nz.items()})
        assert set(m) == set(jm)
        for k in ("loss_e", "loss_d"):
            assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-4), f"step {i} {k}"
        for k in ("rec", "kl_real", "kl_rec", "kl_fake", "expelbo_r", "expelbo_f"):
            assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-4, abs=1e-6), f"step {i} {k}"
    assert state.step == 2 == int(jstate.step)
    _assert_same_weights(state, jstate, before, boot)
    if boot:  # the target decoder's parameters never move; its statistics do
        for k, v in state.target_decoder.named_parameters():
            torch.testing.assert_close(v, before[f"target_decoder.{k}"], rtol=0, atol=0)


@pytest.mark.parametrize("boot", [False, True], ids=["image", "bootstrap"])
def test_vanilla_step_matches_jax(jax_setup, boot):
    fresh_state, steps = jax_setup
    jstate = fresh_state(boot)
    state = _port_state(jstate, boot)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    vanilla, _ = _port_steps(boot)
    jvanilla = steps[boot][0]
    x = _batch(np.random.RandomState(22))
    # the JAX vanilla step draws its eps from fold_in(fold_in(rng, step), 0)
    k = jax.random.fold_in(jstate.rng, jstate.step)
    eps = np.asarray(jax.random.normal(jax.random.fold_in(k, 0), (B, Z), jnp.float32))
    for _ in range(2):  # the second step reads Adam's moments and counts of the first
        jstate, jm = jvanilla(jstate, jnp.asarray(x))
        state, m = vanilla(state, torch.from_numpy(x), {"eps": torch.from_numpy(eps.copy())})
        k = jax.random.fold_in(jstate.rng, jstate.step)
        eps = np.asarray(jax.random.normal(jax.random.fold_in(k, 0), (B, Z), jnp.float32))
        assert set(m) == set(jm)
        for key in m:
            assert float(m[key]) == pytest.approx(float(jm[key]), rel=1e-4), key
    _assert_same_weights(state, jstate, before, boot)
    # bootstrap: the online decoder took zero gradients, and Adam still counted them
    counts = {int(s["step"]) for s in state.opt_d.state.values()}
    assert counts == {2} and int(jstate.opt_d.count) == 2


def test_uint8_and_float_feeds_give_the_same_update():
    """The analog of tests/test_uint8_pipeline.py: a uint8 batch and its host
    normalization x.astype(f32)/255 give identical losses and parameters."""
    u8 = _batch(np.random.RandomState(23))
    results = []
    for x in (u8, u8.astype(np.float32) / np.float32(255)):
        torch.manual_seed(0)
        model = SoftIntroVAE(cdim=CDIM, zdim=Z, channels=CH, image_size=IMG)
        state = TrainState.create(model, device=torch.device("cpu"), seed=4, lr_e=LR, lr_d=LR)
        _, intro = _port_steps(False)
        state, m = intro(state, torch.from_numpy(x))
        results.append(({k: float(v) for k, v in m.items()}, state.model.state_dict()))
    (ma, sa), (mb, sb) = results
    assert ma == mb
    for k in sa:
        torch.testing.assert_close(sa[k], sb[k], rtol=0, atol=0, msg=k)


def test_a_uint8_batch_without_a_table_raises():
    model = SoftIntroVAE(cdim=CDIM, zdim=Z, channels=CH, image_size=IMG)
    state = TrainState.create(model, device=torch.device("cpu"), seed=0)
    x = torch.from_numpy(_batch(np.random.RandomState(24)))
    for nhwc in (True, False):
        vanilla, intro = build_train_steps(cfg=StepConfig(**CFG), nhwc=nhwc)
        for step in (vanilla, intro):
            with pytest.raises(ValueError, match="uint8"):
                step(state, x)
    with pytest.raises(ValueError, match="256"):
        build_train_steps(cfg=StepConfig(**CFG), input_lut=np.zeros(10), nhwc=True)


def test_other_tables_are_looked_up():
    """A 256-entry table other than the unit one maps every byte through it."""
    init = SoftIntroVAE(cdim=CDIM, zdim=Z, channels=CH, image_size=IMG).state_dict()
    x = _batch(np.random.RandomState(25))
    lut = np.arange(256, dtype=np.float32) / 127.5 - 1.0
    runs = []
    for feed, table in ((x, lut), (lut[x], None)):
        model = SoftIntroVAE(cdim=CDIM, zdim=Z, channels=CH, image_size=IMG)
        model.load_state_dict(init)
        state = TrainState.create(model, device=torch.device("cpu"), seed=4)
        _, intro = build_train_steps(cfg=StepConfig(**CFG), input_lut=table, nhwc=True)
        runs.append({k: float(v) for k, v in intro(state, torch.from_numpy(feed))[1].items()})
    assert runs[0] == runs[1]


def test_bootstrap_needs_a_target_decoder():
    state = TrainState.create(SoftIntroVAE(cdim=CDIM, zdim=Z, channels=CH, image_size=IMG),
                              device=torch.device("cpu"), seed=0)
    _, intro = _port_steps(True)
    with pytest.raises(ValueError, match="target_decoder"):
        intro(state, torch.from_numpy(_batch(np.random.RandomState(26))))


def test_bfloat16_intro_step_against_the_jax_package(jax_setup):
    """One intro step with both packages' nets in bfloat16 (compute_dtype;
    parameters, BN and losses in f32), same weights, batch and noises. The
    nets round at other places (tests/test_torch_port_conv.py), so the losses
    differ by bf16 roundings. Measured at 3 seeds: loss_e/loss_d/rec/kl_real
    within rel 6.0e-4, kl_fake/kl_rec (KLs of decoded-then-encoded images,
    two bf16 passes deep) within 5.6e-3; held to 2e-3 and 2e-2."""
    kw = dict(cdim=CDIM, zdim=Z, channels=CH, image_size=IMG)
    enc, dec = JaxEncoder(**kw), JaxDecoder(**kw)
    ve = jax.jit(lambda k: enc.init(k, jnp.zeros((1, IMG, IMG, CDIM)), train=False))(jax.random.key(0))
    vd = jax.jit(lambda k: dec.init(k, jnp.zeros((1, Z)), train=False))(jax.random.key(1))
    encode, decode = make_model_fns(JaxEncoder(dtype=jnp.bfloat16, **kw),
                                    JaxDecoder(dtype=jnp.bfloat16, **kw))
    opt = joptim.adam()
    _, jintro = jax_build_train_steps(encode=encode, decode=decode, optimizer=opt, donate=False,
                                      input_lut=UNIT_LUT, cfg=JaxStepConfig(gamma_r=1e-8, **CFG))
    jstate = JaxState.create(params_e=ve["params"], params_d=vd["params"],
                             stats_e=ve["batch_stats"], stats_d=vd["batch_stats"],
                             opt_e=opt.init(ve["params"]), opt_d=opt.init(vd["params"]),
                             rng=jax.random.key(2), lr_e=LR, lr_d=LR)
    model = SoftIntroVAE(compute_dtype=torch.bfloat16, **kw)
    model.load_state_dict(_sd(jstate, False), strict=True)
    state = TrainState.create(model, device=torch.device("cpu"), seed=0, lr_e=LR, lr_d=LR)
    _, intro = _port_steps(False)
    rs = np.random.RandomState(30)
    x = _batch(rs)
    nz = {k: rs.randn(B, Z).astype(np.float32) for k in INTRO_NOISES}
    _, jm = jintro(jstate, jnp.asarray(x), {k: jnp.asarray(v) for k, v in nz.items()})
    _, m = intro(state, torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in nz.items()})
    for k, rel in (("loss_e", 2e-3), ("loss_d", 2e-3), ("rec", 2e-3), ("kl_real", 2e-3),
                   ("kl_fake", 2e-2), ("kl_rec", 2e-2)):
        assert float(m[k]) == pytest.approx(float(jm[k]), rel=rel), k
