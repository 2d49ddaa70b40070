"""Activation checkpointing in the port (models/remat.py): the image step's
``remat`` and the style model's ``TRAIN.REMAT``.

A remat step recomputes each checkpointed forward in the backward, so it must
be the plain step bit for bit on the CPU: every metric, parameter, BN
buffer (``num_batches_tracked`` advancing once a forward), Adam moment and,
for the style step, the generator's state afterwards. The remat steps are
also held to the JAX package's remat paths on converted weights, at the
tolerances of tests/test_torch_port_image_step.py (losses rel 1e-4, weights
atol 1e-6) and tests/test_torch_port_style_step.py (step 1 rel 1e-4).
Tiny sizes: image channels (8, 16), 16x16, z 8, batch 4; style 3 layers,
8-32 channels, latent 16, batch 2.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soft_intro_vae_tpu.models.conv import ConvDecoder as JaxDecoder
from soft_intro_vae_tpu.models.conv import ConvEncoder as JaxEncoder
from soft_intro_vae_tpu.train import optim as joptim
from soft_intro_vae_tpu.train.image import make_model_fns
from soft_intro_vae_tpu.train.lreq_adam import scale_by_lreq_adam
from soft_intro_vae_tpu.train.state import TrainState as JaxState
from soft_intro_vae_tpu.train.step import StepConfig as JaxStepConfig
from soft_intro_vae_tpu.train.step import build_train_steps as jax_build_train_steps
from soft_intro_vae_tpu.train.style_step import StyleModel as JaxStyleModel
from soft_intro_vae_tpu.train.style_step import StyleModelConfig as JaxStyleModelConfig
from soft_intro_vae_tpu.train.style_step import StyleStepConfig as JaxStyleStepConfig
from soft_intro_vae_tpu.train.style_step import StyleTrainState as JaxStyleTrainState
from soft_intro_vae_tpu.train.style_step import build_style_steps as jax_build_style_steps
from soft_intro_vae_torch.models import remat
from soft_intro_vae_torch.models.conv import SoftIntroVAE
from soft_intro_vae_torch.parallel import collectives, mesh, multihost
from soft_intro_vae_torch.train.state import TrainState
from soft_intro_vae_torch.train.step import INTRO_NOISES, UNIT_LUT, StepConfig, build_train_steps
from soft_intro_vae_torch.train.style_step import (
    NZ_KEYS,
    StyleModel,
    StyleModelConfig,
    StyleStepConfig,
    StyleTrainState,
    build_style_steps,
)
from soft_intro_vae_torch.utils.from_jax import image_state_dict_from_jax, style_state_dict_from_jax
from tests.torch_port_fixtures import one_torch_thread  # noqa: F401

CH, IMG, CDIM, Z, B = (8, 16), 16, 3, 8, 4
LR = 2e-4
CFG = dict(z_dim=Z, beta_rec=1.0, beta_kl=1.0, beta_neg=16.0, scale=1.0 / (3 * IMG * IMG),
           loss_type="mse")
GAMMA_R = {False: 1e-8, True: 1.0}


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, dtype=np.float32), tree)


def _image_state(boot, seed=0):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = SoftIntroVAE(cdim=CDIM, zdim=Z, channels=CH, image_size=IMG, bootstrap=boot)
    state = TrainState.create(model, device=torch.device("cpu"), seed=seed, lr_e=LR, lr_d=LR)
    if boot:
        state.target_decoder.load_state_dict(state.decoder.state_dict())
    return state


def _image_steps(boot, remat_on, scan_steps=1):
    return build_train_steps(cfg=StepConfig(gamma_r=GAMMA_R[boot], bootstrap=boot, **CFG),
                             scan_steps=scan_steps, input_lut=UNIT_LUT, nhwc=True, remat=remat_on)


def _image_run(boot, remat_on, n_vanilla=2, n_intro=2):
    state = _image_state(boot)
    vanilla, intro = _image_steps(boot, remat_on)
    rs = np.random.RandomState(3)
    metrics = []
    for step in [vanilla] * n_vanilla + [intro] * n_intro:
        x = torch.from_numpy(rs.randint(0, 256, (B, IMG, IMG, CDIM)).astype(np.uint8))
        state, m = step(state, x)
        metrics.append(m)
    return state, metrics


def _assert_states_equal(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert set(sa) == set(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    for oa, ob in ((a.opt_e, b.opt_e), (a.opt_d, b.opt_d)):
        for pa, pb in zip(oa.state.values(), ob.state.values()):
            for name in pa:
                assert torch.equal(torch.as_tensor(pa[name]), torch.as_tensor(pb[name])), name
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def _assert_metrics_equal(ma, mb):
    for a, b in zip(ma, mb):
        assert set(a) == set(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("boot", [False, True], ids=["image", "bootstrap"])
def test_image_remat_steps_equal_plain_steps(boot):
    """Two vanilla and two intro steps: losses, gradients' effect (parameters,
    Adam moments), BN running buffers and num_batches_tracked bit-equal."""
    plain, m_plain = _image_run(boot, False)
    rem, m_rem = _image_run(boot, True)
    _assert_metrics_equal(m_plain, m_rem)
    _assert_states_equal(plain, rem)
    # one BN forward each: 2 vanilla encodes + 2 x (3 E-phase + 2 D-phase) encodes
    assert int(rem.model.state_dict()["encoder.main.1.num_batches_tracked"]) == 12


def test_image_remat_gradients_equal_plain_gradients():
    """The E phase's encoder gradients, with the decoder frozen, before any update."""
    grads = []
    for remat_on in (False, True):
        state = _image_state(False)
        run = remat.maybe_checkpoint(remat_on)
        rs = np.random.RandomState(5)
        x = torch.from_numpy(rs.rand(B, CDIM, IMG, IMG).astype(np.float32))
        for p in state.decoder.parameters():
            p.requires_grad_(False)
        mu, logvar = run(state.encoder, x)
        rec = run(state.decoder, mu)
        ((rec - x) ** 2).mean().add(logvar.pow(2).mean()).backward()
        grads.append([p.grad.clone() for p in state.encoder.parameters()])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_frozen_forward_is_not_recomputed():
    """A checkpointed forward whose inputs and parameters need no gradient
    (the E phase's ``fake = dec(noise)``) runs once; one that feeds the
    loss runs again in the backward."""
    state = _image_state(False)
    calls = []
    hook = state.decoder.register_forward_pre_hook(lambda *a: calls.append(1))
    try:
        for p in state.decoder.parameters():
            p.requires_grad_(False)
        noise = torch.randn(B, Z)
        fake = remat.checkpoint(state.decoder, noise)
        assert not fake.requires_grad
        mu, _ = state.encoder(torch.rand(B, CDIM, IMG, IMG))
        rec = remat.checkpoint(state.decoder, mu)
        assert len(calls) == 2
        rec.mean().backward()
        assert len(calls) == 3
    finally:
        hook.remove()


def test_image_remat_k_steps_equal_single_steps():
    """scan_steps 3 with remat (eager on the CPU) against three single remat steps."""
    rs = np.random.RandomState(8)
    xs = torch.from_numpy(rs.randint(0, 256, (3, B, IMG, IMG, CDIM)).astype(np.uint8))
    a = _image_state(False)
    _, intro_k = _image_steps(False, True, scan_steps=3)
    a, mk = intro_k(a, xs)
    b = _image_state(False)
    _, intro = _image_steps(False, True)
    rows = []
    for x in xs:
        b, m = intro(b, x)
        rows.append(m)
    for k in mk:
        assert torch.equal(mk[k], torch.stack([r[k] for r in rows])), k
    _assert_states_equal(a, b)


@pytest.fixture
def world_of_one(tmp_path):
    """A gloo process group of one rank in this process, destroyed after."""
    saved = os.environ.get("LOCAL_RANK")
    multihost.initialize_multihost(f"file://{tmp_path}/store", 1, 0, backend="gloo",
                                   device="cpu", timeout_s=60)
    try:
        yield mesh.current_world()
    finally:
        multihost.shutdown()
        if saved is None:
            os.environ.pop("LOCAL_RANK", None)
        else:
            os.environ["LOCAL_RANK"] = saved


def test_global_bn_remat_in_a_group_of_one(world_of_one):
    """The global-batch BN route with remat: the recompute reads back the
    sums its forward all-reduced, so the all-reduces are the plain step's,
    and the steps (buffers included) are bit-equal."""
    assert world_of_one.active
    results = []
    for remat_on in (False, True):
        collectives.calls.clear()
        state, metrics = _image_run(False, remat_on, n_vanilla=1, n_intro=1)
        results.append((state, metrics, dict(collectives.calls)))
    (a, ma, ca), (b, mb, cb) = results
    _assert_metrics_equal(ma, mb)
    _assert_states_equal(a, b)
    assert ca == cb
    assert ca["bn_fwd"] > 0 and ca["bn_bwd"] > 0


# ------------------------------------------------------ image against JAX --

@pytest.fixture(scope="module")
def jax_image():
    kw = dict(cdim=CDIM, zdim=Z, channels=CH, image_size=IMG)
    enc, dec = JaxEncoder(**kw), JaxDecoder(**kw)
    ve = jax.jit(lambda k: enc.init(k, jnp.zeros((1, IMG, IMG, CDIM)), train=False))(jax.random.key(0))
    vd = jax.jit(lambda k: dec.init(k, jnp.zeros((1, Z)), train=False))(jax.random.key(1))
    encode, decode = make_model_fns(enc, dec, remat=True)
    opt = joptim.adam()
    steps = {boot: jax_build_train_steps(
        encode=encode, decode=decode, optimizer=opt, donate=False, input_lut=UNIT_LUT,
        decode_target=decode if boot else None,
        cfg=JaxStepConfig(gamma_r=GAMMA_R[boot], bootstrap=boot, **CFG)) for boot in (False, True)}

    def fresh(boot):
        return JaxState.create(
            params_e=ve["params"], params_d=vd["params"], stats_e=ve["batch_stats"],
            stats_d=vd["batch_stats"],
            params_d_target=vd["params"] if boot else None,
            stats_d_target=vd["batch_stats"] if boot else None,
            opt_e=opt.init(ve["params"]), opt_d=opt.init(vd["params"]), rng=jax.random.key(2),
            lr_e=LR, lr_d=LR)

    return fresh, steps


def _image_sd(js, boot):
    t = (_np_tree(js.params_d_target), _np_tree(js.stats_d_target)) if boot else (None, None)
    return image_state_dict_from_jax(_np_tree(js.params_e), _np_tree(js.stats_e),
                                     _np_tree(js.params_d), _np_tree(js.stats_d), CH, IMG, *t)


@pytest.mark.parametrize("boot", [False, True], ids=["image", "bootstrap"])
def test_image_remat_intro_steps_match_jax_remat(jax_image, boot):
    fresh, steps = jax_image
    js = fresh(boot)
    model = SoftIntroVAE(cdim=CDIM, zdim=Z, channels=CH, image_size=IMG, bootstrap=boot)
    model.load_state_dict(_image_sd(js, boot), strict=True)
    state = TrainState.create(model, device=torch.device("cpu"), seed=0, lr_e=LR, lr_d=LR)
    _, intro = _image_steps(boot, True)
    jintro = steps[boot][1]
    rs = np.random.RandomState(21)
    for i in range(2):
        x = rs.randint(0, 256, (B, IMG, IMG, CDIM)).astype(np.uint8)
        nz = {k: rs.randn(B, Z).astype(np.float32) for k in INTRO_NOISES}
        js, jm = jintro(js, jnp.asarray(x), {k: jnp.asarray(v) for k, v in nz.items()})
        state, m = intro(state, torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in nz.items()})
        for k in ("loss_e", "loss_d"):
            assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-4), f"step {i} {k}"
    want, got = _image_sd(js, boot), state.model.state_dict()
    for k, w in want.items():
        if k.endswith(("running_var", "num_batches_tracked")):
            continue
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0, atol=1e-6, err_msg=k)


# ------------------------------------------------------------------ style --

LAYERS, STARTF, MAXF, LATENT, SB = 3, 8, 32, 16, 2
SKW = dict(startf=STARTF, maxf=MAXF, layer_count=LAYERS, latent_size=LATENT, mapping_layers=2)
SSTEP = dict(beta_rec=0.1, beta_kl=0.2, beta_neg=8.0, gamma_r=1e-8, scale=1.0 / (3 * 16 * 16))


def _style_state(remat_on, variant="EncoderDefault", **extra):
    model = StyleModel(StyleModelConfig(remat=remat_on, encoder_variant=variant, **SKW, **extra))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        nets = model.make_nets()
    state = StyleTrainState.create(nets, device=torch.device("cpu"), seed=3, lr=1.5e-3,
                                   ema_beta=0.9)
    return model, state


def test_style_remat_model_ops_equal_plain():
    """encode and generate (style mixing and batch noise on) bit-equal, with
    their gradients, and the generator where the plain ops leave it."""
    out = []
    for remat_on in (False, True):
        model, state = _style_state(remat_on)
        rs = np.random.RandomState(1)
        x = torch.tensor(rs.rand(SB, 3, 16, 16).astype(np.float32) * 2 - 1)
        eps = torch.tensor(rs.randn(SB, LATENT).astype(np.float32))
        z, mu, lv = model.encode(state.nets, x, 2, None, eps)
        rec = model.generate(state.nets, state.generator, 2, None, z, mixing=True)
        ((rec - x) ** 2).mean().backward()
        grads = [p.grad.clone() for p in state.nets.parameters() if p.grad is not None]
        out.append((mu.detach(), lv.detach(), rec.detach(), grads, state.generator.get_state()))
    for a, b in zip(out[0][:3], out[1][:3]):
        assert torch.equal(a, b)
    assert len(out[0][3]) == len(out[1][3])
    for a, b in zip(out[0][3], out[1][3]):
        assert torch.equal(a, b)
    assert torch.equal(out[0][4], out[1][4])


@pytest.mark.parametrize("variant", ["EncoderDefault", "EncoderWithStatistics"])
def test_style_remat_intro_steps_equal_plain(variant):
    """A vanilla and two intro steps at LOD 2 (a blended one at LOD 2 too):
    metrics, nets, EMA, dlatent_avg, optimizer state and generator bit-equal."""
    runs = []
    for remat_on in (False, True):
        model, state = _style_state(remat_on, variant)
        cfg = StyleStepConfig(latent_size=LATENT, **SSTEP)
        v, i = build_style_steps(model, cfg, 2, False)
        _, ib = build_style_steps(model, cfg, 2, True)
        rs = np.random.RandomState(2)
        ms = []
        for step, blend in ((v, 1.0), (i, 1.0), (ib, 0.4), (i, 1.0)):
            x = torch.tensor(rs.rand(SB, 3, 16, 16).astype(np.float32) * 2 - 1)
            state, m = step(state, x, blend)
            ms.append(m)
        runs.append((state, ms))
    (a, ma), (b, mb) = runs
    _assert_metrics_equal(ma, mb)
    for k, t in a.nets.state_dict().items():
        assert torch.equal(t, b.nets.state_dict()[k]), k
    for k, t in a.ema.state_dict().items():
        assert torch.equal(t, b.ema.state_dict()[k]), k
    for oa, ob in ((a.opt_e, b.opt_e), (a.opt_d, b.opt_d)):
        sa, sb = oa.state_dict(), ob.state_dict()
        for x, y in zip(jax.tree_util.tree_leaves(sa), jax.tree_util.tree_leaves(sb)):
            assert torch.equal(torch.as_tensor(x), torch.as_tensor(y))
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def test_style_remat_intro_step_matches_jax_remat():
    """One intro step at LOD 1 with injected latents, noise mode "none" and no
    mixing (tests/test_torch_port_style_step.py's setting), both packages
    with remat: the losses within rel 1e-4."""
    mkw = dict(SKW, channels=3, dlatent_avg_beta=0.995, style_mixing_prob=None,
               truncation_psi=None)
    jmodel = JaxStyleModel(JaxStyleModelConfig(remat=True, **mkw))
    pe, pd, buf = jax.jit(jmodel.init_params)(jax.random.key(40))
    # moved off the init, as tests/test_torch_port_style_step.py does: at the
    # init the const input's instance norms see near-constant planes
    rs = np.random.RandomState(41)
    bump = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda a: jnp.asarray(np.asarray(a) + 0.05 * rs.randn(*a.shape).astype(np.float32)), t)
    pe, pd = bump(pe), bump(pd)
    opt = scale_by_lreq_adam(beta2=0.99)
    cp = lambda t: jax.tree_util.tree_map(jnp.copy, t)  # noqa: E731 (the step donates its state)
    jstate = JaxStyleTrainState(
        step=jnp.zeros([], jnp.int32), params_e=cp(pe), params_d=cp(pd), buffers=cp(buf),
        ema_e=cp(pe), ema_d=cp(pd), ema_buffers=cp(buf), opt_e=opt.init(pe), opt_d=opt.init(pd),
        lr=jnp.asarray(1.5e-3, jnp.float32), ema_beta=jnp.asarray(0.9, jnp.float32),
        rng=jax.random.key(0))
    model = StyleModel(StyleModelConfig(remat=True, **mkw))
    nets = model.make_nets()
    nets.load_state_dict(style_state_dict_from_jax(_np_tree(pe), _np_tree(pd), _np_tree(buf)),
                         strict=True)
    state = StyleTrainState.create(nets, device=torch.device("cpu"), seed=0, lr=1.5e-3,
                                   beta2=0.99, ema_beta=0.9)
    _, jintro = jax_build_style_steps(jmodel, JaxStyleStepConfig(latent_size=LATENT, **SSTEP),
                                      1, False, opt, noise_mode="none")
    _, intro = build_style_steps(model, StyleStepConfig(latent_size=LATENT, **SSTEP), 1, False,
                                 noise_mode="none")
    rs = np.random.RandomState(97)
    x = rs.rand(SB, 8, 8, 3).astype(np.float32) * 2.0 - 1.0
    nz = {k: rs.randn(SB, LATENT).astype(np.float32) for k in NZ_KEYS}
    jstate, jm = jintro(jstate, jnp.asarray(x), jnp.asarray(1.0, jnp.float32),
                        {k: jnp.asarray(v) for k, v in nz.items()})
    state, m = intro(state, torch.tensor(np.ascontiguousarray(x.transpose(0, 3, 1, 2))), 1.0,
                     {k: torch.tensor(v) for k, v in nz.items()})
    for k in ("loss_e", "loss_d", "rec_loss", "real_kl", "fake_kl"):
        assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-4), k
