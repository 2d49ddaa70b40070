"""Port parity: soft_intro_vae_torch.train.style_step against train/style_step.py.

The same JAX-initialised weights (carried across by
``style_state_dict_from_jax``), the same batches and the same injected
latent draws (``nz``) go through the JAX package's ``build_style_steps`` and
the port's, two steps in a row: intro steps at LOD 1 (stable) and LOD 2
(blend 0.6), vanilla steps at LOD 1. As tests/test_golden_style.py does, the
decoder runs with noise_mode "none" and style mixing off; dlatent_avg
tracking is on (beta 0.995) and the EMA beta is 0.9, so both move.

Tolerances:
  * step 1: loss_e, loss_d, rec_loss, real_kl and fake_kl within rel 1e-4
    (f32 sums in another order);
  * step 2: loss_e and loss_d within rel 2e-3, the JAX package's own
    tolerance against the torch twin. Step 1's LREQAdam update has beta1 = 0
    and divides by sqrt(v), so its first update is ~lr * sign(g) for every
    element: an element whose gradient is rounding noise in one package moves
    a full lr step, in either direction, and step 2 starts from weights that
    differ by that much. At LOD 1 the gradient of decoder block 0 (4x4, after
    two instance norms) is such a sum of cancelling terms: the port's own f32
    and f64 runs of step 1 differ by 1.2% (median) there, and after step 1
    307 of 57,001 weights differ from the JAX package's by up to 2 lr. The
    single KL terms then drift further than the losses (fake_kl 0.45% at
    step 2), so step 2 checks the two losses only;
  * after step 2, dlatent_avg within the step-2 tolerance, rtol 2e-3 and
    atol 1e-4 (it averages the styles of step 2's forwards); the EMA tensors:
    no element apart by more than 0.6 lr, the most that two such sign-flipped
    updates can move it (beta (1 - beta) 2 lr + (1 - beta) 4 lr = 0.58 lr at
    beta 0.9), and a mean difference over all elements under 0.02 lr
    (measured: 0.004 lr; the differences sit in the ill-conditioned
    decoder blocks and the mappings).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soft_intro_vae_tpu.train.lreq_adam import scale_by_lreq_adam
from soft_intro_vae_tpu.train.style_step import StyleModel as JaxStyleModel
from soft_intro_vae_tpu.train.style_step import StyleModelConfig as JaxStyleModelConfig
from soft_intro_vae_tpu.train.style_step import StyleStepConfig as JaxStyleStepConfig
from soft_intro_vae_tpu.train.style_step import StyleTrainState as JaxStyleTrainState
from soft_intro_vae_tpu.train.style_step import build_style_steps as jax_build_style_steps
from soft_intro_vae_torch.train.style_step import (
    NZ_KEYS,
    StyleModel,
    StyleModelConfig,
    StyleStepConfig,
    StyleTrainState,
    build_style_steps,
)
from soft_intro_vae_torch.utils.from_jax import style_state_dict_from_jax
from tests.torch_port_fixtures import one_torch_thread  # noqa: F401

LAYERS, STARTF, MAXF, LATENT, CH, B = 3, 8, 32, 16, 3, 2
LR, EMA_BETA = 1.5e-3, 0.9
STEP = dict(beta_rec=0.1, beta_kl=0.2, beta_neg=8.0, gamma_r=1e-8,
            scale=1.0 / (CH * 16 * 16))
MODEL = dict(startf=STARTF, maxf=MAXF, layer_count=LAYERS, latent_size=LATENT, mapping_layers=5,
             channels=CH, dlatent_avg_beta=0.995, style_mixing_prob=None, truncation_psi=None)


def np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, dtype=np.float32), tree)


@pytest.fixture(scope="module")
def weights():
    jmodel = JaxStyleModel(JaxStyleModelConfig(**MODEL))
    pe, pd, buf = jax.jit(jmodel.init_params)(jax.random.key(40))
    rs = np.random.RandomState(41)
    bump = lambda t: jax.tree_util.tree_map(
        lambda a: a + 0.05 * rs.randn(*a.shape).astype(np.float32), np_tree(t))
    return jmodel, bump(pe), bump(pd), np_tree(buf)


def _pair(weights):
    jmodel, pe, pd, buf = weights
    opt = scale_by_lreq_adam(beta2=0.99)
    j = lambda t: jax.tree_util.tree_map(jnp.asarray, t)
    jstate = JaxStyleTrainState(
        step=jnp.zeros([], jnp.int32), params_e=j(pe), params_d=j(pd), buffers=j(buf),
        ema_e=j(pe), ema_d=j(pd), ema_buffers=j(buf), opt_e=opt.init(j(pe)),
        opt_d=opt.init(j(pd)), lr=jnp.asarray(LR, jnp.float32),
        ema_beta=jnp.asarray(EMA_BETA, jnp.float32), rng=jax.random.key(0))
    model = StyleModel(StyleModelConfig(**MODEL))
    nets = model.make_nets()
    nets.load_state_dict(style_state_dict_from_jax(pe, pd, buf), strict=True)
    state = StyleTrainState.create(nets, device=torch.device("cpu"), seed=0, lr=LR,
                                   beta2=0.99, ema_beta=EMA_BETA)
    return jmodel, opt, jstate, model, state


def _batch(rs, lod):
    res = 2 ** (lod + 2)
    x = rs.rand(B, res, res, CH).astype(np.float32) * 2.0 - 1.0
    nz = {k: rs.randn(B, LATENT).astype(np.float32) for k in NZ_KEYS}
    return x, nz


def _x(x):
    return torch.tensor(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _check_ema(jstate, state):
    ref = style_state_dict_from_jax(np_tree(jstate.ema_e), np_tree(jstate.ema_d),
                                    np_tree(jstate.ema_buffers))
    ema = state.ema.state_dict()
    torch.testing.assert_close(state.nets.dlatent_avg.buff,
                               torch.tensor(np.asarray(jstate.buffers["dlatent_avg"])),
                               rtol=2e-3, atol=1e-4)
    diff_sum = total = 0
    for k, r in ref.items():
        d = (ema[k] - r).abs()
        diff_sum += float(d.sum())
        total += d.numel()
        assert float(d.max()) <= 0.6 * LR, (k, float(d.max()))
    assert diff_sum / total <= 0.02 * LR, f"EMA mean |diff| {diff_sum / total!r}"


@pytest.mark.parametrize("lod,blend", [(1, None), (2, 0.6)], ids=["lod1-stable", "lod2-blend"])
def test_intro_steps_match_jax(weights, lod, blend):
    jmodel, opt, jstate, model, state = _pair(weights)
    blended = blend is not None
    scfg = dict(latent_size=LATENT, **STEP)
    _, jintro = jax_build_style_steps(jmodel, JaxStyleStepConfig(**scfg), lod, blended, opt,
                                      noise_mode="none")
    _, intro = build_style_steps(model, StyleStepConfig(**scfg), lod, blended, noise_mode="none")
    rs = np.random.RandomState(97)
    keys_1 = ("loss_e", "loss_d", "rec_loss", "real_kl", "fake_kl")
    for step_i, rel, keys in ((0, 1e-4, keys_1), (1, 2e-3, ("loss_e", "loss_d"))):
        x, nz = _batch(rs, lod)
        jb = jnp.asarray(1.0 if blend is None else blend, jnp.float32)
        jstate, jm = jintro(jstate, jnp.asarray(x), jb, {k: jnp.asarray(v) for k, v in nz.items()})
        state, m = intro(state, _x(x), 1.0 if blend is None else blend, nz)
        for key in keys:
            assert float(m[key]) == pytest.approx(float(jm[key]), rel=rel, abs=1e-7), \
                f"step {step_i + 1} {key}"
    assert state.step == 2 and state.opt_e.count == state.opt_d.count == 2
    _check_ema(jstate, state)


def test_vanilla_steps_match_jax(weights):
    jmodel, opt, jstate, model, state = _pair(weights)
    scfg = dict(latent_size=LATENT, **STEP)
    jvanilla, _ = jax_build_style_steps(jmodel, JaxStyleStepConfig(**scfg), 1, False, opt,
                                        noise_mode="none")
    vanilla, _ = build_style_steps(model, StyleStepConfig(**scfg), 1, False, noise_mode="none")
    rs = np.random.RandomState(98)
    for step_i, rel, keys in ((0, 1e-4, ("loss_e", "rec_loss", "real_kl")), (1, 2e-3, ("loss_e",))):
        x, nz = _batch(rs, 1)
        jstate, jm = jvanilla(jstate, jnp.asarray(x), jnp.asarray(1.0, jnp.float32),
                              {k: jnp.asarray(v) for k, v in nz.items()})
        state, m = vanilla(state, _x(x), 1.0, nz)
        for key in keys:
            assert float(m[key]) == pytest.approx(float(jm[key]), rel=rel), f"step {step_i + 1} {key}"
    _check_ema(jstate, state)


def test_intro_step_draws_from_the_generator_and_keeps_grads_apart(weights):
    # no nz: every latent, mixing and noise draw comes from state.generator;
    # after the step every parameter can train again and none holds a stale
    # gradient from the other phase's optimizer
    _, _, _, model, state = _pair(weights)
    cfg = StyleModelConfig(**{**MODEL, "style_mixing_prob": 0.9})
    model = StyleModel(cfg)
    _, intro = build_style_steps(model, StyleStepConfig(latent_size=LATENT, **STEP), 1, False)
    x = _x(_batch(np.random.RandomState(3), 1)[0])
    before = state.generator.get_state()
    state, m = intro(state, x)
    assert not torch.equal(before, state.generator.get_state())
    assert all(torch.isfinite(v) for v in m.values())
    assert all(p.requires_grad for p in state.nets.parameters())
    # the D phase's backward stopped at the encoder: the E optimizer cleared
    # its grads before, and nothing wrote the encoder's grads after
    assert all(p.grad is None or float(p.grad.abs().sum()) > 0 for p in state.nets.params_d())


def test_truncation_pulls_styles_to_the_average(weights):
    _, _, _, _, state = _pair(weights)
    model = StyleModel(StyleModelConfig(**{**MODEL, "truncation_psi": 0.0,
                                           "truncation_cutoff": 2 * LAYERS}))
    z = torch.randn(B, LATENT)
    with torch.no_grad():
        a = model.generate(state.nets, state.generator, 1, None, z, mixing=False,
                           truncation=True, noise_mode="none", update_avg=False)
        b = model.generate(state.nets, state.generator, 1, None, -z, mixing=False,
                           truncation=True, noise_mode="none", update_avg=False)
    # psi 0 on every layer: every sample decodes the average style
    torch.testing.assert_close(a, b, rtol=0, atol=0)
