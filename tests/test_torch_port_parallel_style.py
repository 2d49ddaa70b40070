"""Port parity: two style intro steps on two gloo ranks against the JAX
package's style step on a 2-device mesh, and a checkpoint saved under two
ranks resumed under one.

The JAX style probe's tiny config (parallel/verify.py:133-134: startf 8,
maxf 16, two layers, latent 8, two mapping layers) at LOD 1 on the blend
program (blend 0.5), with style mixing off and the decoder's deterministic
noise correction (noise_mode "none"), so that the draws can be injected:
global latents ``nz`` and a global batch of 4 a step. The reference is
JAX's ``build_style_steps`` + ``optax.sgd(1.0)`` on a 2-device mesh of this
process's virtual CPU devices, from ``StyleModel.init_params(key(1))``
moved off its zeros by 0.05 * randn, as tests/test_torch_port_style_step.py
does (at the init itself decoder block 0's gradient at LOD 1 is a sum of
cancelling terms, ROADMAP Queue 3); the port runs ``parallel/verify.py
style_step_probe`` on the same weights (``style_state_dict_from_jax``) in 2
ranks and in 1.

Held after the two steps (deltas, EMA nets, dlatent_avg and its EMA):
  * against JAX and between the port's 2- and 1-rank runs, each leaf's L2
    difference under rtol * its norm + 1e-3: the rule of
    tests/test_multihost_style_exec.py, whose atol floor takes the block
    biases that sit before an instance norm (their gradient is zero and
    their delta rounding noise); rtol 1e-3 against JAX, 1e-5 between the
    port's runs. Measured worst relative L2 over the leaves whose norm is
    above 1e-2: 5.0e-4 against JAX, 7.3e-5 between the port's runs (1.3e-5
    after one step): each ascent step of lr = 1 carries the last bits of
    the per-sample sums, which split differently across ranks, into the
    next, and the small decoder leaves cancel; the atol floor holds them;
  * the step-2 metrics within rel 1e-5 between the runs (kl_diff through
    its terms);
  * the ranks bit-equal;
  * the resume: rank 0 alone writes the step-1 checkpoint under 2 ranks, a
    1-rank run loads it and takes step 2, and lands where the uninterrupted
    runs do, under the same rule.
"""

import glob

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from soft_intro_vae_tpu.parallel import mesh as jmesh
from soft_intro_vae_tpu.train.style_step import StyleModel as JaxStyleModel
from soft_intro_vae_tpu.train.style_step import StyleModelConfig as JaxStyleModelConfig
from soft_intro_vae_tpu.train.style_step import StyleStepConfig as JaxStyleStepConfig
from soft_intro_vae_tpu.train.style_step import StyleTrainState as JaxStyleTrainState
from soft_intro_vae_tpu.train.style_step import build_style_steps as jax_build_style_steps
from soft_intro_vae_torch.parallel.launch import run_ranks, write_inputs
from soft_intro_vae_torch.train.style_step import NZ_KEYS
from soft_intro_vae_torch.utils.from_jax import style_state_dict_from_jax
from tests.torch_port_fixtures import one_torch_thread  # noqa: F401

B, RES, LATENT, STEPS, BLEND = 4, 8, 8, 2, 0.5
MODEL = dict(startf=8, maxf=16, layer_count=2, latent_size=LATENT, mapping_layers=2,
             style_mixing_prob=None)
EMA_BETA = 0.5 ** (B / 10000.0)


def _np_tree(t):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), t)


def _jax_run(xs, nzs):
    model = JaxStyleModel(JaxStyleModelConfig(**MODEL))
    pe, pd, buf = model.init_params(jax.random.key(1))
    rs = np.random.RandomState(41)
    bump = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda a: np.asarray(a, np.float32) + 0.05 * rs.randn(*a.shape).astype(np.float32), t)
    pe, pd = bump(pe), bump(pd)
    copy = lambda t: jax.tree_util.tree_map(lambda a: jnp.array(a), t)  # noqa: E731
    opt = optax.sgd(1.0)
    state = JaxStyleTrainState(
        step=jnp.zeros((), jnp.int32), params_e=copy(pe), params_d=copy(pd), buffers=copy(buf),
        ema_e=copy(pe), ema_d=copy(pd), ema_buffers=copy(buf), opt_e=opt.init(pe),
        opt_d=opt.init(pd), lr=jnp.asarray(1.0, jnp.float32),
        ema_beta=jnp.asarray(EMA_BETA, jnp.float32), rng=jax.random.key(3))
    scfg = JaxStyleStepConfig(latent_size=LATENT, scale=1.0 / (3 * RES * RES))
    _, intro = jax_build_style_steps(model, scfg, lod=1, blended=True, optimizer=opt,
                                     noise_mode="none")
    mesh = jmesh.make_data_mesh(2)
    state = jmesh.shard_state(state, mesh)
    for i in range(STEPS):
        state, _ = intro(state, jmesh.shard_batch(jnp.asarray(xs[i]), mesh),
                         jnp.asarray(BLEND, jnp.float32),
                         {k: jnp.asarray(v) for k, v in nzs[i].items()})
    init = style_state_dict_from_jax(_np_tree(pe), _np_tree(pd), _np_tree(buf))
    delta = lambda a, b: jax.tree_util.tree_map(lambda u, v: np.asarray(u) - np.asarray(v), a, b)  # noqa: E731
    d = style_state_dict_from_jax(delta(pe, state.params_e), delta(pd, state.params_d),
                                  _np_tree(state.buffers))
    ema = style_state_dict_from_jax(_np_tree(state.ema_e), _np_tree(state.ema_d),
                                    _np_tree(state.ema_buffers))
    ref = {f"delta/{k}": v.numpy() for k, v in d.items() if k != "dlatent_avg.buff"}
    ref.update({f"ema/{k}": v.numpy() for k, v in ema.items() if k != "dlatent_avg.buff"})
    ref["dlatent_avg"] = d["dlatent_avg.buff"].numpy()
    ref["ema_dlatent_avg"] = ema["dlatent_avg.buff"].numpy()
    return init, ref


def _flat(res, prefix):
    """A probe's results as the JAX side's keys: delta_e/ and delta_d/ as delta/."""
    out = {}
    for k, v in res.items():
        if not k.startswith(prefix):
            continue
        k = k[len(prefix):]
        if k.startswith(("delta_e/", "delta_d/")):
            k = "delta/" + k.split("/", 1)[1]
        if k.startswith(("delta/", "ema/")) or k in ("dlatent_avg", "ema_dlatent_avg"):
            out[k] = v
    return out


def _compare(got, want, rtol):
    """Each leaf's L2 difference under rtol * its norm + 1e-3 (module doc)."""
    assert set(got) == set(want) and len(want) > 1
    for k in want:
        diff = float(np.linalg.norm(got[k] - want[k]))
        norm = float(np.linalg.norm(want[k]))
        assert diff < rtol * norm + 1e-3, f"{k}: diverged, L2 {diff:.2e}, norm {norm:.2e}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("style_dp")
    rs = np.random.default_rng(2)
    xs = (rs.random((STEPS, B, RES, RES, 3)) * 2.0 - 1.0).astype(np.float32)
    nzs = [{k: rs.standard_normal((B, LATENT)).astype(np.float32) for k in NZ_KEYS}
           for _ in range(STEPS)]
    init, ref = _jax_run(xs, nzs)
    path = write_inputs(str(tmp / "inputs.npz"), {"style": dict(
        xs=xs, nzs=nzs, weights={k: v.numpy() for k, v in init.items()})})
    kw = dict(model_kwargs=MODEL, lod=1, blend=BLEND, steps=STEPS, noise_mode="none",
              ema_beta=EMA_BETA)
    ckpt = str(tmp / "ckpt_style")
    two = run_ranks(2, [dict(name="style", probe="style_step_probe",
                             kwargs=dict(kw, save_dir=ckpt))], str(tmp), inputs=path)
    (one,) = run_ranks(1, [dict(name="style", probe="style_step_probe", kwargs=kw)],
                       str(tmp), inputs=path)
    (resumed,) = run_ranks(1, [dict(name="style", probe="style_step_probe",
                                    kwargs=dict(kw, restore_dir=ckpt, start_step=1))],
                           str(tmp), inputs=path)
    return ref, two, one, resumed, ckpt


def test_two_ranks_match_the_jax_style_step(runs):
    ref, two, one, _, _ = runs
    for k in two[0]:
        np.testing.assert_array_equal(two[0][k], two[1][k], err_msg=f"rank skew in {k}")
    assert int(two[0]["style/step"]) == int(one["style/step"]) == STEPS
    _compare(_flat(two[0], "style/"), ref, rtol=1e-3)
    _compare(_flat(two[0], "style/"), _flat(one, "style/"), rtol=1e-5)
    for k, v in one.items():
        # kl_diff = fake_kl - real_kl cancels; its terms are held
        if k.startswith("style/metric/") and not k.endswith("kl_diff"):
            assert float(two[0][k]) == pytest.approx(float(v), rel=1e-5, abs=1e-7), k


def test_a_checkpoint_of_two_ranks_resumes_under_one(runs):
    ref, two, one, resumed, ckpt = runs
    assert int(resumed["style/step"]) == STEPS
    got = _flat(resumed, "style/")
    _compare(got, _flat(one, "style/"), rtol=1e-5)
    _compare(got, _flat(two[0], "style/"), rtol=1e-5)
    _compare(got, ref, rtol=1e-3)
    # the step-1 checkpoint was written once, by rank 0
    assert len(glob.glob(f"{ckpt}/*.ckpt")) == 1
