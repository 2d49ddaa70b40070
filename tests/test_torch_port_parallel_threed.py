"""Port parity: the 3D point-cloud step on two gloo ranks against the JAX
package's data-parallel step on a 2-device mesh.

The pattern of tests/test_torch_port_parallel_image.py with the 3D
StepConfig (chamfer with the +0.5 shift, prior std 0.2, fresh z in the
D-phase, detached expELBO targets, beta_rec 20, beta_neg 16) and the plain
chamfer (JAX ``chamfer_impl="xla"``; the port's CPU path): the PointNet
weights of JAX keys 0 and 1, the decoder's output layer scaled by 20 so its
clouds spread like a trained decoder's (tests/test_torch_port_step.py says
why), carried across by ``pointnet_state_dict_from_jax``; a global batch of
4 clouds of 32 points with injected global draws; JAX's ``optax.sgd``
step on the mesh, the port's ``sgd_gradient_probe`` in 2 ranks and in 1.
The step is lr = 1e-3, not 1: the probes step along the gradient (the JAX
probe's convention, parallel/verify.py), and at lr = 1 the narrow prior's
KL sends the encoder's logvar past exp's range in both packages. A delta is
then lr * g rounded to the weights' precision, so the ranks' runs are
compared on the gradients themselves. Held, for the intro and the vanilla
step:
  * per-leaf relative L2 of the deltas <= 1e-3 against JAX (measured worst
    4.2e-5 intro, 4.1e-6 vanilla: the deltas' rounding); the PointNet BN's
    running means within atol 1e-6 of flax's global statistics;
  * the ranks bit-equal; the 2-rank gradients against the 1-rank run's
    within relative L2 1e-5 (measured worst 1.1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from soft_intro_vae_tpu.models.pointnet import PointNetDecoder as JaxDecoder
from soft_intro_vae_tpu.models.pointnet import PointNetEncoder as JaxEncoder
from soft_intro_vae_tpu.parallel import mesh as jmesh
from soft_intro_vae_tpu.train.state import TrainState as JaxState
from soft_intro_vae_tpu.train.step import StepConfig as JaxStepConfig
from soft_intro_vae_tpu.train.step import build_train_steps as jax_build_train_steps
from soft_intro_vae_torch.parallel.launch import run_ranks, write_inputs
from soft_intro_vae_torch.parallel.verify import compare_gradient_trees
from soft_intro_vae_torch.train.step import INTRO_NOISES
from soft_intro_vae_torch.utils.from_jax import pointnet_state_dict_from_jax
from tests.torch_port_fixtures import one_torch_thread  # noqa: F401

B, N, Z = 4, 32, 8
PRIOR_STD, SPREAD = 0.2, 20.0
BETAS = dict(beta_rec=20.0, beta_neg=16.0)
LR = 1e-3  # an ascent of lr = 1 sends the encoder's logvar past exp's range
MODES = ("intro", "vanilla")


def _np_tree(t):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), t)


def _jax_run(mode, x, noises):
    enc, dec = JaxEncoder(z_dim=Z), JaxDecoder(z_dim=Z, n_points=N)
    ve = jax.jit(lambda k: enc.init(k, jnp.zeros((1, N, 3)), train=False))(jax.random.key(0))
    vd = jax.jit(lambda k: dec.init(k, jnp.zeros((1, Z))))(jax.random.key(1))
    params_d = _np_tree(vd["params"])
    params_d["out"] = {k: v * SPREAD for k, v in params_d["out"].items()}

    def encode(params, stats, x):
        (mu, lv), upd = enc.apply({"params": params, "batch_stats": stats}, x,
                                  train=True, mutable=["batch_stats"])
        return (mu, lv), upd["batch_stats"]

    def decode(params, stats, z):
        return dec.apply({"params": params}, z), stats

    opt = optax.sgd(LR)
    vanilla, intro = jax_build_train_steps(
        encode=encode, decode=decode, optimizer=opt, donate=False,
        cfg=JaxStepConfig(z_dim=Z, scale=1.0 / (3 * N), loss_type="chamfer",
                          prior_logvar=float(np.log(PRIOR_STD**2)), prior_std=PRIOR_STD,
                          fresh_z_in_d=True, detach_expelbo_targets=True, chamfer_impl="xla",
                          **BETAS))
    state = JaxState.create(params_e=ve["params"], params_d=jax.tree_util.tree_map(jnp.asarray, params_d),
                            stats_e=ve["batch_stats"], opt_e=opt.init(ve["params"]),
                            opt_d=opt.init(params_d), rng=jax.random.key(2), lr_e=1.0, lr_d=1.0)
    k = jax.random.fold_in(state.rng, state.step)
    eps = np.asarray(jax.random.normal(jax.random.fold_in(k, 0), (B, Z), jnp.float32))
    mesh = jmesh.make_data_mesh(2)
    s, xs = jmesh.shard_state(state, mesh), jmesh.shard_batch(jnp.asarray(x), mesh)
    if mode == "intro":
        after, _ = intro(s, xs, {n: jnp.asarray(v) for n, v in noises.items()})
    else:
        after, _ = vanilla(s, xs)
    init = pointnet_state_dict_from_jax(_np_tree(ve["params"]), _np_tree(ve["batch_stats"]),
                                        params_d)
    delta = lambda a, b: jax.tree_util.tree_map(lambda u, v: np.asarray(u) - np.asarray(v), a, b)  # noqa: E731
    ref = pointnet_state_dict_from_jax(delta(state.params_e, after.params_e),
                                       _np_tree(after.stats_e),
                                       delta(state.params_d, after.params_d))
    return init, {k: v.numpy() for k, v in ref.items()}, eps


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("threed_dp")
    rs = np.random.default_rng(1)
    x = (rs.random((B, N, 3)) - 0.5).astype(np.float32)
    noises = {k: rs.standard_normal((B, Z)).astype(np.float32) for k in INTRO_NOISES}
    refs, inputs = {}, {}
    for mode in MODES:
        init, refs[mode], eps = _jax_run(mode, x, noises)
        inputs[mode] = dict(x=x, noises=noises if mode == "intro" else {"eps": eps},
                            weights={k: v.numpy() for k, v in init.items()})
    path = write_inputs(str(tmp / "inputs.npz"), inputs)
    jobs = [dict(name=m, probe="sgd_gradient_probe",
                 kwargs=dict(variant="3d", mode=m, z_dim=Z, n_points=N, step_kwargs=BETAS,
                             lr=LR))
            for m in MODES]
    two = run_ranks(2, jobs, str(tmp), inputs=path)
    (one,) = run_ranks(1, jobs, str(tmp), inputs=path)
    return refs, two, one


def _part(res, name, kind):
    return {k.split("/", 2)[2]: v for k, v in res.items() if k.startswith(f"{name}/{kind}/")}


@pytest.mark.parametrize("mode", MODES)
def test_two_ranks_match_the_jax_data_parallel_step(runs, mode):
    refs, two, one = runs
    for k in two[0]:
        if k.startswith(mode + "/"):
            np.testing.assert_array_equal(two[0][k], two[1][k], err_msg=f"rank skew in {k}")
    got = _part(two[0], mode, "delta")
    compare_gradient_trees(got, refs[mode], rtol=1e-3, keys=sorted(got))
    compare_gradient_trees(_part(two[0], mode, "grad"), _part(one, mode, "grad"), rtol=1e-5)
    for k, v in _part(two[0], mode, "buf").items():
        if k.endswith("running_mean"):
            np.testing.assert_allclose(v, refs[mode][k], rtol=0, atol=1e-6, err_msg=k)
    metrics = _part(two[0], mode, "metric")
    for k, v in _part(one, mode, "metric").items():
        assert float(metrics[k]) == pytest.approx(float(v), rel=1e-5, abs=1e-7), k
