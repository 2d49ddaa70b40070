"""Port parity: the image and bootstrap steps on two gloo ranks against the JAX
package's data-parallel step on a 2-device mesh.

The reference is JAX's own ``build_train_steps`` + ``optax.sgd(1.0)`` on a
2-device mesh of this process's 8 virtual CPU devices (parallel/mesh.py:
replicated state, sharded batch, GSPMD's all-reduce, BN over the global
batch), from the init that parallel/verify.py:32-78 builds (the probe's
ImageConfig, keys 1 and 2), on a float NHWC global batch of 4 with injected
global draws. The port runs ``parallel/verify.py sgd_gradient_probe`` on the
same weights (``image_state_dict_from_jax``) and draws in 2 gloo ranks,
2 rows each, and in 1 rank. Intro and vanilla steps, image and bootstrap.

With lr = 1 a delta is the negative all-reduced gradient. Held:
  * the 2-rank deltas against JAX's: per-leaf relative L2 <= 1e-3, the JAX
    package's bound (parallel/verify.py:191-202); measured worst 5.7e-6
    (intro), 3.3e-6 (vanilla);
  * the two ranks bit-equal to each other (deltas, BN buffers, metrics);
  * the 2-rank run against the 1-rank run: per-leaf relative L2 <= 1e-5;
    measured worst 1.9e-6;
  * running means against flax's within atol 1e-6; the bootstrap step's
    online decoder takes zero gradients in the vanilla step and its target
    decoder never moves.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from soft_intro_vae_tpu.data.images import ImageSpec as JaxImageSpec
from soft_intro_vae_tpu.parallel import mesh as jmesh
from soft_intro_vae_tpu.train.image import ImageConfig as JaxImageConfig
from soft_intro_vae_tpu.train.image import build_image_models, make_model_fns
from soft_intro_vae_tpu.train.state import TrainState as JaxState
from soft_intro_vae_tpu.train.step import StepConfig as JaxStepConfig
from soft_intro_vae_tpu.train.step import build_train_steps as jax_build_train_steps
from soft_intro_vae_torch.parallel.launch import run_ranks, write_inputs
from soft_intro_vae_torch.parallel.verify import compare_gradient_trees
from soft_intro_vae_torch.train.step import INTRO_NOISES
from soft_intro_vae_torch.utils.from_jax import image_state_dict_from_jax
from tests.torch_port_fixtures import one_torch_thread  # noqa: F401

CH, IMG, Z, B = (8, 16), 16, 16, 4
CASES = [(v, m) for v in ("image", "bootstrap") for m in ("intro", "vanilla")]


def _np_tree(t):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), t)


def _jax_run(variant, mode, x, noises):
    """One step of the JAX package on a 2-device mesh, from verify.py's init;
    returns (initial state_dict, delta-and-statistics state_dict, eps)."""
    boot = variant == "bootstrap"
    spec = JaxImageSpec("probe", IMG, CH, 3)
    cfg = JaxImageConfig(dataset="probe", z_dim=Z, batch_size=B, num_devices=2, seed=0)
    enc, dec = build_image_models(spec, cfg)
    encode, decode = make_model_fns(enc, dec)
    ve = enc.init(jax.random.key(1), jnp.zeros((1, IMG, IMG, 3)), train=False)
    vd = dec.init(jax.random.key(2), jnp.zeros((1, Z)), train=False)
    opt = optax.sgd(1.0)
    state = JaxState.create(
        params_e=ve["params"], params_d=vd["params"], stats_e=ve["batch_stats"],
        stats_d=vd["batch_stats"], params_d_target=vd["params"] if boot else None,
        stats_d_target=vd["batch_stats"] if boot else None, opt_e=opt.init(ve["params"]),
        opt_d=opt.init(vd["params"]), rng=jax.random.key(3), lr_e=1.0, lr_d=1.0)
    vanilla, intro = jax_build_train_steps(
        encode=encode, decode=decode, optimizer=opt, donate=False,
        decode_target=decode if boot else None,
        cfg=JaxStepConfig(z_dim=Z, scale=spec.scale, bootstrap=boot))
    k = jax.random.fold_in(state.rng, state.step)  # the vanilla step's own eps
    eps = np.asarray(jax.random.normal(jax.random.fold_in(k, 0), (B, Z), jnp.float32))
    mesh = jmesh.make_data_mesh(2)
    s = jmesh.shard_state(state, mesh)
    xs = jmesh.shard_batch(jnp.asarray(x), mesh)
    if mode == "intro":
        after, _ = intro(s, xs, {n: jnp.asarray(v) for n, v in noises.items()})
    else:
        after, _ = vanilla(s, xs)
    t = lambda tree: _np_tree(tree) if boot else None  # noqa: E731
    init = image_state_dict_from_jax(_np_tree(ve["params"]), _np_tree(ve["batch_stats"]),
                                     _np_tree(vd["params"]), _np_tree(vd["batch_stats"]), CH, IMG,
                                     t(vd["params"]), t(vd["batch_stats"]))
    delta = lambda a, b: jax.tree_util.tree_map(lambda u, v: np.asarray(u) - np.asarray(v), a, b)  # noqa: E731
    ref = image_state_dict_from_jax(
        delta(state.params_e, after.params_e), _np_tree(after.stats_e),
        delta(state.params_d, after.params_d), _np_tree(after.stats_d), CH, IMG,
        delta(state.params_d_target, after.params_d_target) if boot else None,
        _np_tree(after.stats_d_target) if boot else None)
    return init, {k: v.numpy() for k, v in ref.items()}, eps


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("image_dp")
    rs = np.random.default_rng(0)
    x = rs.random((B, IMG, IMG, 3)).astype(np.float32)
    noises = {k: rs.standard_normal((B, Z)).astype(np.float32) for k in INTRO_NOISES}
    refs, inputs = {}, {}
    for variant, mode in CASES:
        init, ref, eps = _jax_run(variant, mode, x, noises)
        refs[variant, mode] = ref
        inputs[f"{variant}_{mode}"] = dict(
            x=x, noises=noises if mode == "intro" else {"eps": eps},
            weights={k: v.numpy() for k, v in init.items()})
    path = write_inputs(str(tmp / "inputs.npz"), inputs)
    jobs = [dict(name=f"{v}_{m}", probe="sgd_gradient_probe",
                 kwargs=dict(variant=v, mode=m, z_dim=Z, channels=list(CH), image_size=IMG))
            for v, m in CASES]
    two = run_ranks(2, jobs, str(tmp), inputs=path)
    (one,) = run_ranks(1, jobs, str(tmp), inputs=path)
    return refs, two, one


def _part(res, name, kind):
    return {k.split("/", 2)[2]: v for k, v in res.items() if k.startswith(f"{name}/{kind}/")}


@pytest.mark.parametrize("variant, mode", CASES)
def test_two_ranks_match_the_jax_data_parallel_step(runs, variant, mode):
    refs, two, one = runs
    name, ref = f"{variant}_{mode}", refs[variant, mode]
    for k in two[0]:
        if k.startswith(name + "/"):
            np.testing.assert_array_equal(two[0][k], two[1][k], err_msg=f"rank skew in {k}")
    got, single = _part(two[0], name, "delta"), _part(one, name, "delta")
    params = sorted(k for k in got if not k.startswith("target_decoder."))
    compare_gradient_trees(got, ref, rtol=1e-3, keys=params)
    compare_gradient_trees(got, single, rtol=1e-5, keys=params)
    bufs = _part(two[0], name, "buf")
    for k, v in bufs.items():
        if k.endswith("running_mean"):
            np.testing.assert_allclose(v, ref[k], rtol=0, atol=1e-6, err_msg=k)
    if variant == "bootstrap":
        for k, v in got.items():
            if k.startswith("target_decoder.") or (mode == "vanilla" and k.startswith("decoder.")):
                assert not v.any(), f"{k} moved"
    metrics = _part(two[0], name, "metric")
    for k, v in _part(one, name, "metric").items():
        assert float(metrics[k]) == pytest.approx(float(v), rel=1e-5, abs=1e-7), k

