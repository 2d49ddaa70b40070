"""Port parity: soft_intro_vae_torch.train.step against the JAX package's step.

The 3D StepConfig (chamfer with the +0.5 shift, narrow prior, fresh z in the
D-phase, detached expELBO targets), the same PointNet weights (carried across
by ``pointnet_state_dict_from_jax``) and the same injected noises go through
the JAX ``intro_step``/``vanilla_step`` (chamfer by the Pallas kernel,
interpreted on the CPU) and the port's. Two chained intro steps, and one
vanilla step.

Losses: loss_e and loss_d within rel 1e-4 at every step (measured: < 1e-5).

Parameters after the last step: every tensor's update agrees within 1e-2 of
its norm, and at most 1e-4 of all elements lie beyond atol 1e-5. Why not every
element at atol 1e-5: the step is discontinuous in its inputs. Chamfer's
nearest-neighbour matches and the encoder's max-pool pick one point each, and
a float32 rounding difference after step 1 (sums taken in another order) can
switch a pick in step 2. That moves a few gradient elements by O(1), and Adam,
which divides by sqrt(v), turns them into moves of O(lr). Measured here: 36 of
1,075,504 elements beyond 1e-5 after two intro steps, the largest update
difference 0.5% of its tensor's norm. The decoder's output layer is scaled
by SPREAD so that its clouds are spread like a trained decoder's; at PyTorch's
init every point sits within a few hundredths of the others, near-ties decide
most matches, and 1.7% of the elements drift apart by step 2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soft_intro_vae_tpu.models.pointnet import PointNetDecoder as JaxDecoder
from soft_intro_vae_tpu.models.pointnet import PointNetEncoder as JaxEncoder
from soft_intro_vae_tpu.train import optim as joptim
from soft_intro_vae_tpu.train.state import TrainState as JaxState
from soft_intro_vae_tpu.train.step import StepConfig as JaxStepConfig
from soft_intro_vae_tpu.train.step import build_train_steps as jax_build_train_steps
from soft_intro_vae_torch.models.pointnet import SoftIntroVAE3D
from soft_intro_vae_torch.train.state import TrainState
from soft_intro_vae_torch.train.step import INTRO_NOISES, StepConfig, build_train_steps
from soft_intro_vae_torch.utils.from_jax import pointnet_state_dict_from_jax
from tests.torch_port_fixtures import cuda_device, one_torch_thread  # noqa: F401

B, N, Z = 4, 32, 8
LR = 5e-4
PRIOR_STD = 0.2
SPREAD = 20.0  # decoder output scale, see the module docstring
CFG = dict(z_dim=Z, beta_rec=20.0, beta_kl=1.0, beta_neg=16.0, gamma_r=1e-8,
           scale=1.0 / (3 * N), loss_type="chamfer", prior_logvar=float(np.log(PRIOR_STD**2)),
           prior_std=PRIOR_STD, fresh_z_in_d=True, detach_expelbo_targets=True)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, dtype=np.float32), tree)


@pytest.fixture(scope="module")
def jax_setup():
    enc, dec = JaxEncoder(z_dim=Z), JaxDecoder(z_dim=Z, n_points=N)
    # one compiled init each (an eager init compiles every op on its own)
    ve = jax.jit(lambda k: enc.init(k, jnp.zeros((1, N, 3)), train=False))(jax.random.key(0))
    vd = jax.jit(lambda k: dec.init(k, jnp.zeros((1, Z))))(jax.random.key(1))
    params_d = _np_tree(vd["params"])
    params_d["out"] = {k: v * SPREAD for k, v in params_d["out"].items()}
    params_d = jax.tree_util.tree_map(jnp.asarray, params_d)

    def encode(params, stats, x):
        (mu, lv), upd = enc.apply({"params": params, "batch_stats": stats}, x,
                                  train=True, mutable=["batch_stats"])
        return (mu, lv), upd["batch_stats"]

    def decode(params, stats, z):
        return dec.apply({"params": params}, z), stats

    opt = joptim.adam()
    vanilla, intro = jax_build_train_steps(
        encode=encode, decode=decode, optimizer=opt, donate=False,
        cfg=JaxStepConfig(chamfer_impl="pallas", **CFG))

    def fresh_state():
        return JaxState.create(params_e=ve["params"], params_d=params_d,
                               stats_e=ve["batch_stats"], opt_e=opt.init(ve["params"]),
                               opt_d=opt.init(params_d), rng=jax.random.key(2),
                               lr_e=LR, lr_d=LR)

    return fresh_state, vanilla, intro


def _port_state(jstate):
    model = SoftIntroVAE3D(z_dim=Z, n_points=N)
    model.load_state_dict(pointnet_state_dict_from_jax(
        _np_tree(jstate.params_e), _np_tree(jstate.stats_e), _np_tree(jstate.params_d)))
    return TrainState.create(model, device=torch.device("cpu"), seed=0, lr_e=LR, lr_d=LR)


def _assert_same_weights(state, jstate, before):
    """The bounds of the module docstring, against the JAX state; ``before``
    is the port's state_dict before the steps."""
    want = pointnet_state_dict_from_jax(_np_tree(jstate.params_e), _np_tree(jstate.stats_e),
                                        _np_tree(jstate.params_d))
    got = state.model.state_dict()
    beyond = total = 0
    for k, v in want.items():
        if k.endswith(("running_var", "num_batches_tracked")):
            continue  # running_var: biased vs unbiased, see test_torch_port_pointnet.py
        g, w, b = got[k].numpy(), v.numpy(), before[k].numpy()
        beyond += int((np.abs(g - w) > 1e-5).sum())
        total += w.size
        if k.endswith("running_mean"):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5, err_msg=k)
        else:
            upd = np.linalg.norm(w - b)
            assert np.linalg.norm((g - b) - (w - b)) <= 1e-2 * upd + 1e-7, k
    assert beyond <= 1e-4 * total, f"{beyond} of {total} elements beyond atol 1e-5"


def _clouds(rs):
    return (0.3 * rs.randn(B, N, 3)).astype(np.float32)


def test_two_intro_steps_match_jax(jax_setup):
    fresh_state, _, jintro = jax_setup
    jstate = fresh_state()
    state = _port_state(jstate)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    _, intro = build_train_steps(cfg=StepConfig(**CFG))
    rs = np.random.RandomState(11)
    for i in range(2):
        x = _clouds(rs)
        nz = {k: rs.randn(B, Z).astype(np.float32) for k in INTRO_NOISES}
        nz["noise"] *= PRIOR_STD
        jstate, jm = jintro(jstate, jnp.asarray(x), {k: jnp.asarray(v) for k, v in nz.items()})
        state, m = intro(state, torch.tensor(x), {k: torch.tensor(v) for k, v in nz.items()})
        assert set(m) == set(jm)
        for k in ("loss_e", "loss_d"):
            assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-4), f"step {i} {k}"
        for k in ("rec", "kl_real", "kl_rec", "kl_fake", "diff_kl"):
            assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-4, abs=1e-6), f"step {i} {k}"
    assert state.step == 2 == int(jstate.step)
    _assert_same_weights(state, jstate, before)


def test_vanilla_step_matches_jax(jax_setup):
    fresh_state, jvanilla, _ = jax_setup
    jstate = fresh_state()
    state = _port_state(jstate)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    vanilla, _ = build_train_steps(cfg=StepConfig(**CFG))
    x = _clouds(np.random.RandomState(12))
    # the JAX vanilla step draws its eps from fold_in(fold_in(rng, step), 0)
    k = jax.random.fold_in(jstate.rng, jstate.step)
    eps = np.asarray(jax.random.normal(jax.random.fold_in(k, 0), (B, Z), jnp.float32))
    jstate, jm = jvanilla(jstate, jnp.asarray(x))
    state, m = vanilla(state, torch.tensor(x), {"eps": torch.tensor(eps)})
    assert set(m) == set(jm)
    for key in m:
        assert float(m[key]) == pytest.approx(float(jm[key]), rel=1e-4), key
    _assert_same_weights(state, jstate, before)


def test_each_phase_grads_only_its_own_subnet():
    """E-phase gradients reach only the encoder and D-phase only the decoder:
    one intro step accumulates exactly one gradient into every parameter."""
    torch.manual_seed(0)
    state = TrainState.create(SoftIntroVAE3D(z_dim=Z, n_points=N), device=torch.device("cpu"),
                              seed=0, lr_e=LR, lr_d=LR)
    counts = {}
    for name, p in state.model.named_parameters():
        counts[name] = 0
        p.register_post_accumulate_grad_hook(lambda _p, name=name: counts.__setitem__(name, counts[name] + 1))
    _, intro = build_train_steps(cfg=StepConfig(**CFG))
    intro(state, torch.tensor(_clouds(np.random.RandomState(0))))
    assert set(counts.values()) == {1}, {k: v for k, v in counts.items() if v != 1}
    assert all(p.requires_grad for p in state.model.parameters())


def test_draws_come_from_the_state_generator():
    def run():
        torch.manual_seed(0)
        state = TrainState.create(SoftIntroVAE3D(z_dim=Z, n_points=N), device=torch.device("cpu"),
                                  seed=5, lr_e=LR, lr_d=LR)
        _, intro = build_train_steps(cfg=StepConfig(**CFG))
        torch.manual_seed(123)  # the global RNG must not matter
        return float(intro(state, torch.tensor(_clouds(np.random.RandomState(1))))[1]["loss_e"])

    first = run()
    torch.manual_seed(999)
    assert run() == first


def _k_step_runs(fresh_state, phase, xs, scan, device="cpu"):
    """(state, metrics) after the batches of ``xs``: one K-step call of
    ``scan`` steps each, or single eager steps (``.eager``, the step that
    ``scan_steps=1`` replays as a graph on the card) with their metrics
    stacked."""
    state = _port_state(fresh_state())
    if device != "cpu":
        state = TrainState.create(state.model, device=torch.device(device), seed=0, lr_e=LR, lr_d=LR)
    step = build_train_steps(cfg=StepConfig(**CFG), scan_steps=scan)[phase]
    xs = torch.tensor(xs, device=device)
    if scan == 1:
        ms = [step.eager(state, x)[1] for x in xs]
        return state, {k: torch.stack([m[k] for m in ms]) for k in ms[0]}
    chunks = [step(state, xs[i:i + scan])[1] for i in range(0, len(xs), scan)]
    return state, {k: torch.cat([m[k] for m in chunks]) for k in chunks[0]}


def _assert_same_runs(a, b):
    (sa, ma), (sb, mb) = a, b
    assert sa.step == sb.step and ma.keys() == mb.keys()
    for k in ma:
        torch.testing.assert_close(ma[k], mb[k], rtol=0, atol=0, msg=k)
    for k, v in sa.model.state_dict().items():
        torch.testing.assert_close(v, sb.model.state_dict()[k], rtol=0, atol=0, msg=k)
    for oa, ob in ((sa.opt_e, sb.opt_e), (sa.opt_d, sb.opt_d)):
        for p, q in zip(oa.state.values(), ob.state.values()):
            for k in ("exp_avg", "exp_avg_sq", "step"):
                torch.testing.assert_close(p[k], q[k], rtol=0, atol=0, msg=k)
    torch.testing.assert_close(sa.generator.get_state(), sb.generator.get_state())


@pytest.mark.parametrize("phase", [0, 1], ids=["vanilla", "intro"])
def test_k_steps_equal_single_steps(jax_setup, phase):
    """scan_steps=3 on the CPU: one call of three steps gives (3,) metrics
    under the names the JAX step (and so its scan) returns, equal to three
    single port steps, with the same weights, Adam state and generator
    after. With the golden tests above (port step = JAX step) and the JAX
    package's tests/test_step.py (JAX scan = sequential JAX steps) this holds
    the port's K-step to the JAX scan."""
    fresh_state, *jsteps = jax_setup
    rs = np.random.RandomState(13)
    xs = np.stack([_clouds(rs) for _ in range(3)])
    _, jm = jsteps[phase](fresh_state(), jnp.asarray(xs[0]))
    single = _k_step_runs(fresh_state, phase, xs, 1)
    scanned = _k_step_runs(fresh_state, phase, xs, 3)
    assert set(scanned[1]) == set(jm)
    assert all(v.shape == (3,) for v in scanned[1].values())
    assert scanned[0].step == 3
    _assert_same_runs(scanned, single)


def test_scan_steps_take_a_leading_k_axis():
    with pytest.raises(ValueError, match="scan_steps"):
        build_train_steps(cfg=StepConfig(**CFG), scan_steps=0)
    torch.manual_seed(0)
    state = TrainState.create(SoftIntroVAE3D(z_dim=Z, n_points=N), device=torch.device("cpu"),
                              seed=0, lr_e=LR, lr_d=LR)
    _, intro = build_train_steps(cfg=StepConfig(**CFG), scan_steps=2)
    with pytest.raises(ValueError, match="K >= 1"):
        intro(state, torch.zeros((0, B, N, 3)))
    # a short chunk: k < K steps, (k,) metrics
    state, m = intro(state, torch.tensor(_clouds(np.random.RandomState(3)))[None])
    assert state.step == 1 and all(v.shape == (1,) for v in m.values())


@pytest.mark.cuda
def test_graph_k_steps_equal_eager_steps_on_the_card(jax_setup, cuda_device):
    """On the card a K-step call replays a captured CUDA graph: two calls of
    four steps (the first three of them the eager warm-up) equal eight eager
    steps, chamfer kernel included. PyTorch's deterministic kernels are on:
    the chamfer backward's scatter_add_ otherwise sums with atomics in no
    fixed order, and two eager runs differ in the last bits."""
    fresh_state, *_ = jax_setup
    rs = np.random.RandomState(14)
    xs = np.stack([_clouds(rs) for _ in range(8)])
    saved = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        graphed = _k_step_runs(fresh_state, 1, xs, 4, cuda_device)
        eager = _k_step_runs(fresh_state, 1, xs, 1, cuda_device)
    finally:
        torch.use_deterministic_algorithms(saved)
    _assert_same_runs(graphed, eager)


def test_image_default_branches_run():
    """The image-default flags (mse, no fresh z, expELBO target not detached)."""
    torch.manual_seed(0)
    state = TrainState.create(SoftIntroVAE3D(z_dim=Z, n_points=N), device=torch.device("cpu"),
                              seed=0, lr_e=LR, lr_d=LR)
    _, intro = build_train_steps(cfg=StepConfig(z_dim=Z, loss_type="mse", scale=1.0 / (3 * N)))
    _, m = intro(state, torch.tensor(_clouds(np.random.RandomState(2))))
    assert all(torch.isfinite(v) for v in m.values())
