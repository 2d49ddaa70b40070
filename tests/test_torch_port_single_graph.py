"""The single step as a CUDA graph (train/graph.py ``one_step``, wrapped by
train/step.py ``build_train_steps`` at ``scan_steps == 1``): the counterpart
of the JAX package's jitted step for the image, bootstrap, 3D and toy
trainers.

On the CPU:
  * every trainer's vanilla and intro step is the wrapper, exposing
    ``.eager`` (the step itself) and ``.graphed`` (its ``GraphedStep``), and
    two wrapped steps equal two eager ones bit for bit (metrics, parameters,
    BN buffers, Adam state, generator), capturing nothing;
  * with injected draws the wrapped step matches the JAX package's jitted
    step over two optimizer steps, 3D at the tolerances of
    tests/test_torch_port_step.py and image/bootstrap at those of
    tests/test_torch_port_image_step.py (weights carried across by
    utils/from_jax.py, chamfer by the Pallas kernel interpreted on the CPU,
    as those tests run it);
  * each trainer sends every step through the wrapper and lets go of the
    vanilla step (on the card: its graphs and their memory pool) at the
    switch to the introspective step;
  * a graph's key tells calls apart by their injected draws' names, shapes
    and dtypes, as a ``jax.jit`` step retraces on its pytree's structure.

On the card (``cuda`` marker; skipped here): graphed against eager bit-equal
for every trainer and phase, with and without injected draws, and through a
bootstrap target sync between replays.
"""

import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soft_intro_vae_torch.data.images import ArrayDataset, ImageSpec
from soft_intro_vae_torch.data.shapenet import SyntheticClouds
from soft_intro_vae_torch.data.toy import ToyDataset
from soft_intro_vae_torch.train import graph
from soft_intro_vae_torch.train import step as step_mod
from soft_intro_vae_torch.train.image import (
    ImageConfig, build_image_training, sync_target_decoder, train_soft_intro_vae)
from soft_intro_vae_torch.train.step import INTRO_NOISES
from soft_intro_vae_torch.train.threed import (
    ThreeDConfig, build_3d_training, train_soft_intro_vae_3d)
from soft_intro_vae_torch.train.toy import ToyConfig, build_toy, train_soft_intro_vae_toy
from tests import test_torch_port_image_step as image_parity
from tests import test_torch_port_step as threed_parity
from tests.test_torch_port_image_step import jax_setup as jax_image  # noqa: F401  (a fixture)
from tests.test_torch_port_step import jax_setup as jax_3d  # noqa: F401  (a fixture)
from tests.torch_port_fixtures import cuda_device, one_torch_thread  # noqa: F401

KINDS = ("image", "bootstrap", "3d", "toy")
PHASES = ("vanilla", "intro")
SPEC = ImageSpec("cifar10", 16, (8, 16), 3)
B, Z = 4, 8


def _build(kind: str, device: str = "cpu"):
    """(state, vanilla, intro, batches, z_dim) at a tiny width: the trainer's
    own build function, and three batches of its input."""
    if kind in ("image", "bootstrap"):
        boot = dict(bootstrap=True, gamma_r=1.0) if kind == "bootstrap" else {}
        cfg = ImageConfig(dataset="cifar10", z_dim=Z, batch_size=B, beta_neg=16.0, seed=0,
                          verbose=False, device=device, **boot)
        state, vanilla, intro = build_image_training(cfg, SPEC)
        if kind == "bootstrap":
            sync_target_decoder(state)
        xs = np.random.default_rng(3).integers(0, 256, (3, B, 16, 16, 3), dtype=np.uint8)
    elif kind == "3d":
        cfg = ThreeDConfig(n_points=64, batch_size=B, z_size=Z, beta_neg=16.0, seed=0,
                           verbose=False, device=device)
        state, vanilla, intro = build_3d_training(cfg)
        xs = SyntheticClouds(3 * B, 64, seed=4).points.reshape(3, B, 64, 3)
    else:
        cfg = ToyConfig(z_dim=Z, batch_size=B, n_layers=2, num_hidden=16, seed=0,
                        beta_rec=0.2, beta_kl=0.3, beta_neg=0.9, verbose=False, device=device)
        state, vanilla, intro = build_toy(cfg)
        sampler = ToyDataset("8Gaussians", seed=5)
        xs = np.stack([sampler.next_batch(B) for _ in range(3)])
    return state, vanilla, intro, [torch.from_numpy(x).to(device) for x in xs], cfg


def _draws(phase: str, z: int, seed: int, device="cpu"):
    rs = np.random.RandomState(seed)
    names = INTRO_NOISES if phase == "intro" else ("eps",)
    return {n: torch.from_numpy(rs.randn(B, z).astype(np.float32)).to(device) for n in names}


def _assert_runs_equal(a, b):
    """Two (state, [metrics]) runs, every tensor bit for bit."""
    (sa, ma), (sb, mb) = a, b
    assert sa.step == sb.step and len(ma) == len(mb)
    for x, y in zip(ma, mb):
        assert x.keys() == y.keys()
        for k in x:
            assert x[k].dim() == 0 and torch.equal(x[k], y[k]), k
    da, db = sa.model.state_dict(), sb.model.state_dict()
    for k, v in da.items():
        assert torch.equal(v, db[k]), k
    for oa, ob in ((sa.opt_e, sb.opt_e), (sa.opt_d, sb.opt_d)):
        assert len(oa.state) == len(ob.state)
        for p, q in zip(oa.state.values(), ob.state.values()):
            for k in ("exp_avg", "exp_avg_sq", "step"):
                assert torch.equal(p[k], q[k]), k
    assert torch.equal(sa.generator.get_state(), sb.generator.get_state())


def _run(kind, phase, route, device="cpu", draws=False, steps=3, between=None):
    """``steps`` steps of ``phase`` through the wrapper (``route``
    "wrapped") or its ``.eager`` step, from a fresh state of the seed;
    ``between(state, i)`` runs after step i."""
    state, vanilla, intro, xs, cfg = _build(kind, device)
    wrapped = vanilla if phase == "vanilla" else intro
    step = wrapped if route == "wrapped" else wrapped.eager
    z = cfg.z_size if kind == "3d" else cfg.z_dim
    ms = []
    for i in range(steps):
        args = (_draws(phase, z, 10 + i, device),) if draws else ()
        state, m = step(state, xs[i % len(xs)], *args)
        ms.append(m)
        if between is not None:
            between(state, i)
    return (state, ms), wrapped


@pytest.mark.parametrize("phase", PHASES)
@pytest.mark.parametrize("kind", KINDS)
def test_scan_one_steps_are_the_wrapper_and_equal_eager_steps_on_the_cpu(kind, phase):
    wrapped_run, wrapped = _run(kind, phase, "wrapped", steps=2)
    eager_run, _ = _run(kind, phase, "eager", steps=2)
    assert isinstance(wrapped.graphed, graph.GraphedStep)
    assert wrapped.graphed.step is wrapped.eager and wrapped.eager.__name__ == f"{phase}_step"
    assert not wrapped.graphed.graphs and not wrapped.graphed.warmed  # nothing captured here
    _assert_runs_equal(wrapped_run, eager_run)


@pytest.mark.parametrize("phase", PHASES)
@pytest.mark.parametrize("kind", ("image", "bootstrap", "3d"))
def test_injected_draws_match_the_jitted_jax_step(kind, phase, jax_image, jax_3d):  # noqa: F811
    """Two optimizer steps of the wrapped step against two of the JAX
    package's ``jax.jit`` step, the same weights and draws: the batches and
    intro draws of those modules' own two-step tests (seeds 11 and 21; the
    3D step is discontinuous in its inputs, tests/test_torch_port_step.py),
    one batch twice for vanilla (seeds 12 and 22), whose ``eps`` is the JAX
    step's own draw (fold_in(fold_in(rng, step), 0))."""
    if kind == "3d":
        fresh_state, jsteps = jax_3d[0], {"vanilla": jax_3d[1], "intro": jax_3d[2]}
        jstate = fresh_state()
        state = threed_parity._port_state(jstate)
        vanilla, intro = step_mod.build_train_steps(cfg=step_mod.StepConfig(**threed_parity.CFG))
        rs = np.random.RandomState(12 if phase == "vanilla" else 11)
        batch = lambda: threed_parity._clouds(rs)  # noqa: E731
        z, b = threed_parity.Z, threed_parity.B
    else:
        boot = kind == "bootstrap"
        fresh_state, steps = jax_image
        jsteps = dict(zip(PHASES, steps[boot]))
        jstate = fresh_state(boot)
        state = image_parity._port_state(jstate, boot)
        vanilla, intro = image_parity._port_steps(boot)
        rs = np.random.RandomState(22 if phase == "vanilla" else 21)
        batch = lambda: image_parity._batch(rs)  # noqa: E731
        z, b = image_parity.Z, image_parity.B
    step = vanilla if phase == "vanilla" else intro
    assert callable(step.eager) and isinstance(step.graphed, graph.GraphedStep)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    x = batch()
    for i in range(2):
        if i and phase == "intro":
            x = batch()
        if phase == "vanilla":
            k = jax.random.fold_in(jstate.rng, jstate.step)
            nz = {"eps": np.asarray(jax.random.normal(jax.random.fold_in(k, 0), (b, z),
                                                      jnp.float32))}
            jstate, jm = jsteps["vanilla"](jstate, jnp.asarray(x))
        else:
            nz = {n: rs.randn(b, z).astype(np.float32) for n in INTRO_NOISES}
            if kind == "3d":
                nz["noise"] *= threed_parity.PRIOR_STD
            jstate, jm = jsteps["intro"](jstate, jnp.asarray(x),
                                         {n: jnp.asarray(v) for n, v in nz.items()})
        state, m = step(state, torch.from_numpy(x),
                        {n: torch.from_numpy(v.copy()) for n, v in nz.items()})
        assert set(m) == set(jm)
        for key in m:  # losses (and the vanilla metrics) rel 1e-4, the rest abs 1e-6 too
            exact = phase == "vanilla" or key in ("loss_e", "loss_d")
            assert float(m[key]) == pytest.approx(float(jm[key]), rel=1e-4,
                                                  abs=None if exact else 1e-6), f"step {i} {key}"
    assert state.step == 2 == int(jstate.step)
    if kind == "3d":
        threed_parity._assert_same_weights(state, jstate, before)
    else:
        image_parity._assert_same_weights(state, jstate, before, kind == "bootstrap")


def _trainer_run(kind, tmp_path):
    """A tiny run of ``kind``'s trainer with a vanilla phase before the
    introspective one; returns the steps it took."""
    if kind in ("image", "bootstrap"):
        boot = dict(bootstrap=True, gamma_r=1.0) if kind == "bootstrap" else {}
        data = np.random.default_rng(6).integers(0, 256, (8, 16, 16, 3), dtype=np.uint8)
        cfg = ImageConfig(dataset="cifar10", z_dim=Z, batch_size=B, num_epochs=3, num_vae=1,
                          beta_neg=16.0, seed=0, verbose=False, save_figures=True, test_iter=3,
                          result_dir=str(tmp_path / "run"), device="cpu", **boot)
        state, summary = train_soft_intro_vae(cfg, ArrayDataset(data, seed=1), SPEC)
        return summary["steps"]
    if kind == "3d":
        cfg = ThreeDConfig(n_points=64, batch_size=B, max_epochs=3, num_vae=2, z_size=Z, seed=0,
                           valid_frequency=2, save_frequency=10, use_synthetic=True,
                           synthetic_n=8, results_dir=str(tmp_path / "run"), verbose=False,
                           resume=False, device="cpu")
        state, _ = train_soft_intro_vae_3d(cfg)
        return state.step
    cfg = ToyConfig(z_dim=2, batch_size=B, n_iter=6, num_vae=2, n_layers=2, num_hidden=16,
                    test_iter=2, seed=0, beta_rec=0.2, beta_kl=0.3, beta_neg=0.9,
                    result_dir=str(tmp_path / "run"), verbose=False, device="cpu")
    state, _ = train_soft_intro_vae_toy(cfg)
    return state.step


@pytest.mark.parametrize("kind", KINDS)
def test_trainer_sends_every_step_through_the_wrapper_and_drops_vanilla(kind, tmp_path,
                                                                         monkeypatch):
    """Every step of the trainer goes through ``one_step``, and the vanilla
    wrapper (on the card: its graphs and their memory pool) is gone by the
    first introspective step."""
    calls, made, vanilla_alive = [], [], []

    def recording(step):
        wrapped = graph.one_step(step)

        def counted(state, x, *args):
            if step.__name__ == "intro_step" and not vanilla_alive:
                gc.collect()
                vanilla_alive.append([r() is not None for name, r in made if name == "vanilla_step"])
            calls.append(step.__name__)
            return wrapped(state, x, *args)

        made.append((step.__name__, weakref.ref(counted)))
        return counted

    monkeypatch.setattr(step_mod, "one_step", recording)
    steps = _trainer_run(kind, tmp_path)
    assert [name for name, _ in made] == ["vanilla_step", "intro_step"]
    assert len(calls) == steps > 0
    first_intro = calls.index("intro_step")
    assert first_intro > 0 and set(calls[:first_intro]) == {"vanilla_step"}
    assert set(calls[first_intro:]) == {"intro_step"}
    assert vanilla_alive == [[False]]


def test_a_graphs_key_tells_injected_draw_sets_apart():
    xs = torch.zeros((1, B, 2))
    z = torch.zeros((1, B, Z))
    keys = {
        "none": graph.step_key(xs),
        "empty": graph.step_key(xs, (), {}),
        "eps": graph.step_key(xs, (), {"eps": z}),
        "intro": graph.step_key(xs, (), {n: z for n in INTRO_NOISES}),
        "intro reversed": graph.step_key(xs, (), {n: z for n in reversed(INTRO_NOISES)}),
        "one draw": graph.step_key(xs, (), {"noise": z}),
        "wider": graph.step_key(xs, (), {"eps": torch.zeros((1, B, Z + 1))}),
        "float64": graph.step_key(xs, (), {"eps": z.double()}),
        "a scalar": graph.step_key(xs, ([0.5],), {"eps": z}),
        "another batch": graph.step_key(torch.zeros((1, B + 1, 2)), (), {"eps": z}),
    }
    assert keys["none"] == keys["empty"]  # no draws: the generator's
    assert keys["intro"] == keys["intro reversed"]  # by name, not by order
    distinct = [k for n, k in keys.items() if n not in ("empty", "intro reversed")]
    assert len(set(distinct)) == len(distinct)


def test_one_step_takes_draws_as_arrays_or_tensors_and_scalars_before_them():
    """The wrapper's eager route passes its arguments through as they are:
    numpy draws give the tensors' result, and the style-step form
    ``(state, x, blend, draws)`` keeps its order."""
    seen = []

    def probe_step(state, x, *args):
        seen.append(args)
        return state, {"m": torch.zeros(())}

    run = graph.one_step(probe_step)
    nz = {"eps": np.ones((B, Z), np.float32)}
    run(None, torch.zeros(B, 2), nz)
    run(None, torch.zeros(B, 2), 0.5, nz)
    run(None, torch.zeros(B, 2))
    assert [len(a) for a in seen] == [1, 2, 0]
    assert seen[0][0] is nz and seen[1][0] == 0.5 and seen[1][1] is nz
    tensors, _ = _run("3d", "intro", "wrapped", steps=1, draws=True)
    state, _, intro, xs, cfg = _build("3d")
    arrays = {k: v.numpy() for k, v in _draws("intro", cfg.z_size, 10).items()}
    state, m = intro(state, xs[0], arrays)
    _assert_runs_equal(tensors, (state, [m]))


# --- on the card -------------------------------------------------------------


@pytest.fixture
def exact(cuda_device):
    """TF32 off, cuDNN and PyTorch deterministic (the chamfer backward's
    scatter_add_ sums with atomics otherwise, so two eager 3D runs differ)."""
    saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32, torch.are_deterministic_algorithms_enabled())
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    yield cuda_device
    torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32 = saved[:2]
    torch.backends.cuda.matmul.allow_tf32 = saved[2]
    torch.use_deterministic_algorithms(saved[3])


@pytest.mark.cuda
@pytest.mark.parametrize("draws", [False, True], ids=["generator", "injected"])
@pytest.mark.parametrize("phase", PHASES)
@pytest.mark.parametrize("kind", KINDS)
def test_graphed_steps_equal_eager_steps_on_the_card(exact, kind, phase, draws):
    """6 steps: 3 eager warm-up steps, a capture, 3 replays; every tensor of
    the graphed run equals the eager run's."""
    graphed, wrapped = _run(kind, phase, "wrapped", "cuda", draws, steps=6)
    eager, _ = _run(kind, phase, "eager", "cuda", draws, steps=6)
    torch.cuda.synchronize()
    assert len(wrapped.graphed.graphs) == 1
    _assert_runs_equal(graphed, eager)


@pytest.mark.cuda
def test_a_bootstrap_sync_between_replays_reaches_the_graph(exact):
    """The target decoder's sync copies into the target's own tensors, which
    the captured steps read: a sync between replays gives the eager run's
    next steps, and the target's tensors equal the decoder's after it."""

    def sync(state, i):
        if i == 4:
            sync_target_decoder(state)

    runs = [_run("bootstrap", "intro", route, "cuda", steps=7, between=sync)[0]
            for route in ("wrapped", "eager")]
    torch.cuda.synchronize()
    _assert_runs_equal(*runs)
