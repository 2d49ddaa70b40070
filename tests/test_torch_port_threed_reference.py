"""Port: the 3D trainer's nets, loss and intro step against the benchmark's
plain reference (benchmark/reference/threed_ref.py), and the trainer's batch
selection (train/threed.py ``epoch_batches``).

Tiny sizes on the CPU: 64 points, PointNet widths (8, 16, 16, 16, 32), MLP
widths (8, 16, 32, 64), z 8, batch 4, the recipe's betas and prior, seeded
random weights given to both sides. The reference is independent of the
port: the published matrix-product chamfer (three ``bmm``s) where the port
takes differences, the published ``calc_kl`` form, autograd's backward of
the minima where the port has its own, torch's Adam written out.

Tolerances. Both sides compute in float32; their sums and products run in
other orders: the bmm chamfer loses digits to cancellation (up to 1e-6
relative at these sizes, the reference's docstring), the two KL forms
divide where the other multiplies. Values within 1e-5 relative (the losses
read 0 to 1e-7), gradients leaf by leaf within 1e-4 of the leaf's largest
entry (they read 1e-7 to 6e-7). Over two steps, Adam's second update turns
the rounding of a near-zero gradient coordinate into a step of up to its
learning rate, so each leaf's change within 1e-2 of that change (the leaves
read 1e-6 to 1.2e-3, the largest the encoder's FC). A step with the wrong
prior, loss or draw moves these numbers by 1e-2 to 1.
No test here runs the benchmark's harness: it declines to run in a process
that has loaded JAX, as these tests' workers have.
"""

import copy
import dataclasses
import math
import time

import numpy as np
import pytest
import torch

from benchmark.core import harness, weights
from benchmark.reference.common import Draws
from benchmark.reference.threed_ref import (
    ThreeDReference, batch_pairwise_dist, chamfer, init_rules, kl_narrow)
from soft_intro_vae_torch.data.shapenet import rotate_z
from soft_intro_vae_torch.ops.chamfer import chamfer_distance, pairwise_sqdist
from soft_intro_vae_torch.ops.losses import kl_divergence
from soft_intro_vae_torch.train.threed import ThreeDConfig, build_3d_training, epoch_batches
from soft_intro_vae_torch.utils import profiling
from tests.torch_port_fixtures import one_torch_thread  # noqa: F401

WEIGHT_SEED, DRAW_SEED = 2 ** 33 + 11, 2 ** 32 + 7
BATCH = 4


def tiny_cfg(prior_std: float = 0.2) -> dict:
    cfg = copy.deepcopy(harness.load_json(harness.HERE, "configs", "threed-hp.json"))
    cfg.update(n_points=64, z_size=8, prior_std=prior_std)
    cfg["model"].update(conv_channels=[8, 16, 16, 16, 32], hidden=[8, 16, 32, 64])
    return cfg


def port_config(cfg: dict) -> ThreeDConfig:
    return ThreeDConfig(n_points=cfg["n_points"], batch_size=BATCH, z_size=cfg["z_size"],
                        prior_std=cfg["prior_std"], beta_rec=cfg["beta_rec"],
                        beta_kl=cfg["beta_kl"], beta_neg=float(cfg["beta_neg"]),
                        gamma_r=cfg["gamma_r"], seed=0, verbose=False, resume=False,
                        device="cpu", conv_channels=tuple(cfg["model"]["conv_channels"]),
                        hidden=tuple(cfg["model"]["hidden"]))


def shared_weights(cfg: dict) -> dict:
    ref = ThreeDReference(cfg, "meta")
    shapes = {k: (tuple(t.shape), t.dtype)
              for k, t in list(ref.nets.named_parameters()) + list(ref.nets.named_buffers())}
    return weights.make(shapes, init_rules(ref.nets), WEIGHT_SEED, "cpu")


def both_sides(cfg: dict):
    """The port's state and intro step, and the reference, from one set of
    weights, their draws from one seed."""
    w = shared_weights(cfg)
    state, _, intro = build_3d_training(port_config(cfg))
    weights.load_into(state.model, w)
    state.generator.manual_seed(DRAW_SEED)
    ref = ThreeDReference(cfg, "cpu")
    ref.load(w)
    return state, intro, ref, Draws(DRAW_SEED, "cpu")


def clouds(n: int, seed: int, points: int = 64) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.rand(n, points, 3, generator=g) - 0.5


def rel(a, b) -> float:
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


# ---------------------------------------------------------------- chamfer --
@pytest.mark.parametrize("b,n,m", [(2, 64, 64), (3, 50, 70), (1, 128, 32)])
def test_published_chamfer_against_the_port(b, n, m):
    """Values within 1e-5 relative; the nearest points the same wherever the
    best and the second best differ by more than 1e-5 (near-ties may flip
    under the published form's cancellation)."""
    g = torch.Generator().manual_seed(b * 1000 + n + m)
    preds = 0.3 * torch.randn(b, m, 3, generator=g)
    gts = torch.rand(b, n, 3, generator=g) - 0.5
    ours = chamfer_distance(preds + 0.5, gts + 0.5, "plain")
    theirs = chamfer(preds + 0.5, gts + 0.5)
    torch.testing.assert_close(theirs, ours, rtol=1e-5, atol=0)
    exact = pairwise_sqdist((gts + 0.5).double(), (preds + 0.5).double())
    published = batch_pairwise_dist(gts + 0.5, preds + 0.5)
    port = pairwise_sqdist(gts + 0.5, preds + 0.5)
    for dim in (1, 2):
        two = exact.topk(2, dim=dim, largest=False).values
        clear = (two.select(dim, 1) - two.select(dim, 0)) > 1e-5
        assert clear.float().mean() > 0.9
        assert torch.equal(published.argmin(dim)[clear], port.argmin(dim)[clear])


def test_narrow_prior_kl():
    """The port's general-prior KL at logvar_o = log 0.2^2 against the
    published form and the closed form in float64."""
    g = torch.Generator().manual_seed(5)
    mu, logvar = 0.3 * torch.randn(6, 8, generator=g), 0.5 * torch.randn(6, 8, generator=g)
    lo = math.log(0.2 ** 2)
    port = kl_divergence(mu, logvar, logvar_o=lo, reduce="none")
    published = kl_narrow(mu, logvar, lo)
    m, lv = mu.double(), logvar.double()
    exact = 0.5 * (lv.exp() / 0.04 + m * m / 0.04 - 1.0 - (lv - lo)).sum(1)
    torch.testing.assert_close(published.double(), exact, rtol=1e-5, atol=0)
    torch.testing.assert_close(port.double(), exact, rtol=1e-5, atol=0)


def test_fake_draw_is_the_prior_std_times_the_first_draw():
    """The intro step's first decode is of z = 0.2 eps, eps the generator's
    first draw, on both sides."""
    cfg = tiny_cfg()
    state, intro, ref, draws = both_sides(cfg)
    seen = {"port": [], "ref": []}
    state.decoder.register_forward_pre_hook(lambda m, a: seen["port"].append(a[0].clone()))
    ref.nets.decoder.register_forward_pre_hook(lambda m, a: seen["ref"].append(a[0].clone()))
    x = clouds(BATCH, 1)
    intro(state, x)
    ref.step(x, draws)
    first = torch.randn((BATCH, cfg["z_size"]), generator=torch.Generator().manual_seed(DRAW_SEED))
    assert torch.equal(seen["port"][0], 0.2 * first)
    assert torch.equal(seen["ref"][0], 0.2 * first)


# ------------------------------------------------------------------- nets --
@pytest.mark.parametrize("net", ["encoder", "decoder"])
def test_nets_forward(net):
    """The port's PointNet encoder (train-mode BN) and MLP decoder against
    the reference's, one set of weights: within 1e-5 relative."""
    cfg = tiny_cfg()
    state, _, ref, _ = both_sides(cfg)
    p = ref.prec
    if net == "encoder":
        x = clouds(BATCH, 2)
        ours, theirs = state.encoder(x), ref.nets.encoder(x, p)
    else:
        z = torch.randn(BATCH, cfg["z_size"], generator=torch.Generator().manual_seed(3))
        ours, theirs = (state.decoder(z),), (ref.nets.decoder(z, p),)
    for a, b in zip(ours, theirs):
        assert a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------------- step --
def first_step():
    cfg = tiny_cfg()
    state, intro, ref, draws = both_sides(cfg)
    x = clouds(BATCH, 4)
    _, mets = intro(state, x)
    res = ref.step(x, draws)
    grads = {k: p.grad for k, p in state.model.named_parameters()}
    return mets, res, grads


@pytest.mark.parametrize("what", ["loss_e", "loss_d", "grads_e", "grads_d"])
def test_one_eager_intro_step(what):
    """One step from the same weights and draws: each loss within 1e-5
    relative; the E phase's gradients (the encoder's, left on its leaves) and
    the D phase's (the decoder's) leaf by leaf within 1e-4 of the leaf's
    largest entry."""
    mets, res, grads = first_step()
    if what.startswith("loss"):
        assert rel(mets[what], res[what]) < 1e-5, (float(mets[what]), float(res[what]))
        return
    prefix = "encoder." if what == "grads_e" else "decoder."
    leaves = [k for k in grads if k.startswith(prefix)]
    assert leaves
    for k in leaves:
        ours, theirs = grads[k], res["grads"][k]
        assert ours is not None and theirs is not None, k
        scale = float(theirs.abs().max())
        assert scale > 0, k
        assert float((ours - theirs).abs().max()) <= 1e-4 * scale, k


@pytest.mark.parametrize("what", ["parameters", "bn_buffers"])
def test_two_steps_change_the_same_leaves_alike(what):
    """Two steps from the same weights: each parameter's change within 1e-2
    of that change (module doc); the BN running statistics within 1e-5 of
    their largest entry and the batch counts equal (five encoder passes a
    step)."""
    cfg = tiny_cfg()
    state, intro, ref, draws = both_sides(cfg)
    before = {k: t.clone() for k, t in state.model.state_dict().items()}
    for i in (5, 6):
        x = clouds(BATCH, i)
        intro(state, x)
        ref.step(x, draws)
    ours = state.model.state_dict()
    theirs = dict(ref.nets.named_parameters())
    theirs.update(ref.nets.named_buffers())
    if what == "parameters":
        names = [k for k, _ in state.model.named_parameters()]
        for k in names:
            moved = float((theirs[k] - before[k]).detach().norm())
            gap = float((ours[k] - theirs[k]).detach().norm())
            assert moved > 0 and gap <= 1e-2 * moved, (k, gap, moved)
        return
    for k, t in ours.items():
        if "running_" in k:
            torch.testing.assert_close(t, theirs[k], rtol=0, atol=1e-5 * float(t.abs().max()))
        elif k.endswith("num_batches_tracked"):
            assert int(t) == int(theirs[k]) == 10, k


# --------------------------------------------------------------- batches --
def inline_batches(train_pts, train_dev, epoch, data_seed, bs, mine, rotate):
    """The trainer's batch selection as it was written inline in its loop."""
    n = train_pts.shape[0]
    data_rng = np.random.default_rng((data_seed, epoch))
    idx = data_rng.permutation(n)
    idx_dev = torch.from_numpy(idx)
    for i in range(0, n - bs + 1, bs):
        if rotate:
            angles = data_rng.random(bs) * 180.0
            yield torch.from_numpy(rotate_z(train_pts[idx[i: i + bs][mine]], angles[mine]))
        else:
            yield train_dev[idx_dev[i: i + bs][mine]]


@pytest.mark.parametrize("rows,rotate", [(slice(None), False), (slice(4, 8), False),
                                         (slice(0, 4), True)],
                         ids=["whole", "rank_1_of_2", "rotated"])
def test_epoch_batches_are_the_inline_loops(rows, rotate):
    """For a seed and two epochs (42 clouds: each epoch's last, partial batch
    dropped), the same batches, bit for bit, as the loop it replaces: this rank's rows
    and the rotation's angles included."""
    pts = clouds(42, 8, points=16).numpy()
    dev = torch.from_numpy(pts.copy())
    for epoch in (1, 2):
        ours = list(epoch_batches(pts, dev, epoch, data_seed=9, batch_size=8, rows=rows,
                                  rotate=rotate))
        theirs = list(inline_batches(pts, dev, epoch, 9, 8, rows, rotate))
        assert len(ours) == len(theirs) == 5
        for a, b in zip(ours, theirs):
            assert torch.equal(a, b)


def test_the_trainer_records_a_gather_span_a_step(tmp_path):
    """One ``feed.gather`` span a step, numbered by the batch's place in its
    epoch, with no span inside it."""
    cfg = tiny_cfg()
    tcfg = dataclasses.replace(port_config(cfg), max_epochs=2, use_synthetic=True,
                               synthetic_n=12, valid_frequency=5, save_frequency=5,
                               results_dir=str(tmp_path / "run"))
    from soft_intro_vae_torch.train.threed import train_soft_intro_vae_3d

    t0 = time.perf_counter_ns()
    state, _ = train_soft_intro_vae_3d(tcfg)
    got = [s for s in profiling.spans(t0) if s.name == "feed.gather"]
    assert state.step == 6
    assert [s.batch for s in got] == [0, 1, 2, 0, 1, 2]
    assert all(s.dur_ns > 0 and s.child_ns == 0 for s in got)


def test_matmul_precision_sets_tf32():
    """The 3D trainer's ``matmul_precision``, as the image trainer's: None
    leaves PyTorch's settings, "float32" turns TF32 off for cuDNN and cuBLAS,
    anything else raises."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    base = port_config(tiny_cfg())
    try:
        torch.backends.cudnn.allow_tf32 = True
        build_3d_training(dataclasses.replace(base, matmul_precision=None))
        assert torch.backends.cudnn.allow_tf32
        build_3d_training(dataclasses.replace(base, matmul_precision="float32"))
        assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
        with pytest.raises(ValueError, match="matmul_precision"):
            build_3d_training(dataclasses.replace(base, matmul_precision="bf16"))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
