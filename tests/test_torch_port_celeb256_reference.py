"""Port: the image trainer at the celeb256 schedule against the benchmark's
plain reference (benchmark/reference/image_ref.py), the trainer's host
batches (train/image.py ``host_batches``), and the out-of-core folder's
decode span and counters (data/images.py ``FolderDataset``).

Six stages at a small size on the CPU: 128x128 images (a 2x2 last plane),
channels (8, 16, 32, 64, 64, 64), z 16, batch 2, the celeb256 recipe's betas
(beta_kl 0.5, beta_neg 1024), seeded random weights given to both sides, the
same seven latent draws, float32 with TF32 off. The reference is independent
of the port: NCHW where the port runs channels-last, ``F.batch_norm`` where
the port routes its own, torch's Adam written out.

Tolerances. Both sides compute in float32; their convolutions and
reductions run in other orders (channels-last against NCHW kernels), so they
agree to rounding, which this size amplifies: at batch 2 the last stages'
BN normalizes over 8 values a channel, so the step is ill-conditioned (the
reference against itself with its weights moved by one float32 rounding,
relative 1.2e-7, reads gradient gaps up to 5.6e-3 of a leaf's largest
entry). The nets' outputs within 1e-4 of their largest entry (they read up
to 9e-6); the losses within 1e-5 relative (up to 9e-7); the gradients, leaf
by leaf, within 2e-2 of the leaf's largest entry (up to 3.0e-3). Over two
steps, Adam's sign-like first updates turn those gaps into steps of a whole
learning rate where a coordinate's gradient is near zero, so the median
leaf's change within 0.1 of that change (it reads 0.023; single leaves up
to 0.31, so each leaf is only held to have moved, by less than 1, which a
leaf left as it was reads); the BN running statistics within 1e-2 of their
largest entry (up to 1.9e-3). The reference with its conv path rounded to
bfloat16 reads the losses 4e-5 to 1.2e-4 and the gradients 0.6-0.75 apart,
missing those tolerances by 4-40x (a test below holds that), the median
change 0.41 and the BN statistics 3.8e-2 apart.
No test here runs the benchmark's harness: it declines to run in a process
that has loaded JAX, as these tests' workers have.
"""

import copy
import dataclasses
import os
import statistics
import time

import numpy as np
import pytest
import torch

from benchmark.core import harness, weights
from benchmark.reference.common import Draws, Precision
from benchmark.reference.image_ref import ImageReference, init_rules
from soft_intro_vae_torch.data import images
from soft_intro_vae_torch.data.images import ArrayDataset, ImageSpec, augment_mirror
from soft_intro_vae_torch.train.image import (
    ImageConfig, build_image_training, host_batches, train_soft_intro_vae)
from soft_intro_vae_torch.utils import profiling
from tests.torch_port_fixtures import one_torch_thread  # noqa: F401

WEIGHT_SEED, DRAW_SEED = 2 ** 33 + 29, 2 ** 32 + 29
BATCH = 2
CHANNELS = [8, 16, 32, 64, 64, 64]


def tiny_cfg() -> dict:
    cfg = copy.deepcopy(harness.load_json(harness.HERE, "configs", "image-celeb256.json"))
    cfg["model"].update(image_size=128, channels=CHANNELS, z_dim=16)
    return cfg


def port_config(cfg: dict) -> ImageConfig:
    m, t = cfg["model"], cfg["train"]
    return ImageConfig(dataset=m["dataset"], z_dim=m["z_dim"], lr_e=t["lr_e"], lr_d=t["lr_d"],
                       batch_size=BATCH, beta_kl=t["beta_kl"], beta_rec=t["beta_rec"],
                       beta_neg=t["beta_neg"], gamma_r=t["gamma_r"], seed=0,
                       matmul_precision=t["matmul_precision"], verbose=False, device="cpu")


def spec_of(cfg: dict) -> ImageSpec:
    m = cfg["model"]
    return ImageSpec(m["dataset"], m["image_size"], tuple(m["channels"]), m["cdim"])


def shared_weights(cfg: dict) -> dict:
    ref = ImageReference(cfg, "meta")
    shapes = {k: (tuple(t.shape), t.dtype)
              for k, t in list(ref.nets.named_parameters()) + list(ref.nets.named_buffers())}
    return weights.make(shapes, init_rules(ref.nets), WEIGHT_SEED, "cpu")


def both_sides(cfg: dict, prec: Precision = Precision()):
    """The port's state and intro step, and the reference, from one set of
    weights, their draws from one seed."""
    w = shared_weights(cfg)
    state, _, intro = build_image_training(port_config(cfg), spec_of(cfg))
    weights.load_into(state.model, w)
    state.generator.manual_seed(DRAW_SEED)
    ref = ImageReference(cfg, "cpu", prec)
    ref.load(w)
    return state, intro, ref, Draws(DRAW_SEED, "cpu")


def pictures(n: int, seed: int, side: int = 128) -> torch.Tensor:
    """(n, side, side, 3) uint8 NHWC."""
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (n, side, side, 3), generator=g, dtype=torch.uint8)


def rel(a, b) -> float:
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


# ------------------------------------------------------------------- nets --
def test_the_six_stage_schedule_ends_in_a_2x2_plane():
    nets = ImageReference(tiny_cfg(), "meta").nets
    assert nets.decoder.shape == (64, 2, 2)
    assert nets.encoder.fc.weight.shape == (2 * 16, 64 * 2 * 2)
    assert [k for k in dict(nets.encoder.main.named_children()) if k.startswith("res_in")] == \
        ["res_in_64", "res_in_32", "res_in_16", "res_in_8", "res_in_4", "res_in_2"]


@pytest.mark.parametrize("net", ["encoder", "decoder"])
def test_nets_forward(net):
    """The port's encoder (train-mode BN) and decoder against the
    reference's, one set of weights: within 1e-4 of the largest entry."""
    cfg = tiny_cfg()
    state, _, ref, _ = both_sides(cfg)
    p = ref.prec
    with torch.no_grad():
        if net == "encoder":
            x = pictures(BATCH, 2).float().div(255.0).permute(0, 3, 1, 2)
            ours = state.encoder(x.contiguous(memory_format=torch.channels_last))
            theirs = ref.nets.encoder(x.contiguous(), p)
        else:
            z = torch.randn(BATCH, 16, generator=torch.Generator().manual_seed(3))
            ours, theirs = (state.decoder(z),), (ref.nets.decoder(z, p),)
    for a, b in zip(ours, theirs):
        assert a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4 * float(b.abs().max()))


# ------------------------------------------------------------------- step --
def first_step(prec: Precision = Precision()):
    cfg = tiny_cfg()
    state, intro, ref, draws = both_sides(cfg, prec)
    x = pictures(BATCH, 4)
    _, mets = intro(state, x)
    with prec.context():
        res = ref.step(x, draws)
    grads = {k: p.grad for k, p in state.model.named_parameters()}
    return mets, res, grads


def step_gaps(mets, res, grads) -> dict:
    """The first step's loss gaps (relative) and each phase's widest leaf gap
    of its gradient (over the leaf's largest entry)."""
    out = {k: rel(mets[k], res[k]) for k in ("loss_e", "loss_d")}
    for what, prefix in (("grads_e", "encoder."), ("grads_d", "decoder.")):
        worst = 0.0
        for k in [k for k in grads if k.startswith(prefix)]:
            ours, theirs = grads[k], res["grads"][k]
            assert ours is not None and theirs is not None, k
            scale = float(theirs.abs().max())
            assert scale > 0, k
            worst = max(worst, float((ours - theirs).abs().max()) / scale)
        out[what] = worst
    return out


TOLERANCE = {"loss_e": 1e-5, "loss_d": 1e-5, "grads_e": 2e-2, "grads_d": 2e-2}


@pytest.mark.parametrize("what", list(TOLERANCE))
def test_one_eager_intro_step(what):
    """One step from the same weights, batch and draws: each loss within 1e-5
    relative; the E phase's gradients (the encoder's, left on its leaves) and
    the D phase's (the decoder's) leaf by leaf within 2e-2 of the leaf's
    largest entry (module doc)."""
    gaps = step_gaps(*first_step())
    assert gaps[what] < TOLERANCE[what], gaps


def test_the_reference_in_bfloat16_misses_the_tolerances():
    """The reference with its conv path rounded to bfloat16 (the control the
    benchmark's calibration runs) against the port in float32: at least one
    of the step's tolerances fails, so they hold the port to float32."""
    gaps = step_gaps(*first_step(Precision("bf16")))
    missed = [k for k, tol in TOLERANCE.items() if gaps[k] >= tol]
    assert missed, gaps


@pytest.mark.parametrize("what", ["parameters", "bn_buffers"])
def test_two_steps_change_the_same_leaves_alike(what):
    """Two steps from the same weights: the median leaf's change within 0.1
    of that change, and every leaf moved on both sides (module doc); the BN
    running statistics within 1e-2 of their largest entry and the batch
    counts equal."""
    cfg = tiny_cfg()
    state, intro, ref, draws = both_sides(cfg)
    before = {k: t.clone() for k, t in state.model.state_dict().items()}
    with Precision().context():
        for i in (5, 6):
            x = pictures(BATCH, i)
            intro(state, x)
            ref.step(x, draws)
    ours = state.model.state_dict()
    theirs = dict(ref.nets.named_parameters())
    theirs.update(ref.nets.named_buffers())
    if what == "parameters":
        gaps = []
        for k, _ in state.model.named_parameters():
            moved = float((theirs[k] - before[k]).detach().norm())
            gap = float((ours[k] - theirs[k]).detach().norm())
            assert moved > 0 and gap < moved, (k, gap, moved)
            gaps.append(gap / moved)
        assert statistics.median(gaps) < 0.1, sorted(gaps)[-4:]
        return
    counts = set()
    for k, t in ours.items():
        if "running_" in k:
            torch.testing.assert_close(t, theirs[k], rtol=0, atol=1e-2 * float(t.abs().max()))
        elif k.endswith("num_batches_tracked"):
            assert int(t) == int(theirs[k]), k
            counts.add(int(t))
    assert len(counts) == 2  # the encoder's and the decoder's BN layers count apart


# --------------------------------------------------------------- batches --
def inline_batches(dataset, cfg: ImageConfig, epoch: int, mine):
    """The trainer's host batches as they were written inline in its loop."""
    aug_seed = max(cfg.seed, 0) + 1
    aug_rng = np.random.default_rng((aug_seed, epoch))
    for batch in dataset.epoch(cfg.batch_size, drop_last=True, epoch_index=epoch, rows=mine):
        yield (augment_mirror(batch, aug_rng, mine, cfg.batch_size) if cfg.mirror_augment
               else batch)


@pytest.mark.parametrize("rows,mirror", [(slice(None), False), (slice(None), True),
                                         (slice(4, 8), True), (slice(0, 4), False)],
                         ids=["whole", "whole_mirrored", "rank_1_of_2_mirrored", "rank_0_of_2"])
def test_host_batches_are_the_inline_loops(rows, mirror):
    """For a seed and two epochs (42 images: each epoch's last, partial batch
    dropped), the same batches, bit for bit, as the loop it replaces: this
    rank's rows and the mirror's flips included."""
    data = np.random.default_rng(8).integers(0, 256, (42, 6, 6, 3), dtype=np.uint8)
    cfg = ImageConfig(batch_size=8, seed=9, mirror_augment=mirror, device="cpu")
    flipped = 0
    for epoch in (0, 1):
        ours = list(host_batches(ArrayDataset(data, seed=9), cfg, epoch, rows))
        theirs = list(inline_batches(ArrayDataset(data, seed=9), cfg, epoch, rows))
        assert len(ours) == len(theirs) == 5
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a, b)
            flipped += sum(not any(np.array_equal(r, d) for d in data) for r in a)
    assert (flipped > 0) == mirror


# ----------------------------------------------------------------- folder --
def jpeg_folder(root, n: int, side: int = 16) -> list:
    from PIL import Image

    rng = np.random.default_rng(21)
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (side, side, 3), dtype=np.uint8)).save(
            os.path.join(root, f"{i:03d}.jpg"), quality=95)
    return sorted(os.path.join(root, f) for f in os.listdir(root))


def test_the_trainer_records_a_decode_span_a_batch(tmp_path, monkeypatch):
    """The image trainer over a tiny JPEG folder that streams (the residency
    bound set to 0): one ``feed.decode`` span a batch, numbered by the
    batch's place in its epoch, with no span inside it; the folder's
    counters hold every decoded image and its file's bytes."""
    monkeypatch.setenv("SIV_MAX_RESIDENT_BYTES", "0")
    files = jpeg_folder(str(tmp_path / "celeb256"), 10)
    monkeypatch.setitem(images.DATASETS, "celeb256", ImageSpec("celeb256", 16, (8, 16), 3))
    spec, dataset = images.make_dataset("celeb256", str(tmp_path), storage="uint8",
                                        synthetic_fallback=False)
    assert isinstance(dataset, images.FolderDataset)
    cfg = ImageConfig(dataset="celeb256", z_dim=8, batch_size=4, num_epochs=2, num_vae=1,
                      seed=0, mirror_augment=True, verbose=False, device="cpu",
                      result_dir=str(tmp_path / "run"))
    t0 = time.perf_counter_ns()
    state, summary = train_soft_intro_vae(cfg, dataset=dataset, spec=spec)
    got = [s for s in profiling.spans(t0) if s.name == "feed.decode"]
    assert summary["steps"] == 4
    assert [s.batch for s in got] == [0, 1, 0, 1]
    assert all(s.dur_ns > 0 and s.child_ns == 0 for s in got)
    assert dataset.decoded_images == 16
    # each epoch decodes the 8 files of its permutation's first two batches
    sizes = {os.path.getsize(f) for f in files}
    assert min(sizes) * 16 <= dataset.decoded_bytes <= max(sizes) * 16


def test_folder_counters_count_a_ranks_rows(tmp_path, monkeypatch):
    """With ``rows``, only this rank's files are decoded and counted."""
    monkeypatch.setenv("SIV_MAX_RESIDENT_BYTES", "0")
    files = jpeg_folder(str(tmp_path), 6)
    ds = images.open_image_folder(str(tmp_path), 16, storage="uint8")
    assert isinstance(ds, images.FolderDataset)
    batches = list(ds.epoch(4, drop_last=True, epoch_index=0, rows=slice(0, 2)))
    assert len(batches) == 1 and batches[0].shape == (2, 16, 16, 3)
    perm = np.random.default_rng((0, 0)).permutation(6)
    assert ds.decoded_images == 2
    assert ds.decoded_bytes == sum(os.path.getsize(files[i]) for i in perm[:2])


def test_the_trainer_builds_the_celeb256_recipe_widths():
    """The registry's celeb256 is the configuration's: 256x256x3, six stages."""
    cfg = harness.load_json(harness.HERE, "configs", "image-celeb256.json")
    assert images.DATASETS["celeb256"] == spec_of(cfg)
    t = cfg["train"]
    assert (t["batch_size"], t["beta_kl"], t["beta_rec"], t["beta_neg"], t["lr_e"]) == \
        (8, 0.5, 1.0, 1024.0, 2e-4)
    assert dataclasses.replace(port_config(cfg), mirror_augment=t["mirror_augment"]).mirror_augment
