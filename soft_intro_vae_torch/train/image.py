"""Image trainer: the CIFAR/CelebA Soft-IntroVAE recipe and its bootstrap
variant (port of soft_intro_vae_tpu/train/image.py).

Reference: train_soft_intro_vae (soft_intro_vae/train_soft_intro_vae.py:
337-702) and its bootstrap sibling: epoch loop, vanilla warm-up, two-phase
introspective step, MultiStepLR((350,), 0.1) per epoch (:453-454), per-pixel
loss scale (:456), exit_on_negative_diff (:652-657), NaN abort (:625-626),
checkpoints under the reference's file names (:491-495), the bootstrap
target-decoder sync (bootstrap:680-682).

Batches come from the dataset as NHWC host arrays, uint8 by default, and go
to the device through ``data/prefetch.py`` (pinned buffers, a side stream);
the step normalizes a uint8 batch with one launch of the u8norm kernel. The
trainer always gives the step the canonical table, so a uint8 dataset is
normalized whatever ``host_storage`` says (the JAX trainer keys the table on
``host_storage`` and would train a caller's uint8 dataset on 0..255 pixels
when it says "float32"). Step metrics stay on the device and are fetched
once per epoch and every ``nan_check_iter`` steps.

``with_fid`` scores the decoder by FID (metrics/fid.py) at the top of epoch
0, of every 20th epoch from 100, and of the last, as the JAX trainer does
(train/image.py:274-310), over ``min(fid_num_images, len(dataset))`` real
images and as many samples in batches of up to 64, and keeps the
best-scoring state as a tagged checkpoint. Without the pt_inception weights
on disk the metric is ``fid_selfconsistent``. Between K-step calls the FID
reads the decoder in eval mode and draws its noise from a generator of its
own, so the captured graph and its generator are left as they were.

On the card every step is a replay of a CUDA graph of one step
(train/graph.py), the counterpart of the JAX trainer's jitted step: at
``scan_steps`` 1 one replay a batch; with ``scan_steps`` K > 1, K host
batches go to the device as one (K, B, H, W, C) transfer, the last chunk of
an epoch shorter where the batches run out, and one K-step call replays the
graph once a batch of the chunk. On the CPU the steps run eagerly. The work
between steps (figures, NaN checks, FID, saves, the bootstrap target's sync,
a copy into the target's own tensors) leaves the graphs as they are. The
vanilla step, and its graphs with their memory pool, are dropped at the
switch to the introspective step.

``remat`` checkpoints every encoder, decoder and target-decoder forward of
the steps (train/step.py, models/remat.py): bit-equal to the plain steps,
for less device memory and more compute. The interval checkpoints are saved
asynchronously from a host copy of the state taken before the graph replays
again (utils/checkpoint.py); the final save waits for them.

Data parallelism (parallel/): in a process group of N ranks (one a card,
``python -m torch.distributed.run --nproc_per_node N``), ``batch_size`` is
the global batch: every rank draws the same epoch permutation and takes its
rows of each batch, the states start as rank 0's, the steps reduce their
gradients, BN statistics and metrics, and rank 0 alone writes checkpoints,
logs and figures and scores FID while the others wait. ``num_devices``, when
set, must be the world size.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional, Tuple

import numpy as np
import torch

from soft_intro_vae_torch.data.images import (
    ImageSpec, SyntheticImages, augment_mirror, make_dataset, to_unit_float)
from soft_intro_vae_torch.data.prefetch import device_prefetch, device_put_fn
from soft_intro_vae_torch.models.conv import SoftIntroVAE
from soft_intro_vae_torch.parallel.mesh import (
    current_world, host_local_batch_size, shard_state, unsharded)
from soft_intro_vae_torch.parallel.multihost import check_world, is_primary, on_primary
from soft_intro_vae_torch.train import optim
from soft_intro_vae_torch.train.state import TrainState
from soft_intro_vae_torch.train.step import UNIT_LUT, StepConfig, build_train_steps
from soft_intro_vae_torch.train.threed import _epoch_means
from soft_intro_vae_torch.utils.checkpoint import Checkpointer, load_pretrained
from soft_intro_vae_torch.utils.device import resolve_device
from soft_intro_vae_torch.utils.tracker import LossTracker

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class ImageConfig:
    """Mirrors the reference trainer kwargs (train_soft_intro_vae.py:337-341);
    the fields of the JAX package's ImageConfig, plus ``device`` and
    ``u8norm_impl``."""

    dataset: str = "cifar10"
    z_dim: int = 128
    lr_e: float = 2e-4
    lr_d: float = 2e-4
    batch_size: int = 128
    num_epochs: int = 250
    num_vae: int = 0
    save_interval: int = 50
    recon_loss_type: str = "mse"
    beta_kl: float = 1.0
    beta_rec: float = 1.0
    beta_neg: float = 1.0
    gamma_r: float = 1e-8
    test_iter: int = 1000
    seed: int = -1
    start_epoch: int = 0
    exit_on_negative_diff: bool = False
    with_fid: bool = False
    fid_num_images: int = 50000
    pretrained: Optional[str] = None  # a port checkpoint or a reference .pth
    data_root: str = "./data"
    result_dir: str = "./results_image"
    bootstrap: bool = False          # bootstrap variant (target decoder)
    copy_to_target_freq: int = 1     # bootstrap weight-sync cadence, epochs
    mirror_augment: bool = False
    save_figures: bool = False
    num_row: int = 8
    num_devices: Optional[int] = None
    compute_dtype: str = "float32"   # or "bfloat16"
    # None keeps PyTorch's defaults (cuDNN convolutions in TF32, matmuls in
    # float32); "float32" turns TF32 off for cuDNN and cuBLAS, the counterpart
    # of the JAX field's full-precision matmuls; "tensorfloat32" turns it on
    matmul_precision: Optional[str] = None
    remat: bool = False
    scan_steps: int = 1
    synthetic_fallback: bool = True
    synthetic_n: int = 2048
    # sub-epoch NaN abort cadence: every N steps the last step's metrics are
    # fetched (one small sync) and a nonfinite one aborts; 0 disables
    nan_check_iter: int = 200
    # host-side pixel storage of the dataset the trainer builds: "uint8"
    # (source bytes, normalized on the device) or "float32" (on the host)
    host_storage: str = "uint8"
    verbose: bool = True
    device: str = "cuda"             # port: where the nets and the batches live
    u8norm_impl: str = "auto"        # port: auto | plain | cuda (ops/u8norm.py)


def _check_supported(cfg: ImageConfig) -> None:
    check_world(cfg.num_devices, cfg.batch_size)
    if cfg.compute_dtype not in DTYPES:
        raise ValueError(f"compute_dtype must be one of {list(DTYPES)}, got {cfg.compute_dtype!r}")


def _set_matmul_precision(precision: Optional[str]) -> None:
    if precision is None:
        return
    if precision not in ("float32", "tensorfloat32"):
        raise ValueError(f"matmul_precision must be None, 'float32' or 'tensorfloat32', "
                         f"got {precision!r}")
    tf32 = precision == "tensorfloat32"
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32


def build_image_models(spec: ImageSpec, cfg: ImageConfig) -> SoftIntroVAE:
    """The encoder/decoder pair (and the target decoder when bootstrapping)."""
    return SoftIntroVAE(cdim=spec.cdim, zdim=cfg.z_dim, channels=spec.channels,
                        image_size=spec.image_size, compute_dtype=DTYPES[cfg.compute_dtype],
                        bootstrap=cfg.bootstrap)


def build_image_training(cfg: ImageConfig, spec: ImageSpec):
    """Returns ``(state, vanilla_step, intro_step)`` on ``cfg.device``; the
    steps take NHWC batches, uint8 or float."""
    _check_supported(cfg)
    device = resolve_device(cfg.device)
    _set_matmul_precision(cfg.matmul_precision)
    seed = cfg.seed if cfg.seed != -1 else int(time.time()) % (2**31)
    # the nets are made from the seed without touching the global RNG
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = build_image_models(spec, cfg)
    state = TrainState.create(model, device=device, seed=seed + 1, lr_e=cfg.lr_e, lr_d=cfg.lr_d)
    step_cfg = StepConfig(z_dim=cfg.z_dim, beta_rec=cfg.beta_rec, beta_kl=cfg.beta_kl,
                          beta_neg=cfg.beta_neg, gamma_r=cfg.gamma_r, scale=spec.scale,
                          loss_type=cfg.recon_loss_type, bootstrap=cfg.bootstrap,
                          u8norm_impl=cfg.u8norm_impl)
    vanilla_step, intro_step = build_train_steps(cfg=step_cfg, scan_steps=cfg.scan_steps,
                                                 input_lut=UNIT_LUT, nhwc=True, remat=cfg.remat)
    return shard_state(state), vanilla_step, intro_step


def fires(cur_iter: int, k: int, every: int) -> bool:
    """Whether a multiple of ``every`` lies in [cur_iter, cur_iter + k): the
    JAX trainer's cadence of figures and NaN checks under K-step calls
    (train/image.py:346-353); at k = 1 it is ``cur_iter % every == 0``."""
    return (cur_iter + k - 1) // every != (cur_iter - 1) // every


@torch.no_grad()
def sync_target_decoder(state: TrainState) -> TrainState:
    """Bootstrap weight sync, target <- online (bootstrap:680-682): a copy of
    the decoder's parameters and BN buffers into the target's own tensors,
    which share no storage with the decoder's."""
    state.target_decoder.load_state_dict(state.decoder.state_dict())
    return state


@torch.no_grad()
def _save_sample_grid(state: TrainState, batch: torch.Tensor, cfg: ImageConfig, cur_iter: int):
    """[real | deterministic rec | sample] grid every test_iter
    (train_soft_intro_vae.py:641-646), the nets in eval mode."""
    from soft_intro_vae_torch.utils.plotting import save_image_grid

    n = min(batch.shape[0], 16)
    real = to_unit_float(batch[:n].cpu().numpy())  # normalized on the host
    x = torch.from_numpy(np.ascontiguousarray(real.transpose(0, 3, 1, 2))).to(state.device)
    state.model.eval()
    try:
        mu, _ = state.encoder(x)
        rec = state.decoder(mu)
        gen = torch.Generator(device=state.device)
        gen.manual_seed(state.generator.initial_seed() + 2**20 + cur_iter)
        fake = state.decoder(torch.randn((n, mu.shape[1]), generator=gen, device=state.device))
    finally:
        state.model.train()
    grid = np.concatenate([real] + [t.permute(0, 2, 3, 1).cpu().numpy() for t in (rec, fake)])
    fig_dir = os.path.join(cfg.result_dir, f"figures_{cfg.dataset}")
    save_image_grid(grid, os.path.join(fig_dir, f"image_{cur_iter}.jpg"), nrow=cfg.num_row)


def train_soft_intro_vae(cfg: ImageConfig, dataset=None,
                         spec: Optional[ImageSpec] = None) -> Tuple[TrainState, dict]:
    """Run the image recipe; returns (state, summary)."""
    _check_supported(cfg)
    resolve_device(cfg.device)  # fail before loading the data, not after
    if dataset is None or spec is None:
        spec, dataset = make_dataset(cfg.dataset, cfg.data_root, seed=max(cfg.seed, 0),
                                     synthetic_fallback=cfg.synthetic_fallback,
                                     synthetic_n=cfg.synthetic_n, storage=cfg.host_storage)
    if isinstance(dataset, SyntheticImages) and is_primary():
        print("!" * 72)
        print(f"! WARNING: no local {cfg.dataset!r} data found — training on "
              f"SYNTHETIC images.\n! Metrics below are NOT {cfg.dataset} "
              "results. Use --no-synthetic-fallback to fail instead.")
        print("!" * 72)
    state, vanilla_step, intro_step = build_image_training(cfg, spec)
    if cfg.bootstrap:
        sync_target_decoder(state)  # the target starts equal to the online decoder

    ckpt = Checkpointer(os.path.join(cfg.result_dir, "saves"),
                        prefix=f"{cfg.dataset}_soft_intro_betas_{cfg.beta_kl}_{cfg.beta_neg}_{cfg.beta_rec}_")
    tracker = LossTracker(cfg.result_dir)
    if cfg.pretrained:
        load_pretrained(cfg.pretrained, state)  # every rank reads it
        shard_state(state)
    world = current_world()  # checked by _check_supported
    mine = world.rows(host_local_batch_size(cfg.batch_size, world))
    verbose = cfg.verbose and is_primary()
    lr_e_sched = optim.multistep_lr(cfg.lr_e, (350,), 0.1)
    lr_d_sched = optim.multistep_lr(cfg.lr_d, (350,), 0.1)
    aug_seed = max(cfg.seed, 0) + 1  # per-epoch reseeded: a resumed run replays its draws
    put_fn = device_put_fn(state.device)

    fid_fn = None
    fid_name = "fid"
    if cfg.with_fid:
        from soft_intro_vae_torch.metrics.fid import fid_weights_path, make_training_fid

        fid_fn = make_training_fid(cfg) if is_primary() else None  # rank 0 scores
        if fid_weights_path() is None:
            # random-init Inception: self-consistent ordering, NOT comparable
            # to published FID (the reference loads the pt_inception weights,
            # metrics/inception.py:17,184-206)
            fid_name = "fid_selfconsistent"
            if is_primary():
                print("!" * 72)
                print("! WARNING: pt_inception weights not found — FID uses a "
                      "RANDOM-INIT Inception.\n! The metric is logged as "
                      "'fid_selfconsistent' and is NOT comparable to published "
                      "FID.\n! Provide pt_inception-2015-12-05-6726825d.pth (see "
                      "metrics/fid.py) for real FID.")
                print("!" * 72)

    summary = dict(best_fid=None, epochs_run=0, fid_metric=fid_name, steps=0, last_metrics={})
    cur_iter = 0
    start = time.time()
    for epoch in range(cfg.start_epoch, cfg.num_epochs):
        if cfg.with_fid and (epoch == 0 or (epoch >= 100 and epoch % 20 == 0)
                                   or epoch == cfg.num_epochs - 1):
            n = min(cfg.fid_num_images, len(dataset))
            # rank 0 alone; the others wait for its score
            fid = on_primary(lambda: fid_fn(state, dataset, num_images=n, batch_size=min(64, n)))
            if verbose:
                print(f"epoch {epoch} {fid_name}: {fid:.3f}")
            tracker.update({fid_name: fid})
            if summary["best_fid"] is None or fid < summary["best_fid"]:
                summary["best_fid"] = fid
                ckpt.save(state, epoch, cur_iter, tag=f"_{fid_name}_{fid:.3f}")
        if epoch % cfg.save_interval == 0 and epoch > 0:
            ckpt.save(state, epoch, cur_iter, async_save=True)  # a host snapshot, then a thread
        step_fn = vanilla_step if epoch < cfg.num_vae else intro_step
        if epoch >= cfg.num_vae and vanilla_step is not None:
            vanilla_step = None  # its graphs and their memory pool (train/graph.py)
            if state.device.type == "cuda":
                torch.cuda.empty_cache()

        def host_batches(epoch=epoch):
            # (seed, epoch) seeding: shuffle and augment draws are a pure
            # function of the epoch, as in the JAX trainer
            aug_rng = np.random.default_rng((aug_seed, epoch))
            for batch in dataset.epoch(cfg.batch_size, drop_last=True, epoch_index=epoch,
                                       rows=mine):
                yield (augment_mirror(batch, aug_rng, mine, cfg.batch_size) if cfg.mirror_augment
                       else batch)

        def host_chunks():
            # scan_steps batches stacked into one (K, B, H, W, C) transfer; a
            # short trailing chunk replays the same graph fewer times
            buf = []
            for batch in host_batches():
                buf.append(batch)
                if len(buf) == cfg.scan_steps:
                    yield np.stack(buf)
                    buf = []
            if buf:
                yield np.stack(buf)

        scan = cfg.scan_steps > 1
        device_metrics = []
        for x in device_prefetch(host_chunks() if scan else host_batches(), size=2, put_fn=put_fn):
            k = int(x.shape[0]) if scan else 1
            state, m = step_fn(state, x)
            device_metrics.append(m)
            if cfg.save_figures and fires(cur_iter, k, cfg.test_iter) and is_primary():
                with unsharded():
                    _save_sample_grid(state, x[0] if scan else x, cfg, cur_iter)
            if cfg.nan_check_iter and fires(cur_iter, k, cfg.nan_check_iter):
                if not bool(torch.isfinite(torch.stack(list(m.values()))).all()):
                    raise SystemError("loss is NaN")
            cur_iter += k

        ep_mean = _epoch_means(device_metrics)  # one device->host fetch an epoch
        tracker.update(ep_mean)
        tracker.register_means(epoch)
        if any(np.isnan(v) for v in ep_mean.values()):
            raise SystemError("loss is NaN")
        if (cfg.exit_on_negative_diff and epoch > 50 and "diff_kl" in ep_mean
                and ep_mean["diff_kl"] < -1.0):
            raise SystemError("Negative KL Difference — lower beta_neg")
        if cfg.bootstrap and epoch % cfg.copy_to_target_freq == 0:
            sync_target_decoder(state)
        state.set_lr(lr_e_sched(epoch + 1), lr_d_sched(epoch + 1))  # per epoch (:649-650)
        summary.update(epochs_run=epoch + 1, steps=cur_iter, last_metrics=ep_mean)
        if verbose and ep_mean:
            keys = ("rec", "kl_real", "kl_fake", "kl_rec", "diff_kl")
            msg = ", ".join(f"{k}: {ep_mean[k]:.3f}" for k in keys if k in ep_mean)
            print(f"epoch {epoch}: {msg} ({time.time() - start:.1f}s)")

    ckpt.save(state, cfg.num_epochs - 1, cur_iter)  # waits for the async save in flight
    tracker.plot()
    tracker.save_pickle()  # loss-curve pickle (:695-697)
    return state, summary
