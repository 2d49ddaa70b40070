"""3D point-cloud trainer (port of train/threed.py: ShapeNet, chamfer loss, narrow prior).

Reference: soft_intro_vae_3d/train_soft_intro_vae_3d.py:111-449. JSON-config
driven, scale = 1/(3*n_points) (:156), prior N(0, prior_std^2) (:178-180),
optional random Z-rotation augment (:256-260), MultiStepLR [350,450,550]
gamma 0.5 (:188-189), valid-set JSD every valid_frequency epochs with
best-JSD checkpointing (:428-442), epoch-numbered checkpoints with optimizer
state (:444-449) and resume from the latest epoch (:191-198).

The per-epoch shuffle is ``np.random.default_rng((seed + 2, epoch))``, as in
the JAX trainer, so both packages see the same batches; ``epoch_batches``
selects them, each selection a ``feed.gather`` span. Step metrics stay on
the device and are fetched once per epoch (and every ``nan_check_iter`` steps).
On the card each step is a replay of a CUDA graph of one step
(train/graph.py ``one_step``), the counterpart of the JAX trainer's jitted
step, the six chamfer searches of an intro step recorded in it; the valid
JSD, the figure panel and the checkpoints run between replays and leave the
graphs as they are. The vanilla step and its graphs are dropped at the
switch to the introspective step. On the CPU the steps run eagerly.

Data parallelism (parallel/): in a process group ``batch_size`` is the
global batch and every rank gathers its rows of each batch from the
device-resident set (rotation angles drawn for the whole batch), as the
image trainer does (train/image.py); the valid JSD, figures and checkpoints
are rank 0's, and every rank resumes from the same checkpoint.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from soft_intro_vae_torch.data.shapenet import ShapeNetDataset, SyntheticClouds, rotate_z
from soft_intro_vae_torch.metrics.jsd import jsd_between_point_cloud_sets
from soft_intro_vae_torch.models.pointnet import CONV_CHANNELS, HIDDEN, SoftIntroVAE3D
from soft_intro_vae_torch.parallel.mesh import current_world, host_local_batch_size, shard_state
from soft_intro_vae_torch.parallel.multihost import check_world, is_primary, on_primary
from soft_intro_vae_torch.train import optim
from soft_intro_vae_torch.train.state import TrainState
from soft_intro_vae_torch.train.step import StepConfig, build_train_steps
from soft_intro_vae_torch.utils.checkpoint import Checkpointer
from soft_intro_vae_torch.utils.device import resolve_device, set_matmul_precision
from soft_intro_vae_torch.utils.profiling import span
from soft_intro_vae_torch.utils.tracker import LossTracker


@dataclasses.dataclass
class ThreeDConfig:
    """Mirrors config/soft_intro_vae_hp.json."""

    data_dir: str = "./datasets/shapenet_data"
    classes: Tuple[str, ...] = ("car", "airplane")
    n_points: int = 2048
    batch_size: int = 32
    max_epochs: int = 2000
    beta_rec: float = 20.0
    beta_kl: float = 1.0
    beta_neg: float = 256.0
    gamma_r: float = 1e-8
    num_vae: int = 0
    z_size: int = 128
    prior_std: float = 0.2
    lr_e: float = 5e-4
    lr_d: float = 5e-4
    seed: int = -1
    save_frequency: int = 50
    valid_frequency: int = 2
    apply_random_rotation: bool = False
    nan_check_iter: int = 200   # sub-epoch NaN-abort cadence; 0 disables
    reconstruction_loss: str = "chamfer"
    save_figures: bool = False
    results_dir: str = "./results_3d"
    use_synthetic: bool = False     # hermetic stand-in dataset
    synthetic_n: int = 256
    num_devices: Optional[int] = None
    verbose: bool = True
    resume: bool = True
    device: str = "cuda"            # port: where the nets and the data live
    chamfer_impl: str = "auto"      # port: auto | plain | cuda (ops/chamfer.py)
    # port: the PointNet widths, the JAX modules' conv_channels and hidden
    # fields (models/pointnet.py), which its trainer leaves at the recipe's
    conv_channels: Tuple[int, ...] = CONV_CHANNELS
    hidden: Tuple[int, ...] = HIDDEN
    # port: None keeps PyTorch's defaults (the encoder's per-point GEMMs in
    # TF32, as cuDNN's flag says, models/pointnet.py; the Linear layers in
    # float32); "float32" turns TF32 off for cuDNN and cuBLAS; "tensorfloat32"
    # turns it on (utils/device.py)
    matmul_precision: Optional[str] = None

    @classmethod
    def from_json(cls, path: str) -> "ThreeDConfig":
        """Load the reference's JSON config schema."""
        with open(path) as f:
            c = json.load(f)
        opt_e = c.get("optimizer", {}).get("E", {}).get("hyperparams", {})
        opt_d = c.get("optimizer", {}).get("D", {}).get("hyperparams", {})
        return cls(
            data_dir=c.get("data_dir", cls.data_dir),
            classes=tuple(c.get("classes", cls.classes)),
            n_points=c.get("n_points", cls.n_points),
            batch_size=c.get("batch_size", cls.batch_size),
            max_epochs=c.get("max_epochs", cls.max_epochs),
            beta_rec=c.get("beta_rec", cls.beta_rec),
            beta_kl=c.get("beta_kl", cls.beta_kl),
            beta_neg=c.get("beta_neg", cls.beta_neg),
            gamma_r=c.get("gamma_r", cls.gamma_r),
            num_vae=c.get("num_vae", cls.num_vae),
            z_size=c.get("z_size", cls.z_size),
            prior_std=c.get("prior_std", cls.prior_std),
            lr_e=opt_e.get("lr", cls.lr_e),
            lr_d=opt_d.get("lr", cls.lr_d),
            seed=c.get("seed", cls.seed),
            save_frequency=c.get("save_frequency", cls.save_frequency),
            valid_frequency=c.get("valid_frequency", cls.valid_frequency),
            apply_random_rotation="rotate" in c.get("transforms", []),
            reconstruction_loss=c.get("reconstruction_loss", cls.reconstruction_loss),
            results_dir=os.path.join(c.get("results_root", "./results"), c.get("arch", "vae"),
                                     c.get("experiment_name", "soft_intro_vae")),
            # extensions beyond the reference schema, as in the JAX package
            use_synthetic=c.get("use_synthetic", cls.use_synthetic),
            synthetic_n=c.get("synthetic_n", cls.synthetic_n),
            verbose=c.get("verbose", cls.verbose),
            num_devices=c.get("num_devices", cls.num_devices),
            matmul_precision=c.get("matmul_precision", cls.matmul_precision),
        )


def build_3d_training(cfg: ThreeDConfig, scan_steps: int = 1):
    """Returns ``(state, vanilla_step, intro_step)`` on ``cfg.device``, each a
    CUDA graph replayed once a call on the card (train/graph.py); with
    ``scan_steps`` K > 1 the steps take (K, B, N, 3) clouds."""
    if cfg.reconstruction_loss.lower() != "chamfer":
        raise ValueError(f"Invalid reconstruction loss. Accepted `chamfer`, got: {cfg.reconstruction_loss}")
    check_world(cfg.num_devices, cfg.batch_size)
    device = resolve_device(cfg.device)
    set_matmul_precision(cfg.matmul_precision)
    seed = cfg.seed if cfg.seed != -1 else int(time.time()) % (2**31)
    # the nets are made from the seed without touching the global RNG
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = SoftIntroVAE3D(z_dim=cfg.z_size, n_points=cfg.n_points,
                               conv_channels=cfg.conv_channels, hidden=cfg.hidden)
    state = TrainState.create(model, device=device, seed=seed + 1, lr_e=cfg.lr_e, lr_d=cfg.lr_d)
    step_cfg = StepConfig(
        z_dim=cfg.z_size,
        beta_rec=cfg.beta_rec,
        beta_kl=cfg.beta_kl,
        beta_neg=cfg.beta_neg,
        gamma_r=cfg.gamma_r,
        scale=1.0 / (3 * cfg.n_points),
        loss_type="chamfer",
        prior_logvar=float(np.log(cfg.prior_std**2)),
        prior_std=cfg.prior_std,
        fresh_z_in_d=True,
        detach_expelbo_targets=True,
        chamfer_impl=cfg.chamfer_impl,
    )
    vanilla_step, intro_step = build_train_steps(cfg=step_cfg, scan_steps=scan_steps)
    return shard_state(state), vanilla_step, intro_step


def epoch_batches(train_pts: np.ndarray, train_dev: torch.Tensor, epoch: int, *,
                  data_seed: int, batch_size: int, rows: slice = slice(None),
                  rotate: bool = False) -> Iterator[torch.Tensor]:
    """The batches of one epoch, in order: the epoch's permutation
    ``np.random.default_rng((data_seed, epoch))`` cut into whole batches of
    ``batch_size`` (the last partial batch dropped), and of each batch this
    rank's ``rows`` (all of it off the distributed route), gathered on the
    device from the resident set ``train_dev``. With ``rotate`` each batch
    is taken from the host's ``train_pts`` and turned about Z by angles
    drawn for the whole batch from the same generator (3d:256-260). Each
    batch's selection is a ``feed.gather`` span (utils/profiling.py), the
    batch's index in the epoch its ``batch``."""
    n = train_pts.shape[0]
    data_rng = np.random.default_rng((data_seed, epoch))
    idx = data_rng.permutation(n)
    idx_dev = torch.from_numpy(idx).to(train_dev.device)
    for b, i in enumerate(range(0, n - batch_size + 1, batch_size)):
        with span("feed.gather", batch=b):
            if rotate:
                angles = data_rng.random(batch_size) * 180.0
                x = torch.from_numpy(rotate_z(train_pts[idx[i:i + batch_size][rows]],
                                              angles[rows])).to(train_dev.device)
            else:
                x = train_dev[idx_dev[i:i + batch_size][rows]]
        yield x


@torch.no_grad()
def calc_jsd_valid(state: TrainState, valid_points: np.ndarray, cfg: ThreeDConfig,
                   trials: int = 3) -> float:
    """Valid-set JSD: mean of 3 trials, 3x samples each (3d:36-73)."""
    n = valid_points.shape[0]
    results = []
    for t in range(trials):
        gen = torch.Generator(device=state.device)
        gen.manual_seed(state.generator.initial_seed() + 777 + t)
        noise = cfg.prior_std * torch.randn((3 * n, cfg.z_size), generator=gen, device=state.device)
        x_g = state.decoder(noise).cpu().numpy()
        results.append(jsd_between_point_cloud_sets(x_g, valid_points, voxels=28))
    return float(np.mean(results))


def _epoch_means(device_metrics) -> dict:
    """One device->host fetch for a whole epoch of step metrics. The (K,)
    metrics of K-step calls are concatenated, so every step weighs equally."""
    if not device_metrics:
        return {}
    keys = list(device_metrics[0])
    table = torch.stack([torch.cat([m[k].reshape(-1) for m in device_metrics]) for k in keys])
    means = table.double().mean(dim=1).cpu().tolist()
    return dict(zip(keys, means))


@torch.no_grad()
def _save_epoch_panel(state: TrainState, train_pts: np.ndarray, cfg: ThreeDConfig, epoch: int):
    """The per-epoch 3x5 panel of real, reconstructed and sampled clouds
    (3d:396-426; the JAX trainer's train/threed.py:237-250), the encoder in
    eval mode, the samples drawn from a generator seeded from the run's seed
    and the epoch, so the training draws stay as they are."""
    from soft_intro_vae_torch.utils.plotting import save_pointcloud_panel

    x5 = torch.from_numpy(train_pts[:5]).to(state.device)
    gen = torch.Generator(device=state.device)
    gen.manual_seed(state.generator.initial_seed() + 31337 + epoch)
    noise5 = cfg.prior_std * torch.randn((5, cfg.z_size), generator=gen, device=state.device)
    state.model.eval()
    try:
        rec5 = state.decoder(state.encoder(x5)[0])
        fake5 = state.decoder(noise5)
    finally:
        state.model.train()
    return save_pointcloud_panel([train_pts[:5], rec5.cpu().numpy(), fake5.cpu().numpy()],
                                 os.path.join(cfg.results_dir, "samples", f"figure_{epoch}.png"))


def train_soft_intro_vae_3d(cfg: ThreeDConfig):
    """Run the 3D recipe; returns (state, summary)."""
    resolve_device(cfg.device)  # fail before loading the data, not after
    if cfg.use_synthetic:
        train_pts, _ = SyntheticClouds(cfg.synthetic_n, cfg.n_points, seed=max(cfg.seed, 0)).load_all()
        valid_pts = SyntheticClouds(max(cfg.synthetic_n // 8, 8), cfg.n_points, seed=max(cfg.seed, 0) + 1).load_all()[0]
    else:
        train_pts, _ = ShapeNetDataset(cfg.data_dir, cfg.classes, "train").load_all()
        valid_pts, _ = ShapeNetDataset(cfg.data_dir, cfg.classes, "valid").load_all()

    state, vanilla_step, intro_step = build_3d_training(cfg)
    device = state.device
    world = current_world()
    mine = world.rows(host_local_batch_size(cfg.batch_size, world))
    verbose = cfg.verbose and is_primary()
    ckpt = Checkpointer(os.path.join(cfg.results_dir, "weights"))
    tracker = LossTracker(cfg.results_dir)
    lr_e_sched = optim.multistep_lr(cfg.lr_e, (350, 450, 550), 0.5)
    lr_d_sched = optim.multistep_lr(cfg.lr_d, (350, 450, 550), 0.5)
    # per-epoch seeding: a resumed run replays the shuffle of an uninterrupted one
    data_seed = max(cfg.seed, 0) + 2

    starting_epoch = 1
    if cfg.resume:
        latest = ckpt.load_latest(state)  # every rank reads it
        if latest is not None:
            state, ep = latest
            shard_state(state)
            starting_epoch = ep + 1
            if verbose:
                print(f"resumed from epoch {ep}")

    # the training set lives on the device; batches are gathered there
    train_dev = torch.from_numpy(train_pts).to(device)
    best = {"epoch": 0, "jsd": None}
    summary = dict(best_jsd=None, epochs_run=0)
    bs = cfg.batch_size
    for epoch in range(starting_epoch, cfg.max_epochs + 1):
        step_fn = vanilla_step if epoch < cfg.num_vae else intro_step
        if epoch >= cfg.num_vae and vanilla_step is not None:
            vanilla_step = None  # its graphs and their memory pool (train/graph.py)
            if device.type == "cuda":
                torch.cuda.empty_cache()
        device_metrics = []
        for x in epoch_batches(train_pts, train_dev, epoch, data_seed=data_seed, batch_size=bs,
                               rows=mine, rotate=cfg.apply_random_rotation):
            state, m = step_fn(state, x)
            device_metrics.append(m)
            # sub-epoch NaN abort: one small sync every nan_check_iter steps
            if cfg.nan_check_iter and len(device_metrics) % cfg.nan_check_iter == 0:
                if not bool(torch.isfinite(torch.stack(list(m.values()))).all()):
                    raise SystemError("loss is NaN")
        ep_mean = _epoch_means(device_metrics)
        tracker.update(ep_mean)
        tracker.register_means(epoch)
        if any(np.isnan(v) for v in ep_mean.values()):
            raise SystemError("loss is NaN")
        state.set_lr(lr_e_sched(epoch), lr_d_sched(epoch))
        if verbose and ep_mean:
            shown = {k: round(v, 3) for k, v in ep_mean.items() if k in ("rec", "kl_real", "kl_fake", "diff_kl")}
            print(f"epoch {epoch}: {shown}")
        if cfg.save_figures and is_primary():
            _save_epoch_panel(state, train_pts, cfg, epoch)

        if epoch % cfg.valid_frequency == 0:
            # rank 0 alone; the others wait for its score
            jsd = on_primary(lambda: calc_jsd_valid(state, valid_pts, cfg))
            if verbose:
                print(f"epoch: {epoch}, jsd: {jsd:.4f}")
            if best["jsd"] is None or jsd < best["jsd"]:
                best.update(epoch=epoch, jsd=jsd)
                ckpt.save(state, epoch, 0, tag=f"_jsd_{jsd:.4f}")
            summary["best_jsd"] = best["jsd"]
        if epoch % cfg.save_frequency == 0:
            ckpt.save(state, epoch, 0)
        summary["epochs_run"] = epoch
        summary["last_metrics"] = ep_mean
    return state, summary
