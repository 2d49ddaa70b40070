"""Style-SoftIntroVAE trainer: progressive LOD, EMA (port of train/style.py).

Reference style_soft_intro_vae/train_style_soft_intro_vae.py:113-431 and its
launcher.py/defaults.py: a yacs-style config (YAML + KEY VALUE overrides),
per-LOD beta_neg (:278-286), per-LOD batch tables and LR (scheduler.py:61-73),
the optimizer reset on a LOD switch, sine-blend transitions with the input
blend (:330-346), an EMA twin updated every step with beta =
0.5^(batch/10000) (:399-401), checkpoints at epoch end, mid-epoch and at the
end, with resume, and the CSV tracker.

Data parallelism (parallel/): in a process group the LOD driver takes the
world size and its ``LOD_2_BATCH_{N}GPU`` table (global batches); every rank
takes its rows of each batch, its per-sample draws are its rows of draws for
the global batch, the step reduces gradients, dlatent_avg's style mean and
metrics, and rank 0 alone writes checkpoints, logs and figures and scores
FID while the others wait. Without a process group: one device.

Data: per-LOD TFRecord shards streamed from disk when DATASET.PATH is a
two-field %-pattern (data/streaming.py, as JAX :303-317), else the synthetic
stand-in. In a process group each rank reads its own ``PART_COUNT / N``
shards (the reference's per-rank assignment, dataloader.py:53-67) and yields
its ``B / N`` rows of each global batch from them, so unlike the in-memory
route N ranks do not compute what one does (ROADMAP Queue 3); at world 1 the
batches are the JAX package's, byte for byte.

The YAML is read by ``utils/yaml_config.py`` (the GPU machine has no
PyYAML). Images are fed NCHW: float batches are normalised on
the host (x / 127.5 - 1, as the JAX trainer does for float feeds and for
every transition batch); uint8 batches go to the device as bytes and are
normalised there by a 256-entry table lookup, exact for every byte.
``save_figures`` saves an EMA sample grid at the report cadence. ``with_fid``
scores the EMA generator by FID (metrics/fid.py) every ``fid_every`` epochs
once the last LOD is reached, against the dataset at the LOD's resolution,
and keeps the best-scoring state as a tagged checkpoint (the JAX trainer's
train/style.py:378-430). ``TRAIN.REMAT`` checkpoints the encoder with
mapping_tl and the decoder (train/style_step.py). The mid-epoch snapshots
and the end-of-epoch checkpoints are saved asynchronously, from a host copy
of the state (utils/checkpoint.py); the trainer waits for the last before it
returns.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from bisect import bisect_right
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from soft_intro_vae_torch.data.streaming import StreamingTFRecords
from soft_intro_vae_torch.parallel.mesh import World, current_world, shard_state, unsharded
from soft_intro_vae_torch.parallel.multihost import check_world, is_primary, on_primary
from soft_intro_vae_torch.train.lod import LODDriver, pick_batch_table
from soft_intro_vae_torch.train.style_step import (
    StyleModel,
    StyleModelConfig,
    StyleStepConfig,
    StyleTrainState,
    build_style_steps,
)
from soft_intro_vae_torch.utils import yaml_config
from soft_intro_vae_torch.utils.checkpoint import Checkpointer
from soft_intro_vae_torch.utils.device import resolve_device
from soft_intro_vae_torch.utils.tracker import LossTracker


@dataclasses.dataclass
class StyleConfig:
    """Flattened mirror of defaults.py's yacs schema (the JAX package's fields)."""

    name: str = ""
    output_dir: str = "results_style"
    # DATASET
    dataset_path: str = ""
    dataset_size: int = 70000
    max_resolution_level: int = 8
    flip_images: bool = True
    # MODEL
    layer_count: int = 6
    start_channel_count: int = 64
    max_channel_count: int = 512
    latent_space_size: int = 256
    dlatent_avg_beta: float = 0.995
    truncation_psi: float = 0.7
    truncation_cutoff: int = 8
    style_mixing_prob: float = 0.9
    mapping_layers: int = 5
    channels: int = 3
    encoder: str = "EncoderDefault"  # MODEL.ENCODER (defaults.py:60)
    beta_kl: float = 1.0
    beta_rec: float = 1.0
    beta_neg: Tuple[float, ...] = (2048, 2048, 1024, 512, 512, 128, 128, 64, 64)
    scale: float = 1.0 / (3 * 256**2)
    # TRAIN
    epochs_per_lod: int = 15
    base_learning_rate: float = 0.0015
    adam_beta2: float = 0.99
    learning_decay_rate: float = 0.1
    learning_decay_steps: Tuple[int, ...] = ()
    train_epochs: int = 110
    num_vae: int = 1
    learning_rates: Tuple[float, ...] = (0.002,)
    lod_2_batch_tables: Optional[Dict[str, List[int]]] = None
    report_freq: Tuple[int, ...] = (100, 80, 60, 30, 20, 10, 10, 5, 5)
    snapshot_freq: Tuple[int, ...] = (300, 300, 300, 100, 50, 30, 20, 20, 10)
    part_count: int = 1
    # runtime
    seed: int = 0
    num_devices: Optional[int] = None
    use_synthetic: bool = False
    synthetic_n: int = 512
    nan_check_iter: int = 200  # sub-epoch NaN-abort cadence; 0 disables
    fid_every: int = 10
    fid_num_images: int = 50000  # reference protocol (train_style_soft_intro_vae.py:292)
    with_fid: bool = False
    save_figures: bool = False
    verbose: bool = True
    resume: bool = True
    buffer_size_mb: int = 200       # the streaming reader's shuffle buffer
    # None: this process's place in the process group (parallel/mesh.py
    # current_world). Explicit values win: world_size=1 in a group has every
    # rank stream all shards (as rank 0 of one) and keep its rows of each
    # global batch
    rank: Optional[int] = None
    world_size: Optional[int] = None
    compute_dtype: str = "float32"  # "bfloat16": conv-path activations
    remat: bool = False
    # host-side pixels of the streamed batches: "uint8" ships source bytes and
    # normalizes on the device by a 256-entry table (exact for every byte);
    # "float32" normalizes on the host
    host_storage: str = "uint8"
    device: str = "cuda"            # port: where the nets and the batches live
    norm_impl: str = "auto"         # port: auto | plain | cuda (ops/adain.py)

    @classmethod
    def from_yaml(cls, path: str, overrides: Sequence[str] = ()) -> "StyleConfig":
        """A reference-format YAML (configs/ffhq256.yaml) plus KEY VALUE
        overrides (launcher.py:42-50 merge semantics), read as the JAX
        package reads them."""
        y = yaml_config.load_file(path)
        if len(overrides) % 2 != 0:
            # yacs merge_from_list asserts even length (launcher.py:42-50)
            raise ValueError(
                f"KEY VALUE overrides must come in pairs, got odd-length {list(overrides)}")
        for i in range(0, len(overrides) - 1, 2):
            key, val = overrides[i], overrides[i + 1]
            node = y
            parts = key.split(".")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = yaml_config.parse_scalar(val)
        d = y.get("DATASET", {})
        m = y.get("MODEL", {})
        t = y.get("TRAIN", {})
        tables = {k.replace("LOD_2_BATCH_", ""): v for k, v in t.items()
                  if k.startswith("LOD_2_BATCH_")}
        return cls(
            name=y.get("NAME", ""),
            output_dir=y.get("OUTPUT_DIR", "results_style"),
            dataset_path=d.get("PATH", ""),
            dataset_size=d.get("SIZE", 70000),
            part_count=d.get("PART_COUNT", 1),
            max_resolution_level=d.get("MAX_RESOLUTION_LEVEL", 8),
            flip_images=d.get("FLIP_IMAGES", True),
            layer_count=m.get("LAYER_COUNT", 6),
            start_channel_count=m.get("START_CHANNEL_COUNT", 64),
            max_channel_count=m.get("MAX_CHANNEL_COUNT", 512),
            latent_space_size=m.get("LATENT_SPACE_SIZE", 256),
            dlatent_avg_beta=m.get("DLATENT_AVG_BETA", 0.995),
            # the reference's own key spelling (defaults.py)
            truncation_psi=m.get("TRUNCATIOM_PSI", 0.7),
            truncation_cutoff=m.get("TRUNCATIOM_CUTOFF", 8),
            style_mixing_prob=m.get("STYLE_MIXING_PROB", 0.9),
            mapping_layers=m.get("MAPPING_LAYERS", 5),
            channels=m.get("CHANNELS", 3),
            encoder=m.get("ENCODER", "EncoderDefault"),
            beta_kl=m.get("BETA_KL", 1.0),
            beta_rec=m.get("BETA_REC", 1.0),
            beta_neg=tuple(m.get("BETA_NEG", cls.beta_neg)),
            scale=m.get("SCALE", 1.0 / (3 * 256**2)),
            epochs_per_lod=t.get("EPOCHS_PER_LOD", 15),
            base_learning_rate=t.get("BASE_LEARNING_RATE", 0.0015),
            # the reference reads ADAM_BETA_1 into LREQAdam's beta2 slot
            adam_beta2=t.get("ADAM_BETA_1", 0.99),
            learning_decay_rate=t.get("LEARNING_DECAY_RATE", 0.1),
            learning_decay_steps=tuple(t.get("LEARNING_DECAY_STEPS", ())),
            train_epochs=t.get("TRAIN_EPOCHS", 110),
            num_vae=t.get("NUM_VAE", 1),
            learning_rates=tuple(t.get("LEARNING_RATES", (0.002,))),
            lod_2_batch_tables=tables or None,
            use_synthetic=d.get("SYNTHETIC", False),
            synthetic_n=d.get("SYNTHETIC_N", 512),
            with_fid=t.get("WITH_FID", False),
            compute_dtype=t.get("COMPUTE_DTYPE", "float32"),
            remat=t.get("REMAT", False),
            seed=y.get("SEED", 0),
        )


class MultiResImages:
    """Per-LOD image feed (the JAX package's, in numpy): base images at the
    largest resolution, box-downscaled to each LOD's size. NHWC; float32 in
    [0, 255] or uint8."""

    def __init__(self, images: np.ndarray, seed: int = 0, flip: bool = True,
                 storage: str = "float32"):
        if images.ndim != 4:
            raise ValueError(f"images must be (N, H, W, C), got {images.shape}")
        if storage == "uint8":
            self.base = (images if images.dtype == np.uint8
                         else np.clip(np.rint(images), 0, 255).astype(np.uint8))
        else:
            self.base = images.astype(np.float32)
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.flip = flip
        self._cache: Dict[int, np.ndarray] = {}

    def __len__(self):
        return self.base.shape[0]

    @classmethod
    def from_tfrecords(cls, paths: Sequence[str], rank: int = 0, world_size: int = 1,
                       seed: int = 0, flip: bool = True, storage: str = "float32"
                       ) -> "MultiResImages":
        """From max-resolution TFRecord shards (the reference's data path,
        dataloader.py:30-102), this rank's shards of ``paths``, in memory."""
        from soft_intro_vae_torch.data.tfrecords import load_uint8_images, shard_paths_for_rank

        mine = shard_paths_for_rank(list(paths), rank, world_size)
        return cls(load_uint8_images(mine), seed=seed, flip=flip, storage=storage)

    @classmethod
    def synthetic(cls, n: int, resolution: int, channels: int = 3, seed: int = 0):
        rng = np.random.default_rng(seed)
        base = rng.random((n, 8, 8, channels)).astype(np.float32)
        reps = resolution // 8
        img = np.repeat(np.repeat(base, reps, 1), reps, 2)
        noise = rng.random((n, resolution, resolution, channels)).astype(np.float32)
        return cls(np.clip(0.85 * img + 0.15 * noise, 0, 1) * 255.0, seed=seed)

    def at_resolution(self, res: int) -> np.ndarray:
        if res not in self._cache:
            u8 = self.base.dtype == np.uint8
            cur = self.base.astype(np.float32) if u8 else self.base
            while cur.shape[1] > res:
                b, h, w, c = cur.shape
                cur = cur.reshape(b, h // 2, 2, w // 2, 2, c).mean(axis=(2, 4))
            self._cache[res] = (np.clip(np.rint(cur), 0, 255).astype(np.uint8)
                                if u8 else cur.astype(np.float32))
        return self._cache[res]

    def epoch(self, res: int, batch_size: int, epoch_index: Optional[int] = None,
              rows: Optional[slice] = None):
        """One shuffled pass of whole batches. With ``epoch_index`` the
        shuffle and flips are a function of (seed, epoch_index), so a resumed
        run replays the batches of an uninterrupted one. ``rows``: only those
        rows of each batch (a rank's), their flips drawn for the whole batch."""
        data = self.at_resolution(res)
        rng = self.rng if epoch_index is None else np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch_index]))
        n = data.shape[0]
        idx = rng.permutation(n)
        for i in range(0, n - n % batch_size, batch_size):
            take = idx[i: i + batch_size]
            batch = data[take if rows is None else take[rows]]
            if self.flip:
                flip = rng.random(batch_size) < 0.5
                flip = flip if rows is None else flip[rows]
                batch = batch.copy()
                batch[flip] = batch[flip][:, :, ::-1, :]
            yield batch


def _lr_for(cfg: StyleConfig, epoch: int, lod: int) -> float:
    base = cfg.learning_rates[min(lod, len(cfg.learning_rates) - 1)]
    return base * cfg.learning_decay_rate ** bisect_right(list(cfg.learning_decay_steps), epoch)


def build_style_training(cfg: StyleConfig) -> Tuple[StyleModel, StyleTrainState]:
    """(model, state) on ``cfg.device``, the nets drawn from ``cfg.seed``."""
    check_world(cfg.num_devices)  # each LOD's batch is checked when it starts
    device = resolve_device(cfg.device)
    model = StyleModel(StyleModelConfig(
        startf=cfg.start_channel_count, maxf=cfg.max_channel_count,
        layer_count=cfg.layer_count, latent_size=cfg.latent_space_size,
        mapping_layers=cfg.mapping_layers, channels=cfg.channels,
        dlatent_avg_beta=cfg.dlatent_avg_beta, style_mixing_prob=cfg.style_mixing_prob,
        truncation_psi=cfg.truncation_psi, truncation_cutoff=cfg.truncation_cutoff,
        encoder_variant=cfg.encoder, compute_dtype=cfg.compute_dtype, norm_impl=cfg.norm_impl,
        remat=cfg.remat))
    # the nets are made from the seed without touching the global RNG
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.seed)
        nets = model.make_nets()
    state = StyleTrainState.create(nets, device=device, seed=cfg.seed + 1,
                                   lr=cfg.base_learning_rate, beta2=cfg.adam_beta2)
    return model, shard_state(state)


def make_style_dataset(cfg: StyleConfig):
    """The synthetic stand-in, or per-LOD TFRecord shards streamed from disk
    when DATASET.PATH is a %-pattern (dataloader.py:60-67), this rank's
    shards when ``rank``/``world_size`` (None: the process group's) split them."""
    max_res = 2 ** cfg.max_resolution_level
    model_res = 2 ** (cfg.layer_count + 1)
    if cfg.use_synthetic:
        return MultiResImages.synthetic(cfg.synthetic_n, min(max_res, model_res),
                                        cfg.channels, seed=cfg.seed)
    if cfg.dataset_path and "%" in cfg.dataset_path:
        world = current_world()
        world_size = world.size if cfg.world_size is None else cfg.world_size
        # one reader of the whole set is rank 0 of one, whatever the process's rank
        rank = (0 if world_size == 1 else world.rank) if cfg.rank is None else cfg.rank
        return StreamingTFRecords(
            cfg.dataset_path, part_count=cfg.part_count, dataset_size=cfg.dataset_size,
            max_resolution_level=cfg.max_resolution_level, rank=rank, world_size=world_size,
            buffer_size_mb=cfg.buffer_size_mb, channels=cfg.channels, seed=cfg.seed,
            flip=cfg.flip_images, storage=cfg.host_storage)
    raise ValueError(
        "DATASET.PATH must be a per-LOD TFRecord %-pattern "
        "(e.g. 'ffhq-r%02d.tfrecords.%03d'); set use_synthetic=True "
        "(CLI: DATASET.SYNTHETIC true) for smoke runs")


class _Feed:
    """Host batches (NHWC) -> NCHW f32 batches on the device, in [-1, 1]."""

    def __init__(self, device: torch.device):
        self.device = device
        # the table is computed on the host, as the JAX trainer computes it, so
        # every byte maps to the bits of the host path's x / 127.5 - 1
        lut = np.arange(256, dtype=np.float32) / 127.5 - 1.0
        self.lut = torch.from_numpy(lut).to(device)

    def __call__(self, raw: np.ndarray, blend: float, blended: bool) -> torch.Tensor:
        if raw.dtype == np.uint8 and not blended:
            u8 = torch.from_numpy(raw).to(self.device)
            x = self.lut[u8.long()]
        else:
            x = raw.astype(np.float32) / 127.5 - 1.0
            if blended:
                # progressive-growth input blend (:342-346)
                b, h, w, c = x.shape
                x_prev = x.reshape(b, h // 2, 2, w // 2, 2, c).mean(axis=(2, 4))
                x_prev2x = np.repeat(np.repeat(x_prev, 2, 1), 2, 2)
                x = x * blend + x_prev2x * (1.0 - blend)
            x = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
        return x.permute(0, 3, 1, 2).contiguous()


@torch.no_grad()
def _save_style_samples(model: StyleModel, cfg: StyleConfig, state: StyleTrainState, lod: int,
                        epoch: int, nimg: int, count: int = 16):
    """EMA sample grid at the report cadence (reference save_sample,
    train_style_soft_intro_vae.py:408-413; the JAX trainer's
    ``_save_style_samples``), drawn from a generator seeded from the run's
    seed, the epoch and the images seen, so the training draws stay as they are."""
    from soft_intro_vae_torch.utils.plotting import save_image_grid

    gen = torch.Generator(device=state.device)
    gen.manual_seed(state.generator.initial_seed() + 40000 + epoch * 1000 + nimg // 1000)
    z = torch.randn((count, cfg.latent_space_size), generator=gen, device=state.device)
    rec = model.generate(state.ema, gen, lod, None, z, mixing=False, truncation=True,
                         update_avg=False)
    img = np.clip(rec.permute(0, 2, 3, 1).float().cpu().numpy() * 0.5 + 0.5, 0, 1)
    path = os.path.join(cfg.output_dir, "samples", f"epoch{epoch}_nimg{nimg}.jpg")
    return save_image_grid(img, path, nrow=4)


def make_style_fid(model: StyleModel, cfg: StyleConfig):
    """FID of the EMA generator (reference :287-299):
    ``fid_fn(state, dataset, lod, batch_size=32)``. The real statistics are
    the dataset at the LOD's resolution (in memory, or one pass of the shards
    streamed: rank 0's own when they are split), cached per resolution; the fakes are
    EMA samples without truncation, [-1, 1] -> [0, 1], their latents and
    noise from a generator of their own seeded from the run's seed, so the
    training draws stay as they are."""
    from soft_intro_vae_torch.metrics.fid import (
        compute_statistics_streaming, frechet_distance, load_fid_network)

    apply_fn = load_fid_network(device=cfg.device)
    real_cache: Dict[int, Tuple] = {}

    @torch.no_grad()
    def fid_fn(state: StyleTrainState, dataset, lod: int,
               batch_size: int = 32) -> float:
        res = model.layer_to_resolution[lod]
        if res not in real_cache:
            def real_iter():
                seen = 0
                for b in dataset.epoch(res, batch_size):
                    if seen >= cfg.fid_num_images:
                        break
                    seen += b.shape[0]
                    # uint8 batches go as they are: the statistics normalize them
                    yield b if b.dtype == np.uint8 else b / 255.0

            real_cache[res] = compute_statistics_streaming(apply_fn, real_iter(), state.device)
        mu1, s1 = real_cache[res]
        gen = torch.Generator(device=state.device)
        gen.manual_seed(state.generator.initial_seed() + 9000)

        def fake_iter():
            made = 0
            while made < cfg.fid_num_images:
                z = torch.randn((batch_size, cfg.latent_space_size), generator=gen,
                                device=state.device)
                rec = model.generate(state.ema, gen, lod, None, z, mixing=False,
                                     truncation=False, update_avg=False)
                made += batch_size
                yield (rec.float() * 0.5 + 0.5).clamp(0.0, 1.0).permute(0, 2, 3, 1)

        mu2, s2 = compute_statistics_streaming(apply_fn, fake_iter(), state.device)
        return frechet_distance(mu1, s1, mu2, s2, device=state.device)

    return fid_fn


def rank_batches(dataset, res: int, batch: int, epoch: int, world: World):
    """This rank's rows of each global batch of ``batch`` images in the epoch.

    In memory (and for shards every rank streams whole): the rows of the
    global batch, with the global batch's draws. Shards split over the ranks:
    this rank's ``batch / N`` images a step, from its own shards."""
    local = batch // world.size
    if not isinstance(dataset, StreamingTFRecords):
        return dataset.epoch(res, batch, epoch_index=epoch, rows=world.rows(local))
    if dataset.world_size == world.size:
        return dataset.epoch(res, local, epoch_index=epoch)
    if dataset.world_size == 1:
        return (b[world.rows(local)] for b in dataset.epoch(res, batch, epoch_index=epoch))
    raise ValueError(f"the shards are split over {dataset.world_size} ranks, but the process "
                     f"group has {world.size}: leave rank/world_size unset or set world_size 1")


def _epoch_means(device_metrics) -> dict:
    """One device->host fetch for a whole epoch of step metrics."""
    keys = list(device_metrics[0])
    table = torch.stack([torch.stack([m[k] for m in device_metrics]) for k in keys])
    return dict(zip(keys, table.double().mean(dim=1).cpu().tolist()))


def train_style_soft_intro_vae(cfg: StyleConfig, dataset=None):
    """Run the style recipe on ``dataset`` (a ``MultiResImages`` or a
    ``StreamingTFRecords``; None: ``make_style_dataset(cfg)``); returns
    (state, summary)."""
    resolve_device(cfg.device)  # fail before loading the data, not after
    if dataset is None:
        dataset = make_style_dataset(cfg)

    model, state = build_style_training(cfg)
    world = current_world()
    verbose = cfg.verbose and is_primary()
    tables = cfg.lod_2_batch_tables or {"1GPU": [128, 128, 128, 32, 16, 8, 4]}
    # images a global epoch: a streaming reader's length is its rank's share
    dataset_size = (dataset.dataset_size if isinstance(dataset, StreamingTFRecords)
                    else len(dataset))
    lod2batch = LODDriver(
        lod_2_batch=pick_batch_table(tables, world.size), epochs_per_lod=cfg.epochs_per_lod,
        layer_count=cfg.layer_count, dataset_size=dataset_size, world_size=world.size,
        report_freq=cfg.report_freq, snapshot_freq=cfg.snapshot_freq)
    ckpt = Checkpointer(os.path.join(cfg.output_dir, "training_artifacts"), prefix=cfg.name + "_")
    tracker = LossTracker(cfg.output_dir)
    summary = dict(best_fid=None, epochs_run=0, lods_seen=[], blended_steps=0, steps=0)

    # resume (reference :233-234, :268,277): end-of-epoch anchors resume at the
    # next epoch, mid-epoch snapshots restart the interrupted epoch
    start_epoch = 0
    if cfg.resume:
        loaded = ckpt.load_latest(state)  # every rank reads it
        if loaded is not None:
            state, saved_epoch = loaded
            shard_state(state)
            aux = ckpt.latest_aux() or {}
            start_epoch = saved_epoch + 1 if aux.get("epoch_completed", True) else saved_epoch
            # fast-forward the LOD driver without signalling an optimizer
            # reset: the checkpoint holds the post-switch optimizer state
            lod2batch.set_epoch(max(0, start_epoch - 1))
            if aux.get("tracker"):
                tracker.load_state_dict(aux["tracker"])
            summary["best_fid"] = aux.get("best_fid")
            summary["lods_seen"] = list(aux.get("lods_seen", []))
            if verbose:
                print(f"resumed from epoch {saved_epoch} (lod {lod2batch.lod}); "
                      f"starting at epoch {start_epoch}")

    step_cache: Dict[Tuple[int, bool, float], Tuple] = {}

    def get_steps(lod: int, blended: bool, beta_neg: float):
        key = (lod, blended, beta_neg)
        if key not in step_cache:
            scfg = StyleStepConfig(latent_size=cfg.latent_space_size, beta_rec=cfg.beta_rec,
                                   beta_kl=cfg.beta_kl, beta_neg=beta_neg, gamma_r=1e-8,
                                   scale=cfg.scale)
            step_cache[key] = build_style_steps(model, scfg, lod, blended)
        return step_cache[key]

    def aux(lod, completed):
        return {"tracker": tracker.state_dict(), "best_fid": summary["best_fid"],
                "lods_seen": summary["lods_seen"], "lod": lod, "epoch_completed": completed}

    fid_fn = None
    fid_name = "fid"
    if cfg.with_fid:
        from soft_intro_vae_torch.metrics.fid import fid_weights_path

        fid_fn = make_style_fid(model, cfg) if is_primary() else None  # rank 0 scores
        if fid_weights_path() is None:
            fid_name = "fid_selfconsistent"
            if is_primary():
                print("! WARNING: pt_inception weights not found — style FID uses a "
                  "RANDOM-INIT Inception;\n! logged as 'fid_selfconsistent', NOT "
                  "comparable to published FID.")
    summary["fid_metric"] = fid_name

    feed = _Feed(state.device)
    start = time.time()
    for epoch in range(start_epoch, cfg.train_epochs):
        if lod2batch.set_epoch(epoch):
            # optimizer state reset on a LOD switch (lod_driver.py:111-112)
            state.reset_optimizers()
            if lod2batch.lod not in summary["lods_seen"]:
                summary["lods_seen"].append(lod2batch.lod)
        lod = lod2batch.lod
        beta_neg = float(cfg.beta_neg[min(lod, len(cfg.beta_neg) - 1)])
        batch = lod2batch.get_batch_size()
        res = model.layer_to_resolution[lod]
        state.set_lr(_lr_for(cfg, epoch, lod))
        state.ema_beta = 0.5 ** (batch / 10000.0)
        if (cfg.with_fid and epoch > cfg.epochs_per_lod * (cfg.layer_count - 1)
                and epoch % cfg.fid_every == 0):
            # rank 0 alone; the others wait for its score
            fid = on_primary(lambda: fid_fn(state, dataset, lod,
                                            batch_size=min(32, cfg.fid_num_images)))
            if verbose:
                print(f"epoch {epoch} {fid_name}: {fid:.2f}")
            tracker.update({fid_name: fid})
            if summary["best_fid"] is None or fid < summary["best_fid"]:
                summary["best_fid"] = fid
                # FID runs at the top of the epoch, before it trains: a resume
                # from this checkpoint restarts the epoch
                ckpt.save(state, epoch, state.step, tag=f"_lod{lod}_{fid_name}_{fid:.2f}",
                          aux=aux(lod, False))
        vanilla = epoch < cfg.num_vae
        device_metrics = []
        it = 0
        check_world(cfg.num_devices, batch)
        for raw in rank_batches(dataset, res, batch, epoch, world):
            blend = lod2batch.blend_factor_at(it)
            it += batch
            blended = lod2batch.in_transition and blend < 1.0 and lod > 0
            vanilla_step, intro_step = get_steps(lod, blended, beta_neg)
            step_fn = vanilla_step if vanilla else intro_step
            state, m = step_fn(state, feed(raw, blend, blended), blend)
            device_metrics.append(m)
            summary["blended_steps"] += int(blended)
            summary["steps"] += 1
            lod2batch.step()
            if lod2batch.is_time_to_save():
                # mid-epoch snapshot: resume restarts this epoch
                ckpt.save(state, epoch, state.step, aux=aux(lod, False), async_save=True)
            if cfg.save_figures and lod2batch.is_time_to_report() and is_primary():
                with unsharded():
                    _save_style_samples(model, cfg, state, lod, epoch, lod2batch.iteration)
            # sub-epoch NaN abort: one small sync every nan_check_iter steps
            if cfg.nan_check_iter and len(device_metrics) % cfg.nan_check_iter == 0:
                if not bool(torch.isfinite(torch.stack(list(m.values()))).all()):
                    raise SystemError("loss is NaN")
        if not device_metrics:
            raise ValueError(
                f"epoch {epoch}: zero batches — batch {batch} exceeds "
                f"dataset size {dataset_size} (check LOD batch tables)")
        ep_mean = _epoch_means(device_metrics)
        tracker.update(ep_mean)
        tracker.register_means(epoch)
        if any(math.isnan(v) for v in ep_mean.values()):
            raise SystemError("loss is NaN")
        summary["epochs_run"] = epoch + 1
        summary["last_metrics"] = ep_mean
        # end-of-epoch checkpoint (reference model_tmp_lod%d, :425): the resume anchor
        ckpt.save(state, epoch, state.step, aux=aux(lod, True), async_save=True)
        if verbose:
            shown = {k: round(v, 4) for k, v in ep_mean.items()
                     if k in ("rec_loss", "real_kl", "fake_kl", "kl_diff")}
            print(f"epoch {epoch} lod {lod} res {res} bs {batch}: {shown} "
                  f"({time.time() - start:.1f}s)")

    if summary["epochs_run"] > 0 or ckpt.latest_path() is None:
        # skip the redundant _final rewrite when resume found nothing to do
        ckpt.save(state, cfg.train_epochs - 1, state.step, tag="_final",
                  aux=aux(lod2batch.lod, True))
    ckpt.wait()
    return state, summary
