"""Distributed-correctness probes (port of parallel/verify.py).

One train step under SGD(lr=1) on a deterministic global batch, over
whatever process group is running: with lr = 1 a parameter's delta is the
negative all-reduced gradient, so comparing deltas across world sizes (and
with the JAX package's data-parallel step) tests the collectives with no
optimizer in the way. The JAX probes apply ``optax.sgd(1.0)``'s update
through ``apply_updates_with_lr`` (params - lr * update, the update being
-g), so each step moves along the gradient and the delta, initial minus
final, is -g; the port's probes step the same way (``SGD(maximize=True)``). Unlike the JAX probes these take their initial weights
and global draws as arguments, so a test can feed the JAX package's.

  * ``sgd_gradient_probe``: the generic step (train/step.py), for the image,
    bootstrap and 3D nets, intro or vanilla;
  * ``style_step_probe``: style intro steps (EMA, dlatent_avg, blend), with a
    rank-0 checkpoint after the first and a resume from one, so a run saved
    under N ranks can resume under M;
  * ``encoder_bn_probe``: the image or PointNet encoder's BatchNorms over
    the global batch, forward and input gradient;
  * ``training_probe``: the image, 3D or style trainer in each rank;
  * ``stream_probe``: the style trainer's streamed dataset in each rank, its
    shard files and its rows of each global batch;
  * ``compare_gradient_trees``: per-leaf relative L2, the JAX rule.

``main`` is what a rank started by ``parallel/launch.py`` runs: it joins the
group (a file store), runs the jobs of a JSON spec on the inputs of an
``.npz`` and writes its results to ``rank{r}of{n}.npz``:

    python -m soft_intro_vae_torch.parallel.verify --spec S --rank R --world N --store F --out D
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from soft_intro_vae_torch.parallel.mesh import current_world, shard_batch, shard_state

Arrays = Dict[str, np.ndarray]


class Sgd:
    """The JAX probes' SGD(lr) step, p + lr * g (module doc), over a parameter
    list with LreqAdam's interface, for the style state: a parameter with no
    gradient stays where it is."""

    def __init__(self, params, lr: float = 1.0):
        self.params = list(params)
        self.lr = lr
        self.count = 0
        self.nu: list = []

    def reset(self) -> None:
        self.count = 0

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        self.count += 1
        for p in self.params:
            if p.grad is not None:
                p.add_(p.grad, alpha=self.lr)

    def state_dict(self) -> dict:
        return {"count": self.count, "lr": self.lr}

    def load_state_dict(self, sd: dict) -> None:
        self.count, self.lr = int(sd["count"]), float(sd["lr"])


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _model(variant: str, z_dim: int, channels: Sequence[int], image_size: int, n_points: int):
    if variant == "3d":
        from soft_intro_vae_torch.models.pointnet import SoftIntroVAE3D

        return SoftIntroVAE3D(z_dim=z_dim, n_points=n_points)
    from soft_intro_vae_torch.models.conv import SoftIntroVAE

    return SoftIntroVAE(cdim=3, zdim=z_dim, channels=tuple(channels), image_size=image_size,
                        bootstrap=variant == "bootstrap")


def _step_config(variant: str, z_dim: int, image_size: int, n_points: int, **kw):
    from soft_intro_vae_torch.train.step import StepConfig

    if variant == "3d":  # the 3D trainer's config (train/threed.py build_3d_training)
        prior_std = kw.pop("prior_std", 0.2)
        return StepConfig(z_dim=z_dim, scale=1.0 / (3 * n_points), loss_type="chamfer",
                          prior_logvar=float(np.log(prior_std**2)), prior_std=prior_std,
                          fresh_z_in_d=True, detach_expelbo_targets=True, **kw)
    return StepConfig(z_dim=z_dim, scale=1.0 / (3 * image_size**2),
                      bootstrap=variant == "bootstrap", **kw)


def sgd_gradient_probe(x: np.ndarray, noises: Optional[Arrays] = None,
                       weights: Optional[Dict[str, torch.Tensor]] = None, *,
                       variant: str = "image", mode: str = "intro", z_dim: int = 16,
                       channels: Sequence[int] = (8, 16), image_size: int = 16,
                       n_points: int = 2048, seed: int = 0, device: str = "cpu",
                       step_kwargs: Optional[dict] = None, lr: float = 1.0) -> Arrays:
    """One ``mode`` step ("intro" or "vanilla") of ``variant`` ("image",
    "bootstrap" or "3d") with SGD(lr=1) on the global batch ``x`` (NHWC
    images, uint8 or float, or (B, N, 3) clouds), this rank taking its rows.

    ``noises``: the step's draws by name for the global batch (None: drawn
    from the state's generator, seeded from ``seed``); ``weights``: a
    state_dict in the reference's names (None: the nets drawn from ``seed``).
    ``lr`` scales the step where an ascent of lr = 1 would overflow (the 3D
    nets' narrow prior). Returns host arrays: ``delta/<param>`` (init minus
    after), ``grad/<param>`` (the all-reduced gradient the parameter's phase
    stepped with: exact where a small ``lr``'s delta is rounded to the
    weights' precision), ``buf/<name>``
    (the BN buffers after the step) and ``metric/<name>``; every rank
    returns its own copy."""
    from soft_intro_vae_torch.train.state import TrainState
    from soft_intro_vae_torch.train.step import UNIT_LUT, build_train_steps

    dev = torch.device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = _model(variant, z_dim, channels, image_size, n_points)
    if weights is not None:
        model.load_state_dict(weights, strict=True)
    model = model.to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    # the JAX probe's step, p + g (module doc)
    state = TrainState(model=model,
                       opt_e=torch.optim.SGD(model.encoder.parameters(), lr=lr, maximize=True),
                       opt_d=torch.optim.SGD(model.decoder.parameters(), lr=lr, maximize=True),
                       generator=gen, device=dev, lr_e=1.0, lr_d=1.0)
    state = shard_state(state)
    image = variant != "3d"
    vanilla, intro = build_train_steps(
        cfg=_step_config(variant, z_dim, image_size, n_points, **(step_kwargs or {})),
        input_lut=UNIT_LUT if image else None, nhwc=image)
    init = {k: p.detach().clone() for k, p in model.named_parameters()}
    xb = torch.from_numpy(np.ascontiguousarray(shard_batch(x))).to(dev)
    nv = None if noises is None else {k: torch.from_numpy(v) for k, v in noises.items()}
    state, m = (intro if mode == "intro" else vanilla)(state, xb, nv)
    out = {f"delta/{k}": _np(init[k] - p) for k, p in model.named_parameters()}
    out.update({f"grad/{k}": _np(p.grad) for k, p in model.named_parameters()
                if p.grad is not None})
    out.update({f"buf/{k}": _np(b) for k, b in model.named_buffers()})
    out.update({f"metric/{k}": _np(v) for k, v in m.items()})
    return out


def encoder_bn_probe(x: np.ndarray, weights: Dict[str, torch.Tensor], w_mu: np.ndarray,
                     w_logvar: np.ndarray, *, variant: str = "image", z_dim: int = 16,
                     channels: Sequence[int] = (8, 16), image_size: int = 16,
                     device: str = "cpu") -> Arrays:
    """The image encoder's train-mode forward on this rank's rows of the
    global NHWC batch ``x`` (``variant`` "3d": the PointNet encoder's, on
    (B, N, 3) clouds, its BatchNorms over the points-major rows), and the
    gradient of the loss ``sum(mu * w_mu) + sum(logvar * w_logvar)`` over
    the global batch (``w_*`` global too) with respect to its rows: the
    BatchNorms' global route, forward and backward. Returns this rank's
    ``mu``, ``logvar``, ``dx`` (in ``x``'s layout) and the BN buffers after
    the forward (``buf/<name>``)."""
    from soft_intro_vae_torch.models.conv import ConvEncoder
    from soft_intro_vae_torch.models.pointnet import PointNetEncoder

    dev = torch.device(device)
    x_local = torch.from_numpy(np.ascontiguousarray(shard_batch(x))).to(dev).requires_grad_(True)
    if variant == "3d":
        enc = PointNetEncoder(z_dim=z_dim, conv_channels=tuple(channels))
        xb = x_local
    else:
        enc = ConvEncoder(cdim=3, zdim=z_dim, channels=tuple(channels), image_size=image_size)
        xb = x_local.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    enc.load_state_dict(weights, strict=True)
    enc = enc.to(dev).train()
    mu, logvar = enc(xb)
    wm = torch.from_numpy(shard_batch(w_mu)).to(dev)
    wl = torch.from_numpy(shard_batch(w_logvar)).to(dev)
    ((mu * wm).sum() + (logvar * wl).sum()).backward()
    out = {"mu": _np(mu), "logvar": _np(logvar), "dx": _np(x_local.grad)}
    out.update({f"buf/{k}": _np(b) for k, b in enc.named_buffers()})
    return out


def training_probe(variant: str, config: dict, images: Optional[np.ndarray] = None,
                   channels: Sequence[int] = (8, 16), device: str = "cpu") -> Arrays:
    """A trainer's run in each rank: ``train_soft_intro_vae`` ("image", on
    the uint8 NHWC ``images``), ``train_soft_intro_vae_3d`` ("3d") or
    ``train_style_soft_intro_vae`` ("style"), with the config fields
    ``config``; ``{rank}`` in its output directory becomes this rank's.
    Returns the final ``state/<name>`` tensors and ``metric/<name>``, the
    last epoch's means."""
    from soft_intro_vae_torch.parallel.multihost import group_world

    rank = group_world().rank
    config = {k: v.format(rank=rank) if isinstance(v, str) else v for k, v in config.items()}
    if variant == "image":
        from soft_intro_vae_torch.data.images import ArrayDataset, ImageSpec
        from soft_intro_vae_torch.train.image import ImageConfig, train_soft_intro_vae

        cfg = ImageConfig(device=device, **config)
        spec = ImageSpec(cfg.dataset, images.shape[1], tuple(channels), images.shape[3])
        state, summary = train_soft_intro_vae(cfg, ArrayDataset(images, seed=1), spec)
        nets = state.model
    elif variant == "3d":
        from soft_intro_vae_torch.train.threed import ThreeDConfig, train_soft_intro_vae_3d

        state, summary = train_soft_intro_vae_3d(ThreeDConfig(device=device, **config))
        nets = state.model
    else:
        from soft_intro_vae_torch.train.style import StyleConfig, train_style_soft_intro_vae

        state, summary = train_style_soft_intro_vae(StyleConfig(device=device, **config))
        nets = state.nets
    out = {f"state/{k}": _np(v) for k, v in nets.state_dict().items()}
    out.update({f"metric/{k}": np.asarray(v) for k, v in summary["last_metrics"].items()})
    return out


def stream_probe(config: dict, res: int, batch: int, epochs: int = 2,
                 device: str = "cpu") -> Arrays:
    """``make_style_dataset`` of the style config fields ``config`` in each
    rank: ``files``, this rank's shard files at every level, and
    ``epoch{e}``, its rows of each global batch of ``batch`` at ``res``
    (``train/style.py rank_batches``), stacked."""
    from soft_intro_vae_torch.train.style import StyleConfig, make_style_dataset, rank_batches

    ds = make_style_dataset(StyleConfig(device=device, **config))
    out = {"files": np.asarray(sorted(f for fs in ds.filenames.values() for f in fs))}
    for e in range(epochs):
        out[f"epoch{e}"] = np.stack(list(rank_batches(ds, res, batch, e, current_world())))
    return out


def style_probe_config(**kw):
    """The JAX style probe's tiny config (parallel/verify.py:133-134), style
    mixing and decoder noise as given."""
    from soft_intro_vae_torch.train.style_step import StyleModelConfig

    base = dict(startf=8, maxf=16, layer_count=2, latent_size=8, mapping_layers=2)
    base.update(kw)
    return StyleModelConfig(**base)


def style_step_probe(xs: np.ndarray, nzs: Optional[Sequence[Optional[Arrays]]] = None,
                     weights: Optional[Dict[str, torch.Tensor]] = None, *,
                     model_kwargs: Optional[dict] = None, lod: int = 1, blend: float = 0.5,
                     steps: int = 2, start_step: int = 0, save_dir: Optional[str] = None,
                     restore_dir: Optional[str] = None, noise_mode: str = "batch",
                     ema_beta: Optional[float] = None, seed: int = 0, lr: float = 1.0,
                     perturb: float = 0.0, moved_only: bool = False,
                     device: str = "cpu") -> Arrays:
    """``steps`` style intro steps with SGD(lr=1) on the BLEND program at
    ``lod``, step i on the global NHWC batch ``xs[i]`` in [-1, 1] with the
    injected global latents ``nzs[i]`` (None: drawn from the generator).

    ``save_dir``: rank 0 checkpoints after the first step it runs;
    ``restore_dir`` with ``start_step``: resume from that checkpoint under
    this world and run the remaining steps. Returns ``delta_e/``,
    ``delta_d/`` (initial weights minus final), ``ema/`` (the EMA nets),
    ``dlatent_avg``, ``ema_dlatent_avg``, ``step``, ``metric/`` and
    ``grad/`` (the last step's all-reduced gradients, as in
    ``sgd_gradient_probe``; ``lr`` as there); ``moved_only`` leaves out the
    parameters (and their EMA) that the steps did not move, the blocks of
    other LODs. ``perturb`` adds that much of a seeded normal draw to every
    weight drawn from ``seed``: at the init the generator's first block (a
    constant 4x4 input, zero biases, instance norms of near-constant planes)
    has gradients that are sums of cancelling terms, which ranks that split
    the batch round differently (ROADMAP Queue 3)."""
    from soft_intro_vae_torch.train.style_step import (
        StyleModel, StyleStepConfig, StyleTrainState, build_style_steps)
    from soft_intro_vae_torch.utils.checkpoint import Checkpointer

    dev = torch.device(device)
    mc = style_probe_config(**(model_kwargs or {}))
    model = StyleModel(mc)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        nets = model.make_nets()
        if perturb:
            with torch.no_grad():
                for p in nets.parameters():
                    p.add_(torch.randn_like(p), alpha=perturb)
    if weights is not None:
        nets.load_state_dict(weights, strict=True)
    global_batch = xs.shape[1]
    beta = ema_beta if ema_beta is not None else 0.5 ** (global_batch / 10000.0)
    state = StyleTrainState.create(nets, device=dev, seed=seed + 1, lr=lr, ema_beta=beta)
    state.opt_e, state.opt_d = Sgd(nets.params_e(), lr), Sgd(nets.params_d(), lr)
    init = {k: p.detach().clone() for k, p in state.nets.named_parameters()}
    if restore_dir is not None:
        Checkpointer(restore_dir).load_latest(state)  # every rank reads it
    state = shard_state(state)
    res = model.layer_to_resolution[lod]
    scfg = StyleStepConfig(latent_size=mc.latent_size, scale=1.0 / (3 * res * res))
    _, intro = build_style_steps(model, scfg, lod=lod, blended=True, noise_mode=noise_mode)
    ckpt = Checkpointer(save_dir) if save_dir is not None else None
    metrics = {}
    for i in range(start_step, steps):
        # the (B, C, H, W) view of the NHWC rows, channels-last, as the trainer's feed
        x = torch.from_numpy(np.ascontiguousarray(shard_batch(xs[i]))).permute(0, 3, 1, 2)
        nz = None if nzs is None or nzs[i] is None else {
            k: torch.from_numpy(v) for k, v in nzs[i].items()}
        state, metrics = intro(state, x.to(dev), blend, nz)
        if ckpt is not None and i == start_step:
            ckpt.save(state, epoch=0, iteration=i + 1)  # rank 0 writes
    names_e = {id(p) for p in state.nets.params_e()}
    out = {"step": np.asarray(state.step)}
    moved = set()
    for k, p in state.nets.named_parameters():
        d = init[k] - p
        if moved_only and not bool(d.any()):
            continue
        moved.add(k)
        out[f"{'delta_e' if id(p) in names_e else 'delta_d'}/{k}"] = _np(d)
        if p.grad is not None:
            out[f"grad/{k}"] = _np(p.grad)
    out.update({f"ema/{k}": _np(p) for k, p in state.ema.named_parameters() if k in moved})
    out["dlatent_avg"] = _np(state.nets.dlatent_avg.buff)
    out["ema_dlatent_avg"] = _np(state.ema.dlatent_avg.buff)
    out.update({f"metric/{k}": _np(v) for k, v in metrics.items()})
    return out


def compare_gradient_trees(got: Arrays, want: Arrays, rtol: float = 1e-3,
                           keys: Optional[Sequence[str]] = None) -> float:
    """Assert per-leaf relative-L2 equality of two probe results (the JAX
    rule: f32 reduction-order noise between summation trees is ~1e-6
    relative, a broken collective O(1)); returns the worst relative L2."""
    keys = sorted(want) if keys is None else list(keys)
    assert set(keys) <= set(got), sorted(set(keys) - set(got))
    worst = 0.0
    for k in keys:
        a, b = np.asarray(got[k], np.float64), np.asarray(want[k], np.float64)
        rel = float(np.linalg.norm(a - b)) / (float(np.linalg.norm(b)) + 1e-12)
        assert rel < rtol, f"{k} diverged: relative L2 {rel:.2e}"
        worst = max(worst, rel)
    return worst


PROBES = {"sgd_gradient_probe": sgd_gradient_probe, "style_step_probe": style_step_probe,
          "encoder_bn_probe": encoder_bn_probe, "training_probe": training_probe,
          "stream_probe": stream_probe}


def _inputs(path: str, prefix: str) -> dict:
    """Arguments stored in the spec's .npz under ``<prefix>/``: arrays
    ``<prefix>/<arg>``, dicts ``<prefix>/<arg>/<key>``, lists of dicts
    ``<prefix>/<arg>/<i>/<key>``."""
    out: dict = {}
    with np.load(path) as z:
        for name in z.files:
            parts = name.split("/")
            if parts[0] != prefix:
                continue
            v = z[name]
            if len(parts) == 2:
                out[parts[1]] = v
            elif len(parts) == 3:
                out.setdefault(parts[1], {})[parts[2]] = v
            else:
                lst = out.setdefault(parts[1], {})
                lst.setdefault(int(parts[2]), {})[parts[3]] = v
    for k, v in list(out.items()):
        if isinstance(v, dict) and v and all(isinstance(i, int) for i in v):
            out[k] = [v.get(i) for i in range(max(v) + 1)]
        elif k == "weights":
            out[k] = {n: torch.from_numpy(a) for n, a in v.items()}
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="a rank of parallel/launch.py")
    p.add_argument("--spec", required=True)
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--store", required=True)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    with open(args.spec) as f:
        spec = json.load(f)
    from soft_intro_vae_torch.parallel import multihost

    device = spec.get("device", "cpu")
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    else:
        # parity runs: float32 matmuls without TF32, and the convolutions as
        # ATen's own GEMMs, not cuDNN's, which picks other algorithms for 16
        # rows than for 32: their rounding differed by up to 1.6e-3 (relative
        # L2) in the image stem's weight gradient, whose terms cancel through
        # the BatchNorm after it
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.enabled = False
    multihost.initialize_multihost(f"file://{args.store}", args.world, args.rank,
                                   backend=spec.get("backend", "auto"), device=device,
                                   local_rank=args.rank, timeout_s=spec.get("timeout_s", 60.0))
    try:
        assert current_world().size == args.world
        out = {}
        for job in spec["jobs"]:
            kwargs = dict(job.get("kwargs", {}))
            if spec.get("inputs"):
                kwargs.update(_inputs(spec["inputs"], job["name"]))
            for k in ("save_dir", "restore_dir"):
                if kwargs.get(k):
                    kwargs[k] = os.path.join(args.out, kwargs[k]) if not os.path.isabs(
                        kwargs[k]) else kwargs[k]
            res = PROBES[job["probe"]](device=device, **kwargs)
            out.update({f"{job['name']}/{k}": v for k, v in res.items()})
        np.savez(os.path.join(args.out, f"rank{args.rank}of{args.world}.npz"), **out)
    finally:
        multihost.shutdown()


if __name__ == "__main__":
    main()
