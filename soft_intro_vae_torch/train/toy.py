"""2D toy trainer (port of train/toy.py).

Reference: train_soft_intro_vae_toy (soft_intro_vae_2d/
train_soft_intro_vae_2d.py:486-725): an iteration loop with a vanilla-VAE
warm-up for ``num_vae`` iterations, then introspective E/D steps at
dim_scale 0.5 (:515); MultiStepLR milestones (10000, 15000), gamma 0.1,
stepped every iteration (:510-512, 659-660); the NaN abort (:656-658); the
final gnELBO, sample KL and JSD appended to a results log (:703-724).

The step is the port's generic step (train/step.py), eager, one iteration a
call: the JAX toy trainer has no ``scan_steps``. Metrics are fetched at the
``test_iter`` cadence only. Plot and metric samples come from generators of
their own, seeded from the run's seed, so they never move the training draws
(the JAX trainer folds them out of ``state.rng``).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from soft_intro_vae_torch.data.toy import ToyDataset
from soft_intro_vae_torch.metrics.toy import grid_normalized_elbo, sample_kl_2d, setup_grid
from soft_intro_vae_torch.models.mlp import SoftIntroVAESimple
from soft_intro_vae_torch.ops.losses import reconstruction_loss
from soft_intro_vae_torch.train import optim
from soft_intro_vae_torch.train.state import TrainState
from soft_intro_vae_torch.train.step import StepConfig, build_train_steps
from soft_intro_vae_torch.utils.checkpoint import Checkpointer, load_pretrained
from soft_intro_vae_torch.utils.device import resolve_device

LR_MILESTONES = (10000, 15000)


@dataclasses.dataclass
class ToyConfig:
    """The JAX package's ToyConfig, plus ``device`` and ``pretrained``."""

    dataset: str = "8Gaussians"
    z_dim: int = 2
    lr_e: float = 2e-4
    lr_d: float = 2e-4
    batch_size: int = 32
    n_iter: int = 30000
    num_vae: int = 0
    recon_loss_type: str = "mse"
    beta_kl: float = 1.0
    beta_rec: float = 1.0
    beta_neg: float = 1.0
    gamma_r: float = 1e-8
    test_iter: int = 5000
    save_interval: int = 5000
    seed: int = -1
    scale: float = 1.0          # plot and metric half-range multiplier
    n_layers: int = 3
    num_hidden: int = 256
    result_dir: str = "./results_toy"
    save_checkpoints: bool = False
    save_figures: bool = False
    verbose: bool = True
    device: str = "cuda"        # port: where the nets and the batches live
    # port: a port checkpoint or a reference .pth to start from (the
    # reference 2D main.py's -p); None starts from the seed's init
    pretrained: Optional[str] = None


def build_toy(cfg: ToyConfig):
    """Returns ``(state, vanilla_step, intro_step)`` on ``cfg.device``."""
    device = resolve_device(cfg.device)
    seed = cfg.seed if cfg.seed != -1 else int(time.time()) % (2**31)
    # the nets are made from the seed without touching the global RNG
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = SoftIntroVAESimple(x_dim=2, z_dim=cfg.z_dim, n_layers=cfg.n_layers,
                                   num_hidden=cfg.num_hidden)
    state = TrainState.create(model, device=device, seed=seed + 1, lr_e=cfg.lr_e, lr_d=cfg.lr_d)
    step_cfg = StepConfig(z_dim=cfg.z_dim, beta_rec=cfg.beta_rec, beta_kl=cfg.beta_kl,
                          beta_neg=cfg.beta_neg, gamma_r=cfg.gamma_r,
                          scale=0.5,  # dim_scale, reference :515
                          loss_type=cfg.recon_loss_type)
    vanilla_step, intro_step = build_train_steps(cfg=step_cfg)
    return state, vanilla_step, intro_step


def det_fwd(state: TrainState):
    """The deterministic forward ``x -> (mu, logvar, decoder(mu))``."""

    def fwd(x):
        mu, logvar = state.encoder(x)
        return mu, logvar, state.decoder(mu)

    return fwd


@torch.no_grad()
def sample(state: TrainState, n: int, z_dim: int, seed: int) -> np.ndarray:
    """``n`` decoder samples from a generator of their own, seeded with ``seed``."""
    gen = torch.Generator(device=state.device)
    gen.manual_seed(seed)
    z = torch.randn((n, z_dim), generator=gen, device=state.device)
    return state.decoder(z).cpu().numpy()


def train_soft_intro_vae_toy(cfg: ToyConfig, sampler: Optional[ToyDataset] = None):
    """Run the toy recipe; returns (state, results dict)."""
    resolve_device(cfg.device)  # fail before building anything
    if sampler is None:
        sampler = ToyDataset(distr=cfg.dataset, seed=max(cfg.seed, 0))
    scale = cfg.scale * sampler.range

    state, vanilla_step, intro_step = build_toy(cfg)
    if cfg.pretrained:
        load_pretrained(cfg.pretrained, state)
    fwd = det_fwd(state)
    base_seed = state.generator.initial_seed()
    lr_sched_e = optim.multistep_lr(cfg.lr_e, LR_MILESTONES, 0.1)
    lr_sched_d = optim.multistep_lr(cfg.lr_d, LR_MILESTONES, 0.1)
    ckpt = Checkpointer(os.path.join(cfg.result_dir, "saves")) if cfg.save_checkpoints else None

    start = time.time()
    for it in range(cfg.n_iter):
        batch = torch.from_numpy(sampler.next_batch(batch_size=cfg.batch_size)).to(state.device)
        step_fn = vanilla_step if it < cfg.num_vae else intro_step
        state, metrics = step_fn(state, batch)
        state.set_lr(lr_sched_e(it + 1), lr_sched_d(it + 1))  # per iteration (:659-660)
        if it % cfg.test_iter == 0 or it == cfg.n_iter - 1:
            host = {k: float(v) for k, v in metrics.items()}
            if any(np.isnan(v) for v in host.values()):
                raise SystemError("loss is NaN.")
            # the deterministic reconstruction error, for the log only (the
            # reference computes it every iteration, :573-578)
            with torch.no_grad():
                host["rec_det"] = float(reconstruction_loss(batch, fwd(batch)[2],
                                                            cfg.recon_loss_type, "mean"))
            if cfg.verbose:
                keys = ", ".join(f"{k}: {v:.4f}" for k, v in host.items())
                print(f"Iter {it}/{cfg.n_iter} time {time.time() - start:.1f}s: {keys}")
            if cfg.save_figures and (it > 0 or it == cfg.n_iter - 1):
                from soft_intro_vae_torch.utils.plotting import save_scatter_2d

                fakes = sample(state, 1024, cfg.z_dim, base_seed + 10**7 + it)
                name = (f"{cfg.dataset}_bkl_{cfg.beta_kl}_bneg_{cfg.beta_neg}"
                        f"_brec_{cfg.beta_rec}_seed_{cfg.seed}_iter_{it}.png")
                save_scatter_2d(fakes, os.path.join(cfg.result_dir, name), lim=scale * 2)
        if ckpt is not None and it > 0 and it % cfg.save_interval == 0:
            ckpt.save(state, epoch=it, iteration=it)

    # the final quantitative metrics (reference :703-724)
    def sample_np(n):  # the same draws for the KL and the JSD
        return sample(state, n, cfg.z_dim, base_seed + 10**6)

    if cfg.save_figures:
        from soft_intro_vae_torch.metrics.toy import vae_density
        from soft_intro_vae_torch.utils.plotting import save_density_2d, save_scatter_2d

        real = np.asarray(sampler.next_batch(batch_size=1024))
        save_scatter_2d(real, os.path.join(cfg.result_dir, f"{cfg.dataset}_real.png"),
                        lim=scale * 2, color="C0")
        dens = vae_density(fwd, setup_grid(range_lim=scale * 2, n_pts=1024), device=state.device)
        save_density_2d(dens, 1024, os.path.join(cfg.result_dir, f"density_{cfg.dataset}.png"))

    res = {}
    res["sample_kl"] = sample_kl_2d(sample_np, sampler, num_samples=5000, hist_bins=100,
                                    use_jsd=False, xy_range=(-2 * scale, 2 * scale))
    res["jsd"] = sample_kl_2d(sample_np, sampler, num_samples=5000, hist_bins=100,
                              use_jsd=True, xy_range=(-2 * scale, 2 * scale))
    grid = setup_grid(range_lim=scale * 2, n_pts=1024)
    res["gn_elbo"] = grid_normalized_elbo(fwd, sampler, grid, beta_kl=1.0, beta_rec=1.0,
                                          batch_size=128, device=state.device)

    os.makedirs(cfg.result_dir, exist_ok=True)
    with open(os.path.join(cfg.result_dir, "results_log_soft_intro_vae.txt"), "a") as fp:
        fp.write(
            f"{cfg.dataset}_beta_kl_{cfg.beta_kl}_beta_neg_{cfg.beta_neg}_beta_rec_{cfg.beta_rec}"
            f"_gnelbo_{res['gn_elbo']}_kl_{res['sample_kl']}_jsd_{res['jsd']}_seed_{cfg.seed}\n")
    if cfg.verbose:
        print(f"gn_elbo: {res['gn_elbo']:.4e}, kl: {res['sample_kl']:.4f}, jsd: {res['jsd']:.4f}")
    return state, res
