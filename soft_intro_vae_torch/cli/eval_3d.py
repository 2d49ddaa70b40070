"""3D evaluation tools (port of cli/eval_3d.py), on the card by default.

Capability parity with the reference's 3D evaluation scripts:
  * ``test_jsd``  — soft_intro_vae_3d/test_model.py:41-93 (test-split JSD,
    3 trials of 3x samples, averaged)
  * ``find_best_epoch`` — evaluation/find_best_epoch_on_validation_soft.py:26-148
    (sweep every epoch checkpoint for minimum validation JSD)
  * ``generate_data_for_metrics`` — evaluation/generate_data_for_metrics.py:25-92
    (dump X / X_generated / X_reconstructed .npy for external metric suites)
  * ``generate_for_rendering`` — generate_for_rendering.py:19-119 (samples +
    latent interpolations as .npy for offline renderers)

The nets are the port's (``train/threed.py build_3d_training``), loaded from
its checkpoints or a reference ``.pth`` (``utils/checkpoint.py
load_pretrained``), and run on ``cfg.device``. The prior draws come from a
``torch.Generator`` on that device seeded as the JAX module seeds its keys
(777 + trial for the JSD trials, 123 for the metric dump, 7 for rendering).
So the noise differs from the JAX package's; every function takes it
injected, and on the same noise the results agree (ROADMAP Queue 3).

Usage: python -m soft_intro_vae_torch.cli.eval_3d <subcommand> ... [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from soft_intro_vae_torch.data.shapenet import ShapeNetDataset, SyntheticClouds
from soft_intro_vae_torch.metrics.jsd import jsd_between_point_cloud_sets
from soft_intro_vae_torch.train.state import TrainState
from soft_intro_vae_torch.train.threed import ThreeDConfig, build_3d_training
from soft_intro_vae_torch.utils.checkpoint import load_pretrained


def load_state(cfg: ThreeDConfig, ckpt_path: Optional[str] = None) -> Tuple[TrainState, int]:
    """The 3D nets of ``cfg`` on its device, restored from ``ckpt_path``
    when given; returns (state, epoch)."""
    state = build_3d_training(cfg)[0]
    epoch = load_pretrained(ckpt_path, state) if ckpt_path else 0
    return state, epoch


def _points(cfg: ThreeDConfig, split: str) -> np.ndarray:
    if cfg.use_synthetic:
        return SyntheticClouds(max(cfg.synthetic_n // 8, 8), cfg.n_points,
                               seed={"valid": 1, "test": 2}.get(split, 0)).load_all()[0]
    return ShapeNetDataset(cfg.data_dir, cfg.classes, split).load_all()[0]


def prior_noise(cfg: ThreeDConfig, n: int, seed: int, device) -> torch.Tensor:
    """``prior_std`` * N(0, 1) of shape (n, z_size) from a generator seeded ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return cfg.prior_std * torch.randn((n, cfg.z_size), generator=gen, device=device)


@torch.no_grad()
def decode(state: TrainState, z) -> np.ndarray:
    """Point clouds (B, N, 3) of latents ``z`` (array or tensor), on the host."""
    z = torch.as_tensor(z, dtype=torch.float32, device=state.device)
    return state.decoder(z).float().cpu().numpy()


@torch.no_grad()
def encode_mean(state: TrainState, points: np.ndarray) -> torch.Tensor:
    """The encoder's mean in eval mode (BN running statistics)."""
    state.model.eval()
    try:
        return state.encoder(torch.as_tensor(points, device=state.device))[0]
    finally:
        state.model.train()


def jsd_vs_samples(state: TrainState, ref_points: np.ndarray, cfg: ThreeDConfig,
                   trials: int = 3, mult: int = 3, seed: int = 777,
                   noises: Optional[Sequence] = None) -> float:
    """Mean JSD of ``trials`` sets of ``mult`` x len(ref) samples against the
    reference clouds; ``noises`` injects each trial's latents."""
    n = ref_points.shape[0]
    vals = []
    for t in range(trials):
        noise = (noises[t] if noises is not None
                 else prior_noise(cfg, mult * n, seed + t, state.device))
        vals.append(jsd_between_point_cloud_sets(decode(state, noise), ref_points, voxels=28))
    return float(np.mean(vals))


def test_jsd(cfg: ThreeDConfig, ckpt_path: str, noises: Optional[Sequence] = None) -> float:
    """Test-split JSD of a trained checkpoint (test_model.py parity)."""
    state, _ = load_state(cfg, ckpt_path)
    return jsd_vs_samples(state, _points(cfg, "test"), cfg, noises=noises)


def find_best_epoch(cfg: ThreeDConfig, weights_dir: Optional[str] = None,
                    noises: Optional[Sequence] = None) -> Tuple[str, float]:
    """Sweep all checkpoints under weights_dir for minimum validation JSD."""
    weights_dir = weights_dir or os.path.join(cfg.results_dir, "weights")
    paths = sorted(
        os.path.join(weights_dir, f) for f in os.listdir(weights_dir) if f.endswith(".ckpt")
    )
    if not paths:
        raise FileNotFoundError(f"no checkpoints under {weights_dir}")
    valid = _points(cfg, "valid")
    state, _ = load_state(cfg)
    best: Tuple[Optional[str], float] = (None, float("inf"))
    for p in paths:
        epoch = load_pretrained(p, state)
        jsd = jsd_vs_samples(state, valid, cfg, noises=noises)
        print(f"{os.path.basename(p)} (epoch {epoch}): jsd {jsd:.4f}")
        if jsd < best[1]:
            best = (p, jsd)
    assert best[0] is not None
    return best


def generate_data_for_metrics(cfg: ThreeDConfig, ckpt_path: str, out_dir: str,
                              split: str = "test", noise=None) -> List[str]:
    """Dump X.npy (real), Xg.npy (samples), Xrec.npy (reconstructions)."""
    state, _ = load_state(cfg, ckpt_path)
    x = _points(cfg, split)
    x_rec = decode(state, encode_mean(state, x))
    if noise is None:
        noise = prior_noise(cfg, x.shape[0], 123, state.device)
    x_g = decode(state, noise)
    os.makedirs(out_dir, exist_ok=True)
    out = []
    for name, arr in [("X", x), ("Xg", x_g), ("Xrec", x_rec)]:
        p = os.path.join(out_dir, f"{name}.npy")
        np.save(p, arr)
        out.append(p)
    return out


def generate_for_rendering(cfg: ThreeDConfig, ckpt_path: str, out_dir: str,
                           num_samples: int = 10, num_interp: int = 5,
                           z=None, z_ends=None) -> List[str]:
    """Samples + latent interpolations as .npy (generate_for_rendering.py);
    ``z`` (num_samples latents) and ``z_ends`` (2) inject the draws."""
    state, _ = load_state(cfg, ckpt_path)
    if z is None or z_ends is None:
        drawn = prior_noise(cfg, num_samples + 2, 7, state.device)
        z = drawn[:num_samples] if z is None else z
        z_ends = drawn[num_samples:] if z_ends is None else z_ends
    za = torch.as_tensor(z_ends, dtype=torch.float32, device=state.device)
    alphas = torch.linspace(0.0, 1.0, num_interp, device=state.device)[:, None]
    z_interp = za[0][None] * (1 - alphas) + za[1][None] * alphas
    samples, interp = decode(state, z), decode(state, z_interp)
    os.makedirs(out_dir, exist_ok=True)
    p1 = os.path.join(out_dir, "samples.npy")
    p2 = os.path.join(out_dir, "interpolation.npy")
    np.save(p1, samples)
    np.save(p2, interp)
    return [p1, p2]


def main(argv=None):
    ap = argparse.ArgumentParser(prog="eval-3d")
    sub = ap.add_subparsers(dest="command", required=True)
    for name in ("test-jsd", "find-best-epoch", "dump-metrics-data", "render-data"):
        p = sub.add_parser(name)
        p.add_argument("-c", "--config", type=str, default=None, help="JSON config path")
        p.add_argument("--device", type=str, default="cuda",
                       help="cuda (default; fails without a GPU) or cpu")
        if name != "find-best-epoch":
            p.add_argument("-m", "--model", type=str, required=True, help="checkpoint path")
        if name in ("dump-metrics-data", "render-data"):
            p.add_argument("-o", "--out", type=str, required=True)
    p_xml = sub.add_parser("render-xml", help="npy/npz/ply -> Mitsuba XML scenes "
                                              "(render_mitsuba2_pc.py parity)")
    p_xml.add_argument("-i", "--input", type=str, required=True)
    p_xml.add_argument("-o", "--out", type=str, default=None)
    p_xml.add_argument("--points", type=int, default=2048)
    p_xml.add_argument("--mitsuba", type=str, default=None, help="mitsuba binary (optional)")
    args = ap.parse_args(argv)
    if args.command == "render-xml":
        from soft_intro_vae_torch.utils.mitsuba import render_pointclouds

        print("\n".join(render_pointclouds(args.input, args.out, args.points, args.mitsuba)))
        return
    cfg = ThreeDConfig.from_json(args.config) if args.config else ThreeDConfig()
    cfg = dataclasses.replace(cfg, device=args.device)
    if args.command == "test-jsd":
        print(f"test jsd: {test_jsd(cfg, args.model):.4f}")
    elif args.command == "find-best-epoch":
        path, jsd = find_best_epoch(cfg)
        print(f"best: {path} (jsd {jsd:.4f})")
    elif args.command == "dump-metrics-data":
        print("\n".join(generate_data_for_metrics(cfg, args.model, args.out)))
    elif args.command == "render-data":
        print("\n".join(generate_for_rendering(cfg, args.model, args.out)))


if __name__ == "__main__":
    main()
