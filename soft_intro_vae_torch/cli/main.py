"""Command line of the port (mirrors soft_intro_vae_tpu/cli/main.py).

The ``threed`` and ``style`` subcommands are ported so far; the others
follow the slices of ROADMAP.md.

Usage:
    python -m soft_intro_vae_torch.cli.main threed -c configs/soft_intro_vae_hp.json
    python -m soft_intro_vae_torch.cli.main style -c configs/ffhq256.yaml [KEY VALUE ...]
"""

from __future__ import annotations

import argparse
import dataclasses
import sys


def _run_threed(args):
    from soft_intro_vae_torch.train.threed import ThreeDConfig, train_soft_intro_vae_3d

    cfg = ThreeDConfig.from_json(args.config) if args.config else ThreeDConfig()
    train_soft_intro_vae_3d(dataclasses.replace(cfg, device=args.device))


def _run_style(args):
    from soft_intro_vae_torch.train.style import StyleConfig, train_style_soft_intro_vae

    cfg = StyleConfig.from_yaml(args.config_file, overrides=args.opts)
    train_style_soft_intro_vae(dataclasses.replace(cfg, device=args.device))


def build_parser() -> argparse.ArgumentParser:
    root = argparse.ArgumentParser(prog="soft-intro-vae-torch",
                                   description="train Soft-IntroVAE (PyTorch/CUDA port)")
    sub = root.add_subparsers(dest="command", required=True)
    p_3d = sub.add_parser("threed", help="3D point-cloud variant")
    p_3d.add_argument("-c", "--config", type=str, default=None, help="JSON config path")
    p_3d.add_argument("--device", type=str, default="cuda",
                      help="cuda (default; fails without a GPU) or cpu")
    # the reference's train_style_soft_intro_vae.py / launcher.py surface:
    # -c <yaml> plus trailing KEY VALUE pairs merged into the config
    p_style = sub.add_parser("style", help="progressive style variant (YAML config)")
    p_style.add_argument("-c", "--config-file", type=str, default="configs/ffhq256.yaml",
                         metavar="FILE", help="path to YAML config file")
    p_style.add_argument("--device", type=str, default="cuda",
                         help="cuda (default; fails without a GPU) or cpu")
    p_style.add_argument("opts", nargs=argparse.REMAINDER, default=[],
                         help="config overrides as KEY VALUE pairs "
                              "(e.g. TRAIN.TRAIN_EPOCHS 5 DATASET.SYNTHETIC true)")
    return root


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.command == "threed":
        _run_threed(args)
    elif args.command == "style":
        _run_style(args)
    else:
        raise SystemExit(f"unknown command {args.command}")


if __name__ == "__main__":
    main(sys.argv[1:])
