"""Command line of the port (mirrors soft_intro_vae_tpu/cli/main.py).

Only the ``threed`` subcommand is ported so far; the others follow the
slices of ROADMAP.md.

Usage:  python -m soft_intro_vae_torch.cli.main threed -c configs/soft_intro_vae_hp.json
"""

from __future__ import annotations

import argparse
import dataclasses
import sys


def _run_threed(args):
    from soft_intro_vae_torch.train.threed import ThreeDConfig, train_soft_intro_vae_3d

    cfg = ThreeDConfig.from_json(args.config) if args.config else ThreeDConfig()
    train_soft_intro_vae_3d(dataclasses.replace(cfg, device=args.device))


def build_parser() -> argparse.ArgumentParser:
    root = argparse.ArgumentParser(prog="soft-intro-vae-torch",
                                   description="train Soft-IntroVAE (PyTorch/CUDA port)")
    sub = root.add_subparsers(dest="command", required=True)
    p_3d = sub.add_parser("threed", help="3D point-cloud variant")
    p_3d.add_argument("-c", "--config", type=str, default=None, help="JSON config path")
    p_3d.add_argument("--device", type=str, default="cuda",
                      help="cuda (default; fails without a GPU) or cpu")
    return root


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.command == "threed":
        _run_threed(args)
    else:
        raise SystemExit(f"unknown command {args.command}")


if __name__ == "__main__":
    main(sys.argv[1:])
