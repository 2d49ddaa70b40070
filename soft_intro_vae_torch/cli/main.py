"""Command line of the port (mirrors soft_intro_vae_tpu/cli/main.py).

All five subcommands: ``image`` and ``bootstrap`` (the reference's
soft_intro_vae/main.py and soft_intro_vae_bootstrap/main.py flags, the
latter with -o/--freq and gamma_r 1.0 by default, -f/--fid scoring the run
by FID), ``toy`` (soft_intro_vae_2d/main.py), ``threed`` and ``style``.

Devices: the port runs on CUDA unless told otherwise. ``threed`` and
``style`` take ``--device cuda|cpu``; ``image``, ``bootstrap`` and ``toy``
keep the reference's ``-c/--device`` and take ``cpu``, ``cuda``, or a CUDA
index N (``cuda:N``). Without a GPU only ``cpu`` runs.

Data parallelism: one process a card, started by torchrun, whose
environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR/MASTER_PORT) the CLI
reads to join the process group (parallel/multihost.py; NCCL on the card,
gloo for ``cpu``). The batch size is the global batch; ``--num_devices``,
when given, must equal the number of ranks:

    python -m torch.distributed.run --nproc_per_node N -m soft_intro_vae_torch.cli.main \
        image -d cifar10 --num_devices N ...

Usage:
    python -m soft_intro_vae_torch.cli.main image -d cifar10 -n 250 -z 128 -b 32 -e 256
    python -m soft_intro_vae_torch.cli.main bootstrap -d cifar10 -o 1 [-c 0]
    python -m soft_intro_vae_torch.cli.main toy -d 8Gaussians [-c cpu]
    python -m soft_intro_vae_torch.cli.main threed -c configs/soft_intro_vae_hp.json
    python -m soft_intro_vae_torch.cli.main style -c configs/ffhq256.yaml [KEY VALUE ...]
    python -m soft_intro_vae_torch.cli.main style -c configs/ffhq256.yaml \
        DATASET.PATH 'tfr/ffhq-r%02d.tfrecords.%03d' DATASET.PART_COUNT 16 DATASET.SIZE 70000
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys


def device_arg(value: str) -> str:
    """``-c/--device`` of the image subcommands: cpu, cuda, cuda:N or N."""
    if value in ("cpu", "cuda") or value.startswith("cuda:"):
        return value
    try:
        index = int(value)
    except ValueError:
        raise argparse.ArgumentTypeError(f"expected cpu, cuda or a CUDA index, got {value!r}")
    if index < 0:
        raise argparse.ArgumentTypeError(f"a CUDA index is >= 0, got {index}; pass cpu for the CPU")
    return f"cuda:{index}"


def _image_flags(p: argparse.ArgumentParser, gamma_r_default: float) -> None:
    p.add_argument("-d", "--dataset", type=str, required=True,
                   help="['cifar10', 'mnist', 'fmnist', 'svhn', 'monsters128', 'celeb128', "
                        "'celeb256', 'celeb1024']")
    p.add_argument("-n", "--num_epochs", type=int, default=250)
    p.add_argument("-z", "--z_dim", type=int, default=128)
    p.add_argument("-l", "--lr", type=float, default=2e-4)
    p.add_argument("-b", "--batch_size", type=int, default=32)
    p.add_argument("-v", "--num_vae", type=int, default=0)
    p.add_argument("-r", "--beta_rec", type=float, default=1.0)
    p.add_argument("-k", "--beta_kl", type=float, default=1.0)
    p.add_argument("-e", "--beta_neg", type=float, default=1.0)
    p.add_argument("-g", "--gamma_r", type=float, default=gamma_r_default)
    p.add_argument("-s", "--seed", type=int, default=-1)
    p.add_argument("-p", "--pretrained", type=str, default="None",
                   help="a port checkpoint or a reference .pth")
    p.add_argument("-c", "--device", type=device_arg, default="cuda",
                   help="cuda (default; fails without a GPU), cuda:N, a CUDA index N, or cpu")
    p.add_argument("-f", "--fid", action="store_true",
                   help="score the run by FID (metrics/fid.py; without the pt_inception "
                        "weights on disk, logged as fid_selfconsistent)")
    p.add_argument("--data_root", type=str, default="./data")
    p.add_argument("--result_dir", type=str, default=None)
    p.add_argument("--num_devices", type=int, default=None,
                   help="data-parallel ranks, one a card; must equal the world size: "
                        "python -m torch.distributed.run --nproc_per_node N -m "
                        "soft_intro_vae_torch.cli.main image ... --num_devices N")
    p.add_argument("--bf16", action="store_true", help="bfloat16 compute")
    p.add_argument("--scan-steps", type=int, default=1,
                   help="K train steps a call: a CUDA graph of one step replayed K times "
                        "on the card, K eager steps on the CPU")
    p.add_argument("--no-synthetic-fallback", action="store_true",
                   help="fail when the dataset files are absent instead of "
                        "substituting synthetic images")
    p.add_argument("--synthetic-n", type=int, default=2048,
                   help="synthetic-fallback dataset size (smoke runs)")


def _run_image(args, bootstrap: bool):
    from soft_intro_vae_torch.train.image import ImageConfig, train_soft_intro_vae

    cfg = ImageConfig(
        dataset=args.dataset, z_dim=args.z_dim, lr_e=args.lr, lr_d=args.lr,
        batch_size=args.batch_size, num_epochs=args.num_epochs, num_vae=args.num_vae,
        beta_kl=args.beta_kl, beta_rec=args.beta_rec, beta_neg=args.beta_neg,
        gamma_r=args.gamma_r, seed=args.seed, with_fid=args.fid,
        pretrained=None if args.pretrained == "None" else args.pretrained,
        data_root=args.data_root,
        result_dir=args.result_dir or (f"./results_{args.dataset}" + ("_bootstrap" if bootstrap else "")),
        bootstrap=bootstrap,
        copy_to_target_freq=getattr(args, "freq", 1),
        num_devices=args.num_devices,
        compute_dtype="bfloat16" if args.bf16 else "float32",
        scan_steps=args.scan_steps,
        synthetic_fallback=not args.no_synthetic_fallback,
        synthetic_n=args.synthetic_n,
        # the reference's celeb branches pass is_mirror=True (train_soft_intro_vae.py:392,404,417)
        mirror_augment=args.dataset.startswith("celeb"),
        device=args.device,
    )
    train_soft_intro_vae(cfg)


def _run_toy(args):
    from soft_intro_vae_torch.train.toy import ToyConfig, train_soft_intro_vae_toy

    scale = 1.0 if args.dataset == "8Gaussians" else 2.0
    cfg = ToyConfig(
        dataset=args.dataset, z_dim=args.z_dim, lr_e=args.lr, lr_d=args.lr,
        batch_size=args.batch_size, n_iter=args.num_iter, num_vae=args.num_vae,
        beta_kl=args.beta_kl, beta_rec=args.beta_rec, beta_neg=args.beta_neg,
        gamma_r=args.gamma_r, seed=args.seed, scale=scale, save_interval=5000, test_iter=5000,
        pretrained=None if args.pretrained == "None" else args.pretrained, device=args.device,
    )
    train_soft_intro_vae_toy(cfg)


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
    p_img = sub.add_parser("image", help="image variant (cifar10/celeb/...)")
    _image_flags(p_img, gamma_r_default=1e-8)
    p_boot = sub.add_parser("bootstrap", help="bootstrap variant (frozen target decoder)")
    _image_flags(p_boot, gamma_r_default=1.0)
    p_boot.add_argument("-o", "--freq", type=int, default=1,
                        help="epochs between decoder->target weight copies")
    p_toy = sub.add_parser("toy", help="2D toy variant")
    p_toy.add_argument("-d", "--dataset", type=str, required=True,
                       help="['8Gaussians', '2spirals', 'checkerboard', 'rings']")
    p_toy.add_argument("-n", "--num_iter", type=int, default=30000)
    p_toy.add_argument("-z", "--z_dim", type=int, default=2)
    p_toy.add_argument("-l", "--lr", type=float, default=2e-4)
    p_toy.add_argument("-b", "--batch_size", type=int, default=512)
    p_toy.add_argument("-v", "--num_vae", type=int, default=2000)
    p_toy.add_argument("-r", "--beta_rec", type=float, default=0.2)
    p_toy.add_argument("-k", "--beta_kl", type=float, default=0.3)
    p_toy.add_argument("-e", "--beta_neg", type=float, default=0.9)
    p_toy.add_argument("-g", "--gamma_r", type=float, default=1e-8)
    p_toy.add_argument("-s", "--seed", type=int, default=-1)
    p_toy.add_argument("-p", "--pretrained", type=str, default="None",
                       help="a port checkpoint or a reference .pth")
    p_toy.add_argument("-c", "--device", type=device_arg, default="cuda",
                       help="cuda (default; fails without a GPU), cuda:N, a CUDA index N, or cpu")
    p_3d = sub.add_parser("threed", help="3D point-cloud variant")
    p_3d.add_argument("-c", "--config", type=str, default=None, help="JSON config path")
    p_3d.add_argument("--device", type=str, default="cuda",
                      help="cuda (default; fails without a GPU) or cpu")
    # the reference's train_style_soft_intro_vae.py / launcher.py surface:
    # -c <yaml> plus trailing KEY VALUE pairs merged into the config
    p_style = sub.add_parser(
        "style", help="progressive style variant (YAML config)",
        epilog="Train from per-LOD TFRecord shards (soft-intro-vae-torch-prepare-tfrecords "
               "create -o DIR --name ffhq --parts 2) with a DATASET.PATH of two %-fields, "
               "the level and the part: DATASET.PATH 'DIR/ffhq-r%02d.tfrecords.%03d' "
               "DATASET.PART_COUNT 2 DATASET.SIZE N.")
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
    import torch.distributed as dist

    from soft_intro_vae_torch.parallel import multihost

    joined = "WORLD_SIZE" in os.environ and not dist.is_initialized()
    if joined and args.command == "toy":
        raise SystemExit("the 2D toy trainer runs in one process, with no data parallelism")
    if joined:  # a rank started by torchrun
        multihost.initialize_multihost(device=getattr(args, "device", "cuda"))
    try:
        _run(args)
    finally:
        if joined:
            multihost.shutdown()


def _run(args):
    if args.command in ("image", "bootstrap"):
        _run_image(args, bootstrap=args.command == "bootstrap")
    elif args.command == "toy":
        _run_toy(args)
    elif args.command == "threed":
        _run_threed(args)
    elif args.command == "style":
        _run_style(args)
    else:
        raise SystemExit(f"unknown command {args.command}")


if __name__ == "__main__":
    main(sys.argv[1:])
