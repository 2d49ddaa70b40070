"""Figures of a style checkpoint (port of cli/figures.py).

The reference's style_soft_intro_vae/make_figures/* and
style_mixing/stylemix_sandwich.py: sample grids, reconstructions,
latent interpolation, style-mixing grids, the multi-resolution and paged
reconstruction pages and the two-image interpolation, from a port style
checkpoint (``utils/checkpoint.py load_pretrained``), the EMA nets by
default.

Each figure is computed as an array first, (N, H, W, 3) images or a canvas
in [0, 1], by a function that takes the model, the state and its inputs
(``sample_images``, ``reconstruction_images``, ...); writing it is a
separate step. The latents and the decoder's noise come from seeded
``torch.Generator``s on the state's device (the JAX package draws them with
``jax.random`` keys of the same seeds); the array functions take injected
latents (``z``) as well. The folder figures read images with PIL
(``load_sample_images``) and take arrays otherwise.

Writing needs matplotlib, and the folder figures PIL. Without them the CLI
raises an error naming the package: it never exits 0 having written nothing.

Usage: python -m soft_intro_vae_torch.cli.figures <subcommand> --yaml cfg.yaml -m ckpt -o out
       [--device cuda|cpu] ...
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import os
import random
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from soft_intro_vae_torch.train.style import StyleConfig, build_style_training
from soft_intro_vae_torch.train.style_step import StyleModel, StyleNets, StyleTrainState
from soft_intro_vae_torch.utils.checkpoint import load_pretrained

Tensor = torch.Tensor
KINDS = ("samples", "recon", "interpolation", "stylemix", "recon-multires", "recon-paged",
         "interpolation-images")
FOLDER_KINDS = ("recon-multires", "recon-paged", "interpolation-images")


def require(package: str, what: str) -> None:
    """Raise unless ``package`` can be imported: ``what`` needs it."""
    if importlib.util.find_spec(package) is None:
        raise ImportError(f"{what} needs the {package!r} package, which is not installed")


def load_model(cfg: StyleConfig, ckpt_path: str) -> Tuple[StyleModel, StyleTrainState]:
    """The model of ``cfg`` and a state holding the checkpoint ``ckpt_path``."""
    model, state = build_style_training(cfg)
    load_pretrained(ckpt_path, state)
    return model, state


def _nets(state: StyleTrainState, use_ema: bool) -> StyleNets:
    return state.ema if use_ema else state.nets


def _generator(state: StyleTrainState, seed: int) -> torch.Generator:
    gen = torch.Generator(device=state.device)
    gen.manual_seed(seed)
    return gen


def _latents(state: StyleTrainState, shape, seed: int) -> Tensor:
    return torch.randn(shape, generator=_generator(state, seed), device=state.device)


def to01(x: Tensor) -> np.ndarray:
    """(B, C, H, W) in [-1, 1] -> (B, H, W, C) in [0, 1]."""
    return np.clip(x.permute(0, 2, 3, 1).float().cpu().numpy() * 0.5 + 0.5, 0, 1)


def _top_lod(model: StyleModel) -> int:
    return model.mc.layer_count - 1


def _as_input(state: StyleTrainState, x: np.ndarray) -> Tensor:
    """(B, H, W, C) f32 in [-1, 1] -> (B, C, H, W) on the state's device."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32).transpose(0, 3, 1, 2))
                            ).to(state.device)


@torch.no_grad()
def sample_images(model: StyleModel, state: StyleTrainState, count: int = 32, seed: int = 0,
                  use_ema: bool = True, truncation: bool = True,
                  z: Optional[Tensor] = None) -> np.ndarray:
    """make_figures/generate_samples.py: ``count`` samples, truncated; z from
    ``seed`` (or ``z``), the decoder's noise from ``seed + 1``."""
    if z is None:
        z = _latents(state, (count, model.mc.latent_size), seed)
    rec = model.generate(_nets(state, use_ema), _generator(state, seed + 1), _top_lod(model),
                         None, z.to(state.device), mixing=False, truncation=truncation,
                         update_avg=False)
    return to01(rec)


@torch.no_grad()
def reconstruction_images(model: StyleModel, state: StyleTrainState, x: np.ndarray,
                          use_ema: bool = True) -> np.ndarray:
    """make_recon_figure_*: the reals (NHWC in [-1, 1]) above their
    reconstructions from z = mu, the decoder's noise from seed 1."""
    nets, lod = _nets(state, use_ema), _top_lod(model)
    xt = _as_input(state, x)
    eps = torch.zeros((xt.shape[0], model.mc.latent_size), device=state.device)
    _, mu, _ = model.encode(nets, xt, lod, None, eps)
    rec = model.generate(nets, _generator(state, 1), lod, None, mu, mixing=False,
                         truncation=False, update_avg=False)
    return np.concatenate([to01(xt), to01(rec)], axis=0)


@torch.no_grad()
def interpolation_images(model: StyleModel, state: StyleTrainState, steps: int = 8,
                         seed: int = 0, use_ema: bool = True,
                         z: Optional[Tensor] = None) -> np.ndarray:
    """make_recon_figure_interpolation: the z-space lerp between two
    latents (``z``: (2, latent), else drawn from ``seed``) in ``steps``."""
    if z is None:
        z = _latents(state, (2, model.mc.latent_size), seed)
    z = z.to(state.device)
    alphas = torch.linspace(0.0, 1.0, steps, device=state.device)[:, None]
    zs = z[0][None] * (1 - alphas) + z[1][None] * alphas
    rec = model.generate(_nets(state, use_ema), _generator(state, seed + 1), _top_lod(model),
                         None, zs, mixing=False, truncation=False, update_avg=False)
    return to01(rec)


def _decode(nets: StyleNets, styles: Tensor, lod: int, gen: torch.Generator) -> Tensor:
    return nets.decoder(styles, lod, None, "batch", gen)


def _broadcast(s: Tensor, num_layers: int) -> Tensor:
    return s[:, None, :].expand(-1, num_layers, -1)


@torch.no_grad()
def style_mixing_images(model: StyleModel, state: StyleTrainState, n_src: int = 4,
                        n_dst: int = 4, crossover: Optional[int] = None, seed: int = 0,
                        use_ema: bool = True, z_src: Optional[Tensor] = None,
                        z_dst: Optional[Tensor] = None) -> np.ndarray:
    """stylemix_sandwich.py: a header row of the sources, then one row per
    destination whose layers below ``crossover`` take the destination's
    style and the rest the source's. Every decode draws its noise from
    ``seed + 2`` afresh, as the JAX figure reuses one key."""
    nets, lod, nl = _nets(state, use_ema), _top_lod(model), model.num_layers
    crossover = crossover if crossover is not None else nl // 2
    if z_src is None or z_dst is None:
        gen = _generator(state, seed)
        z_src = torch.randn((n_src, model.mc.latent_size), generator=gen, device=state.device)
        z_dst = torch.randn((n_dst, model.mc.latent_size), generator=gen, device=state.device)
    s_src = nets.mapping_fl(z_src.to(state.device))[:, 0]
    s_dst = nets.mapping_fl(z_dst.to(state.device))[:, 0]
    layer_idx = torch.arange(nl, device=state.device)[None, :, None]
    rows = [to01(_decode(nets, _broadcast(s_src, nl), lod, _generator(state, seed + 2)))]
    for j in range(s_dst.shape[0]):
        dst = s_dst[j][None, None, :].expand(s_src.shape[0], nl, -1)
        mixed = torch.where(layer_idx < crossover, dst, _broadcast(s_src, nl))
        rows.append(to01(_decode(nets, mixed, lod, _generator(state, seed + 2))))
    return np.concatenate(rows, axis=0)


def reduce_sample_image(img: np.ndarray, im_size: int, name: str = "image") -> np.ndarray:
    """An (H, W), (H, W, 3) or (H, W, 4) uint8 image -> (im_size, im_size, 3)
    f32 in [-1, 1]: alpha dropped, /127.5 - 1, an integer-factor average pool
    (make_recon_figure_paged.py:143-156)."""
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    img = img[:, :, :3].astype(np.float32) / 127.5 - 1.0
    factor = img.shape[0] // im_size
    if factor > 1:
        h = (img.shape[0] // factor) * factor
        w = (img.shape[1] // factor) * factor
        img = img[:h, :w].reshape(h // factor, factor, w // factor, factor, 3).mean(axis=(1, 3))
    if img.shape[:2] != (im_size, im_size):
        raise ValueError(f"{name}: {img.shape} does not reduce to {im_size}")
    return img


def sample_names(samples_dir: str, shuffle_seed: Optional[int] = None) -> List[str]:
    """The folder's file names, sorted, then shuffled by ``shuffle_seed``."""
    names = sorted(os.listdir(samples_dir))
    if shuffle_seed is not None:
        random.Random(shuffle_seed).shuffle(names)
    return names


def load_sample_images(samples_dir: str, im_size: int, names: Optional[Sequence[str]] = None,
                       shuffle_seed: Optional[int] = None) -> np.ndarray:
    """A folder of images -> (N, im_size, im_size, 3) f32 in [-1, 1]; needs PIL."""
    require("PIL", "reading the sample images")
    from PIL import Image

    if names is None:
        names = sample_names(samples_dir, shuffle_seed)
    return np.stack([reduce_sample_image(np.asarray(Image.open(os.path.join(samples_dir, n))),
                                         im_size, n) for n in names])


@torch.no_grad()
def encode_styles(model: StyleModel, state: StyleTrainState, x: np.ndarray, lod: int,
                  use_ema: bool = True) -> Tensor:
    """Reals -> their (B, num_layers, latent) styles, z = mu
    (make_recon_figure_multires.py:126-129)."""
    nets = _nets(state, use_ema)
    xt = _as_input(state, x)
    eps = torch.zeros((xt.shape[0], model.mc.latent_size), device=state.device)
    _, mu, _ = model.encode(nets, xt, lod, None, eps)
    return nets.mapping_fl(mu)


@torch.no_grad()
def decode_styles(model: StyleModel, state: StyleTrainState, styles: Tensor, lod: int,
                  seed: int = 0, use_ema: bool = True) -> np.ndarray:
    """Styles -> images (B, H, W, C) in [-1, 1], the noise from ``seed``."""
    img = _decode(_nets(state, use_ema), styles, lod, _generator(state, seed))
    return img.permute(0, 2, 3, 1).float().cpu().numpy()


def _resize_half(img: np.ndarray) -> np.ndarray:
    h, w, _ = img.shape
    return img.reshape(h // 2, 2, w // 2, 2, 3).mean(axis=(1, 3))


def multires_canvas(model: StyleModel, state: StyleTrainState, x: np.ndarray,
                    use_ema: bool = True) -> np.ndarray:
    """make_recon_figure_multires.py: 4 column groups, each a full-resolution
    [real | recon] pair above a 2x2 grid of half-resolution pairs
    (lods_down=1, padding_step=4, layout at :188-250); ``x``: up to 20 reals."""
    lod = _top_lod(model)
    im_size = model.layer_to_resolution[lod]
    rec = decode_styles(model, state, encode_styles(model, state, x, lod, use_ema), lod,
                        use_ema=use_ema)
    pad0, step = 8, 4  # current_padding after the reference's sizing loop
    width = 2 * im_size + 4 + 10
    height = 2 * im_size + 4 + 20

    def make_part(imgs):  # (real, recon) HWC pairs, at most 5
        canvas = np.ones((height, width, 3), np.float32)

        def place(img, px, py):
            canvas[py: py + img.shape[0], px: px + img.shape[1]] = np.clip(img * 0.5 + 0.5, 0, 1)

        it = iter(imgs)
        try:
            a, b = next(it)
            place(a, pad0, 0)
            place(b, pad0 + im_size, 0)
            half = im_size // 2
            for xx in range(2):
                for yy in range(2):
                    a, b = next(it)
                    place(_resize_half(a), step + xx * (2 * half + step),
                          im_size + 2 * pad0 + yy * (half + step))
                    place(_resize_half(b), step + half + xx * (2 * half + step),
                          im_size + 2 * pad0 + yy * (half + step))
        except StopIteration:
            pass
        return canvas

    pairs = list(zip(np.asarray(x, np.float32), rec))
    return np.concatenate([make_part(pairs[i::4]) for i in range(4)], axis=1)


def paged_cells(model: StyleModel, state: StyleTrainState, x: np.ndarray,
                use_ema: bool = True) -> np.ndarray:
    """make_recon_figure_paged.py: one page's [real | recon] cells side by side."""
    lod = _top_lod(model)
    rec = decode_styles(model, state, encode_styles(model, state, x, lod, use_ema), lod,
                        use_ema=use_ema)
    to_unit = lambda a: np.clip(np.asarray(a, np.float32) * 0.5 + 0.5, 0, 1)  # noqa: E731
    return np.concatenate([to_unit(x), to_unit(rec)], axis=2)


def interpolation_2_images(model: StyleModel, state: StyleTrainState, x: np.ndarray,
                           steps: int = 7, seed: int = 0, use_ema: bool = True) -> np.ndarray:
    """make_recon_figure_interpolation_2_images.py: two reals to w space,
    decoded along the w-space lerp (one w per image, :154-155)."""
    lod = _top_lod(model)
    styles = encode_styles(model, state, x, lod, use_ema)
    wa, wb = styles[0, 0], styles[1, 0]
    kh = torch.linspace(0.0, 1.0, steps, device=state.device)[:, None]
    w = wa[None] * (1 - kh) + wb[None] * kh
    rec = decode_styles(model, state, _broadcast(w, model.num_layers), lod, seed=seed,
                        use_ema=use_ema)
    return np.clip(rec * 0.5 + 0.5, 0, 1)


def write_grid(images: np.ndarray, path: str, nrow: int) -> str:
    """Write an (N, H, W, 3) batch in [0, 1] as a grid; needs matplotlib."""
    from soft_intro_vae_torch.utils.plotting import save_image_grid

    require("matplotlib", f"writing {path}")
    out = save_image_grid(images, path, nrow=nrow)
    if out is None:
        raise RuntimeError(f"{path} was not written (only rank 0 writes figures)")
    return out


def write_canvas(canvas: np.ndarray, path: str) -> str:
    """Write one (H, W, 3) canvas in [0, 1]; needs matplotlib."""
    require("matplotlib", f"writing {path}")
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    plt.imsave(path, np.clip(canvas, 0, 1))
    return path


def generate_samples(cfg: StyleConfig, ckpt_path: str, out: str, count: int = 32,
                     seed: int = 0, use_ema: bool = True, truncation: bool = True) -> str:
    model, state = load_model(cfg, ckpt_path)
    return write_grid(sample_images(model, state, count, seed, use_ema, truncation), out, nrow=8)


def reconstruction_figure(cfg: StyleConfig, ckpt_path: str, dataset, out: str, count: int = 8,
                          use_ema: bool = True) -> str:
    model, state = load_model(cfg, ckpt_path)
    res = model.layer_to_resolution[_top_lod(model)]
    # astype first: a uint8 dataset normalizes in f32, as the trainer does
    x = next(iter(dataset.epoch(res, count))).astype(np.float32) / 127.5 - 1.0
    return write_grid(reconstruction_images(model, state, x, use_ema), out, nrow=count)


def interpolation_figure(cfg: StyleConfig, ckpt_path: str, out: str, steps: int = 8,
                         seed: int = 0, use_ema: bool = True) -> str:
    model, state = load_model(cfg, ckpt_path)
    return write_grid(interpolation_images(model, state, steps, seed, use_ema), out, nrow=steps)


def style_mixing_figure(cfg: StyleConfig, ckpt_path: str, out: str, n_src: int = 4,
                        n_dst: int = 4, crossover: Optional[int] = None, seed: int = 0,
                        use_ema: bool = True) -> str:
    model, state = load_model(cfg, ckpt_path)
    grid = style_mixing_images(model, state, n_src, n_dst, crossover, seed, use_ema)
    return write_grid(grid, out, nrow=n_src)


def multires_reconstruction_figure(cfg: StyleConfig, ckpt_path: str, samples_dir: str,
                                   out: str, use_ema: bool = True, seed: int = 5) -> str:
    model, state = load_model(cfg, ckpt_path)
    im_size = model.layer_to_resolution[_top_lod(model)]
    names = sample_names(samples_dir, seed)[: 4 * 5]  # 4 parts x (1 full + 4 half) pairs
    x = load_sample_images(samples_dir, im_size, names=names)
    return write_canvas(multires_canvas(model, state, x, use_ema), out)


def paged_reconstruction_figure(cfg: StyleConfig, ckpt_path: str, samples_dir: str,
                                out_dir: str, per_page: int = 24, use_ema: bool = True,
                                seed: int = 1, max_pages: Optional[int] = None) -> List[str]:
    """Pages ``reconstructions_<i>.png`` of 3 [real | recon] cells a row."""
    model, state = load_model(cfg, ckpt_path)
    im_size = model.layer_to_resolution[_top_lod(model)]
    names = sample_names(samples_dir, seed)
    n_pages = (len(names) + per_page - 1) // per_page
    if max_pages is not None:
        n_pages = min(n_pages, max_pages)
    paths = []
    for page in range(n_pages):
        x = load_sample_images(samples_dir, im_size,
                               names=names[page * per_page:(page + 1) * per_page])
        paths.append(write_grid(paged_cells(model, state, x, use_ema),
                                os.path.join(out_dir, f"reconstructions_{page}.png"), nrow=3))
    return paths


def interpolation_2_images_figure(cfg: StyleConfig, ckpt_path: str, samples_dir: str,
                                  image_a: str, image_b: str, out: str, steps: int = 7,
                                  use_ema: bool = True, seed: int = 0) -> str:
    model, state = load_model(cfg, ckpt_path)
    im_size = model.layer_to_resolution[_top_lod(model)]
    x = load_sample_images(samples_dir, im_size, names=[image_a, image_b])
    return write_grid(interpolation_2_images(model, state, x, steps, seed, use_ema), out,
                      nrow=steps)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="soft-intro-vae-torch-figures")
    sub = ap.add_subparsers(dest="command", required=True)
    for name in KINDS:
        p = sub.add_parser(name)
        p.add_argument("--yaml", type=str, default=None)
        p.add_argument("-m", "--model", type=str, required=True)
        p.add_argument("-o", "--out", type=str, required=True)
        # recon-paged's default seed is 1, the function's (the reference's shuffle)
        p.add_argument("--seed", type=int, default=1 if name == "recon-paged" else 0)
        p.add_argument("--device", type=str, default="cuda",
                       help="cuda (default) or cpu: where the nets run")
        if name == "recon":
            # real side: DATASET.PATH %-pattern from the yaml, or synthetic
            p.add_argument("--count", type=int, default=8)
        if name in FOLDER_KINDS:
            p.add_argument("--samples", type=str, required=True)
        if name == "recon-paged":
            p.add_argument("--max-pages", type=int, default=None)
        if name == "interpolation-images":
            p.add_argument("--image-a", type=str, required=True)
            p.add_argument("--image-b", type=str, required=True)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    # fail before loading anything when the figure cannot be written
    require("matplotlib", f"the {args.command} figure")
    if args.command in FOLDER_KINDS:
        require("PIL", f"the {args.command} figure")
    cfg = StyleConfig.from_yaml(args.yaml) if args.yaml else StyleConfig()
    cfg = dataclasses.replace(cfg, device=args.device)
    if args.command == "samples":
        print(generate_samples(cfg, args.model, args.out, seed=args.seed))
    elif args.command == "recon":
        from soft_intro_vae_torch.train.style import make_style_dataset

        if not (cfg.dataset_path and "%" in cfg.dataset_path):
            cfg = dataclasses.replace(cfg, use_synthetic=True)
        print(reconstruction_figure(cfg, args.model, make_style_dataset(cfg), args.out,
                                    count=args.count))
    elif args.command == "interpolation":
        print(interpolation_figure(cfg, args.model, args.out, seed=args.seed))
    elif args.command == "stylemix":
        print(style_mixing_figure(cfg, args.model, args.out, seed=args.seed))
    elif args.command == "recon-multires":
        print(multires_reconstruction_figure(cfg, args.model, args.samples, args.out,
                                             seed=args.seed))
    elif args.command == "recon-paged":
        print(paged_reconstruction_figure(cfg, args.model, args.samples, args.out,
                                          seed=args.seed, max_pages=args.max_pages))
    elif args.command == "interpolation-images":
        print(interpolation_2_images_figure(cfg, args.model, args.samples, args.image_a,
                                            args.image_b, args.out, seed=args.seed))


if __name__ == "__main__":
    main()
