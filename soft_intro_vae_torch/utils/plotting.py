"""Image grids (port of the image part of soft_intro_vae_tpu/utils/plotting.py).

The reference saves [real | reconstruction | sample] grids with torchvision's
``vutils.save_image`` (train_soft_intro_vae.py:539-540,641-646). matplotlib is
imported lazily with the Agg backend; ``save_image_grid`` is a no-op
returning None where matplotlib is missing, as on the card's machine.
"""

from __future__ import annotations

import os

import numpy as np


def _plt():
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        return plt
    except Exception:  # matplotlib is optional
        return None


def make_grid(images: np.ndarray, nrow: int = 8, pad: int = 2, pad_value: float = 0.0) -> np.ndarray:
    """Tile (N, H, W, C) into one (H', W', C) image (vutils.make_grid)."""
    n, h, w, c = images.shape
    rows = (n + nrow - 1) // nrow
    grid = np.full((rows * (h + pad) + pad, nrow * (w + pad) + pad, c), pad_value, np.float32)
    for i in range(n):
        r, col = divmod(i, nrow)
        y, x = pad + r * (h + pad), pad + col * (w + pad)
        grid[y : y + h, x : x + w] = images[i]
    return grid


def save_image_grid(images: np.ndarray, path: str, nrow: int = 8, value_range=(0.0, 1.0)):
    """Save an (N, H, W, C) batch as a tiled grid image; the path, or None
    without matplotlib."""
    plt = _plt()
    if plt is None:
        return None
    lo, hi = value_range
    imgs = np.clip((np.asarray(images, np.float32) - lo) / (hi - lo), 0, 1)
    if imgs.shape[-1] == 1:
        imgs = np.repeat(imgs, 3, axis=-1)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    plt.imsave(path, make_grid(imgs, nrow=nrow))
    return path
