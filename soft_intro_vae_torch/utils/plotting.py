"""Image grids, 2D scatter and density plots, and point-cloud panels (port
of soft_intro_vae_tpu/utils/plotting.py).

The reference saves [real | reconstruction | sample] grids with torchvision's
``vutils.save_image`` (train_soft_intro_vae.py:539-540,641-646), the 2D
trainer's sample scatter and VAE density (train_soft_intro_vae_2d.py:
232-258,662-699) and the 3D trainer's real / reconstruction / sample panel
(train_soft_intro_vae_3d.py:396-426). matplotlib is imported lazily with
the Agg backend; each function is a no-op returning None where matplotlib is
missing, as on the card's machine.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

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


def save_scatter_2d(points: np.ndarray, path: str, lim: float = 4.0, color: str = "g",
                    title: Optional[str] = None):
    """A 2D sample scatter (train_soft_intro_vae_2d.py:662-676); the path, or
    None without matplotlib."""
    plt = _plt()
    if plt is None:
        return None
    fig, ax = plt.subplots(1, 1, figsize=(6, 6))
    ax.scatter(points[:, 0], points[:, 1], s=8, c=color)
    ax.set_xlim((-lim, lim))
    ax.set_ylim((-lim, lim))
    ax.set_axis_off()
    if title:
        ax.set_title(title)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)
    return path


def save_density_2d(density: np.ndarray, n_pts: int, path: str):
    """The VAE density heatmap of an (n_pts^2,) grid (plot_vae_density,
    train_soft_intro_vae_2d.py:232-258); the path, or None without matplotlib."""
    plt = _plt()
    if plt is None:
        return None
    fig, ax = plt.subplots(1, 1, figsize=(6, 6))
    ax.pcolormesh(density.reshape(n_pts, n_pts), cmap=plt.cm.jet)
    ax.set_facecolor(plt.cm.jet(0.0))
    ax.set_axis_off()
    ax.invert_yaxis()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)
    return path


def save_pointcloud_panel(rows: Sequence[np.ndarray], path: str, n_cols: int = 5,
                          in_u_sphere: bool = True, s: int = 4, color: str = "dodgerblue"):
    """A len(rows) x n_cols panel of 3D point clouds, each row (n_cols, N, 3)
    (pcutil.py:110-150); the path, or None without matplotlib."""
    plt = _plt()
    if plt is None:
        return None
    n_rows = len(rows)
    fig = plt.figure(dpi=200, figsize=(2 * n_cols, 2 * n_rows))
    for r, row in enumerate(rows):
        for k in range(min(n_cols, row.shape[0])):
            ax = fig.add_subplot(n_rows, n_cols, r * n_cols + k + 1, projection="3d")
            pc = row[k]
            ax.scatter(pc[:, 0], pc[:, 1], pc[:, 2], s=s, c=color)
            if in_u_sphere:
                ax.set_xlim3d(-0.5, 0.5)
                ax.set_ylim3d(-0.5, 0.5)
                ax.set_zlim3d(-0.5, 0.5)
            ax.set_xticklabels([])
            ax.set_yticklabels([])
            ax.set_zticklabels([])
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)
    return path
