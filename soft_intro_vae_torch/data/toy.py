"""Procedural 2D toy distributions (port of data/toy.py, numpy only).

The reference's ToyDataset and sample_2d_data
(soft_intro_vae_2d/train_soft_intro_vae_2d.py:29-177): 8Gaussians,
25Gaussians, Sequential8Gaussians, 2spirals, checkerboard and rings, drawn on
the host from a seeded numpy generator in the JAX package's order, so both
packages draw the same batches for the same seed.
"""

from __future__ import annotations

import numpy as np

_SQ2 = 1.0 / np.sqrt(2.0)
_EIGHT_CENTERS = np.array(
    [(1, 0), (-1, 0), (0, 1), (0, -1), (_SQ2, _SQ2), (_SQ2, -_SQ2), (-_SQ2, _SQ2), (-_SQ2, -_SQ2)],
    dtype=np.float64,
)

DISTRIBUTIONS = ("8Gaussians", "25Gaussians", "Sequential8Gaussians", "2spirals", "checkerboard",
                 "rings")


class ToyDataset:
    """``next_batch(batch_size) -> (B, 2) float32``; ToyDataset (:29-115).

    ``range`` is 2 for 25Gaussians, else 1 (:47-49): the trainer multiplies
    its plot and metric scale by it. Sequential8Gaussians moves to the next
    mode every ``iter_per_mode`` batches.
    """

    def __init__(self, distr: str = "8Gaussians", scale: float = 2.0, iter_per_mode: int = 100,
                 seed: int = 0):
        if distr not in DISTRIBUTIONS:
            raise ValueError(f"unknown distribution {distr!r}; choose from {DISTRIBUTIONS}")
        self.distr = distr
        self.scale = scale
        self.rng = np.random.default_rng(seed)
        self.range = 2 if distr == "25Gaussians" else 1
        self.curr_iter = 0
        self.curr_mode = 0
        self.iter_per_mode = iter_per_mode
        if distr == "25Gaussians":
            # a pre-drawn 100k-point 5x5 grid, std 0.05, / 2.828 (:35-45)
            pts = []
            for _ in range(100000 // 25):
                for x in range(-2, 3):
                    for y in range(-2, 3):
                        p = self.rng.standard_normal(2) * 0.05
                        pts.append((p[0] + 2 * x, p[1] + 2 * y))
            self.dataset = np.asarray(pts, dtype=np.float32)
            self.rng.shuffle(self.dataset)
            self.dataset /= 2.828

    def next_batch(self, batch_size: int = 64, sig: float = 0.02) -> np.ndarray:
        if self.distr in ("2spirals", "checkerboard", "rings"):
            return sample_2d_data(self.distr, batch_size, self.rng)
        if self.distr == "8Gaussians":
            centers = _EIGHT_CENTERS * self.scale
            idx = self.rng.integers(0, 8, size=batch_size)
            pts = self.rng.standard_normal((batch_size, 2)) * sig + centers[idx]
            return (pts / 1.414).astype(np.float32)
        if self.distr == "25Gaussians":
            bi = self.rng.integers(0, 100000 // batch_size)
            return (self.dataset[bi * batch_size:(bi + 1) * batch_size] * self.scale).astype(np.float32)
        # Sequential8Gaussians
        centers = _EIGHT_CENTERS * self.scale
        pts = self.rng.standard_normal((batch_size, 2)) * 0.02 + centers[self.curr_mode]
        if self.curr_iter % self.iter_per_mode == self.iter_per_mode - 1:
            self.curr_mode = (self.curr_mode + 1) % 8
        self.curr_iter += 1
        return (pts / 1.414).astype(np.float32)


def sample_2d_data(dataset: str, n_samples: int, rng: np.random.Generator) -> np.ndarray:
    """The 2spirals, checkerboard and rings samplers (:118-177)."""
    z = rng.standard_normal((n_samples, 2))

    if dataset == "2spirals":
        n = np.sqrt(rng.random(n_samples // 2)) * 540 * (2 * np.pi) / 360
        d1x = -np.cos(n) * n + rng.random(n_samples // 2) * 0.5
        d1y = np.sin(n) * n + rng.random(n_samples // 2) * 0.5
        x = np.concatenate(
            [np.stack([d1x, d1y], axis=1), np.stack([-d1x, -d1y], axis=1)], axis=0) / 3.0
        return (x + 0.1 * z[: x.shape[0]]).astype(np.float32)

    if dataset == "checkerboard":
        x1 = rng.random(n_samples) * 4 - 2
        x2_ = rng.random(n_samples) - rng.integers(0, 2, n_samples).astype(np.float64) * 2
        x2 = x2_ + np.floor(x1) % 2
        return (np.stack([x1, x2], axis=1) * 2).astype(np.float32)

    if dataset == "rings":
        n4 = n3 = n2 = n_samples // 4
        n1 = n_samples - n4 - n3 - n2
        radii_pts = []
        for count, r in ((n4, 1.0), (n3, 0.75), (n2, 0.5), (n1, 0.25)):
            lin = np.linspace(0, 2 * np.pi, count + 1)[:-1]
            radii_pts.append(np.stack([np.cos(lin) * r, np.sin(lin) * r], axis=1))
        x = np.concatenate(radii_pts, axis=0) * 3.0
        x = x[rng.integers(0, n_samples, n_samples)]
        return (x + rng.normal(0.0, 0.08, x.shape)).astype(np.float32)

    raise RuntimeError("Invalid `dataset` to sample from.")
