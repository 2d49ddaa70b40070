"""Voxel-occupancy JSD between point-cloud sets (numpy/scipy copy of
soft_intro_vae_tpu/metrics/jsd.py).

Capability parity with reference soft_intro_vae_3d/metrics/jsd.py:80-157
("Learning Representations and Generative Models for 3D Point Clouds" JSD):
28^3 occupancy grid clipped to the unit sphere, per-set occupancy counts,
Jensen-Shannon divergence (base-2) between the two normalized count grids.

Host-side numpy/scipy (eval-only). The reference's sklearn NearestNeighbors
sweep is replaced by a scipy cKDTree over the same clipped grid centers —
identical assignments, orders of magnitude faster.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree
from scipy.stats import entropy


def unit_cube_grid(resolution: int, clip_sphere: bool = False):
    """Cell-center coordinates of a resolution^3 grid in the unit cube
    (reference _unit_cube_grid_point_cloud, jsd.py:139-157)."""
    spacing = 1.0 / float(resolution - 1)
    ax = np.arange(resolution, dtype=np.float32) * spacing - 0.5
    grid = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), axis=-1).reshape(-1, 3)
    if clip_sphere:
        grid = grid[np.linalg.norm(grid, axis=1) <= 0.5]
    return grid, spacing


def entropy_of_occupancy_grid(pclouds: np.ndarray, grid_resolution: int, in_sphere: bool = False):
    """(mean Bernoulli cell entropy, per-cell point counts) — reference
    _entropy_of_occupancy_grid (jsd.py:97-136)."""
    pclouds = np.asarray(pclouds, np.float32)
    grid, _ = unit_cube_grid(grid_resolution, in_sphere)
    tree = cKDTree(grid)
    counters = np.zeros(len(grid), np.float64)
    bernoulli = np.zeros(len(grid), np.float64)
    for pc in pclouds:
        _, idx = tree.query(pc, k=1)
        np.add.at(counters, idx, 1.0)
        bernoulli[np.unique(idx)] += 1.0
    n = float(len(pclouds))
    p = bernoulli / n
    mask = p > 0
    # scipy entropy([p, 1-p]) is the natural-log Bernoulli entropy
    with np.errstate(divide="ignore", invalid="ignore"):
        ent = -(p[mask] * np.log(p[mask]) + np.where(p[mask] < 1, (1 - p[mask]) * np.log1p(-p[mask]), 0.0))
    return float(ent.sum() / len(counters)), counters


def js_divergence(p: np.ndarray, q: np.ndarray) -> float:
    """Base-2 JSD via entropies (reference _js_divergence, jsd.py:25-42)."""
    p = p / np.sum(p)
    q = q / np.sum(q)
    e1 = entropy(p, base=2)
    e2 = entropy(q, base=2)
    e_sum = entropy((p + q) / 2.0, base=2)
    return float(e_sum - (e1 + e2) / 2.0)


def jsd_between_point_cloud_sets(sample_pcs, ref_pcs, voxels: int = 28, in_unit_sphere: bool = True) -> float:
    """Reference entry point (jsd.py:80-94)."""
    _, sample_counts = entropy_of_occupancy_grid(np.asarray(sample_pcs), voxels, in_unit_sphere)
    _, ref_counts = entropy_of_occupancy_grid(np.asarray(ref_pcs), voxels, in_unit_sphere)
    return js_divergence(sample_counts, ref_counts)
