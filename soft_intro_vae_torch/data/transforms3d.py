"""3D transforms for point clouds (the port's copy of the JAX package's
data/transforms3d.py).

Capability parity with the parts of the reference's vendored transforms3d
(soft_intro_vae_3d/datasets/{transforms,transforms3d}.py)
that the framework actually exercises — RotateAxisAngle is the only
transform the trainer uses (train_soft_intro_vae_3d.py:26,256-260) — plus
the standard conversion/compose utilities so users of the reference's
transform API find equivalents: axis-angle / euler / matrix conversions,
Compose, normalization and jitter augments.

Pure numpy (host-side data augmentation, like the reference).
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

_AXES = {"X": 0, "Y": 1, "Z": 2}


def axis_angle_matrix(axis: str, angle_deg: np.ndarray) -> np.ndarray:
    """(B,) degrees -> (B, 3, 3) rotation matrices about a named axis."""
    th = np.deg2rad(np.asarray(angle_deg, np.float32))
    c, s = np.cos(th), np.sin(th)
    b = th.shape[0] if th.ndim else 1
    c, s = np.broadcast_to(c, (b,)), np.broadcast_to(s, (b,))
    m = np.tile(np.eye(3, dtype=np.float32), (b, 1, 1))
    i = _AXES[axis.upper()]
    j, k = (i + 1) % 3, (i + 2) % 3
    m[:, j, j] = c
    m[:, j, k] = -s
    m[:, k, j] = s
    m[:, k, k] = c
    return m


def euler_matrix(angles_deg: np.ndarray, convention: str = "XYZ") -> np.ndarray:
    """(B, 3) euler angles (degrees) -> (B, 3, 3), extrinsic composition."""
    angles_deg = np.asarray(angles_deg, np.float32)
    m = None
    for ax, a in zip(convention, angles_deg.T):
        r = axis_angle_matrix(ax, a)
        m = r if m is None else np.einsum("bij,bjk->bik", r, m)
    return m


def rotate_points(points: np.ndarray, matrices: np.ndarray) -> np.ndarray:
    """(B, N, 3) @ (B, 3, 3)^T — transform_points semantics."""
    return np.einsum("bni,bji->bnj", points, matrices)


class RotateAxisAngle:
    """Reference-call-compatible: RotateAxisAngle(angle, axis="Z").transform_points(x)."""

    def __init__(self, angle, axis: str = "X", **_):
        self.m = axis_angle_matrix(axis, np.atleast_1d(np.asarray(angle, np.float32)))

    def transform_points(self, points: np.ndarray) -> np.ndarray:
        m = self.m
        if m.shape[0] == 1 and points.shape[0] > 1:
            m = np.broadcast_to(m, (points.shape[0], 3, 3))
        return rotate_points(points, m)


class Compose:
    def __init__(self, transforms: Sequence[Callable[[np.ndarray], np.ndarray]]):
        self.transforms = list(transforms)

    def __call__(self, x: np.ndarray) -> np.ndarray:
        for t in self.transforms:
            x = t(x)
        return x


def unit_sphere_normalize(points: np.ndarray) -> np.ndarray:
    """Center and scale each cloud into the unit sphere (radius 0.5)."""
    centered = points - points.mean(axis=-2, keepdims=True)
    r = np.linalg.norm(centered, axis=-1).max(axis=-1, keepdims=True)
    return centered / (2.0 * r[..., None] + 1e-12)


def jitter(points: np.ndarray, rng: np.random.Generator, sigma: float = 0.01,
           clip: float = 0.05) -> np.ndarray:
    noise = np.clip(rng.normal(0, sigma, points.shape), -clip, clip).astype(points.dtype)
    return points + noise


def check_valid_rotation_matrix(m: np.ndarray, tol: float = 1e-5) -> bool:
    """Orthonormal + det 1 (reference _check_valid_rotation_matrix,
    transforms3d.py:1130)."""
    eye = np.eye(3, dtype=m.dtype)
    orth = np.allclose(np.einsum("...ij,...kj->...ik", m, m), eye, atol=tol)
    det1 = np.allclose(np.linalg.det(m), 1.0, atol=tol)
    return bool(orth and det1)


# ----------------------------------------------------- Transform3d family --
# Composable homogeneous transforms, capability parity with the reference's
# vendored PyTorch3D classes (transforms3d.py:509-1018). Same row-vector
# convention: matrices are (B, 4, 4) with the translation in the LAST ROW
# (M[:, 3, :3]), and points transform as p_homogeneous @ M. ``compose`` of
# [t1, t2, ...] applies t1 first.


def _broadcast_stack(ms: Sequence[np.ndarray]) -> tuple:
    b = max(m.shape[0] for m in ms)
    return tuple(np.broadcast_to(m, (b,) + m.shape[1:]) for m in ms), b


class Transform3d:
    """Batch of 4x4 row-vector homogeneous transforms (transforms3d.py:509+)."""

    def __init__(self, matrix: np.ndarray | None = None, dtype=np.float32):
        if matrix is None:
            matrix = np.eye(4, dtype=dtype)[None]
        matrix = np.asarray(matrix, dtype)
        if matrix.ndim == 2:
            matrix = matrix[None]
        if matrix.shape[-2:] != (4, 4):
            raise ValueError(f"matrix must be (B, 4, 4), got {matrix.shape}")
        self._matrix = matrix

    def get_matrix(self) -> np.ndarray:
        return self._matrix.copy()

    def __len__(self) -> int:
        return self._matrix.shape[0]

    def compose(self, *others: "Transform3d") -> "Transform3d":
        """self applied first, then each other in order
        (transforms3d.py:608-630 semantics: p @ M_self @ M_1 @ ...)."""
        (m, *rest), _ = _broadcast_stack([self._matrix] + [o._matrix for o in others])
        out = m
        for r in rest:
            out = out @ r
        return Transform3d(out)

    def inverse(self) -> "Transform3d":
        return Transform3d(np.linalg.inv(self._matrix.astype(np.float64)).astype(
            self._matrix.dtype))

    def transform_points(self, points: np.ndarray) -> np.ndarray:
        """(B|1, N, 3) -> (B, N, 3): [p, 1] @ M (transforms3d.py:712-760)."""
        points = np.asarray(points, self._matrix.dtype)
        squeeze = points.ndim == 2
        if squeeze:
            points = points[None]
        ones = np.ones(points.shape[:-1] + (1,), points.dtype)
        ph = np.concatenate([points, ones], axis=-1)
        (m, ph), _ = _broadcast_stack([self._matrix, ph])
        out = np.einsum("bni,bij->bnj", ph, m)
        w = out[..., 3:]
        out = out[..., :3] / np.where(np.abs(w) > 1e-12, w, 1.0)
        return out[0] if squeeze else out

    def transform_normals(self, normals: np.ndarray) -> np.ndarray:
        """Normals transform by the inverse-transpose of the linear part
        (transforms3d.py:762-790)."""
        normals = np.asarray(normals, self._matrix.dtype)
        squeeze = normals.ndim == 2
        if squeeze:
            normals = normals[None]
        lin = self._matrix[:, :3, :3].astype(np.float64)
        it = np.linalg.inv(lin).transpose(0, 2, 1)
        (it, normals), _ = _broadcast_stack([it, normals])
        out = np.einsum("bni,bij->bnj", normals, it).astype(self._matrix.dtype)
        return out[0] if squeeze else out

    # constructors-by-composition (transforms3d.py:792-820)
    def translate(self, x, y=None, z=None) -> "Transform3d":
        return self.compose(Translate(x, y, z))

    def scale(self, x, y=None, z=None) -> "Transform3d":
        return self.compose(Scale(x, y, z))

    def rotate(self, R) -> "Transform3d":
        return self.compose(Rotate(R))

    def rotate_axis_angle(self, angle, axis: str = "X", degrees: bool = True) -> "Transform3d":
        return self.compose(RotateAxisAngleTransform(angle, axis, degrees=degrees))


def _xyz_to_batch(x, y, z) -> np.ndarray:
    """The reference's flexible (N,3)-or-scalars argument handling
    (transforms3d.py:1036-1086)."""
    if y is None and z is None:
        arr = np.asarray(x, np.float32)
        if arr.ndim == 0:
            arr = np.full((1, 3), float(arr), np.float32)
        elif arr.ndim == 1:
            arr = np.broadcast_to(arr.reshape(1, -1), (1, 3)).astype(np.float32) \
                if arr.shape[0] == 3 else np.repeat(arr[:, None], 3, axis=1)
        return np.atleast_2d(arr).astype(np.float32)
    xs = [np.atleast_1d(np.asarray(v, np.float32)) for v in (x, y, z)]
    b = max(v.shape[0] for v in xs)
    return np.stack([np.broadcast_to(v, (b,)) for v in xs], axis=-1)


class Translate(Transform3d):
    """transforms3d.py:881-910."""

    def __init__(self, x, y=None, z=None):
        t = _xyz_to_batch(x, y, z)
        m = np.tile(np.eye(4, dtype=np.float32), (t.shape[0], 1, 1))
        m[:, 3, :3] = t
        super().__init__(m)


class Scale(Transform3d):
    """transforms3d.py:913-948 (single scalar = isotropic)."""

    def __init__(self, x, y=None, z=None):
        s = _xyz_to_batch(x, y, z)
        m = np.tile(np.eye(4, dtype=np.float32), (s.shape[0], 1, 1))
        m[:, 0, 0], m[:, 1, 1], m[:, 2, 2] = s[:, 0], s[:, 1], s[:, 2]
        super().__init__(m)


class Rotate(Transform3d):
    """Wrap (B, 3, 3) rotation matrices (transforms3d.py:951-980). The
    matrices act on column vectors (R @ p); stored transposed so that the
    row-vector product p @ M applies the same rotation."""

    def __init__(self, R: np.ndarray):
        R = np.asarray(R, np.float32)
        if R.ndim == 2:
            R = R[None]
        if not check_valid_rotation_matrix(R, tol=1e-4):
            raise ValueError("R is not a valid rotation matrix")
        m = np.tile(np.eye(4, dtype=np.float32), (R.shape[0], 1, 1))
        m[:, :3, :3] = R.transpose(0, 2, 1)
        super().__init__(m)


class RotateAxisAngleTransform(Rotate):
    """Transform3d-based RotateAxisAngle (transforms3d.py:983-1018) —
    composable, unlike the lightweight trainer-path RotateAxisAngle above
    (kept for reference-call compatibility). Same counterclockwise
    convention: both produce identical point rotations."""

    def __init__(self, angle, axis: str = "X", degrees: bool = True):
        angle = np.atleast_1d(np.asarray(angle, np.float32))
        if not degrees:
            angle = np.rad2deg(angle)
        super().__init__(axis_angle_matrix(axis, angle))
