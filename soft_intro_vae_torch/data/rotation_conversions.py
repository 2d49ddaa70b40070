"""Rotation representation conversions for 3D point-cloud tooling (the port's
copy of the JAX package's data/rotation_conversions.py).

Capability parity with the conversion half of the reference's vendored
PyTorch3D module (soft_intro_vae_3d/datasets/transforms3d.py:32-506): quaternion <-> matrix <-> axis-angle <-> euler,
quaternion algebra, random rotations, and the continuous 6D representation
(Zhou et al. 2019). Pure numpy — these run host-side in data pipelines.

Conventions (PyTorch3D-compatible):
* quaternions are (w, x, y, z), real part first, unit norm;
* matrices are (..., 3, 3) acting on COLUMN vectors (R @ p);
* axis-angle vectors point along the rotation axis with norm = angle (rad);
* euler angles are radians, ``convention`` a string like "XYZ", composed
  as R(conv[0]) @ R(conv[1]) @ R(conv[2]).
"""

from __future__ import annotations

import numpy as np

_AXIS_INDEX = {"X": 0, "Y": 1, "Z": 2}


def _unit(q: np.ndarray) -> np.ndarray:
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


# ------------------------------------------------------------ quaternions --

def standardize_quaternion(q: np.ndarray) -> np.ndarray:
    """Flip sign so the real part is non-negative (q and -q are the same
    rotation; transforms3d.py:300-310)."""
    return np.where(q[..., :1] < 0, -q, q)


def quaternion_raw_multiply(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Hamilton product (transforms3d.py:313-329)."""
    aw, ax, ay, az = np.moveaxis(np.asarray(a, np.float64), -1, 0)
    bw, bx, by, bz = np.moveaxis(np.asarray(b, np.float64), -1, 0)
    return np.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], axis=-1).astype(np.result_type(a, b, np.float32))


def quaternion_multiply(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Product standardized to non-negative real part."""
    return standardize_quaternion(quaternion_raw_multiply(a, b))


def quaternion_invert(q: np.ndarray) -> np.ndarray:
    """Conjugate (== inverse for unit quaternions; transforms3d.py:347-358)."""
    return np.asarray(q) * np.array([1.0, -1.0, -1.0, -1.0], dtype=np.asarray(q).dtype)


def quaternion_apply(q: np.ndarray, point: np.ndarray) -> np.ndarray:
    """Rotate points (..., 3) by quaternions (..., 4) — q p q^-1
    (transforms3d.py:361-379)."""
    p = np.concatenate([np.zeros(point.shape[:-1] + (1,), point.dtype), point], axis=-1)
    out = quaternion_raw_multiply(quaternion_raw_multiply(q, p), quaternion_invert(q))
    return out[..., 1:]


def quaternion_to_matrix(q: np.ndarray) -> np.ndarray:
    """(..., 4) wxyz -> (..., 3, 3) (transforms3d.py:32-58)."""
    q = _unit(np.asarray(q, np.float64))
    w, x, y, z = np.moveaxis(q, -1, 0)
    two = 2.0
    m = np.stack([
        1 - two * (y * y + z * z), two * (x * y - z * w), two * (x * z + y * w),
        two * (x * y + z * w), 1 - two * (x * x + z * z), two * (y * z - x * w),
        two * (x * z - y * w), two * (y * z + x * w), 1 - two * (x * x + y * y),
    ], axis=-1)
    return m.reshape(q.shape[:-1] + (3, 3)).astype(np.float32)


def matrix_to_quaternion(m: np.ndarray) -> np.ndarray:
    """(..., 3, 3) -> (..., 4) wxyz with w >= 0 (transforms3d.py:88-108).

    Uses the numerically-stable largest-pivot branch selection rather than
    the single-branch trace formula.
    """
    m = np.asarray(m, np.float64)
    batch = m.shape[:-2]
    m = m.reshape((-1, 3, 3))
    out = np.empty((m.shape[0], 4))
    t = np.trace(m, axis1=-2, axis2=-1)
    for i in range(m.shape[0]):
        r = m[i]
        if t[i] > 0:
            s = np.sqrt(t[i] + 1.0) * 2
            out[i] = [0.25 * s, (r[2, 1] - r[1, 2]) / s,
                      (r[0, 2] - r[2, 0]) / s, (r[1, 0] - r[0, 1]) / s]
        elif r[0, 0] >= r[1, 1] and r[0, 0] >= r[2, 2]:
            s = np.sqrt(1.0 + r[0, 0] - r[1, 1] - r[2, 2]) * 2
            out[i] = [(r[2, 1] - r[1, 2]) / s, 0.25 * s,
                      (r[0, 1] + r[1, 0]) / s, (r[0, 2] + r[2, 0]) / s]
        elif r[1, 1] >= r[2, 2]:
            s = np.sqrt(1.0 + r[1, 1] - r[0, 0] - r[2, 2]) * 2
            out[i] = [(r[0, 2] - r[2, 0]) / s, (r[0, 1] + r[1, 0]) / s,
                      0.25 * s, (r[1, 2] + r[2, 1]) / s]
        else:
            s = np.sqrt(1.0 + r[2, 2] - r[0, 0] - r[1, 1]) * 2
            out[i] = [(r[1, 0] - r[0, 1]) / s, (r[0, 2] + r[2, 0]) / s,
                      (r[1, 2] + r[2, 1]) / s, 0.25 * s]
    q = standardize_quaternion(_unit(out)).astype(np.float32)
    return q.reshape(batch + (4,))


# ------------------------------------------------------------- axis-angle --

def axis_angle_to_quaternion(aa: np.ndarray) -> np.ndarray:
    """(..., 3) axis*angle(rad) -> (..., 4) wxyz (transforms3d.py:410-437);
    uses the small-angle Taylor branch near zero."""
    aa = np.asarray(aa, np.float64)
    angle = np.linalg.norm(aa, axis=-1, keepdims=True)
    half = angle * 0.5
    small = angle < 1e-6
    sin_half_over_angle = np.where(
        small, 0.5 - angle * angle / 48.0, np.sin(half) / np.maximum(angle, 1e-30))
    return np.concatenate([np.cos(half), aa * sin_half_over_angle],
                          axis=-1).astype(np.float32)


def quaternion_to_axis_angle(q: np.ndarray) -> np.ndarray:
    """(..., 4) -> (..., 3) (transforms3d.py:440-466)."""
    q = standardize_quaternion(_unit(np.asarray(q, np.float64)))
    norm = np.linalg.norm(q[..., 1:], axis=-1, keepdims=True)
    half = np.arctan2(norm, q[..., :1])
    angle = 2 * half
    small = np.abs(angle) < 1e-6
    sin_half_over_angle = np.where(
        small, 0.5 - angle * angle / 48.0, np.sin(half) / np.maximum(angle, 1e-30))
    return (q[..., 1:] / sin_half_over_angle).astype(np.float32)


def axis_angle_to_matrix(aa: np.ndarray) -> np.ndarray:
    """Rodrigues via quaternion (transforms3d.py:382-393)."""
    return quaternion_to_matrix(axis_angle_to_quaternion(aa))


def matrix_to_axis_angle(m: np.ndarray) -> np.ndarray:
    """(..., 3, 3) -> (..., 3) (transforms3d.py:396-407)."""
    return quaternion_to_axis_angle(matrix_to_quaternion(m))


# ------------------------------------------------------------------ euler --

def _single_axis_matrix(axis: str, angle: np.ndarray) -> np.ndarray:
    """R about a named axis, radians, column-vector convention
    (transforms3d.py:111-134)."""
    c, s = np.cos(angle), np.sin(angle)
    one, zero = np.ones_like(c), np.zeros_like(c)
    if axis == "X":
        flat = (one, zero, zero, zero, c, -s, zero, s, c)
    elif axis == "Y":
        flat = (c, zero, s, zero, one, zero, -s, zero, c)
    elif axis == "Z":
        flat = (c, -s, zero, s, c, zero, zero, zero, one)
    else:
        raise ValueError(f"axis must be X, Y or Z, got {axis!r}")
    return np.stack(flat, axis=-1).reshape(np.shape(angle) + (3, 3)).astype(np.float32)


def euler_angles_to_matrix(euler: np.ndarray, convention: str) -> np.ndarray:
    """(..., 3) radians -> (..., 3, 3): R(c0,a0) @ R(c1,a1) @ R(c2,a2)
    (transforms3d.py:137-157)."""
    if len(convention) != 3 or any(c not in "XYZ" for c in convention):
        raise ValueError(f"invalid convention {convention!r}")
    if convention[0] == convention[1] or convention[1] == convention[2]:
        raise ValueError(f"repeated adjacent axis in convention {convention!r}")
    euler = np.asarray(euler, np.float64)
    m = None
    for c, a in zip(convention, np.moveaxis(euler, -1, 0)):
        r = _single_axis_matrix(c, a)
        m = r if m is None else m @ r
    return m.astype(np.float32)


def matrix_to_euler_angles(m: np.ndarray, convention: str) -> np.ndarray:
    """(..., 3, 3) -> (..., 3) radians (transforms3d.py:200-237).

    Inverse of euler_angles_to_matrix for the same convention string; both
    Tait-Bryan ("XYZ", "ZYX", ...) and proper-Euler ("XYX", ...) orders.
    Delegates the branch-heavy angle extraction to scipy's Rotation (an
    existing dependency): our column-vector R(c0)@R(c1)@R(c2) composition
    is scipy's intrinsic (uppercase) sequence.
    """
    if len(convention) != 3 or any(c not in "XYZ" for c in convention):
        raise ValueError(f"invalid convention {convention!r}")
    if convention[0] == convention[1] or convention[1] == convention[2]:
        raise ValueError(f"repeated adjacent axis in convention {convention!r}")
    from scipy.spatial.transform import Rotation

    m = np.asarray(m, np.float64)
    batch = m.shape[:-2]
    angles = Rotation.from_matrix(m.reshape(-1, 3, 3)).as_euler(convention)
    return angles.reshape(batch + (3,)).astype(np.float32)


# ----------------------------------------------------------------- random --

def random_quaternions(n: int, rng: np.random.Generator | None = None) -> np.ndarray:
    """n uniform unit quaternions, w >= 0 (transforms3d.py:240-259)."""
    rng = rng or np.random.default_rng()
    q = rng.normal(size=(n, 4))
    return standardize_quaternion(_unit(q)).astype(np.float32)


def random_rotations(n: int, rng: np.random.Generator | None = None) -> np.ndarray:
    """n uniform rotation matrices (transforms3d.py:262-280)."""
    return quaternion_to_matrix(random_quaternions(n, rng))


def random_rotation(rng: np.random.Generator | None = None) -> np.ndarray:
    return random_rotations(1, rng)[0]


# --------------------------------------------------------------------- 6d --

def rotation_6d_to_matrix(d6: np.ndarray) -> np.ndarray:
    """Continuous 6D -> (..., 3, 3) via Gram-Schmidt (Zhou et al. 2019;
    transforms3d.py:469-488)."""
    d6 = np.asarray(d6, np.float64)
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / np.linalg.norm(a1, axis=-1, keepdims=True)
    b2 = a2 - np.sum(b1 * a2, axis=-1, keepdims=True) * b1
    b2 = b2 / np.linalg.norm(b2, axis=-1, keepdims=True)
    b3 = np.cross(b1, b2)
    return np.stack([b1, b2, b3], axis=-2).astype(np.float32)


def matrix_to_rotation_6d(m: np.ndarray) -> np.ndarray:
    """(..., 3, 3) -> first two rows flattened (transforms3d.py:491-506)."""
    m = np.asarray(m, np.float32)
    return m[..., :2, :].reshape(m.shape[:-2] + (6,)).copy()
