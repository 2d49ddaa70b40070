"""Binding of the hand-written CUDA chamfer kernel (csrc/chamfer_nearest.cu).

Replaces the TPU kernel of soft_intro_vae_tpu/ops/chamfer_pallas.py
(``_nearest`` -> ``_min_kernel``), one launch per direction; the source's
header says what bounds it and how it is laid out.

Build: ``ops/cuda_build.py`` compiles the source with ``nvcc`` into a shared
library with a plain C interface under ``soft_intro_vae_torch/_build/``,
keyed by a hash of the source and the flags, and ``ctypes`` loads it. That
happens on the first call with a CUDA tensor, never at import. A build or
launch failure raises; there is no fallback to the plain version.
"""

from __future__ import annotations

import ctypes
import os
from typing import Tuple

import torch

from soft_intro_vae_torch.ops import cuda_build

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "chamfer_nearest.cu")
_BUILD_DIR = cuda_build.BUILD_DIR

# kernel launches made by ``nearest_cuda``; a run sets it to 0 and reads it
# back to show which path went through the kernel
launches = 0


def spec() -> cuda_build.Spec:
    """The build of this kernel: (source, library stem, extra nvcc flags)."""
    return (_SRC, "chamfer_nearest", ())


def _declare(lib: ctypes.CDLL) -> None:
    lib.chamfer_nearest_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.chamfer_nearest_launch.restype = ctypes.c_int
    lib.chamfer_error_string.argtypes = [ctypes.c_int]
    lib.chamfer_error_string.restype = ctypes.c_char_p


_library = cuda_build.Library(spec, _declare)


def library_path() -> str:
    """Where the built library for the current source and flags lives."""
    return cuda_build.library_path(*spec())


def load() -> ctypes.CDLL:
    """Build (if needed) and load the library once per process."""
    return _library.load()


def _check_cloud(name: str, t: torch.Tensor) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got device {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if t.dim() != 3 or t.shape[2] != 3:
        raise ValueError(f"{name} must have shape (B, N, 3), got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def nearest_cuda(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(min, argmin) over b for every point of a: (B, N) f32 and (B, N) int64.

    One kernel launch on the current stream; does not synchronise.
    """
    global launches
    _check_cloud("a", a)
    _check_cloud("b", b)
    if a.device != b.device or a.shape[0] != b.shape[0]:
        raise ValueError(f"clouds disagree: {tuple(a.shape)} on {a.device} vs "
                         f"{tuple(b.shape)} on {b.device}")
    bsz, n, _ = a.shape
    m = b.shape[1]
    if n == 0 or m == 0:
        raise ValueError("clouds must hold at least one point")
    lib = load()
    dist = torch.empty((bsz, n), dtype=torch.float32, device=a.device)
    idx = torch.empty((bsz, n), dtype=torch.int64, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.chamfer_nearest_launch(a.data_ptr(), b.data_ptr(), dist.data_ptr(),
                                         idx.data_ptr(), bsz, n, m, stream)
    if err != 0:
        raise RuntimeError(f"chamfer_nearest launch failed: {lib.chamfer_error_string(err).decode()}")
    launches += 1
    return dist, idx
