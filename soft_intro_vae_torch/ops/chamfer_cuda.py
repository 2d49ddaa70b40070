"""Binding of the hand-written CUDA chamfer kernel (csrc/chamfer_nearest.cu).

Replaces the TPU kernel of soft_intro_vae_tpu/ops/chamfer_pallas.py
(``_nearest`` -> ``_min_kernel``), one launch per direction; the source's
header says what bounds it and how it is laid out.

Build: ``nvcc`` compiles the source into a shared library with a plain C
interface under ``soft_intro_vae_torch/_build/``, keyed by a hash of the
source and the flags, and ``ctypes`` loads it. That happens on the first call
with a CUDA tensor, never at import. A build or launch failure raises; there
is no fallback to the plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional, Tuple

import torch

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "chamfer_nearest.cu")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

# kernel launches made by ``nearest_cuda``; a run sets it to 0 and reads it
# back to show which path went through the kernel
launches = 0

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; it is needed to build "
                       f"{_SRC}")


def library_path() -> str:
    """Where the built library for the current source and flags lives."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(_BUILD_DIR, f"libchamfer_nearest_{digest}.so")


def build() -> str:
    """Compile the kernel if no library for this source exists; return its path."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, _SRC]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a process building at the same time never loads half a file
    with open(out + ".log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    return out


def load() -> ctypes.CDLL:
    """Build (if needed) and load the library once per process."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.chamfer_nearest_launch.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            lib.chamfer_nearest_launch.restype = ctypes.c_int
            lib.chamfer_error_string.argtypes = [ctypes.c_int]
            lib.chamfer_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


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
