"""Binding of the hand-written CUDA normalize kernel (csrc/u8norm.cu).

Replaces the JAX package's in-step ``u8_to_unit_f32``
(soft_intro_vae_tpu/ops/u8norm.py): one launch turns a uint8 NHWC batch on
the card into the float32 NCHW batch the nets take, each value the correctly
rounded ``i / 255``. The source's header says why PyTorch's own divide is
not used and what bounds the kernel.

Build: ``ops/cuda_build.py`` compiles the source with ``nvcc`` into a shared
library with a plain C interface under ``soft_intro_vae_torch/_build/`` and
``ctypes`` loads it, on the first call with a CUDA tensor, never at import. A
build or launch failure raises; there is no fallback to the plain version.
``plan`` and ``check_input`` are plain Python, so the CPU tests reach them.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Tuple

import torch

from soft_intro_vae_torch.ops import cuda_build

Tensor = torch.Tensor

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "u8norm.cu")
THREADS = 256
BLOCKS_PER_SM = 16           # grid cap: the grid-stride loop takes the rest
H100_SMS = 132

# kernel launches made by ``u8_to_unit_nchw_cuda``; a run sets it to 0 and
# reads it back to show which path went through the kernel
launches = 0


def spec() -> cuda_build.Spec:
    """The build of this kernel: (source, library stem, extra nvcc flags)."""
    return (_SRC, "u8norm", ())


def _declare(lib: ctypes.CDLL) -> None:
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.u8norm_nhwc_to_nchw.argtypes = [p, p, ll, ll, ll, ll, i, i, p]
    lib.u8norm_nhwc_to_nchw.restype = ctypes.c_int
    lib.u8norm_error_string.argtypes = [ctypes.c_int]
    lib.u8norm_error_string.restype = ctypes.c_char_p


_library = cuda_build.Library(spec, _declare)


def load() -> ctypes.CDLL:
    """Build (if needed) and load the library once per process."""
    return _library.load()


def plan(n: int, sms: int = H100_SMS) -> Tuple[int, int]:
    """(grid, threads) for ``n`` output elements: one thread an element, the
    grid capped at BLOCKS_PER_SM blocks an SM (each thread then loops)."""
    if n <= 0 or sms <= 0:
        raise ValueError(f"empty launch: {n} elements on {sms} SMs")
    return min(-(-n // THREADS), BLOCKS_PER_SM * sms), THREADS


def check_input(x: Tensor) -> None:
    """What the kernel takes: a contiguous 4-D (B, H, W, C) uint8 tensor."""
    if x.dtype != torch.uint8:
        raise TypeError(f"u8norm takes uint8, got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"u8norm takes (B, H, W, C), got shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("u8norm takes a contiguous NHWC tensor")


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def u8_to_unit_nchw_cuda(x: Tensor) -> Tensor:
    """(B, H, W, C) uint8 on the card -> (B, C, H, W) float32, ``x / 255``
    correctly rounded. One launch on the current stream; does not synchronise."""
    global launches
    if not x.is_cuda:
        raise ValueError(f"u8norm_cuda needs a CUDA tensor, got device {x.device}")
    check_input(x)
    bsz, h, w, c = x.shape
    y = torch.empty((bsz, c, h, w), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y
    grid, threads = plan(y.numel(), _sms(x.device))
    lib = load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.u8norm_nhwc_to_nchw(x.data_ptr(), y.data_ptr(), bsz, h, w, c, grid, threads,
                                      stream)
    if err != 0:
        raise RuntimeError(f"u8norm launch failed: {lib.u8norm_error_string(err).decode()} "
                           f"(shape {tuple(x.shape)}, grid {grid}, threads {threads})")
    launches += 1
    return y
