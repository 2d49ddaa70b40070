"""Binding of the hand-written CUDA normalize kernel (csrc/u8norm.cu).

Replaces the JAX package's in-step ``u8_to_unit_f32``
(soft_intro_vae_tpu/ops/u8norm.py): one launch turns a uint8 NHWC batch on
the card into float32 in the same NHWC order, each value the correctly
rounded ``i / 255``, returned as the (B, C, H, W) tensor with channels-last
strides that the image nets take. The source's header says why PyTorch's own
divide is not used, what bounds the kernel and how it is laid out.

Build and launch: ``ops/cuda_build.py`` (its module doc), on the first call
with a CUDA tensor, never at import; the launch counts under ``u8norm``. A
build or launch failure raises; there is no fallback to the plain version.
``plan`` and ``check_input`` are plain Python, so the CPU tests reach them.
"""

from __future__ import annotations

import ctypes
import os
from typing import NamedTuple

import torch

from soft_intro_vae_torch.ops import cuda_build
from soft_intro_vae_torch.ops.cuda_build import H100_SMS

Tensor = torch.Tensor

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "u8norm.cu")
VEC = 16                     # input bytes a thread takes an iteration
THREADS = 128                # measured against 64 and 256 (tools/torch_u8norm_variants.py)
BLOCKS_PER_SM = 16           # grid cap: the grid-stride loop takes the rest


class Plan(NamedTuple):
    """One launch: ``head`` elements one a thread up to the input's first
    16-byte boundary, ``vectors`` runs of 16 bytes one a thread an iteration
    of a grid-stride loop (as four 4-byte words a grid stride apart), ``tail``
    elements one a thread after them."""

    head: int
    vectors: int
    tail: int
    grid: int
    threads: int


def spec() -> cuda_build.Spec:
    """The build of this kernel: (source, library stem, extra nvcc flags)."""
    return (_SRC, "u8norm", ())


def _declare(lib: ctypes.CDLL) -> None:
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.u8norm_to_unit_nhwc.argtypes = [p, p, ll, ll, ll, ll, i, i, p]
    lib.u8norm_to_unit_nhwc.restype = ctypes.c_int


_library = cuda_build.Library(spec, _declare, "u8norm")


def load() -> ctypes.CDLL:
    """Build (if needed) and load the library once per process."""
    return _library.load()


def plan(n: int, offset: int = 0, sms: int = H100_SMS) -> Plan:
    """The launch for ``n`` elements whose input starts ``offset`` bytes past
    a 16-byte boundary (``data_ptr() % 16``): one thread a 16-byte run, or a
    head or tail element, the grid capped at BLOCKS_PER_SM blocks an SM."""
    if n <= 0 or sms <= 0:
        raise ValueError(f"empty launch: {n} elements on {sms} SMs")
    if not 0 <= offset < VEC:
        raise ValueError(f"offset must be in [0, {VEC}), got {offset}")
    head = min(-offset % VEC, n)
    vectors = (n - head) // VEC
    tail = n - head - VEC * vectors
    work = max(vectors, head, tail)
    return Plan(head, vectors, tail, min(-(-work // THREADS), BLOCKS_PER_SM * sms), THREADS)


def check_input(x: Tensor) -> None:
    """What the kernel takes: a contiguous 4-D (B, H, W, C) uint8 tensor."""
    if x.dtype != torch.uint8:
        raise TypeError(f"u8norm takes uint8, got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"u8norm takes (B, H, W, C), got shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("u8norm takes a contiguous NHWC tensor")


def u8_to_unit_nchw_cuda(x: Tensor) -> Tensor:
    """(B, H, W, C) uint8 on the card -> (B, C, H, W) float32 with
    channels-last strides, ``x / 255`` correctly rounded. One launch on the
    current stream; does not synchronise."""
    if not x.is_cuda:
        raise ValueError(f"u8norm_cuda needs a CUDA tensor, got device {x.device}")
    check_input(x)
    y = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y.permute(0, 3, 1, 2)
    p = plan(y.numel(), x.data_ptr() % VEC, cuda_build.sm_count(x.device))
    _library.launch("u8norm", "u8norm_to_unit_nhwc", x.device, x.data_ptr(), y.data_ptr(),
                    y.numel(), p.head, p.vectors, p.tail, p.grid, p.threads,
                    context=f"shape {tuple(x.shape)}, {p}")
    return y.permute(0, 3, 1, 2)
