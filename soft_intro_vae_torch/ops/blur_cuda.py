"""Binding of the hand-written CUDA blur kernel (csrc/blur3x3.cu).

The style nets' fixed [1,2,1] x [1,2,1] / 16 blur with zero padding, on a
channels-last (B, C, H, W) tensor of float32 or bfloat16, one launch a call,
forward or backward: the backward is the same kernel on the output gradient
(``flip`` only sums the nine terms in the order ATen's depthwise backward
does). It replaces no TPU kernel; the source's header says why it exists,
what bounds it and how it is laid out.

Build and launch: ``ops/cuda_build.py`` (its module doc), on the first call
with a CUDA tensor, never at import, in one ``nvcc`` round with the fused
norm's library (``cuda_build.BUILT_TOGETHER``: the style nets need both); a
launch, forward or backward, counts under ``blur3x3``. A build or launch
failure raises; there is no fallback to the plain version. ``plan`` and
``check_input`` are plain Python, so the CPU tests reach them.
"""

from __future__ import annotations

import ctypes
import os
from typing import NamedTuple

import torch

from soft_intro_vae_torch.ops import cuda_build
from soft_intro_vae_torch.ops.cuda_build import H100_SMS

Tensor = torch.Tensor

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "blur3x3.cu")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ELEM_BYTES = {torch.float32: 4, torch.bfloat16: 2}
VEC_BYTES = 16               # the widest load or store a thread makes
MAX_THREADS = 256            # the kernel's __launch_bounds__
THREADS = 256                # threads a CTA aims at
RING = 6                     # rows a CTA's ring stages (csrc/blur3x3.cu kRing)
MIN_CTAS_PER_SM = 4          # the grid a launch aims at, while bands are taller than MIN_ROWS
MIN_ROWS = 8


class Plan(NamedTuple):
    """One launch. A thread takes ``vec`` channels of one pixel (C // vec
    threads a pixel); a CTA takes ``cols`` consecutive pixels of a band of
    ``rows`` rows of one image, through a ring of RING staged rows of
    ``smem`` bytes; ``threads`` = cols * C // vec; ``grid`` CTAs: B *
    ceil(H / rows) * ceil(W / cols)."""

    vec: int
    cols: int
    rows: int
    threads: int
    smem: int
    grid: int

    def args(self):
        """The plan in the C entry point's order."""
        return tuple(self)


def spec() -> cuda_build.Spec:
    """The build of this kernel: (source, library stem, extra nvcc flags)."""
    return (_SRC, "blur3x3", ())


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.blur3x3.argtypes = [p, p] + [i] * 12 + [p]
    lib.blur3x3.restype = ctypes.c_int


_library = cuda_build.Library(spec, _declare, "blur3x3")


def load() -> ctypes.CDLL:
    """Build (if needed, with the fused norm's library) and load the library
    once per process."""
    return _library.load()


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def plan(bsz: int, ch: int, h: int, w: int, dtype: torch.dtype, sms: int = H100_SMS) -> Plan:
    """The launch for ``bsz`` images of h x w pixels of ``ch`` channels of ``dtype``.

    The widest unit of channels (16 bytes at most) that divides C; as many
    pixels a CTA as bring it to THREADS threads; bands of the whole image's
    rows, halved (down to MIN_ROWS) while the grid gives an SM fewer than
    MIN_CTAS_PER_SM CTAs. Raises ValueError where one pixel's channels need
    more than MAX_THREADS threads."""
    if dtype not in _ELEM_BYTES:
        raise TypeError(f"the blur takes float32 or bfloat16, got {dtype}")
    if min(bsz, ch, h, w) <= 0:
        raise ValueError(f"empty launch: {bsz} images of {ch} x {h} x {w}")
    es = _ELEM_BYTES[dtype]
    vec = VEC_BYTES // es
    while ch % vec:
        vec //= 2
    units = ch // vec
    if units > MAX_THREADS:
        raise ValueError(f"a pixel of {ch} {dtype} channels needs {units} threads, more than "
                         f"{MAX_THREADS}")
    cols = max(1, min(w, THREADS // units))
    col_blocks = _ceil_div(w, cols)
    rows = h
    while rows > MIN_ROWS and bsz * _ceil_div(h, rows) * col_blocks < MIN_CTAS_PER_SM * sms:
        rows = _ceil_div(rows, 2)
    smem = RING * (cols + 2) * ch * es
    return Plan(vec, cols, rows, cols * units, smem, bsz * _ceil_div(h, rows) * col_blocks)


def check_input(x: Tensor) -> None:
    """What the kernel takes: a channels-last (B, C, H, W) float32 or bfloat16 tensor."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"the blur kernel takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"the blur takes (B, C, H, W), got shape {tuple(x.shape)}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("the blur kernel takes a channels-last tensor (NHWC in memory)")


def blur3x3_cuda(x: Tensor, flip: bool = False) -> Tensor:
    """The blur of a channels-last x (B, C, H, W) on the card, in x's type and
    layout: one launch on the current stream, no synchronisation. ``flip``
    sums the nine terms in the order of ATen's depthwise backward (the
    Function's backward)."""
    if not x.is_cuda:
        raise ValueError(f"blur3x3_cuda needs a CUDA tensor, got device {x.device}")
    check_input(x)
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    bsz, ch, h, w = x.shape
    p = plan(bsz, ch, h, w, x.dtype, cuda_build.sm_count(x.device))
    if x.data_ptr() % (p.vec * x.element_size()):
        x = x.clone()  # a view that starts off a unit: the kernel's loads need whole units
    _library.launch("blur3x3", "blur3x3", x.device, x.data_ptr(), y.data_ptr(), bsz, h, w, ch,
                    _DTYPES[x.dtype], int(flip), *p.args(),
                    context=f"shape {tuple(x.shape)}, {x.dtype}, {p}")
    return y
