"""Binding of the hand-written CUDA blur kernel (csrc/blur3x3.cu).

The style nets' fixed [1,2,1] x [1,2,1] / 16 blur with zero padding, on an
NCHW tensor of float32 or bfloat16, one launch a call, forward or backward:
the backward is the same kernel on the output gradient (``flip`` only sums
the nine terms in the order ATen's depthwise backward does). It replaces no
TPU kernel; the source's header says why it exists, what bounds it and how
it is laid out.

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
from soft_intro_vae_torch.ops.cuda_build import SM90_SMEM as MAX_SMEM

Tensor = torch.Tensor

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "blur3x3.cu")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ELEM_BYTES = {torch.float32: 4, torch.bfloat16: 2}
VEC_BYTES = 16               # the widest load or store a thread makes
MAX_THREADS = 1024
TILE_BYTES = 32 * 1024       # staged bytes a CTA aims at
THREADS = 256                # threads a CTA aims at
MIN_CTAS_PER_SM = 2          # small planes: the fewest CTAs an SM gets


class Plan(NamedTuple):
    """One launch. ``vec`` elements a thread takes in a row (W // vec threads
    cover it); a CTA takes ``rows`` output rows of a plane (``strips`` CTAs a
    plane) or, where ``planes`` > 1, that many whole planes; its ``walkers``
    (threads // (W // vec)) each take runs of ``run_rows`` consecutive rows
    of one plane, ``runs`` runs a plane; ``smem`` staged bytes; ``grid``
    CTAs."""

    vec: int
    rows: int
    strips: int
    planes: int
    walkers: int
    runs: int
    run_rows: int
    threads: int
    smem: int
    grid: int

    def args(self):
        """The plan in the C entry point's order."""
        return (self.vec, self.rows, self.strips, self.planes, self.walkers, self.runs,
                self.run_rows, self.threads, self.smem, self.grid)


def spec() -> cuda_build.Spec:
    """The build of this kernel: (source, library stem, extra nvcc flags)."""
    return (_SRC, "blur3x3", ())


def _declare(lib: ctypes.CDLL) -> None:
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.blur3x3.argtypes = [p, p, ll] + [i] * 14 + [p]
    lib.blur3x3.restype = ctypes.c_int


_library = cuda_build.Library(spec, _declare, "blur3x3")


def load() -> ctypes.CDLL:
    """Build (if needed, with the fused norm's library) and load the library
    once per process."""
    return _library.load()


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def plan(planes: int, h: int, w: int, dtype: torch.dtype, sms: int = H100_SMS) -> Plan:
    """The launch for ``planes`` (B * C) planes of h x w elements of ``dtype``.

    A plane of at most TILE_BYTES goes whole to a CTA with others, as many as
    fill the tile while every SM still gets MIN_CTAS_PER_SM CTAs; a larger
    plane is cut into strips of equal rows that, with the halo rows, fill the
    tile. Raises ValueError where one row is too wide for a CTA."""
    if dtype not in _ELEM_BYTES:
        raise TypeError(f"the blur takes float32 or bfloat16, got {dtype}")
    if min(planes, h, w) <= 0:
        raise ValueError(f"empty launch: {planes} planes of {h} x {w}")
    es = _ELEM_BYTES[dtype]
    vec = VEC_BYTES // es
    while w % vec:
        vec //= 2
    across = w // vec
    if across > MAX_THREADS:
        raise ValueError(f"a row of {w} {dtype} elements needs {across} threads, more than "
                         f"{MAX_THREADS}")
    row_bytes, plane_bytes = w * es, h * w * es
    if plane_bytes <= TILE_BYTES:
        per_cta = max(1, min(TILE_BYTES // plane_bytes, planes // (MIN_CTAS_PER_SM * sms)))
        rows, strips, staged = h, 1, per_cta * plane_bytes
    else:
        per_cta = 1
        fit = max(TILE_BYTES, 3 * row_bytes) // row_bytes - 2
        strips = _ceil_div(h, fit)
        rows = _ceil_div(h, strips)
        strips = _ceil_div(h, rows)
        staged = min(rows + 2, h) * row_bytes
    smem = _ceil_div(staged, 16) * 16
    if smem > MAX_SMEM:
        raise ValueError(f"a strip of rows of {w} {dtype} elements needs {smem} bytes of shared "
                         f"memory, more than {MAX_SMEM}")
    walkers = max(1, THREADS // across)
    runs = max(1, min(rows, walkers // per_cta))
    run_rows = _ceil_div(rows, runs)
    runs = _ceil_div(rows, run_rows)
    return Plan(vec, rows, strips, per_cta, walkers, runs, run_rows, across * walkers, smem,
                _ceil_div(planes, per_cta) * strips)


def check_input(x: Tensor) -> None:
    """What the kernel takes: a contiguous (B, C, H, W) float32 or bfloat16 tensor."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"the blur kernel takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"the blur takes (B, C, H, W), got shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("the blur kernel takes a contiguous NCHW tensor")


def blur3x3_cuda(x: Tensor, flip: bool = False) -> Tensor:
    """The blur of x (B, C, H, W) on the card, in x's type: one launch on the
    current stream, no synchronisation. ``flip`` sums the nine terms in the
    order of ATen's depthwise backward (the Function's backward)."""
    if not x.is_cuda:
        raise ValueError(f"blur3x3_cuda needs a CUDA tensor, got device {x.device}")
    check_input(x)
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    bsz, ch, h, w = x.shape
    p = plan(bsz * ch, h, w, x.dtype, cuda_build.sm_count(x.device))
    _library.launch("blur3x3", "blur3x3", x.device, x.data_ptr(), y.data_ptr(), bsz * ch, h, w,
                    _DTYPES[x.dtype], int(flip), *p.args(),
                    context=f"shape {tuple(x.shape)}, {x.dtype}, {p}")
    return y
