"""Binding of the hand-written float32 convolution kernels (csrc/conv_f32.cu).

A stride-1 convolution with padding (k - 1) / 2 on channels-last float32
tensors, as implicit GEMMs in full float32 FFMA: ``fprop`` (the forward,
``bias`` added in its epilogue), ``dgrad`` (the input gradient: ``fprop`` on
the output gradient with the weight flipped in (r, s) and its channels
swapped, one ``conv_f32_flip`` re-layout a call) and ``wgrad`` (the weight
gradient, in the weight's channels-last layout). It replaces no TPU kernel;
the source's header says why it exists, what bounds it and how it is laid
out.

The launch plans (``plan_fprop``, ``plan_wgrad``) are plain Python, so the
CPU tests reach them: a tile from the GEMM's shape (the output's rows and
columns), and a split of the reduction over CTAs where the tiles alone would
leave SMs idle. A split writes its partial sums into a workspace from
``torch.empty``, and ``conv_f32_reduce`` adds them in split order: no float
atomics, so a call gives the same bits every time, eager or replayed.

Build and launch: ``ops/cuda_build.py`` (its module doc), on the first call
with a CUDA tensor, never at import. A launch counts under its kernel's name
(``conv_f32_fprop``, ``conv_f32_wgrad``, ``conv_f32_reduce``,
``conv_f32_flip``). A build or launch failure raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import os
from typing import NamedTuple, Optional, Tuple

import torch

from soft_intro_vae_torch.ops import cuda_build
from soft_intro_vae_torch.ops.cuda_build import H100_SMS

Tensor = torch.Tensor

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "conv_f32.cu")
BK = 16                      # K-slice of an fprop tile; pixels of a wgrad slice
REDUCE_THREADS = 256
MAX_SPLITS = 128
MIN_SLICES_PER_SPLIT = 4     # a split's share of the reduction, in slices of BK
# the card's rates in the split model (H100 SXM data sheet), and a launch's cost
FP32_FLOPS = 67e12
MEMORY_BYTES_PER_S = 3.35e12
LAUNCH_S = 3e-6


class Tile(NamedTuple):
    """One compiled tile shape (the C entry points' ``tile`` index): a CTA's
    ``bm`` x ``bn`` output tile, a thread's ``tm`` x ``tn``, a ring of
    ``stages`` slices; ``ctas_per_sm`` is how many fit an SM at once (the
    ptxas registers and the shared memory, as built for sm_90a); ``staged``:
    the register-staged fprop kernel (16-byte loads only), else the K-major
    one."""

    bm: int
    bn: int
    tm: int
    tn: int
    stages: int
    ctas_per_sm: int
    staged: bool = False

    @property
    def threads(self) -> int:
        return (self.bm // self.tm) * (self.bn // self.tn)


# csrc/conv_f32.cu conv_f32_fprop's tiles: (pixels x output channels); 0, 1
# register-staged (Cin a multiple of 4), 2 for a few output channels, 3, 4
# K-major (any Cin)
FPROP_TILES = (Tile(128, 128, 8, 8, 2, 1, True), Tile(256, 64, 8, 8, 2, 1, True),
               Tile(128, 4, 4, 4, 4, 4), Tile(128, 128, 8, 8, 4, 1), Tile(256, 64, 8, 8, 4, 1))
# conv_f32_wgrad's: (output channels x k*k*Cin)
WGRAD_TILES = (Tile(128, 128, 8, 8, 4, 1), Tile(64, 128, 8, 8, 4, 2), Tile(4, 128, 4, 4, 4, 4))


def fprop_smem(t: Tile) -> int:
    """Shared bytes of an fprop CTA: the staged kernel's two MN-major slices,
    or the K-major ring, rows padded by 4 floats, and a 16-byte (m, oh, ow)
    record a tile row."""
    if t.staged:
        return t.stages * BK * (t.bm + t.bn) * 4
    return t.stages * (t.bm + t.bn) * (BK + 4) * 4 + t.bm * 16


def wgrad_smem(t: Tile) -> int:
    """Shared bytes of a wgrad CTA: the ring of MN-major slices."""
    return t.stages * BK * (t.bm + t.bn) * 4


class Plan(NamedTuple):
    """One GEMM launch: ``tile`` (index into the tile table), ``splits`` x
    ``per_split`` slices of the reduction (BK each), ``threads`` and
    ``smem`` as the tile has them, ``grid`` CTAs (rows, columns, splits)."""

    tile: int
    splits: int
    per_split: int
    threads: int
    smem: int
    grid: Tuple[int, int, int]


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def split(tile: Tile, tiles: int, slices: int, outputs: int, sms: int) -> Tuple[int, int]:
    """(splits, slices a split) for ``tiles`` CTAs of ``tile`` over a
    reduction of ``slices`` slices into ``outputs`` floats, on ``sms`` SMs:
    the split count whose time is least by a model of the card, then the
    count that leaves no split empty. The model: waves of ``ctas_per_sm`` CTAs
    an SM, each CTA's slices at its share of FP32_FLOPS; a split writes its
    partial tile and the reduction reads them all and writes the output at
    MEMORY_BYTES_PER_S, after one launch more. At most MAX_SPLITS splits of
    at least MIN_SLICES_PER_SPLIT slices; the fewest splits on a tie."""
    slots = sms * tile.ctas_per_sm
    slice_s = 2.0 * tile.bm * tile.bn * BK * slots / FP32_FLOPS
    most = max(1, min(MAX_SPLITS, slices // MIN_SLICES_PER_SPLIT))
    best, cost = 1, None
    for s in range(1, most + 1):
        per = _ceil_div(slices, s)
        c = _ceil_div(tiles * s, slots) * per * slice_s
        if s > 1:
            c += (2 * s + 1) * outputs * 4 / MEMORY_BYTES_PER_S + LAUNCH_S
        if cost is None or c < cost:
            best, cost = s, c
    per = _ceil_div(slices, best)
    return _ceil_div(slices, per), per


def fprop_tile(cout: int, vec: int = 4) -> int:
    """The fprop tile for ``cout`` output channels (the GEMM's columns) and
    copies of ``vec`` floats (4: Cin a multiple of 4, 16-byte aligned)."""
    if cout <= 4:
        return 2
    if vec == 4:
        return 1 if cout <= 64 else 0
    return 4 if cout <= 64 else 3


def wgrad_tile(cout: int) -> int:
    """The wgrad tile for ``cout`` output channels (the GEMM's rows)."""
    if cout <= 4:
        return 2
    return 1 if cout <= 64 else 0


def plan_fprop(m: int, cout: int, k: int, sms: int = H100_SMS, vec: int = 4) -> Plan:
    """The fprop (or dgrad) launch for ``m`` output pixels, ``cout`` output
    channels and a reduction of ``k`` = ksize^2 * Cin, copies of ``vec``
    floats."""
    if min(m, cout, k) <= 0:
        raise ValueError(f"empty convolution: M {m}, N {cout}, K {k}")
    idx = fprop_tile(cout, vec)
    t = FPROP_TILES[idx]
    rows, cols = _ceil_div(m, t.bm), _ceil_div(cout, t.bn)
    splits, per = split(t, rows * cols, _ceil_div(k, BK), m * cout, sms)
    return Plan(idx, splits, per, t.threads, fprop_smem(t), (rows, cols, splits))


def plan_wgrad(pixels: int, cout: int, k: int, sms: int = H100_SMS) -> Plan:
    """The wgrad launch for a ``cout`` x ``k`` weight over ``pixels`` pixels."""
    if min(pixels, cout, k) <= 0:
        raise ValueError(f"empty convolution: pixels {pixels}, Cout {cout}, K {k}")
    idx = wgrad_tile(cout)
    t = WGRAD_TILES[idx]
    rows, cols = _ceil_div(cout, t.bm), _ceil_div(k, t.bn)
    splits, per = split(t, rows * cols, _ceil_div(pixels, BK), cout * k, sms)
    return Plan(idx, splits, per, t.threads, wgrad_smem(t), (rows, cols, splits))


def reduce_blocks(total: int, sms: int = H100_SMS) -> int:
    """CTAs of the split reduction over ``total`` outputs: four elements a
    thread, at most 8 CTAs an SM (the kernel strides over the rest)."""
    return max(1, min(_ceil_div(total, 4 * REDUCE_THREADS), 8 * sms))


def spec() -> cuda_build.Spec:
    """The build of these kernels: (source, library stem, extra nvcc flags)."""
    return (_SRC, "conv_f32", ())


def _declare(lib: ctypes.CDLL) -> None:
    p, i, s = ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p
    lib.conv_f32_fprop.argtypes = [p, p, p, p] + [i] * 12 + [s]
    lib.conv_f32_wgrad.argtypes = [p, p, p] + [i] * 13 + [s]
    lib.conv_f32_reduce.argtypes = [p, p, p, ctypes.c_longlong, i, i, i, s]
    lib.conv_f32_flip.argtypes = [p, p, i, i, i, s]
    for fn in (lib.conv_f32_fprop, lib.conv_f32_wgrad, lib.conv_f32_reduce, lib.conv_f32_flip):
        fn.restype = ctypes.c_int


_library = cuda_build.Library(spec, _declare, "conv_f32")


def load() -> ctypes.CDLL:
    """Build (if needed) and load the library once per process."""
    return _library.load()


def check_input(t: Tensor, what: str) -> None:
    """What the kernels take: a channels-last (B, C, H, W) float32 CUDA tensor."""
    if not t.is_cuda:
        raise ValueError(f"the float32 conv kernels need CUDA tensors, got {what} on {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"the float32 conv kernels take float32, got {what} in {t.dtype}")
    if t.dim() != 4:
        raise ValueError(f"the float32 conv kernels take 4-D tensors, got {what} of shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"the float32 conv kernels take channels-last tensors ({what})")


def _vec(t: Tensor, channels: int) -> int:
    """16-byte copies where a pixel's channels are whole 16-byte pieces."""
    return 4 if channels % 4 == 0 and t.data_ptr() % 16 == 0 else 1


def _empty_nhwc(like: Tensor, b: int, c: int, h: int, w: int) -> Tensor:
    return torch.empty((b, c, h, w), dtype=like.dtype, device=like.device,
                       memory_format=torch.channels_last)


def _reduce(ws: Tensor, bias: Optional[Tensor], out: Tensor, n: int, context: str) -> None:
    total = out.numel()
    blocks = reduce_blocks(total, cuda_build.sm_count(out.device))
    _library.launch("conv_f32_reduce", "conv_f32_reduce", out.device, ws.data_ptr(),
                    None if bias is None else bias.data_ptr(), out.data_ptr(), total, n,
                    ws.shape[0], blocks, context=context)


def fprop(x: Tensor, weight: Tensor, bias: Optional[Tensor] = None) -> Tensor:
    """y = conv(x, weight) + bias: x (B, Cin, H, W) and weight (Cout, Cin, k,
    k) channels-last float32 on the card, k odd, stride 1, padding (k - 1) /
    2; y (B, Cout, H, W) channels-last. One launch, and a reduction where the
    plan splits K; no synchronisation."""
    check_input(x, "x")
    check_input(weight, "weight")
    b, cin, h, w = x.shape
    cout, wcin, kh, kw = weight.shape
    if wcin != cin or kh != kw or kh % 2 == 0:
        raise ValueError(f"fprop takes an odd square weight of x's {cin} channels, got "
                         f"{tuple(weight.shape)}")
    if bias is not None and (bias.shape != (cout,) or bias.dtype != torch.float32
                             or not bias.is_contiguous()):
        raise ValueError(f"bias must be a contiguous float32 ({cout},), got {tuple(bias.shape)}")
    y = _empty_nhwc(x, b, cout, h, w)
    if y.numel() == 0:
        return y
    m, k = b * h * w, kh * kh * cin
    vec = min(_vec(x, cin), _vec(weight, cin))
    p = plan_fprop(m, cout, k, cuda_build.sm_count(x.device), vec)
    context = f"x {tuple(x.shape)}, weight {tuple(weight.shape)}, vec {vec}, {p}"
    out = y if p.splits == 1 else torch.empty((p.splits, m, cout), dtype=x.dtype, device=x.device)
    _library.launch("conv_f32_fprop", "conv_f32_fprop", x.device, x.data_ptr(),
                    weight.data_ptr(), None if bias is None or p.splits > 1 else bias.data_ptr(),
                    out.data_ptr(), b, h, w, cin, cout, kh, p.tile, vec, p.splits, p.per_split,
                    p.threads, p.smem, context=context)
    if p.splits > 1:
        _reduce(out, bias, y, cout, context)
    return y


def flip(weight: Tensor) -> Tensor:
    """The input gradient's weight: (Cin, Cout, k, k) channels-last with
    wt[c, n, r, s] = weight[n, c, k-1-r, k-1-s]."""
    check_input(weight, "weight")
    cout, cin, k, _ = weight.shape
    wt = _empty_nhwc(weight, cin, cout, k, k)
    _library.launch("conv_f32_flip", "conv_f32_flip", weight.device, weight.data_ptr(),
                    wt.data_ptr(), cout, cin, k, context=f"weight {tuple(weight.shape)}")
    return wt


def dgrad(dy: Tensor, weight: Tensor) -> Tensor:
    """The input gradient of ``fprop`` for the output gradient ``dy``:
    ``fprop`` on dy with the flipped, channel-swapped weight."""
    return fprop(dy, flip(weight))


def wgrad(x: Tensor, dy: Tensor, ksize: int) -> Tensor:
    """The weight gradient of ``fprop`` for x and the output gradient dy:
    (Cout, Cin, k, k) channels-last, sum over the B*H*W pixels of dy times
    the patch of x at each tap. One launch, and a reduction where the plan
    splits the pixels."""
    check_input(x, "x")
    check_input(dy, "dy")
    b, cin, h, w = x.shape
    cout = dy.shape[1]
    if dy.shape != (b, cout, h, w) or ksize % 2 == 0:
        raise ValueError(f"wgrad takes dy of x's batch and plane and an odd ksize, got x "
                         f"{tuple(x.shape)}, dy {tuple(dy.shape)}, ksize {ksize}")
    dw = _empty_nhwc(x, cout, cin, ksize, ksize)
    if x.numel() == 0:
        return dw.zero_()
    m, k = b * h * w, ksize * ksize * cin
    p = plan_wgrad(m, cout, k, cuda_build.sm_count(x.device))
    vec_a, vec_b = _vec(dy, cout), _vec(x, cin)
    context = f"x {tuple(x.shape)}, dy {tuple(dy.shape)}, k {ksize}, vec {vec_a}/{vec_b}, {p}"
    out = dw if p.splits == 1 else torch.empty((p.splits, cout, k), dtype=x.dtype, device=x.device)
    _library.launch("conv_f32_wgrad", "conv_f32_wgrad", x.device, x.data_ptr(), dy.data_ptr(),
                    out.data_ptr(), b, h, w, cin, cout, ksize, p.tile, vec_a, vec_b, p.splits,
                    p.per_split, p.threads, p.smem, context=context)
    if p.splits > 1:
        _reduce(out, None, dw, k, context)
    return dw
