"""Binding of the hand-written CUDA fused-norm kernels (csrc/bias_act_norm.cu).

Replaces the TPU kernels of soft_intro_vae_tpu/ops/adain_pallas.py:
``_fwd_pallas`` (``forward`` here, one launch) and ``_bwd_pallas``
(``backward`` here, one launch). The source's header says what bounds them
and how they are laid out. Built, loaded and launched by
``ops/cuda_build.py`` (its module doc) on the first call with a CUDA tensor,
never at import, in one ``nvcc`` round with the blur's library
(``cuda_build.BUILT_TOGETHER``); the launches count under
``bias_act_norm_fwd`` and ``bias_act_norm_bwd``.

Layout NHWC: x a channels-last (B, C, H, W) tensor in float32 or bfloat16, n
(B, H, W) f32, bias and nw (C,) f32, g and b (B, C) f32, all contiguous on
one device. The wrappers check that and raise on anything the kernels do not
take; they launch on the current stream and do not synchronise. The items of
a launch meet through an int32 buffer of counters (``_flags``), zeroed once
and left usable by every launch; launches share a buffer only with the
launches of their own stream, which run one after another.

``plan`` picks each launch's shape from (B, C, S, dtype, direction) alone, in
plain Python so that the CPU tests can hold it to its invariants; the C entry
points check the plan they are given and refuse one that does not fit.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
import os
from typing import Dict, Optional, Tuple

import torch

from soft_intro_vae_torch.ops import cuda_build
from soft_intro_vae_torch.ops.cuda_build import H100_SMS
from soft_intro_vae_torch.ops.cuda_build import SM90_SMEM as BLOCK_SMEM

Tensor = torch.Tensor

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "bias_act_norm.cu")
CORR_K = 0.8 / math.sqrt(2.0 * math.pi)
MODES = {"plain": 0, "noise": 1, "corr": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ELEM_BYTES = {torch.float32: 4, torch.bfloat16: 2}
DIRECTIONS = ("fwd", "bwd")

# Launch-plan limits; csrc/bias_act_norm.cu keeps the same numbers and checks them.
STATIC_SMEM = 1024           # bound on the kernels' static shared memory
MAX_DYNAMIC_SMEM = BLOCK_SMEM - STATIC_SMEM
MAX_THREADS = 256
MAX_IMAGES = 65536
UNIT = 4                     # channels a thread takes a step, where C * bytes(T) % 16 == 0
CHUNK_BYTES = 32 * 1024      # staged bytes a chunk, a slot of the ring (at least one pixel)
TILE_BYTES = 256 * 1024      # staged bytes a tile aims at
CTAS_PER_SM = 3              # the kernels' __launch_bounds__
ITEMS_PER_SLOT = 2           # the fewest items a launch has for each CTA the card holds


def spec() -> cuda_build.Spec:
    """The build of these kernels: (source, library stem, extra nvcc flags)."""
    return (_SRC, "bias_act_norm", ())


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.bias_act_norm_fwd.argtypes = [p] * 11 + [i] * 6 + [i] * 8 + [f] * 4 + [p]
    lib.bias_act_norm_fwd.restype = ctypes.c_int
    lib.bias_act_norm_bwd.argtypes = [p] * 17 + [i] * 6 + [i] * 8 + [f] * 5 + [p]
    lib.bias_act_norm_bwd.restype = ctypes.c_int


_library = cuda_build.Library(spec, _declare, "bias_act_norm")


def library_path() -> str:
    return cuda_build.library_path(*spec())


def load() -> ctypes.CDLL:
    """Build (if needed) and load the library once per process."""
    return _library.load()


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch's shape (the source's header explains the items).

    unit, channels a thread takes a step (UNIT where every pixel's run is 16
    bytes' worth, else 1); rows R, threads a unit (threads = R * C / unit);
    chunk, pixels a slot of the two-slot ring stages; pixels P, pixels a
    tile, a contiguous run of P * C elements; tiles T an image; smem, dynamic
    shared bytes (two slots of a chunk's arrays and noise run, the sums'
    scratch); grid, CTAs: 2 * B * T, a sums and an apply item a tile.
    """

    unit: int
    rows: int
    threads: int
    chunk: int
    pixels: int
    tiles: int
    smem: int
    grid: int

    def args(self) -> Tuple[int, ...]:
        """The plan in the C entry points' order."""
        return dataclasses.astuple(self)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def plan(bsz: int, ch: int, size: int, dtype: torch.dtype, direction: str,
         sms: int = H100_SMS) -> Plan:
    """The launch plan of one kernel call on x (bsz, ch, S = size) of ``dtype``
    on a card of ``sms`` SMs: chunks of as many pixels as fit CHUNK_BYTES of
    staged arrays; tiles of about TILE_BYTES, more where the launch would
    give the card's CTA slots fewer than ITEMS_PER_SLOT items each, but no
    more tiles than chunks. Raises ValueError for more than MAX_THREADS units of
    channels (1024 channels) or more than MAX_IMAGES images.
    """
    if direction not in DIRECTIONS:
        raise ValueError(f"direction must be one of {DIRECTIONS}, got {direction!r}")
    if dtype not in _ELEM_BYTES:
        raise TypeError(f"x must be float32 or bfloat16, got {dtype}")
    if min(bsz, ch, size) <= 0:
        raise ValueError(f"empty shape: B {bsz}, C {ch}, S {size}")
    if bsz > MAX_IMAGES:
        raise ValueError(f"{bsz} images: the kernels take at most {MAX_IMAGES}")
    es = _ELEM_BYTES[dtype]
    arrays = 1 if direction == "fwd" else 2  # x; x and dy
    unit = UNIT if ch * es % 16 == 0 else 1
    units = ch // unit
    if units > MAX_THREADS:
        raise ValueError(f"{ch} channels of {dtype} need {units} threads a pixel, more than "
                         f"{MAX_THREADS}")
    rows = MAX_THREADS // units
    threads = rows * units
    pixel_bytes = arrays * ch * es
    chunk = min(size, max(1, CHUNK_BYTES // pixel_bytes))
    tiles = max(-(-size * pixel_bytes // TILE_BYTES),
                -(-ITEMS_PER_SLOT * CTAS_PER_SM * sms // (2 * bsz)))
    tiles = min(tiles, -(-size // chunk))
    pixels = -(-size // tiles)
    tiles = -(-size // pixels)
    smem = (2 * (arrays * _round_up(chunk * ch * es, 16) + _round_up(chunk, 4) * 4)
            + 2 * unit * threads * 4)
    return Plan(unit, rows, threads, chunk, pixels, tiles, smem, 2 * bsz * tiles)


def corr_constants(corr_scale: float) -> Tuple[float, float, float]:
    """(ks, c2, 1/s^2) of the corr inject ks*exp(x*x*c2), as both versions use them."""
    s = float(corr_scale)
    return CORR_K * s, -0.5 / (s * s), 1.0 / (s * s)


def _check(name: str, t: Optional[Tensor], shape, device, dtype=torch.float32) -> None:
    if t is None:
        raise ValueError(f"{name} is required")
    if t.device != device:
        raise ValueError(f"{name} must be on {device}, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_activation(name: str, t: Tensor, shape, device, dtype) -> None:
    _check(name, t.permute(0, 2, 3, 1), (shape[0], shape[2], shape[3], shape[1]), device, dtype)


def _check_common(x: Tensor, bias, g, n, nw, mode: str) -> Tuple[int, int, int]:
    if not x.is_cuda:
        raise ValueError(f"x must be a CUDA tensor, got device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4 or x.numel() == 0:
        raise ValueError(f"x must be a non-empty (B, C, H, W) tensor, got {tuple(x.shape)}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("x must be channels-last (NHWC in memory)")
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    bsz, ch, h, w = x.shape
    _check("bias", bias, (ch,), x.device)
    if g is not None:
        _check("g", g, (bsz, ch), x.device)
    if mode == "noise":
        _check("n", n, (bsz, h, w), x.device)
        _check("nw", nw, (ch,), x.device)
    return bsz, ch, h * w


def _ptr(t: Optional[Tensor]):
    return None if t is None else t.data_ptr()


def _aligned(t: Optional[Tensor]) -> Optional[Tensor]:
    """t, or a fresh (16-byte aligned) copy in its layout where a view starts
    off 16 bytes: the kernels' bulk copies and vector loads need aligned bases."""
    return t if t is None or t.data_ptr() % 16 == 0 else t.clone()


_FLAGS: Dict[Tuple[torch.device, int], Tensor] = {}


def _flags(device: torch.device, stream: int) -> Tensor:
    """The counters (2 + 3 * MAX_IMAGES int32) of the launches on ``stream``
    (the raw stream handle) of ``device``, zeroed once; every launch leaves
    them usable by the next (the source's header). Two streams never share
    counters, so launches that may overlap never meet in them. A stream's
    first launch must run eagerly: a buffer made under a CUDA graph's capture
    would belong to the graph's memory pool."""
    flags = _FLAGS.get((device, stream))
    if flags is None:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the fused-norm kernels' first launch on a stream is being "
                               "captured: run one call on that stream eagerly first")
        flags = _FLAGS.setdefault((device, stream), torch.zeros(
            2 + 3 * MAX_IMAGES, dtype=torch.int32, device=device))
    return flags


def _stream_flags(x: Tensor) -> Tensor:
    """The counters of the current stream of x's device."""
    return _flags(x.device, torch.cuda.current_stream(x.device).cuda_stream)


def forward(x: Tensor, bias: Tensor, g: Optional[Tensor] = None, b: Optional[Tensor] = None,
            n: Optional[Tensor] = None, nw: Optional[Tensor] = None, *, mode: str = "plain",
            eps: float = 1e-8, slope: float = 0.2, corr_scale: float = 1.0
            ) -> Tuple[Tensor, Tensor, Tensor]:
    """(y, mean, var): y like x (channels-last), mean and var (B, C) f32. One
    kernel launch, shaped by ``plan(B, C, H*W, x.dtype, "fwd")``."""
    bsz, ch, size = _check_common(x, bias, g, n, nw, mode)
    if (g is None) != (b is None):
        raise ValueError("g and b come together (AdaIN) or not at all")
    if b is not None:
        _check("b", b, (bsz, ch), x.device)
    pl = plan(bsz, ch, size, x.dtype, "fwd", cuda_build.sm_count(x.device))
    x = _aligned(x)
    n = _aligned(n) if mode == "noise" else None
    y = torch.empty_like(x)
    stats = torch.empty((2, bsz, ch), dtype=torch.float32, device=x.device)
    part = torch.empty((bsz * pl.tiles, 2 * ch), dtype=torch.float32, device=x.device)
    ks, c2, _ = corr_constants(corr_scale)
    _library.launch(
        "bias_act_norm_fwd", "bias_act_norm_fwd", x.device,
        x.data_ptr(), bias.data_ptr(), _ptr(g), _ptr(b),
        _ptr(n) if mode == "noise" else None, _ptr(nw) if mode == "noise" else None,
        y.data_ptr(), stats[0].data_ptr(), stats[1].data_ptr(), part.data_ptr(),
        _stream_flags(x).data_ptr(), bsz, ch, size,
        _DTYPES[x.dtype], MODES[mode], int(g is not None), *pl.args(), eps, slope, ks, c2,
        context=pl)
    return y, stats[0], stats[1]


def backward(dy: Tensor, x: Tensor, bias: Tensor, g: Optional[Tensor], n: Optional[Tensor],
             nw: Optional[Tensor], mean: Tensor, var: Tensor, dm: Tensor, dv: Tensor, *,
             mode: str = "plain", eps: float = 1e-8, slope: float = 0.2,
             corr_scale: float = 1.0) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """(dx, d_bst, d_g, d_bias, d_nw): dx like x (channels-last), the rest (B, C)
    f32 per (b, c), not yet summed over b. One kernel launch, shaped by
    ``plan(..., "bwd")``."""
    bsz, ch, size = _check_common(x, bias, g, n, nw, mode)
    _check_activation("dy", dy, tuple(x.shape), x.device, x.dtype)
    for name, t in (("mean", mean), ("var", var), ("dm", dm), ("dv", dv)):
        _check(name, t, (bsz, ch), x.device)
    pl = plan(bsz, ch, size, x.dtype, "bwd", cuda_build.sm_count(x.device))
    dy, x = _aligned(dy), _aligned(x)
    n = _aligned(n) if mode == "noise" else None
    dx = torch.empty_like(x)
    sums = torch.empty((4, bsz, ch), dtype=torch.float32, device=x.device)
    part = torch.empty((bsz * pl.tiles, 2 * ch), dtype=torch.float32, device=x.device)
    ks, c2, inv_s2 = corr_constants(corr_scale)
    _library.launch(
        "bias_act_norm_bwd", "bias_act_norm_bwd", x.device,
        dy.data_ptr(), x.data_ptr(), bias.data_ptr(), _ptr(g),
        _ptr(n) if mode == "noise" else None, _ptr(nw) if mode == "noise" else None,
        mean.data_ptr(), var.data_ptr(), dm.data_ptr(), dv.data_ptr(), dx.data_ptr(),
        sums[0].data_ptr(), sums[1].data_ptr(), sums[2].data_ptr(), sums[3].data_ptr(),
        part.data_ptr(), _stream_flags(x).data_ptr(),
        bsz, ch, size, _DTYPES[x.dtype], MODES[mode], int(g is not None),
        *pl.args(), eps, slope, ks, c2, inv_s2, context=pl)
    return dx, sums[0], sums[1], sums[2], sums[3]
