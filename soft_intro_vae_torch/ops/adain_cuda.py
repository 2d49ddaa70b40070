"""Binding of the hand-written CUDA fused-norm kernels (csrc/bias_act_norm.cu).

Replaces the TPU kernels of soft_intro_vae_tpu/ops/adain_pallas.py:
``_fwd_pallas`` (``forward`` here, one launch) and ``_bwd_pallas``
(``backward`` here, one launch). The source's header says what bounds them
and how they are laid out. Built, loaded and launched by
``ops/cuda_build.py`` (its module doc) on the first call with a CUDA tensor,
never at import, in one ``nvcc`` round with the blur's library
(``cuda_build.BUILT_TOGETHER``); the launches count under
``bias_act_norm_fwd`` and ``bias_act_norm_bwd``.

Layout NCHW: x (B, C, H, W) in float32 or bfloat16, n (B, H, W) f32, bias and
nw (C,) f32, g and b (B, C) f32, all contiguous on one device. The wrappers
check that and raise on anything the kernels do not take; they launch on the
current stream and do not synchronise.

``plan`` picks each launch's shape from (B, C, S, dtype, direction) alone, in
plain Python so that the CPU tests can hold it to its invariants; the C entry
points check the plan they are given and refuse one that does not fit.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
import os
from typing import Optional, Tuple

import torch

from soft_intro_vae_torch.ops import cuda_build
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
MAX_THREADS = 512
MAX_CLUSTER = 8              # the portable cluster size
SMALL_SIZE = 256             # planes of at most this many elements share a CTA
SMALL_THREADS = 128
# Chosen on the card with tools/torch_norm_plans.py (PERF.md):
STAGE_TARGET = 64 * 1024     # staged bytes per CTA the cluster size aims at
UNITS_PER_THREAD = 8         # 16-byte units a thread takes per pass, where the slice allows


def spec() -> cuda_build.Spec:
    """The build of these kernels: (source, library stem, extra nvcc flags)."""
    return (_SRC, "bias_act_norm", ())


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.bias_act_norm_fwd.argtypes = [p] * 9 + [i] * 6 + [i] * 8 + [f] * 4 + [p]
    lib.bias_act_norm_fwd.restype = ctypes.c_int
    lib.bias_act_norm_bwd.argtypes = [p] * 15 + [i] * 6 + [i] * 8 + [f] * 5 + [p]
    lib.bias_act_norm_bwd.restype = ctypes.c_int


_library = cuda_build.Library(spec, _declare, "bias_act_norm")


def library_path() -> str:
    return cuda_build.library_path(*spec())


def load() -> ctypes.CDLL:
    """Build (if needed) and load the library once per process."""
    return _library.load()


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch's shape (the source's header explains the tiers).

    tier: "small" (k planes per CTA, G <= 32 lanes each), "plane" (one CTA
    per plane) or "cluster" (Q CTAs per plane); planes_per_cta k; lanes G,
    threads per plane (k * G == threads); cluster Q; slice E, elements of a
    plane one CTA stages (S unless Q > 1); unit, elements a thread takes per
    step (16 bytes' worth where every CTA's run is 16-byte aligned, else 1);
    smem, dynamic shared bytes (the staged runs); grid, CTAs.
    """

    tier: str
    planes_per_cta: int
    lanes: int
    cluster: int
    threads: int
    slice: int
    unit: int
    smem: int
    grid: int

    def args(self) -> Tuple[int, ...]:
        """The plan in the C entry points' order (k, lanes, cluster, threads,
        slice, unit, smem, grid)."""
        return (self.planes_per_cta, self.lanes, self.cluster, self.threads, self.slice,
                self.unit, self.smem, self.grid)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def plan(bsz: int, ch: int, size: int, dtype: torch.dtype, direction: str) -> Plan:
    """The launch plan of one kernel call on x (bsz, ch, S = size) of ``dtype``.

    Raises ValueError for a plane too large to stage in a cluster of
    MAX_CLUSTER CTAs (beyond ~925K bf16 elements forward, ~231K f32 backward).
    """
    if direction not in DIRECTIONS:
        raise ValueError(f"direction must be one of {DIRECTIONS}, got {direction!r}")
    if dtype not in _ELEM_BYTES:
        raise TypeError(f"x must be float32 or bfloat16, got {dtype}")
    if min(bsz, ch, size) <= 0:
        raise ValueError(f"empty shape: B {bsz}, C {ch}, S {size}")
    es = _ELEM_BYTES[dtype]
    arrays = 1 if direction == "fwd" else 2  # x; x and dy
    planes = bsz * ch
    unit = 16 // es if size * es % 16 == 0 else 1
    if size <= SMALL_SIZE:
        lanes = min(32, 1 << ((size // unit).bit_length() - 1))
        k = SMALL_THREADS // lanes
        return Plan("small", k, lanes, 1, SMALL_THREADS, size, unit,
                    arrays * _round_up(k * size * es, 16), -(-planes // k))

    def slice_for(q: int) -> int:
        return _round_up(-(-size // q), unit)

    cluster = 1
    while cluster < MAX_CLUSTER and arrays * slice_for(cluster) * es > STAGE_TARGET:
        cluster *= 2
    slc = slice_for(cluster)
    smem = arrays * _round_up(slc * es, 16)
    if smem > MAX_DYNAMIC_SMEM:
        raise ValueError(f"a plane of {size} {dtype} elements does not fit {MAX_CLUSTER} CTAs' "
                         f"shared memory in the {direction} kernel ({smem} bytes per CTA)")
    want = -(-(slc // unit) // UNITS_PER_THREAD)
    threads = min(MAX_THREADS, max(32, 1 << (want - 1).bit_length()))
    return Plan("plane" if cluster == 1 else "cluster", 1, threads, cluster, threads, slc, unit,
                smem, planes * cluster)


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


def _check_common(x: Tensor, bias, g, n, nw, mode: str) -> Tuple[int, int, int]:
    if not x.is_cuda:
        raise ValueError(f"x must be a CUDA tensor, got device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4 or x.numel() == 0:
        raise ValueError(f"x must be a non-empty (B, C, H, W) tensor, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous (NCHW)")
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
    """t, or a fresh (16-byte aligned) copy where a view starts off 16 bytes:
    the kernels' bulk copies and 16-byte loads need aligned bases."""
    return t if t is None or t.data_ptr() % 16 == 0 else t.clone()


def forward(x: Tensor, bias: Tensor, g: Optional[Tensor] = None, b: Optional[Tensor] = None,
            n: Optional[Tensor] = None, nw: Optional[Tensor] = None, *, mode: str = "plain",
            eps: float = 1e-8, slope: float = 0.2, corr_scale: float = 1.0
            ) -> Tuple[Tensor, Tensor, Tensor]:
    """(y, mean, var): y like x, mean and var (B, C) f32. One kernel launch,
    shaped by ``plan(B, C, H*W, x.dtype, "fwd")``."""
    bsz, ch, size = _check_common(x, bias, g, n, nw, mode)
    if (g is None) != (b is None):
        raise ValueError("g and b come together (AdaIN) or not at all")
    if b is not None:
        _check("b", b, (bsz, ch), x.device)
    pl = plan(bsz, ch, size, x.dtype, "fwd")
    x = _aligned(x)
    n = _aligned(n) if mode == "noise" else None
    y = torch.empty_like(x)
    mean = torch.empty((bsz, ch), dtype=torch.float32, device=x.device)
    var = torch.empty_like(mean)
    ks, c2, _ = corr_constants(corr_scale)
    _library.launch(
        "bias_act_norm_fwd", "bias_act_norm_fwd", x.device,
        x.data_ptr(), bias.data_ptr(), _ptr(g), _ptr(b),
        _ptr(n), _ptr(nw) if mode == "noise" else None,
        y.data_ptr(), mean.data_ptr(), var.data_ptr(), bsz * ch, ch, size,
        _DTYPES[x.dtype], MODES[mode], int(g is not None), *pl.args(), eps, slope, ks, c2,
        context=pl)
    return y, mean, var


def backward(dy: Tensor, x: Tensor, bias: Tensor, g: Optional[Tensor], n: Optional[Tensor],
             nw: Optional[Tensor], mean: Tensor, var: Tensor, dm: Tensor, dv: Tensor, *,
             mode: str = "plain", eps: float = 1e-8, slope: float = 0.2,
             corr_scale: float = 1.0) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """(dx, d_bst, d_g, d_bias, d_nw): dx like x, the rest (B, C) f32 per (b, c),
    not yet summed over b. One kernel launch, shaped by ``plan(..., "bwd")``."""
    bsz, ch, size = _check_common(x, bias, g, n, nw, mode)
    _check("dy", dy, tuple(x.shape), x.device, x.dtype)
    for name, t in (("mean", mean), ("var", var), ("dm", dm), ("dv", dv)):
        _check(name, t, (bsz, ch), x.device)
    pl = plan(bsz, ch, size, x.dtype, "bwd")
    dy, x = _aligned(dy), _aligned(x)
    n = _aligned(n) if mode == "noise" else None
    dx = torch.empty_like(x)
    sums = torch.empty((4, bsz, ch), dtype=torch.float32, device=x.device)
    ks, c2, inv_s2 = corr_constants(corr_scale)
    _library.launch(
        "bias_act_norm_bwd", "bias_act_norm_bwd", x.device,
        dy.data_ptr(), x.data_ptr(), bias.data_ptr(), _ptr(g),
        _ptr(n), _ptr(nw) if mode == "noise" else None,
        mean.data_ptr(), var.data_ptr(), dm.data_ptr(), dv.data_ptr(), dx.data_ptr(),
        sums[0].data_ptr(), sums[1].data_ptr(), sums[2].data_ptr(), sums[3].data_ptr(),
        bsz * ch, ch, size, _DTYPES[x.dtype], MODES[mode], int(g is not None),
        *pl.args(), eps, slope, ks, c2, inv_s2, context=pl)
    return dx, sums[0], sums[1], sums[2], sums[3]
