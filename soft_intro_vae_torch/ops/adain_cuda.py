"""Binding of the hand-written CUDA fused-norm kernels (csrc/bias_act_norm.cu).

Replaces the TPU kernels of soft_intro_vae_tpu/ops/adain_pallas.py:
``_fwd_pallas`` (``forward`` here, one launch) and ``_bwd_pallas``
(``backward`` here, one launch). The source's header says what bounds them
and how they are laid out. Built and loaded by ``ops/cuda_build.py`` on the
first call with a CUDA tensor, never at import.

Layout NCHW: x (B, C, H, W) in float32 or bfloat16, n (B, H, W) f32, bias and
nw (C,) f32, g and b (B, C) f32, all contiguous on one device. The wrappers
check that and raise on anything the kernels do not take; they launch on the
current stream and do not synchronise.
"""

from __future__ import annotations

import ctypes
import math
import os
from typing import Optional, Tuple

import torch

from soft_intro_vae_torch.ops import cuda_build

Tensor = torch.Tensor

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "bias_act_norm.cu")
CORR_K = 0.8 / math.sqrt(2.0 * math.pi)
MODES = {"plain": 0, "noise": 1, "corr": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches made by ``forward`` and ``backward``; a run sets them to 0
# and reads them back to show which path went through the kernels
launches_fwd = 0
launches_bwd = 0


def spec() -> cuda_build.Spec:
    """The build of these kernels: (source, library stem, extra nvcc flags)."""
    return (_SRC, "bias_act_norm", ())


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.bias_act_norm_fwd.argtypes = [p] * 9 + [i] * 6 + [f] * 4 + [p]
    lib.bias_act_norm_fwd.restype = ctypes.c_int
    lib.bias_act_norm_bwd.argtypes = [p] * 15 + [i] * 6 + [f] * 5 + [p]
    lib.bias_act_norm_bwd.restype = ctypes.c_int
    lib.bias_act_norm_error_string.argtypes = [ctypes.c_int]
    lib.bias_act_norm_error_string.restype = ctypes.c_char_p


_library = cuda_build.Library(spec, _declare)


def library_path() -> str:
    return cuda_build.library_path(*spec())


def load() -> ctypes.CDLL:
    """Build (if needed) and load the library once per process."""
    return _library.load()


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


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"bias_act_norm {what} launch failed: "
                           f"{lib.bias_act_norm_error_string(err).decode()}")


def forward(x: Tensor, bias: Tensor, g: Optional[Tensor] = None, b: Optional[Tensor] = None,
            n: Optional[Tensor] = None, nw: Optional[Tensor] = None, *, mode: str = "plain",
            eps: float = 1e-8, slope: float = 0.2, corr_scale: float = 1.0
            ) -> Tuple[Tensor, Tensor, Tensor]:
    """(y, mean, var): y like x, mean and var (B, C) f32. One kernel launch."""
    global launches_fwd
    bsz, ch, size = _check_common(x, bias, g, n, nw, mode)
    if (g is None) != (b is None):
        raise ValueError("g and b come together (AdaIN) or not at all")
    if b is not None:
        _check("b", b, (bsz, ch), x.device)
    lib = load()
    y = torch.empty_like(x)
    mean = torch.empty((bsz, ch), dtype=torch.float32, device=x.device)
    var = torch.empty_like(mean)
    ks, c2, _ = corr_constants(corr_scale)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.bias_act_norm_fwd(
            x.data_ptr(), bias.data_ptr(), _ptr(g), _ptr(b),
            _ptr(n) if mode == "noise" else None, _ptr(nw) if mode == "noise" else None,
            y.data_ptr(), mean.data_ptr(), var.data_ptr(), bsz * ch, ch, size,
            _DTYPES[x.dtype], MODES[mode], int(g is not None), eps, slope, ks, c2, stream)
    _raise_on(lib, err, "forward")
    launches_fwd += 1
    return y, mean, var


def backward(dy: Tensor, x: Tensor, bias: Tensor, g: Optional[Tensor], n: Optional[Tensor],
             nw: Optional[Tensor], mean: Tensor, var: Tensor, dm: Tensor, dv: Tensor, *,
             mode: str = "plain", eps: float = 1e-8, slope: float = 0.2,
             corr_scale: float = 1.0) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """(dx, d_bst, d_g, d_bias, d_nw): dx like x, the rest (B, C) f32 per (b, c),
    not yet summed over b. One kernel launch."""
    global launches_bwd
    bsz, ch, size = _check_common(x, bias, g, n, nw, mode)
    _check("dy", dy, tuple(x.shape), x.device, x.dtype)
    for name, t in (("mean", mean), ("var", var), ("dm", dm), ("dv", dv)):
        _check(name, t, (bsz, ch), x.device)
    lib = load()
    dx = torch.empty_like(x)
    sums = torch.empty((4, bsz, ch), dtype=torch.float32, device=x.device)
    ks, c2, inv_s2 = corr_constants(corr_scale)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.bias_act_norm_bwd(
            dy.data_ptr(), x.data_ptr(), bias.data_ptr(), _ptr(g),
            _ptr(n) if mode == "noise" else None, _ptr(nw) if mode == "noise" else None,
            mean.data_ptr(), var.data_ptr(), dm.data_ptr(), dv.data_ptr(), dx.data_ptr(),
            sums[0].data_ptr(), sums[1].data_ptr(), sums[2].data_ptr(), sums[3].data_ptr(),
            bsz * ch, ch, size, _DTYPES[x.dtype], MODES[mode], int(g is not None),
            eps, slope, ks, c2, inv_s2, stream)
    _raise_on(lib, err, "backward")
    launches_bwd += 1
    return dx, sums[0], sums[1], sums[2], sums[3]
