"""Fused bias + leaky ReLU + instance norm (+ AdaIN) (port of ops/adain_pallas.py).

The norm site of every EncodeBlock and DecodeBlock (reference
style_soft_intro_vae/net.py:97-181) on the conv output x (B, C, H, W):

    e    = leaky_relu(x + inject + bias, slope)
    m, v = per-(b, c) spatial moments of e, one pass in f32: v = max(E[e^2] - m^2, 0)
    y    = (e - m) * rsqrt(v + eps) * g + b           (g, b: AdaIN, decoder only)

with inject = nothing (mode "plain", encoder), nw * n (mode "noise", decoder
training) or s * exp(-x^2 / 2s^2) * 0.8 / sqrt(2 pi) (mode "corr", decoder with
noise off). Returns (y, m, v); m and v carry gradients, because the encoder's
style head reads them.

Two implementations of one function:
  * ``bias_act_norm_plain`` / ``bias_act_norm_backward_plain``: PyTorch ops,
    the semantics of the JAX package's ``reference_bias_act_norm`` and the
    backward written out step by step as ``_bwd_pallas`` computes it (not
    taken from autograd). They are the CPU path and the kernels' twins.
  * the CUDA kernels of ``ops/adain_cuda.py`` (one launch each way).

``bias_act_norm`` dispatches on where x lies: the kernels for CUDA tensors,
the plain functions for CPU tensors. ``impl="plain"`` forces the plain
functions (to compare the two routes on the card); a CUDA tensor otherwise
launches the kernel or raises, and never falls back.

Compute type: f32 for f32 and bf16 inputs (y is returned in x's type), f64
for f64 inputs on the plain path, which ``torch.autograd.gradcheck`` uses.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from soft_intro_vae_torch.ops import adain_cuda

Tensor = torch.Tensor
IMPLS = ("auto", "plain", "cuda")
MODES = tuple(adain_cuda.MODES)


def _compute_dtype(x: Tensor) -> torch.dtype:
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _per_channel(t: Tensor) -> Tensor:
    return t[None, :, None, None]


def _per_plane(t: Tensor) -> Tensor:
    return t[:, :, None, None]


def _producer(x: Tensor, bias: Tensor, n: Optional[Tensor], nw: Optional[Tensor], mode: str,
              slope: float, corr_scale: float) -> Tuple[Tensor, Tensor]:
    """(e, pre) in the compute type, one elementwise op at a time, in the
    order the kernels round them (csrc/bias_act_norm.cu ``pre_act``)."""
    ct = _compute_dtype(x)
    xe = x.to(ct)
    if mode == "noise":
        xe = xe + _per_channel(nw.to(ct)) * n.to(ct)[:, None]
    elif mode == "corr":
        ks, c2, _ = adain_cuda.corr_constants(corr_scale)
        xe = xe + ks * torch.exp(xe * xe * c2)
    pre = xe + _per_channel(bias.to(ct))
    return torch.where(pre >= 0, pre, slope * pre), pre


def bias_act_norm_plain(x: Tensor, bias: Tensor, g: Optional[Tensor] = None,
                        b: Optional[Tensor] = None, n: Optional[Tensor] = None,
                        nw: Optional[Tensor] = None, *, mode: str = "plain", eps: float = 1e-8,
                        slope: float = 0.2, corr_scale: float = 1.0
                        ) -> Tuple[Tensor, Tensor, Tensor]:
    """(y, m, v) of the fused chain in plain PyTorch ops (reference_bias_act_norm)."""
    ct = _compute_dtype(x)
    e, _ = _producer(x, bias, n, nw, mode, slope, corr_scale)
    m = e.mean(dim=(2, 3))
    v = torch.clamp((e * e).mean(dim=(2, 3)) - m * m, min=0.0)
    rstd = torch.rsqrt(v + eps)
    if g is not None:
        a = rstd * g.to(ct)
        c = b.to(ct) - m * a
    else:
        a = rstd
        c = -m * a
    y = e * _per_plane(a) + _per_plane(c)
    return y.to(x.dtype), m, v


def bias_act_norm_backward_plain(x: Tensor, bias: Tensor, g: Optional[Tensor],
                                 n: Optional[Tensor], nw: Optional[Tensor], m: Tensor, v: Tensor,
                                 dy: Tensor, dm: Tensor, dv: Tensor, *, mode: str = "plain",
                                 eps: float = 1e-8, slope: float = 0.2, corr_scale: float = 1.0
                                 ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """The backward of ``bias_act_norm_plain``, as ``_bwd_pallas`` computes it.

    Returns (dx like x, d_bst, d_g, d_bias, d_nw), the last four (B, C) per
    (b, c) and not yet summed over b: d_bst = sum(dy), d_g = sum(dy * ehat),
    d_bias = sum(dp), d_nw = sum(dp * n) (0 unless mode is "noise").
    """
    ct = _compute_dtype(x)
    size = x.shape[2] * x.shape[3]
    e, pre = _producer(x, bias, n, nw, mode, slope, corr_scale)
    m, v, dm, dv = (t.to(ct) for t in (m, v, dm, dv))
    rstd = torch.rsqrt(v + eps)
    ehat = (e - _per_plane(m)) * _per_plane(rstd)
    d = dy.to(ct)
    # pass 1: the two sums the normalisation's backward needs
    sdy = d.sum(dim=(2, 3))
    sde = (d * ehat).sum(dim=(2, 3))
    # pass 2: de with the m, v cotangents folded in, then through leaky ReLU
    gain = rstd * g.to(ct) if g is not None else rstd
    de = (_per_plane(gain) * (d - _per_plane(sdy / size) - ehat * _per_plane(sde / size))
          + _per_plane(dm * (1.0 / size)) + _per_plane(dv * (2.0 / size)) * (e - _per_plane(m)))
    dp = torch.where(pre >= 0, de, slope * de)
    dbias = dp.sum(dim=(2, 3))
    if mode == "noise":
        dnw = (dp * n.to(ct)[:, None]).sum(dim=(2, 3))
    else:
        dnw = torch.zeros_like(dbias)
    if mode == "corr":
        ks, c2, inv_s2 = adain_cuda.corr_constants(corr_scale)
        xc = x.to(ct)
        dx = dp * (1.0 - xc * inv_s2 * (ks * torch.exp(xc * xc * c2)))
    else:
        dx = dp
    return dx.to(x.dtype), sdy, sde, dbias, dnw


class BiasActNorm(torch.autograd.Function):
    """(y, m, v) with the hand-written backward; kernels on CUDA, plain on CPU."""

    @staticmethod
    def forward(ctx, x, bias, g, b, n, nw, mode, eps, slope, corr_scale, use_kernel):
        kw = dict(mode=mode, eps=eps, slope=slope, corr_scale=corr_scale)
        if use_kernel:
            y, m, v = adain_cuda.forward(x, bias, g, b, n, nw, **kw)
        else:
            y, m, v = bias_act_norm_plain(x, bias, g, b, n, nw, **kw)
        ctx.save_for_backward(x, bias, g, n, nw, m, v)
        ctx.kw = kw
        ctx.use_kernel = use_kernel
        return y, m, v

    @staticmethod
    def backward(ctx, dy, dm, dv):
        x, bias, g, n, nw, m, v = ctx.saved_tensors
        dy = dy.to(x.dtype).contiguous()
        dm = dm.to(m.dtype).contiguous()
        dv = dv.to(v.dtype).contiguous()
        if ctx.use_kernel:
            dx, dbst, dg, dbias_p, dnw_p = adain_cuda.backward(dy, x, bias, g, n, nw, m, v,
                                                              dm, dv, **ctx.kw)
        else:
            dx, dbst, dg, dbias_p, dnw_p = bias_act_norm_backward_plain(
                x, bias, g, n, nw, m, v, dy, dm, dv, **ctx.kw)
        affine = g is not None
        d_nw = dnw_p.sum(dim=0).to(nw.dtype) if ctx.kw["mode"] == "noise" else None
        return (dx, dbias_p.sum(dim=0).to(bias.dtype),
                dg.to(g.dtype) if affine else None, dbst.to(g.dtype) if affine else None,
                None, d_nw, None, None, None, None, None)


def _use_kernel(impl: str, x: Tensor) -> bool:
    if impl not in IMPLS:
        raise NotImplementedError(f"unknown fused-norm impl: {impl!r}")
    if impl == "cuda" and not x.is_cuda:
        raise ValueError("impl='cuda' needs CUDA tensors")
    return impl != "plain" and x.is_cuda


def bias_act_norm(x: Tensor, bias: Tensor, g: Optional[Tensor] = None,
                  b: Optional[Tensor] = None, n: Optional[Tensor] = None,
                  nw: Optional[Tensor] = None, *, mode: str = "plain", eps: float = 1e-8,
                  slope: float = 0.2, corr_scale: float = 1.0, impl: str = "auto"
                  ) -> Tuple[Tensor, Tensor, Tensor]:
    """Fused producer + IN (+ AdaIN) over NCHW ``x``; returns (y, m, v).

    x: (B, C, H, W) conv output before its bias. bias: (C,). For AdaIN pass
    g = s0 + 1 and b = s1 as (B, C); omit both for the encoder's plain
    instance norm. mode "noise" takes n (B, H, W) and nw (C,); mode "corr"
    takes corr_scale = sqrt(layer + 1). Gradients reach x, bias, g, b and nw.
    """
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    if (g is None) != (b is None):
        raise ValueError("g and b come together (AdaIN) or not at all")
    if mode == "noise" and (n is None or nw is None):
        raise ValueError("mode='noise' needs n (B, H, W) and nw (C,)")
    use_kernel = _use_kernel(impl, x)
    ct = _compute_dtype(x)

    def side(t):
        return None if t is None else t.to(ct).contiguous()

    if mode != "noise":
        n = nw = None
    return BiasActNorm.apply(x.contiguous(), side(bias), side(g), side(b), side(n), side(nw),
                             mode, float(eps), float(slope), float(corr_scale), use_kernel)
