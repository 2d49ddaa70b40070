"""Plain float32 pieces shared by the benchmark's references.

Nothing here imports the program under test or JAX. The references run in
float32 with TF32 off (``Precision.context``); ``Precision`` computes a
control in a lower precision: "tf32" (TF32 on), "bf16" or "fp8" (float8
e4m3 with a per-tensor scale), each conv-path operand and result rounded to
it forward and backward; ``cast`` gives the conv path a compute type for the
FLOP count on the meta device.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor
FP8_MAX = 448.0  # largest finite float8 e4m3fn


class Precision:
    """How the conv path of a reference computes.

    ``kind``: "fp32" (the reference itself), "bf16" or "fp8" (controls: each
    conv-path operand and result rounded to that type, the arithmetic in
    float32). ``dtype``: the tensors' type on the conv path (bfloat16 only for
    the FLOP count, where nothing is computed)."""

    def __init__(self, kind: str = "fp32", dtype: torch.dtype = torch.float32):
        if kind not in ("fp32", "tf32", "bf16", "fp8"):
            raise ValueError(f"unknown precision {kind!r}")
        self.kind = kind
        self.dtype = dtype

    def q(self, t: Tensor) -> Tensor:
        """``t`` rounded to the control's precision (the identity for fp32
        and tf32); its gradient rounded alike on the way back."""
        if self.kind in ("fp32", "tf32") or t.device.type == "meta":
            return t
        return _Round.apply(t, self.kind)

    def context(self):
        """TF32 on for cuDNN and cuBLAS for "tf32", off for the rest."""
        return float32_matmuls(tf32=self.kind == "tf32")

    def cast(self, t: Tensor) -> Tensor:
        """``t`` in the conv path's type, rounded to the control's precision."""
        return self.q(t.to(self.dtype))


def _round(t: Tensor, kind: str) -> Tensor:
    if kind == "bf16":
        return t.to(torch.bfloat16).to(t.dtype)
    scale = FP8_MAX / t.abs().amax().float().clamp_min(1e-30)
    return (t * scale).to(torch.float8_e4m3fn).to(t.dtype) / scale


class _Round(torch.autograd.Function):
    """Rounding to a lower precision, forward and backward (per-tensor scale
    for float8), as a step computed in that precision rounds both ways."""

    @staticmethod
    def forward(ctx, t, kind):
        ctx.kind = kind
        return _round(t, kind)

    @staticmethod
    def backward(ctx, g):
        return _round(g, ctx.kind), None


@contextlib.contextmanager
def float32_matmuls(tf32: bool = False):
    """TF32 off (or on) for cuDNN and cuBLAS inside the block, as it was after."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


class Draws:
    """The steps' random draws, in the order the step makes them, from a
    ``torch.Generator`` seeded by the benchmark (the same seed the program's
    generator is given). On the meta device nothing is drawn."""

    def __init__(self, seed: Optional[int], device):
        self.device = torch.device(device)
        self.gen = None
        if self.device.type != "meta":
            self.gen = torch.Generator(device=self.device)
            self.gen.manual_seed(int(seed))

    def randn(self, shape) -> Tensor:
        if self.gen is None:
            return torch.empty(shape, device=self.device)
        return torch.randn(shape, generator=self.gen, device=self.device, dtype=torch.float32)

    def randint(self, low: int, high: int) -> Tensor:
        if self.gen is None:
            return torch.ones((), dtype=torch.int64, device=self.device)
        return torch.randint(low, high, (), generator=self.gen, device=self.device)

    def rand(self) -> Tensor:
        if self.gen is None:
            return torch.zeros((), device=self.device)
        return torch.rand((), generator=self.gen, device=self.device)


# ---------------------------------------------------------------- losses --
def kl_per_sample(mu: Tensor, logvar: Tensor) -> Tensor:
    """KL(N(mu, e^logvar) || N(0, I)) summed over the latent, (B,)."""
    mu, logvar = mu.float(), logvar.float()
    return -0.5 * torch.sum(1.0 + logvar - torch.exp(logvar) - mu * mu, dim=-1)


def sq_err_per_sample(x: Tensor, y: Tensor) -> Tensor:
    """Sum of squared errors over each sample, (B,)."""
    d = y.float() - x.float()
    return (d * d).flatten(1).sum(dim=1)


def exp_elbo(rec: Tensor, kl: Tensor, scale: float, beta_rec: float, beta_neg: float) -> Tensor:
    return torch.exp(-2.0 * scale * (beta_rec * rec + beta_neg * kl)).mean()


# ------------------------------------------------------------ optimizers --
class PlainAdam:
    """torch.optim.Adam's update written out, one leaf at a time."""

    def __init__(self, params: Sequence[Tensor], lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.params = list(params)
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.t = 0
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads: Sequence[Optional[Tensor]]) -> None:
        self.t += 1
        bc1 = 1.0 - self.b1 ** self.t
        bc2 = 1.0 - self.b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            if g is None:
                continue  # torch's Adam skips a parameter with no gradient
            m.mul_(self.b1).add_(g * (1.0 - self.b1))
            v.mul_(self.b2).add_(g * g * (1.0 - self.b2))
            denom = v.sqrt() / math.sqrt(bc2) + self.eps
            p.sub_((self.lr / bc1) * m / denom)

    @torch.no_grad()
    def load(self, names: Sequence[str], moments, steps: int) -> None:
        """Another side's moments by parameter name (``names`` in ``params``'
        order; a name without them: nought) after ``steps`` steps."""
        for k, m, v in zip(names, self.m, self.v):
            for mine, key in ((m, "m"), (v, "v")):
                if k in moments:
                    mine.copy_(moments[k][key])
                else:
                    mine.zero_()
        self.t = steps


class PlainLreqAdam:
    """The style recipe's Adam with beta1 = 0 (the reference's custom_adam):
    v <- b2 v + (1 - b2) g^2; p <- p - lr sqrt(1 - b2^t) g / (sqrt(v) + eps).
    A parameter with no gradient counts as a zero gradient."""

    def __init__(self, params: Sequence[Tensor], lr: float, b2: float = 0.99, eps: float = 1e-8):
        self.params = list(params)
        self.lr, self.b2, self.eps = lr, b2, eps
        self.t = 0
        self.v = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads: Sequence[Optional[Tensor]]) -> None:
        self.t += 1
        corr = math.sqrt(1.0 - self.b2 ** self.t)
        for p, g, v in zip(self.params, grads, self.v):
            v.mul_(self.b2)
            if g is None:
                continue
            v.add_(g * g * (1.0 - self.b2))
            p.sub_(self.lr * corr * g / (v.sqrt() + self.eps))

    @torch.no_grad()
    def load(self, names: Sequence[str], moments, steps: int) -> None:
        """Another side's v by parameter name (``names`` in ``params``' order;
        a name without one: nought) after ``steps`` steps."""
        for k, v in zip(names, self.v):
            if k in moments:
                v.copy_(moments[k]["v"])
            else:
                v.zero_()
        self.t = steps


def grads_of(loss: Tensor, params: Sequence[Tensor]) -> List[Optional[Tensor]]:
    """d loss / d params; None where a parameter does not reach the loss."""
    return list(torch.autograd.grad(loss, list(params), allow_unused=True))


def leaky(x: Tensor) -> Tensor:
    return F.leaky_relu(x, 0.2)


NormHook = Optional[Callable[[str, Tuple[int, ...], str], None]]
