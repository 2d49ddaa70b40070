"""FID: the patched FID-Inception and the Fréchet distance (port of metrics/fid.py).

The reference's FID stack (soft_intro_vae/metrics/{inception.py,fid_score.py},
pytorch-fid):

* ``InceptionV3FID`` is the pt_inception-2015-12-05 topology
  (inception.py:184-206) with the FID patches (:209-330): every Inception
  block's average pool excludes padding (``count_include_pad=False``), and
  Mixed_7c's pool branch is a 3x3/1 max pool; BN eps 1e-3. NCHW, under
  pytorch-fid's module names (``Conv2d_1a_3x3.conv.weight``,
  ``Mixed_5b.branch1x1.bn.running_mean``, ...). The convolutions are cuDNN's,
  through ``nn.Conv2d``: the JAX package computes them outside any Pallas
  kernel too. The input is resized to 299x299 bilinearly, antialiased when it
  shrinks, as ``jax.image.resize`` does (pytorch-fid never antialiases; the
  port keeps the JAX package's choice).
* Weights: a pytorch-fid ``.pth`` is loaded only if one already sits on disk
  (``fid_weights_path``); nothing is downloaded. Without it the network is a
  deterministic random init whose BN statistics are calibrated on one batch,
  and the FID it gives is self-consistent (the trainers log it as
  ``fid_selfconsistent``), not comparable to published numbers.
* ``frechet_distance`` (fid_score.py:274-325): the trace of sqrt(S1 S2) by 30
  Newton-Schulz iterations in float32 on the device, with scipy's sqrtm on
  the host when they go non-finite.
* ``compute_statistics_streaming``: one pass over the batches, the sums in
  float64 on the device; uint8 batches are normalized by ops/u8norm.py (the
  CUDA kernel on the card, bit-equal to the host's x / 255).

TF32: the FID forward and the Newton-Schulz matmuls run in full float32
whatever the global flags say (``InceptionFeatures(allow_tf32=False)``, as
``load_fid_network`` builds it): cuDNN would otherwise take TF32 for the ~95
float32 convolutions, and the metric would move with the card's math mode.
"""

from __future__ import annotations

import contextlib
import os
import warnings
from typing import Callable, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from soft_intro_vae_torch.ops.u8norm import u8_to_unit_nchw
from soft_intro_vae_torch.utils.device import resolve_device

Tensor = torch.Tensor

FID_WEIGHTS_FILENAME = "pt_inception-2015-12-05-6726825d.pth"
CACHE_DIR = os.path.join(os.path.expanduser("~"), ".cache", "soft_intro_vae_torch")
INCEPTION_SIZE = 299
# the reference wrapper's dim -> tap-index map (inception.py:28-33)
BLOCK_INDEX_BY_DIM = {64: 0, 192: 1, 768: 2, 2048: 3}


@contextlib.contextmanager
def tf32(allowed: bool):
    """cuDNN and cuBLAS TF32 set to ``allowed`` inside, restored after."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = allowed
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


# ---------------------------------------------------------------- pooling ---
def avg_pool_no_pad(x: Tensor) -> Tensor:
    """3x3/1 average pool over the valid pixels only (the FID patch)."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


def resize_to_inception(x: Tensor) -> Tensor:
    """(B, C, H, W) -> (B, C, 299, 299), bilinear with half-pixel centers;
    antialiased when a side shrinks, as ``jax.image.resize`` is."""
    h, w = x.shape[-2:]
    shrink = h > INCEPTION_SIZE or w > INCEPTION_SIZE
    return F.interpolate(x, size=(INCEPTION_SIZE, INCEPTION_SIZE), mode="bilinear",
                         align_corners=False, antialias=shrink)


# ----------------------------------------------------------------- blocks ---
class BasicConv2d(nn.Module):
    """conv (no bias) -> BN (eps 1e-3) -> ReLU."""

    def __init__(self, in_ch: int, out_ch: int, **kw):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, bias=False, **kw)
        self.bn = nn.BatchNorm2d(out_ch, eps=0.001)

    def forward(self, x: Tensor) -> Tensor:
        return F.relu(self.bn(self.conv(x)))


class InceptionA(nn.Module):
    def __init__(self, in_ch: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_ch, 64, kernel_size=1)
        self.branch5x5_1 = BasicConv2d(in_ch, 48, kernel_size=1)
        self.branch5x5_2 = BasicConv2d(48, 64, kernel_size=5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, kernel_size=1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, kernel_size=3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, kernel_size=3, padding=1)
        self.branch_pool = BasicConv2d(in_ch, pool_features, kernel_size=1)

    def forward(self, x: Tensor) -> Tensor:
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(avg_pool_no_pad(x))
        return torch.cat([b1, b5, bd, bp], 1)


class InceptionB(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(in_ch, 384, kernel_size=3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, kernel_size=1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, kernel_size=3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, kernel_size=3, stride=2)

    def forward(self, x: Tensor) -> Tensor:
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, 2)], 1)


class InceptionC(nn.Module):
    def __init__(self, in_ch: int, channels_7x7: int):
        super().__init__()
        c7 = channels_7x7
        self.branch1x1 = BasicConv2d(in_ch, 192, kernel_size=1)
        self.branch7x7_1 = BasicConv2d(in_ch, c7, kernel_size=1)
        self.branch7x7_2 = BasicConv2d(c7, c7, kernel_size=(1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(in_ch, c7, kernel_size=1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, kernel_size=(1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, kernel_size=(1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(in_ch, 192, kernel_size=1)

    def forward(self, x: Tensor) -> Tensor:
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for conv in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4,
                     self.branch7x7dbl_5):
            bd = conv(bd)
        bp = self.branch_pool(avg_pool_no_pad(x))
        return torch.cat([b1, b7, bd, bp], 1)


class InceptionD(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(in_ch, 192, kernel_size=1)
        self.branch3x3_2 = BasicConv2d(192, 320, kernel_size=3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(in_ch, 192, kernel_size=1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, kernel_size=(1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, kernel_size=3, stride=2)

    def forward(self, x: Tensor) -> Tensor:
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_4(self.branch7x7x3_3(self.branch7x7x3_2(self.branch7x7x3_1(x))))
        return torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], 1)


class InceptionE(nn.Module):
    """``pool_kind`` "avg" is Mixed_7b; "max" is Mixed_7c, whose pool branch
    is a 3x3/1 max pool (FIDInceptionE_2, inception.py:322-327)."""

    def __init__(self, in_ch: int, pool_kind: str = "avg"):
        super().__init__()
        self.pool_kind = pool_kind
        self.branch1x1 = BasicConv2d(in_ch, 320, kernel_size=1)
        self.branch3x3_1 = BasicConv2d(in_ch, 384, kernel_size=1)
        self.branch3x3_2a = BasicConv2d(384, 384, kernel_size=(1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, kernel_size=(3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 448, kernel_size=1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, kernel_size=3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, kernel_size=(1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, kernel_size=(3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(in_ch, 192, kernel_size=1)

    def forward(self, x: Tensor) -> Tensor:
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        bp = F.max_pool2d(x, 3, 1, 1) if self.pool_kind == "max" else avg_pool_no_pad(x)
        return torch.cat([b1, b3, bd, self.branch_pool(bp)], 1)


class InceptionV3FID(nn.Module):
    """The pt_inception FID network: (B, 3, H, W) in [0, 1] -> features.

    ``output_blocks`` are the reference wrapper's taps (inception.py:28-33,
    88-130): 0 after the first max pool (64 channels), 1 after the second
    (192), 2 after Mixed_6e (768), 3 the global average pool of Mixed_7c (a
    (B, 2048) vector). With the default ``(3,)`` the pool3 vector comes back
    bare (the FID path); otherwise a tuple of the taps, ascending. Layers
    past the last tap are neither built nor run.
    """

    def __init__(self, output_blocks: Sequence[int] = (3,), resize_input: bool = True):
        super().__init__()
        blocks = sorted(set(output_blocks))
        if not blocks or blocks[0] < 0 or blocks[-1] > 3:
            raise ValueError(f"output_blocks must be within 0..3, got {tuple(output_blocks)}")
        self.blocks = blocks
        self.resize_input = resize_input
        last = blocks[-1]
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, kernel_size=3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, kernel_size=3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, kernel_size=3, padding=1)
        if last >= 1:
            self.Conv2d_3b_1x1 = BasicConv2d(64, 80, kernel_size=1)
            self.Conv2d_4a_3x3 = BasicConv2d(80, 192, kernel_size=3)
        if last >= 2:
            self.Mixed_5b = InceptionA(192, pool_features=32)
            self.Mixed_5c = InceptionA(256, pool_features=64)
            self.Mixed_5d = InceptionA(288, pool_features=64)
            self.Mixed_6a = InceptionB(288)
            self.Mixed_6b = InceptionC(768, channels_7x7=128)
            self.Mixed_6c = InceptionC(768, channels_7x7=160)
            self.Mixed_6d = InceptionC(768, channels_7x7=160)
            self.Mixed_6e = InceptionC(768, channels_7x7=192)
        if last >= 3:
            self.Mixed_7a = InceptionD(768)
            self.Mixed_7b = InceptionE(1280, "avg")
            self.Mixed_7c = InceptionE(2048, "max")

    def forward(self, x: Tensor):
        last = self.blocks[-1]
        taps = []
        if self.resize_input:
            x = resize_to_inception(x)
        x = 2.0 * x - 1.0  # (0, 1) -> (-1, 1) (inception.py:151-154)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, 2)
        if 0 in self.blocks:
            taps.append(x)
        if last >= 1:
            x = F.max_pool2d(self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x)), 3, 2)
            if 1 in self.blocks:
                taps.append(x)
        if last >= 2:
            for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c",
                         "Mixed_6d", "Mixed_6e"):
                x = getattr(self, name)(x)
            if 2 in self.blocks:
                taps.append(x)
        if last >= 3:
            x = self.Mixed_7c(self.Mixed_7b(self.Mixed_7a(x)))
            taps.append(x.mean(dim=(2, 3)))  # global average pool -> (B, 2048)
        if self.blocks == [3]:
            return taps[0]
        return tuple(taps)


# ---------------------------------------------------------------- weights ---
def fid_weights_path(weights_path: Optional[str] = None) -> Optional[str]:
    """The pt_inception weights file (the payload of the reference's
    FID_WEIGHTS_URL, inception.py:17) if it is on disk: ``weights_path``, then
    the working directory, then ``CACHE_DIR``; None means the random-init
    fallback. Nothing is downloaded."""
    if weights_path and os.path.exists(weights_path):
        return weights_path
    for root in (os.getcwd(), CACHE_DIR):
        cand = os.path.join(root, FID_WEIGHTS_FILENAME)
        if os.path.exists(cand):
            return cand
    return None


def load_pt_inception(net: InceptionV3FID, state_dict: dict) -> None:
    """A pytorch-fid state_dict into ``net``: the ``fc`` and ``AuxLogits``
    heads are dropped, and so are the blocks past ``net``'s last tap; every
    tensor of ``net`` must come from the file (a BN's ``num_batches_tracked``
    may be missing)."""
    own = net.state_dict()
    sd = {k: v for k, v in state_dict.items()
          if not k.startswith(("fc.", "AuxLogits.")) and k.split(".")[0] in net._modules}
    unexpected = sorted(set(sd) - set(own))
    missing = sorted(k for k in set(own) - set(sd) if not k.endswith("num_batches_tracked"))
    if unexpected or missing:
        raise KeyError(f"not a pt_inception state_dict: unexpected {unexpected[:5]}, "
                       f"missing {missing[:5]}")
    net.load_state_dict(sd, strict=False)


@torch.no_grad()
def calibrate_random_init(net: InceptionV3FID, batch: Tensor) -> None:
    """Make the random-init fallback's features non-degenerate, in place.

    With default BN statistics (mean 0, var 1: the identity in eval mode) the
    activations die out through the ~95 convolutions (the JAX package measured
    a pool3 std of ~1e-5). One forward of ``batch`` sets each BN's running
    mean and variance to the batch mean and biased variance of its own input,
    taken just before it normalizes, in network order; eval mode then
    normalizes as a train-mode pass over that batch does. This is what the JAX
    package's ``_calibrate_random_init`` (metrics/fid.py:304-322) recovers from
    flax's running update; ``torch.nn.BatchNorm2d``'s own update would store
    the unbiased variance instead.
    """

    def take_batch_stats(bn, inputs):
        x = inputs[0]
        var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
        bn.running_mean.copy_(mean)
        bn.running_var.copy_(var)

    hooks = [m.register_forward_pre_hook(take_batch_stats)
             for m in net.modules() if isinstance(m, nn.BatchNorm2d)]
    net.eval()
    try:
        net(batch)
    finally:
        for h in hooks:
            h.remove()


class InceptionFeatures:
    """``apply_fn``: (B, 3, H, W) float in [0, 1] -> pool3 (B, 2048) float32,
    on ``device``, without gradients, in eval mode, TF32 as ``allow_tf32``."""

    def __init__(self, net: InceptionV3FID, device: torch.device, allow_tf32: bool = False):
        self.net = net.eval()
        self.device = device
        self.allow_tf32 = allow_tf32

    @torch.no_grad()
    def __call__(self, x: Tensor) -> Tensor:
        with tf32(self.allow_tf32):
            return self.net(x.to(self.device, torch.float32)).float()


# (weights path, resize_input, device) -> InceptionFeatures: every
# trainer and evaluation calls load_fid_network, and the fallback's init and
# calibration cost one 32-image forward; a weights file that appears later in
# the process needs _FID_NETWORK_CACHE.clear()
_FID_NETWORK_CACHE: dict = {}


def load_fid_network(weights_path: Optional[str] = None, resize_input: bool = True,
                     device="cuda") -> InceptionFeatures:
    """The FID network on ``device``, from the pt_inception file when it is on
    disk (``fid_weights_path``), else the random-init fallback: PyTorch's
    default init drawn from seed 0, calibrated on 32 uniform 64x64 images from
    a generator seeded 1 (``calibrate_random_init``), with a warning."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:  # "cuda" and "cuda:0" share a network
        device = torch.device("cuda", torch.cuda.current_device())
    path = fid_weights_path(weights_path)
    key = (path, resize_input, str(device))
    if key in _FID_NETWORK_CACHE:
        return _FID_NETWORK_CACHE[key]
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        net = InceptionV3FID(resize_input=resize_input)
    net = net.to(device)
    if path is not None:
        load_pt_inception(net, torch.load(path, map_location="cpu", weights_only=True))
    else:
        warnings.warn(
            "FID inception weights not found — using deterministic random "
            "init with BN-calibrated stats. FID values are self-consistent "
            "but NOT comparable to published numbers. Provide "
            f"{FID_WEIGHTS_FILENAME} for parity.")
        size = 64 if resize_input else INCEPTION_SIZE
        gen = torch.Generator().manual_seed(1)
        batch = torch.rand((32, 3, size, size), generator=gen).to(device)
        with tf32(False):
            calibrate_random_init(net, batch)
    features = InceptionFeatures(net, device)
    _FID_NETWORK_CACHE[key] = features
    return features


# --------------------------------------------------------------- distance ---
def sqrtm_newton_schulz(a: Tensor, iters: int = 30) -> Tensor:
    """The matrix square root by Newton-Schulz iterations, float32 matmuls on
    ``a``'s device, TF32 off."""
    a = a.float()
    eye = torch.eye(a.shape[0], dtype=a.dtype, device=a.device)
    norm = torch.linalg.norm(a)
    y, z = a / norm, eye
    with tf32(False):
        for _ in range(iters):
            t = 0.5 * (3.0 * eye - z @ y)
            y, z = y @ t, t @ z
    return y * torch.sqrt(norm)


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6, method: str = "newton",
                     device="cuda") -> float:
    """d^2 = |mu1 - mu2|^2 + Tr(S1 + S2 - 2 sqrt(S1 S2)) (fid_score.py:274-325).

    ``method="newton"``: (S1 + eps I)(S2 + eps I) in float64 on ``device``,
    its square root by ``sqrtm_newton_schulz``; when that trace is not finite
    (a nearly singular product: few samples, rank far below the dimension),
    the reference's scipy path on the host (:307-313)."""
    mu1, mu2 = np.asarray(mu1, np.float64), np.asarray(mu2, np.float64)
    sigma1, sigma2 = np.asarray(sigma1, np.float64), np.asarray(sigma2, np.float64)
    diff = mu1 - mu2
    if method == "scipy":
        from scipy import linalg

        # scipy's sqrtm, without the ``disp`` argument that newer scipy removed
        covmean = linalg.sqrtm(sigma1.dot(sigma2))
        if not np.isfinite(covmean).all():
            offset = np.eye(sigma1.shape[0]) * eps
            covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
        if np.iscomplexobj(covmean):
            covmean = covmean.real
        tr_covmean = float(np.trace(covmean))
    elif method == "newton":
        device = resolve_device(device)
        offset = eps * torch.eye(sigma1.shape[0], dtype=torch.float64, device=device)
        prod = (torch.from_numpy(sigma1).to(device) + offset) @ (
            torch.from_numpy(sigma2).to(device) + offset)
        tr_covmean = float(torch.trace(sqrtm_newton_schulz(prod)))
        if not np.isfinite(tr_covmean):
            return frechet_distance(mu1, sigma1, mu2, sigma2, eps, method="scipy")
    else:
        raise ValueError(f"method must be 'newton' or 'scipy', got {method!r}")
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2.0 * tr_covmean)


def compute_statistics_streaming(apply_fn: Callable[[Tensor], Tensor], batches: Iterable,
                                 device=None) -> Tuple[np.ndarray, np.ndarray]:
    """One-pass mean and covariance (float64) of ``apply_fn``'s features over
    NHWC batches (numpy or torch): uint8 batches through ops/u8norm.py (the
    kernel on a CUDA device), float batches in [0, 1] as they are. Either goes
    to the network NCHW-contiguous: u8norm's channels-last output is copied
    once, and the Inception's convolutions keep the NCHW layout whose speed
    and pool3 the FID was measured in. The sums stay on ``device`` (default:
    ``apply_fn.device``) until the end."""
    device = resolve_device(device if device is not None else apply_fn.device)
    n, s, ss = 0, None, None
    for b in batches:
        x = torch.from_numpy(np.ascontiguousarray(b)) if isinstance(b, np.ndarray) else b
        x = x.to(device)
        if x.dtype == torch.uint8:
            x = u8_to_unit_nchw(x)
        else:
            x = x.to(torch.float32).permute(0, 3, 1, 2)
        a = apply_fn(x.contiguous()).double()  # the Inception runs NCHW
        s = a.sum(0) if s is None else s + a.sum(0)
        ss = a.T @ a if ss is None else ss + a.T @ a
        n += a.shape[0]
    if n < 2:
        raise ValueError("need at least 2 samples for covariance")
    mu = s / n
    cov = (ss - n * torch.outer(mu, mu)) / (n - 1)
    return mu.cpu().numpy(), cov.cpu().numpy()


def fid_between_batches(apply_fn, real_batches, fake_batches, method: str = "newton",
                        device=None) -> float:
    device = device if device is not None else apply_fn.device
    mu1, s1 = compute_statistics_streaming(apply_fn, real_batches, device)
    mu2, s2 = compute_statistics_streaming(apply_fn, fake_batches, device)
    return frechet_distance(mu1, s1, mu2, s2, method=method, device=device)


# ------------------------------------------------ trainer integration hook ---
def make_training_fid(cfg, weights_path: Optional[str] = None):
    """The image trainer's FID hook (train_soft_intro_vae.py:472-487):
    ``fid_fn(state, dataset=None, num_images=2048, batch_size=64)``.

    The real statistics come from the dataset's first ``num_images`` images
    (unshuffled), once, then stay cached. The fakes are decoder samples in
    eval mode (the BN running statistics, as the reference's ``model.eval()``,
    fid_score.py:249), clipped and rounded to 1/255 steps as a uint8 round
    trip does (get_activations_generate, fid_score.py:244-257). Their noise
    comes from a generator of its own, seeded from the run's seed, so the
    training draws (``state.generator``, registered with the step's CUDA
    graph) never move; the decoder's tensors are read, never replaced.
    """
    apply_fn = load_fid_network(weights_path, device=cfg.device)
    cache = {}

    @torch.no_grad()
    def fid_fn(state, dataset=None, num_images: int = 2048, batch_size: int = 64) -> float:
        if "real" not in cache:
            if dataset is None:
                raise ValueError("first FID call needs the dataset")

            def real_iter():
                seen = 0
                for b in dataset.epoch(batch_size, shuffle=False):
                    if seen >= num_images:
                        break
                    seen += b.shape[0]
                    yield b

            cache["real"] = compute_statistics_streaming(apply_fn, real_iter(), state.device)
        mu1, s1 = cache["real"]
        dec = state.decoder
        gen = torch.Generator(device=state.device)
        gen.manual_seed(state.generator.initial_seed() + 555)

        def fake_iter():
            made = 0
            while made < num_images:
                z = torch.randn((batch_size, cfg.z_dim), generator=gen, device=state.device)
                x = dec(z).float().clamp(0.0, 1.0)
                made += batch_size
                yield (torch.round(x * 255.0) / 255.0).permute(0, 2, 3, 1)

        training = dec.training
        dec.eval()
        try:
            mu2, s2 = compute_statistics_streaming(apply_fn, fake_iter(), state.device)
        finally:
            dec.train(training)
        return frechet_distance(mu1, s1, mu2, s2, device=state.device)

    return fid_fn
