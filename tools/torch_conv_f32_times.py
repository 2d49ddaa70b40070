#!/usr/bin/env python3
"""The image nets' float32 convolutions on the GPU: the hand-written kernels
(soft_intro_vae_torch/ops/conv_f32_cuda.py) against float64 and against cuDNN.

    python3 tools/torch_conv_f32_times.py [--recipes celeb256,cifar10] [--iters 10]
                                          [--no-library] [--root DIR] [--out FILE]

Every distinct conv of the recipes' nets (read from ``SoftIntroVAE`` on the
meta device at the recipe's batch: celeb256 batch 8 at 256x256, cifar10
batch 32 at 32x32) is one shape class. For each, with cuDNN's TF32 off:

  * the kernels' forward, input gradient and weight gradient against the
    float64 convolution and its autograd on the card (``F.conv2d`` in
    float64), as the largest error over the largest value of the float64
    result, held to ``TOLERANCE`` (float32 sums in another order); cuDNN's
    float32 error beside it; each kernel run twice, bit-equal;
  * the device time of each (CUDA events around ``--iters`` calls queued
    behind a sleep kernel, ``tools/torch_norm_sites.py device_ms``) beside
    its bound, the FLOPs (2 * M * N * K, torch's count) at the card's
    float32 peak, and cuDNN's own call at TF32 off (the port's route before
    the kernels; the library yardstick, which the port never calls on this
    route): NHWC and NCHW operands, under cuDNN's heuristics and under
    ``cudnn.benchmark`` (``--no-library`` leaves these out).

Prints the card's name and power limit, the library's ptxas summary, one
line a shape class and direction, each recipe's totals weighed by the
shapes' calls in one forward of each net, and one JSON line; ``--out``
writes the table to a JSON file. Fails where an error passes its tolerance
or two runs differ. ``--root`` times another checkout's package. Imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# the recipes' batch and dataset (the dataset names the widths in the registry)
RECIPES = {"celeb256": ("celeb256", 8), "cifar10": ("cifar10", 32)}
FP32_PEAK = {"PCIe": 51e12, "NVL": 60e12}
FP32_PEAK_SXM = 67e12
# the kernels' error over the float64 result's largest value: float32 sums of
# up to B*H*W = 524,288 (weight gradient) or k*k*Cin = 4,608 terms, in
# another order than cuDNN's; cuDNN's own float32 error is printed beside it
TOLERANCE = 3e-5
DIRECTIONS = ("fprop", "dgrad", "wgrad")


def fp32_peak(card_name: str) -> float:
    for key, flops in FP32_PEAK.items():
        if key in card_name:
            return flops
    return FP32_PEAK_SXM


class Shape(collections.namedtuple("Shape", "b cin cout h w k bias")):
    """One conv of a net: (B, Cin, H, W) in, Cout out, a k x k filter."""

    def flops(self) -> float:
        """2 * M * N * K, each direction (torch's count for a conv)."""
        return 2.0 * self.b * self.h * self.w * self.cout * self.cin * self.k * self.k

    def label(self) -> str:
        return (f"B{self.b} {self.cin}->{self.cout} k{self.k} {self.h}x{self.w}"
                + (" +bias" if self.bias else ""))


def net_shapes(dataset: str, batch: int):
    """The convs of the recipe's encoder and decoder, in call order: one
    forward of each net on the meta device, recorded by a forward hook."""
    import torch

    from soft_intro_vae_torch.data.images import DATASETS
    from soft_intro_vae_torch.models.conv import Conv2d, SoftIntroVAE

    spec = DATASETS[dataset]
    with torch.device("meta"):
        vae = SoftIntroVAE(cdim=spec.cdim, zdim=8, channels=spec.channels,
                           image_size=spec.image_size)
    seen = []

    def hook(mod, args, out):
        x = args[0]
        seen.append(Shape(x.shape[0], x.shape[1], mod.out_channels, x.shape[2], x.shape[3],
                          mod.kernel_size[0], mod.bias is not None))

    hooks = [m.register_forward_hook(hook) for m in vae.modules() if isinstance(m, Conv2d)]
    x = torch.empty(batch, spec.cdim, spec.image_size, spec.image_size, device="meta")
    with torch.no_grad():
        mu, _ = vae.encoder(x)
        vae.decoder(mu)
    for h in hooks:
        h.remove()
    return seen


def _rel(got, want) -> float:
    return float((got.double() - want).abs().max() / want.abs().max().clamp_min(1e-30))


def check_shape(s: Shape, device, gen):
    """Errors of the kernels and of cuDNN in float32 against float64, each
    kernel run twice bit-equal; the operands for the timings."""
    import torch
    import torch.nn.functional as F

    from soft_intro_vae_torch.ops import conv_f32_cuda

    cl = torch.channels_last
    x = torch.randn(s.b, s.cin, s.h, s.w, generator=gen, device=device).contiguous(memory_format=cl)
    w = (torch.randn(s.cout, s.cin, s.k, s.k, generator=gen, device=device)
         / (s.cin * s.k * s.k) ** 0.5).contiguous(memory_format=cl)
    bias = torch.randn(s.cout, generator=gen, device=device) if s.bias else None
    dy = torch.randn(s.b, s.cout, s.h, s.w, generator=gen, device=device).contiguous(memory_format=cl)
    pad = (s.k - 1) // 2
    x64, w64, dy64 = (t.double().requires_grad_(True) for t in (x, w, dy))
    b64 = None if bias is None else bias.double()
    y64 = F.conv2d(x64, w64, b64, padding=pad)
    dx64, dw64 = torch.autograd.grad(y64, (x64, w64), dy64)
    want = {"fprop": y64.detach(), "dgrad": dx64, "wgrad": dw64}
    runs = {"fprop": lambda: conv_f32_cuda.fprop(x, w, bias),
            "dgrad": lambda: conv_f32_cuda.dgrad(dy, w),
            "wgrad": lambda: conv_f32_cuda.wgrad(x, dy, s.k)}
    xr, wr = x.detach().requires_grad_(True), w.detach().requires_grad_(True)
    yc = F.conv2d(xr, wr, bias, padding=pad)
    dxc, dwc = torch.autograd.grad(yc, (xr, wr), dy)
    cudnn = {"fprop": yc.detach(), "dgrad": dxc, "wgrad": dwc}
    out = {}
    for d in DIRECTIONS:
        a, b2 = runs[d](), runs[d]()
        torch.cuda.synchronize()
        out[d] = {"err": _rel(a, want[d]), "cudnn_err": _rel(cudnn[d], want[d]),
                  "bit_equal": bool(torch.equal(a, b2))}
    return out, (x, w, bias, dy)


def time_shape(s: Shape, operands, iters: int, library: bool):
    """Device ms of the kernels and, with ``library``, of cuDNN's calls."""
    import torch
    import torch.nn.functional as F

    from soft_intro_vae_torch.ops import conv_f32_cuda
    from tools.torch_norm_sites import device_ms

    x, w, bias, dy = operands
    out = {"fprop": {"kernel": device_ms(lambda: conv_f32_cuda.fprop(x, w, bias), iters)},
           "dgrad": {"kernel": device_ms(lambda: conv_f32_cuda.dgrad(dy, w), iters)},
           "wgrad": {"kernel": device_ms(lambda: conv_f32_cuda.wgrad(x, dy, s.k), iters)}}
    if not library:
        return out
    pad = [(s.k - 1) // 2] * 2
    conv_bwd = torch.ops.aten.convolution_backward
    for layout in ("nhwc", "nchw"):
        fmt = torch.channels_last if layout == "nhwc" else torch.contiguous_format
        xl, wl, dyl = (t.contiguous(memory_format=fmt) for t in (x, w, dy))
        for bench in (False, True):
            torch.backends.cudnn.benchmark = bench
            key = f"cudnn_{layout}" + ("_benchmark" if bench else "")
            calls = {
                "fprop": lambda: F.conv2d(xl, wl, bias, padding=pad[0]),
                "dgrad": lambda: conv_bwd(dyl, xl, wl, None, [1, 1], pad, [1, 1], False, [0, 0],
                                          1, [True, False, False]),
                "wgrad": lambda: conv_bwd(dyl, xl, wl, None, [1, 1], pad, [1, 1], False, [0, 0],
                                          1, [False, True, False]),
            }
            for d in DIRECTIONS:
                out[d][key] = device_ms(calls[d], iters)
    torch.backends.cudnn.benchmark = False
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--recipes", default="celeb256,cifar10")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--no-library", action="store_true", help="time the kernels alone")
    ap.add_argument("--root", default=ROOT, help="checkout whose soft_intro_vae_torch is timed")
    ap.add_argument("--out", default="", help="JSON file for the table")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_conv_f32_times: CUDA is not available", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from soft_intro_vae_torch.ops import conv_f32_cuda, cuda_build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    peak = fp32_peak(card)
    conv_f32_cuda.load()
    path = cuda_build.library_path(*conv_f32_cuda.spec())
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; package {root}; "
          f"ptxas: {cuda_build.ptxas_summary(path)}", flush=True)
    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(30)
    table, failures = [], []
    for recipe in args.recipes.split(","):
        dataset, batch = RECIPES[recipe]
        calls = collections.Counter(net_shapes(dataset, batch))
        totals = collections.defaultdict(float)
        for s, n in calls.items():
            errs, operands = check_shape(s, device, gen)
            times = time_shape(s, operands, args.iters, not args.no_library)
            del operands
            for d in DIRECTIONS:
                e, t = errs[d], times[d]
                bound = s.flops() / peak * 1e3
                row = {"recipe": recipe, "shape": s._asdict(), "calls": n, "direction": d,
                       "bound_ms": bound, **e, **{f"{k}_ms": v for k, v in t.items()}}
                table.append(row)
                for k, v in t.items():
                    totals[k + "_" + d] += n * v
                totals["bound_" + d] += n * bound
                lib = "  ".join(f"{k} {v:.4f}" for k, v in t.items() if k != "kernel")
                print(f"{recipe} {s.label():32s} x{n} {d}: kernel {t['kernel']:.4f} ms "
                      f"({s.flops() / t['kernel'] / 1e9:.1f} TFLOP/s, "
                      f"{100 * bound / t['kernel']:.1f}% of bound {bound:.4f}); err "
                      f"{e['err']:.2e} (cuDNN f32 {e['cudnn_err']:.2e}), bit-equal "
                      f"{e['bit_equal']}; {lib}", flush=True)
                if not (e["err"] <= TOLERANCE and e["bit_equal"]):
                    failures.append(f"{recipe} {s.label()} {d}: err {e['err']:.2e}, "
                                    f"bit-equal {e['bit_equal']}")
        summary = "; ".join(f"{k} {v:.3f}" for k, v in sorted(totals.items()))
        print(f"{recipe} totals, ms for one forward of each net and one backward of each "
              f"direction: {summary}", flush=True)
    print(json.dumps({"card": card, "failures": failures, "rows": len(table)}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "root": root, "table": table}, f, indent=1)
    if failures:
        print("FAIL: " + "; ".join(failures), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
