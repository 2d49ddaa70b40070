#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (soft_intro_vae_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing one line; any failure exits non-zero:
  1. device:  the card's name and power limit (nvidia-smi);
  2. build:   nvcc builds every kernel library of the checkout's sources,
              one process per source, all at once (ptxas registers, shared
              memory and spills on the line);
  3. kernels: each kernel against its plain PyTorch version on the card, at
              the main paths' shapes and at odd ones, plus its time, the plain
              version's, a library call's where one exists and the card's
              lower bound: the chamfer search, both directions in one
              launch (bit-equal, also on tie-heavy clouds), and the fused
              bias/leaky-ReLU/instance-norm/AdaIN forward and backward in
              every mode, f32 and bf16, at every LOD-6 site shape (each with
              its launch plan; two launches bit-equal);
  4. train 3d: ``train_soft_intro_vae_3d`` at the full width of
              configs/soft_intro_vae_hp.json (2048 points, batch 32, z 128) on
              synthetic clouds for one intro epoch plus the valid JSD, every
              kernel's launch count read around it; the step time after
              warm-up; one step through the kernel against the plain route;
  4b. graph 3d: the generic step's K-step form (``scan_steps`` 4, a CUDA
              graph of one step with the chamfer kernel captured) at that
              width, two calls against 8 eager steps from the same seed: every
              metric, parameter, BN buffer, Adam moment and count bit-equal;
  5. train style: ``train_style_soft_intro_vae`` at the full width of
              configs/ffhq256.yaml (7 blocks, 64->512 channels, latent 512,
              bf16) at LOD 6 (256x256, batch 4) on synthetic images, one
              vanilla and one intro epoch, every kernel's launch count read
              around it and held to the count the steps imply;
  6. step style: ms per LOD-6 intro step after warm-up; the first warm-up
              step records its fused-norm launches by site, and each site is
              then timed alone in bf16 and f32: per-step kernel ms against the
              per-step bound;
  7. routes style: one f32 intro step through the kernels against one
              through the plain version, from the same weights and draws;
  8. transition style: LOD 0 -> 1 through a blended epoch;
  9. kernels u8norm: the uint8 NHWC -> f32 normalize (NHWC memory, returned
              as (B, C, H, W) with channels-last strides) bit-equal to its
              plain version and to numpy for all 256 byte values and at the
              image recipes' batch shapes, odd ones and input slices that
              start off a 16-byte boundary, launch to launch, in the plain
              version's layout; its device time against the bound and
              against the library chain ``x.float().div(255)`` (no faster
              fails), and how many byte values that chain gets wrong;
 10. train image: ``train_soft_intro_vae`` at the CIFAR-10 recipe's full
              width (channels 64/128/256, z 128, batch 32, f32) and bench.py's
              ``scan_steps`` 8 on a uint8 dataset, one vanilla and one intro
              epoch of 8 graph calls of 8 steps and a trailing call of one,
              u8norm launches (eager warm-up steps plus graph replays) held to
              the steps taken, every 4-D parameter channels-last; ms per intro
              step after warm-up at scan_steps 8 and 1, and cuDNN's layout
              transposes (``nchwToNhwc``/``nhwcToNchw`` kernels) per graphed
              step from a torch.profiler pass over two calls, held to 0 (the
              trace held to one u8norm launch a step);
 11. routes image: one intro step through the kernel and through the plain
              normalize, from the same weights, draws and uint8 batch;
 11b. graph image: 16 intro steps as two graph calls of 8 against 16 eager
              steps from the same seed on the same uint8 batches, bit-equal
              as in 4b;
 12. bootstrap image: one bootstrap epoch at scan_steps 8; the target
              decoder's sync is a copy into tensors of its own;
 13. toy:     ``train_soft_intro_vae_toy`` at the toy CLI recipe's width
              (8Gaussians, z 2, 3 hidden layers of 256, batch 512), 100
              vanilla and 200 intro iterations, then its final metrics (the
              gnELBO over the 1024x1024 grid, sample KL and JSD); ms per
              iteration, device operations and idle share (torch.profiler),
              vanilla and intro; one intro step against the CPU's;
 14. fid:     the FID Inception (random init calibrated on the card) against
              its CPU forward, TF32 off, and its speed with TF32 off and on;
              Newton-Schulz against scipy's sqrtm at 2048x2048; a with_fid
              CIFAR-10 run at scan_steps 8 (u8norm launches = steps + real
              uint8 batches, no graph captured across the FID between graph
              calls, losses bit-equal to the run without FID); the style FID
              of the EMA generator at LOD 2.
Launch counts are launches on the device: a wrapper's calls, less those
recorded into a CUDA graph's capture, plus those its replays made
(train/graph.py).
The second-to-last lines are the kernels' JSON record and the card's name and
power limit; the last line is ``{"ok": true, "device": {...}}``.

Imports nothing of JAX or of the JAX package. Writes only inside the
checkout: soft_intro_vae_torch/_build/ (the kernels) and temporary
results_chip_smoke_*/ directories (the trainers' output, removed at the end).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# published peaks, dense, no sparsity (NVIDIA data sheets): FP32 outside the
# tensor cores in FLOP/s, device-memory rate in bytes/s
PEAKS = {"H100 SXM": (67e12, 3.35e12), "H100 PCIe": (51e12, 2.0e12), "H100 NVL": (60e12, 3.9e12)}

TRAIN_N = 256          # synthetic training clouds: 8 steps of batch 32
TIMED_STEPS = 10       # steps per timed window, after 3 warm-up steps
TIMED_WINDOWS = 3      # the median window is reported, with the others


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def peaks_for(name: str):
    for key in ("PCIe", "NVL"):
        if key in name:
            return f"H100 {key}", PEAKS[f"H100 {key}"]
    return "H100 SXM", PEAKS["H100 SXM"]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def clouds(gen, b: int, n: int, m: int, device):
    import torch

    a = 0.3 * torch.randn((b, n, 3), generator=gen, device=device)
    c = 0.3 * torch.randn((b, m, 3), generator=gen, device=device)
    return a, c


def tie_clouds(gen, b: int, n: int, m: int, device):
    """Clouds full of equal distances: coordinates on a coarse grid, and y
    drawn from 24 distinct points, each repeated at indices spread over every
    cluster rank."""
    import torch

    a = torch.round(torch.randn((b, n, 3), generator=gen, device=device) * 4.0) / 8.0
    base = torch.round(torch.randn((b, 24, 3), generator=gen, device=device) * 4.0) / 8.0
    pick = torch.randint(0, 24, (b, m), generator=gen, device=device)
    return a, torch.gather(base, 1, pick[..., None].expand(-1, -1, 3)).contiguous()


# chamfer cases (B, N, M): the recipe's shape, the JAX package's test shapes,
# N below one warp's rows and one x pass, M % 4 != 0 (scalar staging), M
# smaller than one slice, several x passes, many slices (bulk and scalar),
# more items than CTAs, slices streamed in chunks (bulk, scalar, 8 warps)
CHAMFER_CASES = ((32, 2048, 2048), (3, 48, 96), (1, 24, 24), (2, 2047, 1000), (1, 1, 1),
                 (2, 5, 300), (3, 100, 1001), (2, 3000, 7), (2, 5000, 2048), (1, 300, 40000),
                 (1, 600, 40001), (300, 24, 100), (133, 64, 5000), (133, 64, 5001),
                 (133, 1800, 1600))
# tie-heavy cases: the recipe's shape, N % 8 != 0 and M % 4 != 0
TIE_CASES = ((32, 2048, 2048), (2, 333, 1001))


def phase_kernels(device, peak_name, peaks):  # the chamfer kernel
    """chamfer_nearest (one launch, both directions) bit-equal to
    nearest_pair_plain: minima and argmins, both directions, at every case;
    two launches bit-equal."""
    import torch

    from soft_intro_vae_torch.ops import chamfer, chamfer_cuda
    from tools.torch_chamfer_times import (
        PAIR_INSTRUCTIONS, PAIR_INSTRUCTIONS_FMA, bound_ms, sass_slots_per_pair)
    from tools.torch_norm_sites import device_ms

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    pairs = [clouds(gen, *c, device) for c in CHAMFER_CASES]
    same = clouds(gen, 2, 512, 512, device)[0]
    pairs.append((same, same.clone()))
    pairs += [tie_clouds(gen, *c, device)[::-1] for c in TIE_CASES]
    max_err = 0.0
    names = ("min_x", "amin_x", "min_y", "amin_y")
    for preds, gts in pairs:
        for x, y in ((gts, preds), (preds, gts)):
            got = chamfer_cuda.nearest_pair_cuda(x, y)
            again = chamfer_cuda.nearest_pair_cuda(x, y)
            want = chamfer.nearest_pair_plain(x, y)
            torch.cuda.synchronize()
            shape = (tuple(x.shape), tuple(y.shape))
            for name, k, p, k2 in zip(names, got, want, again):
                check(torch.equal(k, p), f"chamfer_nearest {name} differs at {shape}: "
                      f"{(k != p).sum().item()} of {k.numel()}, max |diff| "
                      f"{(k.double() - p.double()).abs().max().item()}")
                check(torch.equal(k, k2), f"chamfer_nearest {name}: two launches differ at {shape}")
            max_err = max(max_err, *((k - p).abs().max().item()
                                     for k, p in zip(got[::2], want[::2])))
            del got, again, want
    check(float(chamfer.chamfer_distance(same, same, "cuda").abs().max()) == 0.0,
          "chamfer of identical clouds is not 0")

    # loss and both input gradients against autograd through the dense plain path
    for preds, gts in pairs[:2]:
        p = preds.clone().requires_grad_(True)
        g = gts.clone().requires_grad_(True)
        loss = chamfer.chamfer_distance(p, g, "cuda")
        gp, gg = torch.autograd.grad(loss.sum(), (p, g))
        p2 = preds.clone().requires_grad_(True)
        g2 = gts.clone().requires_grad_(True)
        dist = chamfer.pairwise_sqdist(g2, p2)
        ref = dist.min(dim=1).values.sum(dim=1) + dist.min(dim=2).values.sum(dim=1)
        rp, rg = torch.autograd.grad(ref.sum(), (p2, g2))
        del dist
        check(torch.allclose(loss, ref.detach(), rtol=1e-5, atol=0.0), "chamfer loss differs from dense")
        check(torch.allclose(gp, rp, rtol=1e-3, atol=1e-4), "chamfer d/dpreds differs from dense")
        check(torch.allclose(gg, rg, rtol=1e-3, atol=1e-4), "chamfer d/dgts differs from dense")

    # times at the main path's shape: one chamfer call's search, both
    # directions; device time, calls queued behind a sleep kernel (the
    # wrapper's host time is longer than the kernel's)
    preds, gts = pairs[0]
    bsz, n, _ = gts.shape
    m = preds.shape[1]

    def kernel():
        chamfer_cuda.nearest_pair_cuda(gts, preds)

    def plain():
        chamfer.nearest_pair_plain(gts, preds)

    def library():
        d = torch.cdist(gts, preds, compute_mode="donot_use_mm_for_euclid_dist").square()
        d.min(dim=2)
        d.min(dim=1)

    # turns: plain, kernel, kernel, plain; the mean of each pair
    t_plain_1 = device_ms(plain, iters=5)
    t_kernel_1 = device_ms(kernel)
    t_kernel_2 = device_ms(kernel)
    t_plain_2 = device_ms(plain, iters=5)
    t_lib = device_ms(library, iters=5)
    t_calls = cuda_ms(kernel)
    # every distance once, 8 FP32 instructions (no FMA: bit-exact) at the FP32
    # instruction rate, half the FP32 FLOP rate
    rate = peaks[0] / 2
    t_ops = bound_ms(bsz, n, m, rate)
    nbytes = 4 * 3 * bsz * (n + m) + (4 + 8) * bsz * (n + m)  # clouds in, min+argmin out
    t_bytes = nbytes / peaks[1] * 1e3
    slots, ops = sass_slots_per_pair(chamfer_cuda.library_path())
    pl = chamfer_cuda.plan(bsz, n, m)
    record = {
        "name": "chamfer_nearest",
        "route": "cuda",
        "source": "soft_intro_vae_torch/ops/csrc/chamfer_nearest.cu",
        "replaces": "soft_intro_vae_tpu/ops/chamfer_pallas.py:74",
        "launches": None,  # filled from the train phase
        "max_abs_err": max_err,
        "ms": (t_kernel_1 + t_kernel_2) / 2,
        "plain_ms": (t_plain_1 + t_plain_2) / 2,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": t_lib,
        "sass_slots_per_pair": slots,
    }
    slots_text = f"{slots:.2f}" if slots is not None else f"not counted ({ops})"
    print(f"kernels: chamfer_nearest (one launch, both directions) bit-equal to "
          f"nearest_pair_plain (minima and argmins, both directions) and launch to launch at "
          f"{list(CHAMFER_CASES)}, identical clouds and tie-heavy clouds at {list(TIE_CASES)}; "
          f"loss/grads match dense autograd; plan at {(bsz, n, m)}: {pl}; one chamfer call's "
          f"search, device time: kernel {t_kernel_1:.4f}/{t_kernel_2:.4f} ms (calls back to "
          f"back, host time included: {t_calls:.4f} ms), plain {t_plain_1:.4f}/"
          f"{t_plain_2:.4f} ms, cdist + 2 min {t_lib:.4f} ms, bound {record['bound_ms']:.4f} ms "
          f"({record['bound_by']}: {PAIR_INSTRUCTIONS} FP32 instructions a pair at "
          f"{rate / 1e12:.2f}e12/s, half of {peak_name}'s {peaks[0] / 1e12:.0f} TFLOP/s FP32; "
          f"{bound_ms(bsz, n, m, rate, PAIR_INSTRUCTIONS_FMA):.4f} ms with FMAs, not bit-exact; "
          f"bytes {t_bytes:.4f} ms at {peaks[1] / 1e12:.2f} TB/s); "
          f"{record['ms'] * 1e-3 * rate / (bsz * n * m):.2f} issue slots a pair achieved, "
          f"SASS tile loop {slots_text} slots a pair", flush=True)
    if slots is not None:
        print("kernels: chamfer_nearest tile loop opcodes: " + ", ".join(
            f"{k} {v}" for k, v in sorted(ops.items(), key=lambda kv: -kv[1])), flush=True)
    return record


def phase_build() -> str:
    """nvcc builds every kernel library of the checkout, one process per source,
    all started together."""
    from soft_intro_vae_torch.ops import adain_cuda, chamfer_cuda, cuda_build, u8norm_cuda

    t0 = time.perf_counter()
    libs = (chamfer_cuda, adain_cuda, u8norm_cuda)
    paths = cuda_build.build_many([lib.spec() for lib in libs])
    for lib in libs:
        lib.load()
    parts = [f"{os.path.basename(lib.spec()[0])}: {cuda_build.ptxas_summary(path)}"
             for lib, path in zip(libs, paths)]
    return (f"build: chamfer_nearest.cu, bias_act_norm.cu and u8norm.cu in "
            f"{time.perf_counter() - t0:.2f} s (in parallel); " + " || ".join(parts))


# fused-norm cases: the ffhq256 LOD-6 extremes and an odd shape, in every mode
NORM_SHAPES = ((4, 64, 256, 256), (4, 512, 4, 4), (4, 512, 2, 2), (3, 5, 7, 9))
# the norm sites of the ffhq256 LOD-6 intro step (models/style.py, startf 64,
# maxf 512, batch 4); phase_style_step holds this list to the step's launches
SITE_SHAPES = ((4, 64, 256, 256), (4, 128, 128, 128), (4, 256, 64, 64), (4, 512, 32, 32),
               (4, 512, 16, 16), (4, 512, 8, 8), (4, 512, 4, 4), (4, 512, 2, 2))
CHECK_SHAPES = tuple(dict.fromkeys(NORM_SHAPES + SITE_SHAPES))
NORM_MODES = (("plain", False), ("noise", True), ("corr", True))
# Tolerances, kernel against bias_act_norm_plain on the same inputs on the card:
#  * f32: sums (moments, sum(dy), sum(dy*ehat), the parameter gradients) are
#    taken in another order, so every output agrees to 1e-4 of the largest
#    magnitude of its tensor, not bit for bit;
#  * bf16: y and dx are rounded to bf16 from f32 values that differ in their
#    last bits, so an element may land one bf16 ulp (<= 2^-7 of its value)
#    away; the f32 outputs (m, v and the per-plane sums) keep the f32 tolerance.
NORM_RTOL = 1e-4
BF16_ULP = 2.0 ** -7


def _norm_inputs(gen, shape, mode, affine, dtype, device):
    import torch

    bsz, ch, h, w = shape
    f32 = dict(generator=gen, device=device, dtype=torch.float32)
    x = (2.0 * torch.randn(shape, **f32) + 0.3).to(dtype)
    args = dict(bias=torch.randn((ch,), **f32), g=None, b=None, n=None, nw=None)
    if affine:
        args["g"] = torch.randn((bsz, ch), **f32) + 1.0
        args["b"] = torch.randn((bsz, ch), **f32)
    if mode == "noise":
        args["n"] = torch.randn((bsz, h, w), **f32)
        args["nw"] = torch.randn((ch,), **f32)
    cot = dict(dy=torch.randn(shape, **f32).to(dtype), dm=torch.randn((bsz, ch), **f32),
               dv=torch.randn((bsz, ch), **f32))
    return x, args, cot


def _norm_err(name, k, p, low_precision: bool):
    """(max |k - p|, max |k - p| / max |p|), failing beyond the stated tolerance."""
    k = k.float()
    p = p.float()
    scale = max(float(p.abs().max()), 1e-30)
    diff = (k - p).abs()
    allowed = NORM_RTOL * scale + (BF16_ULP * p.abs() if low_precision else 0.0)
    bad = int((diff > allowed).sum())
    check(bad == 0, f"{name}: {bad} of {diff.numel()} elements beyond tolerance, "
          f"max |diff| {float(diff.max())!r} at scale {scale!r}")
    return float(diff.max()), float(diff.max()) / scale


def plan_line(shape) -> str:
    import torch

    from soft_intro_vae_torch.ops import adain_cuda

    bsz, ch, h, w = shape
    parts = []
    for dtype in (torch.bfloat16, torch.float32):
        for direction in adain_cuda.DIRECTIONS:
            p = adain_cuda.plan(bsz, ch, h * w, dtype, direction)
            parts.append(f"{str(dtype)[6:]} {direction} {p.tier} k={p.planes_per_cta} "
                         f"G={p.lanes} Q={p.cluster} T={p.threads} E={p.slice} unit={p.unit} "
                         f"smem={p.smem} grid={p.grid}")
    return f"plan {tuple(shape)}: " + "; ".join(parts)


def phase_norm_kernels(device):
    """bias_act_norm forward and backward kernels against their plain versions,
    and each against itself: two launches on the same inputs give the same bits."""
    import torch
    import torch.nn.functional as F

    from soft_intro_vae_torch.ops import adain, adain_cuda
    from tools.torch_norm_sites import device_ms, norm_bytes

    for shape in CHECK_SHAPES:
        print(plan_line(shape), flush=True)
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    kw = dict(eps=1e-8, slope=0.2, corr_scale=2.0)
    worst = {"fwd": 0.0, "bwd": 0.0, "fwd_rel": 0.0, "bwd_rel": 0.0}

    def note(key, errs):
        worst[key] = max(worst[key], errs[0])
        worst[key + "_rel"] = max(worst[key + "_rel"], errs[1])

    for dtype in (torch.float32, torch.bfloat16):
        low = dtype == torch.bfloat16
        for shape in CHECK_SHAPES:
            for mode, affine in NORM_MODES:
                x, a, cot = _norm_inputs(gen, shape, mode, affine, dtype, device)
                case = f"{mode}{'/affine' if affine else ''} {tuple(shape)} {dtype}"
                fk = adain_cuda.forward(x, a["bias"], a["g"], a["b"], a["n"], a["nw"],
                                        mode=mode, **kw)
                fk2 = adain_cuda.forward(x, a["bias"], a["g"], a["b"], a["n"], a["nw"],
                                         mode=mode, **kw)
                fp = adain.bias_act_norm_plain(x, a["bias"], a["g"], a["b"], a["n"], a["nw"],
                                               mode=mode, **kw)
                torch.cuda.synchronize()
                check(fk[0].dtype == dtype, f"forward {case}: y is {fk[0].dtype}")
                check(all(torch.equal(p, q) for p, q in zip(fk, fk2)),
                      f"forward {case}: two launches differ")
                for name, k, p, lp in zip(("y", "m", "v"), fk, fp, (low, False, False)):
                    note("fwd", _norm_err(f"forward {case} {name}", k, p, lp))
                m, v = fp[1], fp[2]
                bargs = (cot["dy"], x, a["bias"], a["g"], a["n"], a["nw"], m, v, cot["dm"],
                         cot["dv"])
                bk = adain_cuda.backward(*bargs, mode=mode, **kw)
                bk2 = adain_cuda.backward(*bargs, mode=mode, **kw)
                bp = adain.bias_act_norm_backward_plain(x, a["bias"], a["g"], a["n"], a["nw"],
                                                        m, v, cot["dy"], cot["dm"], cot["dv"],
                                                        mode=mode, **kw)
                torch.cuda.synchronize()
                check(all(torch.equal(p, q) for p, q in zip(bk, bk2)),
                      f"backward {case}: two launches differ")
                names = ("dx", "d_bst", "d_g", "d_bias", "d_nw")
                for name, k, p, lp in zip(names, bk, bp, (low, False, False, False, False)):
                    note("bwd", _norm_err(f"backward {case} {name}", k, p, lp))
                del x, a, cot, fk, fk2, fp, bk, bk2, bp

    # times at the decoder's top site in training (noise + AdaIN), 4x64x256x256
    shape = NORM_SHAPES[0]
    times = {}
    for dtype in (torch.bfloat16, torch.float32):
        x, a, cot = _norm_inputs(gen, shape, "noise", True, dtype, device)
        args = (a["bias"], a["g"], a["b"], a["n"], a["nw"])
        _, m, v = adain_cuda.forward(x, *args, mode="noise", **kw)
        bargs = (cot["dy"], x, a["bias"], a["g"], a["n"], a["nw"], m, v, cot["dm"], cot["dv"])
        # the activated tensor the fused chain normalises
        e = F.leaky_relu(x.float() + a["nw"][:, None, None] * a["n"][:, None]
                         + a["bias"][:, None, None], 0.2).to(dtype)

        def fwd_k():
            adain_cuda.forward(x, *args, mode="noise", **kw)

        def fwd_p():
            adain.bias_act_norm_plain(x, *args, mode="noise", **kw)

        def bwd_k():
            adain_cuda.backward(*bargs, mode="noise", **kw)

        def bwd_p():
            adain.bias_act_norm_backward_plain(x, a["bias"], a["g"], a["n"], a["nw"], m, v,
                                               cot["dy"], cot["dm"], cot["dv"], mode="noise", **kw)

        t = {}
        # device time, calls queued behind a sleep; turns: plain, kernel,
        # kernel, plain; the mean of each pair
        t["fwd_plain"] = [device_ms(fwd_p, iters=5)]
        t["fwd"] = [device_ms(fwd_k), device_ms(fwd_k)]
        t["fwd_plain"].append(device_ms(fwd_p, iters=5))
        t["bwd_plain"] = [device_ms(bwd_p, iters=5)]
        t["bwd"] = [device_ms(bwd_k), device_ms(bwd_k)]
        t["bwd_plain"].append(device_ms(bwd_p, iters=5))
        t["nearest"] = [device_ms(lambda: F.instance_norm(e, eps=1e-8))]
        # calls one after another, the wrapper's host time included
        t["fwd_calls"] = [cuda_ms(fwd_k)]
        t["bwd_calls"] = [cuda_ms(bwd_k)]
        size = x.element_size()
        times[str(dtype).replace("torch.", "")] = {
            k: sum(vals) / len(vals) for k, vals in t.items()} | {
            "fwd_bytes": norm_bytes("fwd", shape, "noise", True, size),
            "bwd_bytes": norm_bytes("bwd", shape, "noise", True, size),
            "runs": t}
        del x, a, cot, e, m, v
    return worst, times


def phase_norm_sites(device, mix, peaks):
    """Each fused-norm site of one LOD-6 intro step, timed alone in the mode
    and eps the step runs it, in bf16 and f32, then summed over the step with
    the launches ``mix`` recorded: per-step kernel ms against per-step bound."""
    from tools.torch_norm_sites import row_line, time_sites, totals_line

    rows, totals = time_sites(device, mix, peaks[1])
    for row in rows:
        print(f"norm site: {row_line(row)}", flush=True)
    print(f"norm sites per LOD-6 intro step (each site timed alone, device time of 20 "
          f"queued launches after 3 warm-up; bound by bytes at {peaks[1] / 1e12:.2f} TB/s): "
          f"{totals_line(totals)}", flush=True)
    return totals


def norm_records(worst, times, peaks, totals):
    """The two fused-norm kernels' entries of the JSON line (times in bf16)."""
    bf = times["bfloat16"]
    recs = []
    for key, name, call in (("fwd", "bias_act_norm_fwd", 171), ("bwd", "bias_act_norm_bwd", 320)):
        recs.append({
            "name": name,
            "route": "cuda",
            "source": "soft_intro_vae_torch/ops/csrc/bias_act_norm.cu",
            "replaces": f"soft_intro_vae_tpu/ops/adain_pallas.py:{call}",
            "launches": None,  # filled from the style train phase
            "max_abs_err": worst[key],
            "ms": bf[key],
            "plain_ms": bf[f"{key}_plain"],
            "bound_ms": bf[f"{key}_bytes"] / peaks[1] * 1e3,
            "bound_by": "bytes",
            "library_ms": None,  # no single PyTorch call computes the fused chain
            "dtype": "bfloat16",
            "shape": list(NORM_SHAPES[0]),
            "step_ms": totals[("bfloat16", key)][0],
            "step_bound_ms": totals[("bfloat16", key)][1],
        })
    return recs


def norm_line(worst, times, peaks) -> str:
    parts = []
    for dt, t in times.items():
        parts.append(
            f"{dt}: fwd kernel {t['runs']['fwd'][0]:.4f}/{t['runs']['fwd'][1]:.4f} ms, plain "
            f"{t['runs']['fwd_plain'][0]:.4f}/{t['runs']['fwd_plain'][1]:.4f} ms, bound "
            f"{t['fwd_bytes'] / peaks[1] * 1e3:.4f} ms; bwd kernel {t['runs']['bwd'][0]:.4f}/"
            f"{t['runs']['bwd'][1]:.4f} ms, plain {t['runs']['bwd_plain'][0]:.4f}/"
            f"{t['runs']['bwd_plain'][1]:.4f} ms, bound {t['bwd_bytes'] / peaks[1] * 1e3:.4f} ms; "
            f"nearest PyTorch call (F.instance_norm alone, not the fused chain) "
            f"{t['nearest']:.4f} ms; calls back to back (host overhead included) fwd "
            f"{t['fwd_calls']:.4f} ms, bwd {t['bwd_calls']:.4f} ms")
    return (f"kernels: bias_act_norm fwd/bwd agree with bias_act_norm_plain/"
            f"bias_act_norm_backward_plain at {list(CHECK_SHAPES)} x "
            f"{[m for m, _ in NORM_MODES]} x f32/bf16, and two launches on the same inputs are "
            f"bit-equal (worst max|diff| fwd {worst['fwd']:.3g}, bwd {worst['bwd']:.3g}; "
            f"as a share of the tensor's max|ref| fwd {worst['fwd_rel']:.3g}, bwd "
            f"{worst['bwd_rel']:.3g}; tolerance {NORM_RTOL:g} of the tensor's scale, plus one bf16 "
            f"ulp per element in bf16); device times (calls queued behind a sleep kernel) at "
            f"{NORM_SHAPES[0]} noise+AdaIN: " + "; ".join(parts)
            + f" (bound by bytes at {peaks[1] / 1e12:.2f} TB/s)")


def reset_counts() -> None:
    from soft_intro_vae_torch.ops import adain_cuda, chamfer_cuda, u8norm_cuda
    from soft_intro_vae_torch.train import graph

    chamfer_cuda.launches = u8norm_cuda.launches = 0
    adain_cuda.launches_fwd = adain_cuda.launches_bwd = 0
    graph.captured.clear()
    graph.replayed.clear()


def read_counts() -> dict:
    """Launches on the device since reset_counts, by kernel: each wrapper's
    count (every call, eager or recorded into a CUDA graph's capture) less
    the launches recorded into captures, plus those the replays made
    (train/graph.py); with no graph, the wrappers' counts."""
    from soft_intro_vae_torch.train import graph

    return {k: v - graph.captured[k] + graph.replayed[k] for k, v in graph.wrapper_counts().items()}


def captured_counts() -> dict:
    """Kernel launches recorded into CUDA graph captures since reset_counts."""
    from soft_intro_vae_torch.train import graph

    return dict(graph.captured)


@contextlib.contextmanager
def no_tf32():
    """Full-f32 convolutions and matmuls, for comparing two routes."""
    import torch

    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def phase_train_3d(device, card: str, results_dir: str):
    """The 3D trainer's main path at full width, with the kernels' launches counted."""
    import torch

    from soft_intro_vae_torch.data.shapenet import SyntheticClouds
    from soft_intro_vae_torch.train.step import INTRO_NOISES
    from soft_intro_vae_torch.train.threed import (
        ThreeDConfig, build_3d_training, train_soft_intro_vae_3d)

    base = ThreeDConfig.from_json(os.path.join(ROOT, "configs", "soft_intro_vae_hp.json"))
    cfg = dataclasses.replace(
        base, use_synthetic=True, synthetic_n=TRAIN_N, max_epochs=1, valid_frequency=1,
        save_frequency=1, seed=0, resume=False, verbose=False, device=str(device),
        results_dir=results_dir)
    check((cfg.n_points, cfg.batch_size, cfg.z_size) == (2048, 32, 128),
          f"recipe width changed: {(cfg.n_points, cfg.batch_size, cfg.z_size)}")
    steps = TRAIN_N // cfg.batch_size

    reset_counts()
    t0 = time.perf_counter()
    _, summary = train_soft_intro_vae_3d(cfg)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    counts = read_counts()
    launches = counts["chamfer_nearest"]
    last = summary["last_metrics"]
    check(launches == 6 * steps, f"chamfer_nearest launched {launches} times in {steps} intro "
          f"steps, expected {6 * steps} (one a chamfer call)")
    check(counts["bias_act_norm_fwd"] == counts["bias_act_norm_bwd"] == counts["u8norm"] == 0,
          f"the 3D path launched a fused-norm or u8norm kernel: {counts}")
    check(math.isfinite(last["loss_e"]) and math.isfinite(last["loss_d"]),
          f"non-finite losses: {last}")
    check(summary["best_jsd"] is not None and math.isfinite(summary["best_jsd"]),
          f"non-finite JSD: {summary['best_jsd']}")
    check(os.path.exists(os.path.join(cfg.results_dir, "weights", "model_epoch_1_iter_0.ckpt")),
          "no checkpoint written")

    # step time after warm-up, from the same build_3d_training the trainer calls
    state, _, intro_step = build_3d_training(cfg)
    pts = torch.from_numpy(SyntheticClouds(cfg.batch_size * 4, cfg.n_points, seed=5).points).to(device)
    batches = [pts[i * cfg.batch_size:(i + 1) * cfg.batch_size] for i in range(4)]
    for i in range(3):
        state, m = intro_step(state, batches[i % 4])
    windows = []
    for _ in range(TIMED_WINDOWS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(TIMED_STEPS):
            state, m = intro_step(state, batches[i % 4])
        torch.cuda.synchronize()
        windows.append((time.perf_counter() - t0) * 1e3 / TIMED_STEPS)
    ms_step = sorted(windows)[len(windows) // 2]
    check(math.isfinite(float(m["loss_e"])), "non-finite loss in the timed steps")

    # impl="cuda" against impl="plain": same weights, same batch, same noises
    gen = torch.Generator(device=device)
    gen.manual_seed(11)
    noises = {k: torch.randn((cfg.batch_size, cfg.z_size), generator=gen, device=device)
              for k in INTRO_NOISES}
    noises["noise"] = noises["noise"] * cfg.prior_std
    losses = {}
    with no_tf32():
        for impl in ("cuda", "plain"):
            st, _, step = build_3d_training(dataclasses.replace(cfg, chamfer_impl=impl))
            _, m = step(st, batches[0], noises)
            losses[impl] = (float(m["loss_e"]), float(m["loss_d"]))
    for name, k, p in zip(("loss_e", "loss_d"), losses["cuda"], losses["plain"]):
        check(abs(k - p) <= 1e-4 * abs(p), f"{name}: impl=cuda {k!r} vs impl=plain {p!r}")
    print(f"train 3d: {steps} intro steps + valid JSD at 2048 points, batch 32, z 128 in "
          f"{epoch_s:.2f} s (first call, warm-up included); loss_e {last['loss_e']:.6g}, "
          f"loss_d {last['loss_d']:.6g}, JSD {summary['best_jsd']:.4f}; chamfer_nearest "
          f"launches {launches}; after warm-up {ms_step:.3f} ms/step (median of "
          f"{'/'.join(f'{w:.3f}' for w in windows)}), "
          f"{cfg.batch_size * 1e3 / ms_step:.1f} clouds/s on {card}; impl=cuda vs plain "
          f"loss_e {losses['cuda'][0]!r}/{losses['plain'][0]!r}, loss_d "
          f"{losses['cuda'][1]!r}/{losses['plain'][1]!r}", flush=True)
    return {"chamfer_nearest": launches}


def compare_runs(a, b):
    """Two (state, metrics) runs of the generic step: every metric, model
    tensor (parameters and BN buffers), Adam moment and count, and the
    generator's state. Returns (names of the tensors that differ, the
    largest |difference| among them, how many were compared)."""
    import torch

    (sa, ma), (sb, mb) = a, b
    pairs = [(f"metric {k}", ma[k], mb[k]) for k in ma]
    sd_b = sb.model.state_dict()
    pairs += [(k, v, sd_b[k]) for k, v in sa.model.state_dict().items()]
    for name in ("opt_e", "opt_d"):
        states = zip(getattr(sa, name).state.values(), getattr(sb, name).state.values())
        for i, (p, q) in enumerate(states):
            pairs += [(f"{name}[{i}].{k}", p[k], q[k]) for k in ("exp_avg", "exp_avg_sq", "step")]
    pairs.append(("generator", sa.generator.get_state(), sb.generator.get_state()))
    differ, worst = [], 0.0
    for name, x, y in pairs:
        if x.shape != y.shape or not torch.equal(x, y):
            differ.append(name)
            if x.shape == y.shape:
                worst = max(worst, float((x.double() - y.double()).abs().max()))
    return differ, worst, len(pairs)


@contextlib.contextmanager
def exact_routes(deterministic_algorithms: bool = False):
    """TF32 off and cuDNN deterministic, for comparing two routes bit for bit;
    with ``deterministic_algorithms`` also PyTorch's deterministic kernels
    where it has them (the chamfer backward's ``scatter_add_`` sums with
    atomics otherwise, in no fixed order, so two eager 3D steps differ in the
    last bits), warning only for cuBLAS, which is deterministic on one stream
    and one workspace size."""
    import warnings

    import torch

    saved = (torch.backends.cudnn.deterministic, torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic = True
    if deterministic_algorithms:
        torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with no_tf32(), warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=".*CuBLAS.*")
            yield
    finally:
        torch.backends.cudnn.deterministic = saved[0]
        torch.use_deterministic_algorithms(saved[1], warn_only=saved[2])


def graph_against_eager(build, xs, scan: int):
    """The same seed's state built twice: ``xs`` (S, B, ...) through K-step
    calls of ``scan`` (a CUDA graph) on one, S eager steps on the other.
    Returns (graph run, eager run, device launches and captures of the graph
    run)."""
    import torch

    sg, graphed = build(scan)
    se, eager = build(1)
    reset_counts()
    mg = [graphed(sg, xs[i:i + scan])[1] for i in range(0, xs.shape[0], scan)]
    torch.cuda.synchronize()
    counts, captured = read_counts(), captured_counts()
    me = [eager(se, x)[1] for x in xs]
    torch.cuda.synchronize()
    return ((sg, {k: torch.cat([m[k] for m in mg]) for k in mg[0]}),
            (se, {k: torch.stack([m[k] for m in me]) for k in me[0]}), counts, captured)


def phase_graph_3d(device):
    """The generic step's K-step form with the 3D StepConfig at full width
    (2048 points, batch 32, z 128): two calls of K = 4 (a CUDA graph, the
    chamfer kernel captured) against 8 eager steps from the same seed."""
    import torch

    from soft_intro_vae_torch.data.shapenet import SyntheticClouds
    from soft_intro_vae_torch.train.threed import ThreeDConfig, build_3d_training

    base = ThreeDConfig.from_json(os.path.join(ROOT, "configs", "soft_intro_vae_hp.json"))
    cfg = dataclasses.replace(base, seed=0, device=str(device), verbose=False)
    n, b = 8, cfg.batch_size
    pts = torch.from_numpy(SyntheticClouds(n * b, cfg.n_points, seed=6).points).to(device)
    xs = pts.view(n, b, cfg.n_points, 3)

    def build(scan):
        state, _, intro = build_3d_training(cfg, scan_steps=scan)
        return state, intro

    t0 = time.perf_counter()
    with exact_routes(deterministic_algorithms=True):
        graph_run, eager_run, counts, captured = graph_against_eager(build, xs, 4)
    differ, worst, compared = compare_runs(graph_run, eager_run)
    check(counts["chamfer_nearest"] == 6 * n and captured == {"chamfer_nearest": 6},
          f"3D K-step run: device launches {counts}, captured {captured}; expected "
          f"{6 * n} chamfer launches, 6 recorded in one capture")
    check(not differ, f"3D K-step graph against eager steps: {len(differ)} of {compared} tensors "
          f"differ (first {differ[:6]}), max |diff| {worst!r}")
    print(f"graph 3d: the generic step's K-step form at 2048 points, batch 32, z 128, two calls "
          f"of K = 4 (3 eager warm-up steps, a capture, 5 replays) against 8 eager steps, TF32 "
          f"off, cuDNN deterministic, PyTorch's deterministic scatter_add_: all {compared} "
          f"tensors bit-equal (metrics (8,), "
          f"parameters and BN buffers, Adam moments and counts, generator); chamfer_nearest "
          f"launches {counts['chamfer_nearest']} on the device, {captured['chamfer_nearest']} "
          f"recorded in the capture (a cooperative launch captured); "
          f"{time.perf_counter() - t0:.2f} s", flush=True)


def phase_graph_image(device):
    """16 intro steps at the CIFAR-10 recipe's width as two K-step calls of 8
    (a CUDA graph, the u8norm kernel captured) against 16 eager steps from the
    same seed on the same uint8 batches."""
    import torch

    from soft_intro_vae_torch.train.image import build_image_training

    n = 16
    spec, ds = image_dataset(n * 32, seed=9)
    xs = torch.from_numpy(ds.images).to(device).view(n, 32, *ds.images.shape[1:])
    cfg = image_config(device, "")

    def build(scan):
        state, _, intro = build_image_training(dataclasses.replace(cfg, scan_steps=scan), spec)
        return state, intro

    t0 = time.perf_counter()
    with exact_routes():
        graph_run, eager_run, counts, captured = graph_against_eager(build, xs, IMAGE_SCAN)
    differ, worst, compared = compare_runs(graph_run, eager_run)
    check(counts["u8norm"] == n and captured == {"u8norm": 1},
          f"image K-step run: device launches {counts}, captured {captured}")
    check(not differ, f"image K-step graph against eager steps: {len(differ)} of {compared} "
          f"tensors differ (first {differ[:6]}), max |diff| {worst!r}")
    print(f"graph image: CIFAR-10 recipe width, two calls of K = {IMAGE_SCAN} (3 eager warm-up "
          f"steps, a capture, 13 replays) against {n} eager intro steps, TF32 off, cuDNN "
          f"deterministic: all {compared} tensors bit-equal (metrics ({n},), parameters and BN "
          f"buffers, Adam moments and counts, generator); u8norm launches {counts['u8norm']} on "
          f"the device, {captured['u8norm']} recorded in the capture; "
          f"{time.perf_counter() - t0:.2f} s", flush=True)


# the style slice: configs/ffhq256.yaml at full width, LOD 6 (256x256)
STYLE_YAML = os.path.join(ROOT, "configs", "ffhq256.yaml")
STYLE_TRAIN_OPTS = ["DATASET.SYNTHETIC", "true", "DATASET.SYNTHETIC_N", "16",
                    "TRAIN.EPOCHS_PER_LOD", "0", "TRAIN.TRAIN_EPOCHS", "2"]
STYLE_TRANSITION_OPTS = ["DATASET.SYNTHETIC", "true", "DATASET.SYNTHETIC_N", "128",
                         "TRAIN.EPOCHS_PER_LOD", "2", "TRAIN.TRAIN_EPOCHS", "3"]
# kernel route against plain route, one f32 intro step without TF32: loss_e
# comes from forwards before any update, so it agrees to f32 sums in another
# order; loss_d follows the E phase's LREQAdam update (beta1 = 0), which turns
# rounding-level gradient differences into moves of up to 2 lr on a few weights
STYLE_RTOL_LOSS_E = 1e-4
STYLE_RTOL_LOSS_D = 1e-3


def style_config(device, results_dir: str, opts):
    from soft_intro_vae_torch.train.style import StyleConfig

    cfg = StyleConfig.from_yaml(STYLE_YAML, opts)
    cfg = dataclasses.replace(cfg, output_dir=results_dir, device=str(device), verbose=False,
                              resume=False, seed=0)
    width = (cfg.layer_count, cfg.start_channel_count, cfg.max_channel_count,
             cfg.latent_space_size, cfg.mapping_layers, cfg.compute_dtype)
    check(width == (7, 64, 512, 512, 8, "bfloat16"), f"ffhq256 width changed: {width}")
    return cfg


def style_step_launches(lod: int, vanilla: int, intro: int):
    """(forward, backward) fused-norm launches of these steps at this LOD.

    Each encoder and decoder pass runs 2 norm sites per block, lod + 1 blocks.
    Vanilla: 1 encode + 1 generate, both with a gradient. Intro: E phase
    generate(fake) [no gradient], encode(x), generate(rec), encode(rec),
    generate(rec_rec), encode(fake), generate(rec_fake); D phase generate(fake),
    generate(rec), encode(rec), encode(fake), generate(rec_rec),
    generate(rec_fake): 13 forwards, 12 of them with a gradient."""
    sites = 2 * (lod + 1)
    return sites * (2 * vanilla + 13 * intro), sites * (2 * vanilla + 12 * intro)


def phase_style_train(device, card: str, results_dir: str):
    """The style trainer's main path at ffhq256 width, LOD 6, with launches counted."""
    import torch

    from soft_intro_vae_torch.train.style import train_style_soft_intro_vae

    cfg = style_config(device, results_dir, STYLE_TRAIN_OPTS)
    batch = cfg.lod_2_batch_tables["1GPU"][cfg.layer_count - 1]
    steps = cfg.synthetic_n // batch  # per epoch; epoch 0 vanilla, epoch 1 intro
    reset_counts()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    state, summary = train_style_soft_intro_vae(cfg)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = read_counts()
    want_fwd, want_bwd = style_step_launches(cfg.layer_count - 1, steps, steps)
    check(counts["bias_act_norm_fwd"] == want_fwd and counts["bias_act_norm_bwd"] == want_bwd,
          f"fused-norm launches {counts}, expected forward {want_fwd}, backward {want_bwd}")
    check(counts["chamfer_nearest"] == counts["u8norm"] == 0,
          f"the style path launched chamfer or u8norm: {counts}")
    check(summary["epochs_run"] == 2 and summary["steps"] == 2 * steps and state.step == 2 * steps,
          f"style run: {summary['epochs_run']} epochs, {summary['steps']} steps")
    last = summary["last_metrics"]
    check(all(math.isfinite(v) for v in last.values()), f"non-finite style metrics: {last}")
    final = os.path.join(results_dir, "training_artifacts",
                         f"{cfg.name}_model_epoch_1_iter_{2 * steps}_final.ckpt")
    check(os.path.exists(final), f"no final checkpoint at {final}")
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    print(f"train style: ffhq256 width (7 blocks, 64->512 channels, latent 512, bf16) at LOD 6 "
          f"(256x256), batch {batch}: {steps} vanilla + {steps} intro steps and 3 checkpoints "
          f"in {run_s:.2f} s (first call, warm-up included); loss_e {last['loss_e']:.6g}, "
          f"loss_d {last['loss_d']:.6g}, rec_loss {last['rec_loss']:.6g}; bias_act_norm "
          f"launches fwd {counts['bias_act_norm_fwd']} / bwd {counts['bias_act_norm_bwd']} "
          f"(expected {want_fwd} / {want_bwd}); peak device memory {peak_gb:.2f} GB; "
          f"on {card}", flush=True)
    return cfg, counts


def _style_batches(cfg, device, n: int):
    from soft_intro_vae_torch.train.style import MultiResImages, _Feed

    res = 2 ** (cfg.layer_count + 1)
    batch = cfg.lod_2_batch_tables["1GPU"][cfg.layer_count - 1]
    images = MultiResImages.synthetic(batch * n, res, seed=5).at_resolution(res)
    feed = _Feed(device)
    return [feed(images[i * batch:(i + 1) * batch], 1.0, False) for i in range(n)]


def _style_intro(cfg, noise_mode="batch"):
    from soft_intro_vae_torch.train.style import build_style_training
    from soft_intro_vae_torch.train.style_step import StyleStepConfig, build_style_steps

    model, state = build_style_training(cfg)
    lod = cfg.layer_count - 1
    scfg = StyleStepConfig(latent_size=cfg.latent_space_size, beta_rec=cfg.beta_rec,
                           beta_kl=cfg.beta_kl, beta_neg=float(cfg.beta_neg[lod]),
                           scale=cfg.scale)
    _, intro = build_style_steps(model, scfg, lod, False, noise_mode)
    return state, intro


@contextlib.contextmanager
def recording_norm_launches(mix):
    """Counts every fused-norm kernel call by (direction, shape, mode, affine, eps)."""
    from soft_intro_vae_torch.ops import adain_cuda

    fwd, bwd = adain_cuda.forward, adain_cuda.backward

    def rec_fwd(x, bias, g=None, b=None, n=None, nw=None, **kw):
        mix[("fwd", tuple(x.shape), kw["mode"], g is not None, kw["eps"])] += 1
        return fwd(x, bias, g, b, n, nw, **kw)

    def rec_bwd(dy, x, bias, g, *args, **kw):
        mix[("bwd", tuple(x.shape), kw["mode"], g is not None, kw["eps"])] += 1
        return bwd(dy, x, bias, g, *args, **kw)

    adain_cuda.forward, adain_cuda.backward = rec_fwd, rec_bwd
    try:
        yield mix
    finally:
        adain_cuda.forward, adain_cuda.backward = fwd, bwd


def phase_style_step(device, card: str, cfg):
    """ms per LOD-6 intro step after warm-up: median of three 10-step windows.
    The first warm-up step records the step's fused-norm launches by site."""
    import collections

    import torch

    state, intro = _style_intro(cfg)
    batches = _style_batches(cfg, device, 4)
    with recording_norm_launches(collections.Counter()) as mix:
        state, m = intro(state, batches[0])
    want = style_step_launches(cfg.layer_count - 1, 0, 1)
    got = tuple(sum(v for k, v in mix.items() if k[0] == d) for d in ("fwd", "bwd"))
    check(got == want, f"one intro step launched {got} fused-norm kernels, expected {want}")
    sites = sorted({k[1] for k in mix}, key=lambda s: -s[2])
    check(sites == list(SITE_SHAPES), f"the step's norm sites {sites} are not {SITE_SHAPES}")
    for i in range(1, 3):
        state, m = intro(state, batches[i % 4])
    windows = []
    for _ in range(TIMED_WINDOWS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(TIMED_STEPS):
            state, m = intro(state, batches[i % 4])
        torch.cuda.synchronize()
        windows.append((time.perf_counter() - t0) * 1e3 / TIMED_STEPS)
    check(all(math.isfinite(float(v)) for v in m.values()), "non-finite loss in the timed steps")
    ms_step = sorted(windows)[len(windows) // 2]
    batch = batches[0].shape[0]
    print(f"step style: LOD-6 intro step at ffhq256 width, batch {batch}, bf16: "
          f"{ms_step:.3f} ms/step after warm-up (median of "
          f"{'/'.join(f'{w:.3f}' for w in windows)}), {batch * 1e3 / ms_step:.2f} images/s "
          f"on {card}", flush=True)
    del state, intro, batches
    torch.cuda.empty_cache()
    return ms_step, mix


def phase_style_routes(device, cfg):
    """One f32 intro step through the kernels against one through the plain
    version: same weights, batch and latents, noise_mode "none", no TF32."""
    import torch

    from soft_intro_vae_torch.train.style_step import NZ_KEYS

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    x = _style_batches(cfg32, device, 1)[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(13)
    nz = {k: torch.randn((x.shape[0], cfg.latent_space_size), generator=gen, device=device)
          for k in NZ_KEYS}
    losses = {}
    with no_tf32():
        for impl in ("cuda", "plain"):
            state, intro = _style_intro(dataclasses.replace(cfg32, norm_impl=impl), "none")
            _, m = intro(state, x, 1.0, nz)
            losses[impl] = (float(m["loss_e"]), float(m["loss_d"]))
            del state, intro
            torch.cuda.empty_cache()
    for name, k, p, rtol in zip(("loss_e", "loss_d"), losses["cuda"], losses["plain"],
                                (STYLE_RTOL_LOSS_E, STYLE_RTOL_LOSS_D)):
        check(math.isfinite(k) and abs(k - p) <= rtol * abs(p),
              f"style {name}: kernel route {k!r} vs plain route {p!r} (rtol {rtol:g})")
    print(f"routes style: one f32 LOD-6 intro step, noise off, TF32 off: kernel vs plain "
          f"loss_e {losses['cuda'][0]!r}/{losses['plain'][0]!r} (rtol {STYLE_RTOL_LOSS_E:g}), "
          f"loss_d {losses['cuda'][1]!r}/{losses['plain'][1]!r} (rtol {STYLE_RTOL_LOSS_D:g})",
          flush=True)


def phase_style_transition(device, results_dir: str):
    """LODs 0 -> 1 with a blended epoch: EPOCHS_PER_LOD 2, TRAIN_EPOCHS 3."""
    import torch

    from soft_intro_vae_torch.train.style import train_style_soft_intro_vae

    cfg = style_config(device, results_dir, STYLE_TRANSITION_OPTS)
    t0 = time.perf_counter()
    state, summary = train_style_soft_intro_vae(cfg)
    torch.cuda.synchronize()
    last = summary["last_metrics"]
    # epoch 2 is the first half of LOD 1's cycle: every one of its steps blends
    epoch2 = cfg.synthetic_n // cfg.lod_2_batch_tables["1GPU"][1]
    check(summary["lods_seen"] == [0, 1], f"LODs seen: {summary['lods_seen']}")
    check(summary["blended_steps"] == epoch2 >= 1,
          f"transition: {summary['blended_steps']} blended of {summary['steps']} steps, "
          f"expected {epoch2}")
    check(all(math.isfinite(v) for v in last.values()), f"non-finite metrics: {last}")
    check(state.opt_e.count == epoch2,
          f"optimizer not reset on the LOD switch: count {state.opt_e.count}")
    print(f"transition style: epochs 0-1 at LOD 0 (4x4), epoch 2 at LOD 1 (8x8) "
          f"blended in {summary['blended_steps']} steps, optimizer reset on the switch; "
          f"{time.perf_counter() - t0:.2f} s; loss_e {last['loss_e']:.6g}", flush=True)


# the image slice: the CIFAR-10 recipe (bench.py's ImageSpec, z 128, batch 32,
# beta_rec/beta_kl/beta_neg 1/1/256, f32) on a uint8 dataset made from a seed
IMAGE_N = 2080         # images: 65 steps of batch 32 an epoch, 8 chunks of 8 and one of 1
IMAGE_SCAN = 8         # bench.py's scan_steps: steps a K-step call (a CUDA graph)
# u8norm cases (B, H, W, C): the CIFAR-10 and celeb256 batches, mnist's single
# channel, odd sizes and a single pixel
U8_SHAPES = ((32, 32, 32, 3), (32, 256, 256, 3), (5, 28, 28, 1), (3, 7, 5, 1), (1, 1, 1, 1))
# kernel route against plain route, one f32 intro step, TF32 off and cuDNN
# deterministic: the normalized batches are bit-equal, so the losses agree
# to the rounding of the convolutions' sums
IMAGE_RTOL_LOSS = 1e-5


def u8_cases(gen, device):
    """(name, uint8 NHWC input) pairs: U8_SHAPES, then slices whose first byte
    lies off a 16-byte boundary: the second batch of an odd-sized K-batch
    (105 bytes a batch) and CIFAR batches 1 and 4 bytes into a buffer (the
    output's vectors then land off and on a 16-byte boundary)."""
    import torch

    def draw(shape):
        return torch.randint(0, 256, shape, generator=gen, device=device, dtype=torch.uint8)

    cases = [(str(shape), draw(shape)) for shape in U8_SHAPES]
    cases.append(("slice 1 of (2, 3, 7, 5, 1)", draw((2, 3, 7, 5, 1))[1]))
    n = math.prod(U8_SHAPES[0])
    for off in (1, 4):
        cases.append((f"{U8_SHAPES[0]} at byte {off}", draw((n + 16,))[off:off + n]
                      .view(U8_SHAPES[0])))
    return cases


def phase_u8norm(device, peaks):
    """u8norm bit-equal to its plain version and to numpy for every byte value
    and at every u8_cases input, in the plain version's channels-last layout,
    two launches bit-equal; device times against the bound and against the
    library chain ``x.float().div(255)`` (same NHWC order), which must not be
    faster, and the byte values that chain gets wrong on the card."""
    import numpy as np
    import torch

    from soft_intro_vae_torch.ops import u8norm, u8norm_cuda
    from tools.torch_norm_sites import device_ms

    host = np.arange(256, dtype=np.uint8).astype(np.float32) / np.float32(255)
    every = torch.arange(256, dtype=torch.uint8, device=device).reshape(1, 16, 16, 1)
    got = u8norm_cuda.u8_to_unit_nchw_cuda(every)
    plain = u8norm.u8_to_unit_nchw_plain(every)
    naive = every.float().div(255)
    torch.cuda.synchronize()
    bits = got.cpu().numpy().ravel().view(np.uint32)
    check(np.array_equal(bits, host.view(np.uint32)), "u8norm differs from numpy on the 256 bytes")
    check(torch.equal(got.view(torch.int32), plain.view(torch.int32)),
          "u8norm differs from its plain version on the 256 bytes")
    naive_wrong = int((naive.cpu().numpy().ravel().view(np.uint32) != host.view(np.uint32)).sum())

    gen = torch.Generator(device=device)
    gen.manual_seed(5)
    batches, plans = {}, []
    for name, x in u8_cases(gen, device):
        k1, k2 = u8norm_cuda.u8_to_unit_nchw_cuda(x), u8norm_cuda.u8_to_unit_nchw_cuda(x)
        p = u8norm.u8_to_unit_nchw_plain(x)
        torch.cuda.synchronize()
        check(k1.shape == p.shape and k1.stride() == p.stride()
              and k1.is_contiguous(memory_format=torch.channels_last),
              f"u8norm layout at {name}: shape {tuple(k1.shape)}, strides {k1.stride()}, plain "
              f"{p.stride()}")
        check(torch.equal(k1.view(torch.int32), p.view(torch.int32)),
              f"u8norm differs from its plain version at {name}: "
              f"{int((k1 != p).sum())} of {p.numel()}")
        check(torch.equal(k1.view(torch.int32), k2.view(torch.int32)),
              f"u8norm: two launches differ at {name}")
        batches[name] = x
        plan = u8norm_cuda.plan(x.numel(), x.data_ptr() % u8norm_cuda.VEC)
        plans.append(f"{name}: head {plan.head}, {plan.vectors} vectors, tail {plan.tail}, "
                     f"grid {plan.grid}")

    times = {}
    for shape in U8_SHAPES[:2]:
        x = batches[str(shape)]
        t = {"plain": [device_ms(lambda: u8norm.u8_to_unit_nchw_plain(x))]}
        t["kernel"] = [device_ms(lambda: u8norm_cuda.u8_to_unit_nchw_cuda(x)) for _ in range(2)]
        t["plain"].append(device_ms(lambda: u8norm.u8_to_unit_nchw_plain(x)))
        t["naive"] = [device_ms(lambda: x.float().div(255)) for _ in range(2)]
        t["calls"] = [cuda_ms(lambda: u8norm_cuda.u8_to_unit_nchw_cuda(x))]
        times[shape] = {k: sum(v) / len(v) for k, v in t.items()} | {
            "runs": t, "bound": 5 * x.numel() / peaks[1] * 1e3}
        check(times[shape]["kernel"] <= times[shape]["naive"],
              f"u8norm at {shape}: kernel {t['kernel']} ms, slower than the chain "
              f"x.float().div(255), {t['naive']} ms")
    recipe = times[U8_SHAPES[0]]
    record = {
        "name": "u8norm",
        "route": "cuda",
        "source": "soft_intro_vae_torch/ops/csrc/u8norm.cu",
        "replaces": "soft_intro_vae_tpu/ops/u8norm.py:47 (not Pallas: XLA elementwise ops)",
        "launches": None,  # filled from the image train phase
        "max_abs_err": 0.0,
        "ms": recipe["kernel"],
        "plain_ms": recipe["plain"],
        "bound_ms": recipe["bound"],
        "bound_by": "bytes",
        "library_ms": None,  # no one PyTorch call computes the correctly rounded i/255
        "shape": list(U8_SHAPES[0]),
        "naive_ms": recipe["naive"],
        "naive_mismatches_of_256": naive_wrong,
        "celeb256": {k: v for k, v in times[U8_SHAPES[1]].items() if k != "runs"},
    }
    parts = []
    for shape, t in times.items():
        r = t["runs"]
        parts.append(f"{shape}: kernel {r['kernel'][0]:.4f}/{r['kernel'][1]:.4f} ms (calls back "
                     f"to back, host time included: {t['calls']:.4f} ms), plain "
                     f"{r['plain'][0]:.4f}/{r['plain'][1]:.4f} ms, chain x.float().div(255) "
                     f"{r['naive'][0]:.4f}/{r['naive'][1]:.4f} ms, bound {t['bound']:.5f} ms "
                     f"(kernel at {t['bound'] / t['kernel']:.1%} of it)")
    print(f"kernels: u8norm bit-equal to numpy x.astype(f32)/f32(255) and to its plain version "
          f"for all 256 byte values, and to the plain version (channels-last strides, the "
          f"plain version's) and launch to launch at {len(batches)} inputs; launch plans: "
          + "; ".join(plans) + f"; the chain x.float().div(255) gets {naive_wrong} of 256 byte "
          f"values wrong on this card; device times (calls queued behind a sleep kernel; bound: "
          f"5 bytes an element at {peaks[1] / 1e12:.2f} TB/s): " + "; ".join(parts), flush=True)
    return record


def image_config(device, results_dir: str, **kw):
    from soft_intro_vae_torch.train.image import ImageConfig

    base = dict(dataset="cifar10", z_dim=128, batch_size=32, beta_rec=1.0, beta_kl=1.0,
                beta_neg=256.0, gamma_r=1e-8, num_epochs=2, num_vae=1, save_interval=1000,
                seed=0, device=str(device), verbose=False, result_dir=results_dir)
    return ImageConfig(**{**base, **kw})


def image_dataset(n: int = IMAGE_N, seed: int = 3):
    import numpy as np

    from soft_intro_vae_torch.data.images import DATASETS, ArrayDataset

    spec = DATASETS["cifar10"]
    check((spec.image_size, spec.channels, spec.cdim) == (32, (64, 128, 256), 3),
          f"cifar10 width changed: {spec}")
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (n, spec.image_size, spec.image_size, spec.cdim), dtype=np.uint8)
    return spec, ArrayDataset(images, seed=seed)


def layout_transposes(prof, steps: int) -> dict:
    """cuDNN's layout conversions in a torch.profiler trace, per step: kernel
    name -> (launches, ms). Fails unless the trace holds the replays' own
    kernels, one u8norm launch a step, so an empty trace cannot read as no
    transposes."""
    import torch

    from tools.torch_profile_image import TRANSPOSES, device_us

    out, u8 = {}, 0
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA or evt.is_user_annotation:
            continue
        if "u8norm_kernel" in evt.key:
            u8 += evt.count
        if any(t in evt.key.lower() for t in TRANSPOSES):
            launches, ms = out.get(evt.key, (0.0, 0.0))
            out[evt.key] = (launches + evt.count / steps, ms + device_us(evt) / 1e3 / steps)
    check(u8 == steps, f"the profiled replays show {u8} u8norm launches for {steps} steps: the "
          f"trace did not catch the graphs' kernels")
    return out


def image_ms_step(cfg, spec, ds, device, scan: int):
    """ms per intro step after warm-up at ``scan_steps`` = ``scan``, resident
    uint8 batches (a chunk of ``scan`` at scan > 1): (median, windows,
    layout transposes a step), each window 16 steps; at scan > 1 the
    transposes come from a torch.profiler pass over two calls of graph
    replays (``layout_transposes``), else None."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from soft_intro_vae_torch.train.image import build_image_training

    state, _, intro = build_image_training(dataclasses.replace(cfg, scan_steps=scan), spec)
    b = cfg.batch_size
    inputs = [torch.from_numpy(ds.images[i * b * scan:(i + 1) * b * scan]).to(device)
              for i in range(2)]
    if scan > 1:
        inputs = [x.view(scan, b, *x.shape[1:]) for x in inputs]
    calls = 16 // scan
    for i in range(max(2, 3 // scan)):  # the first K-step call warms up and captures
        state, m = intro(state, inputs[i % 2])
    windows = []
    for _ in range(TIMED_WINDOWS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(calls):
            state, m = intro(state, inputs[i % 2])
        torch.cuda.synchronize()
        windows.append((time.perf_counter() - t0) * 1e3 / (calls * scan))
    check(all(bool(torch.isfinite(v).all()) for v in m.values()),
          f"non-finite loss in the timed steps at scan_steps {scan}")
    transposes = None
    if scan > 1:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(2):
                state, m = intro(state, inputs[i % 2])
            torch.cuda.synchronize()
        transposes = layout_transposes(prof, 2 * scan)
    del state, intro
    torch.cuda.empty_cache()
    return sorted(windows)[len(windows) // 2], windows, transposes


def check_channels_last(model) -> None:
    """Every 4-D parameter of the image nets in the channels-last layout."""
    import torch

    for k, p in model.named_parameters():
        if p.dim() == 4:
            check(p.is_contiguous(memory_format=torch.channels_last) and p.stride(1) == 1,
                  f"image net parameter {k} is not channels-last: strides {p.stride()}")


def phase_train_image(device, card: str, results_dir: str):
    """The image trainer's main path at the CIFAR-10 recipe's width and
    bench.py's scan_steps 8: one vanilla and one intro epoch on a uint8
    dataset, each 8 graph calls of 8 steps and a trailing call of one,
    launches counted per capture plus per replay; ms per step at scan_steps
    8 and 1."""
    import torch

    from soft_intro_vae_torch.train.image import train_soft_intro_vae

    cfg = image_config(device, results_dir, scan_steps=IMAGE_SCAN)
    spec, ds = image_dataset()
    steps = 2 * (IMAGE_N // cfg.batch_size)
    reset_counts()
    t0 = time.perf_counter()
    state, summary = train_soft_intro_vae(cfg, ds, spec)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts, captured = read_counts(), captured_counts()
    check(summary["steps"] == state.step == steps, f"image run took {summary['steps']} steps")
    check(counts["u8norm"] == steps, f"u8norm launched {counts['u8norm']} times in {steps} steps "
          f"(eager warm-up steps plus graph replays)")
    check(captured == {"u8norm": 2}, f"the vanilla and intro graphs recorded {captured}, "
          f"expected one u8norm launch each")
    check(counts["chamfer_nearest"] == counts["bias_act_norm_fwd"] == counts["bias_act_norm_bwd"]
          == 0, f"the image path launched another kernel: {counts}")
    last = summary["last_metrics"]
    check(all(math.isfinite(v) for v in last.values()), f"non-finite image metrics: {last}")
    saved = os.path.join(results_dir, "saves", "cifar10_soft_intro_betas_1.0_256.0_1.0_"
                         f"model_epoch_1_iter_{steps}.ckpt")
    check(os.path.exists(saved), f"no final checkpoint at {saved}")
    check_channels_last(state.model)
    del state

    ms = {scan: image_ms_step(cfg, spec, ds, device, scan) for scan in (IMAGE_SCAN, 1)}
    timing = "; ".join(
        f"scan_steps {scan}: {m:.3f} ms/step (median of {'/'.join(f'{w:.3f}' for w in ws)}), "
        f"{cfg.batch_size * 1e3 / m:.1f} images/s" for scan, (m, ws, _) in ms.items())
    transposes = ms[IMAGE_SCAN][2]
    check(not transposes, f"a graphed image step launches cuDNN layout transposes: {transposes}")
    layout = (f"{sum(c for c, _ in transposes.values()):.1f} launches, "
              f"{sum(t for _, t in transposes.values()):.3f} ms" + "".join(
                  f"; {c:.1f} x {name[:60]} ({t:.3f} ms)" for name, (c, t) in transposes.items()))
    print(f"train image: CIFAR-10 recipe width (channels 64/128/256, z 128, batch 32, f32), "
          f"scan_steps {IMAGE_SCAN}, on {IMAGE_N} uint8 images: {steps // 2} vanilla + "
          f"{steps // 2} intro steps in {run_s:.2f} s (first call, warm-up and capture "
          f"included); loss_e {last['loss_e']:.6g}, loss_d {last['loss_d']:.6g}, rec "
          f"{last['rec']:.6g}; u8norm launches {counts['u8norm']} (one a step: eager warm-up "
          f"steps and graph replays; {captured['u8norm']} recorded in 2 captures); every 4-D "
          f"parameter channels-last; intro step after warm-up, 16-step windows: {timing}; cuDNN "
          f"layout transposes per graphed step (nchwToNhwc/nhwcToNchw kernels, torch.profiler "
          f"over 2 calls of {IMAGE_SCAN}): {layout}; on {card}", flush=True)
    return cfg, counts, ms


def phase_image_routes(device, cfg):
    """One f32 intro step through the u8norm kernel against one through its
    plain version: same weights, draws and uint8 batch; TF32 off, cuDNN
    deterministic."""
    import torch

    from soft_intro_vae_torch.ops import u8norm
    from soft_intro_vae_torch.train.image import build_image_training
    from soft_intro_vae_torch.train.step import INTRO_NOISES

    spec, ds = image_dataset(cfg.batch_size, seed=7)
    x = torch.from_numpy(ds.images).to(device)
    check(torch.equal(u8norm.u8_to_unit_nchw(x, "cuda").view(torch.int32),
                      u8norm.u8_to_unit_nchw(x, "plain").view(torch.int32)),
          "the kernel and the plain normalize differ on the routes batch")
    gen = torch.Generator(device=device)
    gen.manual_seed(17)
    noises = {k: torch.randn((cfg.batch_size, cfg.z_dim), generator=gen, device=device)
              for k in INTRO_NOISES}
    losses = {}
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with no_tf32():
            for impl in ("cuda", "plain"):
                state, _, intro = build_image_training(dataclasses.replace(cfg, u8norm_impl=impl),
                                                       spec)
                _, m = intro(state, x, noises)
                losses[impl] = (float(m["loss_e"]), float(m["loss_d"]))
    finally:
        torch.backends.cudnn.deterministic = saved
    for name, k, p in zip(("loss_e", "loss_d"), losses["cuda"], losses["plain"]):
        check(math.isfinite(k) and abs(k - p) <= IMAGE_RTOL_LOSS * abs(p),
              f"image {name}: kernel route {k!r} vs plain route {p!r}")
    print(f"routes image: one f32 intro step, TF32 off, cuDNN deterministic: the normalized "
          f"batches bit-equal; kernel vs plain loss_e {losses['cuda'][0]!r}/"
          f"{losses['plain'][0]!r}, loss_d {losses['cuda'][1]!r}/{losses['plain'][1]!r} "
          f"(rtol {IMAGE_RTOL_LOSS:g})", flush=True)


def phase_bootstrap_image(device, results_dir: str):
    """One bootstrap epoch at the CIFAR-10 recipe's width (gamma_r 1.0, the
    target synced every epoch): the target's tensors equal the decoder's
    after the sync and share no storage with them."""
    import torch

    from soft_intro_vae_torch.train.image import train_soft_intro_vae

    cfg = image_config(device, results_dir, bootstrap=True, gamma_r=1.0, copy_to_target_freq=1,
                       num_epochs=1, num_vae=0, scan_steps=IMAGE_SCAN)
    spec, ds = image_dataset()
    reset_counts()
    t0 = time.perf_counter()
    state, summary = train_soft_intro_vae(cfg, ds, spec)
    torch.cuda.synchronize()
    steps = IMAGE_N // cfg.batch_size
    check(summary["steps"] == steps and read_counts()["u8norm"] == steps
          and captured_counts() == {"u8norm": 1},
          f"bootstrap: {summary['steps']} steps, {read_counts()['u8norm']} u8norm launches, "
          f"{captured_counts()} recorded in captures")
    online, target = state.decoder.state_dict(), state.target_decoder.state_dict()
    check(set(online) == set(target), "target and online decoders differ in names")
    for k, v in online.items():
        check(torch.equal(v, target[k]), f"bootstrap sync: target {k} differs from the decoder's")
        check(v.untyped_storage().data_ptr() != target[k].untyped_storage().data_ptr(),
              f"bootstrap sync: target {k} shares storage with the decoder's")
    check(all(not p.requires_grad for p in state.target_decoder.parameters()),
          "a target decoder parameter takes a gradient")
    check_channels_last(state.model)
    last = summary["last_metrics"]
    check(all(math.isfinite(v) for v in last.values()), f"non-finite bootstrap metrics: {last}")
    print(f"bootstrap image: {steps} bootstrap intro steps (gamma_r 1.0, scan_steps "
          f"{IMAGE_SCAN}: graph replays) in "
          f"{time.perf_counter() - t0:.2f} s; loss_e {last['loss_e']:.6g}, loss_d "
          f"{last['loss_d']:.6g}; after the sync the target's {len(target)} tensors equal the "
          f"decoder's and share no storage with them", flush=True)


# the toy slice: the toy CLI's recipe (tools/torch_profile_toy.py RECIPE:
# 8Gaussians, z 2, 3 hidden layers of 256, batch 512, betas 0.2/0.3/0.9), its
# depth cut from 30000 iterations to 300 and its vanilla warm-up from 2000 to
# 100, so that 200 introspective iterations run
TOY_ITERS = 300
TOY_NUM_VAE = 100
TOY_PROFILE_ITERS = 50  # iterations timed, then as many traced, each phase
# one intro step on the card against the same step on the CPU, same weights,
# batch and injected noises, TF32 off: loss_e comes before any update and
# loss_d after the E phase's Adam update (float32 bias corrections on the card,
# float64 on the CPU), each within this relative distance
TOY_RTOL = 1e-5


def phase_toy(device, card: str, results_dir: str):
    """``train_soft_intro_vae_toy`` at the toy recipe's width on the card,
    the final metrics (gnELBO over the 1024x1024 grid, sample KL and JSD)
    included; ms per iteration, device operations and idle share, vanilla
    and intro; one intro step against the CPU's."""
    import numpy as np
    import torch

    from soft_intro_vae_torch.data.toy import ToyDataset
    from soft_intro_vae_torch.train.step import INTRO_NOISES
    from soft_intro_vae_torch.train.toy import ToyConfig, build_toy, train_soft_intro_vae_toy
    from tools.torch_profile_toy import RECIPE, toy_phases

    cfg = ToyConfig(n_iter=TOY_ITERS, num_vae=TOY_NUM_VAE, test_iter=100, seed=0,
                    device=str(device), verbose=False, result_dir=results_dir, **RECIPE)
    reset_counts()
    t0 = time.perf_counter()
    state, res = train_soft_intro_vae_toy(cfg)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = read_counts()
    check(state.step == TOY_ITERS and state.device.type == "cuda", f"toy run: step {state.step}")
    check(all(math.isfinite(v) for v in res.values()), f"non-finite toy metrics: {res}")
    check(not any(counts.values()), f"the toy path launched a hand-written kernel: {counts}")
    with open(os.path.join(results_dir, "results_log_soft_intro_vae.txt")) as f:
        line = f.read()
    check(line.startswith("8Gaussians_beta_kl_0.3_beta_neg_0.9_beta_rec_0.2_gnelbo_"),
          f"toy results line: {line!r}")

    prof = toy_phases(device, TOY_PROFILE_ITERS)

    # one intro step on the card and on the CPU from the same weights
    card_state, _, card_intro = build_toy(cfg)
    cpu_state, _, cpu_intro = build_toy(dataclasses.replace(cfg, device="cpu"))
    cpu_state.model.load_state_dict({k: v.cpu() for k, v in card_state.model.state_dict().items()})
    rs = np.random.RandomState(21)
    x = ToyDataset(seed=21).next_batch(cfg.batch_size)
    noises = {k: rs.randn(cfg.batch_size, cfg.z_dim).astype(np.float32) for k in INTRO_NOISES}
    with no_tf32():
        _, m_card = card_intro(card_state, torch.from_numpy(x).to(device),
                               {k: torch.from_numpy(v).to(device) for k, v in noises.items()})
        losses = {k: float(m_card[k]) for k in ("loss_e", "loss_d")}
    _, m_cpu = cpu_intro(cpu_state, torch.from_numpy(x),
                         {k: torch.from_numpy(v) for k, v in noises.items()})
    rel = {k: abs(v - float(m_cpu[k])) / abs(float(m_cpu[k])) for k, v in losses.items()}
    check(all(r <= TOY_RTOL for r in rel.values()),
          f"toy intro step, card {losses} vs CPU {({k: float(m_cpu[k]) for k in losses})}")
    parts = [f"{phase} {r['ms_iter']:.3f} ms/iteration ({r['device_ops_iter']:.0f} device "
             f"operations, device busy {r['busy_ms_iter']:.3f} ms, idle {r['idle_share_untraced']:.1%} "
             f"of the untraced iteration)" for phase, r in prof.items()]
    print(f"toy: train_soft_intro_vae_toy at the CLI recipe's width (8Gaussians, z 2, 3x256, "
          f"batch 512, betas 0.2/0.3/0.9), {TOY_NUM_VAE} vanilla + {TOY_ITERS - TOY_NUM_VAE} "
          f"intro iterations and the final metrics in {run_s:.2f} s: gn_elbo {res['gn_elbo']:.6g}, "
          f"sample KL {res['sample_kl']:.6g}, JSD {res['jsd']:.6g}; hand-written kernel launches "
          f"{counts} (none on this path); after warm-up, {TOY_PROFILE_ITERS} iterations each: "
          + "; ".join(parts) + f"; one intro step card vs CPU, TF32 off: loss_e rel "
          f"{rel['loss_e']:.2e}, loss_d rel {rel['loss_d']:.2e} (tolerance {TOY_RTOL:g}); "
          f"on {card}", flush=True)


FID_IMAGES = 2048      # the with_fid CIFAR run: its images, and the real and fake images a FID
# pool3 on the card against the port's CPU forward from the same weights, TF32
# off: within this share of the largest feature
FID_RTOL_POOL3 = 1e-4
# Newton-Schulz (30 iterations, float32) against scipy's sqrtm: the traces of
# sqrt(S1 S2) for two 2048x2048 covariances of 8192 samples each
FID_RTOL_TRACE = 1e-3


@contextlib.contextmanager
def recording_fid_calls(calls: list):
    """Each call of the image trainer's FID hook appended to ``calls``: its
    value, seconds, the CUDA graphs captured before and after it, and whether
    its Fréchet distance fell back from Newton-Schulz to scipy's sqrtm."""
    import torch

    from soft_intro_vae_torch.metrics import fid
    from soft_intro_vae_torch.train import graph

    make, distance = fid.make_training_fid, fid.frechet_distance
    methods = []

    def recording_distance(*args, **kwargs):
        methods.append(kwargs.get("method", "newton"))
        return distance(*args, **kwargs)

    def recording_make(cfg, weights_path=None):
        fid_fn = make(cfg, weights_path)

        def timed(state, *args, **kwargs):
            torch.cuda.synchronize()
            before, t0 = graph.captures, time.perf_counter()
            methods.clear()
            value = fid_fn(state, *args, **kwargs)
            torch.cuda.synchronize()
            calls.append({"fid": value, "s": time.perf_counter() - t0,
                          "captures": (before, graph.captures), "scipy": "scipy" in methods})
            return value

        return timed

    fid.make_training_fid, fid.frechet_distance = recording_make, recording_distance
    try:
        yield
    finally:
        fid.make_training_fid, fid.frechet_distance = make, distance


def phase_fid(device, card: str, results_dir: str):
    """The FID network on the card against its CPU forward; its speed with
    TF32 off (the policy) and on; Newton-Schulz against scipy at 2048x2048; a
    with_fid CIFAR run at scan_steps 8 (u8norm launches, graph captures
    around the FID between graph calls, the losses equal to a run without
    FID); one style FID at LOD 2."""
    import numpy as np
    import torch
    from scipy import linalg

    from soft_intro_vae_torch.metrics import fid
    from soft_intro_vae_torch.train import graph
    from soft_intro_vae_torch.train.image import train_soft_intro_vae
    from soft_intro_vae_torch.train.style import (
        build_style_training, make_style_dataset, make_style_fid)

    t0 = time.perf_counter()
    feats = fid.load_fid_network(device=device)  # the fallback: init and calibration on the card
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    cpu_net = fid.InceptionV3FID().eval()
    cpu_net.load_state_dict({k: v.cpu() for k, v in feats.net.state_dict().items()})
    x = torch.rand((4, 3, 32, 32), generator=torch.Generator().manual_seed(31))
    with torch.no_grad():
        want = cpu_net(x)
    scale = float(want.abs().max())
    err = float((feats(x.to(device)).cpu() - want).abs().max()) / scale
    check(err <= FID_RTOL_POOL3, f"pool3 on the card vs the CPU: {err:.3g} of the largest feature")
    with_tf32 = fid.InceptionFeatures(feats.net, feats.device, allow_tf32=True)
    err_tf32 = float((with_tf32(x.to(device)).cpu() - want).abs().max()) / scale
    xb = torch.rand((64, 3, 32, 32), generator=torch.Generator().manual_seed(32)).to(device)
    ms = {"off": [], "on": []}
    for mode in ("off", "on", "on", "off"):
        fn = feats if mode == "off" else with_tf32
        ms[mode].append(cuda_ms(lambda: fn(xb), iters=5, warmup=2))
    ms = {k: sum(v) / len(v) for k, v in ms.items()}

    gen = torch.Generator(device=device).manual_seed(33)

    def covariance(spread):
        a = spread * torch.randn((8192, 2048), generator=gen, device=device, dtype=torch.float64)
        a = a - a.mean(dim=0)
        return a.T @ a / (a.shape[0] - 1)

    prod = covariance(1.0) @ covariance(1.3)
    ns_ms = cuda_ms(lambda: fid.sqrtm_newton_schulz(prod), iters=3, warmup=1)
    tr_ns = float(torch.trace(fid.sqrtm_newton_schulz(prod)))
    t0 = time.perf_counter()
    tr_scipy = float(np.trace(linalg.sqrtm(prod.cpu().numpy()).real))
    scipy_s = time.perf_counter() - t0
    tr_rel = abs(tr_ns - tr_scipy) / abs(tr_scipy)
    check(tr_rel <= FID_RTOL_TRACE, f"Newton-Schulz trace {tr_ns!r} vs scipy {tr_scipy!r}")
    print(f"fid network: pt_inception topology, random init calibrated on the card in "
          f"{load_s:.2f} s (no weights file); pool3 of 4 images (32x32 -> 299x299) on the card vs "
          f"the port's CPU forward: {err:.3g} of the largest feature with TF32 off (tolerance "
          f"{FID_RTOL_POOL3:g}), {err_tf32:.3g} with TF32 on; batch 64: {ms['off']:.3f} ms "
          f"({64e3 / ms['off']:.1f} images/s) TF32 off, {ms['on']:.3f} ms ({64e3 / ms['on']:.1f} "
          f"images/s) TF32 on; Newton-Schulz at 2048x2048 {ns_ms:.3f} ms, trace rel {tr_rel:.3g} "
          f"of scipy's sqrtm ({scipy_s:.2f} s on the host); on {card}", flush=True)

    spec, ds = image_dataset(FID_IMAGES, seed=11)
    cfg = image_config(device, results_dir, scan_steps=IMAGE_SCAN, num_epochs=2, num_vae=0,
                       with_fid=True, fid_num_images=FID_IMAGES)
    steps = 2 * FID_IMAGES // cfg.batch_size
    real_batches = -(-FID_IMAGES // 64)
    calls = []
    reset_counts()
    graph_captures = graph.captures
    t0 = time.perf_counter()
    with recording_fid_calls(calls):
        state, summary = train_soft_intro_vae(cfg, ds, spec)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts, captured = read_counts(), captured_counts()
    expect_name = "fid_selfconsistent" if fid.fid_weights_path() is None else "fid"
    check(summary["fid_metric"] == expect_name, f"FID logged as {summary['fid_metric']}")
    check(len(calls) == 2 and all(math.isfinite(c["fid"]) for c in calls),
          f"FID calls: {calls}")
    before, after = calls[1]["captures"]
    check(before == after == graph_captures + 1,
          f"graphs captured {graph_captures} -> {calls[0]['captures']} -> {calls[1]['captures']}: "
          "the FID between graph calls must leave the one capture alone")
    check(summary["steps"] == steps and counts["u8norm"] == steps + real_batches,
          f"u8norm launched {counts['u8norm']} times: {steps} steps + {real_batches} real FID "
          "batches expected")
    check(captured == {"u8norm": 1}, f"captures recorded {captured}")
    check(math.isfinite(summary["best_fid"]), f"best FID {summary['best_fid']}")
    images = [2 * FID_IMAGES, FID_IMAGES]  # the first call also takes the real statistics
    how = {True: "by scipy: Newton-Schulz not finite", False: "by Newton-Schulz"}
    fid_line = "; ".join(f"epoch {e} {expect_name} {c['fid']:.6g} in {c['s']:.3f} s "
                         f"({n} images through Inception, {n / c['s']:.1f} a second; the "
                         f"distance {how[c['scipy']]}), graphs captured {c['captures'][0]} -> "
                         f"{c['captures'][1]}" for e, c, n in zip((0, 1), calls, images))
    del state

    # the same run with FID on and off under exact routes: equal losses and weights
    small = dict(scan_steps=IMAGE_SCAN, num_epochs=2, num_vae=0, fid_num_images=256)
    spec_s = image_dataset(8)[0]
    runs = []
    with exact_routes():
        for with_fid in (True, False):
            cfg_s = image_config(device, os.path.join(results_dir, f"exact_{with_fid}"),
                                 with_fid=with_fid, **small)
            runs.append(train_soft_intro_vae(cfg_s, image_dataset(512, seed=12)[1], spec_s))
    (sa, ma), (sb, mb) = runs
    check(ma["last_metrics"] == mb["last_metrics"],
          f"with FID {ma['last_metrics']} vs without {mb['last_metrics']}")
    sd_b = sb.model.state_dict()
    differ = [k for k, v in sa.model.state_dict().items() if not torch.equal(v, sd_b[k])]
    check(not differ, f"with FID vs without: {len(differ)} tensors differ ({differ[:4]})")
    del runs, sa, sb
    print(f"fid image: with_fid CIFAR-10 run at the recipe's width, scan_steps {IMAGE_SCAN}, "
          f"{FID_IMAGES} uint8 images, 2 intro epochs ({steps} steps) in {run_s:.2f} s: "
          f"{fid_line}; best {summary['best_fid']:.6g}; u8norm launches {counts['u8norm']} "
          f"({steps} steps + {real_batches} real batches of 64); with FID on and off (512 images, "
          f"256-image FID, TF32 off, cuDNN deterministic): losses and all "
          f"{len(sd_b)} model tensors bit-equal; on {card}", flush=True)

    scfg = style_config(device, results_dir, ["DATASET.SYNTHETIC", "true",
                                              "DATASET.SYNTHETIC_N", "64"])
    scfg = dataclasses.replace(scfg, fid_num_images=64)
    model, sstate = build_style_training(scfg)
    fid_fn = make_style_fid(model, scfg)
    t0 = time.perf_counter()
    value = fid_fn(sstate, make_style_dataset(scfg), 2)
    torch.cuda.synchronize()
    check(math.isfinite(value), f"style FID {value}")
    print(f"fid style: the EMA generator at ffhq256 width, LOD 2 (16x16): {expect_name} "
          f"{value:.6g} over 64 real and 64 generated images in {time.perf_counter() - t0:.2f} s",
          flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a GPU", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "soft_intro_vae_torch")):
        print("chip_smoke: run it from a checkout of the repository "
              "(soft_intro_vae_torch/ not found)", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    device = torch.device("cuda", 0)

    card = card_line()
    name = torch.cuda.get_device_name(0)
    peak_name, peaks = peaks_for(name)
    print(f"device: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    start = laps = None

    def lap(name: str) -> None:  # seconds since the previous phase ended
        nonlocal start, laps
        now = time.perf_counter()
        laps = [] if laps is None else laps + [f"{name} {now - start:.1f}"]
        start = now

    lap("")
    began = start
    print(phase_build(), flush=True)
    lap("build")
    chamfer = phase_kernels(device, peak_name, peaks)
    worst, times = phase_norm_kernels(device)
    print(norm_line(worst, times, peaks), flush=True)
    lap("kernels chamfer and fused norm")
    # the trainers' checkpoints (~100 MB for 3D, ~0.65 GB for style) go to
    # directories removed afterwards
    with tempfile.TemporaryDirectory(prefix="results_chip_smoke_", dir=ROOT) as results_dir:
        counts_3d = phase_train_3d(device, card, results_dir)
    lap("train 3d")
    phase_graph_3d(device)
    lap("graph 3d")
    with tempfile.TemporaryDirectory(prefix="results_chip_smoke_", dir=ROOT) as results_dir:
        cfg, counts_style = phase_style_train(device, card, results_dir)
    _, mix = phase_style_step(device, card, cfg)
    totals = phase_norm_sites(device, mix, peaks)
    phase_style_routes(device, cfg)
    with tempfile.TemporaryDirectory(prefix="results_chip_smoke_", dir=ROOT) as results_dir:
        phase_style_transition(device, results_dir)
    lap("style")
    u8 = phase_u8norm(device, peaks)
    with tempfile.TemporaryDirectory(prefix="results_chip_smoke_", dir=ROOT) as results_dir:
        cfg_image, counts_image, _ = phase_train_image(device, card, results_dir)
    phase_image_routes(device, dataclasses.replace(cfg_image, scan_steps=1))
    lap("image")
    phase_graph_image(device)
    with tempfile.TemporaryDirectory(prefix="results_chip_smoke_", dir=ROOT) as results_dir:
        phase_bootstrap_image(device, results_dir)
    lap("graph image and bootstrap")
    with tempfile.TemporaryDirectory(prefix="results_chip_smoke_", dir=ROOT) as results_dir:
        phase_toy(device, card, results_dir)
    lap("toy")
    with tempfile.TemporaryDirectory(prefix="results_chip_smoke_", dir=ROOT) as results_dir:
        phase_fid(device, card, results_dir)
    lap("fid")
    print(f"timing (s): {', '.join(laps)}; build to last phase "
          f"{time.perf_counter() - began:.1f}", flush=True)
    chamfer["launches"] = counts_3d["chamfer_nearest"]
    records = [chamfer] + norm_records(worst, times, peaks, totals)
    for rec in records[1:]:
        rec["launches"] = counts_style[rec["name"]]
    u8["launches"] = counts_image["u8norm"]
    records.append(u8)
    print(json.dumps({"kernels": records}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
