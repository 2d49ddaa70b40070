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
              synthetic clouds for one intro epoch plus the valid JSD, each
              step a replay of the intro graph after 3 eager warm-up steps and
              its capture, every kernel's launch count and the captures read
              around it; the step time after warm-up graphed and eager, device
              busy time and peak memory; one step through the kernel against
              the plain route;
  4b. graph 3d: the generic step's K-step form (``scan_steps`` 4, a CUDA
              graph of one step with the chamfer kernel captured) at that
              width, two calls against 8 eager steps from the same seed: every
              metric, parameter, BN buffer, Adam moment and count bit-equal;
              then the trainer's single step (``one_step``) against the eager
              step over a trainer's course (``single_script``): vanilla, the
              switch with the vanilla graphs freed, intro with the valid JSD
              between replays, intro with injected draws, bit-equal, chamfer
              launches 1 a vanilla and 6 an intro step;
  5. train style: ``train_style_soft_intro_vae`` at the full width of
              configs/ffhq256.yaml (7 blocks, 64->512 channels, latent 512,
              bf16) at LOD 6 (256x256, batch 4) on synthetic images, one
              vanilla and one intro epoch, each step a replay of the epoch's
              CUDA graph after 3 eager warm-up steps and its capture; every
              kernel's launch count on the device read around it and held to
              the count the steps imply, and the launches each capture
              recorded to one step's;
  6. step style: ms per LOD-6 eager intro step after warm-up; the first warm-up
              step records its fused-norm launches by site, and each site is
              then timed alone in bf16 and f32: per-step kernel ms against the
              per-step bound;
  7. routes style: one f32 intro step through the kernels against one
              through the plain version, from the same weights and draws;
  8. transition style: LOD 0 -> 1 through a blended epoch, 4 steps of batch
              128 an epoch, so each of the 3 (LOD, blended, phase) graphs is
              captured and replayed; the same run with eager steps, every
              tensor and the epoch means bit-equal under exact routes; peak
              device memory of both;
  8b. stream: the port's prepare_tfrecords writes 16 seeded 256x256 images as
              per-LOD shards (levels 2-8, 2 parts); the native reader (built
              with g++ from soft_intro_vae_torch/native/) and the Python
              reader both return the source images and their box cascade bit
              for bit; ``train_style_soft_intro_vae`` from the shards
              (configs/ffhq256.yaml, two-field DATASET.PATH, PART_COUNT 2,
              SIZE 16) at LOD 6, one vanilla and one intro epoch, fused-norm
              launches held to the steps'; intro ms/step fed from the shards
              and from the same images in memory; then 128 images at level 8
              only: each reader's records/s and MB/s a pass over them, and at
              LODs 0-2 one batch of 128 box-downscaled on the host, held to
              the box-downscaled images up to flips, its host ms against the
              LOD's intro step's ms and device busy time;
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
              the steps taken, every 4-D parameter channels-last; the same at
              the CLI's scan_steps 1 (a graph replay a step, sample grids
              between replays); ms per intro step after warm-up at scan_steps
              8, and at 1 graphed and eager with device busy time and peak
              memory, and cuDNN's layout
              transposes (``nchwToNhwc``/``nhwcToNchw`` kernels) per graphed
              step from a torch.profiler pass over two calls, held to 0 (the
              trace held to one u8norm launch a step);
 11. routes image: one intro step through the kernel and through the plain
              normalize, from the same weights, draws and uint8 batch;
 11b. graph image: 16 intro steps as two graph calls of 8 against 16 eager
              steps from the same seed on the same uint8 batches, bit-equal
              as in 4b; then the trainer's single step against the eager step
              over a trainer's course as in 4b, a sample grid and a NaN check
              between replays;
 12. bootstrap image: one bootstrap epoch at scan_steps 8; the target
              decoder's sync is a copy into tensors of its own; then the
              single step graphed against eager through the switch and a
              target sync between two intro replays;
 13. toy:     ``train_soft_intro_vae_toy`` at the toy CLI recipe's width
              (8Gaussians, z 2, 3 hidden layers of 256, batch 512), 100
              vanilla and 200 intro iterations, then its final metrics (the
              gnELBO over the 1024x1024 grid, sample KL and JSD); ms per
              iteration, device operations and idle share (torch.profiler),
              vanilla and intro, graphed (the trainer's route) and eager,
              with peak memory; the single step graphed against eager over a
              trainer's course with an LR fill after every step and the
              deterministic forward between replays; one intro step against
              the CPU's;
 14. fid:     the FID Inception (random init calibrated on the card) against
              its CPU forward, TF32 off, and its speed with TF32 off and on;
              Newton-Schulz against scipy's sqrtm at 2048x2048; a with_fid
              CIFAR-10 run at scan_steps 8 (u8norm launches = steps + real
              uint8 batches, no graph captured across the FID between graph
              calls, losses bit-equal to the run without FID); the style FID
              of the EMA generator at LOD 2;
 8c. figures: every array kind of cli/figures.py (samples, reconstruction,
              interpolation, style mixing, the multi-resolution canvas, a
              paged page, two-image interpolation; the folder kinds on
              arrays, the card's machine has no PIL) from the style phase's
              final checkpoint at full width: shapes and finite values, and
              f32 samples through the kernels against the plain norm route;
 8d. remat style: TRAIN.REMAT at that width, LOD 6: one vanilla and one
              intro epoch of ``train_style_soft_intro_vae`` (graphed),
              fused-norm launches held to ``style_step_launches(...,
              remat=True)``; one f32 intro step with remat against one without
              (batch noise, style mixing, deterministic routes) bit-equal,
              generator state included;
 8e. encoders: one f32 LOD-6 intro step with MODEL.ENCODER
              EncoderWithStatistics and EncoderWithFC, kernel route against
              plain route;
 8f. graph style: the trainer's route (train/graph.py ``one_step``) against
              the eager step at that width, LOD 6, batch 4, bf16, TF32 off
              and deterministic routes: 8 intro steps from one seed (3 eager
              warm-up steps, a capture, 5 replays) stable, blended (8 blends
              from the LOD driver) and with TRAIN.REMAT; every metric,
              parameter, EMA tensor, dlatent_avg, LREQAdam moment and count
              and the generator's state bit-equal; fused-norm launches
              recorded in the capture (one step's) and on the device (8
              steps'); then, stable, remat off and on, ms/step graphed and
              eager (median of three 10-step windows), device busy time from
              a trace and peak device memory;
 12b. remat image: the image step with ``remat`` at scan_steps 8, graph
              calls against eager remat steps and against graphed steps
              without remat, all bit-equal under deterministic routes; u8norm
              launches one a step; the single step with remat graphed against
              eager over a trainer's course; ms/step and peak device memory,
              remat off and on;
 12c. async save: an image run at scan_steps 8 with an async save each
              epoch: each reloaded file equals the state at its save,
              though the graph replayed after it;
 15. dp:      data parallelism (soft_intro_vae_torch/parallel), run last:
              (a) NCCL at world 1 in this process: ``train_soft_intro_vae`` at
              the CIFAR-10 recipe and scan_steps 8 with the collectives
              (gradient, BatchNorm and metrics reduces) captured in the
              graphs, their counts on the device; graphed against eager
              distributed steps, bit-equal; the route's losses against the
              non-distributed route's (cuDNN BN) over one step; ms/step of
              both routes and NCCL's kernels a step; the LOD-6 style intro
              step graphed on that route, its collectives (a gradient reduce
              a phase, dlatent_avg's style mean a generate, the metrics)
              recorded in the capture, 5 steps bit-equal to eager ones; (b)
              two ranks on the card
              over gloo (eager), spawned by parallel/launch.py, against one
              rank: the image, 3D and style probes (parallel/verify.py) at
              their recipes' widths, the ranks bit-equal. Each destroys its
              process group.
Launch counts are launches on the device: a wrapper's calls, less those
recorded into a CUDA graph's capture, plus those its replays made
(train/graph.py).
The second-to-last lines are the kernels' JSON record and the card's name and
power limit; the last line is ``{"ok": true, "device": {...}}``.

Imports nothing of JAX or of the JAX package. Writes only inside the
checkout: soft_intro_vae_torch/_build/ (the kernels and the native TFRecord
reader) and temporary results_chip_smoke_*/ directories (the trainers'
output and the shards, removed at the end).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import weakref

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

    from soft_intro_vae_torch.parallel import collectives

    chamfer_cuda.launches = u8norm_cuda.launches = 0
    adain_cuda.launches_fwd = adain_cuda.launches_bwd = 0
    collectives.calls.clear()
    graph.captured.clear()
    graph.replayed.clear()


def read_counts() -> dict:
    """Launches on the device since reset_counts, by kernel: each wrapper's
    count (every call, eager or recorded into a CUDA graph's capture) less
    the launches recorded into captures, plus those the replays made
    (train/graph.py); with no graph, the wrappers' counts."""
    from soft_intro_vae_torch.train import graph

    return {k: v - graph.captured[k] + graph.replayed[k] for k, v in graph.wrapper_counts().items()}


def captured_graphs() -> int:
    """CUDA graphs captured in this process so far (train/graph.py)."""
    from soft_intro_vae_torch.train import graph

    return graph.captures


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
    graphs = captured_graphs()
    t0 = time.perf_counter()
    _, summary = train_soft_intro_vae_3d(cfg)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    counts, captured, graphs = read_counts(), captured_counts(), captured_graphs() - graphs
    launches = counts["chamfer_nearest"]
    last = summary["last_metrics"]
    check(launches == 6 * steps, f"chamfer_nearest launched {launches} times in {steps} intro "
          f"steps, expected {6 * steps} (one a chamfer call)")
    check(graphs == 1 and captured == {"chamfer_nearest": 6},
          f"the 3D trainer captured {graphs} graphs recording {captured}; expected one intro "
          f"graph recording 6 chamfer launches")
    check(counts["bias_act_norm_fwd"] == counts["bias_act_norm_bwd"] == counts["u8norm"] == 0,
          f"the 3D path launched a fused-norm or u8norm kernel: {counts}")
    check(math.isfinite(last["loss_e"]) and math.isfinite(last["loss_d"]),
          f"non-finite losses: {last}")
    check(summary["best_jsd"] is not None and math.isfinite(summary["best_jsd"]),
          f"non-finite JSD: {summary['best_jsd']}")
    check(os.path.exists(os.path.join(cfg.results_dir, "weights", "model_epoch_1_iter_0.ckpt")),
          "no checkpoint written")

    # step time after warm-up, from the same build_3d_training the trainer calls:
    # its route (a graph a step) and the eager step
    pts = torch.from_numpy(SyntheticClouds(cfg.batch_size * 4, cfg.n_points, seed=5).points).to(device)
    batches = [pts[i * cfg.batch_size:(i + 1) * cfg.batch_size] for i in range(4)]
    times = route_times(lambda: build_3d_training(cfg), "intro", batches)
    ms_step = times["graphed"]["ms"]

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
          f"launches {launches} on the device (3 eager warm-up steps, then replays of the "
          f"intro graph, {captured['chamfer_nearest']} recorded in its capture); intro step "
          f"after warm-up: {routes_line(times)}; graphed "
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
def exact_routes(deterministic_algorithms: bool = False, fill_uninitialized: bool = True):
    """TF32 off and cuDNN deterministic, for comparing two routes bit for bit;
    with ``deterministic_algorithms`` also PyTorch's deterministic kernels
    where it has them (the chamfer backward's ``scatter_add_`` sums with
    atomics otherwise, in no fixed order, so two eager 3D steps differ in the
    last bits), warning only for cuBLAS, which is deterministic on one stream
    and one workspace size. That mode also fills every new tensor
    (``torch.utils.deterministic.fill_uninitialized_memory``), a kernel an
    allocation; ``fill_uninitialized=False`` leaves them unfilled, for steps
    that are timed as well."""
    import warnings

    import torch

    saved = (torch.backends.cudnn.deterministic, torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             torch.utils.deterministic.fill_uninitialized_memory)
    torch.backends.cudnn.deterministic = True
    if deterministic_algorithms:
        torch.use_deterministic_algorithms(True, warn_only=True)
    torch.utils.deterministic.fill_uninitialized_memory = fill_uninitialized
    try:
        with no_tf32(), warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=".*CuBLAS.*")
            yield
    finally:
        torch.backends.cudnn.deterministic = saved[0]
        torch.use_deterministic_algorithms(saved[1], warn_only=saved[2])
        torch.utils.deterministic.fill_uninitialized_memory = saved[3]


def graph_against_eager(build, xs, scan: int):
    """The same seed's state built twice: ``xs`` (S, B, ...) through K-step
    calls of ``scan`` (a CUDA graph) on one, S eager steps on the other.
    Returns (graph run, eager run, device launches and captures of the graph
    run)."""
    import torch

    sg, graphed = build(scan)
    se, eager = build(1)
    eager = eager.eager  # the step that scan_steps=1 replays as a graph
    reset_counts()
    mg = [graphed(sg, xs[i:i + scan])[1] for i in range(0, xs.shape[0], scan)]
    torch.cuda.synchronize()
    counts, captured = read_counts(), captured_counts()
    me = [eager(se, x)[1] for x in xs]
    torch.cuda.synchronize()
    return ((sg, {k: torch.cat([m[k] for m in mg]) for k in mg[0]}),
            (se, {k: torch.stack([m[k] for m in me]) for k in me[0]}), counts, captured)


SINGLE_STEPS = 5  # a phase's steps in a single-step script: 3 eager warm-up steps, a capture, a replay


def single_graph_against_eager(build, script):
    """The trainers' route at scan_steps 1 (train/graph.py ``one_step``, one
    CUDA graph a key) against the eager step. ``build()`` makes a fresh state
    of one seed and its (vanilla, intro) wrappers; ``script`` is a list of
    (phase, batch, injected draws or None, hook or None) steps, run through
    the wrappers on one state and through their ``.eager`` steps on another,
    ``hook(state)`` after its step on both. At the first intro step each run
    drops its vanilla step, as the trainers do. Returns (graph run, eager run,
    the graph run's device launches, launches recorded in its captures, graphs
    it captured, whether the vanilla graphs were freed at the switch); each
    run is (state, metrics by step) as ``compare_runs`` takes it."""
    import torch

    runs = []
    for route in ("graphed", "eager"):
        state, vanilla, intro = build()
        if route == "eager":
            vanilla, intro = vanilla.eager, intro.eager
        reset_counts()
        before, step, freed, ms = captured_graphs(), None, False, {}
        for i, (phase, x, draws, hook) in enumerate(script):
            if phase == "intro" and vanilla is not None:
                ref = weakref.ref(vanilla.graphed) if route == "graphed" else None
                vanilla = step = None
                gc.collect()
                freed = ref is not None and ref() is None
            step = vanilla if phase == "vanilla" else intro
            state, m = step(state, x, *((draws,) if draws else ()))
            ms.update({f"step {i} {k}": v for k, v in m.items()})
            if hook is not None:
                hook(state)
        torch.cuda.synchronize()
        if route == "graphed":
            counts, captured = read_counts(), captured_counts()
            graphs, gone = captured_graphs() - before, freed
        runs.append((state, ms))
        del state, vanilla, intro, step
    return runs[0], runs[1], counts, captured, graphs, gone


def single_script(xs, intro_draws, hook_at=None, hook=None):
    """A trainer's course at scan_steps 1: SINGLE_STEPS vanilla steps, the
    switch, SINGLE_STEPS + 2 intro steps (``hook`` after intro step
    ``hook_at``, a replay), then SINGLE_STEPS intro steps with the injected
    draws ``intro_draws(i)``; the batches of ``xs`` in turn."""
    steps = [("vanilla", None, None)] * SINGLE_STEPS
    steps += [("intro", None, hook if i == hook_at else None) for i in range(SINGLE_STEPS + 2)]
    script = [(phase, xs[i % len(xs)], draws, h) for i, (phase, draws, h) in enumerate(steps)]
    n = len(script)
    if intro_draws is not None:
        script += [("intro", xs[(n + i) % len(xs)], intro_draws(i), None)
                   for i in range(SINGLE_STEPS)]
    return script


def seeded_draws(device, b: int, z: int, seed: int, names) -> dict:
    """Injected draws by name, (b, z) normals from a seeded generator on the card."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return {k: torch.randn((b, z), generator=gen, device=device) for k in names}


def route_times(build, phase: str, batches) -> dict:
    """``phase``'s step on fresh states of one seed, graphed (the trainers'
    route) and eager: by route, ms/step (median of TIMED_WINDOWS windows of
    TIMED_STEPS steps after SINGLE_STEPS warm-up steps, a graph's capture
    among them), the windows, (device busy ms, device operations) a step from
    a device trace of TIMED_STEPS steps, and peak device memory over the
    route in GiB with what was allocated as it began."""
    import itertools

    import torch

    out = {}
    for route in ("graphed", "eager"):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated() / 2**30
        state, vanilla, intro = build()
        step = vanilla if phase == "vanilla" else intro
        step = step if route == "graphed" else step.eager
        turn = itertools.count()

        def call():
            return step(state, batches[next(turn) % len(batches)])[1]

        for _ in range(SINGLE_STEPS):
            call()
        windows = []
        for _ in range(TIMED_WINDOWS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(TIMED_STEPS):
                m = call()
            torch.cuda.synchronize()
            windows.append((time.perf_counter() - t0) * 1e3 / TIMED_STEPS)
        check(all(math.isfinite(float(v)) for v in m.values()),
              f"non-finite loss in the timed {route} {phase} steps")
        busy = device_busy(call, TIMED_STEPS)
        out[route] = dict(ms=sorted(windows)[len(windows) // 2], windows=windows, busy=busy[0],
                          ops=busy[1], peak=torch.cuda.max_memory_allocated() / 2**30, base=base)
        del state, vanilla, intro, step, m
    torch.cuda.empty_cache()
    return out


def routes_line(times: dict) -> str:
    return "; ".join(
        f"{route} {t['ms']:.3f} ms/step (median of {'/'.join(f'{w:.3f}' for w in t['windows'])}), "
        f"device busy {t['busy']:.3f} ms/step (idle {1 - t['busy'] / t['ms']:.1%}), "
        f"{t['ops']:.0f} device operations a step, peak {t['peak']:.3f} GiB ({t['base']:.3f} "
        f"allocated before)" for route, t in times.items())


def single_line(compared: int, counts: dict, captured: dict, graphs: int,
                kinds: str = "vanilla, intro, intro with injected draws") -> str:
    kernels = {k: v for k, v in counts.items() if v}
    return (f"all {compared} tensors bit-equal, {graphs} graphs captured ({kinds}), vanilla "
            f"graphs freed at the switch; "
            f"hand-written kernel launches on the device {kernels or 'none'}, recorded in the "
            f"captures {captured or 'none'}")


def phase_graph_3d(device):
    """The generic step's K-step form with the 3D StepConfig at full width
    (2048 points, batch 32, z 128): two calls of K = 4 (a CUDA graph, the
    chamfer kernel captured) against 8 eager steps from the same seed; then
    the 3D trainer's route at scan_steps 1 (one graph a key) against the
    eager step over ``single_script``: vanilla, the switch, intro with the
    valid JSD between replays, intro with injected draws."""
    import torch

    from soft_intro_vae_torch.data.shapenet import SyntheticClouds
    from soft_intro_vae_torch.train.step import INTRO_NOISES
    from soft_intro_vae_torch.train.threed import ThreeDConfig, build_3d_training, calc_jsd_valid

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
    k_step = (f"all {compared} tensors bit-equal (metrics (8,), parameters and BN buffers, Adam "
              f"moments and counts, generator); chamfer_nearest launches "
              f"{counts['chamfer_nearest']} on the device, {captured['chamfer_nearest']} recorded "
              f"in the capture (a cooperative launch captured)")

    valid = SyntheticClouds(8, cfg.n_points, seed=7).points
    jsd = []
    script = single_script(
        xs, lambda i: seeded_draws(device, b, cfg.z_size, 40 + i, INTRO_NOISES), hook_at=4,
        hook=lambda state: jsd.append(calc_jsd_valid(state, valid, cfg)))
    n_vanilla = sum(phase == "vanilla" for phase, *_ in script)
    with exact_routes(deterministic_algorithms=True):
        graph_run, eager_run, counts, captured, graphs, freed = single_graph_against_eager(
            lambda: build_3d_training(cfg), script)
    differ, worst, compared = compare_runs(graph_run, eager_run)
    want = n_vanilla + 6 * (len(script) - n_vanilla)  # one chamfer call a vanilla step
    check(counts["chamfer_nearest"] == want and captured == {"chamfer_nearest": 13}
          and graphs == 3 and freed,
          f"3D single-step run: device launches {counts} (expected {want} chamfer), captured "
          f"{captured} (expected 1 + 6 + 6), {graphs} graphs, vanilla graphs freed {freed}")
    check(not differ, f"3D single-step graph against eager steps: {len(differ)} of {compared} "
          f"tensors differ (first {differ[:6]}), max |diff| {worst!r}")
    check(len(jsd) == 2 and jsd[0] == jsd[1] and math.isfinite(jsd[0]),
          f"the valid JSD between replays: {jsd}")
    print(f"graph 3d: 2048 points, batch 32, z 128, TF32 off, cuDNN deterministic, PyTorch's "
          f"deterministic scatter_add_. K-step form, two calls of K = 4 (3 eager warm-up steps, a "
          f"capture, 5 replays) against 8 eager steps: {k_step}. The trainer's single step "
          f"(one_step), {len(script)} steps ({n_vanilla} vanilla, then intro with the valid JSD "
          f"{jsd[0]:.6f} between replays, then intro with injected draws) against the eager "
          f"steps: " + single_line(compared, counts, captured, graphs)
          + f"; {time.perf_counter() - t0:.2f} s", flush=True)


def phase_graph_image(device):
    """16 intro steps at the CIFAR-10 recipe's width as two K-step calls of 8
    (a CUDA graph, the u8norm kernel captured) against 16 eager steps from the
    same seed on the same uint8 batches; then the image trainer's route at
    scan_steps 1 (one graph a key) against the eager step over
    ``single_script``: vanilla, the switch, intro with a sample grid and a
    NaN check between replays, intro with injected draws."""
    import torch

    from soft_intro_vae_torch.train.image import _save_sample_grid, build_image_training
    from soft_intro_vae_torch.train.step import INTRO_NOISES

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
    k_step = (f"all {compared} tensors bit-equal (metrics ({n},), parameters and BN buffers, "
              f"Adam moments and counts, generator); u8norm launches {counts['u8norm']} on the "
              f"device, {captured['u8norm']} recorded in the capture")

    def between(state):  # the trainer's work between steps: a sample grid, a NaN check
        _save_sample_grid(state, xs[0], fig_cfg, 0)
        m = state.model.state_dict()["encoder.fc.weight"]
        check(bool(torch.isfinite(m).all()), "non-finite encoder weights")

    with tempfile.TemporaryDirectory(prefix="results_chip_smoke_", dir=ROOT) as fig_dir:
        fig_cfg = dataclasses.replace(cfg, result_dir=fig_dir)
        script = single_script(
            xs, lambda i: seeded_draws(device, 32, cfg.z_dim, 50 + i, INTRO_NOISES), hook_at=4,
            hook=between)
        with exact_routes():
            graph_run, eager_run, counts, captured, graphs, freed = single_graph_against_eager(
                lambda: build_image_training(cfg, spec), script)
    differ, worst, compared = compare_runs(graph_run, eager_run)
    check(counts["u8norm"] == len(script) and captured == {"u8norm": 3} and graphs == 3
          and freed, f"image single-step run: device launches {counts}, captured {captured}, "
          f"{graphs} graphs, vanilla graphs freed {freed}")
    check(not differ, f"image single-step graph against eager steps: {len(differ)} of {compared} "
          f"tensors differ (first {differ[:6]}), max |diff| {worst!r}")
    print(f"graph image: CIFAR-10 recipe width, TF32 off, cuDNN deterministic. K-step form, two "
          f"calls of K = {IMAGE_SCAN} (3 eager warm-up steps, a capture, 13 replays) against {n} "
          f"eager intro steps: {k_step}. The trainer's single step (one_step), {len(script)} "
          f"steps ({SINGLE_STEPS} vanilla, then intro with a sample grid and a NaN check between "
          f"replays, then intro with injected draws) against the eager steps: "
          + single_line(compared, counts, captured, graphs)
          + f"; {time.perf_counter() - t0:.2f} s", flush=True)


# the style slice: configs/ffhq256.yaml at full width, LOD 6 (256x256)
STYLE_YAML = os.path.join(ROOT, "configs", "ffhq256.yaml")
STYLE_TRAIN_OPTS = ["DATASET.SYNTHETIC", "true", "DATASET.SYNTHETIC_N", "16",
                    "TRAIN.EPOCHS_PER_LOD", "0", "TRAIN.TRAIN_EPOCHS", "2"]
STYLE_TRANSITION_OPTS = ["DATASET.SYNTHETIC", "true", "DATASET.SYNTHETIC_N", "512",
                         "TRAIN.EPOCHS_PER_LOD", "2", "TRAIN.TRAIN_EPOCHS", "3"]
# kernel route against plain route, one f32 intro step without TF32: loss_e
# comes from forwards before any update, so it agrees to f32 sums in another
# order; loss_d follows the E phase's LREQAdam update (beta1 = 0), which turns
# rounding-level gradient differences into moves of up to 2 lr on a few weights
STYLE_RTOL_LOSS_E = 1e-4
STYLE_RTOL_LOSS_D = 1e-3
# an f32 route is held to the float64 plain route within this many times the
# plain f32 route's own distance from it, where the quantity is ill-conditioned
# (a loss after LREQAdam's sign-like first update, a decoded image): a second,
# independent f32 rounding lands about as far (0.11-1.34x, measured on one H100)
ROUTE_F64_FACTOR = 2.0


def style_config(device, results_dir: str, opts):
    from soft_intro_vae_torch.train.style import StyleConfig

    cfg = StyleConfig.from_yaml(STYLE_YAML, opts)
    cfg = dataclasses.replace(cfg, output_dir=results_dir, device=str(device), verbose=False,
                              resume=False, seed=0)
    width = (cfg.layer_count, cfg.start_channel_count, cfg.max_channel_count,
             cfg.latent_space_size, cfg.mapping_layers, cfg.compute_dtype)
    check(width == (7, 64, 512, 512, 8, "bfloat16"), f"ffhq256 width changed: {width}")
    return cfg


def style_step_launches(lod: int, vanilla: int, intro: int, remat: bool = False):
    """(forward, backward) fused-norm launches of these steps at this LOD.

    Each encoder and decoder pass runs 2 norm sites per block, lod + 1 blocks.
    Vanilla: 1 encode + 1 generate, both with a gradient. Intro: E phase
    generate(fake) [no gradient], encode(x), generate(rec), encode(rec),
    generate(rec_rec), encode(fake), generate(rec_fake); D phase generate(fake),
    generate(rec), encode(rec), encode(fake), generate(rec_rec),
    generate(rec_fake): 13 forwards, 12 of them with a gradient. With
    ``remat`` (TRAIN.REMAT) the backward recomputes every forward that has a
    gradient, every norm site of it: 2 + 2 forwards a vanilla step, 13 + 12
    an intro step; the backward launches are the same."""
    sites = 2 * (lod + 1)
    grads = 2 * vanilla + 12 * intro
    return sites * (2 * vanilla + 13 * intro + (grads if remat else 0)), sites * grads


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
    counts, captured = read_counts(), captured_counts()
    want_fwd, want_bwd = style_step_launches(cfg.layer_count - 1, steps, steps)
    check(counts["bias_act_norm_fwd"] == want_fwd and counts["bias_act_norm_bwd"] == want_bwd,
          f"fused-norm launches {counts}, expected forward {want_fwd}, backward {want_bwd}")
    check(counts["chamfer_nearest"] == counts["u8norm"] == 0,
          f"the style path launched chamfer or u8norm: {counts}")
    per_graph = [style_step_launches(cfg.layer_count - 1, v, 1 - v) for v in (1, 0)]
    check((captured.get("bias_act_norm_fwd"), captured.get("bias_act_norm_bwd"))
          == tuple(map(sum, zip(*per_graph))),
          f"the vanilla and intro graphs recorded {captured}, expected {per_graph}")
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
          f"launches on the device fwd {counts['bias_act_norm_fwd']} / bwd "
          f"{counts['bias_act_norm_bwd']} (expected {want_fwd} / {want_bwd}; each epoch 3 eager "
          f"warm-up steps, a graph capture recording {per_graph[0]} vanilla and {per_graph[1]} "
          f"intro launches, replays); peak device memory {peak_gb:.2f} GB; on {card}",
          flush=True)
    return cfg, counts


def _style_batches(cfg, device, n: int, blends=None):
    """``n`` LOD-6 batches on the card; with ``blends``, batch i blended with
    its half-resolution input by ``blends[i]``, as the trainer's transition
    feed does."""
    from soft_intro_vae_torch.train.style import MultiResImages, _Feed

    res = 2 ** (cfg.layer_count + 1)
    batch = cfg.lod_2_batch_tables["1GPU"][cfg.layer_count - 1]
    images = MultiResImages.synthetic(batch * n, res, seed=5).at_resolution(res)
    feed = _Feed(device)
    return [feed(images[i * batch:(i + 1) * batch], 1.0 if blends is None else blends[i],
                 blends is not None) for i in range(n)]


def _style_intro(cfg, noise_mode="batch", blended: bool = False):
    from soft_intro_vae_torch.train.style import build_style_training
    from soft_intro_vae_torch.train.style_step import StyleStepConfig, build_style_steps

    model, state = build_style_training(cfg)
    lod = cfg.layer_count - 1
    scfg = StyleStepConfig(latent_size=cfg.latent_space_size, beta_rec=cfg.beta_rec,
                           beta_kl=cfg.beta_kl, beta_neg=float(cfg.beta_neg[lod]),
                           scale=cfg.scale)
    _, intro = build_style_steps(model, scfg, lod, blended, noise_mode)
    return state, intro


def style_snapshot(state, metrics) -> dict:
    """Every tensor a style run leaves, cloned: each step's metrics, the nets
    and their EMA (dlatent_avg included), LREQAdam's counts and moments, the
    generator's state, and the step count."""
    def nets(n):
        return {k: v.detach().clone() for k, v in n.state_dict().items()}

    def adam(o):
        return {"count": o.count.clone(), "nu": [v.clone() for v in o.nu]}

    return {"metrics": [{k: v.detach().clone() for k, v in m.items()} for m in metrics],
            "nets": nets(state.nets), "ema": nets(state.ema), "opt_e": adam(state.opt_e),
            "opt_d": adam(state.opt_d), "generator": state.generator.get_state(),
            "step": state.step}


def style_graph_against_eager(cfg, xs, blends, blended: bool, timed: bool = False):
    """The same seed's state twice: the LOD-6 intro step on ``xs`` with
    ``blends`` through ``one_step`` (3 eager warm-up steps, a capture, the
    rest replays) and eagerly. Returns the graphed run's device launches and
    captures, how many tensors of the two runs' snapshots (taken on the host
    after the steps) were compared, the names of those that differ, and with
    ``timed`` each route's (median ms/step of TIMED_WINDOWS windows of
    TIMED_STEPS steps on the first batch, the windows, peak device memory in
    GiB over the run, the memory allocated as it began, (device busy ms,
    device operations) a step from a trace of STYLE_TRACED_STEPS steps), by
    route."""
    import torch

    from soft_intro_vae_torch.train.graph import one_step
    from soft_intro_vae_torch.utils.checkpoint import to_host

    snaps, times = [], {}
    for graphed in (True, False):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(xs[0].device)
        base = torch.cuda.memory_allocated(xs[0].device) / 2**30
        state, intro = _style_intro(cfg, blended=blended)
        step = one_step(intro) if graphed else intro
        reset_counts()
        ms = [step(state, x, b)[1] for x, b in zip(xs, blends)]
        torch.cuda.synchronize()
        if graphed:
            counts, captured = read_counts(), captured_counts()
            check(len(step.graphed.graphs) == 1, f"{len(step.graphed.graphs)} graphs captured")
        snaps.append(to_host(style_snapshot(state, ms)))
        if timed:
            windows = []
            for _ in range(TIMED_WINDOWS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(TIMED_STEPS):
                    m = step(state, xs[0], blends[0])[1]  # holds no second name for the state
                torch.cuda.synchronize()
                windows.append((time.perf_counter() - t0) * 1e3 / TIMED_STEPS)
            check(all(math.isfinite(float(v)) for v in m.values()),
                  "non-finite loss in timed style steps")
            peak = torch.cuda.max_memory_allocated(xs[0].device) / 2**30
            busy = device_busy(lambda: step(state, xs[0], blends[0]), STYLE_TRACED_STEPS)
            times["graphed" if graphed else "eager"] = (
                sorted(windows)[len(windows) // 2], windows, peak, base, busy)
        del state, intro, step, ms
        torch.cuda.empty_cache()
    differ = []
    compared = _tensors_equal(snaps[0], snaps[1], "style", differ)
    return counts, captured, compared, differ, times


def device_busy(fn, calls: int):
    """(device busy ms, device operations) a call of ``fn``, from a
    torch.profiler trace of the device alone over ``calls`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tools.torch_profile_toy import device_us

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    busy, ops = 0.0, 0
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA and not evt.is_user_annotation:
            busy += device_us(evt) / 1e3
            ops += evt.count
    check(busy > 0, "the trace holds no device time")
    return busy / calls, ops / calls


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


def as_float64(state):
    """``state`` in float64 in place: nets, EMA and LREQAdam's moments (reset,
    so call it on a fresh state), every layer's compute type float64. The
    plain norm computes in its input's type, so a float64 state is the plain
    route's reference for the float32 routes."""
    import torch

    for nets in (state.nets, state.ema):
        nets.double()
        for m in nets.modules():
            if isinstance(getattr(m, "dtype", None), torch.dtype):
                m.dtype = torch.float64
    state.reset_optimizers()
    return state


def style_route_losses(device, cfg32, what: str = "style", f64: bool = False) -> dict:
    """(loss_e, loss_d) of one f32 intro step of ``cfg32`` through the kernels
    ("cuda") and through the plain version ("plain"): same weights, batch and
    latents, noise_mode "none", no TF32. loss_e, from forwards before any
    update, is held kernel against plain at STYLE_RTOL_LOSS_E. loss_d follows
    the E phase's LREQAdam update: without ``f64`` it is held kernel against
    plain at STYLE_RTOL_LOSS_D; with ``f64`` the step also runs through the
    plain version in float64 ("f64", ``as_float64``), and the kernel route's
    loss_d is held to it within STYLE_RTOL_LOSS_D or within
    ``ROUTE_F64_FACTOR`` times the plain f32 route's own distance from it,
    whichever is larger."""
    import torch

    from soft_intro_vae_torch.train.style_step import NZ_KEYS

    x = _style_batches(cfg32, device, 1)[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(13)
    nz = {k: torch.randn((x.shape[0], cfg32.latent_space_size), generator=gen, device=device)
          for k in NZ_KEYS}
    losses = {}
    legs = (("cuda", "cuda"), ("plain", "plain")) + ((("f64", "plain"),) if f64 else ())
    with no_tf32():
        for name, impl in legs:
            state, intro = _style_intro(dataclasses.replace(cfg32, norm_impl=impl), "none")
            if name == "f64":
                as_float64(state)
            _, m = intro(state, x, 1.0, nz)
            losses[name] = (float(m["loss_e"]), float(m["loss_d"]))
            del state, intro
            torch.cuda.empty_cache()
    (ke, kd), (pe, pd) = losses["cuda"], losses["plain"]
    check(math.isfinite(ke) and abs(ke - pe) <= STYLE_RTOL_LOSS_E * abs(pe),
          f"{what} loss_e: kernel route {ke!r} vs plain route {pe!r} (rtol {STYLE_RTOL_LOSS_E:g})")
    if not f64:
        check(math.isfinite(kd) and abs(kd - pd) <= STYLE_RTOL_LOSS_D * abs(pd),
              f"{what} loss_d: kernel route {kd!r} vs plain route {pd!r} "
              f"(rtol {STYLE_RTOL_LOSS_D:g})")
        return losses
    rd = losses["f64"][1]
    bound = max(STYLE_RTOL_LOSS_D * abs(rd), ROUTE_F64_FACTOR * abs(pd - rd))
    check(math.isfinite(kd) and abs(kd - rd) <= bound,
          f"{what} loss_d: kernel route {kd!r}, plain f32 route {pd!r}, float64 plain route "
          f"{rd!r}: the kernel route is {abs(kd - rd)!r} from float64, bound {bound!r}")
    return losses


def phase_style_routes(device, cfg):
    """One f32 intro step through the kernels against one through the plain
    version: same weights, batch and latents, noise_mode "none", no TF32."""
    losses = style_route_losses(device, dataclasses.replace(cfg, compute_dtype="float32"))
    print(f"routes style: one f32 LOD-6 intro step, noise off, TF32 off: kernel vs plain "
          f"loss_e {losses['cuda'][0]!r}/{losses['plain'][0]!r} (rtol {STYLE_RTOL_LOSS_E:g}), "
          f"loss_d {losses['cuda'][1]!r}/{losses['plain'][1]!r} (rtol {STYLE_RTOL_LOSS_D:g})",
          flush=True)


def phase_style_transition(device, results_dir: str):
    """LODs 0 -> 1 with a blended epoch: EPOCHS_PER_LOD 2, TRAIN_EPOCHS 3, 4
    steps of batch 128 an epoch, so each of the three (LOD, blended, phase)
    graphs is captured after its 3 warm-up steps and replayed; then the same
    run with the steps eager: every tensor bit-equal under exact routes, and
    the peak device memory of both."""
    import torch

    from soft_intro_vae_torch.train import style
    from soft_intro_vae_torch.utils.checkpoint import to_host

    cfg = style_config(device, results_dir, STYLE_TRANSITION_OPTS)
    runs, peaks, seconds = [], [], []
    one_step = style.one_step
    for graphed in (True, False):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        before = captured_graphs()
        t0 = time.perf_counter()
        style.one_step = one_step if graphed else (lambda step: step)
        try:
            with exact_routes(deterministic_algorithms=True):
                state, summary = style.train_style_soft_intro_vae(
                    dataclasses.replace(cfg, output_dir=os.path.join(results_dir, str(graphed))))
            torch.cuda.synchronize()
        finally:
            style.one_step = one_step
        seconds.append(time.perf_counter() - t0)
        peaks.append(torch.cuda.max_memory_allocated(device) / 2**30)
        check((captured_graphs() - before == 3) == graphed,
              f"transition run (graphed {graphed}): {captured_graphs() - before} graphs captured")
        runs.append((to_host(style_snapshot(state, [])), summary, int(state.opt_e.count)))
        del state
        torch.cuda.empty_cache()
    _, summary, count = runs[0]
    differ = []
    compared = _tensors_equal(runs[0][0], runs[1][0], "transition", differ)
    check(not differ and runs[0][1]["last_metrics"] == runs[1][1]["last_metrics"],
          f"transition graphed against eager: {len(differ)} of {compared} tensors differ "
          f"(first {differ[:6]}); metrics {runs[0][1]['last_metrics']} vs "
          f"{runs[1][1]['last_metrics']}")
    last = summary["last_metrics"]
    # epoch 2 is the first half of LOD 1's cycle: every one of its steps blends
    epoch2 = cfg.synthetic_n // cfg.lod_2_batch_tables["1GPU"][1]
    check(summary["lods_seen"] == [0, 1], f"LODs seen: {summary['lods_seen']}")
    check(summary["blended_steps"] == epoch2 >= 1,
          f"transition: {summary['blended_steps']} blended of {summary['steps']} steps, "
          f"expected {epoch2}")
    check(all(math.isfinite(v) for v in last.values()), f"non-finite metrics: {last}")
    check(count == epoch2, f"optimizer not reset on the LOD switch: count {count}")
    print(f"transition style: epochs 0-1 at LOD 0 (4x4), epoch 2 at LOD 1 (8x8) "
          f"blended in {summary['blended_steps']} steps of batch 128, optimizer reset on the "
          f"switch, 3 graphs captured; loss_e {last['loss_e']:.6g}; graphed against eager steps "
          f"(TF32 off, deterministic): all {compared} tensors and the epoch means bit-equal; "
          f"peak device memory graphed {peaks[0]:.3f} GiB, eager {peaks[1]:.3f} GiB; "
          f"{seconds[0]:.2f} s graphed, {seconds[1]:.2f} s eager", flush=True)


# the stream phase: per-LOD TFRecord shards written by the port's
# prepare_tfrecords, read back by both readers, and the style trainer fed from them
STREAM_N = 16          # 256x256 images at levels 2-8: 4 steps of batch 4 an epoch at LOD 6
STREAM_PARTS = 2
STREAM_HOST_N = 128    # images at level 8 only: one batch of 128 at LODs 0-2, box-downscaled
STREAM_HOST_LODS = (0, 1, 2)  # the 1GPU table's batch-128 LODs
STREAM_READ_PASSES = {"native": 5, "python": 1}  # timed passes over the 128 level-8 records
STREAM_PATTERN = "ffhq-r%02d.tfrecords.%03d"


def _box_cascade(images, level: int, round_each: bool = True):
    """Each level's images from the source bytes: 2x2 box means in float32,
    rounded to uint8 at every level (the writer) or once at the end (the
    streaming reader's downscale of max-level records)."""
    import numpy as np

    def u8(x):
        return np.clip(np.rint(x), 0, 255).astype(np.uint8)

    out = {level: images}
    cur = images.astype(np.float32)
    while level > 2:
        b, h, w, c = cur.shape
        cur = cur.reshape(b, h // 2, 2, w // 2, 2, c).mean(axis=(2, 4))
        if round_each:
            cur = u8(cur).astype(np.float32)
        level -= 1
        out[level] = u8(cur)
    return out


def _reader_rates(paths, impl: str, passes: int):
    """(records/s, MB/s) of ``TFRecordFile.examples`` over ``paths``, one pair a pass."""
    from soft_intro_vae_torch.data.tfrecords import TFRecordFile

    size = sum(os.path.getsize(p) for p in paths)
    rates = []
    for _ in range(passes):
        t0 = time.perf_counter()
        n = sum(1 for p in paths for _ in TFRecordFile(p, impl=impl).examples())
        dt = time.perf_counter() - t0
        rates.append((n / dt, size / dt / 1e6))
    return rates


def _spread(values, fmt: str = ".1f") -> str:
    """'lo-hi' of ``values``."""
    return f"{min(values):{fmt}}-{max(values):{fmt}}"


def _rows_match_up_to_flips(batch, images) -> bool:
    """Whether the rows of ``batch`` are ``images`` in some order, each as it
    is or mirrored left to right."""
    index = {}
    for i, img in enumerate(images):
        index[img.tobytes()] = i
        index[img[:, ::-1].tobytes()] = i
    found = sorted(index.get(row.tobytes(), -1) for row in batch)
    return found == list(range(len(images)))


def _fed_ms_step(intro, state, feed, batches, windows: int = TIMED_WINDOWS, steps: int = 5):
    """ms per intro step with each batch taken from ``batches()`` (a fresh
    iterator of host batches) and fed through ``feed``: median of windows of
    ``steps`` steps after 3 warm-up steps."""
    import torch

    def stream():
        while True:
            yield from batches()

    it = stream()
    for _ in range(3):
        state, m = intro(state, feed(next(it), 1.0, False))
    times = []
    for _ in range(windows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            state, m = intro(state, feed(next(it), 1.0, False))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / steps)
    check(all(math.isfinite(float(v)) for v in m.values()), "non-finite loss in the fed steps")
    return sorted(times)[len(times) // 2], times


def phase_stream(device, card: str, results_dir: str, resident_ms: float):
    """Shards written and read by both readers, the style trainer fed from
    them at LOD 6, and the max-level route's host time at LOD 0."""
    import numpy as np
    import torch

    from soft_intro_vae_torch.cli.prepare_tfrecords import write_multires_shards
    from soft_intro_vae_torch.data.streaming import StreamingTFRecords
    from soft_intro_vae_torch.data.tfrecords import load_uint8_images
    from soft_intro_vae_torch.train.style import (
        MultiResImages, _Feed, build_style_training, train_style_soft_intro_vae)
    from soft_intro_vae_torch.train.style_step import StyleStepConfig, build_style_steps
    from tools.torch_profile_toy import profile_iterations

    # 1. shards at levels 2-8 from seeded images
    rng = np.random.default_rng(11)
    images = rng.integers(0, 256, (STREAM_N, 256, 256, 3), dtype=np.uint8)
    shards = os.path.join(results_dir, "shards")
    t0 = time.perf_counter()
    paths = write_multires_shards(images, shards, "ffhq", 8, min_level=2, parts=STREAM_PARTS)
    write_s = time.perf_counter() - t0
    check(len(paths) == 7 * STREAM_PARTS, f"{len(paths)} shard files")

    # 2. both readers, bit-equal to the source images and their box cascade
    want = _box_cascade(images, 8)
    for level in range(2, 9):
        for part in range(STREAM_PARTS):
            path = os.path.join(shards, STREAM_PATTERN % (level, part))
            for impl in ("native", "python"):
                got = load_uint8_images([path], impl=impl)
                check(np.array_equal(got, want[level][part::STREAM_PARTS]),
                      f"{impl} reader: {os.path.basename(path)} differs from the source images")
    # the reader rates over the max-level route's 128 level-8 records (step 4)
    host_dir = os.path.join(results_dir, "top")
    top_images = rng.integers(0, 256, (STREAM_HOST_N, 256, 256, 3), dtype=np.uint8)
    top = write_multires_shards(top_images, host_dir, "ffhq", 8, min_level=8, parts=STREAM_PARTS)
    rates = {impl: _reader_rates(top, impl, passes) for impl, passes in STREAM_READ_PASSES.items()}

    # 3. the trainer from the shards: ffhq256 width, LOD 6, one vanilla and one intro epoch
    pattern = os.path.join(shards, STREAM_PATTERN)
    run_dir = os.path.join(results_dir, "run")
    cfg = style_config(device, run_dir, [
        "DATASET.PATH", pattern, "DATASET.PART_COUNT", str(STREAM_PARTS),
        "DATASET.SIZE", str(STREAM_N), "TRAIN.EPOCHS_PER_LOD", "0", "TRAIN.TRAIN_EPOCHS", "2"])
    batch = cfg.lod_2_batch_tables["1GPU"][cfg.layer_count - 1]
    steps = STREAM_N // batch
    reset_counts()
    t0 = time.perf_counter()
    state, summary = train_style_soft_intro_vae(cfg)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = read_counts()
    want_fwd, want_bwd = style_step_launches(cfg.layer_count - 1, steps, steps)
    check(counts["bias_act_norm_fwd"] == want_fwd and counts["bias_act_norm_bwd"] == want_bwd,
          f"streamed style run: fused-norm launches {counts}, expected {want_fwd} / {want_bwd}")
    check(summary["steps"] == 2 * steps == state.step, f"streamed style run: {summary['steps']} steps")
    last = summary["last_metrics"]
    check(all(math.isfinite(v) for v in last.values()), f"non-finite streamed metrics: {last}")
    final = os.path.join(run_dir, "training_artifacts",
                         f"{cfg.name}_model_epoch_1_iter_{2 * steps}_final.ckpt")
    check(os.path.exists(final), f"no final checkpoint at {final}")
    del state

    # intro steps fed from the shards against the same images held in memory
    lod = cfg.layer_count - 1
    model, state = build_style_training(cfg)
    scfg = StyleStepConfig(latent_size=cfg.latent_space_size, beta_rec=cfg.beta_rec,
                           beta_kl=cfg.beta_kl, beta_neg=float(cfg.beta_neg[lod]),
                           scale=cfg.scale)
    _, intro = build_style_steps(model, scfg, lod, False)
    feed = _Feed(device)
    streamed = StreamingTFRecords(pattern, STREAM_PARTS, STREAM_N, 8, seed=0, storage="uint8")
    in_memory = MultiResImages(images, seed=0, storage="uint8")
    res = model.layer_to_resolution[lod]
    ms_stream, w_stream = _fed_ms_step(intro, state, feed, lambda: streamed.epoch(res, batch))
    ms_memory, w_memory = _fed_ms_step(intro, state, feed, lambda: in_memory.epoch(res, batch))
    del state, intro, model
    torch.cuda.empty_cache()

    # 4. the max-level route: level-8 shards only, LODs 0-2 at batch 128; each
    # batch holds every image once, shuffled, each as it is or mirrored
    top_stream = StreamingTFRecords(os.path.join(host_dir, STREAM_PATTERN), STREAM_PARTS,
                                    STREAM_HOST_N, 8, seed=0, storage="uint8")
    check(sorted(top_stream.filenames) == [8], f"levels {sorted(top_stream.filenames)}")
    small = _box_cascade(top_images, 8, round_each=False)
    model, state = build_style_training(cfg)
    holder = {"state": state}
    host = {}
    for lod in STREAM_HOST_LODS:
        side = 4 * 2 ** lod
        host_times = []
        for epoch in range(3):
            t0 = time.perf_counter()
            got = list(top_stream.epoch(side, STREAM_HOST_N, epoch_index=epoch))
            host_times.append((time.perf_counter() - t0) * 1e3)
            check(len(got) == 1 and got[0].shape == (STREAM_HOST_N, side, side, 3),
                  f"max-level route at LOD {lod}: {[b.shape for b in got]}")
            check(_rows_match_up_to_flips(got[0], small[lod + 2]),
                  f"max-level route at LOD {lod}: the batch is not the box-downscaled images "
                  f"up to flips")
        _, intro_lod = build_style_steps(
            model, dataclasses.replace(scfg, beta_neg=float(cfg.beta_neg[lod])), lod, False)
        x = feed(got[0], 1.0, False)

        def lod_step():
            holder["state"], _ = intro_lod(holder["state"], x)

        prof = profile_iterations(lod_step, iters=3, warmup=2)
        host[lod] = (sorted(host_times)[1], host_times, prof)
        del intro_lod, x
    del holder, state, model
    torch.cuda.empty_cache()

    def route(lod):
        host_ms, times, prof = host[lod]
        bound = ("the host feed bounds the step" if host_ms > prof["ms_iter"]
                 else "the host feed stays under the step")
        return (f"LOD {lod}: host {host_ms:.3f} ms a batch "
                f"({'/'.join(f'{t:.3f}' for t in times)}) against the intro step's "
                f"{prof['ms_iter']:.3f} ms/step, device busy {prof['busy_ms_iter']:.3f} ms/step "
                f"(idle {prof['idle_share_untraced']:.1%}): {bound}")
    print(f"stream: {STREAM_N} images at levels 2-8 in {STREAM_PARTS} parts written in "
          f"{write_s:.2f} s, both readers bit-equal to the source images at every level; "
          f"reads of the {STREAM_HOST_N} level-8 records, a pass each: native "
          f"{_spread([r for r, _ in rates['native']])} records/s "
          f"{_spread([m for _, m in rates['native']])} MB/s over {len(rates['native'])} "
          f"passes, python {_spread([r for r, _ in rates['python']])} records/s "
          f"{_spread([m for _, m in rates['python']], '.2f')} MB/s over "
          f"{len(rates['python'])} passes; style from shards (ffhq256 width, LOD 6, batch "
          f"{batch}, bf16): {steps} vanilla + {steps} intro steps in {run_s:.2f} s, "
          f"bias_act_norm launches fwd {counts['bias_act_norm_fwd']} / bwd "
          f"{counts['bias_act_norm_bwd']} (expected {want_fwd} / {want_bwd}), loss_e "
          f"{last['loss_e']:.6g}; intro ms/step streamed {ms_stream:.3f} "
          f"({'/'.join(f'{w:.3f}' for w in w_stream)}), in memory {ms_memory:.3f} "
          f"({'/'.join(f'{w:.3f}' for w in w_memory)}), device-resident batches "
          f"{resident_ms:.3f} (step style); max-level route (level 8 only, batch "
          f"{STREAM_HOST_N}): {'; '.join(route(lod) for lod in STREAM_HOST_LODS)}; on {card}",
          flush=True)


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


def image_ms_step(cfg, spec, ds, device, scan: int, trace=layout_transposes):
    """ms per intro step after warm-up at ``scan_steps`` = ``scan``, resident
    uint8 batches (a chunk of ``scan`` at scan > 1): (median, windows,
    ``trace(prof, steps)``), each window 16 steps; at scan > 1 the trace is
    a torch.profiler pass over two calls of graph replays after one under
    its warm-up cycle (by default the layout transposes a step,
    ``layout_transposes``), else None."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

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
        # a call under the profiler's warm-up cycle first, so the tracer is
        # set up before the two counted calls' replays start (a trace started
        # just before them has missed one of their kernels)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            state, m = intro(state, inputs[0])
            torch.cuda.synchronize()
            prof.step()
            for i in range(2):
                state, m = intro(state, inputs[i % 2])
            torch.cuda.synchronize()
            prof.step()
        transposes = trace(prof, 2 * scan)
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
    launches counted per capture plus per replay; the same at the CLI's
    scan_steps 1, a graph replay a step, with sample grids between replays;
    ms per step at scan_steps 8, and at 1 graphed and eager."""
    import torch

    from soft_intro_vae_torch.train.image import build_image_training, train_soft_intro_vae

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

    # the CLI's default scan_steps 1: a graph replay a step, a sample grid between replays
    with tempfile.TemporaryDirectory(prefix="results_chip_smoke_", dir=ROOT) as one_dir:
        cfg1 = image_config(device, one_dir, save_figures=True, test_iter=16, nan_check_iter=8)
        reset_counts()
        graphs = captured_graphs()
        t0 = time.perf_counter()
        state, summary1 = train_soft_intro_vae(cfg1, ds, spec)
        torch.cuda.synchronize()
        run1_s = time.perf_counter() - t0
        counts1, captured1 = read_counts(), captured_counts()
        graphs = captured_graphs() - graphs
    check(summary1["steps"] == state.step == steps and counts1["u8norm"] == steps,
          f"image run at scan_steps 1: {summary1['steps']} steps, u8norm launches "
          f"{counts1['u8norm']} (expected one a step)")
    check(graphs == 2 and captured1 == {"u8norm": 2},
          f"image run at scan_steps 1: {graphs} graphs captured recording {captured1}; expected "
          f"the vanilla and the intro graph, one u8norm launch each")
    check(all(math.isfinite(v) for v in summary1["last_metrics"].values()),
          f"non-finite image metrics at scan_steps 1: {summary1['last_metrics']}")
    del state

    ms = {IMAGE_SCAN: image_ms_step(cfg, spec, ds, device, IMAGE_SCAN)}
    b = cfg.batch_size
    resident = [torch.from_numpy(ds.images[i * b:(i + 1) * b]).to(device) for i in range(2)]
    times1 = route_times(lambda: build_image_training(cfg1, spec), "intro", resident)
    timing = "; ".join(
        f"scan_steps {scan}: {m:.3f} ms/step (median of {'/'.join(f'{w:.3f}' for w in ws)}), "
        f"{cfg.batch_size * 1e3 / m:.1f} images/s" for scan, (m, ws, _) in ms.items())
    timing += f"; scan_steps 1: {routes_line(times1)}"
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
          f"parameter channels-last; at scan_steps 1 (the CLI's default) through the trainer, "
          f"figures every 16 steps: {steps} steps in {run1_s:.2f} s, u8norm launches "
          f"{counts1['u8norm']} on the device, {graphs} graphs captured recording "
          f"{captured1['u8norm']} u8norm launches; intro step after warm-up, 16-step windows "
          f"at scan_steps {IMAGE_SCAN}, {TIMED_STEPS}-step at 1: {timing}; cuDNN "
          f"layout transposes per graphed step (nchwToNhwc/nhwcToNchw kernels, torch.profiler "
          f"over 2 calls of {IMAGE_SCAN}): {layout}; on {card}", flush=True)
    return cfg, counts, times1


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
    after the sync and share no storage with them. Then the trainer's route
    at scan_steps 1 against the eager step, vanilla, the switch and intro
    steps with a target sync between two replays: the replays after it read
    the synced target."""
    import torch

    from soft_intro_vae_torch.train.image import (
        build_image_training, sync_target_decoder, train_soft_intro_vae)

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
    run_s = time.perf_counter() - t0
    del state

    # the trainer's route at scan_steps 1 against the eager step, a target
    # sync between two intro replays
    n = 8
    spec8, ds8 = image_dataset(n * 32, seed=15)
    xs = torch.from_numpy(ds8.images).to(device).view(n, 32, *ds8.images.shape[1:])
    cfg1 = dataclasses.replace(cfg, scan_steps=1)

    def build():
        built = build_image_training(cfg1, spec8)
        sync_target_decoder(built[0])  # the target starts equal to the decoder, as in the trainer
        return built

    script = single_script(xs, None, hook_at=4, hook=sync_target_decoder)
    with exact_routes():
        graph_run, eager_run, counts, captured, graphs, freed = single_graph_against_eager(
            build, script)
    differ, worst, compared = compare_runs(graph_run, eager_run)
    check(counts["u8norm"] == len(script) and captured == {"u8norm": 2} and graphs == 2 and freed,
          f"bootstrap single-step run: device launches {counts}, captured {captured}, {graphs} "
          f"graphs, vanilla graphs freed {freed}")
    check(not differ, f"bootstrap single-step graph against eager steps, a sync between "
          f"replays: {len(differ)} of {compared} tensors differ (first {differ[:6]}), max |diff| "
          f"{worst!r}")
    print(f"bootstrap image: {steps} bootstrap intro steps (gamma_r 1.0, scan_steps "
          f"{IMAGE_SCAN}: graph replays) in {run_s:.2f} s; loss_e {last['loss_e']:.6g}, loss_d "
          f"{last['loss_d']:.6g}; after the sync the target's {len(target)} tensors equal the "
          f"decoder's and share no storage with them; the trainer's single step (one_step), "
          f"{len(script)} steps ({SINGLE_STEPS} vanilla, then intro with a target sync between "
          f"two replays) against the eager steps, TF32 off, cuDNN deterministic: "
          + single_line(compared, counts, captured, graphs, "vanilla, intro"), flush=True)


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
    from soft_intro_vae_torch.train.toy import (
        ToyConfig, build_toy, det_fwd, train_soft_intro_vae_toy)
    from tools.torch_profile_toy import RECIPE, toy_phases

    cfg = ToyConfig(n_iter=TOY_ITERS, num_vae=TOY_NUM_VAE, test_iter=100, seed=0,
                    device=str(device), verbose=False, result_dir=results_dir, **RECIPE)
    reset_counts()
    graphs = captured_graphs()
    t0 = time.perf_counter()
    state, res = train_soft_intro_vae_toy(cfg)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts, graphs = read_counts(), captured_graphs() - graphs
    check(state.step == TOY_ITERS and state.device.type == "cuda", f"toy run: step {state.step}")
    check(graphs == 2, f"the toy trainer captured {graphs} graphs, expected vanilla and intro")
    check(all(math.isfinite(v) for v in res.values()), f"non-finite toy metrics: {res}")
    check(not any(counts.values()), f"the toy path launched a hand-written kernel: {counts}")
    with open(os.path.join(results_dir, "results_log_soft_intro_vae.txt")) as f:
        line = f.read()
    check(line.startswith("8Gaussians_beta_kl_0.3_beta_neg_0.9_beta_rec_0.2_gnelbo_"),
          f"toy results line: {line!r}")

    prof = toy_phases(device, TOY_PROFILE_ITERS)

    # the trainer's route against the eager step: LR fills after every step,
    # the test_iter reads (the metrics, the deterministic forward) between replays
    sampler = ToyDataset(seed=23)
    xs = [torch.from_numpy(sampler.next_batch(cfg.batch_size)).to(device) for _ in range(4)]
    def between(state):
        state.set_lr(cfg.lr_e * (1 + 0.1 * state.step), cfg.lr_d * (1 + 0.05 * state.step))
        if state.step % 4 == 3:
            with torch.no_grad():
                check(math.isfinite(float(det_fwd(state)(xs[0])[2].square().mean())),
                      "non-finite deterministic reconstruction")

    script = [(phase, x, draws, between) for phase, x, draws, _ in single_script(
        xs, lambda i: seeded_draws(device, cfg.batch_size, cfg.z_dim, 70 + i, INTRO_NOISES))]
    with exact_routes():
        graph_run, eager_run, g_counts, g_captured, g_graphs, freed = single_graph_against_eager(
            lambda: build_toy(cfg), script)
    differ, worst, compared = compare_runs(graph_run, eager_run)
    check(g_graphs == 3 and freed and not g_captured,
          f"toy single-step run: {g_graphs} graphs, captured {g_captured}, vanilla graphs freed "
          f"{freed}")
    check(not differ, f"toy single-step graph against eager steps: {len(differ)} of {compared} "
          f"tensors differ (first {differ[:6]}), max |diff| {worst!r}")
    del graph_run, eager_run

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
             f"of the untraced iteration, peak {r['peak_gib']:.4f} GiB)"
             for phase, r in prof.items()]
    print(f"toy: train_soft_intro_vae_toy at the CLI recipe's width (8Gaussians, z 2, 3x256, "
          f"batch 512, betas 0.2/0.3/0.9), {TOY_NUM_VAE} vanilla + {TOY_ITERS - TOY_NUM_VAE} "
          f"intro iterations (graph replays, {graphs} graphs captured) and the final metrics in "
          f"{run_s:.2f} s: gn_elbo {res['gn_elbo']:.6g}, "
          f"sample KL {res['sample_kl']:.6g}, JSD {res['jsd']:.6g}; hand-written kernel launches "
          f"{counts} (none on this path); after warm-up, {TOY_PROFILE_ITERS} iterations each: "
          + "; ".join(parts) + f"; the trainer's single step (one_step), {len(script)} steps "
          f"({SINGLE_STEPS} vanilla, then intro, then intro with injected draws; an LR fill "
          f"after every step and the deterministic forward between replays) against the eager "
          f"steps, TF32 off, cuDNN deterministic: "
          + single_line(compared, g_counts, g_captured, g_graphs)
          + f"; one intro step card vs CPU, TF32 off: loss_e rel "
          f"{rel['loss_e']:.2e}, loss_d rel {rel['loss_d']:.2e} (tolerance {TOY_RTOL:g}); "
          f"on {card}", flush=True)
    return prof


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


# the dp phase: data parallelism over torch.distributed (parallel/)
DP_TIMEOUT_S = 420     # the spawned ranks' deadline on the card, each collective's too
DP_RTOL_ROUTES = 1e-5  # distributed (global BN, E[x^2] - E[x]^2) against cuDNN's BN route
DP_RTOL_RANKS = 1e-3   # two ranks against one, per leaf (the JAX bound, parallel/verify.py)
DP_STYLE = dict(startf=64, maxf=512, layer_count=7, latent_size=512, mapping_layers=8)
DP_STYLE_RTOL_LEAF = 1e-2    # the JAX package's own rule for its style step (dp_gloo_two_ranks)
DP_STYLE_RTOL_GLOBAL = 1e-2


def nccl_kernels(prof, steps: int):
    """NCCL's kernels in a torch.profiler trace: (launches a step, device ms
    a step, the u8norm launches the trace holds of ``steps``: one a step
    when it caught every replay)."""
    import torch

    from tools.torch_profile_image import device_us

    launches = ms = 0.0
    u8 = 0
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA or evt.is_user_annotation:
            continue
        if "u8norm_kernel" in evt.key:
            u8 += evt.count
        if "nccl" in evt.key.lower():
            launches += evt.count / steps
            ms += device_us(evt) / 1e3 / steps
    check(u8 > 0, "the profiled replays show no u8norm launch: the trace missed the graphs")
    return launches, ms, u8


def dp_nccl_world_one(device, card: str, results_dir: str) -> str:
    """(a) NCCL at world 1 in this process: the CIFAR-10 recipe through
    ``train_soft_intro_vae`` at scan_steps 8 with the collectives captured in
    the graph; graph against eager steps; the route against the
    non-distributed one (``mesh.unsharded``); ms/step of both routes."""
    import torch

    from soft_intro_vae_torch.parallel import collectives, mesh, multihost
    from soft_intro_vae_torch.train.image import build_image_training, train_soft_intro_vae
    from soft_intro_vae_torch.train.step import INTRO_NOISES

    world = multihost.initialize_multihost(f"file://{results_dir}/nccl_store", 1, 0,
                                           backend="nccl", device=str(device),
                                           timeout_s=DP_TIMEOUT_S)
    try:
        check(world.active and world.backend == "nccl" and world.size == 1, f"world {world}")
        # the trainer's main path on the distributed route
        cfg = image_config(device, os.path.join(results_dir, "nccl"), scan_steps=IMAGE_SCAN)
        spec, ds = image_dataset()
        steps = 2 * (IMAGE_N // cfg.batch_size)
        reset_counts()
        t0 = time.perf_counter()
        state, summary = train_soft_intro_vae(cfg, ds, spec)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts, captured = read_counts(), captured_counts()
        check(summary["steps"] == state.step == steps and counts["u8norm"] == steps,
              f"dp image run: {summary['steps']} steps, u8norm launches {counts['u8norm']}")
        check(counts["nccl_grads"] == 3 * steps // 2 and counts["nccl_metrics"] == steps,
              f"dp image run: gradient reduces {counts['nccl_grads']}, metrics reduces "
              f"{counts['nccl_metrics']} in {steps} steps (1 + 2 a vanilla + intro pair)")
        check(all(captured.get(f"nccl_{k}", 0) > 0 for k in ("grads", "bn_fwd", "bn_bwd",
                                                              "metrics")),
              f"the graphs did not capture every kind of collective: {captured}")
        last = summary["last_metrics"]
        check(all(math.isfinite(v) for v in last.values()), f"non-finite dp metrics: {last}")
        print(f"dp nccl: trainer run passed: {steps} steps in {run_s:.2f} s, device counts "
              f"{ {k: v for k, v in counts.items() if v} }, captured {dict(captured)}", flush=True)
        del state

        # graphed distributed steps against eager distributed steps
        n = 16
        spec16, ds16 = image_dataset(n * 32, seed=9)
        xs = torch.from_numpy(ds16.images).to(device).view(n, 32, *ds16.images.shape[1:])
        base = image_config(device, "")

        def build(scan):
            s, _, intro = build_image_training(dataclasses.replace(base, scan_steps=scan), spec16)
            return s, intro

        with exact_routes():
            graph_run, eager_run, g_counts, g_captured = graph_against_eager(build, xs, IMAGE_SCAN)
        differ, worst, compared = compare_runs(graph_run, eager_run)
        check(not differ, f"dp graph against eager steps: {len(differ)} of {compared} tensors "
              f"differ (first {differ[:6]}), max |diff| {worst!r}")
        per_replay = {k: v for k, v in sorted(g_captured.items())}
        del graph_run, eager_run

        # the distributed route against the non-distributed one, one eager step
        spec1, ds1 = image_dataset(base.batch_size, seed=7)
        x = torch.from_numpy(ds1.images).to(device)
        gen = torch.Generator(device=device)
        gen.manual_seed(17)
        noises = {k: torch.randn((base.batch_size, base.z_dim), generator=gen, device=device)
                  for k in INTRO_NOISES}
        losses = {}
        with exact_routes():
            for route in ("dp", "plain"):
                with (contextlib.nullcontext() if route == "dp" else mesh.unsharded()):
                    s, _, intro = build_image_training(base, spec1)
                    _, m = intro(s, x, noises)
                    losses[route] = {k: float(v) for k, v in m.items()}
        rel = {k: abs(losses["dp"][k] - losses["plain"][k]) / abs(losses["plain"][k])
               for k in ("loss_e", "loss_d")}
        print(f"dp nccl: graph against eager bit-equal ({compared} tensors); routes rel {rel}",
              flush=True)
        check(all(r <= DP_RTOL_ROUTES for r in rel.values()),
              f"dp route against the non-distributed route: {losses}")

        # ms/step of both routes at scan 8, NCCL's kernels from a trace
        ms = {"dp": image_ms_step(cfg, spec, ds, device, IMAGE_SCAN, trace=nccl_kernels)}
        with mesh.unsharded():
            ms["plain"] = image_ms_step(cfg, spec, ds, device, IMAGE_SCAN, trace=nccl_kernels)
        (nccl_launches, nccl_ms, u8_seen), plain_nccl = ms["dp"][2], ms["plain"][2]
        check(plain_nccl[0] == 0, f"{plain_nccl[0]} NCCL kernels a step off the dp route")
        calls = {k: v for k, v in collectives.calls.items()}

        # the style trainer's graph on the distributed route: its collectives captured
        scfg = style_config(device, "", STYLE_TRAIN_OPTS)
        xs = _style_batches(scfg, device, 5)
        with exact_routes(deterministic_algorithms=True):
            _, s_captured, s_compared, s_differ, _ = style_graph_against_eager(
                scfg, xs, [1.0] * len(xs), False)
        check(not s_differ, f"dp style graph against eager: {len(s_differ)} of {s_compared} "
              f"tensors differ (first {s_differ[:6]})")
        s_nccl = {k: v for k, v in s_captured.items() if k.startswith("nccl_")}
        check(s_nccl == {"nccl_grads": 2, "nccl_dlatent": 8, "nccl_metrics": 1},
              f"the style intro capture recorded collectives {s_nccl}")
    finally:
        multihost.shutdown()
    check(not torch.distributed.is_initialized(), "the NCCL group was not destroyed")
    timing = ", ".join(f"{r} {m:.3f} ms/step ({'/'.join(f'{w:.3f}' for w in ws)})"
                       for r, (m, ws, _) in ms.items())
    return (f"dp nccl: world 1 in this process, CIFAR-10 recipe width, scan_steps {IMAGE_SCAN}: "
            f"{steps} steps through train_soft_intro_vae in {run_s:.2f} s, gradient reduces "
            f"{counts['nccl_grads']}, metrics reduces {counts['nccl_metrics']}, BN reduces "
            f"{counts['nccl_bn_fwd']} forward / {counts['nccl_bn_bwd']} backward (on the "
            f"device: eager warm-up steps plus replays); launches per intro replay {per_replay}; "
            f"graph against eager: all {compared} tensors bit-equal over {n} steps; routes, one "
            f"f32 step: loss_e rel {rel['loss_e']:.2e}, loss_d rel {rel['loss_d']:.2e} (rtol "
            f"{DP_RTOL_ROUTES:g}); intro ms/step at scan {IMAGE_SCAN}: {timing}; NCCL kernels a "
            f"step {nccl_launches:.1f}, {nccl_ms:.4f} ms (torch.profiler over 2 calls, "
            f"{u8_seen} of {2 * IMAGE_SCAN} u8norm launches in the trace); "
            f"collective calls in this process {sum(calls.values())}; the style intro step "
            f"(ffhq256 width, LOD 6, batch 4, bf16) graphed on this route: collectives recorded "
            f"in its capture {s_nccl} (a gradient reduce a phase, dlatent_avg's style mean a "
            f"generate, the metrics), 5 steps against eager, all {s_compared} tensors bit-equal; "
            f"on {card}")


def dp_gloo_two_ranks(device, card: str, results_dir: str) -> str:
    """(b) Two ranks on the one card over gloo, eager, spawned by
    parallel/launch.py: the image, 3D and style probes, each against a
    1-rank run of the same global batch, weights and draws."""
    import numpy as np

    from soft_intro_vae_torch.parallel.launch import run_ranks, write_inputs
    from soft_intro_vae_torch.parallel.verify import compare_gradient_trees

    rng = np.random.default_rng(23)
    image_x = rng.integers(0, 256, (32, 32, 32, 3), dtype=np.uint8)
    clouds = (rng.random((32, 2048, 3)) - 0.5).astype(np.float32)
    style_xs = (rng.random((2, 32, 16, 16, 3)) * 2.0 - 1.0).astype(np.float32)
    inputs = write_inputs(os.path.join(results_dir, "dp_inputs.npz"), {
        "image": dict(x=image_x), "threed": dict(x=clouds), "style": dict(xs=style_xs)})
    jobs = [
        # lr 1e-3 and the gradients compared: after an ascent of lr 1 at full width
        # the D phase starts from an encoder far from the init, and its gradient
        # carries the E phase's last bits; at 3D widths the narrow prior's
        # logvar leaves exp's range
        dict(name="image", probe="sgd_gradient_probe",
             kwargs=dict(variant="image", mode="intro", z_dim=128, channels=[64, 128, 256],
                         image_size=32, lr=1e-3, step_kwargs=dict(beta_neg=256.0))),
        dict(name="threed", probe="sgd_gradient_probe",
             kwargs=dict(variant="3d", mode="intro", z_dim=128, n_points=2048, lr=1e-3,
                         step_kwargs=dict(beta_rec=20.0, beta_neg=256.0))),
        dict(name="style", probe="style_step_probe",
             kwargs=dict(model_kwargs=DP_STYLE, lod=2, blend=0.5, steps=1, lr=1e-3,
                         perturb=0.05, moved_only=True)),
    ]
    t0 = time.perf_counter()
    two = run_ranks(2, jobs, results_dir, inputs=inputs, device=str(device), backend="gloo",
                    timeout_s=DP_TIMEOUT_S)
    t2 = time.perf_counter() - t0
    (one,) = run_ranks(1, jobs, results_dir, inputs=inputs, device=str(device), backend="gloo",
                       timeout_s=DP_TIMEOUT_S)
    t1 = time.perf_counter() - t0 - t2
    for k in two[0]:
        check(np.array_equal(two[0][k], two[1][k]), f"dp gloo: the ranks differ in {k}")
    worst = {}
    for name, kind in (("image", "grad"), ("threed", "grad")):
        pre = f"{name}/{kind}/"
        got = {k: v for k, v in two[0].items() if k.startswith(pre)}
        want = {k: v for k, v in one.items() if k.startswith(pre)}
        check(len(want) > 4 and set(got) == set(want), f"dp gloo {name}: {len(want)} leaves")
        try:
            worst[name] = compare_gradient_trees(got, want, rtol=DP_RTOL_RANKS)
        except AssertionError as e:
            fail(f"dp gloo {name}: two ranks against one: {e}")
    # style: the JAX package's rule for its style data-parallel step
    # (tests/test_parallel.py test_style_dp_step_matches_single_device): per
    # leaf relative L2 < 1e-2 but for the blocks' biases, which feed an
    # instance norm and have no gradient but rounding noise, and the whole
    # gradient < DP_STYLE_RTOL_GLOBAL; the first block's instance norms of a
    # near-constant 4x4 plane carry the batch split's last bits into the rest
    keys = [k for k in one if k.startswith("style/grad/")]
    check(len(keys) > 4, f"dp gloo style: {len(keys)} leaves")
    style_worst, sq_diff, sq_ref = 0.0, 0.0, 0.0
    for k in keys:
        a, b = two[0][k].astype(np.float64), one[k].astype(np.float64)
        diff, norm = float(np.linalg.norm(a - b)), float(np.linalg.norm(b))
        sq_diff, sq_ref = sq_diff + diff ** 2, sq_ref + norm ** 2
        if "bias" in k and "block" in k:
            continue
        check(diff < DP_STYLE_RTOL_LEAF * norm, f"dp gloo style {k}: L2 {diff:.3e}, norm {norm:.3e}")
        style_worst = max(style_worst, diff / norm)
    style_global = (sq_diff / sq_ref) ** 0.5
    check(style_global < DP_STYLE_RTOL_GLOBAL, f"dp gloo style: whole gradient {style_global:.3e}")
    dl = one["style/dlatent_avg"].astype(np.float64)
    dl_rel = float(np.linalg.norm(two[0]["style/dlatent_avg"] - dl) / np.linalg.norm(dl))
    check(dl_rel < DP_RTOL_RANKS, f"dp gloo style dlatent_avg: relative L2 {dl_rel:.3e}")
    check(int(two[0]["style/step"]) == 1, "dp gloo style: steps")
    return (f"dp gloo: two ranks on {card} over gloo (eager), each against one rank on the "
            f"same global batch, weights and draws, TF32 off, convolutions by ATen's GEMMs "
            f"(cuDNN off in the ranks); ranks bit-equal in all "
            f"{len(two[0])} arrays; worst per-leaf relative L2 (bound {DP_RTOL_RANKS:g}) of the "
            f"all-reduced gradients of one intro step (SGD lr 1e-3): image at the CIFAR-10 "
            f"recipe width (global batch 32, 16 a rank) {worst['image']:.2e}; 3D at "
            f"soft_intro_vae_hp.json width (2048 points, global batch 32) "
            f"{worst['threed']:.2e}; style, configs/ffhq256.yaml widths and depth (7 blocks, "
            f"latent 512, f32, not the config's bf16), LOD 2 blend 0.5, global batch 32 (not the "
            f"table's 128), one intro step with style mixing and decoder noise drawn, weights "
            f"moved off the init by 0.05 randn: worst leaf {style_worst:.2e} of {len(keys)} "
            f"(blocks' biases aside; bound {DP_STYLE_RTOL_LEAF:g}, the JAX package's style rule), "
            f"whole gradient {style_global:.2e} (bound {DP_STYLE_RTOL_GLOBAL:g}), dlatent_avg "
            f"{dl_rel:.2e}; 2 ranks {t2:.1f} s, 1 rank {t1:.1f} s")


def phase_dp(device, card: str, results_dir: str):
    """Data parallelism: (a) NCCL at world 1 in this process, (b) two gloo
    ranks on the card; each destroys its process group."""
    t0 = time.perf_counter()
    print(dp_nccl_world_one(device, card, results_dir), flush=True)
    ta = time.perf_counter() - t0
    print(dp_gloo_two_ranks(device, card, results_dir), flush=True)
    print(f"dp time (s): nccl world 1 {ta:.1f}, gloo two ranks {time.perf_counter() - t0 - ta:.1f}",
          flush=True)


# this slice's phases: activation checkpointing (remat), the encoder variants,
# the figures and async checkpoint saves
GRAPH_STYLE_STEPS = 8  # graph style: intro steps a run (3 warm-up, a capture, 5 replays)
STYLE_TRACED_STEPS = 2  # graph style: steps traced for the device's busy time
ASYNC_N = 640          # images of the async-save run: 20 steps an epoch, chunks 8, 8 and 4


def _tensors_equal(a, b, where: str, differ: list) -> int:
    """Compare two nested payloads tensor by tensor (torch.equal), appending
    the paths that differ to ``differ``; returns how many tensors it compared."""
    import torch

    if isinstance(a, dict):
        check(set(a) <= set(b), f"{where}: keys {sorted(set(a) - set(b))[:4]} missing")
        return sum(_tensors_equal(a[k], b[k], f"{where}.{k}", differ) for k in a)
    if isinstance(a, (list, tuple)):
        return sum(_tensors_equal(x, y, f"{where}[{i}]", differ)
                   for i, (x, y) in enumerate(zip(a, b)))
    if isinstance(a, torch.Tensor):
        if a.shape != b.shape or not torch.equal(a.cpu(), b.cpu()):
            differ.append(where)
        return 1
    if a != b:
        differ.append(where)
    return 0


def phase_remat_image(device, card: str):
    """The image step with remat at the CIFAR-10 recipe's width and
    scan_steps 8, deterministic routes: 16 steps as two graph calls against
    16 eager remat steps, and against 16 graphed steps without remat, all
    bit-equal; u8norm launches one a step; at scan_steps 1 the trainer's
    route with remat against the eager remat step over ``single_script``;
    ms/step and peak device memory with remat off and on."""
    import torch

    from soft_intro_vae_torch.train.image import build_image_training
    from soft_intro_vae_torch.train.step import INTRO_NOISES

    n = 16
    spec, ds = image_dataset(n * 32, seed=11)
    xs = torch.from_numpy(ds.images).to(device).view(n, 32, *ds.images.shape[1:])
    cfg = image_config(device, "")

    def builder(remat: bool):
        def build(scan):
            state, _, intro = build_image_training(
                dataclasses.replace(cfg, scan_steps=scan, remat=remat), spec)
            return state, intro
        return build

    t0 = time.perf_counter()
    with exact_routes(deterministic_algorithms=True):
        graph_run, eager_run, counts, captured = graph_against_eager(builder(True), xs, IMAGE_SCAN)
        sp, plain = builder(False)(IMAGE_SCAN)
        mp = [plain(sp, xs[i:i + IMAGE_SCAN])[1] for i in range(0, n, IMAGE_SCAN)]
        torch.cuda.synchronize()
    plain_run = (sp, {k: torch.cat([m[k] for m in mp]) for k in mp[0]})
    check(counts["u8norm"] == n and captured == {"u8norm": 1},
          f"remat K-step run: device launches {counts}, captured {captured}")
    differ, worst, compared = compare_runs(graph_run, eager_run)
    check(not differ, f"remat image graph against eager: {len(differ)} of {compared} tensors "
          f"differ (first {differ[:6]}), max |diff| {worst!r}")
    differ, worst, compared = compare_runs(graph_run, plain_run)
    check(not differ, f"image remat on against off: {len(differ)} of {compared} tensors differ "
          f"(first {differ[:6]}), max |diff| {worst!r}")
    check(int(graph_run[0].model.state_dict()["encoder.main.1.num_batches_tracked"]) == 5 * n,
          "remat advanced num_batches_tracked more than once a forward")
    del graph_run, eager_run, plain_run, sp, plain
    # the trainer's route at scan_steps 1 with remat: the recomputes in each graph
    script = single_script(
        xs, lambda i: seeded_draws(device, 32, cfg.z_dim, 60 + i, INTRO_NOISES))
    with exact_routes(deterministic_algorithms=True):
        graph_run, eager_run, counts1, captured1, graphs1, freed = single_graph_against_eager(
            lambda: build_image_training(dataclasses.replace(cfg, remat=True), spec), script)
    differ, worst, compared1 = compare_runs(graph_run, eager_run)
    check(counts1["u8norm"] == len(script) and captured1 == {"u8norm": 3} and graphs1 == 3
          and freed, f"remat single-step run: device launches {counts1}, captured {captured1}, "
          f"{graphs1} graphs, vanilla graphs freed {freed}")
    check(not differ, f"remat image single-step graph against eager: {len(differ)} of "
          f"{compared1} tensors differ (first {differ[:6]}), max |diff| {worst!r}")
    del graph_run, eager_run
    equal_s = time.perf_counter() - t0
    timed = {}
    for remat in (False, True):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        ms, ws, _ = image_ms_step(dataclasses.replace(cfg, remat=remat), spec, ds, device,
                                  IMAGE_SCAN, trace=lambda prof, steps: None)
        timed[remat] = (ms, ws, torch.cuda.max_memory_allocated(device) / 2**30)
    print(f"remat image: CIFAR-10 recipe width, batch 32, f32, scan_steps {IMAGE_SCAN}, every "
          f"encoder/decoder forward checkpointed; TF32 off, cuDNN and PyTorch deterministic: two "
          f"graph calls of {IMAGE_SCAN} against {n} eager remat steps, and against {n} graphed "
          f"steps without remat: all {compared} tensors bit-equal (metrics, parameters, BN "
          f"buffers with num_batches_tracked {5 * n} = one a forward, Adam moments and counts, "
          f"generator); u8norm launches {counts['u8norm']} = steps, {captured['u8norm']} "
          f"recorded in the capture; the trainer's single step (one_step) with remat, "
          f"{len(script)} steps against the eager remat steps: "
          + single_line(compared1, counts1, captured1, graphs1)
          + f" ({equal_s:.2f} s); intro step after warm-up, 16-step "
          f"windows (default TF32 policy): " + "; ".join(
              f"remat {'on' if r else 'off'} {ms:.3f} ms/step (median of "
              f"{'/'.join(f'{w:.3f}' for w in ws)}), peak device memory {gib:.3f} GiB"
              for r, (ms, ws, gib) in timed.items()) + f"; on {card}", flush=True)
    return timed


def phase_remat_style(device, card: str, results_dir: str):
    """TRAIN.REMAT at ffhq256 width, LOD 6, batch 4: the trainer's vanilla and
    intro epoch with the remat launch count; one f32 intro step with remat
    against one without (batch noise and style mixing on, deterministic
    routes), bit-equal with the generator's state; ms/step and peak device
    memory with remat off and on, bf16."""
    import torch

    from soft_intro_vae_torch.train.style import train_style_soft_intro_vae

    cfg = style_config(device, results_dir, STYLE_TRAIN_OPTS + ["TRAIN.REMAT", "true"])
    check(cfg.remat, "TRAIN.REMAT true did not reach the config")
    lod = cfg.layer_count - 1
    steps = cfg.synthetic_n // cfg.lod_2_batch_tables["1GPU"][lod]
    reset_counts()
    t0 = time.perf_counter()
    state, summary = train_style_soft_intro_vae(cfg)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = read_counts()
    want = style_step_launches(lod, steps, steps, remat=True)
    check((counts["bias_act_norm_fwd"], counts["bias_act_norm_bwd"]) == want,
          f"remat fused-norm launches {counts}, expected forward/backward {want}")
    last = summary["last_metrics"]
    check(summary["steps"] == 2 * steps and all(math.isfinite(v) for v in last.values()),
          f"remat style run: {summary['steps']} steps, metrics {last}")
    del state

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    x = _style_batches(cfg32, device, 1)[0]
    runs = []
    with exact_routes(deterministic_algorithms=True):
        for remat in (False, True):
            state, intro = _style_intro(dataclasses.replace(cfg32, remat=remat))
            _, m = intro(state, x)
            torch.cuda.synchronize()
            runs.append({"metrics": {k: v.detach().clone() for k, v in m.items()},
                         "nets": {k: v.clone() for k, v in state.nets.state_dict().items()},
                         "ema": {k: v.clone() for k, v in state.ema.state_dict().items()},
                         "generator": state.generator.get_state()})
            del state, intro
            torch.cuda.empty_cache()
    differ = []
    compared = _tensors_equal(runs[0], runs[1], "step", differ)
    check(not differ, f"style remat on against off: {len(differ)} of {compared} tensors differ "
          f"(first {differ[:6]})")
    del runs
    print(f"remat style: ffhq256 width, LOD 6, batch 4, bf16, TRAIN.REMAT (encoder + mapping_tl "
          f"and the decoder checkpointed): {steps} vanilla + {steps} intro steps in {run_s:.2f} s "
          f"(graphed); bias_act_norm launches on the device fwd {counts['bias_act_norm_fwd']} / "
          f"bwd {counts['bias_act_norm_bwd']} (expected {want[0]} / {want[1]}: each forward with "
          f"a gradient recomputed); one f32 intro step with remat against one without, batch "
          f"noise and mixing on, TF32 off, deterministic: all {compared} tensors bit-equal "
          f"(metrics, nets, EMA, generator state); timed in the graph style phase; on {card}",
          flush=True)


def phase_graph_style(device, card: str):
    """The style trainer's route on the card, ``one_step`` (one CUDA graph a
    (LOD, blended, phase, batch shape)), against the eager step at ffhq256
    width, LOD 6, batch 4, bf16, under exact routes: GRAPH_STYLE_STEPS intro
    steps from one seed, stable, blended (a blend a step from the LOD
    driver) and with TRAIN.REMAT, every tensor bit-equal; fused-norm launches
    recorded in the capture and on the device; then ms/step graphed and
    eager, remat off and on, with peak device memory and device busy time."""
    from soft_intro_vae_torch.train.lod import LODDriver

    t0 = time.perf_counter()
    cfg = style_config(device, "", STYLE_TRAIN_OPTS)
    lod = cfg.layer_count - 1
    batch = cfg.lod_2_batch_tables["1GPU"][lod]
    n = GRAPH_STYLE_STEPS
    driver = LODDriver(lod_2_batch=cfg.lod_2_batch_tables["1GPU"], epochs_per_lod=2,
                       layer_count=cfg.layer_count, dataset_size=n * batch)
    driver.set_epoch(2 * lod)
    blends = [driver.blend_factor_at(i * batch) for i in range(n)]
    check(driver.lod == lod and driver.in_transition and len(set(blends)) == n
          and max(blends) < 1.0, f"LOD driver: lod {driver.lod}, blends {blends}")
    cases = (("stable", cfg, _style_batches(cfg, device, n), [1.0] * n, False),
             ("blended", cfg, _style_batches(cfg, device, n, blends), blends, True),
             ("remat", dataclasses.replace(cfg, remat=True), _style_batches(cfg, device, n),
              [1.0] * n, False))
    parts, timed = [], {}
    for name, c, xs, bs, blended in cases:
        with exact_routes(deterministic_algorithms=True, fill_uninitialized=False):
            counts, captured, compared, differ, times = style_graph_against_eager(
                c, xs, bs, blended, timed=not blended)
        if times:
            timed[c.remat] = times
        check(not differ, f"graph style {name}: {len(differ)} of {compared} tensors differ "
              f"from the eager steps (first {differ[:6]})")
        per_step = style_step_launches(lod, 0, 1, remat=c.remat)
        want = style_step_launches(lod, 0, n, remat=c.remat)
        got = (counts["bias_act_norm_fwd"], counts["bias_act_norm_bwd"])
        rec = (captured.get("bias_act_norm_fwd"), captured.get("bias_act_norm_bwd"))
        check(got == want and rec == per_step,
              f"graph style {name}: fused-norm launches on the device {got} (expected {want}), "
              f"recorded in the capture {rec} (expected {per_step})")
        parts.append(f"{name}: all {compared} tensors bit-equal, fused-norm launches captured "
                     f"{rec[0]} / {rec[1]}, on the device {got[0]} / {got[1]}")

    def cell(remat, route):
        ms, ws, gib, base, (busy, ops) = timed[remat][route]
        return (f"{route} {ms:.3f} ms/step (median of "
                f"{'/'.join(f'{w:.3f}' for w in ws)}), device busy {busy:.3f} ms/step (idle "
                f"{1 - busy / ms:.1%}), {ops:.0f} device operations a step, peak {gib:.3f} GiB "
                f"({base:.3f} allocated before the state was built)")
    print(f"graph style: ffhq256 width, LOD 6, batch {batch}, bf16, TF32 off, cuDNN and PyTorch "
          f"deterministic (new tensors unfilled): {n} intro steps through one_step (3 eager warm-up steps, a capture, "
          f"{n - 3} replays) against {n} eager steps from the same seed; " + "; ".join(parts)
          + f" (blends {', '.join(f'{b:.4f}' for b in blends)}); stable intro step after "
          f"those {n}, {TIMED_STEPS}-step windows, busy time from a device trace of "
          f"{STYLE_TRACED_STEPS} steps, peak memory over the run: " + "; ".join(
              f"remat {'on' if r else 'off'}: {cell(r, 'graphed')}, {cell(r, 'eager')}"
              for r in (False, True)) + f"; {time.perf_counter() - t0:.2f} s on {card}",
          flush=True)
    return timed


def phase_encoders(device, cfg):
    """One f32 LOD-6 intro step at ffhq256 width for each of the other two
    MODEL.ENCODER values: loss_e kernel route against plain route; loss_d of
    both f32 routes against the float64 plain route (their last block's
    4M-weight dense layer takes LREQAdam's sign-like first update, so loss_d
    moves with rounding: the plain f32 route lands 3e-3 and 9e-3 from float64,
    measured on one H100)."""
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    out = []
    for variant in ("EncoderWithStatistics", "EncoderWithFC"):
        losses = style_route_losses(device, dataclasses.replace(cfg32, encoder=variant), variant,
                                    f64=True)
        (ke, kd), (pe, pd), (_, rd) = losses["cuda"], losses["plain"], losses["f64"]
        out.append(f"{variant} loss_e {ke!r}/{pe!r} (kernel/plain), loss_d {kd!r}/{pd!r}/{rd!r} "
                   f"(kernel/plain/float64: {abs(kd - rd) / abs(rd):.3g} and "
                   f"{abs(pd - rd) / abs(rd):.3g} from float64)")
    print(f"encoders: one f32 LOD-6 intro step at ffhq256 width, noise off, TF32 off: loss_e "
          f"kernel vs plain route rtol {STYLE_RTOL_LOSS_E:g}; loss_d kernel route to the float64 "
          f"plain route within rtol {STYLE_RTOL_LOSS_D:g} or {ROUTE_F64_FACTOR:g} x the plain f32 "
          f"route's distance: " + "; ".join(out), flush=True)


def phase_figures(device, card: str, cfg, results_dir: str):
    """Every array-producing figure kind (cli/figures.py) from the style
    phase's final checkpoint at ffhq256 width: shapes and finite values; the
    samples through the kernels against the plain norm route (f32, TF32 off)."""
    import numpy as np

    from soft_intro_vae_torch.cli import figures

    lod = cfg.layer_count - 1
    steps = 2 * (cfg.synthetic_n // cfg.lod_2_batch_tables["1GPU"][lod])
    ckpt = os.path.join(results_dir, "training_artifacts",
                        f"{cfg.name}_model_epoch_1_iter_{steps}_final.ckpt")
    t0 = time.perf_counter()
    model, state = figures.load_model(cfg, ckpt)
    res = model.layer_to_resolution[lod]
    rng = np.random.default_rng(17)
    reals = lambda k: rng.random((k, res, res, 3), dtype=np.float32) * 2 - 1  # noqa: E731
    grids = {
        "samples": (figures.sample_images(model, state, count=4), (4, res, res, 3)),
        "recon": (figures.reconstruction_images(model, state, reals(4)), (8, res, res, 3)),
        "interpolation": (figures.interpolation_images(model, state, steps=4), (4, res, res, 3)),
        "stylemix": (figures.style_mixing_images(model, state, n_src=2, n_dst=2),
                     (6, res, res, 3)),
        "recon-multires": (figures.multires_canvas(model, state, reals(20)),
                           (2 * res + 24, 4 * (2 * res + 14), 3)),
        "recon-paged": (figures.paged_cells(model, state, reals(6)), (6, res, 2 * res, 3)),
        "interpolation-images": (figures.interpolation_2_images(model, state, reals(2), steps=4),
                                 (4, res, res, 3)),
    }
    for kind, (arr, shape) in grids.items():
        check(arr.shape == shape and bool(np.isfinite(arr).all()),
              f"figure {kind}: shape {arr.shape} (expected {shape}), finite {np.isfinite(arr).all()}")
    del model, state
    # samples in f32 through the kernels and through the plain norm, and in
    # float64 through the plain norm: a decoder 8 steps from the init
    # normalizes near-constant planes, so the f32 routes' rounding is amplified
    # (relative L2 ~2e-2 from float64, measured on one H100); the kernel route
    # is held to float64 within ROUTE_F64_FACTOR times the plain f32 route
    samples = {}
    with no_tf32():
        for name, impl in (("cuda", "cuda"), ("plain", "plain"), ("f64", "plain")):
            model, state = figures.load_model(
                dataclasses.replace(cfg, compute_dtype="float32", norm_impl=impl), ckpt)
            if name == "f64":
                as_float64(state)
            samples[name] = figures.sample_images(model, state, count=4)
            del model, state
    ref = samples["f64"]
    rel = {k: float(np.linalg.norm(samples[k] - ref) / np.linalg.norm(ref))
           for k in ("cuda", "plain")}
    err = float(np.abs(samples["cuda"] - samples["plain"]).max())
    check(rel["cuda"] <= ROUTE_F64_FACTOR * rel["plain"],
          f"figure samples: kernel route {rel['cuda']!r} from the float64 plain route (relative "
          f"L2), more than {ROUTE_F64_FACTOR:g} x the plain f32 route's {rel['plain']!r}")
    print(f"figures: from the style phase's final checkpoint (ffhq256 width, LOD 6, bf16), every "
          f"array kind finite at its shape: " + ", ".join(
              f"{k} {arr.shape}" for k, (arr, _) in grids.items()) + f"; f32 samples, kernel "
          f"route {rel['cuda']:.4g} and plain f32 route {rel['plain']:.4g} from the float64 plain "
          f"route (relative L2; bound {ROUTE_F64_FACTOR:g} x the plain's), kernel against plain "
          f"max |diff| {err:.3g}; "
          f"{time.perf_counter() - t0:.2f} s on {card}", flush=True)


def phase_async_save(device, card: str, results_dir: str):
    """The image trainer at the CIFAR-10 recipe's width and scan_steps 8 with
    an async save each epoch: each file, reloaded, equals the state at its
    save (a host copy taken there), though the graph replayed after it."""
    import torch

    from soft_intro_vae_torch.train.image import train_soft_intro_vae
    from soft_intro_vae_torch.utils.checkpoint import Checkpointer, to_host

    spec, ds = image_dataset(ASYNC_N, seed=13)
    cfg = image_config(device, results_dir, scan_steps=IMAGE_SCAN, num_epochs=3,
                       save_interval=1)
    saves = []
    real_save = Checkpointer.save

    def recording_save(self, state, epoch, iteration=0, tag="", aux=None, async_save=False):
        torch.cuda.synchronize()
        saves.append((epoch, iteration, async_save, to_host(state.state_dict())))
        return real_save(self, state, epoch, iteration, tag, aux, async_save)

    t0 = time.perf_counter()
    Checkpointer.save = recording_save
    try:
        state, summary = train_soft_intro_vae(cfg, ds, spec)
    finally:
        Checkpointer.save = real_save
    torch.cuda.synchronize()
    per_epoch = ASYNC_N // cfg.batch_size
    check([(e, i, a) for e, i, a, _ in saves] ==
          [(1, per_epoch, True), (2, 2 * per_epoch, True), (2, 3 * per_epoch, False)],
          f"image run saves: {[(e, i, a) for e, i, a, _ in saves]}")
    prefix = f"cifar10_soft_intro_betas_{cfg.beta_kl}_{cfg.beta_neg}_{cfg.beta_rec}_"
    compared, moved = 0, []
    for epoch, it, _, want in saves:
        path = os.path.join(results_dir, "saves", f"{prefix}model_epoch_{epoch}_iter_{it}.ckpt")
        got = torch.load(path, map_location="cpu", weights_only=True)
        differ = []
        compared += _tensors_equal(want, got, os.path.basename(path), differ)
        check(not differ, f"checkpoint {path}: {len(differ)} tensors differ from the state at "
              f"its save (first {differ[:4]})")
    final = state.model.state_dict()
    for epoch, _, is_async, want in saves:
        if is_async:
            moved.append(not torch.equal(want["model"]["encoder.fc.weight"],
                                         final["encoder.fc.weight"].cpu()))
    check(all(moved), "the state did not move after an async save: the check would be empty")
    print(f"async save: CIFAR-10 recipe width, scan_steps {IMAGE_SCAN}, {ASYNC_N} uint8 images, "
          f"3 epochs, async saves at epochs 1 and 2 then the final synchronous one: each of the "
          f"3 files reloads equal to the state at its save, {compared} tensors torch.equal, "
          f"while the graph replayed on after each async save; "
          f"{time.perf_counter() - t0:.2f} s on {card}", flush=True)


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
    with tempfile.TemporaryDirectory(prefix="results_chip_smoke_", dir=ROOT) as style_dir:
        cfg, counts_style = phase_style_train(device, card, style_dir)
        resident_ms, mix = phase_style_step(device, card, cfg)
        totals = phase_norm_sites(device, mix, peaks)
        phase_style_routes(device, cfg)
        with tempfile.TemporaryDirectory(prefix="results_chip_smoke_", dir=ROOT) as results_dir:
            phase_style_transition(device, results_dir)
        lap("style")
        phase_figures(device, card, cfg, style_dir)  # from the style phase's final checkpoint
        lap("figures")
    with tempfile.TemporaryDirectory(prefix="results_chip_smoke_", dir=ROOT) as results_dir:
        phase_remat_style(device, card, results_dir)
    phase_encoders(device, cfg)
    lap("remat style and encoders")
    phase_graph_style(device, card)
    lap("graph style")
    with tempfile.TemporaryDirectory(prefix="results_chip_smoke_", dir=ROOT) as results_dir:
        phase_stream(device, card, results_dir, resident_ms)
    lap("stream")
    u8 = phase_u8norm(device, peaks)
    with tempfile.TemporaryDirectory(prefix="results_chip_smoke_", dir=ROOT) as results_dir:
        cfg_image, counts_image, _ = phase_train_image(device, card, results_dir)
    phase_image_routes(device, dataclasses.replace(cfg_image, scan_steps=1))
    lap("image")
    phase_graph_image(device)
    with tempfile.TemporaryDirectory(prefix="results_chip_smoke_", dir=ROOT) as results_dir:
        phase_bootstrap_image(device, results_dir)
    lap("graph image and bootstrap")
    phase_remat_image(device, card)
    with tempfile.TemporaryDirectory(prefix="results_chip_smoke_", dir=ROOT) as results_dir:
        phase_async_save(device, card, results_dir)
    lap("remat image and async save")
    with tempfile.TemporaryDirectory(prefix="results_chip_smoke_", dir=ROOT) as results_dir:
        phase_toy(device, card, results_dir)
    lap("toy")
    with tempfile.TemporaryDirectory(prefix="results_chip_smoke_", dir=ROOT) as results_dir:
        phase_fid(device, card, results_dir)
    lap("fid")
    with tempfile.TemporaryDirectory(prefix="results_chip_smoke_", dir=ROOT) as results_dir:
        phase_dp(device, card, results_dir)
    lap("dp")
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
