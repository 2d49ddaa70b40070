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
              bias/leaky-ReLU/instance-norm/AdaIN forward and backward on
              channels-last tensors in every mode, f32 and bf16, at every
              LOD-6 site shape (each with its launch plan; two launches
              bit-equal); the blur forward and backward on channels-last
              tensors against F.conv2d's on NCHW copies at every LOD-6 b32
              site, f32 and bf16, bit-equal, timed at the two largest sites;
  4. train 3d: ``train_soft_intro_vae_3d`` at the full width of
              configs/soft_intro_vae_hp.json (2048 points, batch 32, z 128) on
              synthetic clouds for one intro epoch plus the valid JSD, each
              step a replay of the intro graph after 3 eager warm-up steps and
              its capture, every kernel's launch count and the captures read
              around it; the step time after warm-up graphed and eager, device
              busy time and peak memory; one step through the kernel against
              the plain route;
  4b. graph 3d: the encoder's per-point GEMMs (models/pointnet.py) at
              cuDNN's TF32 flag, on and off, each product bit-equal to
              ``torch.mm`` under cuBLAS's flag at that value, cuBLAS's flag
              restored; the generic step's K-step form (``scan_steps`` 4, a CUDA
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
              the count the steps imply (one launch a call each way), and the
              launches each capture recorded to one step's (the blur's: 83
              forward + 77 backward an intro step); the norm's and the blur's
              relayouts held to 0 (every input and gradient channels-last);
  6. step style: ms per LOD-6 eager intro step after warm-up; the first warm-up
              step records its fused-norm and blur launches by site, and each
              fused-norm site is
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
              SIZE 16) at LOD 6, one vanilla and two intro epochs, each fed by
              the trainer's prefetch worker, fused-norm launches held to the
              steps'; the trainer's ms a step (its epoch loop, the last epoch
              replays only) against its two parts alone: the host feed (the
              producer and the put, from the shards and from the same images
              in memory) and the graphed intro step on a resident batch; then
              512 images at level 8 only, in 4 parts: the native reader's
              records/s and MB/s a pass over them, the Python reader's over
              one part; the trainer on that max-level route at LODs 0-2 (an
              epoch each, 4 batches of 128 box-downscaled on the host), its
              launches held to the steps', its ms a step by LOD against the
              LOD's host feed alone (its batches held to the box-downscaled
              images up to flips) and graphed intro step alone; at each LOD
              the prefetch worker feeding the captured graph outside the
              trainer, an epoch, ms a step (the overlap once captured);
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
 10b. train folder: ``train_soft_intro_vae`` at the celeb256 recipe's width
              (channels 64-512 in six stages, 256x256, z 256, batch 8, beta_neg
              1024, f32 with TF32 off, the CLI's mirror) for one intro epoch
              over 64 seeded JPEG files streamed by ``FolderDataset`` (the
              residency bound set to 0): one ``feed.decode`` span a batch, the
              folder's counters held to the files of the epoch's batches,
              u8norm launches to the steps; the decode's ms a batch, the
              epoch's seconds and the peak memory;
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
              recorded in the capture, 5 steps bit-equal to eager ones; the
              style trainer there (LOD 6, 16 images, batch 4), its prefetch
              worker copying beside the replays' all-reduces, launches and
              collectives held to the steps'; (b)
              two ranks on the card
              over gloo (eager), spawned by parallel/launch.py, against one
              rank: the image, 3D and style probes (parallel/verify.py) at
              their recipes' widths, the ranks bit-equal. Each destroys its
              process group.
16. api:     the port's counterparts of the JAX package's remaining public
              functions, TF32 off: ``chamfer_distance_tiled`` (tile 512)
              against the kernel route ``chamfer_distance(impl="cuda")`` at
              the 3D recipe's (32, 2048, 2048), values within rel 1e-6 and
              gradients within 1e-5 of their largest; again at (32, 16384,
              16384), where one (B, N, M) float32 temporary of the dense plain
              route would take 34.4 GB: values, both routes' times and the
              tiled route's peak memory; ``LreqSeparableConv2d`` and
              ``LreqSeparableConvTranspose2d`` forward and input and weight
              gradients against the CPU within 1e-5 of their largest, and
              ``style_mod``, ``instance_norm``, ``avg_pool_2x``,
              ``upsample_nearest_2x`` within 1e-6; the subpackages' exports.
              Its chamfer launches are comparisons, not counted.
17. resume:  each trainer's course straight against the same course
              resumed by a fresh trainer call from the straight run's own
              checkpoint (written after graph replays), under exact routes:
              3D at configs/soft_intro_vae_hp.json (epoch 2 of 2 resumed),
              the CIFAR-10 recipe at scan_steps 8 (``pretrained`` +
              ``start_epoch``, epoch 1 of 2), the style trainer at ffhq256
              width across LOD 0 -> 1 (EPOCHS_PER_LOD 4, batch 128, the
              checkpoint at the end of epoch 4, inside LOD 1's blended
              transition), the toy CLI recipe (the last 150 of 300 iterations
              as ``pretrained``, the sampler where the straight run left it);
              final weights, optimizer state, step and generator state
              bit-equal; graphs captured and kernel launches on each side;
18. carry:   the JAX package's checkpoints under
              tests/torch_port_fixtures/jax_checkpoints/ (3D at narrow widths
              and 256 points; style at LOD 1, tiny channels) loaded by
              ``Checkpointer.load_latest``, warm-up steps and the capture, the
              checkpoint loaded again into the graph's tensors, then the 2
              steps JAX recorded beside it as replays through the chamfer and
              fused-norm kernels: losses within 1e-4 (3D) and 1e-3 (style) of
              JAX's, launches counted; eval_3d's sweep over the two 3D files
              on JAX's prior draws picks JAX's file, JSD within 1e-6.
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
    from soft_intro_vae_torch.ops import (
        adain_cuda, blur_cuda, chamfer_cuda, cuda_build, u8norm_cuda)

    t0 = time.perf_counter()
    libs = (chamfer_cuda, adain_cuda, blur_cuda, u8norm_cuda)
    paths = cuda_build.build_many([lib.spec() for lib in libs])
    for lib in libs:
        lib.load()
    parts = [f"{os.path.basename(lib.spec()[0])}: {cuda_build.ptxas_summary(path)}"
             for lib, path in zip(libs, paths)]
    return (f"build: chamfer_nearest.cu, bias_act_norm.cu, blur3x3.cu and u8norm.cu in "
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
    cl = torch.channels_last
    x = (2.0 * torch.randn(shape, **f32) + 0.3).to(dtype).contiguous(memory_format=cl)
    args = dict(bias=torch.randn((ch,), **f32), g=None, b=None, n=None, nw=None)
    if affine:
        args["g"] = torch.randn((bsz, ch), **f32) + 1.0
        args["b"] = torch.randn((bsz, ch), **f32)
    if mode == "noise":
        args["n"] = torch.randn((bsz, h, w), **f32)
        args["nw"] = torch.randn((ch,), **f32)
    cot = dict(dy=torch.randn(shape, **f32).to(dtype).contiguous(memory_format=cl),
               dm=torch.randn((bsz, ch), **f32), dv=torch.randn((bsz, ch), **f32))
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
            parts.append(f"{str(dtype)[6:]} {direction} unit={p.unit} R={p.rows} "
                         f"threads={p.threads} chunk={p.chunk} P={p.pixels} T={p.tiles} "
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

    # planes of equal values, as the generator's first norm sees its expanded
    # const (4x4, 512 channels): v = 0 and m = e at the image's first pixel
    # exactly (in corr mode the card's expf may round e otherwise), y = b up
    # to the rounding of m * a
    for dtype in (torch.float32, torch.bfloat16):
        for mode in ("plain", "corr"):
            xc = (2 * torch.randn((4, 512, 1, 1), generator=gen, device=device) + 0.3).expand(
                4, 512, 4, 4).to(dtype).contiguous(memory_format=torch.channels_last)
            bias = torch.randn(512, generator=gen, device=device)
            g = torch.randn((4, 512), generator=gen, device=device) + 1.0
            b = torch.randn((4, 512), generator=gen, device=device)
            y, m, v = adain_cuda.forward(xc, bias, g, b, mode=mode, **kw)
            e, _ = adain._producer(xc, bias, None, None, mode, kw["slope"], kw["corr_scale"])
            case = f"planes of equal values, {mode} {dtype}"
            check(torch.equal(v, torch.zeros_like(v)), f"{case}: v {float(v.abs().max())}")
            check(mode != "plain" or torch.equal(m, e[:, :, 0, 0]), f"{case}: m is not e")
            err = float((y.float() - b[:, :, None, None]).abs().max())
            tol = float(4 * torch.finfo(torch.float32).eps * (m * torch.rsqrt(v + kw["eps"]) * g)
                        .abs().max()) + (float(b.abs().max()) * 2 ** -8 if dtype != torch.float32
                                         else 0.0)
            check(err <= tol, f"{case}: max|y - b| {err:.3g} over {tol:.3g}")
            del xc, bias, g, b, y, m, v, e

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


# the blur's planes (C, side) in the ffhq256 LOD-6 step, largest first;
# phase_blur runs them at batch 32 (the benchmark's b32 cell), the style
# phases hold the step's blur sites to them at the smoke's batch
BLUR_PLANES = ((64, 256), (128, 128), (256, 64), (512, 32), (512, 16), (512, 8), (512, 4))
BLUR_BATCH = 32
BLUR_TIMED = 2                     # the planes timed: the two that hold 75% of the bytes
# odd shapes (one element a thread, strips of odd rows, whole planes of odd
# sides) and a contiguous view that starts 2 or 4 bytes past 16 (scalar staging)
BLUR_ODD = ((3, 5, 7, 9), (2, 3, 1, 6), (2, 3, 33, 65), (1, 2, 300, 1), (2, 2, 129, 127))


def style_blur_launches(lod: int, vanilla: int, intro: int, remat: bool = False):
    """(forward, backward) blur launches of these steps at this LOD: an
    encoder pass blurs in each of its lod + 1 blocks, a generator pass in
    each of its lod blocks after the first; the passes as in
    ``style_step_launches`` (an intro step: 5 encoder and 8 generator passes,
    all with a backward but the E phase's fake generation; 83 and 77 at LOD
    6); ``remat`` recomputes every forward that has a backward."""
    enc, dec = lod + 1, lod
    fwd = enc * (vanilla + 5 * intro) + dec * (vanilla + 8 * intro)
    bwd = enc * (vanilla + 5 * intro) + dec * (vanilla + 7 * intro)
    return fwd + (bwd if remat else 0), bwd


def _blur_pair(x, dy, route):
    """(y, dx) of the blur of x: route "cuda", the nets' blur (``models/style.py
    blur3x3``) on x and dy channels-last, dx through the kernel on dy; route
    "plain", ATen's depthwise F.conv2d on NCHW copies, dx through its own
    backward: the kernel's yardstick."""
    import torch

    from soft_intro_vae_torch.models.style import blur3x3
    from soft_intro_vae_torch.ops import blur

    fmt = torch.channels_last if route == "cuda" else torch.contiguous_format
    xg = x.contiguous(memory_format=fmt).detach().requires_grad_(True)
    y = blur3x3(xg, route) if route == "cuda" else blur.blur3x3_plain(xg)
    (dx,) = torch.autograd.grad(y, xg, dy.contiguous(memory_format=fmt))
    return y.detach(), dx


def phase_blur(device, peaks):
    """The blur kernel on channels-last tensors (forward; backward = the kernel
    on dy, ``flip``) against F.conv2d's forward and its own input gradient
    (ATen's depthwise kernels) on NCHW copies at every LOD-6 b32 site in f32
    and bf16 and at BLUR_ODD, bit for bit, and launch to launch; each order
    of the nine terms against the other direction's ATen result, counted;
    device times at the two largest planes
    in bf16 against the bound (one read and one write an element), the plain
    route (blur3x3_plain on x, and on dy: the Function's plain backward) and
    F.conv2d's own backward (``library_ms``)."""
    import torch

    from soft_intro_vae_torch.ops import blur, blur_cuda, cuda_build
    from tools.torch_norm_sites import device_ms

    gen = torch.Generator(device=device)
    gen.manual_seed(24)
    shapes = [(BLUR_BATCH, c, s, s) for c, s in BLUR_PLANES] + list(BLUR_ODD)
    crossed, plans = {}, []
    for dtype in (torch.float32, torch.bfloat16):
        for shape in shapes:
            n = math.prod(shape)
            # a channels-last view off a 16-byte boundary for the odd shapes
            off = 1 if shape in BLUR_ODD else 0
            bsz, ch, h, w = shape
            x = torch.randn(n + off, generator=gen, device=device).to(dtype)[off:].view(
                bsz, h, w, ch).permute(0, 3, 1, 2)
            dy = torch.randn(shape, generator=gen, device=device).to(dtype).contiguous(
                memory_format=torch.channels_last)
            y, dx = _blur_pair(x, dy, "cuda")
            y_ref, dx_ref = _blur_pair(x, dy, "plain")
            y2 = blur_cuda.blur3x3_cuda(x)
            y_flip = blur_cuda.blur3x3_cuda(x, flip=True)
            torch.cuda.synchronize()
            name = f"{tuple(shape)} {str(dtype).split('.')[-1]}"
            check(torch.equal(y, y_ref), f"blur forward {name}: {int((y != y_ref).sum())} of {n} "
                  f"elements differ from F.conv2d (max |diff| "
                  f"{float((y.float() - y_ref.float()).abs().max()):.3g})")
            check(torch.equal(dx, dx_ref), f"blur backward {name}: {int((dx != dx_ref).sum())} of "
                  f"{n} elements differ from F.conv2d's input gradient (max |diff| "
                  f"{float((dx.float() - dx_ref.float()).abs().max()):.3g})")
            check(torch.equal(y, y2), f"blur {name}: two launches differ")
            crossed[name] = int((y_flip != y_ref).sum())
            if shape in BLUR_ODD or shape[1:] == (64, 256, 256):
                p = blur_cuda.plan(*shape, dtype)
                plans.append(f"{name}: vec {p.vec}, {p.cols} pixels x bands of {p.rows} rows, "
                             f"{p.threads} threads, {p.smem} B, grid {p.grid}")
            del x, dy, y, dx, y_ref, dx_ref, y2, y_flip
    torch.cuda.empty_cache()

    times = {}
    plain, kernel = ("plain_fwd", "plain_bwd", "library_bwd"), ("fwd", "bwd")
    for c, side in BLUR_PLANES[:BLUR_TIMED]:
        shape = (BLUR_BATCH, c, side, side)
        x = torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)
        dy = torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)
        x_cl, dy_cl = (t.contiguous(memory_format=torch.channels_last) for t in (x, dy))
        xg = x.clone().requires_grad_(True)
        y_lib = blur.blur3x3_plain(xg)
        # the plain route and the library on NCHW (ATen's depthwise kernels),
        # the kernel channels-last
        calls = {"plain_fwd": lambda: blur.blur3x3_plain(x),
                 "plain_bwd": lambda: blur.blur3x3_plain(dy),
                 "library_bwd": lambda: torch.autograd.grad(y_lib, xg, dy, retain_graph=True),
                 "fwd": lambda: blur_cuda.blur3x3_cuda(x_cl),
                 "bwd": lambda: blur_cuda.blur3x3_cuda(dy_cl, flip=True)}
        t = {k: [] for k in calls}
        for turn in (plain, kernel, kernel, plain):
            for k in turn:
                t[k].append(device_ms(calls[k]))
        times[shape] = {k: sum(v) / len(v) for k, v in t.items()} | {
            "runs": t, "bound": 2 * x.numel() * x.element_size() / peaks[1] * 1e3}
        del x, dy, x_cl, dy_cl, xg, y_lib, calls
    torch.cuda.empty_cache()
    path = cuda_build.library_path(*blur_cuda.spec())
    top_shape = (BLUR_BATCH, BLUR_PLANES[0][0], BLUR_PLANES[0][1], BLUR_PLANES[0][1])
    top = times[top_shape]
    record = {
        "name": "blur3x3",
        "route": "cuda",
        "source": "soft_intro_vae_torch/ops/csrc/blur3x3.cu",
        "replaces": "no TPU kernel: XLA's grouped conv, soft_intro_vae_tpu/models/style.py:55",
        "launches": None,  # filled from the style train phase
        "max_abs_err": 0.0,
        "ms": top["fwd"],
        "bwd_ms": top["bwd"],
        "plain_ms": top["plain_fwd"],
        "plain_bwd_ms": top["plain_bwd"],
        "bound_ms": top["bound"],
        "bound_by": "bytes",
        "library_ms": top["plain_fwd"],  # the plain route is F.conv2d's forward
        "library_bwd_ms": top["library_bwd"],
        "shape": list(top_shape),
        "dtype": "bfloat16",
        "by_shape": {str(k): {n: v for n, v in t.items() if n != "runs"}
                     for k, t in times.items()},
    }
    parts = []
    for shape, t in times.items():
        r = {k: "/".join(f"{v:.4f}" for v in vs) for k, vs in t["runs"].items()}
        parts.append(
            f"{shape} bf16: forward {r['fwd']} ms, backward {r['bwd']} ms, bound "
            f"{t['bound']:.4f} ms (forward at {t['bound'] / t['fwd']:.1%}, backward at "
            f"{t['bound'] / t['bwd']:.1%}); plain route (F.conv2d) on x {r['plain_fwd']} ms, on "
            f"dy {r['plain_bwd']} ms; library_ms: F.conv2d's forward {t['plain_fwd']:.4f}, its "
            f"own backward {r['library_bwd']} ms")
    print(f"kernels: blur3x3 forward and backward bit-equal to F.conv2d's forward and input "
          f"gradient at every LOD-6 b32 plane and {len(BLUR_ODD)} odd shapes (views 2 or 4 "
          f"bytes off 16), f32 and bf16, and launch to launch; the backward's order of the nine "
          f"terms on x against F.conv2d's forward, elements that differ: "
          + (", ".join(f"{k} {v}" for k, v in crossed.items() if v) or "none")
          + "; plans: " + "; ".join(plans) + "; device times (calls queued behind a sleep "
          f"kernel, plain and kernel in turns; bound: one read and one write an element at "
          f"{peaks[1] / 1e12:.2f} TB/s): " + "; ".join(parts)
          + f"; ptxas: {cuda_build.ptxas_summary(path)}", flush=True)
    return record


# the hand-written kernels' names in ops/cuda_build.py ``launches``
KERNELS = ("chamfer_nearest", "bias_act_norm_fwd", "bias_act_norm_bwd", "u8norm", "blur3x3")


def relayouts() -> dict:
    """The style kernels' relayouts (ops/adain.py, ops/blur.py): copies of a
    norm or blur input or gradient into channels-last, by kernel and tensor."""
    from soft_intro_vae_torch.ops import adain, blur

    return {f"{name}.{k}": v for name, counter in (("norm", adain.relayouts),
                                                    ("blur", blur.relayouts))
            for k, v in counter.items() if v}


def reset_counts() -> None:
    from soft_intro_vae_torch.ops import adain, blur, cuda_build
    from soft_intro_vae_torch.parallel import collectives
    from soft_intro_vae_torch.train import graph

    adain.relayouts.clear()
    blur.relayouts.clear()
    cuda_build.launches.clear()
    collectives.calls.clear()
    graph.captured.clear()
    graph.replayed.clear()


def read_counts() -> dict:
    """Launches on the device since reset_counts, by kernel: each wrapper's
    count (every call, eager or recorded into a CUDA graph's capture) less
    the launches recorded into captures, plus those the replays made
    (train/graph.py); with no graph, the wrappers' counts."""
    from soft_intro_vae_torch.train import graph

    counts = graph.wrapper_counts()
    return {k: counts[k] - graph.captured[k] + graph.replayed[k]
            for k in dict.fromkeys([*KERNELS, *counts, *graph.replayed])}


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


def point_gemm_handoff(device) -> str:
    """The encoder's per-point layer (models/pointnet.py ``PointConv1d``) at
    the recipe's widest one, 65,536 rows of 256 -> 512: with cuDNN's TF32
    flag on and off and cuBLAS's flag set the other way, its forward, input
    gradient and weight gradient each bit-equal to ``torch.mm`` under cuBLAS's
    flag at cuDNN's value, cuBLAS's flag as it was afterwards, and the TF32
    products apart from the float32 ones."""
    import torch

    from soft_intro_vae_torch.models.pointnet import PointConv1d

    gen = torch.Generator(device).manual_seed(26)
    rows = torch.randn(65536, 256, device=device, generator=gen)
    dy = torch.randn(65536, 512, device=device, generator=gen)
    layer = PointConv1d(256, 512, 1, bias=False).to(device)
    w = layer.weight.detach().view(512, 256)
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    products = {}
    try:
        for tf32 in (False, True):
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32, not tf32
            x = rows.clone().requires_grad_()
            layer.weight.grad = None
            y = layer(x)
            y.backward(dy)
            check(torch.backends.cuda.matmul.allow_tf32 == (not tf32),
                  f"PointConv1d left cuBLAS's TF32 flag at {torch.backends.cuda.matmul.allow_tf32}")
            torch.backends.cuda.matmul.allow_tf32 = tf32
            want = (rows.mm(w.t()), dy.mm(w), dy.t().mm(rows).view(512, 256, 1))
            got = (y.detach(), x.grad, layer.weight.grad)
            for name, g, r in zip(("forward", "input gradient", "weight gradient"), got, want):
                check(torch.equal(g, r), f"PointConv1d {name} with cuDNN TF32 {tf32}: max |diff| "
                      f"{(g - r).abs().max().item():.3e} from torch.mm under cuBLAS TF32 {tf32}")
            products[tf32] = got
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    apart = [not torch.equal(a, b) for a, b in zip(products[False], products[True])]
    check(all(apart), f"PointConv1d's TF32 and float32 products equal: {apart}")
    return ("PointConv1d at 65536 x 256 -> 512, cuDNN TF32 off and on with cuBLAS's flag "
            "opposite: forward, input and weight gradients bit-equal to torch.mm under cuBLAS "
            "at cuDNN's flag, cuBLAS's flag restored, TF32 apart from float32")


def phase_graph_3d(device):
    """The encoder's per-point GEMMs' precision handoff (``point_gemm_handoff``);
    the generic step's K-step form with the 3D StepConfig at full width
    (2048 points, batch 32, z 128): two calls of K = 4 (a CUDA graph, the
    chamfer kernel captured) against 8 eager steps from the same seed; then
    the 3D trainer's route at scan_steps 1 (one graph a key) against the
    eager step over ``single_script``: vanilla, the switch, intro with the
    valid JSD between replays, intro with injected draws."""
    import torch

    from soft_intro_vae_torch.data.shapenet import SyntheticClouds
    from soft_intro_vae_torch.train.step import INTRO_NOISES
    from soft_intro_vae_torch.train.threed import ThreeDConfig, build_3d_training, calc_jsd_valid

    handoff = point_gemm_handoff(device)
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
    print(f"graph 3d: {handoff}. 2048 points, batch 32, z 128, TF32 off, cuDNN "
          f"deterministic, PyTorch's deterministic scatter_add_. K-step form, two calls of "
          f"K = 4 (3 eager warm-up steps, a capture, 5 replays) against 8 eager steps: {k_step}. The trainer's single step "
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
    check(not relayouts(), f"the style main path copied tensors into channels-last: "
          f"{relayouts()}")
    want_blur = sum(style_blur_launches(cfg.layer_count - 1, steps, steps))
    check(counts["blur3x3"] == want_blur,
          f"blur launches {counts['blur3x3']} on the device, expected {want_blur}")
    per_graph = [style_step_launches(cfg.layer_count - 1, v, 1 - v) for v in (1, 0)]
    blur_per_graph = [sum(style_blur_launches(cfg.layer_count - 1, v, 1 - v)) for v in (1, 0)]
    check((captured.get("bias_act_norm_fwd"), captured.get("bias_act_norm_bwd"))
          == tuple(map(sum, zip(*per_graph))) and captured.get("blur3x3") == sum(blur_per_graph),
          f"the vanilla and intro graphs recorded {captured}, expected {per_graph} fused-norm "
          f"and {blur_per_graph} blur launches")
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
          f"intro launches, replays); blur3x3 launches on the device {counts['blur3x3']} "
          f"(expected {want_blur}; captures {blur_per_graph}); one launch a call each way; "
          f"relayouts {sum(relayouts().values())} (every norm and blur input and gradient "
          f"channels-last); peak device memory {peak_gb:.2f} GB; on {card}",
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


@contextlib.contextmanager
def recording_blur_launches(mix):
    """Counts every blur kernel call by (direction, shape)."""
    from soft_intro_vae_torch.ops import blur_cuda

    call = blur_cuda.blur3x3_cuda

    def rec(x, flip=False):
        mix[("bwd" if flip else "fwd", tuple(x.shape))] += 1
        return call(x, flip)

    blur_cuda.blur3x3_cuda = rec
    try:
        yield mix
    finally:
        blur_cuda.blur3x3_cuda = call


def phase_style_step(device, card: str, cfg):
    """ms per LOD-6 intro step after warm-up: median of three 10-step windows.
    The first warm-up step records the step's fused-norm launches by site."""
    import collections

    import torch

    state, intro = _style_intro(cfg)
    batches = _style_batches(cfg, device, 4)
    with recording_norm_launches(collections.Counter()) as mix, \
            recording_blur_launches(collections.Counter()) as blurs:
        state, m = intro(state, batches[0])
    want = style_step_launches(cfg.layer_count - 1, 0, 1)
    got = tuple(sum(v for k, v in mix.items() if k[0] == d) for d in ("fwd", "bwd"))
    check(got == want, f"one intro step launched {got} fused-norm kernels, expected {want}")
    sites = sorted({k[1] for k in mix}, key=lambda s: -s[2])
    check(sites == list(SITE_SHAPES), f"the step's norm sites {sites} are not {SITE_SHAPES}")
    want_blur = style_blur_launches(cfg.layer_count - 1, 0, 1)
    got_blur = tuple(sum(v for k, v in blurs.items() if k[0] == d) for d in ("fwd", "bwd"))
    batch = batches[0].shape[0]
    blur_sites = sorted({k[1] for k in blurs}, key=lambda s: -s[2])
    check(got_blur == want_blur and blur_sites == [(batch, c, s, s) for c, s in BLUR_PLANES],
          f"one intro step launched {got_blur} blur kernels at {blur_sites}, expected "
          f"{want_blur} at {BLUR_PLANES}")
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
    print(f"step style: LOD-6 intro step at ffhq256 width, batch {batch}, bf16: "
          f"{ms_step:.3f} ms/step after warm-up (median of "
          f"{'/'.join(f'{w:.3f}' for w in windows)}), {batch * 1e3 / ms_step:.2f} images/s; "
          f"blur launches a step forward {got_blur[0]}, backward {got_blur[1]} on {card}",
          flush=True)
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
    run with the steps eager: every tensor bit-equal under exact routes, no
    relayout, and the peak device memory of both."""
    import torch

    from soft_intro_vae_torch.train import style
    from soft_intro_vae_torch.utils.checkpoint import to_host

    reset_counts()
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
    check(not relayouts(), f"the blended path copied tensors into channels-last: {relayouts()}")
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
STREAM_EPOCHS = 3      # LOD 6 from the shards: vanilla, intro (its capture), intro (replays only)
STREAM_HOST_N = 512    # images at level 8 only: 4 batches of 128 an epoch at LODs 0-2, box-downscaled
STREAM_HOST_PARTS = 4
STREAM_HOST_LODS = (0, 1, 2)  # the 1GPU table's batch-128 LODs, an epoch each (EPOCHS_PER_LOD 1)
# timed passes: native over the 512 level-8 records, python over one part's 128
STREAM_READ_PASSES = {"native": 3, "python": 1}
STREAM_PATTERN = "ffhq-r%02d.tfrecords.%03d"
STREAM_REPLAYS = 5     # graph replays a timed window, on one device-resident batch


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


@contextlib.contextmanager
def recording_epochs():
    """The style trainer's epoch loops, timed: from the prefetch worker's
    first read of an epoch (its call of ``rank_batches``) to the end of
    ``_epoch_means``, which waits for the epoch's last step. Yields the list
    of (ms, steps) the epochs append."""
    from soft_intro_vae_torch.train import style

    starts, epochs = [], []
    real_rank, real_means = style.rank_batches, style._epoch_means

    def rank_batches(*args, **kwargs):
        starts.append(time.perf_counter())
        return real_rank(*args, **kwargs)

    def epoch_means(device_metrics):
        out = real_means(device_metrics)
        epochs.append(((time.perf_counter() - starts[-1]) * 1e3, len(device_metrics)))
        return out

    style.rank_batches, style._epoch_means = rank_batches, epoch_means
    try:
        yield epochs
    finally:
        style.rank_batches, style._epoch_means = real_rank, real_means


def _host_feed(dataset, feed, res: int, batch: int, epoch: int):
    """The style trainer's feed alone, no steps: one epoch of its producer
    (``rank_batches``: read, shuffle, flip, box-downscale) and its put
    (``_Feed.put``: pinned ring, side-stream copy, table lookup) on this
    thread, up to the end of the last copy. (ms a batch, host batches)."""
    from soft_intro_vae_torch.parallel.mesh import current_world
    from soft_intro_vae_torch.train.style import rank_batches

    raws, last = [], None
    t0 = time.perf_counter()
    for raw in rank_batches(dataset, res, batch, epoch, current_world()):
        last, _, _ = feed.put((raw, 1.0, False))
        raws.append(raw)
    last.event.synchronize()
    return (time.perf_counter() - t0) * 1e3 / len(raws), raws


def _graphed_ms_step(intro, state, x):
    """ms a replay of the intro step's CUDA graph (train/graph.py
    ``one_step``, the trainer's route) on one device-resident batch, after
    its eager warm-up steps and its capture: (median, windows of
    TIMED_WINDOWS x STREAM_REPLAYS replays, the graphed step)."""
    import torch

    from soft_intro_vae_torch.train.graph import WARMUP_STEPS, one_step

    step = one_step(intro)
    for _ in range(WARMUP_STEPS + 1):
        state, m = step(state, x, 1.0)
    windows = []
    for _ in range(TIMED_WINDOWS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STREAM_REPLAYS):
            state, m = step(state, x, 1.0)
        torch.cuda.synchronize()
        windows.append((time.perf_counter() - t0) * 1e3 / STREAM_REPLAYS)
    check(all(math.isfinite(float(v)) for v in m.values()), "non-finite loss in the replays")
    return sorted(windows)[len(windows) // 2], windows, step


def _prefetched_ms_step(step, state, dataset, feed, res: int, batch: int, epoch: int) -> float:
    """ms a step of the trainer's loop once its graph is captured: one epoch
    of ``dataset`` through the trainer's producer and put on the prefetch
    worker (``device_prefetch``, two batches ahead) into replays of
    ``step``; from the worker's start to the end of the last replay."""
    import torch

    from soft_intro_vae_torch.data.prefetch import device_prefetch
    from soft_intro_vae_torch.parallel.mesh import current_world
    from soft_intro_vae_torch.train.style import rank_batches

    def produce():
        for raw in rank_batches(dataset, res, batch, epoch, current_world()):
            yield raw, 1.0, False

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = 0
    with contextlib.closing(device_prefetch(produce(), size=2, put_fn=feed.put)) as fed:
        for x, blend, _ in fed:
            state, m = step(state, x, blend)
            n += 1
    torch.cuda.synchronize()
    check(all(math.isfinite(float(v)) for v in m.values()), "non-finite loss in the replays")
    return (time.perf_counter() - t0) * 1e3 / n


def _bound_by(trainer_ms: float, host_ms: float, step_ms: float) -> str:
    """The trainer's ms a step against max(host, step), and which one bounds it."""
    bound = max(host_ms, step_ms)
    return (f"{trainer_ms / bound:.2f}x max(host, step), "
            f"{'the host feed' if host_ms > step_ms else 'the step'} bounds it")


def phase_stream(device, card: str, results_dir: str):
    """Shards written and read by both readers; the style trainer fed from
    them through its prefetch worker at LOD 6, and on the max-level route at
    LODs 0-2; each against its host feed alone and its graphed step alone."""
    import numpy as np
    import torch

    from soft_intro_vae_torch.cli.prepare_tfrecords import write_multires_shards
    from soft_intro_vae_torch.data.streaming import StreamingTFRecords
    from soft_intro_vae_torch.data.tfrecords import load_uint8_images
    from soft_intro_vae_torch.train.style import (
        MultiResImages, _Feed, build_style_training, train_style_soft_intro_vae)
    from soft_intro_vae_torch.train.style_step import StyleStepConfig, build_style_steps

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
    # the reader rates over the max-level route's level-8 records (step 4)
    host_dir = os.path.join(results_dir, "top")
    top_images = rng.integers(0, 256, (STREAM_HOST_N, 256, 256, 3), dtype=np.uint8)
    top = sorted(write_multires_shards(top_images, host_dir, "ffhq", 8, min_level=8,
                                       parts=STREAM_HOST_PARTS))
    check(len(top) == STREAM_HOST_PARTS, f"{len(top)} level-8 shard files")
    rates = {impl: _reader_rates(top if impl == "native" else top[:1], impl, passes)
             for impl, passes in STREAM_READ_PASSES.items()}

    # 3. the trainer from the shards: ffhq256 width, LOD 6, a vanilla epoch and
    # two intro epochs, each fed by the prefetch worker; the last one replays
    # graphs captured in the one before
    pattern = os.path.join(shards, STREAM_PATTERN)
    run_dir = os.path.join(results_dir, "run")
    cfg = style_config(device, run_dir, [
        "DATASET.PATH", pattern, "DATASET.PART_COUNT", str(STREAM_PARTS),
        "DATASET.SIZE", str(STREAM_N), "TRAIN.EPOCHS_PER_LOD", "0",
        "TRAIN.TRAIN_EPOCHS", str(STREAM_EPOCHS)])
    lod = cfg.layer_count - 1
    batch = cfg.lod_2_batch_tables["1GPU"][lod]
    steps = STREAM_N // batch
    reset_counts()
    t0 = time.perf_counter()
    with recording_epochs() as epochs:
        state, summary = train_style_soft_intro_vae(cfg)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = read_counts()
    want_fwd, want_bwd = style_step_launches(lod, steps, (STREAM_EPOCHS - 1) * steps)
    check(counts["bias_act_norm_fwd"] == want_fwd and counts["bias_act_norm_bwd"] == want_bwd,
          f"streamed style run: fused-norm launches {counts}, expected {want_fwd} / {want_bwd}")
    check(summary["steps"] == STREAM_EPOCHS * steps == state.step,
          f"streamed style run: {summary['steps']} steps")
    check([n for _, n in epochs] == [steps] * STREAM_EPOCHS, f"streamed style epochs {epochs}")
    last = summary["last_metrics"]
    check(all(math.isfinite(v) for v in last.values()), f"non-finite streamed metrics: {last}")
    final = os.path.join(run_dir, "training_artifacts", f"{cfg.name}_model_epoch_"
                         f"{STREAM_EPOCHS - 1}_iter_{STREAM_EPOCHS * steps}_final.ckpt")
    check(os.path.exists(final), f"no final checkpoint at {final}")
    trainer_ms = epochs[-1][0] / steps
    del state

    # its two parts alone: the host feed (shards, and the same images in
    # memory) and the graphed intro step on a device-resident batch
    feed = _Feed(device)
    streamed = StreamingTFRecords(pattern, STREAM_PARTS, STREAM_N, 8, seed=0, storage="uint8")
    in_memory = MultiResImages(images, seed=0, storage="uint8")
    res = 2 ** (lod + 2)
    host_stream = [_host_feed(streamed, feed, res, batch, e)[0] for e in range(STREAM_EPOCHS)]
    host_memory = [_host_feed(in_memory, feed, res, batch, e)[0] for e in range(STREAM_EPOCHS)]
    model, state = build_style_training(cfg)
    scfg = StyleStepConfig(latent_size=cfg.latent_space_size, beta_rec=cfg.beta_rec,
                           beta_kl=cfg.beta_kl, beta_neg=float(cfg.beta_neg[lod]),
                           scale=cfg.scale)
    _, intro = build_style_steps(model, scfg, lod, False)
    x = feed(next(in_memory.epoch(res, batch, epoch_index=0)), 1.0, False)
    step_ms, step_windows, graphed = _graphed_ms_step(intro, state, x)
    overlap = [_prefetched_ms_step(graphed, state, streamed, feed, res, batch, e)
               for e in range(STREAM_EPOCHS)]
    del state, intro, model, x, graphed
    torch.cuda.empty_cache()
    host_ms = sorted(host_stream)[len(host_stream) // 2]
    lod6 = (f"style from shards (ffhq256 width, LOD 6, batch {batch}, bf16): {steps} vanilla + "
            f"{(STREAM_EPOCHS - 1) * steps} intro steps in {run_s:.2f} s, bias_act_norm launches "
            f"fwd {counts['bias_act_norm_fwd']} / bwd {counts['bias_act_norm_bwd']} (expected "
            f"{want_fwd} / {want_bwd}), loss_e {last['loss_e']:.6g}; trainer, prefetched, epoch "
            f"loop ms/step by epoch {'/'.join(f'{ms / n:.3f}' for ms, n in epochs)} (the last "
            f"replays only: {trainer_ms:.3f}); host feed alone {host_ms:.3f} ms a batch from the "
            f"shards ({'/'.join(f'{t:.3f}' for t in host_stream)}), "
            f"{sorted(host_memory)[1]:.3f} in memory ({'/'.join(f'{t:.3f}' for t in host_memory)}"
            f"); graphed intro step alone {step_ms:.3f} ms/step "
            f"({'/'.join(f'{w:.3f}' for w in step_windows)}); trainer "
            f"{_bound_by(trainer_ms, host_ms, step_ms)}; the prefetch feeding the captured "
            f"graph, outside the trainer, from the shards: "
            f"{'/'.join(f'{t:.3f}' for t in overlap)} ms/step by epoch, "
            f"{_bound_by(sorted(overlap)[1], host_ms, step_ms)}")

    # 4. the max-level route: level-8 shards only, LODs 0-2 at batch 128, box-
    # downscaled on the host; the trainer an epoch a LOD, then each LOD's host
    # feed alone (its batches hold every image once, each as it is or
    # mirrored) and its graphed intro step alone
    top_pattern = os.path.join(host_dir, STREAM_PATTERN)
    cfg_top = style_config(device, os.path.join(results_dir, "run_top"), [
        "DATASET.PATH", top_pattern, "DATASET.PART_COUNT", str(STREAM_HOST_PARTS),
        "DATASET.SIZE", str(STREAM_HOST_N), "TRAIN.EPOCHS_PER_LOD", "1",
        "TRAIN.TRAIN_EPOCHS", str(len(STREAM_HOST_LODS))])
    top_batch = cfg_top.lod_2_batch_tables["1GPU"][0]
    top_steps = STREAM_HOST_N // top_batch
    reset_counts()
    with recording_epochs() as top_epochs:
        state, top_summary = train_style_soft_intro_vae(cfg_top)
    top_counts = read_counts()
    launches = [style_step_launches(lod, top_steps * (i < cfg_top.num_vae),
                                    top_steps * (i >= cfg_top.num_vae))
                for i, lod in enumerate(STREAM_HOST_LODS)]
    top_want = tuple(map(sum, zip(*launches)))
    check((top_counts["bias_act_norm_fwd"], top_counts["bias_act_norm_bwd"]) == top_want,
          f"max-level style run: fused-norm launches {top_counts}, expected {top_want}")
    check(top_summary["lods_seen"] == list(STREAM_HOST_LODS)
          and [n for _, n in top_epochs] == [top_steps] * len(STREAM_HOST_LODS),
          f"max-level style run: LODs {top_summary['lods_seen']}, epochs {top_epochs}")
    check(all(math.isfinite(v) for v in top_summary["last_metrics"].values()),
          f"non-finite max-level metrics: {top_summary['last_metrics']}")
    del state

    top_stream = StreamingTFRecords(top_pattern, STREAM_HOST_PARTS, STREAM_HOST_N, 8, seed=0,
                                    storage="uint8")
    check(sorted(top_stream.filenames) == [8], f"levels {sorted(top_stream.filenames)}")
    small = _box_cascade(top_images, 8, round_each=False)
    model, state = build_style_training(cfg_top)
    routes = []
    for i, lod in enumerate(STREAM_HOST_LODS):
        side = 4 * 2 ** lod
        host_lod, got = _host_feed(top_stream, feed, side, top_batch, i)
        check(len(got) == top_steps and all(b.shape == (top_batch, side, side, 3) for b in got),
              f"max-level route at LOD {lod}: {[b.shape for b in got]}")
        check(_rows_match_up_to_flips(np.concatenate(got), small[lod + 2]),
              f"max-level route at LOD {lod}: the epoch's batches are not the box-downscaled "
              f"images up to flips")
        _, intro_lod = build_style_steps(
            model, dataclasses.replace(scfg, beta_neg=float(cfg_top.beta_neg[lod])), lod, False)
        step_lod, _, graphed = _graphed_ms_step(intro_lod, state, feed(got[0], 1.0, False))
        overlap_lod = _prefetched_ms_step(graphed, state, top_stream, feed, side, top_batch, i)
        del intro_lod, graphed
        trainer_lod = top_epochs[i][0] / top_steps
        phase = "vanilla" if i < cfg_top.num_vae else "intro"
        routes.append(f"LOD {lod} ({phase} epoch): trainer {trainer_lod:.3f} ms/step, host feed "
                      f"alone {host_lod:.3f} ms a batch, graphed intro step alone {step_lod:.3f} "
                      f"ms/step; trainer {_bound_by(trainer_lod, host_lod, step_lod)}; the "
                      f"prefetch feeding the captured graph {overlap_lod:.3f} ms/step, "
                      f"{_bound_by(overlap_lod, host_lod, step_lod)}")
    del state, model
    torch.cuda.empty_cache()
    print(f"stream: {STREAM_N} images at levels 2-8 in {STREAM_PARTS} parts written in "
          f"{write_s:.2f} s, both readers bit-equal to the source images at every level; "
          f"reads of level-8 records, a pass each: native over {STREAM_HOST_N} "
          f"{_spread([r for r, _ in rates['native']])} records/s "
          f"{_spread([m for _, m in rates['native']])} MB/s over {len(rates['native'])} "
          f"passes, python over {STREAM_HOST_N // STREAM_HOST_PARTS} "
          f"{_spread([r for r, _ in rates['python']])} records/s "
          f"{_spread([m for _, m in rates['python']], '.2f')} MB/s; {lod6}; max-level route "
          f"(level 8 only, {STREAM_HOST_N} records, batch {top_batch}, {top_steps} steps an "
          f"epoch, each epoch's first 3 steps eager warm-up, then a capture): "
          f"{'; '.join(routes)}; on {card}", flush=True)


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


FOLDER_N = 64          # JPEG files of the folder phase: 8 batches of the celeb256 recipe


def phase_train_folder(device, card: str, results_dir: str):
    """The image trainer on the celeb256 recipe, fed out of core: one intro
    epoch over FOLDER_N seeded 256x256 JPEG files through ``FolderDataset``
    with the host mirror; its decode spans and counters read."""
    import numpy as np
    import torch
    from PIL import Image

    from soft_intro_vae_torch.data.images import DATASETS, FolderDataset, open_image_folder
    from soft_intro_vae_torch.train.image import train_soft_intro_vae
    from soft_intro_vae_torch.utils import profiling

    spec = DATASETS["celeb256"]
    folder = os.path.join(results_dir, "celeb256")
    os.makedirs(folder)
    rng = np.random.default_rng(29)
    for i in range(FOLDER_N):  # smooth blobs plus noise, as SyntheticImages
        base = rng.integers(0, 224, (8, 8, 3), dtype=np.uint8)
        img = np.kron(base, np.ones((32, 32, 1), np.uint8)) + rng.integers(0, 32, (256, 256, 3),
                                                                           dtype=np.uint8)
        Image.fromarray(img).save(os.path.join(folder, f"{i:05d}.jpg"), quality=95)
    ds = open_image_folder(folder, spec.image_size, seed=0, max_resident_bytes=0, storage="uint8")
    check(isinstance(ds, FolderDataset), f"the folder opened as {type(ds).__name__}")
    cfg = image_config(device, results_dir, dataset="celeb256", z_dim=256, batch_size=8,
                       beta_kl=0.5, beta_neg=1024.0, num_epochs=1, num_vae=0,
                       mirror_augment=True, matmul_precision="float32")
    steps = FOLDER_N // cfg.batch_size
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0_ns = time.perf_counter_ns()
    state, summary = train_soft_intro_vae(cfg, ds, spec)
    torch.cuda.synchronize()
    run_s = (time.perf_counter_ns() - t0_ns) / 1e9
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    decodes = [s for s in profiling.spans(t0_ns) if s.name == "feed.decode"]
    counts = read_counts()
    check(summary["steps"] == state.step == steps and counts["u8norm"] == steps,
          f"folder run: {summary['steps']} steps, u8norm launches {counts['u8norm']}, "
          f"expected {steps}")
    check([s.batch for s in decodes] == list(range(steps)),
          f"feed.decode spans of batches {[s.batch for s in decodes]}, expected 0..{steps - 1}")
    files = sorted(os.listdir(folder))
    check(ds.decoded_images == FOLDER_N and ds.decoded_bytes == sum(
        os.path.getsize(os.path.join(folder, f)) for f in files),
          f"folder counters: {ds.decoded_images} images, {ds.decoded_bytes} bytes")
    check(all(math.isfinite(v) for v in summary["last_metrics"].values()),
          f"non-finite folder metrics: {summary['last_metrics']}")
    decode_ms = sorted(s.dur_ns / 1e6 for s in decodes)
    del state
    print(f"train folder: celeb256 recipe width (channels {'/'.join(map(str, spec.channels))}, "
          f"256x256, z 256, batch 8, beta_neg 1024, f32, mirror) from {FOLDER_N} JPEG files "
          f"({ds.decoded_bytes / FOLDER_N / 1e3:.1f} KB each) through FolderDataset: {steps} "
          f"intro steps in {run_s:.2f} s (warm-up and capture included), peak "
          f"{peak:.3f} GiB; feed.decode spans one a batch, {decode_ms[len(decode_ms) // 2]:.2f} ms "
          f"median ({decode_ms[0]:.2f}-{decode_ms[-1]:.2f}) over {cfg.batch_size} files; "
          f"counters {ds.decoded_images} images, {ds.decoded_bytes} bytes; on {card}",
          flush=True)


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
    from soft_intro_vae_torch.train.style import train_style_soft_intro_vae

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

        # the style trainer on this route: its prefetch worker's side-stream
        # copies and table lookups run beside the replays' all-reduces
        st_cfg = style_config(device, os.path.join(results_dir, "nccl_style"), STYLE_TRAIN_OPTS)
        st_steps = st_cfg.synthetic_n // st_cfg.lod_2_batch_tables["1GPU"][st_cfg.layer_count - 1]
        reset_counts()
        t0 = time.perf_counter()
        st_state, st_summary = train_style_soft_intro_vae(st_cfg)
        torch.cuda.synchronize()
        st_run_s = time.perf_counter() - t0
        st_counts = read_counts()
        st_want = style_step_launches(st_cfg.layer_count - 1, st_steps, st_steps)
        check((st_counts["bias_act_norm_fwd"], st_counts["bias_act_norm_bwd"]) == st_want,
              f"dp style run: fused-norm launches {st_counts}, expected {st_want}")
        check(st_summary["steps"] == st_state.step == 2 * st_steps,
              f"dp style run: {st_summary['steps']} steps")
        check(st_counts["nccl_metrics"] == 2 * st_steps and st_counts["nccl_grads"] > 0,
              f"dp style run: collectives on the device {st_counts}")
        st_last = st_summary["last_metrics"]
        check(all(math.isfinite(v) for v in st_last.values()), f"non-finite dp style metrics: "
              f"{st_last}")
        st_nccl = {k: v for k, v in st_counts.items() if k.startswith("nccl_") and v}
        del st_state
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
            f"the style trainer at that width with its prefetched feed: {st_steps} vanilla + "
            f"{st_steps} intro steps in {st_run_s:.2f} s, fused-norm launches "
            f"{st_counts['bias_act_norm_fwd']} / {st_counts['bias_act_norm_bwd']} (expected "
            f"{st_want[0]} / {st_want[1]}), collectives on the device {st_nccl}, loss_e "
            f"{st_last['loss_e']:.6g}; on {card}")


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
    want_blur = sum(style_blur_launches(lod, steps, steps, remat=True))
    check(counts["blur3x3"] == want_blur,
          f"remat blur launches {counts['blur3x3']}, expected {want_blur}")
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
        blur_step = sum(style_blur_launches(lod, 0, 1, remat=c.remat))
        blur_got, blur_rec = counts["blur3x3"], captured.get("blur3x3")
        check(got == want and rec == per_step and blur_got == n * blur_step
              and blur_rec == blur_step,
              f"graph style {name}: fused-norm launches on the device {got} (expected {want}), "
              f"recorded in the capture {rec} (expected {per_step}); blur launches on the "
              f"device {blur_got} (expected {n * blur_step}), recorded {blur_rec} (expected "
              f"{blur_step})")
        parts.append(f"{name}: all {compared} tensors bit-equal, fused-norm launches captured "
                     f"{rec[0]} / {rec[1]}, on the device {got[0]} / {got[1]}; blur launches "
                     f"captured {blur_rec}, on the device {blur_got}")

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


API_TILE = 512
API_SHAPES = ((32, 2048, 2048), (32, 16384, 16384))  # (B, N preds, M gts): the 3D recipe, 8x
API_RTOL_VALUE = 1e-6   # chamfer values, tiled against the kernel route
API_RTOL_GRAD = 1e-5    # gradients, of their largest element
API_RTOL_SEPARABLE = 1e-5
API_RTOL_PRIMITIVES = 1e-6


def _rel_to_max(got, want) -> float:
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return float((got - want).abs().max()
                 / want.abs().max().clamp_min(1e-30))


def _api_chamfer(device, gen, b: int, n: int, m: int, grads: bool) -> str:
    import torch

    from soft_intro_vae_torch.ops import chamfer

    preds, gts = clouds(gen, b, n, m, device)
    w = torch.randn(b, generator=gen, device=device)
    routes = {"tiled": lambda p, g: chamfer.chamfer_distance_tiled(p, g, tile=API_TILE),
              "kernel": lambda p, g: chamfer.chamfer_distance(p, g, impl="cuda")}
    values, peaks, grad = {}, {}, {}
    for name, fn in routes.items():
        p = preds.clone().requires_grad_(grads)
        g = gts.clone().requires_grad_(grads)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with torch.set_grad_enabled(grads):
            values[name] = fn(p, g)
            if grads:
                (values[name] * w).sum().backward()
                grad[name] = (p.grad, g.grad)
        torch.cuda.synchronize()
        peaks[name] = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    tiled, kernel = values["tiled"].detach(), values["kernel"].detach()
    check(bool(torch.isfinite(tiled).all()) and tiled.shape == (b,),
          f"tiled chamfer at {(b, n, m)}: not finite or not (B,)")
    err = float(((tiled - kernel).abs() / kernel.abs()).max())
    check(err <= API_RTOL_VALUE, f"tiled chamfer at {(b, n, m)}: rel {err:.3e} from the kernel "
          f"route (bound {API_RTOL_VALUE})")
    text = f"{(b, n, m)}: values rel {err:.2e}"
    if grads:
        errs = [_rel_to_max(a, k) for a, k in zip(grad["tiled"], grad["kernel"])]
        check(max(errs) <= API_RTOL_GRAD, f"tiled chamfer gradients at {(b, n, m)}: "
              f"{errs} of their largest from the kernel route (bound {API_RTOL_GRAD})")
        text += f", gradients {errs[0]:.2e} (preds) {errs[1]:.2e} (gts) of their largest"
    with torch.no_grad():
        iters = 3 if n * m > 2 ** 24 else 10
        t_tiled = cuda_ms(lambda: routes["tiled"](preds, gts), iters=iters, warmup=1)
        t_kernel = cuda_ms(lambda: routes["kernel"](preds, gts), iters=iters, warmup=1)
    dense_gb = b * n * m * 4 / 1e9
    passes = "forward + backward" if grads else "forward"
    return (f"{text}; forward ms tiled {t_tiled:.3f}, kernel route {t_kernel:.3f} "
            f"({t_tiled / t_kernel:.1f}x); peak GiB over the inputs, {passes}: "
            f"tiled {peaks['tiled']:.3f}, kernel route {peaks['kernel']:.3f} (one dense "
            f"(B, N, M) f32 temporary: {dense_gb:.1f} GB)")


def _api_separable(device, gen) -> str:
    import torch

    from soft_intro_vae_torch.models import lreq

    parts = []
    for cls, shape, stride, pad in ((lreq.LreqSeparableConv2d, (4, 64, 64, 64), 1, 1),
                                    (lreq.LreqSeparableConvTranspose2d, (4, 64, 32, 32), 2, 1)):
        torch.manual_seed(14)
        cpu = cls(shape[1], 128, kernel_size=3, stride=stride, padding=pad)
        with torch.no_grad():
            cpu.pointwise.bias.normal_()
        card = cls(shape[1], 128, kernel_size=3, stride=stride, padding=pad).to(device)
        card.load_state_dict(cpu.state_dict())
        x = torch.randn(shape, generator=gen, device=device)
        errs, outs, cots = {}, {}, {}
        for where, layer, xi in (("cpu", cpu, x.cpu()), ("card", card, x)):
            xi = xi.clone().requires_grad_(True)
            y = layer(xi)
            cot = cots.setdefault(tuple(y.shape), torch.randn(
                y.shape, generator=gen, device=device)).to(xi.device)
            (y * cot).sum().backward()
            outs[where] = [y, xi.grad] + [p.grad for p in layer.parameters()]
        names = ["y", "dx"] + [n for n, _ in cpu.named_parameters()]
        for name, got, want in zip(names, outs["card"], outs["cpu"]):
            errs[name] = _rel_to_max(got, want)
        worst = max(errs, key=errs.get)
        check(errs[worst] <= API_RTOL_SEPARABLE, f"{cls.__name__} on the card: {worst} "
              f"{errs[worst]:.3e} of its largest from the CPU (bound {API_RTOL_SEPARABLE})")
        parts.append(f"{cls.__name__} {tuple(shape)} -> {tuple(outs['card'][0].shape)} worst "
                     f"{worst} {errs[worst]:.2e}")
    return "; ".join(parts)


def _api_primitives(device, gen) -> str:
    import torch

    from soft_intro_vae_torch.models.conv import avg_pool_2x, upsample_nearest_2x
    from soft_intro_vae_torch.models.style import instance_norm, style_mod

    x = torch.randn((4, 64, 32, 32), generator=gen, device=device) * 2.0 + 0.5
    s = torch.randn((4, 128), generator=gen, device=device)
    xl = x.contiguous(memory_format=torch.channels_last)
    cases = {"style_mod": style_mod,
             "instance_norm": lambda a, t: instance_norm(a, 1e-8),
             "avg_pool_2x": lambda a, t: avg_pool_2x(a),
             "upsample_nearest_2x": lambda a, t: upsample_nearest_2x(a)}
    errs = {}
    for name, fn in cases.items():
        for a in (x, xl):
            errs[name] = max(errs.get(name, 0.0), _rel_to_max(fn(a, s), fn(a.cpu(), s.cpu())))
    worst = max(errs, key=errs.get)
    check(errs[worst] <= API_RTOL_PRIMITIVES, f"{worst} on the card: {errs[worst]:.3e} from "
          f"the CPU (bound {API_RTOL_PRIMITIVES})")
    return ", ".join(f"{k} {v:.1e}" for k, v in errs.items())


def phase_api(device, card: str) -> None:
    import torch

    import soft_intro_vae_torch.metrics as metrics
    import soft_intro_vae_torch.models as models
    import soft_intro_vae_torch.ops as ops
    import soft_intro_vae_torch.parallel as parallel
    import soft_intro_vae_torch.train as train

    exported = sum(len(m.__all__) for m in (ops, models, metrics, train, parallel))
    check(all(hasattr(m, n) for m in (ops, models, metrics, train, parallel) for n in m.__all__),
          "a subpackage lacks a name of its __all__")
    gen = torch.Generator(device=device)
    gen.manual_seed(14)
    with no_tf32():
        lines = [_api_chamfer(device, gen, *API_SHAPES[0], grads=True),
                 _api_chamfer(device, gen, *API_SHAPES[1], grads=False),
                 _api_separable(device, gen), _api_primitives(device, gen)]
    print(f"api: chamfer_distance_tiled (tile {API_TILE}) against chamfer_distance(impl='cuda'), "
          f"TF32 off, {card}: {lines[0]}", flush=True)
    print(f"api: chamfer_distance_tiled {lines[1]}", flush=True)
    print(f"api: separable lreq convs, card against CPU, forward and gradients: {lines[2]}; "
          f"primitives, card against CPU, NCHW and channels-last, of their largest: {lines[3]}; "
          f"{exported} names exported by ops, models, metrics, train, parallel", flush=True)


# the resume and carry phases: the port's own resume at full width, and the
# JAX package's checkpoints (tests/torch_port_fixtures/jax_checkpoints/,
# written by make_jax_checkpoints.py there) continued through the kernels
FIXTURES = os.path.join(ROOT, "tests", "torch_port_fixtures", "jax_checkpoints")
RESUME_STYLE_OPTS = ["DATASET.SYNTHETIC", "true", "DATASET.SYNTHETIC_N", "512",
                     "TRAIN.EPOCHS_PER_LOD", "4", "TRAIN.TRAIN_EPOCHS", "6"]
RESUME_STYLE_AT = 4    # LOD 1's first epoch: the transition runs over epochs 4 and 5
RESUME_TOY_AT = 150    # iterations before the toy checkpoint: 100 vanilla, 50 intro
CARRY_RTOL = {"threed": 1e-4, "style": 1e-3}  # the kernel routes' bounds (phases 4, 7)
CARRY_JSD_ATOL = 1e-6


def train_state_snapshot(state) -> dict:
    """A generic train state's tensors: the nets (BN buffers included), both
    Adams' moments and counts, the LRs, the step and the generator's state."""
    return {"model": state.model.state_dict(), "opt_e": state.opt_e.state_dict()["state"],
            "opt_d": state.opt_d.state_dict()["state"], "lr": [state.lr_e, state.lr_d],
            "step": state.step, "generator": state.generator.get_state()}


def resumed_against_straight(name: str, straight, resumed, snapshot, kernel=None) -> str:
    """Run ``straight()`` (the whole course, writing its checkpoints) and
    ``resumed()`` (a fresh trainer call from one of them), each returning its
    final state, under exact routes; fail unless each side captured a graph
    and launched ``kernel`` (where the path has one) and the two final states
    are bit-equal. Returns the phase's line part: captures and launches a side."""
    import torch

    from soft_intro_vae_torch.utils.checkpoint import to_host

    sides = {}
    for side, run in (("straight", straight), ("resumed", resumed)):
        torch.cuda.empty_cache()
        reset_counts()
        graphs = captured_graphs()
        t0 = time.perf_counter()
        with exact_routes(deterministic_algorithms=True):
            state = run()
            torch.cuda.synchronize()
        sides[side] = (to_host(snapshot(state)), time.perf_counter() - t0,
                       captured_graphs() - graphs,
                       {k: v for k, v in read_counts().items() if v})
        del state
        check(sides[side][2] > 0 and (kernel is None or sides[side][3].get(kernel, 0) > 0),
              f"resume {name}, {side}: {sides[side][2]} graphs captured, launches {sides[side][3]}")
    differ = []
    compared = _tensors_equal(sides["straight"][0], sides["resumed"][0], name, differ)
    check(not differ, f"resume {name}: {len(differ)} of {compared} tensors differ from the "
          f"straight run (first {differ[:6]})")
    return (f"{name}: all {compared} tensors bit-equal; " + ", ".join(
        f"{side} {s:.2f} s, {g} graphs captured, launches {c or 'none'}"
        for side, (_, s, g, c) in sides.items()))


def phase_resume(device, card: str, results_dir: str) -> None:
    """Each trainer's course straight, against the same course resumed from
    one of its checkpoints by a fresh trainer call, both under exact routes:
    final weights, optimizer state, step and generator state bit-equal. The
    checkpoint is written by the straight run after graph replays (the
    trainers' async saves snapshot the state at the call), and the resumed
    call starts with eager warm-up steps and a capture where the straight
    run replays."""
    import shutil

    from soft_intro_vae_torch.data.toy import ToyDataset
    from soft_intro_vae_torch.train import style
    from soft_intro_vae_torch.train.image import train_soft_intro_vae
    from soft_intro_vae_torch.train.threed import ThreeDConfig, train_soft_intro_vae_3d
    from soft_intro_vae_torch.train.toy import ToyConfig, train_soft_intro_vae_toy
    from tools.torch_profile_toy import RECIPE

    def place(src: str, dst_dir: str, names, pointer: bool = False) -> None:
        os.makedirs(dst_dir, exist_ok=True)
        for n in names:
            shutil.copy(os.path.join(src, n), dst_dir)
        if pointer:
            with open(os.path.join(dst_dir, "last_checkpoint"), "w") as f:
                f.write(names[0])

    parts = []
    # 3D at configs/soft_intro_vae_hp.json: 2 intro epochs of 8 steps, the
    # second resumed from the first's checkpoint
    run3d = os.path.join(results_dir, "3d")
    cfg = dataclasses.replace(
        ThreeDConfig.from_json(os.path.join(ROOT, "configs", "soft_intro_vae_hp.json")),
        use_synthetic=True, synthetic_n=TRAIN_N, max_epochs=2, valid_frequency=10**6,
        save_frequency=1, seed=0, resume=True, verbose=False, device=str(device))

    def resumed_3d():
        place(os.path.join(run3d, "straight", "weights"), os.path.join(run3d, "resumed", "weights"),
              ["model_epoch_1_iter_0.ckpt"])
        return train_soft_intro_vae_3d(dataclasses.replace(
            cfg, results_dir=os.path.join(run3d, "resumed")))[0]

    parts.append(resumed_against_straight(
        "3d (2048 points, batch 32, z 128; epoch 2 resumed)",
        lambda: train_soft_intro_vae_3d(dataclasses.replace(
            cfg, results_dir=os.path.join(run3d, "straight")))[0],
        resumed_3d, train_state_snapshot, "chamfer_nearest"))
    shutil.rmtree(run3d)

    # the CIFAR-10 recipe at scan_steps 8 on uint8 images: a vanilla and an
    # intro epoch, the intro epoch resumed as ``pretrained`` + ``start_epoch``
    spec, ds = image_dataset()
    cfg = image_config(device, os.path.join(results_dir, "image"), scan_steps=IMAGE_SCAN,
                       save_interval=1)
    steps = len(ds) // cfg.batch_size
    saved = os.path.join(cfg.result_dir, "saves", f"cifar10_soft_intro_betas_1.0_256.0_1.0_"
                                                  f"model_epoch_1_iter_{steps}.ckpt")
    parts.append(resumed_against_straight(
        "image (CIFAR-10 recipe, scan_steps 8, u8norm; epoch 1 resumed)",
        lambda: train_soft_intro_vae(cfg, ds, spec)[0],
        lambda: train_soft_intro_vae(dataclasses.replace(
            cfg, pretrained=saved, start_epoch=1, result_dir=cfg.result_dir + "_resumed"),
            ds, spec)[0], train_state_snapshot, "u8norm"))
    shutil.rmtree(cfg.result_dir)
    shutil.rmtree(cfg.result_dir + "_resumed")

    # the style trainer at ffhq256 width across LOD 0 -> 1, resumed from the
    # end of epoch 4, the middle of LOD 1's blended transition
    cfg = style_config(device, os.path.join(results_dir, "style"), RESUME_STYLE_OPTS)
    cfg = dataclasses.replace(cfg, resume=True)
    batch = cfg.lod_2_batch_tables["1GPU"][1]
    name = (f"{cfg.name}_model_epoch_{RESUME_STYLE_AT}_iter_"
            f"{(RESUME_STYLE_AT + 1) * cfg.synthetic_n // batch}.ckpt")
    arts = os.path.join(cfg.output_dir, "training_artifacts")

    def resumed_style():
        out = cfg.output_dir + "_resumed"
        place(arts, os.path.join(out, "training_artifacts"), [name, name + ".aux.json"],
              pointer=True)
        shutil.rmtree(cfg.output_dir)  # ~0.65 GB a checkpoint
        state, summary = style.train_style_soft_intro_vae(dataclasses.replace(cfg, output_dir=out))
        check(summary["lods_seen"] == [0, 1] and summary["blended_steps"] == summary["steps"] > 0,
              f"resumed style run: {summary['lods_seen']}, {summary['blended_steps']} blended "
              f"of {summary['steps']} steps")
        return state

    parts.append(resumed_against_straight(
        "style (ffhq256 width, LODs 0-1, batch 128; epoch 5, the second of LOD 1's blended "
        "transition, resumed)",
        lambda: style.train_style_soft_intro_vae(cfg)[0], resumed_style,
        lambda state: style_snapshot(state, []), "bias_act_norm_fwd"))
    shutil.rmtree(cfg.output_dir + "_resumed")

    # the toy CLI recipe: 300 iterations, 100 vanilla; the last 150 resumed as
    # ``pretrained``, with the sampler at the straight run's point
    cfg = ToyConfig(n_iter=TOY_ITERS, num_vae=TOY_NUM_VAE, test_iter=100, seed=0,
                    save_checkpoints=True, save_interval=RESUME_TOY_AT - 1,
                    result_dir=os.path.join(results_dir, "toy"), device=str(device),
                    verbose=False, **RECIPE)

    def resumed_toy():
        sampler = ToyDataset(distr=cfg.dataset, seed=cfg.seed)
        for _ in range(RESUME_TOY_AT):
            sampler.next_batch(batch_size=cfg.batch_size)
        saved = os.path.join(cfg.result_dir, "saves",
                             f"model_epoch_{RESUME_TOY_AT - 1}_iter_{RESUME_TOY_AT - 1}.ckpt")
        return train_soft_intro_vae_toy(dataclasses.replace(
            cfg, pretrained=saved, n_iter=TOY_ITERS - RESUME_TOY_AT, save_checkpoints=False,
            num_vae=max(0, TOY_NUM_VAE - RESUME_TOY_AT)), sampler)[0]

    parts.append(resumed_against_straight(
        f"toy (CLI recipe, {TOY_ITERS} iterations; the last {TOY_ITERS - RESUME_TOY_AT} resumed)",
        lambda: train_soft_intro_vae_toy(cfg)[0], resumed_toy, train_state_snapshot))
    shutil.rmtree(cfg.result_dir)
    print(f"resume: each trainer straight against resumed from its checkpoint by a fresh call "
          f"(TF32 off, deterministic): " + "; ".join(parts) + f"; on {card}", flush=True)


def _recorded(name: str) -> dict:
    import numpy as np

    with np.load(os.path.join(FIXTURES, name, "next_steps.npz")) as z:
        return {k: z[k] for k in z.files}


def _carry(step, state, ckpt, xs, args) -> tuple:
    """The recorded steps after a JAX checkpoint as graph replays: the
    checkpoint loaded, warm-up steps and the capture on the first batch, the
    checkpoint loaded again into the same tensors, then one replay a batch.
    Returns (metrics of the replays, device launches, graphs captured by them)."""
    import torch

    from soft_intro_vae_torch.train.graph import WARMUP_STEPS

    ckpt.load_latest(state)
    for _ in range(WARMUP_STEPS + 1):
        step(state, xs[0], *args[0])
    ckpt.load_latest(state)
    reset_counts()
    graphs = captured_graphs()
    ms = [{k: float(v) for k, v in step(state, x, *a)[1].items()} for x, a in zip(xs, args)]
    torch.cuda.synchronize()
    return ms, read_counts(), captured_graphs() - graphs


def phase_carry(device, card: str) -> None:
    """The JAX package's checkpoints continued on the card: a 3D state at
    narrow widths and 256 points through the chamfer kernel, a style state at
    LOD 1 through the fused-norm kernels, each loaded by ``Checkpointer.
    load_latest`` from the directory holding it and run on for the 2 steps
    JAX recorded beside it, as replays of the trainers' graphed step; the
    losses held to JAX's (CPU) within the kernel routes' bounds. Then
    eval_3d's sweep over the two 3D files on JAX's prior draws: JAX's pick,
    its JSD within 1e-6."""
    import numpy as np
    import torch

    from soft_intro_vae_torch.cli import eval_3d
    from soft_intro_vae_torch.train.graph import one_step
    from soft_intro_vae_torch.train.step import INTRO_NOISES
    from soft_intro_vae_torch.train.style import StyleConfig, build_style_training
    from soft_intro_vae_torch.train.style_step import NZ_KEYS, StyleStepConfig, build_style_steps
    from soft_intro_vae_torch.train.threed import ThreeDConfig, build_3d_training
    from soft_intro_vae_torch.utils.checkpoint import Checkpointer

    def losses_line(name, ms, rec):
        rel = max(abs(m[k] / float(rec[f"metric_{k}"][i]) - 1)
                  for i, m in enumerate(ms) for k in ("loss_e", "loss_d"))
        check(rel <= CARRY_RTOL[name], f"carry {name}: losses {ms} against JAX's "
              f"{[(float(rec['metric_loss_e'][i]), float(rec['metric_loss_d'][i])) for i in (0, 1)]}")
        return rel

    parts = []
    directory = os.path.join(FIXTURES, "threed")
    rec = _recorded("threed")
    cfg = dataclasses.replace(
        ThreeDConfig.from_json(os.path.join(ROOT, "configs", "soft_intro_vae_hp.json")),
        **json.loads(str(rec["config"])), device=str(device))
    state, _, intro = build_3d_training(cfg)
    xs = [torch.from_numpy(x).to(device) for x in rec["x"]]
    args = [({k: torch.from_numpy(rec[f"draw_{k}"][i]).to(device) for k in INTRO_NOISES},)
            for i in range(2)]
    with exact_routes():
        ms, counts, graphs = _carry(intro, state, Checkpointer(directory), xs, args)
    check(counts["chamfer_nearest"] == 12 and graphs == 0 and state.step == 6,
          f"carry threed: chamfer launches {counts['chamfer_nearest']} in 2 replays (expected "
          f"12), {graphs} graphs captured by them, step {state.step}")
    rel = losses_line("threed", ms, rec)
    parts.append(f"3D (PointNet widths {cfg.conv_channels}/{cfg.hidden}, {cfg.n_points} points, "
                 f"batch {cfg.batch_size}, from model_epoch_2_iter_4.ckpt): 2 replays, losses "
                 f"within rel {rel:.2e} of JAX's (bound {CARRY_RTOL['threed']:g}), chamfer_nearest "
                 f"launches {counts['chamfer_nearest']}")

    # eval_3d's sweep over both 3D files, on the JAX package's draws
    names = sorted(k[len("jsd_"):] for k in rec if k.startswith("jsd_") and k != "jsd_noise")
    want = min(names, key=lambda n: float(rec["jsd_" + n]))
    with no_tf32():
        path, jsd = eval_3d.find_best_epoch(cfg, directory, noises=list(rec["jsd_noise"]))
    check(os.path.basename(path) == want
          and abs(jsd - float(rec["jsd_" + want])) <= CARRY_JSD_ATOL,
          f"eval_3d sweep: {os.path.basename(path)} jsd {jsd!r}, JAX's {want} "
          f"{float(rec['jsd_' + want])!r}")
    parts.append(f"eval_3d sweep over {len(names)} JAX files: {want} as JAX picks it, JSD "
                 f"{jsd:.6f} (JAX {float(rec['jsd_' + want]):.6f})")
    del state, intro

    directory = os.path.join(FIXTURES, "style")
    rec = _recorded("style")
    over = json.loads(str(rec["config"]))
    lod = over.pop("lod")
    over.pop("ema_beta")
    cfg = dataclasses.replace(StyleConfig(), **over, device=str(device))
    model, state = build_style_training(cfg)
    scfg = StyleStepConfig(latent_size=cfg.latent_space_size, beta_rec=cfg.beta_rec,
                           beta_kl=cfg.beta_kl, beta_neg=float(cfg.beta_neg[lod]),
                           gamma_r=1e-8, scale=cfg.scale)
    intro = one_step(build_style_steps(model, scfg, lod, False, noise_mode="none")[1])
    xs = [torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))).to(device)
          for x in rec["x"]]
    args = [(1.0, {k: torch.from_numpy(rec[f"draw_{k}"][i]).to(device) for k in NZ_KEYS})
            for i in range(2)]
    with exact_routes():
        ms, counts, graphs = _carry(intro, state, Checkpointer(directory), xs, args)
    fwd, bwd = (2 * n for n in style_step_launches(lod, 0, 1))
    check((counts["bias_act_norm_fwd"], counts["bias_act_norm_bwd"]) == (fwd, bwd)
          and graphs == 0 and state.step == 4,
          f"carry style: fused-norm launches {counts} in 2 replays (expected {fwd}/{bwd}), "
          f"{graphs} graphs captured by them, step {state.step}")
    rel = losses_line("style", ms, rec)
    parts.append(f"style (LOD {lod}, channels {cfg.start_channel_count}-{cfg.max_channel_count}, "
                 f"latent {cfg.latent_space_size}, f32, from {cfg.name}_model_epoch_2_iter_2.ckpt): "
                 f"2 replays, losses within rel {rel:.2e} of JAX's (bound {CARRY_RTOL['style']:g}), "
                 f"bias_act_norm launches fwd {counts['bias_act_norm_fwd']} / bwd "
                 f"{counts['bias_act_norm_bwd']}")
    print(f"carry: JAX checkpoints loaded by Checkpointer.load_latest, warm-up steps and the "
          f"capture, the checkpoint loaded again into the graph's tensors, then JAX's next 2 "
          f"steps as replays (TF32 off): " + "; ".join(parts) + f"; on {card}", flush=True)



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
    blur_record = phase_blur(device, peaks)
    lap("kernels chamfer, fused norm and blur")
    # the trainers' checkpoints (~100 MB for 3D, ~0.65 GB for style) go to
    # directories removed afterwards
    with tempfile.TemporaryDirectory(prefix="results_chip_smoke_", dir=ROOT) as results_dir:
        counts_3d = phase_train_3d(device, card, results_dir)
    lap("train 3d")
    phase_graph_3d(device)
    lap("graph 3d")
    with tempfile.TemporaryDirectory(prefix="results_chip_smoke_", dir=ROOT) as style_dir:
        cfg, counts_style = phase_style_train(device, card, style_dir)
        _, mix = phase_style_step(device, card, cfg)
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
        phase_stream(device, card, results_dir)
    lap("stream")
    u8 = phase_u8norm(device, peaks)
    with tempfile.TemporaryDirectory(prefix="results_chip_smoke_", dir=ROOT) as results_dir:
        cfg_image, counts_image, _ = phase_train_image(device, card, results_dir)
    phase_image_routes(device, dataclasses.replace(cfg_image, scan_steps=1))
    with tempfile.TemporaryDirectory(prefix="results_chip_smoke_", dir=ROOT) as results_dir:
        phase_train_folder(device, card, results_dir)
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
    phase_api(device, card)
    lap("api")
    with tempfile.TemporaryDirectory(prefix="results_chip_smoke_", dir=ROOT) as results_dir:
        phase_resume(device, card, results_dir)
    lap("resume")
    phase_carry(device, card)
    lap("carry")
    print(f"timing (s): {', '.join(laps)}; build to last phase "
          f"{time.perf_counter() - began:.1f}", flush=True)
    chamfer["launches"] = counts_3d["chamfer_nearest"]
    records = [chamfer] + norm_records(worst, times, peaks, totals)
    for rec in records[1:]:
        rec["launches"] = counts_style[rec["name"]]
    blur_record["launches"] = counts_style["blur3x3"]
    u8["launches"] = counts_image["u8norm"]
    records += [blur_record, u8]
    print(json.dumps({"kernels": records}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
