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
              lower bound: the chamfer search (bit-equal), and the fused
              bias/leaky-ReLU/instance-norm/AdaIN forward and backward in
              every mode, f32 and bf16;
  4. train 3d: ``train_soft_intro_vae_3d`` at the full width of
              configs/soft_intro_vae_hp.json (2048 points, batch 32, z 128) on
              synthetic clouds for one intro epoch plus the valid JSD, every
              kernel's launch count read around it; the step time after
              warm-up; one step through the kernel against the plain route;
  5. train style: ``train_style_soft_intro_vae`` at the full width of
              configs/ffhq256.yaml (7 blocks, 64->512 channels, latent 512,
              bf16) at LOD 6 (256x256, batch 4) on synthetic images, one
              vanilla and one intro epoch, every kernel's launch count read
              around it and held to the count the steps imply;
  6. step style: ms per LOD-6 intro step after warm-up;
  7. routes style: one f32 intro step through the kernels against one
              through the plain version, from the same weights and draws;
  8. transition style: LOD 0 -> 1 through a blended epoch.
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


def phase_kernels(device, peak_name, peaks):  # the chamfer kernel
    """chamfer_nearest against nearest_plain: equal minima and argmins both ways."""
    import torch

    from soft_intro_vae_torch.ops import chamfer, chamfer_cuda

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    cases = [(32, 2048, 2048), (3, 48, 96), (1, 24, 24), (2, 2047, 1000)]
    pairs = [clouds(gen, *c, device) for c in cases]
    same = clouds(gen, 2, 512, 512, device)[0]
    pairs.append((same, same.clone()))
    max_err = 0.0
    for preds, gts in pairs:
        for a, b in ((gts, preds), (preds, gts)):
            d_k, i_k = chamfer_cuda.nearest_cuda(a, b)
            d_p, i_p = chamfer.nearest_plain(a, b)
            torch.cuda.synchronize()
            shape = (tuple(a.shape), tuple(b.shape))
            check(torch.equal(d_k, d_p), f"chamfer_nearest minima differ at {shape}: "
                  f"max |diff| {(d_k - d_p).abs().max().item()}")
            check(torch.equal(i_k, i_p), f"chamfer_nearest argmins differ at {shape}: "
                  f"{(i_k != i_p).sum().item()} of {i_k.numel()}")
            max_err = max(max_err, (d_k - d_p).abs().max().item())
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

    # times at the main path's shape: one chamfer call's search, both directions
    preds, gts = pairs[0]
    bsz, n, _ = gts.shape
    m = preds.shape[1]

    def kernel():
        chamfer_cuda.nearest_cuda(gts, preds)
        chamfer_cuda.nearest_cuda(preds, gts)

    def plain():
        chamfer.nearest_plain(gts, preds)
        chamfer.nearest_plain(preds, gts)

    def library():
        d = torch.cdist(gts, preds, compute_mode="donot_use_mm_for_euclid_dist").square()
        d.min(dim=2)
        d.min(dim=1)

    # turns: plain, kernel, kernel, plain; the mean of each pair
    t_plain_1 = cuda_ms(plain, iters=5)
    t_kernel_1 = cuda_ms(kernel)
    t_kernel_2 = cuda_ms(kernel)
    t_plain_2 = cuda_ms(plain, iters=5)
    t_lib = cuda_ms(library, iters=5)
    t_launch = cuda_ms(lambda: chamfer_cuda.nearest_cuda(gts, preds))
    flop = 8.0 * bsz * n * m                       # one distance per pair, as the TPU kernel
    nbytes = 4 * 3 * bsz * (n + m) + (4 + 8) * bsz * (n + m)  # clouds in, min+argmin out
    t_ops = flop / peaks[0] * 1e3
    t_bytes = nbytes / peaks[1] * 1e3
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
    }
    print(f"kernels: chamfer_nearest equal to nearest_plain (minima and argmins, both "
          f"directions) at {cases} and identical clouds; loss/grads match dense autograd; "
          f"at (32,2048,2048) one search of both directions: kernel {t_kernel_1:.4f}/"
          f"{t_kernel_2:.4f} ms, one launch {t_launch:.4f} ms, plain {t_plain_1:.4f}/"
          f"{t_plain_2:.4f} ms, cdist {t_lib:.4f} ms, bound {record['bound_ms']:.4f} ms "
          f"({record['bound_by']}; {peak_name} {peaks[0] / 1e12:.0f} TFLOP/s FP32, "
          f"{peaks[1] / 1e12:.2f} TB/s)", flush=True)
    return record


def phase_build() -> str:
    """nvcc builds every kernel library of the checkout, one process per source,
    all started together."""
    from soft_intro_vae_torch.ops import adain_cuda, chamfer_cuda, cuda_build

    t0 = time.perf_counter()
    paths = cuda_build.build_many([chamfer_cuda.spec(), adain_cuda.spec()])
    chamfer_cuda.load()
    adain_cuda.load()
    parts = [f"{os.path.basename(spec[0])}: {cuda_build.ptxas_summary(path)}"
             for spec, path in zip((chamfer_cuda.spec(), adain_cuda.spec()), paths)]
    return (f"build: chamfer_nearest.cu and bias_act_norm.cu in "
            f"{time.perf_counter() - t0:.2f} s (in parallel); " + " || ".join(parts))


# fused-norm cases: the ffhq256 LOD-6 extremes and an odd shape, in every mode
NORM_SHAPES = ((4, 64, 256, 256), (4, 512, 4, 4), (4, 512, 2, 2), (3, 5, 7, 9))
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


def phase_norm_kernels(device):
    """bias_act_norm forward and backward kernels against their plain versions."""
    import torch
    import torch.nn.functional as F

    from soft_intro_vae_torch.ops import adain, adain_cuda

    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    kw = dict(eps=1e-8, slope=0.2, corr_scale=2.0)
    worst = {"fwd": 0.0, "bwd": 0.0, "fwd_rel": 0.0, "bwd_rel": 0.0}

    def note(key, errs):
        worst[key] = max(worst[key], errs[0])
        worst[key + "_rel"] = max(worst[key + "_rel"], errs[1])

    for dtype in (torch.float32, torch.bfloat16):
        low = dtype == torch.bfloat16
        for shape in NORM_SHAPES:
            for mode, affine in NORM_MODES:
                x, a, cot = _norm_inputs(gen, shape, mode, affine, dtype, device)
                case = f"{mode}{'/affine' if affine else ''} {tuple(shape)} {dtype}"
                fk = adain_cuda.forward(x, a["bias"], a["g"], a["b"], a["n"], a["nw"],
                                        mode=mode, **kw)
                fp = adain.bias_act_norm_plain(x, a["bias"], a["g"], a["b"], a["n"], a["nw"],
                                               mode=mode, **kw)
                torch.cuda.synchronize()
                check(fk[0].dtype == dtype, f"forward {case}: y is {fk[0].dtype}")
                for name, k, p, lp in zip(("y", "m", "v"), fk, fp, (low, False, False)):
                    note("fwd", _norm_err(f"forward {case} {name}", k, p, lp))
                m, v = fp[1], fp[2]
                bk = adain_cuda.backward(cot["dy"], x, a["bias"], a["g"], a["n"], a["nw"], m, v,
                                         cot["dm"], cot["dv"], mode=mode, **kw)
                bp = adain.bias_act_norm_backward_plain(x, a["bias"], a["g"], a["n"], a["nw"],
                                                        m, v, cot["dy"], cot["dm"], cot["dv"],
                                                        mode=mode, **kw)
                torch.cuda.synchronize()
                names = ("dx", "d_bst", "d_g", "d_bias", "d_nw")
                for name, k, p, lp in zip(names, bk, bp, (low, False, False, False, False)):
                    note("bwd", _norm_err(f"backward {case} {name}", k, p, lp))
                del x, a, cot, fk, fp, bk, bp

    # times at the decoder's top site in training (noise + AdaIN), 4x64x256x256
    shape = NORM_SHAPES[0]
    bsz, ch, h, w = shape
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

        before = (adain_cuda.launches_fwd, adain_cuda.launches_bwd)
        t = {}
        # turns: plain, kernel, kernel, plain; the mean of each pair
        t["fwd_plain"] = [cuda_ms(fwd_p, iters=5)]
        t["fwd"] = [cuda_ms(fwd_k), cuda_ms(fwd_k)]
        t["fwd_plain"].append(cuda_ms(fwd_p, iters=5))
        t["bwd_plain"] = [cuda_ms(bwd_p, iters=5)]
        t["bwd"] = [cuda_ms(bwd_k), cuda_ms(bwd_k)]
        t["bwd_plain"].append(cuda_ms(bwd_p, iters=5))
        t["nearest"] = [cuda_ms(lambda: F.instance_norm(e, eps=1e-8))]
        # these comparison launches do not count for the main path
        adain_cuda.launches_fwd, adain_cuda.launches_bwd = before
        size = x.element_size()
        n_bytes = bsz * h * w * 4
        times[str(dtype).replace("torch.", "")] = {
            k: sum(vals) / len(vals) for k, vals in t.items()} | {
            "fwd_bytes": 2 * x.numel() * size + n_bytes,
            "bwd_bytes": 3 * x.numel() * size + n_bytes,
            "runs": t}
        del x, a, cot, e, m, v
    return worst, times


def norm_records(worst, times, peaks):
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
            f"{t['nearest']:.4f} ms")
    return (f"kernels: bias_act_norm fwd/bwd agree with bias_act_norm_plain/"
            f"bias_act_norm_backward_plain at {list(NORM_SHAPES)} x {[m for m, _ in NORM_MODES]} "
            f"x f32/bf16 (worst max|diff| fwd {worst['fwd']:.3g}, bwd {worst['bwd']:.3g}; "
            f"as a share of the tensor's max|ref| fwd {worst['fwd_rel']:.3g}, bwd "
            f"{worst['bwd_rel']:.3g}; tolerance {NORM_RTOL:g} of the tensor's scale, plus one bf16 "
            f"ulp per element in bf16); times at {NORM_SHAPES[0]} noise+AdaIN: " + "; ".join(parts)
            + f" (bound by bytes at {peaks[1] / 1e12:.2f} TB/s)")


def reset_counts() -> None:
    from soft_intro_vae_torch.ops import adain_cuda, chamfer_cuda

    chamfer_cuda.launches = 0
    adain_cuda.launches_fwd = adain_cuda.launches_bwd = 0


def read_counts() -> dict:
    from soft_intro_vae_torch.ops import adain_cuda, chamfer_cuda

    return {"chamfer_nearest": chamfer_cuda.launches, "bias_act_norm_fwd": adain_cuda.launches_fwd,
            "bias_act_norm_bwd": adain_cuda.launches_bwd}


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
    check(launches == 12 * steps, f"chamfer_nearest launched {launches} times in {steps} intro "
          f"steps, expected {12 * steps}")
    check(counts["bias_act_norm_fwd"] == counts["bias_act_norm_bwd"] == 0,
          f"the 3D path launched a fused-norm kernel: {counts}")
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
    check(counts["chamfer_nearest"] == 0, f"the style path launched chamfer: {counts}")
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


def phase_style_step(device, card: str, cfg):
    """ms per LOD-6 intro step after warm-up: median of three 10-step windows."""
    import torch

    state, intro = _style_intro(cfg)
    batches = _style_batches(cfg, device, 4)
    for i in range(3):
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
    return ms_step


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

    print(phase_build(), flush=True)
    chamfer = phase_kernels(device, peak_name, peaks)
    worst, times = phase_norm_kernels(device)
    print(norm_line(worst, times, peaks), flush=True)
    # the trainers' checkpoints (~100 MB for 3D, ~0.65 GB for style) go to
    # directories removed afterwards
    with tempfile.TemporaryDirectory(prefix="results_chip_smoke_", dir=ROOT) as results_dir:
        counts_3d = phase_train_3d(device, card, results_dir)
    with tempfile.TemporaryDirectory(prefix="results_chip_smoke_", dir=ROOT) as results_dir:
        cfg, counts_style = phase_style_train(device, card, results_dir)
    phase_style_step(device, card, cfg)
    phase_style_routes(device, cfg)
    with tempfile.TemporaryDirectory(prefix="results_chip_smoke_", dir=ROOT) as results_dir:
        phase_style_transition(device, results_dir)
    chamfer["launches"] = counts_3d["chamfer_nearest"]
    records = [chamfer] + norm_records(worst, times, peaks)
    for rec in records[1:]:
        rec["launches"] = counts_style[rec["name"]]
    print(json.dumps({"kernels": records}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
