#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (soft_intro_vae_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing one line; any failure exits non-zero:
  1. device:  the card's name and power limit (nvidia-smi);
  2. build:   nvcc builds every kernel of the path from the checkout's sources;
  3. kernels: each kernel against its plain PyTorch version on the card, at
              the main path's shapes and at odd ones, plus its time, the plain
              version's, a library call's and the card's lower bound;
  4. train:   the 3D trainer's main path, ``train_soft_intro_vae_3d`` at the
              full width of configs/soft_intro_vae_hp.json (2048 points, batch
              32, z 128) on synthetic clouds for one intro epoch plus the valid
              JSD, with every kernel's launch count read around it; then the
              step time after warm-up, and one step with impl="cuda" against
              impl="plain" from the same weights and noises.
The second-to-last lines are the kernels' JSON record and the card's name and
power limit; the last line is ``{"ok": true, "device": {...}}``.

Imports nothing of JAX or of the JAX package. Writes only inside the
checkout: soft_intro_vae_torch/_build/ (the kernels) and a temporary
results_chip_smoke_*/ directory (the trainer's output, removed at the end).
"""

from __future__ import annotations

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


def phase_kernels(device, peak_name, peaks):
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


def phase_train(device, card: str, results_dir: str):
    """The trainer's main path at full width, with the kernel's launches counted."""
    import torch

    from soft_intro_vae_torch.data.shapenet import SyntheticClouds
    from soft_intro_vae_torch.ops import chamfer_cuda
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

    chamfer_cuda.launches = 0
    t0 = time.perf_counter()
    _, summary = train_soft_intro_vae_3d(cfg)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    launches = chamfer_cuda.launches
    last = summary["last_metrics"]
    check(launches == 12 * steps, f"chamfer_nearest launched {launches} times in {steps} intro "
          f"steps, expected {12 * steps}")
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
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=device)
    gen.manual_seed(11)
    noises = {k: torch.randn((cfg.batch_size, cfg.z_size), generator=gen, device=device)
              for k in INTRO_NOISES}
    noises["noise"] = noises["noise"] * cfg.prior_std
    losses = {}
    for impl in ("cuda", "plain"):
        st, _, step = build_3d_training(dataclasses.replace(cfg, chamfer_impl=impl))
        _, m = step(st, batches[0], noises)
        losses[impl] = (float(m["loss_e"]), float(m["loss_d"]))
    for name, k, p in zip(("loss_e", "loss_d"), losses["cuda"], losses["plain"]):
        check(abs(k - p) <= 1e-4 * abs(p), f"{name}: impl=cuda {k!r} vs impl=plain {p!r}")
    print(f"train: {steps} intro steps + valid JSD at 2048 points, batch 32, z 128 in "
          f"{epoch_s:.2f} s (first call, warm-up included); loss_e {last['loss_e']:.6g}, "
          f"loss_d {last['loss_d']:.6g}, JSD {summary['best_jsd']:.4f}; chamfer_nearest "
          f"launches {launches}; after warm-up {ms_step:.3f} ms/step (median of "
          f"{'/'.join(f'{w:.3f}' for w in windows)}), "
          f"{cfg.batch_size * 1e3 / ms_step:.1f} clouds/s on {card}; impl=cuda vs plain "
          f"loss_e {losses['cuda'][0]!r}/{losses['plain'][0]!r}, loss_d "
          f"{losses['cuda'][1]!r}/{losses['plain'][1]!r}", flush=True)
    return {"chamfer_nearest": launches}


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

    from soft_intro_vae_torch.ops import chamfer_cuda

    t0 = time.perf_counter()
    chamfer_cuda.load()
    ptxas = ""
    log = chamfer_cuda.library_path() + ".log"
    if os.path.exists(log):
        with open(log) as f:
            ptxas = " | ".join(line.strip() for line in f if "registers" in line or "smem" in line)
    print(f"build: chamfer_nearest.cu in {time.perf_counter() - t0:.2f} s; {ptxas}", flush=True)

    record = phase_kernels(device, peak_name, peaks)
    # the trainer's checkpoints (~100 MB each) go to a directory removed afterwards
    with tempfile.TemporaryDirectory(prefix="results_chip_smoke_", dir=ROOT) as results_dir:
        launches = phase_train(device, card, results_dir)
    record["launches"] = launches["chamfer_nearest"]
    print(json.dumps({"kernels": [record]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
