#!/usr/bin/env python3
"""Where the time of the PyTorch port's 3D intro step goes on the GPU.

    python3 tools/torch_profile_3d.py [--steps 5] [--root DIR] [--out FILE]

Builds the 3D trainer of soft_intro_vae_torch at the full width of
configs/soft_intro_vae_hp.json (2048 points, batch 32, z 128) and drives its
intro step by two routes, each on a fresh state from the same seed:
"graphed", the trainer's route on the card (train/graph.py ``one_step``: a
CUDA graph replayed a step), and "eager", the step itself (``.eager``; a
checkout whose steps have no ``.eager`` is eager, and has that route alone).
Each route warms up (a graph's 3 eager steps and its capture), times
``--steps`` intro steps on the host clock (ending in a synchronise), then
traces as many with torch.profiler. Prints the card's name and power limit,
and for each route ms/step, the device's busy time and its idle share of the
traced window and of the untraced step, peak device memory, and the device
time by kernel family and by kernel, then one JSON line. Fails when a trace
holds no device time. ``--root`` profiles the package of another checkout
(built into that checkout's ``_build/``), so two versions can be compared in
one call; ``--out`` writes every kernel's ms/step and launches a step, by
route, to a JSON file. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# kernel name substring -> family, first match wins
FAMILIES = (
    ("nearest_pair_kernel", "chamfer kernel (hand-written)"),
    ("scatter", "chamfer backward (gather/scatter)"),
    ("gather", "chamfer backward (gather/scatter)"),
    ("batch_norm", "batch norm"),
    ("bn_", "batch norm"),
    ("multi_tensor", "optimizer"),
    ("gemm", "matmul/conv"),
    ("xmma", "matmul/conv"),
    ("cutlass", "matmul/conv"),
    ("conv", "matmul/conv"),
    ("cudnn", "matmul/conv"),
    ("sm90", "matmul/conv"),
    ("reduce", "reductions"),
)


def family(name: str) -> str:
    low = name.lower()
    for key, fam in FAMILIES:
        if key in low:
            return fam
    return "elementwise/other"


WARMUP = 4  # steps before timing: a graph's 3 eager warm-up steps and its capture


def device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--root", default=ROOT, help="checkout whose soft_intro_vae_torch is profiled")
    ap.add_argument("--out", default="", help="JSON file for the per-kernel table")
    args = ap.parse_args(argv)

    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_profile_3d: CUDA is not available", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import soft_intro_vae_torch

    if os.path.dirname(os.path.dirname(os.path.abspath(soft_intro_vae_torch.__file__))) != root:
        print(f"torch_profile_3d: soft_intro_vae_torch did not come from {root}", file=sys.stderr)
        return 1
    from soft_intro_vae_torch.data.shapenet import SyntheticClouds
    from soft_intro_vae_torch.train.threed import ThreeDConfig, build_3d_training

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; package {root}")
    cfg = dataclasses.replace(ThreeDConfig.from_json(os.path.join(root, "configs", "soft_intro_vae_hp.json")),
                              seed=0, device="cuda")
    pts = torch.from_numpy(SyntheticClouds(cfg.batch_size * 4, cfg.n_points, seed=5).points).cuda()
    batches = [pts[i * cfg.batch_size:(i + 1) * cfg.batch_size] for i in range(4)]
    n = args.steps
    out, tables = {"card": card}, {}
    for route in ("graphed", "eager"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state, _, intro_step = build_3d_training(cfg)
        if not hasattr(intro_step, "eager"):
            if route == "graphed":
                continue  # a checkout from before the single-step graph: eager only
        elif route == "eager":
            intro_step = intro_step.eager

        for i in range(WARMUP):
            intro_step(state, batches[i % 4])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            intro_step(state, batches[i % 4])
        torch.cuda.synchronize()
        ms_step = (time.perf_counter() - t0) * 1e3 / n

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            t0 = time.perf_counter()
            for i in range(n):
                intro_step(state, batches[i % 4])
            torch.cuda.synchronize()
            traced_ms = (time.perf_counter() - t0) * 1e3
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        del state, intro_step

        kernels = defaultdict(float)
        launches = defaultdict(int)
        for evt in prof.key_averages():
            # user annotations (e.g. "Optimizer.step#Adam.step") sit on the device
            # lane too, spanning kernels already counted; torch's own table skips them
            if evt.device_type == torch.autograd.DeviceType.CUDA and not evt.is_user_annotation:
                kernels[evt.key] += device_us(evt) / 1e3
                launches[evt.key] += evt.count
        busy_ms = sum(kernels.values())
        if busy_ms <= 0:
            print(f"torch_profile_3d: {route}: the trace holds no device time", file=sys.stderr)
            return 1
        fams = defaultdict(float)
        for name, ms in kernels.items():
            fams[family(name)] += ms
        print(f"intro step, {route}, at 2048 points, batch 32, z 128: {ms_step:.3f} ms/step "
              f"untraced, {traced_ms / n:.3f} ms/step traced; device busy {busy_ms / n:.3f} "
              f"ms/step, idle share {1 - busy_ms / traced_ms:.3f} of the traced window, "
              f"{1 - busy_ms / n / ms_step:.3f} of the untraced step; "
              f"{sum(launches.values()) / n:.0f} kernel launches/step; peak device memory "
              f"{peak_gib:.3f} GiB")
        for fam, ms in sorted(fams.items(), key=lambda kv: -kv[1]):
            print(f"  {fam:36s} {ms / n:8.3f} ms/step  {ms / busy_ms:6.1%}")
        for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:15]:
            print(f"    {ms / n:8.3f} ms/step  x{launches[name] / n:5.1f}  {name[:110]}")
        out[route] = {"ms_step": ms_step, "traced_ms_step": traced_ms / n,
                      "busy_ms_step": busy_ms / n, "idle_share_traced": 1 - busy_ms / traced_ms,
                      "idle_share_untraced": 1 - busy_ms / n / ms_step,
                      "launches_step": sum(launches.values()) / n, "peak_gib": peak_gib,
                      "families_ms_step": {k: v / n for k, v in fams.items()}}
        tables[route] = {k: {"ms_step": ms / n, "launches_step": launches[k] / n}
                         for k, ms in kernels.items()}
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "root": root, "kernels": tables}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
