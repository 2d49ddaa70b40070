#!/usr/bin/env python3
"""Where the time of the PyTorch port's 3D intro step goes on the GPU.

    python3 tools/torch_profile_3d.py [--steps 5] [--root DIR] [--out FILE]

Builds the 3D trainer of soft_intro_vae_torch at the full width of
configs/soft_intro_vae_hp.json (2048 points, batch 32, z 128), warms up, times
``--steps`` intro steps on the host clock (ending in a synchronise), then
traces as many with torch.profiler. Prints the card's name and power limit,
ms/step, the device's busy time and its idle share of the traced window and
of the untraced step, and the device time by kernel family and by kernel,
then one JSON line. Fails when the
trace holds no device time. ``--root`` profiles the package of another
checkout (built into that checkout's ``_build/``), so two versions can be
compared in one call; ``--out`` writes every kernel's ms/step and launches a
step to a JSON file. Imports nothing of JAX.
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
    cfg = dataclasses.replace(ThreeDConfig.from_json(os.path.join(root, "configs", "soft_intro_vae_hp.json")),
                              seed=0, device="cuda")
    state, _, intro_step = build_3d_training(cfg)
    pts = torch.from_numpy(SyntheticClouds(cfg.batch_size * 4, cfg.n_points, seed=5).points).cuda()
    batches = [pts[i * cfg.batch_size:(i + 1) * cfg.batch_size] for i in range(4)]

    for i in range(3):
        intro_step(state, batches[i % 4])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(args.steps):
        intro_step(state, batches[i % 4])
    torch.cuda.synchronize()
    ms_step = (time.perf_counter() - t0) * 1e3 / args.steps

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        t0 = time.perf_counter()
        for i in range(args.steps):
            intro_step(state, batches[i % 4])
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3

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
        print("torch_profile_3d: the trace holds no device time", file=sys.stderr)
        return 1
    fams = defaultdict(float)
    for name, ms in kernels.items():
        fams[family(name)] += ms
    n = args.steps
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; package {root}")
    print(f"intro step at 2048 points, batch 32, z 128: {ms_step:.3f} ms/step untraced, "
          f"{traced_ms / n:.3f} ms/step traced; device busy {busy_ms / n:.3f} ms/step, "
          f"idle share {1 - busy_ms / traced_ms:.3f} of the traced window, "
          f"{1 - busy_ms / n / ms_step:.3f} of the untraced step; "
          f"{sum(launches.values()) / n:.0f} kernel launches/step")
    for fam, ms in sorted(fams.items(), key=lambda kv: -kv[1]):
        print(f"  {fam:36s} {ms / n:8.3f} ms/step  {ms / busy_ms:6.1%}")
    for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:15]:
        print(f"    {ms / n:8.3f} ms/step  x{launches[name] / n:5.1f}  {name[:110]}")
    print(json.dumps({"card": card, "ms_step": ms_step, "traced_ms_step": traced_ms / n,
                      "busy_ms_step": busy_ms / n, "idle_share_traced": 1 - busy_ms / traced_ms,
                      "idle_share_untraced": 1 - busy_ms / n / ms_step,
                      "launches_step": sum(launches.values()) / n,
                      "families_ms_step": {k: v / n for k, v in fams.items()}}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "root": root,
                       "kernels": {k: {"ms_step": ms / n, "launches_step": launches[k] / n}
                                   for k, ms in kernels.items()}}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
