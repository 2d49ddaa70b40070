#!/usr/bin/env python3
"""Where the time of the PyTorch port's image intro step goes on the GPU.

    python3 tools/torch_profile_image.py [--steps 10] [--scan-steps K] [--root DIR] [--out FILE]

Builds the image trainer of soft_intro_vae_torch at the CIFAR-10 recipe
(bench.py's: channels 64/128/256, 32x32, z 128, batch 32, beta_rec/beta_kl/
beta_neg 1/1/256, float32), feeds it resident uint8 batches (normalized in the
step by the u8norm kernel), warms up, times ``--steps`` intro steps on the
host clock (ending in a synchronise), then traces as many with torch.profiler.
The steps are CUDA graph replays (train/graph.py), and the kernels the
replays launch are traced like any other. At the default ``--scan-steps 1``
the step runs by two routes, each on a fresh state from the same seed:
"graphed", the trainer's route (``one_step``: a graph replayed a call), and
"eager", the step itself (``.eager``; a checkout whose steps have no
``.eager`` is eager, and has that route alone). With ``--scan-steps K`` > 1
the steps run K a call, one uint8 chunk of K batches resident, the graph
replayed once a batch; ``--steps`` is then rounded up to whole calls.
Prints the card's name and power limit, and for each route ms/step, the
device's busy time and its idle share of the traced window and of the
untraced step, kernel launches a step, cuDNN's layout transposes a step
(``nchwToNhwc``/``nhwcToNchw`` kernels: launches and ms), peak device memory
and the device time by kernel family and by kernel, then one JSON line (a
route's figures under its name). Fails when a trace holds no device time.
``--root`` profiles the package of another checkout (built into that
checkout's ``_build/``), so two versions can be compared in one call;
``--out`` writes every kernel's ms/step and launches a step, by route, to a
JSON file. Imports nothing of JAX.
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

# cuDNN's layout conversions around a convolution whose operands are not in
# the layout of the kernel it picked (lower-case substrings of kernel names)
TRANSPOSES = ("nchwtonhwc", "nhwctonchw")
# kernel name substring -> family, first match wins
FAMILIES = (
    ("u8norm_kernel", "u8norm kernel (hand-written)"),
    *((key, "layout transposes") for key in TRANSPOSES),
    ("direct_copy_kernel", "copies (ATen copy_)"),
    ("batch_norm", "batch norm"),
    ("batchnorm", "batch norm"),  # cuDNN's NHWC kernels: batchnorm_fwtr_nhwc_semiPersist, ...
    ("bn_", "batch norm"),
    ("multi_tensor", "optimizer"),
    ("adam", "optimizer"),
    ("upsample", "upsample/pool"),
    ("pool", "upsample/pool"),
    ("gemm", "matmul/conv"),
    ("xmma", "matmul/conv"),
    ("cutlass", "matmul/conv"),
    ("conv", "matmul/conv"),
    ("cudnn", "matmul/conv"),
    ("sm90", "matmul/conv"),
    ("sm80", "matmul/conv"),
    ("wgrad", "matmul/conv"),
    ("dgrad", "matmul/conv"),
    ("reduce", "reductions"),
    ("memcpy", "copies/fills"),
    ("memset", "copies/fills"),
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
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--scan-steps", type=int, default=1, help="K steps a call (a CUDA graph)")
    ap.add_argument("--root", default=ROOT, help="checkout whose soft_intro_vae_torch is profiled")
    ap.add_argument("--out", default="", help="JSON file for the per-kernel table")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_profile_image: CUDA is not available", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import soft_intro_vae_torch

    if os.path.dirname(os.path.dirname(os.path.abspath(soft_intro_vae_torch.__file__))) != root:
        print(f"torch_profile_image: soft_intro_vae_torch did not come from {root}", file=sys.stderr)
        return 1
    from soft_intro_vae_torch.data.images import DATASETS
    from soft_intro_vae_torch.ops import u8norm_cuda
    from soft_intro_vae_torch.train import graph
    from soft_intro_vae_torch.train.image import ImageConfig, build_image_training

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; package {root}")
    spec = DATASETS["cifar10"]
    scan = args.scan_steps
    kw = dict(scan_steps=scan) if scan > 1 else {}
    cfg = ImageConfig(dataset="cifar10", z_dim=128, batch_size=32, beta_rec=1.0, beta_kl=1.0,
                      beta_neg=256.0, gamma_r=1e-8, seed=0, device="cuda", **kw)
    rng = np.random.default_rng(5)
    shape = ((scan,) if scan > 1 else ()) + (cfg.batch_size, spec.image_size, spec.image_size,
                                              spec.cdim)
    batches = [torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).cuda()
               for _ in range(4)]
    calls = -(-args.steps // scan)
    n = calls * scan
    out, tables = {"card": card, "scan_steps": scan}, {}
    for route in ("graphed", "eager") if scan == 1 else ("graphed",):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state, _, intro_step = build_image_training(cfg, spec)
        if not hasattr(intro_step, "eager"):
            if route == "graphed" and scan == 1:
                continue  # a checkout from before the single-step graph: eager only
        elif route == "eager":
            intro_step = intro_step.eager

        for i in range(max(2, -(-5 // scan))):  # a graph's warm-up steps and its capture
            intro_step(state, batches[i % 4])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(calls):
            intro_step(state, batches[i % 4])
        torch.cuda.synchronize()
        ms_step = (time.perf_counter() - t0) * 1e3 / n

        u8norm_cuda.launches = 0
        replayed = graph.replayed["u8norm"]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            t0 = time.perf_counter()
            for i in range(calls):
                intro_step(state, batches[i % 4])
            torch.cuda.synchronize()
            traced_ms = (time.perf_counter() - t0) * 1e3
        u8_launches = u8norm_cuda.launches + graph.replayed["u8norm"] - replayed
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
            print(f"torch_profile_image: {route}: the trace holds no device time",
                  file=sys.stderr)
            return 1
        fams = defaultdict(float)
        fam_launches = defaultdict(int)
        for name, ms in kernels.items():
            fams[family(name)] += ms
            fam_launches[family(name)] += launches[name]
        transposes = {k: (ms / n, launches[k] / n) for k, ms in kernels.items()
                      if any(t in k.lower() for t in TRANSPOSES)}
        print(f"image intro step, {route}, CIFAR-10 recipe (32x32, channels 64/128/256, batch "
              f"32, z 128, f32, uint8 resident), scan_steps {scan}: {ms_step:.3f} ms/step "
              f"untraced, {traced_ms / n:.3f} ms/step traced; "
              f"device busy {busy_ms / n:.3f} ms/step, idle share {1 - busy_ms / traced_ms:.3f} "
              f"of the traced window, {1 - busy_ms / n / ms_step:.3f} of the untraced step; "
              f"{sum(launches.values()) / n:.0f} kernel launches/step, u8norm "
              f"{u8_launches / n:.0f}/step; layout transposes "
              f"{sum(c for _, c in transposes.values()):.1f}/step, "
              f"{sum(ms for ms, _ in transposes.values()):.3f} ms/step; peak device memory "
              f"{peak_gib:.3f} GiB")
        for fam, ms in sorted(fams.items(), key=lambda kv: -kv[1]):
            print(f"  {fam:32s} {ms / n:8.3f} ms/step  {ms / busy_ms:6.1%}  "
                  f"x{fam_launches[fam] / n:6.1f}")
        for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:15]:
            print(f"    {ms / n:8.3f} ms/step  x{launches[name] / n:5.1f}  {name[:110]}")
        out[route] = {"ms_step": ms_step, "traced_ms_step": traced_ms / n,
                      "busy_ms_step": busy_ms / n, "idle_share_traced": 1 - busy_ms / traced_ms,
                      "idle_share_untraced": 1 - busy_ms / n / ms_step,
                      "launches_step": sum(launches.values()) / n,
                      "u8norm_launches_step": u8_launches / n, "peak_gib": peak_gib,
                      "layout_transposes_step": {k: {"ms": ms, "launches": c}
                                                 for k, (ms, c) in transposes.items()},
                      "families_ms_step": {k: v / n for k, v in fams.items()},
                      "families_launches_step": {k: v / n for k, v in fam_launches.items()}}
        tables[route] = {k: {"ms_step": ms / n, "launches_step": launches[k] / n}
                         for k, ms in kernels.items()}
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "root": root, "kernels": tables}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
