#!/usr/bin/env python3
"""Where the time of the PyTorch port's style intro step goes on the GPU.

    python3 tools/torch_profile_style.py [--steps 5]

Builds the style trainer of soft_intro_vae_torch at the full width of
configs/ffhq256.yaml (7 blocks, 64->512 channels, latent 512, bf16) and
drives its LOD-6 intro step (256x256, batch 4 from LOD_2_BATCH_1GPU) on the
JAX package's synthetic images by two routes, each on a fresh state from
the same seed: "graphed", the trainer's route on the card (train/graph.py
``one_step``: one CUDA graph replayed a step), and "eager", the step itself.
Each route warms up (a graph's 3 eager steps and its capture), times
``--steps`` steps on the host clock (ending in a synchronise), then traces as
many with torch.profiler. Prints the card's name and power limit, and for
each route ms/step, the device's busy time, its idle share of the traced
window and of the untraced step, launches a step and the device time by
kernel family and by kernel, then one JSON line. Fails when a trace holds
no device time. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# kernel name substring -> family, first match wins
FAMILIES = (
    ("fwd_kernel", "fused norm forward (hand-written)"),
    ("bwd_kernel", "fused norm backward (hand-written)"),
    ("depthwise", "blur (depthwise conv)"),
    ("multi_tensor", "optimizer + EMA (foreach)"),
    ("foreach", "optimizer + EMA (foreach)"),
    ("gemm", "conv/matmul"),
    ("xmma", "conv/matmul"),
    ("cutlass", "conv/matmul"),
    ("conv", "conv/matmul"),
    ("cudnn", "conv/matmul"),
    ("sm90", "conv/matmul"),
    ("dgrad", "conv/matmul"),
    ("wgrad", "conv/matmul"),
    ("pool", "resampling (pool/upscale)"),
    ("upsample", "resampling (pool/upscale)"),
    ("reduce", "reductions"),
    ("copy", "copies and casts"),
    ("cast", "copies and casts"),
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


WARMUP = 4  # steps before timing: a graph's 3 eager warm-up steps and its capture


def profile_route(step, state, batches, steps: int) -> dict:
    """ms/step untraced and traced, device time and launches by kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for i in range(WARMUP):
        state, _ = step(state, batches[i % len(batches)])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        state, _ = step(state, batches[i % len(batches)])
    torch.cuda.synchronize()
    ms_step = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            state, _ = step(state, batches[i % len(batches)])
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    kernels = defaultdict(float)
    launches = defaultdict(int)
    for evt in prof.key_averages():
        # user annotations sit on the device lane too, spanning kernels
        # already counted; torch's own table skips them
        if evt.device_type == torch.autograd.DeviceType.CUDA and not evt.is_user_annotation:
            kernels[evt.key] += device_us(evt) / 1e3
            launches[evt.key] += evt.count
    busy_ms = sum(kernels.values())
    if busy_ms <= 0:
        raise RuntimeError("the trace holds no device time")
    return {"ms_step": ms_step, "traced_ms_step": traced_ms / steps, "busy_ms_step": busy_ms / steps,
            "idle_share_traced": 1 - busy_ms / traced_ms,
            "idle_share_untraced": 1 - busy_ms / steps / ms_step,
            "launches_step": sum(launches.values()) / steps, "kernels": kernels,
            "launches": launches}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_profile_style: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from soft_intro_vae_torch.train.graph import one_step
    from soft_intro_vae_torch.train.style import (
        MultiResImages, StyleConfig, _Feed, build_style_training)
    from soft_intro_vae_torch.train.style_step import StyleStepConfig, build_style_steps

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    cfg = StyleConfig.from_yaml(os.path.join(ROOT, "configs", "ffhq256.yaml"),
                                ["DATASET.SYNTHETIC", "true", "TRAIN.EPOCHS_PER_LOD", "0"])
    cfg = dataclasses.replace(cfg, seed=0, device="cuda", verbose=False)
    lod = cfg.layer_count - 1
    batch = cfg.lod_2_batch_tables["1GPU"][lod]
    res = 2 ** (lod + 2)
    scfg = StyleStepConfig(latent_size=cfg.latent_space_size, beta_rec=cfg.beta_rec,
                           beta_kl=cfg.beta_kl, beta_neg=float(cfg.beta_neg[lod]), scale=cfg.scale)
    images = MultiResImages.synthetic(4 * batch, res, seed=5).at_resolution(res)
    n = args.steps
    out = {"card": card}
    for route in ("graphed", "eager"):
        model, state = build_style_training(cfg)
        _, intro = build_style_steps(model, scfg, lod, False)
        feed = _Feed(state.device)
        batches = [feed(images[i * batch:(i + 1) * batch], 1.0, False) for i in range(4)]
        try:
            r = profile_route(one_step(intro) if route == "graphed" else intro, state, batches, n)
        except RuntimeError as e:
            print(f"torch_profile_style: {route}: {e}", file=sys.stderr)
            return 1
        del model, state, intro, batches
        torch.cuda.empty_cache()
        kernels, launches = r.pop("kernels"), r.pop("launches")
        fams = defaultdict(float)
        fam_launches = defaultdict(int)
        for name, ms in kernels.items():
            fams[family(name)] += ms
            fam_launches[family(name)] += launches[name]
        busy_ms = r["busy_ms_step"] * n
        print(f"style intro step, {route}, at ffhq256 width, LOD 6 (256x256), batch {batch}, "
              f"bf16: {r['ms_step']:.3f} ms/step untraced, {r['traced_ms_step']:.3f} ms/step "
              f"traced; device busy {r['busy_ms_step']:.3f} ms/step, idle share "
              f"{r['idle_share_traced']:.3f} of the traced window, "
              f"{r['idle_share_untraced']:.3f} of the untraced step; "
              f"{r['launches_step']:.0f} kernel launches/step", flush=True)
        for fam, ms in sorted(fams.items(), key=lambda kv: -kv[1]):
            print(f"  {fam:36s} {ms / n:8.3f} ms/step  {ms / busy_ms:6.1%}  "
                  f"x{fam_launches[fam] / n:6.1f}")
        for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:20]:
            print(f"    {ms / n:8.3f} ms/step  x{launches[name] / n:5.1f}  {name[:110]}")
        out[route] = dict(r, families_ms_step={k: v / n for k, v in fams.items()},
                          families_launches_step={k: v / n for k, v in fam_launches.items()})
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
