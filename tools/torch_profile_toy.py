#!/usr/bin/env python3
"""Where the time of the PyTorch port's 2D toy iteration goes on the GPU.

    python3 tools/torch_profile_toy.py [--iters 50] [--out FILE]

Builds the toy trainer of soft_intro_vae_torch at the CLI recipe's width
(8Gaussians, z 2, 3 hidden layers of 256, batch 512, beta_rec/beta_kl/
beta_neg 0.2/0.3/0.9) and times the trainer's own iteration, vanilla and
introspective: a host batch from the sampler, its copy to the card, one
step and the two LR fills. Each phase runs by two routes, each on a fresh
state from the same seed: "graphed", the trainer's route on the card
(train/graph.py ``one_step``: a CUDA graph replayed a step), and "eager",
the step itself. After a warm-up (a graph's 3 eager steps and its capture
among it), ``--iters`` iterations on the host clock (ending in a
synchronise), then as many traced with torch.profiler: device busy time, its
idle share of the untraced iteration and of the traced window, device
operations (kernels, copies, fills) an iteration, and the peak device memory
of the route. Prints the card's name and power limit, a line a phase and
route and one JSON line; ``--out`` writes the JSON to a file. Fails when the
trace holds no device time. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the toy CLI's recipe (soft_intro_vae_tpu/cli/main.py:122-136; n_layers and
# num_hidden are ToyConfig's defaults)
RECIPE = dict(dataset="8Gaussians", z_dim=2, batch_size=512, beta_rec=0.2, beta_kl=0.3,
              beta_neg=0.9, gamma_r=1e-8, n_layers=3, num_hidden=256)


def device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def profile_iterations(iteration, iters: int, warmup: int = 5) -> dict:
    """``iteration()`` ``warmup`` times, ``iters`` times untraced, then
    ``iters`` times under torch.profiler: ms an iteration (untraced and
    traced), device busy ms, idle shares and device operations an iteration."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        iteration()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        iteration()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / iters
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities, acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            iteration()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, ops = 0.0, 0
    for evt in prof.key_averages():
        # user annotations sit on the device lane too, spanning counted kernels
        if evt.device_type == torch.autograd.DeviceType.CUDA and not evt.is_user_annotation:
            busy_ms += device_us(evt) / 1e3
            ops += evt.count
    if busy_ms <= 0:
        raise RuntimeError("the trace holds no device time")
    return {"ms_iter": ms, "traced_ms_iter": traced_ms / iters, "busy_ms_iter": busy_ms / iters,
            "idle_share_untraced": 1 - busy_ms / iters / ms,
            "idle_share_traced": 1 - busy_ms / traced_ms, "device_ops_iter": ops / iters}


def toy_phases(device, iters: int, seed: int = 0) -> dict:
    """{"vanilla graphed": ..., "vanilla eager": ..., "intro graphed": ...,
    "intro eager": ...}: ``profile_iterations`` of the trainer's iteration
    (train/toy.py) with each step, graphed (the trainer's route) and eager,
    each with its peak device memory in GiB (``peak_gib``)."""
    import torch

    from soft_intro_vae_torch.data.toy import ToyDataset
    from soft_intro_vae_torch.train.toy import ToyConfig, build_toy

    cfg = ToyConfig(seed=seed, device=str(device), verbose=False, **RECIPE)
    out = {}
    for phase in ("vanilla", "intro"):
        for route in ("graphed", "eager"):
            torch.cuda.empty_cache()
            state, vanilla, intro = build_toy(cfg)  # (the first CUDA call must not be the reset)
            torch.cuda.reset_peak_memory_stats(device)
            step = vanilla if phase == "vanilla" else intro
            step = step if route == "graphed" else step.eager
            sampler = ToyDataset(cfg.dataset, seed=seed)

            def iteration():
                batch = torch.from_numpy(sampler.next_batch(cfg.batch_size)).to(state.device)
                step(state, batch)
                state.set_lr(cfg.lr_e, cfg.lr_d)

            r = profile_iterations(iteration, iters)
            r["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
            out[f"{phase} {route}"] = r
            del state, vanilla, intro, step
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--out", default="", help="JSON file for the result")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_profile_toy: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    res = toy_phases(torch.device("cuda", 0), args.iters)
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    for phase, r in res.items():
        print(f"toy {phase} iteration (8Gaussians, z 2, 3x256, batch 512): {r['ms_iter']:.3f} ms "
              f"untraced, {r['traced_ms_iter']:.3f} traced; device busy {r['busy_ms_iter']:.3f} ms, "
              f"idle {r['idle_share_untraced']:.3f} of the untraced iteration, "
              f"{r['idle_share_traced']:.3f} of the traced window; "
              f"{r['device_ops_iter']:.0f} device operations an iteration; peak device memory "
              f"{r['peak_gib']:.4f} GiB")
    line = json.dumps({"card": card, **res})
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
