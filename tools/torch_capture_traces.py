#!/usr/bin/env python3
"""torch.profiler traces of the port's two headline steps.

    python3 tools/torch_capture_traces.py [cifar|style|both] [--out DIR]

The counterpart of tools/capture_traces.py, through the port's
``utils/profiling.trace``: the CIFAR-10 intro step (channels 64/128/256,
z 128, batch 32, f32) as K-step calls at scan_steps 8 (CUDA graph replays),
and the ffhq256 style intro step at LOD 6 (256x256, batch 4 from
LOD_2_BATCH_1GPU, bf16), each traced over a few steps after warm-up (the
capture and the first calls excluded) into ``DIR/cifar_step/trace.json`` and
``DIR/style256_step/trace.json`` (default DIR chiprun_out/traces; open with
chrome://tracing or Perfetto). Prints the card's name and power limit and,
for each trace, the device time a step and the five kernels that take most
of it. Needs a GPU; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _summary(prof, steps: int) -> str:
    import torch

    from tools.torch_profile_image import device_us

    rows = [(device_us(e), e.key) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
    total = sum(t for t, _ in rows)
    if total <= 0:
        raise RuntimeError("the trace holds no device time")
    top = sorted(rows, reverse=True)[:5]
    return (f"device {total / 1e3 / steps:.3f} ms/step; top: " +
            "; ".join(f"{k[:50]} {t / 1e3 / steps:.3f}" for t, k in top))


def trace_cifar(out: str, calls: int = 2) -> str:
    import numpy as np
    import torch

    from soft_intro_vae_torch.data.images import DATASETS
    from soft_intro_vae_torch.train.image import ImageConfig, build_image_training
    from soft_intro_vae_torch.utils.profiling import annotate, trace

    scan, b = 8, 32
    spec = DATASETS["cifar10"]
    cfg = ImageConfig(dataset="cifar10", z_dim=128, batch_size=b, beta_kl=1.0, beta_rec=1.0,
                      beta_neg=256.0, seed=0, scan_steps=scan, device="cuda", verbose=False)
    state, _, intro = build_image_training(cfg, spec)
    rng = np.random.default_rng(0)
    xs = torch.from_numpy(rng.integers(0, 256, (scan, b, 32, 32, 3), dtype=np.uint8)).cuda()
    for _ in range(3):  # warm-up steps, the capture, replays
        state, m = intro(state, xs)
    torch.cuda.synchronize()
    path = os.path.join(out, "cifar_step")
    with trace(path) as prof:
        for i in range(calls):
            with annotate(f"cifar_call_{i}"):
                state, m = intro(state, xs)
    return f"cifar step (scan_steps {scan}): {_summary(prof, calls * scan)}; wrote {path}"


def trace_style(out: str, steps: int = 3) -> str:
    import torch

    from soft_intro_vae_torch.train.style import (
        MultiResImages, StyleConfig, _Feed, build_style_training)
    from soft_intro_vae_torch.train.style_step import StyleStepConfig, build_style_steps
    from soft_intro_vae_torch.utils.profiling import annotate, trace

    cfg = StyleConfig.from_yaml(os.path.join(ROOT, "configs", "ffhq256.yaml"),
                                ["DATASET.SYNTHETIC", "true"])
    cfg = dataclasses.replace(cfg, seed=0, device="cuda", verbose=False)
    lod = cfg.layer_count - 1
    batch, res = cfg.lod_2_batch_tables["1GPU"][lod], 2 ** (lod + 2)
    model, state = build_style_training(cfg)
    scfg = StyleStepConfig(latent_size=cfg.latent_space_size, beta_rec=cfg.beta_rec,
                           beta_kl=cfg.beta_kl, beta_neg=float(cfg.beta_neg[lod]), scale=cfg.scale)
    _, intro = build_style_steps(model, scfg, lod, False)
    images = MultiResImages.synthetic(2 * batch, res, seed=1).at_resolution(res)
    feed = _Feed(state.device)
    batches = [feed(images[i * batch:(i + 1) * batch], 1.0, False) for i in range(2)]
    for i in range(3):
        state, m = intro(state, batches[i % 2])
    torch.cuda.synchronize()
    path = os.path.join(out, "style256_step")
    with trace(path) as prof:
        for i in range(steps):
            with annotate(f"style_step_{i}"):
                state, m = intro(state, batches[i % 2])
    return f"style step (LOD 6, batch {batch}, bf16): {_summary(prof, steps)}; wrote {path}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("which", nargs="?", default="both", choices=("cifar", "style", "both"))
    ap.add_argument("--out", type=str, default=os.path.join(ROOT, "chiprun_out", "traces"))
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_capture_traces: CUDA is not available; this tool needs a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    if args.which in ("cifar", "both"):
        print(trace_cifar(args.out), flush=True)
    if args.which in ("style", "both"):
        print(trace_style(args.out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
