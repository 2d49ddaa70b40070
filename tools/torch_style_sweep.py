#!/usr/bin/env python3
"""LOD-6 style step sweep of the PyTorch port at configs/ffhq256.yaml.

    python3 tools/torch_style_sweep.py [--steps 5] [--batches 4,8,16,32] [--out FILE]

The counterpart of tools/tpu_style_sweep.py: the style trainer of
soft_intro_vae_torch at the unmodified ffhq256 width (7 blocks, 64->512
channels, latent 512, mapping 8) and its LOD-6 intro step (256x256), crossed
over compute dtype (bfloat16, float32) x TRAIN.REMAT (off, on) x batch. Each
cell builds a fresh state, takes 2 warm-up steps, then times ``--steps`` steps
on the host clock ending in a synchronise, and reads
``torch.cuda.max_memory_allocated`` over the cell. A cell that runs out of
device memory is recorded as "oom". Prints the card's name and power limit,
one row per cell, and writes every cell to ``--out`` (JSON, default
chiprun_out/torch_style_sweep.json). Needs a GPU; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = ("bfloat16", "float32")
REMAT = (False, True)


def run_cell(cfg, batch: int, steps: int) -> dict:
    """ms/step and peak device memory of the LOD-6 intro step at ``batch``."""
    import torch

    from soft_intro_vae_torch.train.style import MultiResImages, _Feed, build_style_training
    from soft_intro_vae_torch.train.style_step import StyleStepConfig, build_style_steps

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lod = cfg.layer_count - 1
    res = 2 ** (lod + 2)
    model, state = build_style_training(cfg)
    scfg = StyleStepConfig(latent_size=cfg.latent_space_size, beta_rec=cfg.beta_rec,
                           beta_kl=cfg.beta_kl, beta_neg=float(cfg.beta_neg[lod]), scale=cfg.scale)
    _, intro = build_style_steps(model, scfg, lod, False)
    images = MultiResImages.synthetic(2 * batch, res, seed=5).at_resolution(res)
    feed = _Feed(state.device)
    batches = [feed(images[i * batch:(i + 1) * batch], 1.0, False) for i in range(2)]
    for i in range(2):
        state, m = intro(state, batches[i])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        state, m = intro(state, batches[i % 2])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    if not all(bool(torch.isfinite(v)) for v in m.values()):
        raise RuntimeError(f"non-finite metrics at batch {batch}: {m}")
    return {"ms_step": round(ms, 3), "images_s": round(batch * 1e3 / ms, 2),
            "peak_gib": round(torch.cuda.max_memory_allocated() / 2**30, 3)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--batches", type=str, default="4,8,16,32")
    ap.add_argument("--out", type=str, default=os.path.join(ROOT, "chiprun_out",
                                                            "torch_style_sweep.json"))
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_style_sweep: CUDA is not available; this tool needs a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from soft_intro_vae_torch.train.style import StyleConfig

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    cells = {}
    for dtype in DTYPES:
        for remat in REMAT:
            cfg = StyleConfig.from_yaml(os.path.join(ROOT, "configs", "ffhq256.yaml"), [
                "TRAIN.COMPUTE_DTYPE", dtype, "TRAIN.REMAT", "true" if remat else "false",
                "DATASET.SYNTHETIC", "true"])
            cfg = dataclasses.replace(cfg, seed=0, device="cuda", verbose=False)
            for batch in (int(b) for b in args.batches.split(",")):
                key = f"ffhq256_lod6_{dtype}_remat{'on' if remat else 'off'}_bs{batch}"
                try:
                    cells[key] = run_cell(cfg, batch, args.steps)
                except torch.cuda.OutOfMemoryError:
                    cells[key] = "oom"
                torch.cuda.empty_cache()
                print(f"{key}: {cells[key]}", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "steps": args.steps, "cells": cells}, f, indent=1)
    print(json.dumps({"card": card, "cells": cells}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
