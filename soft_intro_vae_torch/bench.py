"""Throughput of the port's CIFAR-10 image step on one GPU (twin of bench.py).

    python3 -m soft_intro_vae_torch.bench [--warmup 24] [--iters 480]

The recipe is bench.py's: ImageSpec("cifar10", 32, (64, 128, 256), 3), z 128,
batch 32, beta_rec/beta_kl/beta_neg 1/1/256, gamma_r 1e-8, float32, the
introspective E+D double update (12 network passes and 2 backward passes a
step). Each ``scan_steps`` K (bench.py's default 8, and 1) gets two rows, both
normalizing uint8 batches in the step with the u8norm kernel (ops/u8norm.py):

  * resident: one uint8 chunk of K batches (one batch at K = 1) already on
    the card;
  * host_fed: a 50,000-image uint8 ``ArrayDataset``, the epoch shuffle and
    gather on the host, K batches stacked into one (K, 32, 32, 32, 3) chunk a
    call, the pinned put and ``device_prefetch`` of depth 2 (the trainer's
    own feed, data/prefetch.py).

At K > 1 a call is K steps: a CUDA graph of one step replayed K times
(train/graph.py ``k_steps``); at K = 1 a call is one replay of that graph
(``one_step``, the trainer's route at its default scan_steps), its capture
among the warm-up steps. Each row runs
``--warmup`` steps, then ``--iters`` timed steps (both rounded to whole
calls), fenced by ``torch.cuda.synchronize()``; images/s and ms/step count
steps, not calls. Prints one JSON line: each row's images/s and ms/step,
host_fed over resident (``feed_efficiency``) per K, and the card's name and
power limit. It measures the step; it is not a benchmark cell.
"""

from __future__ import annotations

import argparse
import itertools
import json
import subprocess
import sys
import time

import numpy as np
import torch

from soft_intro_vae_torch.data.images import DATASETS, ArrayDataset
from soft_intro_vae_torch.data.prefetch import device_prefetch, device_put_fn
from soft_intro_vae_torch.train.image import ImageConfig, build_image_training

BATCH = 32
ZDIM = 128
N_IMAGES = 50000
PREFETCH = 2
SCANS = (8, 1)         # bench.py's default scan_steps, and one step a call


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _timed(step, state, chunks, warmup: int, iters: int) -> float:
    """Seconds of ``iters`` calls after ``warmup`` ones, each end fenced by a
    synchronise; ``chunks`` yields one call's input."""
    for _ in range(warmup):
        state, _ = step(state, next(chunks))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        state, m = step(state, next(chunks))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if not all(bool(torch.isfinite(v).all()) for v in m.values()):
        raise SystemError(f"non-finite metrics in the timed steps: {m}")
    return seconds


def run_scan(scan: int, warmup: int, iters: int, ds) -> dict:
    """The resident and host-fed rows at ``scan_steps`` = ``scan``."""
    spec = DATASETS["cifar10"]
    cfg = ImageConfig(dataset="cifar10", z_dim=ZDIM, batch_size=BATCH, beta_rec=1.0,
                      beta_kl=1.0, beta_neg=256.0, gamma_r=1e-8, seed=0, device="cuda",
                      scan_steps=scan)
    state, _, intro_step = build_image_training(cfg, spec)
    warm_calls, calls = -(-warmup // scan), max(1, iters // scan)
    steps = calls * scan
    shape = (spec.image_size, spec.image_size, spec.cdim)
    rng = np.random.default_rng(1)
    chunk = rng.integers(0, 256, ((scan,) if scan > 1 else ()) + (BATCH, *shape), dtype=np.uint8)
    resident = torch.from_numpy(chunk).to(state.device)
    s_res = _timed(intro_step, state, itertools.repeat(resident), warm_calls, calls)

    def host_stream():
        for epoch in itertools.count():
            yield from ds.epoch(BATCH, drop_last=True, epoch_index=epoch)

    def host_chunks():
        batches = host_stream()
        while True:
            yield np.stack(list(itertools.islice(batches, scan)))

    # exactly the calls the row takes, so the prefetch worker ends with it
    feed = host_chunks() if scan > 1 else host_stream()
    fed = device_prefetch(itertools.islice(feed, warm_calls + calls), size=PREFETCH,
                          put_fn=device_put_fn(state.device))
    s_fed = _timed(intro_step, state, fed, warm_calls, calls)
    res_ips, fed_ips = BATCH * steps / s_res, BATCH * steps / s_fed
    return {"scan_steps": scan, "resident": res_ips, "host_fed": fed_ips,
            "feed_efficiency": fed_ips / res_ips, "ms_step_resident": s_res * 1e3 / steps,
            "ms_step_host_fed": s_fed * 1e3 / steps, "warmup_steps": warm_calls * scan,
            "timed_steps": steps}


def run(warmup: int = 24, iters: int = 480) -> dict:
    spec = DATASETS["cifar10"]
    rng = np.random.default_rng(0)
    ds = ArrayDataset(rng.integers(0, 256, (N_IMAGES, spec.image_size, spec.image_size, spec.cdim),
                                   dtype=np.uint8), seed=0)
    rows = []
    for scan in SCANS:
        rows.append(run_scan(scan, warmup, iters, ds))
        torch.cuda.empty_cache()
    return {"metric": "image intro step throughput, CIFAR-10 recipe (torch port)",
            "unit": "images/s", "rows": rows, "batch": BATCH, "z_dim": ZDIM,
            "dtype": "float32", "host_storage": "uint8", "prefetch": PREFETCH}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--warmup", type=int, default=24)
    ap.add_argument("--iters", type=int, default=480)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench: CUDA is not available; this program times the step on a GPU",
              file=sys.stderr)
        return 1
    row = run(args.warmup, args.iters)
    print(json.dumps({**row, "card": card_line(), "torch": torch.__version__}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
