"""Throughput of the port's CIFAR-10 image step on one GPU (twin of bench.py).

    python3 -m soft_intro_vae_torch.bench [--warmup 24] [--iters 480]

The recipe is bench.py's: ImageSpec("cifar10", 32, (64, 128, 256), 3), z 128,
batch 32, beta_rec/beta_kl/beta_neg 1/1/256, gamma_r 1e-8, float32, the
introspective E+D double update (12 network passes and 2 backward passes a
step), one step a launch (``scan_steps`` 1). Two rows, both normalizing uint8
batches in the step with the u8norm kernel (ops/u8norm.py):

  * resident: one uint8 batch already on the card;
  * host_fed: a 50,000-image uint8 ``ArrayDataset``, the epoch shuffle and
    gather on the host, the pinned put and ``device_prefetch`` of depth 2 (the
    trainer's own feed, data/prefetch.py).

Each row runs ``--warmup`` steps, then ``--iters`` timed steps fenced by
``torch.cuda.synchronize()``. Prints one JSON line: each row's images/s and
ms/step, their ratio (``feed_efficiency``), ``scan_steps`` and the card's name
and power limit. It measures the step; it is not a benchmark cell.
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


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _timed(step, state, batches, warmup: int, iters: int) -> float:
    """Seconds of ``iters`` steps after ``warmup`` ones, each end fenced by a
    synchronise; ``batches`` yields one batch a step."""
    for _ in range(warmup):
        state, _ = step(state, next(batches))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        state, m = step(state, next(batches))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if not all(bool(torch.isfinite(v)) for v in m.values()):
        raise SystemError(f"non-finite metrics in the timed steps: {m}")
    return seconds


def run(warmup: int = 24, iters: int = 480) -> dict:
    spec = DATASETS["cifar10"]
    cfg = ImageConfig(dataset="cifar10", z_dim=ZDIM, batch_size=BATCH, beta_rec=1.0,
                      beta_kl=1.0, beta_neg=256.0, gamma_r=1e-8, seed=0, device="cuda")
    state, _, intro_step = build_image_training(cfg, spec)
    rng = np.random.default_rng(0)
    shape = (spec.image_size, spec.image_size, spec.cdim)

    resident = torch.from_numpy(rng.integers(0, 256, (BATCH, *shape), dtype=np.uint8))
    resident = resident.to(state.device)
    s_res = _timed(intro_step, state, itertools.repeat(resident), warmup, iters)

    ds = ArrayDataset(rng.integers(0, 256, (N_IMAGES, *shape), dtype=np.uint8), seed=0)

    def host_stream():
        for epoch in itertools.count():
            yield from ds.epoch(BATCH, drop_last=True, epoch_index=epoch)

    # exactly the batches the row takes, so the prefetch worker ends with it
    fed = device_prefetch(itertools.islice(host_stream(), warmup + iters), size=PREFETCH,
                          put_fn=device_put_fn(state.device))
    s_fed = _timed(intro_step, state, fed, warmup, iters)

    res_ips, fed_ips = BATCH * iters / s_res, BATCH * iters / s_fed
    return {"metric": "image intro step throughput, CIFAR-10 recipe (torch port)",
            "unit": "images/s", "resident": res_ips, "host_fed": fed_ips,
            "feed_efficiency": fed_ips / res_ips, "ms_step_resident": s_res * 1e3 / iters,
            "ms_step_host_fed": s_fed * 1e3 / iters, "batch": BATCH, "z_dim": ZDIM,
            "dtype": "float32", "host_storage": "uint8", "prefetch": PREFETCH,
            "scan_steps": 1, "warmup": warmup, "iters": iters}


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
