#!/usr/bin/env python3
"""The fused-norm kernels under other launch-plan choices, on the GPU.

    python3 tools/torch_norm_plans.py [--iters 20]

Times every norm site of the LOD-6 intro step at ffhq256 width (as
tools/torch_norm_sites.py does: device time, each site alone, weighed by its
launches per step) once for each policy below, by setting the constants that
ops/adain_cuda.py ``plan`` reads: the bytes a CTA stages (which sets the
cluster size) and the units a thread takes per pass (which sets the threads
per CTA). Prints the card's name and power
limit, one line per policy and site, per-step totals per policy, and a JSON
line. The plan the kernels use is the module's defaults; this tool is how
they were chosen. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

POLICIES = {
    "the plan's defaults": {},
    "32 KB runs": dict(STAGE_TARGET=32768),
    "128 KB runs": dict(STAGE_TARGET=131072),
    "4 units a thread": dict(UNITS_PER_THREAD=4),
    "16 units a thread": dict(UNITS_PER_THREAD=16),
    "32 KB runs, 4 units a thread": dict(STAGE_TARGET=32768, UNITS_PER_THREAD=4),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_norm_plans: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from soft_intro_vae_torch.ops import adain_cuda
    from tools.torch_norm_sites import memory_rate, row_line, step_mix, time_sites, totals_line

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    device = torch.device("cuda", 0)
    adain_cuda.load()
    mix = step_mix(6, 4)
    rate = memory_rate(torch.cuda.get_device_name(0))
    names = ("STAGE_TARGET", "UNITS_PER_THREAD")
    defaults = {name: getattr(adain_cuda, name) for name in names}
    print(f"card: {card}; defaults {defaults}")
    results = {}
    for policy, consts in POLICIES.items():
        for name, value in {**defaults, **consts}.items():
            setattr(adain_cuda, name, value)
        try:
            rows, totals = time_sites(device, mix, rate, args.iters)
        finally:
            for name, value in defaults.items():
                setattr(adain_cuda, name, value)
        for row in rows:
            print(f"  [{policy}] {row_line(row)}")
        print(f"{policy}: {totals_line(totals)}", flush=True)
        results[policy] = {f"{dt} {d}": v[0] for (dt, d), v in totals.items()}
    print(json.dumps({"card": card, "step_ms": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
