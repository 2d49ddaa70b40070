#!/usr/bin/env python3
"""The chamfer search of the PyTorch port at the 3D recipe's shape, on the GPU.

    python3 tools/torch_chamfer_times.py [--root DIR] [--iters 20] [--batches 1,8,32]

Times one chamfer call's nearest-neighbour search, both directions, at
(B, N, M) = (32, 2048, 2048) (configs/soft_intro_vae_hp.json: batch 32, 2048
points) on device time: CUDA events around ``--iters`` calls queued behind a
sleep kernel (``tools/torch_norm_sites.py device_ms``), so the wrapper's host
time does not show. The search is one ``nearest_pair_cuda`` launch where the
package has it, else two ``nearest_cuda`` launches (x -> y, y -> x), the
earlier design. Before timing, the search is held bit-equal to the package's
plain version. Prints the card's name and power limit, the time against the
bound (8 FP32 instructions a pair at half the card's FP32 FLOP rate: the
distance is not contracted into FMAs), the issue slots a pair of the kernel's
inner loop takes, counted from the build's SASS, and a JSON line.

``--batches`` also times the one-launch kernel at (B, 2048, 2048) for each B
listed, beside its work items and CTAs: how the time grows with B shows how
the work spreads over the SMs.

``--root`` times the package of another checkout, built into that
checkout's own ``_build/``, so that two versions can be compared in one call
on one card. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (32, 2048, 2048)
# FP32 FLOP/s outside the tensor cores (NVIDIA data sheets); one FP32
# instruction a lane a cycle is half of it
FP32_FLOPS = {"PCIe": 51e12, "NVL": 60e12}
FP32_FLOPS_SXM = 67e12
PAIR_INSTRUCTIONS = 8       # 3 sub, 3 mul, 2 add, rounded one at a time
PAIR_INSTRUCTIONS_FMA = 6   # 3 sub, 1 mul, 2 FMA: fewer, but not the plain version's bits


def fp32_instruction_rate(card_name: str) -> float:
    """FP32 instructions a second over the card's lanes: half its FLOP rate."""
    for key, flops in FP32_FLOPS.items():
        if key in card_name:
            return flops / 2
    return FP32_FLOPS_SXM / 2


def bound_ms(bsz: int, n: int, m: int, rate: float, pair_instructions: int = PAIR_INSTRUCTIONS
             ) -> float:
    """The least time of the search: every distance once, at the FP32 instruction rate."""
    return pair_instructions * bsz * n * m / rate * 1e3


def _cuobjdump() -> str:
    from soft_intro_vae_torch.ops import cuda_build

    return os.path.join(os.path.dirname(cuda_build.nvcc()), "cuobjdump")


def sass_slots_per_pair(library: str, kernel: str = "nearest_pair_kernel", rows: int = 8,
                        tile: int = 8):
    """(slots per pair, opcode counts) of the kernel's tile loop in the built
    library's SASS, or (None, reason).

    The tile loop is the innermost loop whose body holds a full tile's FMULs
    (3 a pair, rows * tile pairs); its nested loops (the ragged tail, which a
    full tile skips) are left out. Every other instruction of the body is
    counted, so the branch into the tail and the row-argmin notes at the
    tile's end are in the count."""
    try:
        out = subprocess.run([_cuobjdump(), "-sass", library], capture_output=True, text=True,
                             timeout=120, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return None, f"cuobjdump failed: {e}"
    body, inside = [], False
    for line in out.splitlines():
        if "Function :" in line:
            inside = kernel in line
            continue
        mt = re.search(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", line)
        if inside and mt:
            text = re.sub(r"^@!?U?P\w+\s+", "", mt.group(2).strip())
            body.append((int(mt.group(1), 16), text))
    if not body:
        return None, f"no SASS for {kernel} in {library}"
    loops = []
    for addr, text in body:
        tb = re.match(r"BRA\b.*?0x([0-9a-f]+)", text)
        if tb and int(tb.group(1), 16) <= addr:
            loops.append((int(tb.group(1), 16), addr))

    def fmuls(lo, hi):
        return sum(1 for a, t in body if lo <= a <= hi and t.split()[0].split(".")[0] == "FMUL")

    full = [lp for lp in loops if fmuls(*lp) >= 3 * rows * tile]
    if not full:
        return None, "no loop holds a full tile"
    lo, hi = min(full, key=lambda lp: lp[1] - lp[0])
    nested = [lp for lp in loops if lo <= lp[0] and lp[1] <= hi and lp != (lo, hi)]
    ops = collections.Counter(
        t.split()[0] for a, t in body
        if lo <= a <= hi and not any(n0 <= a <= n1 for n0, n1 in nested))
    return sum(ops.values()) / (rows * tile), dict(ops)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=ROOT, help="checkout whose soft_intro_vae_torch is timed")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--batches", default="", help="comma-separated batch sizes to sweep")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_chamfer_times: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from tools.torch_norm_sites import device_ms

    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import soft_intro_vae_torch

    if os.path.dirname(os.path.dirname(os.path.abspath(soft_intro_vae_torch.__file__))) != root:
        print(f"torch_chamfer_times: soft_intro_vae_torch did not come from {root}",
              file=sys.stderr)
        return 1
    from soft_intro_vae_torch.ops import chamfer, chamfer_cuda

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    bsz, n, m = SHAPE
    preds = 0.3 * torch.randn((bsz, m, 3), generator=gen, device=device)
    gts = 0.3 * torch.randn((bsz, n, 3), generator=gen, device=device)

    if hasattr(chamfer_cuda, "nearest_pair_cuda"):
        design, kernel = "one launch (nearest_pair_cuda)", "nearest_pair_kernel"

        def search():
            return chamfer_cuda.nearest_pair_cuda(gts, preds)
    else:
        design, kernel = "two launches (nearest_cuda)", "nearest_kernel"

        def search():
            return chamfer_cuda.nearest_cuda(gts, preds) + chamfer_cuda.nearest_cuda(preds, gts)

    got = search()
    want = chamfer.nearest_plain(gts, preds) + chamfer.nearest_plain(preds, gts)
    torch.cuda.synchronize()
    equal = all(torch.equal(a, b) for a, b in zip(got, want))
    del got, want
    ms = device_ms(search, args.iters)
    rate = fp32_instruction_rate(torch.cuda.get_device_name(0))
    bound = bound_ms(bsz, n, m, rate)
    slots, ops = sass_slots_per_pair(chamfer_cuda.library_path(), kernel)
    slots_text = f"{slots:.2f}" if slots is not None else f"not counted ({ops})"
    print(f"card: {card}; package {root}; {design}")
    print(f"chamfer search at {SHAPE}: {ms:.4f} ms device time per call; bit-equal to the plain "
          f"version: {equal}; bound {bound:.4f} ms ({PAIR_INSTRUCTIONS} FP32 instructions a pair "
          f"at {rate / 1e12:.2f}e12/s; {bound_ms(bsz, n, m, rate, PAIR_INSTRUCTIONS_FMA):.4f} ms "
          f"with FMAs, not bit-exact); {ms / bound:.2f}x the bound; "
          f"{ms * 1e-3 * rate / (bsz * n * m):.2f} issue slots a pair achieved; "
          f"SASS tile loop {slots_text} slots a pair")
    if slots is not None:
        print("  tile loop opcodes: " + ", ".join(f"{k} {v}" for k, v in
                                                  sorted(ops.items(), key=lambda kv: -kv[1])))
    clusters = None
    if hasattr(chamfer_cuda, "max_active_clusters"):
        clusters = chamfer_cuda.max_active_clusters(chamfer_cuda.plan(bsz, n, m), 8)
        print(f"  clusters of 8 such CTAs the card holds at once: {clusters} (a cluster a batch "
              f"element would need {bsz})")
    sweep = []
    for b in [int(v) for v in args.batches.split(",") if v]:
        x = 0.3 * torch.randn((b, n, 3), generator=gen, device=device)
        y = 0.3 * torch.randn((b, m, 3), generator=gen, device=device)
        pl = chamfer_cuda.plan(b, n, m)
        t = device_ms(lambda: chamfer_cuda.nearest_pair_cuda(x, y), args.iters)
        sweep.append({"batch": b, "ms": t, "items": b * pl.slices, "grid": pl.grid})
        print(f"  B {b}: {t:.4f} ms, {t / b * 1e3:.3f} us per batch element; {b * pl.slices} "
              f"items of {pl.slice} points of y, {pl.grid} CTAs of {pl.threads} threads")
    print(json.dumps({"card": card, "root": root, "design": design, "shape": list(SHAPE),
                      "ms": ms, "bound_ms": bound, "equal": equal, "sass_slots_per_pair": slots,
                      "max_active_clusters_of_8": clusters, "sweep": sweep}))
    return 0 if equal else 1


if __name__ == "__main__":
    sys.exit(main())
