#!/usr/bin/env python3
"""The fused-norm kernels of the PyTorch port, site by site, on the GPU.

    python3 tools/torch_norm_sites.py [--root DIR] [--iters 20]

Times the hand-written forward and backward kernels (ops/adain_cuda.py) at
every norm site of the style model at ffhq256 width and LOD 6 (256x256,
batch 4), each in the mode the intro step runs it there (encoder: plain,
eps 1e-5; decoder: noise + AdaIN, eps 1e-8), in bf16 and f32. Each time is
the device's: CUDA events over ``--iters`` launches after 3 warm-up
launches, queued behind a sleep kernel so that the wrapper's host time does
not show; a site whose tensors fit the 50 MB L2 runs from L2. Per-step totals weigh each site
by its launches per intro step: the sites of one encoder and one generator
pass, found by running the model on the meta device, times the passes of an
intro step (ENCODER_PASSES, GENERATOR_PASSES). The bound of a launch is the
bytes it must move over the card's memory rate.

``--root`` times the package of another checkout (one with the same
``adain_cuda.forward``/``backward``), so two versions can be compared in one
call on one card. Prints the card's name and power limit, one line per site
and a JSON line. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# ffhq256 width (configs/ffhq256.yaml): 7 blocks, 64 -> 512 channels, latent 512
STARTF, MAXF, LAYERS, LATENT = 64, 512, 7, 512
# passes of one intro step (train/style_step.py): the E phase encodes x, rec
# and fake and generates fake (no gradient), rec, rec_rec and rec_fake; the D
# phase generates fake, rec, rec_rec and rec_fake and encodes rec and fake.
# (forward, backward) passes:
ENCODER_PASSES = (5, 5)
GENERATOR_PASSES = (8, 7)
SLEEP_CYCLES = 20_000_000  # ~10 ms at the H100's clock: room to queue the timed calls
# device-memory rate by card name, bytes/s (NVIDIA data sheets)
MEMORY_RATE = {"PCIe": 2.0e12, "NVL": 3.9e12}
MEMORY_RATE_SXM = 3.35e12


def memory_rate(card_name: str) -> float:
    for key, rate in MEMORY_RATE.items():
        if key in card_name:
            return rate
    return MEMORY_RATE_SXM


def norm_bytes(direction: str, shape, mode: str, affine: bool, elem: int) -> int:
    """Bytes one fused-norm launch must move: each input read once, each output
    written once (x, y, dy, dx in the working type; the rest f32)."""
    bsz, ch, h, w = shape
    planes, n = bsz * ch, bsz * ch * h * w
    side = 4 * ch * (2 if mode == "noise" else 1) + (4 * bsz * h * w if mode == "noise" else 0)
    if direction == "fwd":  # x in, y out; g, b in; mean, var out
        return 2 * n * elem + side + 4 * planes * (2 * affine + 2)
    # dy, x in, dx out; g, mean, var, dm, dv in; four per-plane sums out
    return 3 * n * elem + side + 4 * planes * (affine + 4 + 4)


@contextlib.contextmanager
def _recording_sites(calls):
    import torch

    from soft_intro_vae_torch.models import style

    real = style.bias_act_norm

    def record(x, bias, g=None, b=None, n=None, nw=None, *, mode="plain", eps=1e-8, **_):
        calls[(tuple(x.shape), mode, g is not None, eps)] += 1
        stats = x.new_empty(x.shape[:2], dtype=torch.float32)
        return torch.empty_like(x), stats, stats

    style.bias_act_norm = record
    try:
        yield calls
    finally:
        style.bias_act_norm = real


def pass_sites(lod: int, batch: int, startf: int = STARTF, maxf: int = MAXF,
               layers: int = LAYERS, latent: int = LATENT):
    """(encoder, generator): Counters of (shape, mode, affine, eps) -> calls of
    one encoder pass and one generator pass at this LOD, found by running the
    style nets on the meta device (no data, no arithmetic)."""
    import torch

    from soft_intro_vae_torch.models.style import StyleEncoder, StyleGenerator

    res = 2 ** (lod + 2)
    with torch.device("meta"):
        enc = StyleEncoder(startf, maxf, layers, latent)
        gen = StyleGenerator(startf, maxf, layers, latent)
        with _recording_sites(collections.Counter()) as e_sites:
            enc(torch.empty(batch, 3, res, res), lod)
        with _recording_sites(collections.Counter()) as g_sites:
            gen(torch.empty(batch, 2 * layers, latent), lod)
    return e_sites, g_sites


def step_mix(lod: int, batch: int):
    """Counter of (direction, shape, mode, affine, eps) -> launches per intro step."""
    e_sites, g_sites = pass_sites(lod, batch)
    mix = collections.Counter()
    for sites, passes in ((e_sites, ENCODER_PASSES), (g_sites, GENERATOR_PASSES)):
        for key, calls in sites.items():
            for direction, n in zip(("fwd", "bwd"), passes):
                mix[(direction, *key)] += calls * n
    return mix


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time per call of ``fn``: CUDA events around ``iters`` calls that
    are queued behind a sleep kernel, so the host's time per call (the
    wrapper's checks and allocations) does not show between the launches.
    The sleep grows until it outlasts the host's queueing."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    cycles = SLEEP_CYCLES
    while True:
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        ran_dry = start.query()  # the sleep ended before every call was queued
        torch.cuda.synchronize()
        if not ran_dry or cycles >= 64 * SLEEP_CYCLES:
            return start.elapsed_time(end) / iters
        cycles *= 4


def _inputs(gen, shape, mode, affine, dtype, device):
    import torch

    bsz, ch, h, w = shape
    f32 = dict(generator=gen, device=device, dtype=torch.float32)
    x = (2.0 * torch.randn(shape, **f32) + 0.3).to(dtype)
    g = torch.randn((bsz, ch), **f32) + 1.0 if affine else None
    b = torch.randn((bsz, ch), **f32) if affine else None
    n = torch.randn((bsz, h, w), **f32) if mode == "noise" else None
    nw = torch.randn((ch,), **f32) if mode == "noise" else None
    dy = torch.randn(shape, **f32).to(dtype)
    dm, dv = torch.randn((bsz, ch), **f32), torch.randn((bsz, ch), **f32)
    return (x, torch.randn((ch,), **f32), g, b, n, nw), (dy, dm, dv)


def time_sites(device, mix, rate: float, iters: int = 20):
    """Each (direction, shape, mode, affine, eps) of ``mix`` timed alone in bf16
    and f32. Returns (rows, totals): rows (dtype, direction, shape, mode,
    affine, launches, ms, bound_ms); totals {(dtype, direction): [launches *
    ms, launches * bound_ms] summed over the sites}."""
    import torch

    from soft_intro_vae_torch.ops import adain_cuda

    gen = torch.Generator(device=device)
    gen.manual_seed(2)
    rows, totals = [], {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).replace("torch.", "")
        for (direction, shape, mode, affine, eps), launches in sorted(mix.items()):
            fargs, (dy, dm, dv) = _inputs(gen, shape, mode, affine, dtype, device)
            kw = dict(mode=mode, eps=eps)
            if direction == "fwd":
                ms = device_ms(lambda: adain_cuda.forward(*fargs, **kw), iters)
            else:
                x, bias, g, _, n, nw = fargs
                _, m, v = adain_cuda.forward(*fargs, **kw)
                ms = device_ms(lambda: adain_cuda.backward(dy, x, bias, g, n, nw, m, v, dm, dv,
                                                           **kw), iters)
            bound = norm_bytes(direction, shape, mode, affine, fargs[0].element_size()) / rate * 1e3
            tot = totals.setdefault((name, direction), [0.0, 0.0])
            tot[0] += launches * ms
            tot[1] += launches * bound
            rows.append((name, direction, shape, mode, affine, launches, ms, bound))
            del fargs, dy, dm, dv
    return rows, totals


def copy_floor(device, rate: float, iters: int = 20) -> str:
    """Device time of ``y.copy_(x)`` for the top site's x in bf16 (one read,
    one write of 33.5 MB): what a plain streaming kernel gets of the card's
    memory rate."""
    import torch

    x = torch.randn((4, 64, 256, 256), device=device).to(torch.bfloat16)
    y = torch.empty_like(x)
    ms = device_ms(lambda: y.copy_(x), iters)
    nbytes = 2 * x.numel() * x.element_size()
    return (f"copy_ of (4, 64, 256, 256) bf16: {ms:.4f} ms, {nbytes / ms / 1e9:.3f} TB/s "
            f"(bound {nbytes / rate * 1e3:.4f} ms)")


def row_line(row) -> str:
    name, direction, shape, mode, affine, launches, ms, bound = row
    return (f"{name} {direction} {tuple(shape)} {mode}{'+AdaIN' if affine else ''} x{launches}: "
            f"{ms:.4f} ms (bound {bound:.4f})")


def totals_line(totals) -> str:
    return "; ".join(f"{dt} {d} {v[0]:.4f} ms/step (bound {v[1]:.4f})"
                     for (dt, d), v in totals.items())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=ROOT, help="checkout whose soft_intro_vae_torch is timed")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_norm_sites: CUDA is not available", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import soft_intro_vae_torch

    if os.path.dirname(os.path.dirname(os.path.abspath(soft_intro_vae_torch.__file__))) != root:
        print(f"torch_norm_sites: soft_intro_vae_torch did not come from {root}", file=sys.stderr)
        return 1
    from soft_intro_vae_torch.ops import adain_cuda

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    adain_cuda.load()
    build_s = time.perf_counter() - t0
    mix = step_mix(6, 4)
    rate = memory_rate(torch.cuda.get_device_name(0))
    rows, totals = time_sites(device, mix, rate, args.iters)
    floor = copy_floor(device, rate, args.iters)
    print(f"card: {card}; package {root}; build+load {build_s:.2f} s")
    print(f"  yardstick: {floor}")
    for row in rows:
        print(f"  {row_line(row)}")
    print(f"per LOD-6 intro step: {totals_line(totals)}")
    print(json.dumps({"card": card, "root": root,
                      "sites": [[r[0], r[1], list(r[2]), r[3], r[4], r[5], r[6], r[7]] for r in rows],
                      "step_ms": {f"{dt} {d}": v[0] for (dt, d), v in totals.items()},
                      "step_bound_ms": {f"{dt} {d}": v[1] for (dt, d), v in totals.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
