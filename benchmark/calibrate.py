#!/usr/bin/env python3
"""The readings a cell's limits are set from, in one process on the card:

    python3 benchmark/calibrate.py --workload <cell> --seeds 12 --faults 3 [--first N]

For each seed: the program's checked steps (the first three, and the
graph's first three replays), taken through the window's own call and feed
as a run takes them, against the reference's (the program's readings: the
lower ends of the limits). For the first
``--faults`` seeds also the control, the reference in the precision below
the configuration's (``control_precision``) put in the program's place,
and the fault of half the batch left out (the reference on the batch's
first half, its mean over those rows): the upper ends. ``--also bf16``:
the reference rounded to further precisions, for the record. Prints one
JSON line a seed and a summary; writes nothing else. No window is measured.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark.core import checks, harness  # noqa: E402
from benchmark.core.timing import Spans  # noqa: E402
from benchmark.reference.common import Precision  # noqa: E402


def readings(cfg: dict, cell: dict, seed: int, faults: bool, device: str = "cuda",
             also=()) -> dict:
    cell = dict(cell, warmup_steps=0)  # the checked steps alone
    fam = harness.family_class(cfg["family"])(cfg, cell, seed, Spans(), device)
    fam.setup()
    fam.close()
    recs, matched, wrong = fam.check_feed()
    prog = fam.program_readings()
    ref = fam.reference(recs, matched)
    out = {"seed": seed, "program": fam.numbers(prog, ref, recs, matched, wrong),
           "look": checks.look(prog[0].as_dict(), ref[0].as_dict(),
                               fam.d_phase(recs, matched, prog[0].encoder_after))}
    if faults:
        for name, side in (
                ("control", fam.reference(recs, matched, Precision(cfg["control_precision"]))),
                ("half_batch", fam.reference(recs, matched, half=True)),
                *((f"ref_{k}", fam.reference(recs, matched, Precision(k))) for k in also)):
            out[name] = fam.numbers(side, ref, recs, matched, 0)
    out["losses"] = {"program": prog[0].losses + prog[1].losses,
                     "reference": ref[0].losses + ref[1].losses}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--first", type=int, default=7_000_000_001)
    ap.add_argument("--also", nargs="*", default=(), help="further precisions of the reference")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    man = harness.manifest()
    entry = harness.find_cell(man, args.workload)
    cfg = harness.load_json(harness.HERE, "configs", f"{entry['config']}.json")
    cell = harness.load_json(harness.HERE, "workloads", f"{args.workload}.json")
    print(f"card: {harness.card()}", flush=True)
    rows = []
    for i in range(args.seeds):
        t0 = time.perf_counter()
        row = readings(cfg, cell, args.first + 7919 * i, i < args.faults, also=args.also)
        row["seconds"] = time.perf_counter() - t0
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {"workload": args.workload, "lower": {}, "upper": {}}
    for k in rows[0]["program"]:
        summary["lower"][k] = max(r["program"][k] for r in rows)
        summary["upper"][k] = {f: min(r[f][k] for r in rows if f in r)
                               for f in ("control", "half_batch")}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
