"""One run of one cell: ``python3 benchmark/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``.

Everything a cell is sits in files found by name: the cell in
``BENCHMARK.json``; its configuration in ``benchmark/configs/<config>.json``,
whose ``family`` names the trainer's loop, ``benchmark/families/<family>.py``
(its ``Cell``); its traffic in ``benchmark/workloads/<cell>.json``; each
metric's reader in ``benchmark/metrics/<metric>.py`` (its ``read``). A run:

1. fails, printing no result, without a CUDA card (or with fewer than the
   cell asks for); prints the card's name and power limit on standard error;
2. set-up: builds the program, the data and the weights from the seed, runs
   the warm-up through the window's own call and feed, so that every shape
   is captured before the window, and reads its checked steps (the first
   three, and the graph's first three replays); ``setup_s`` is process
   start to here;
3. the window (``benchmark/core/timing.py``), then the peak device memory;
   with ``--trace 1`` a profiled stretch of further steps;
4. fails if JAX or the JAX package is loaded;
5. frees the program and runs the reference over the checked steps
   (``correct``, benchmark/core/checks.py);
6. prints the compared numbers beside their limits as the last lines of
   standard error, and the result as the last line of standard output.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import subprocess
import sys
from typing import Dict, Optional

import torch

from benchmark.core import checks
from benchmark.core.timing import Spans, Trace, Window

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "soft_intro_vae_tpu")


def load_json(*parts: str) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(ROOT, "BENCHMARK.json")


def find_cell(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def cell_metrics(man: dict, cell: str, section: str):
    """The metrics of ``section`` this cell reports."""
    return [m for m in man[section] if cell in m.get("workloads", [cell])]


def _load(kind: str, name: str):
    """``benchmark/<kind>/<name>.py`` as a module (loaded once)."""
    path = os.path.join(HERE, kind, f"{name}.py")
    if not os.path.isfile(path):
        raise SystemExit(f"no file {path} for {name!r}")
    key = f"benchmark.{kind}.{name}"
    mod = sys.modules.get(key)
    if mod is not None and os.path.abspath(getattr(mod, "__file__", "") or "") == path:
        return mod
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_reader(name: str):
    """``metrics/<name>.py``'s ``read``."""
    return _load("metrics", name).read


def family_class(name: str):
    """``families/<name>.py``'s ``Cell``."""
    return _load("families", name).Cell


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card() -> Dict[str, str]:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True).stdout.strip().splitlines()[0]
        name, limit = (s.strip() for s in out.split(",", 1))
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        name, limit = torch.cuda.get_device_name(0), "unknown"
    return {"name": name, "power_limit": limit}


def peaks(card_name: str) -> dict:
    table = load_json(HERE, "peaks.json")["cards"]
    for key in ("PCIe", "NVL"):
        if key in card_name:
            return table[f"H100 {key}"]
    return table["H100 SXM"]


class Run:
    """What a metric's reader reads."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def parse(argv):
    ap = argparse.ArgumentParser(description="One run of one benchmark cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, started: float) -> int:
    args = parse(argv)
    man = manifest()
    entry = find_cell(man, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"this cell needs {entry['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    dev = card()
    print(f"card: {dev['name']}, power limit {dev['power_limit']}", file=sys.stderr, flush=True)
    cfg = load_json(HERE, "configs", f"{entry['config']}.json")
    cell = load_json(HERE, "workloads", f"{args.workload}.json")
    result = run_cell(args, man, cfg, cell, started, "cuda", peaks(dev["name"]))
    if result is None:
        return 3
    print(json.dumps(result), flush=True)
    return 0


def run_cell(args, man: dict, cfg: dict, cell: dict, started: float, device: str,
             card_peaks: dict) -> Optional[dict]:
    """One run on ``device`` (the harness's own tests drive it on the CPU);
    the result, or None where JAX was loaded."""
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    spans = Spans()
    fam = family_class(cfg["family"])(cfg, cell, args.seed, spans, device)
    fam.setup()
    window = Window(args.seconds, cuda)
    window.open()
    setup_s = window.t0 - started
    for _ in fam.steps():
        if not window.mark():
            break
    window.close()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    trace: Optional[Trace] = None
    if args.trace:
        trace = Trace.record(fam.run_steps, cell["trace_steps"], cuda)
    counted = window.counted()
    failed = fam.failed_steps(counted)
    if _jax_loaded():
        return None

    run = Run(args=args, cfg=cfg, cell=cell, fam=fam, spans=spans, window=window, trace=trace,
              setup_s=setup_s, peak_bytes=peak, steps=counted, batch=cell["batch"],
              peaks=card_peaks)
    metrics = {}
    for m in cell_metrics(man, args.workload, "per_layer" if args.trace else "end_to_end"):
        value = load_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    fam.close()
    limits = cell["limits"]
    recs, matched, wrong = fam.check_feed()
    if wrong:  # a row the reference cannot be fed: the step is not judged
        values = dict({k: math.nan for k in limits}, feed_rows_wrong=float(wrong))
    else:
        values = fam.numbers(fam.program_readings(), fam.reference(recs, matched), recs,
                             matched, wrong)
    correct = bool(limits) and checks.judge(values, limits) and failed == 0
    if _jax_loaded():
        return None

    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": counted, "failed": failed, "metrics": metrics,
              "device": device_info}
    if trace is not None:
        device_info["busy_s"] = trace.busy_seconds()
        device_info["window_s"] = trace.seconds
        result["breakdown"] = trace.breakdown()
    shown = {k: _num(values.get(k)) for k in (limits or values)}
    result["checks"] = {k: {"value": shown[k], "limit": limits.get(k)} for k in shown}
    for k in shown:
        print(f"check {k}: {shown[k]} limit {limits.get(k)}", file=sys.stderr)
    sys.stderr.flush()
    return result


def _jax_loaded() -> bool:
    found = forbidden_modules()
    if found:
        print(f"JAX or the JAX package is loaded: {found}", file=sys.stderr)
    return bool(found)


def _num(v) -> Optional[float]:
    return None if v is None or not math.isfinite(v) else v
