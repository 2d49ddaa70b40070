"""Start N local ranks of ``parallel/verify.py`` and gather their results.

For tests and smoke runs: each rank is a process of its own that joins a
process group through a file store (no port to pick), runs the jobs of a
spec, and writes ``rank{r}of{n}.npz``. Every rank has the same join
deadline, so a collective that deadlocks fails the call instead of hanging
it; the spec's ``timeout_s`` bounds each collective inside the ranks too.
Users start their ranks with ``python -m torch.distributed.run``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import uuid
from typing import Dict, List, Optional

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def write_inputs(path: str, jobs: Dict[str, dict]) -> str:
    """Store each job's array arguments in one .npz (parallel/verify.py
    ``_inputs``): arrays, dicts of arrays, lists of dicts of arrays (None
    entries left out)."""
    flat = {}
    for name, args in jobs.items():
        for arg, v in args.items():
            if isinstance(v, dict):
                flat.update({f"{name}/{arg}/{k}": np.asarray(a) for k, a in v.items()})
            elif isinstance(v, (list, tuple)):
                for i, d in enumerate(v):
                    if d is not None:
                        flat.update({f"{name}/{arg}/{i}/{k}": np.asarray(a) for k, a in d.items()})
            else:
                flat[f"{name}/{arg}"] = np.asarray(v)
    np.savez(path, **flat)
    return path


def run_ranks(world: int, jobs: List[dict], workdir: str, *, inputs: Optional[str] = None,
              device: str = "cpu", backend: str = "auto", timeout_s: float = 60.0,
              env: Optional[dict] = None) -> List[Dict[str, np.ndarray]]:
    """Run ``jobs`` (``{"name", "probe", "kwargs"}``) in ``world`` ranks on
    ``device`` (every rank the same device: on one card that is gloo's
    two-ranks-on-one-card check); returns each rank's results, rank order.
    Raises with the ranks' output when one fails or the deadline passes."""
    run = os.path.join(workdir, f"ranks{world}_{uuid.uuid4().hex[:8]}")
    os.makedirs(run)
    spec = dict(jobs=jobs, inputs=inputs, device=device, backend=backend, timeout_s=timeout_s)
    spec_path = os.path.join(run, "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    child_env = dict(os.environ if env is None else env)
    child_env["PYTHONPATH"] = ROOT + os.pathsep + child_env.get("PYTHONPATH", "")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        child_env.pop(k, None)
    store = os.path.join(run, "store")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "soft_intro_vae_torch.parallel.verify", "--spec", spec_path,
         "--rank", str(r), "--world", str(world), "--store", store, "--out", run],
        env=child_env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    deadline = time.monotonic() + timeout_s
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        logs = [p.communicate()[0] for p in procs]
        raise TimeoutError(f"{world} rank(s) still running after {timeout_s} s:\n"
                           + "\n".join(f"--- rank {r}:\n{o}" for r, o in enumerate(logs)))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise RuntimeError(f"rank(s) {bad} of {world} failed:\n"
                           + "\n".join(f"--- rank {r}:\n{outs[r]}" for r in bad))
    results = []
    for r in range(world):
        with np.load(os.path.join(run, f"rank{r}of{world}.npz")) as z:
            results.append({k: z[k] for k in z.files})
    return results
