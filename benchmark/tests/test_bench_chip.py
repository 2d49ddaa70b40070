"""On the card: one short run of a cell through the command the driver runs,
its result line read as the driver reads it, and the control's readings at
the cell's own size (a short calibration): the control must fail a limit
the program's seeds meet. Skips without a CUDA card."""

import json
import subprocess
import sys

import pytest
import torch

from benchmark.core import harness


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["image-cifar10.b32", "style-ffhq256.lod6-b32"])
def test_a_short_run_prints_a_correct_result(card, cell):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                          str(2 ** 32 + 17), "--seconds", "8", "--trace", "0"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    assert {"setup_s", "peak_mem_gib"} <= set(res["metrics"]) and len(res["metrics"]) >= 3
    assert out.stderr.strip().splitlines()[-1].startswith("check ")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["image-cifar10.b32", "style-ffhq256.lod6-b32"])
def test_the_control_fails_where_the_program_passes(card, cell):
    from benchmark.calibrate import readings

    entry = harness.find_cell(harness.manifest(), cell)
    cfg = harness.load_json(harness.HERE, "configs", f"{entry['config']}.json")
    traffic = harness.load_json(harness.HERE, "workloads", f"{cell}.json")
    limits = traffic["limits"]
    row = readings(cfg, traffic, 2 ** 32 + 99, True)
    assert all(row["program"][k] <= limits[k] for k in limits), row["program"]
    for fault in ("control", "half_batch"):
        assert any(row[fault][k] > limits[k] for k in limits), (fault, row[fault])
