"""BENCHMARK.json against the contract's shape, and every name it holds
found as a file of its own."""

import json
import os
import re

import pytest

from benchmark.core import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MAN = harness.manifest()
CELLS = [w["name"] for w in MAN["workloads"]]
METRICS = MAN["end_to_end"] + MAN["per_layer"]


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "benchmark/run.py"]
    assert MAN["paths"] == ["benchmark"]
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51
    assert len(json.dumps(MAN)) <= 64 * 1024


@pytest.mark.parametrize("name", [c["name"] for c in MAN["configs"]] + CELLS
                         + [m["name"] for m in METRICS])
def test_names(name):
    assert NAME.match(name), name


def test_names_unique():
    for group in (MAN["configs"], MAN["workloads"], METRICS):
        names = [g["name"] for g in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("metric", METRICS, ids=[m["name"] for m in METRICS])
def test_metric_fields(metric):
    assert UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert set(metric.get("workloads", [])) <= set(CELLS)
    assert callable(harness.load_reader(metric["name"]))
    if metric in MAN["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
        assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}
    else:
        assert metric["moves"] in [m["name"] for m in MAN["end_to_end"]]
        assert metric["layer"] and "\n" not in metric["layer"]
        assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves",
                               "workloads"}
        # every cell it lists reports the metric it moves
        moved = next(m for m in MAN["end_to_end"] if m["name"] == metric["moves"])
        assert set(metric["workloads"]) <= set(moved.get("workloads", CELLS))


@pytest.mark.parametrize("cell", MAN["workloads"], ids=CELLS)
def test_cell_files(cell):
    assert cell["chips"] in (1, 4)
    assert len(cell["why"]) <= 200 and "\n" not in cell["why"]
    assert cell["name"] == f"{cell['config']}.{cell['traffic']}"
    traffic = harness.load_json(harness.HERE, "workloads", f"{cell['name']}.json")
    assert traffic["why"] == cell["why"]
    limits = traffic["limits"]
    assert limits["feed_rows_wrong"] == 0 and len(limits) >= 3
    assert "change_median_gap" in limits  # a step that leaves its state unchanged
    assert set(limits) <= {"feed_rows_wrong", "loss1_e_gap", "loss1_d_gap", "loss_gap",
                           "grad_e_gap", "grad_e_median_gap", "grad_d_gap", "grad_d_median_gap",
                           "grad_e_share_median_gap", "grad_d_share_median_gap",
                           "replay_grad_e_share_median_gap",
                           "change_gap", "change_median_gap", "ema_gap", "ema_median_gap",
                           "kl1_gap", "replay_loss_e_gap", "replay_kl_gap", "replay_loss_gap",
                           "replay_grad_e_gap", "replay_grad_e_median_gap", "replay_change_gap",
                           "replay_change_median_gap", "replay_ema_gap", "replay_ema_median_gap"}
    # the graph's replays, the path every window step takes, are compared too
    assert any(k.startswith("replay_") for k in limits)
    cfg = next(c for c in MAN["configs"] if c["name"] == cell["config"])
    assert os.path.isfile(os.path.join(harness.ROOT, cfg["file"]))
    reported = [m["name"] for m in MAN["end_to_end"] if cell["name"] in m.get("workloads", CELLS)]
    assert "setup_s" in reported and len(reported) >= 2
    assert "train_samples_per_s" in reported
    assert any(cell["name"] in m.get("workloads", CELLS) for m in MAN["per_layer"])


@pytest.mark.parametrize("cfg", MAN["configs"], ids=[c["name"] for c in MAN["configs"]])
def test_config_files(cfg):
    assert cfg["file"].startswith("benchmark/configs/")
    body = harness.load_json(harness.ROOT, cfg["file"])
    assert set(cfg["reduced"]) == set(body["reduced"])
    assert os.path.isfile(os.path.join(harness.HERE, "families", f"{body['family']}.py"))
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
