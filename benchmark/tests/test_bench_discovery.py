"""A cell is found by name: a workload file dropped into benchmark/workloads/
and an entry in BENCHMARK.json are all a new cell of an existing
configuration needs; a new family of cells is a file of its own in
benchmark/families/, named by its configuration."""

import json
import shutil

from benchmark.core import harness


def test_new_cell_found_by_name(tmp_path, monkeypatch):
    here = tmp_path / "benchmark"
    shutil.copytree(harness.HERE, here, ignore=shutil.ignore_patterns(".data", ".cache",
                                                                       "__pycache__"))
    man = harness.manifest()
    man["workloads"].append({"name": "style-ffhq256.lod5-b8", "config": "style-ffhq256",
                             "traffic": "lod5-b8", "chips": 1, "why": "a dropped-in cell"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    (here / "workloads" / "style-ffhq256.lod5-b8.json").write_text(json.dumps(
        {"lod": 5, "batch": 8, "records": 64, "warmup_steps": 6, "trace_steps": 2,
         "why": "a dropped-in cell", "limits": {}}))
    monkeypatch.setattr(harness, "HERE", str(here))
    monkeypatch.setattr(harness, "ROOT", str(tmp_path))
    found = harness.find_cell(harness.manifest(), "style-ffhq256.lod5-b8")
    cfg = harness.load_json(harness.HERE, "configs", f"{found['config']}.json")
    cell = harness.load_json(harness.HERE, "workloads", f"{found['name']}.json")
    assert (cfg["family"], cell["lod"], cell["batch"]) == ("style", 5, 8)
    reported = harness.cell_metrics(harness.manifest(), found["name"], "end_to_end")
    assert {"setup_s", "peak_mem_gib"} <= {m["name"] for m in reported}
    for m in reported:
        assert callable(harness.load_reader(m["name"]))


def test_new_family_found_by_name(tmp_path, monkeypatch):
    here = tmp_path / "benchmark"
    (here / "families").mkdir(parents=True)
    (here / "families" / "dropped_in.py").write_text(
        "from benchmark.families.image import ImageCell\n\n\nclass Cell(ImageCell):\n"
        "    pass\n")
    monkeypatch.setattr(harness, "HERE", str(here))
    from benchmark.families.image import ImageCell

    found = harness.family_class("dropped_in")
    assert issubclass(found, ImageCell) and found is not ImageCell
    assert harness.family_class("dropped_in") is found  # loaded once
