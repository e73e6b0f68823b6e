"""BENCHMARK.json keeps to the contract's forms, each cell's files exist,
and a cell file dropped into benchmark/workloads/ is found and run with
no code edited."""

import argparse
import json
import re
import shutil
from pathlib import Path

import pytest
import torch

from benchmark import harness, run

REPO = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def test_names_and_units():
    b = bench()
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for e in b[k]]
    names += [w["config"] for w in b["workloads"]] + [w["traffic"] for w in b["workloads"]]
    names += [k for c in b["configs"] for k in c["reduced"]]
    assert [n for n in names if not NAME.match(n)] == []
    assert [m["unit"] for k in ("end_to_end", "per_layer") for m in b[k]
            if not UNIT.match(m["unit"])] == []
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({e["name"] for e in b[k]}) == len(b[k])


def test_each_cell_has_its_files():
    b = bench()
    for c in b["configs"]:
        assert (REPO / c["file"]).is_file()
    for w in b["workloads"]:
        wl = harness.load_json("workloads", w["traffic"])
        assert wl["config"] == w["config"] and wl["chips"] == w["chips"]
        assert (harness.ROOT / "entries" / f"{wl['entry']}.py").is_file()
        assert (harness.ROOT / "flops" / f"{wl['config']}.py").is_file()
    for m in b["per_layer"]:
        assert (harness.ROOT / "metrics" / f"{m['name']}.py").is_file()
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and all(0 < m["bound"] <= 0.25 for m in e2e.values())


def test_metric_workloads_name_cells():
    """A per-layer metric's `workloads` list names cells, each once."""
    b = bench()
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        listed = m.get("workloads", sorted(cells))
        assert listed and set(listed) <= cells and len(set(listed)) == len(listed), m["name"]


def test_a_dropped_cell_is_found(tmp_path, monkeypatch):
    """A new workload file under a copy of benchmark/ runs by its name."""
    root = tmp_path / "benchmark"
    shutil.copytree(harness.ROOT, root, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    wl = json.loads((root / "workloads" / "edit_clip_b2.json").read_text())
    wl["editing"]["batch"] = 1
    (root / "workloads" / "dropped_cell.json").write_text(json.dumps(wl))
    monkeypatch.setattr(harness, "ROOT", root)
    args = argparse.Namespace(workload="dropped_cell", seed=7, seconds=0.5, trace=0)
    out = run.run_cell(args, torch.device("cpu"), tiny=True)
    assert out["correct"] and out["metrics"]["img_steps_per_s"]["value"] > 0


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "edit_clip_b2", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("cell", [w["name"] for w in json.loads(
    (REPO / "BENCHMARK.json").read_text())["workloads"]])
def test_cell_files_parse(cell):
    wl = harness.load_json("workloads", cell)
    assert set(wl["limits"]) <= {"grad", "grad_mid", "change", "change_median"}
    assert wl["warmup_steps"] >= wl["check_steps"] >= 3
