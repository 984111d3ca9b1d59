"""The benchmark's files: every cell resolves its configuration, entry and metric
readers by name, BENCHMARK.json keeps to the contract's shapes, and a cell is added by
new files alone."""
import json
import re
from pathlib import Path

import pytest

from perfbench.harness import bench
from perfbench.tests import tiny

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves_its_files(name):
    cell = bench.load_cell(REPO, name)
    entry = cell.entry()
    for fn in ("setup", "window", "release", "judge"):
        assert callable(getattr(entry, fn))
    assert cell.end_to_end and cell.per_layer
    assert "setup_s" in [m["name"] for m in cell.end_to_end]
    assert len(cell.end_to_end) >= 2
    for m in cell.end_to_end + cell.per_layer:
        assert callable(cell.reader(m["name"]).read)
    assert cell.cell["limits"], "a cell compares at least one number"


def test_benchmark_json_shapes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = len(BENCH["workloads"])
    # a full check with all 24 cells fits its 43,200 s
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(x["name"] for x in BENCH["end_to_end"] + BENCH["per_layer"])) == \
        len(BENCH["end_to_end"]) + len(BENCH["per_layer"])
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (REPO / c["file"]).is_file() and c["file"].startswith("perfbench/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert UNIT.match(m["unit"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer",
                                         "moves"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
    assert cells <= 24 and len(json.dumps(BENCH)) < 64 * 1024


def test_a_cell_is_added_by_new_files_alone(tmp_path):
    """A throwaway cell, configuration and metric in a temporary copy: new files and
    new BENCHMARK.json entries, and no file of the copy edited."""
    root = tiny.make_root(tmp_path)
    before = {p: p.read_bytes() for p in (REPO / "perfbench").rglob("*")
              if p.is_file() and "__pycache__" not in p.parts and "tests" not in p.parts}
    reader = root / "perfbench" / "metrics" / "throwaway.count.py"
    reader.write_text("def read(run):\n    return run.window['attempted']\n")
    data = json.loads((root / "BENCHMARK.json").read_text())
    data["per_layer"].append({"name": "throwaway.count", "unit": "scenes", "better": "higher",
                              "source": "program_counter", "layer": "scene runner",
                              "moves": "frames_per_s", "workloads": ["scene-tiny.tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(data))
    cell = bench.load_cell(root, "scene-tiny.tiny")
    assert cell.config["name"] == "scene-tiny"
    assert "throwaway.count" in [m["name"] for m in cell.per_layer]
    assert cell.reader("throwaway.count").read(type("R", (), {"window": {"attempted": 3}})) == 3
    for p, b in before.items():
        copy = root / p.relative_to(REPO)
        assert copy.read_bytes() == b, f"{p} changed"
