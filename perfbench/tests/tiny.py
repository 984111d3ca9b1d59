"""A tiny copy of the benchmark for the CPU: the real files under a temporary root,
with small configurations and cells beside them (new files only)."""
from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

TINY_SCENE = {"frame_hw": [96, 128], "cads": 2, "cad_subdiv": 2, "steps": 2}
TINY_TRAFFIC = {"name": "tiny", "vehicles": 1, "pool": 2, "focal_px": 150.0}


def make_root(tmp: Path, window_first: int = 0) -> Path:
    """``tmp`` holding BENCHMARK.json and perfbench/ as committed, plus the cells
    ``scene-tiny.tiny`` and ``train-tiny.tiny`` on small configurations."""
    shutil.copy(REPO / "BENCHMARK.json", tmp / "BENCHMARK.json")
    shutil.copytree(REPO / "perfbench", tmp / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((tmp / "BENCHMARK.json").read_text())
    pb = tmp / "perfbench"

    scene_cfg = json.loads((pb / "configs" / "scene-720p-f32.json").read_text())
    scene_cfg.update(TINY_SCENE, name="scene-tiny")
    (pb / "configs" / "scene-tiny.json").write_text(json.dumps(scene_cfg))
    scene_cell = json.loads((pb / "cells" / "scene-720p-f32.v4.json").read_text())
    scene_cell["config"] = "scene-tiny"
    scene_cell["traffic"].update(TINY_TRAFFIC)
    scene_cell["trace"] = {"first": window_first, "count": 1}
    scene_cell["judge"] = {"scenes": 1}
    (pb / "cells" / "scene-tiny.tiny.json").write_text(json.dumps(scene_cell))

    train_cfg = json.loads((pb / "configs" / "icn-train-256-f32.json").read_text())
    train_cfg.update(name="train-tiny")
    (pb / "configs" / "train-tiny.json").write_text(json.dumps(train_cfg))
    train_cell = json.loads((pb / "cells" / "icn-train-256-f32.b8.json").read_text())
    train_cell["config"] = "train-tiny"
    train_cell["traffic"].update(name="tiny", batch=2)
    train_cell["trace"] = {"first": window_first, "count": 1}
    (pb / "cells" / "train-tiny.tiny.json").write_text(json.dumps(train_cell))

    bench["configs"] += [dict(bench["configs"][0], name="scene-tiny",
                              file="perfbench/configs/scene-tiny.json"),
                         dict(bench["configs"][1], name="train-tiny",
                              file="perfbench/configs/train-tiny.json")]
    bench["workloads"] += [
        {"name": "scene-tiny.tiny", "config": "scene-tiny", "traffic": "tiny", "chips": 1,
         "why": "tiny scene for the CPU"},
        {"name": "train-tiny.tiny", "config": "train-tiny", "traffic": "tiny", "chips": 1,
         "why": "tiny training for the CPU"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            tiny = []
            if "scene-720p-f32.v4" in m["workloads"]:
                tiny.append("scene-tiny.tiny")
            if "icn-train-256-f32.b8" in m["workloads"]:
                tiny.append("train-tiny.tiny")
            m["workloads"] = m["workloads"] + tiny
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return tmp


def with_limits(root: Path, cell: str, limits: dict) -> None:
    """Give the tiny cell ``cell`` the limits ``limits``."""
    path = root / "perfbench" / "cells" / f"{cell}.json"
    data = json.loads(path.read_text())
    data["limits"] = copy.deepcopy(limits)
    path.write_text(json.dumps(data))
