"""Finding a cell's files by name.

``BENCHMARK.json`` at the checkout's root names the cells, configurations and
metrics; the harness finds the rest under ``<root>/perfbench``: the cell's traffic
and entry kind in ``cells/<cell>.json``, the entry in ``entries/<kind>.py`` and each
metric's reader in ``metrics/<metric>.py``. A later cell, configuration, entry or
metric is new files and new ``BENCHMARK.json`` entries; no existing file changes.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List


@dataclasses.dataclass
class Cell:
    root: Path  # the checkout's root: BENCHMARK.json and perfbench/
    name: str
    workload: dict  # the cell's entry of BENCHMARK.json's workloads
    cell: dict  # cells/<name>.json
    config: dict  # the configuration's file
    end_to_end: List[dict]  # the end-to-end metrics this cell reports
    per_layer: List[dict]  # the per-layer metrics this cell reports

    @property
    def bench_dir(self) -> Path:
        return self.root / "perfbench"

    def entry(self) -> ModuleType:
        return load_module(self.bench_dir / "entries" / f"{self.cell['entry']}.py")

    def reader(self, metric: str) -> ModuleType:
        return load_module(self.bench_dir / "metrics" / f"{metric}.py")


def _reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(root, name: str) -> Cell:
    """The cell ``name`` of the BENCHMARK.json under ``root``, with its files."""
    root = Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    workloads = {w["name"]: w for w in bench["workloads"]}
    if name not in workloads:
        raise KeyError(f"no workload {name!r} in {root / 'BENCHMARK.json'}")
    workload = workloads[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[workload["config"]]["file"]).read_text())
    cell = json.loads((root / "perfbench" / "cells" / f"{name}.json").read_text())
    if cell["config"] != workload["config"] or cell["traffic"]["name"] != workload["traffic"]:
        raise ValueError(f"cells/{name}.json disagrees with BENCHMARK.json on its "
                         "configuration or traffic")
    return Cell(root, name, workload, cell, config,
                [m for m in bench["end_to_end"] if _reports(m, name)],
                [m for m in bench["per_layer"] if _reports(m, name)])


_MODULES: Dict[Path, ModuleType] = {}


def load_module(path: Path) -> ModuleType:
    """Import the file ``path`` as a module of its own (file names may hold dots)."""
    path = Path(path).resolve()
    if path not in _MODULES:
        name = "perfbench_file_" + "_".join(path.with_suffix("").parts[-2:]).replace(".", "_")
        spec = importlib.util.spec_from_file_location(name, path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _MODULES[path] = module
    return _MODULES[path]
