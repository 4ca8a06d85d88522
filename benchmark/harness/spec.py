"""``BENCHMARK.json`` and the files it names.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, found by its name:

- ``configs/<config>.json``: the sizes as they are run, the model family,
  the precision, the source, what was cut (``reduced``) and assumed;
- ``traffic/<traffic>.json``: a mix's parameters, and ``kind``, the
  generator ``traffic/<kind>.py`` that reads them;
- ``workloads/<cell>.json``: the limits of the cell's comparison with the
  reference;
- ``metrics/<metric>.py``: the reader of one per-layer metric.

A later change adds a cell, a configuration, a mix or a metric by adding
such files and entries, and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_json(path: Path) -> Dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load_module(path: Path) -> ModuleType:
    """A module from a file under the benchmark, by path (the generators and
    metric readers are not a package)."""
    name = "bench_" + "_".join(path.with_suffix("").parts[-2:]).replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    """One cell of ``BENCHMARK.json`` with its files read."""

    name: str
    entry: Dict
    config: Dict
    traffic: Dict
    workload: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]
    bench_dir: Path = BENCH_DIR

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])

    def generator(self) -> ModuleType:
        return load_module(self.bench_dir / "traffic" / f"{self.traffic['kind']}.py")

    def metric_reader(self, name: str) -> ModuleType:
        return load_module(self.bench_dir / "metrics" / f"{name}.py")


def benchmark(root: Path = ROOT) -> Dict:
    return load_json(root / "BENCHMARK.json")


def _reports(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json`` with its files read
    (its benchmark folder: ``root / "benchmark"``)."""
    bench, bench_dir = benchmark(root), root / BENCH_DIR.name
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if len(entries) != 1:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    entry = entries[0]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[entry["config"]]["file"])
    return Cell(
        name=name, entry=entry, config=config,
        traffic=load_json(bench_dir / "traffic" / f"{entry['traffic']}.json"),
        workload=load_json(bench_dir / "workloads" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
        bench_dir=bench_dir,
    )
