"""BENCHMARK.json against the contract, and every name to its files."""

import json
import math
import shutil

import pytest

from harness import spec

BENCH = spec.benchmark()
NAMES = ([c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
         + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
ONE_LINE = 200


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells: 2 + 14 x 24 runs of run_seconds + 60, 2 x 90 s a cell
    # to compile, 1,200 s spare, within 43,200 s
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("name", NAMES)
def test_names(name):
    assert spec.NAME.match(name), name


def test_names_unique():
    for group in ("configs", "workloads"):
        names = [x["name"] for x in BENCH[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))


def test_metric_entries():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert spec.UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and 1 <= len(m["layer"]) <= ONE_LINE
        assert set(m.get("workloads", cells)) <= cells


def test_entries_and_lines():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["source"].startswith("https://") and len(c["source"]) <= ONE_LINE
        assert 1 <= len(c["why"]) <= ONE_LINE and "\n" not in c["why"]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= ONE_LINE and "\n" not in w["why"]
        assert spec.NAME.match(w["traffic"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves_to_its_files(name):
    cell = spec.cell(name)
    assert cell.generator().Driver
    for m in cell.per_layer:
        assert callable(cell.metric_reader(m["name"]).read)
    assert cell.config["family"] in ("vilbert", "basebert")
    assert cell.config["reduced"] == [
        c for c in BENCH["configs"] if c["name"] == cell.entry["config"]][0]["reduced"]
    limits = cell.workload["limits"]
    assert limits and all(v is not None and math.isfinite(v) and v > 0 for v in limits.values())
    driver = cell.generator().Driver
    e2e = {m["name"] for m in cell.end_to_end}
    assert e2e == {"setup_s", driver.rate_metric, driver.tail_metric} and cell.per_layer
    assert all(m["moves"] == driver.rate_metric for m in cell.per_layer)


def test_every_config_is_used():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


def test_new_cell_and_metric_are_files_only(tmp_path):
    """A cell (a new mix of an existing generator) and a per-layer metric,
    added as files and entries alone, are found and run."""
    root = tmp_path
    shutil.copytree(spec.BENCH_DIR, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "vilbert_6l6c.cc_short", "config": "vilbert_6l6c",
                               "traffic": "cc_short", "chips": 1, "why": "a test cell"})
    bench["per_layer"].append({"name": "samples_traced", "unit": "samples", "better": "higher",
                               "source": "host_clock", "layer": "models",
                               "moves": "samples_per_s", "workloads": ["vilbert_6l6c.cc_short"]})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "vilbert_6l6c.cc_pretrain" in m.get("workloads", ()):
            m["workloads"].append("vilbert_6l6c.cc_short")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    mix = spec.load_json(spec.BENCH_DIR / "traffic" / "cc_pretrain.json")
    (root / "benchmark" / "traffic" / "cc_short.json").write_text(json.dumps(mix))
    limits = spec.load_json(spec.BENCH_DIR / "workloads" / "vilbert_6l6c.cc_pretrain.json")
    (root / "benchmark" / "workloads" / "vilbert_6l6c.cc_short.json").write_text(
        json.dumps(limits))
    (root / "benchmark" / "metrics" / "samples_traced.py").write_text(
        "def read(t):\n    return float(t.window.samples)\n")
    cell = spec.cell("vilbert_6l6c.cc_short", root=root)
    assert cell.traffic == mix and cell.generator().Driver.train
    assert [m["name"] for m in cell.per_layer][-1] == "samples_traced"
    assert {m["name"] for m in cell.end_to_end} == {"samples_per_s", "step_ms_p90", "setup_s"}

    class Seen:
        class window:
            samples = 7

    assert cell.metric_reader("samples_traced").read(Seen) == 7.0
    old = spec.cell("vilbert_6l6c.cc_pretrain", root=root)
    assert "samples_traced" not in [m["name"] for m in old.per_layer]
