"""The benchmark's files: every cell, configuration, traffic mix, limits
file and metric loads by the name `BENCHMARK.json` gives it, unknown names
fail, and `BENCHMARK.json` keeps to the shape the check reads."""

from __future__ import annotations

import re
from pathlib import Path

import pytest

from gpubench import harness
from gpubench.tests._cells import TINY, full_cell

BENCH = harness.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_loads_by_name(name):
    cell = harness.Cell.load(BENCH, name)
    assert cell.config == full_cell(name).config and cell.traffic == full_cell(name).traffic


@pytest.mark.parametrize("name", sorted(TINY))
def test_cell_files_load(name):
    cell = full_cell(name)
    assert cell.traffic["call"] in ("reduce", "reduce_images")
    assert cell.limits["compare"] and cell.limits["sample_calls"] >= 1
    assert "train_max_size" in cell.processor_options()


@pytest.mark.parametrize("name", METRICS)
def test_metric_reader_loads_by_name(name):
    assert callable(harness.load_reader(name))


@pytest.mark.parametrize("loader", [harness.load_config, harness.load_traffic,
                                    harness.load_limits, harness.load_reader])
def test_unknown_name_fails(loader):
    with pytest.raises(KeyError):
        loader("no-such-name")
    with pytest.raises(KeyError):
        loader("../BENCHMARK")


def test_unknown_workload_fails():
    with pytest.raises(KeyError):
        harness.Cell.load(BENCH, "no-such-cell")


def test_benchmark_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["gpubench"] and 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]] + CELLS + METRICS
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    root = harness.ROOT
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("gpubench/") and (root / c["file"]).is_file()
        assert Path(c["file"]).stem == c["name"] and c["reduced"] == []
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200 and NAME.match(w["traffic"])
    for m in BENCH["end_to_end"]:
        assert UNIT.match(m["unit"]) and 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in e2e and m["layer"]
        assert all(w in CELLS for w in m.get("workloads", CELLS))
    for cell in CELLS:
        assert "setup_s" in [m["name"] for m in harness.cell_metrics(BENCH, cell, False)]
        assert len(harness.cell_metrics(BENCH, cell, False)) >= 2
        assert harness.cell_metrics(BENCH, cell, True)
