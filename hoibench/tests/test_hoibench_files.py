"""``BENCHMARK.json`` and the files it names: each loads, and each cell has
what it reports."""

from __future__ import annotations

import json
import re

import pytest

from hoibench import harness

BENCH = harness.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert BENCH["paths"] == ["hoibench"]
    assert 1 <= BENCH["run_seconds"] <= 51


def test_names_units_and_entry_keys():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    names += CELLS
    assert all(NAME.match(n) for n in names)
    assert len(set(CELLS)) == len(CELLS)
    assert len({m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}) == \
        len(BENCH["end_to_end"]) + len(BENCH["per_layer"])


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_loads_with_its_driver(cell):
    c = harness.load_cell(BENCH, cell)
    module = harness.load_driver(c["driver"])
    assert hasattr(module, "Driver")
    assert set(c["limits"]) and c["traced_units"] > 0
    assert c["config_params"]["source"] in {x["source"] for x in BENCH["configs"]}


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_per_layer_reader_loads_and_its_cells_report_what_it_moves(metric):
    entry = next(m for m in BENCH["per_layer"] if m["name"] == metric)
    assert callable(harness.load_reader(metric).read)
    for cell in entry["workloads"]:
        e2e, layer = harness.metrics_for(BENCH, cell)
        assert entry["moves"] in {m["name"] for m in e2e}
        assert metric in {m["name"] for m in layer}


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric(cell):
    e2e, layer = harness.metrics_for(BENCH, cell)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and layer


def test_every_config_is_used_and_its_file_is_its_own():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        assert c["file"] == f"hoibench/configs/{c['name']}.json"
        assert harness.load_json(harness.CHECKOUT / c["file"])
