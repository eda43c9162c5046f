"""BENCHMARK.json against the benchmark's contract, and every cell, traffic
mix, driver, metric and limit resolved to its own file by name."""

import json
import re

import pytest

from conftest import ROOT

from bench_h100 import harness

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench_h100"]
    assert BENCH["command"] == ["python3", "bench_h100/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("name", [m["name"] for m in METRICS] + CELLS
                         + [c["name"] for c in BENCH["configs"]]
                         + [w["traffic"] for w in BENCH["workloads"]])
def test_names_use_allowed_characters(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_entry(metric):
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    keys = set(metric) - {"workloads"}
    if metric in BENCH["end_to_end"]:
        assert keys == {"name", "unit", "better", "bound", "source"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert keys == {"name", "unit", "better", "source", "layer", "moves"}
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
    assert set(metric.get("workloads", CELLS)) <= set(CELLS)


def test_every_cell_reports_setup_another_metric_and_a_layer():
    for cell in CELLS:
        r = harness.resolve(BENCH, cell)
        names = {m["name"] for m in r.end_to_end}
        assert "setup_s" in names and len(names) >= 2, cell
        assert r.per_layer, cell


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_has_its_reader_and_reports_what_it_moves(metric):
    assert callable(harness.metric_module(metric["name"]).read)
    moves = next(m for m in BENCH["end_to_end"] if m["name"] == metric["moves"])
    # each cell that reads the metric reports the end-to-end metric it moves
    assert set(metric["workloads"]) <= set(moves.get("workloads", CELLS))
    if metric["unit"] == "%" and ("roofline" in metric["name"]
                                  or "mfu" in metric["name"]):
        assert metric["better"] == "higher"


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_resolves_to_its_files(cell):
    assert cell["chips"] == 1
    assert 1 <= len(cell["why"]) <= 200 and "\n" not in cell["why"]
    r = harness.resolve(BENCH, cell["name"])
    assert (ROOT / "bench_h100" / "drivers" / f"{r.driver}.py").is_file()
    drv = harness.driver_module(r.driver)
    for fn in ("setup", "window", "check", "control_readings"):
        assert callable(getattr(drv, fn))
    limits = json.loads((ROOT / "bench_h100" / "limits"
                         / f"{cell['name']}.json").read_text())
    for name, v in limits["numbers"].items():
        assert v["lower"] < v["limit"] < v["upper"], name


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_file(entry):
    assert entry["file"].startswith("bench_h100/configs/")
    config = json.loads((ROOT / entry["file"]).read_text())
    assert config["name"] == entry["name"]
    assert config["source"] == entry["source"]
    assert config["reduced"] == entry["reduced"]
    assert set(entry["reduced"]) <= set(config)
    assert len(entry["reduced"]) <= 16
    for key in entry["reduced"]:
        assert NAME.match(key)
        assert not key.endswith(("_dim", "_rank")) and "hidden" not in key
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))


def test_names_are_unique():
    for group in (METRICS, BENCH["workloads"], BENCH["configs"]):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
