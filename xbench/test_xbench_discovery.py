"""Every cell, configuration, traffic kind and metric that ``BENCHMARK.json``
names is found by its name, and the file keeps the benchmark's contract."""

import json
import re

import pytest

from xbench import harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["xbench"] and BENCH["command"][1] == "xbench/run.py"
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits the driver's 43,200 s
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names), names
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"] and w["chips"] in (1, 4)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_found_by_name(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    spec = harness.load_cell(cell)
    assert spec["config"] == entry["config"] and spec["traffic"]["kind"] == entry["traffic"]
    assert spec["why"] == entry["why"]
    assert callable(harness.driver_class(spec["traffic"]["kind"]))
    cfg = harness.load_config(spec["config"])
    conf = next(c for c in BENCH["configs"] if c["name"] == spec["config"])
    assert conf["file"] == f"xbench/configs/{spec['config']}.json" and cfg["name"] == conf["name"]
    assert spec["limits"]["margin_gap"] > 0
    e2e = [m["name"] for m in harness.reported(BENCH, cell, False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.reported(BENCH, cell, True)


def test_configs_used_and_unreduced():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert c["reduced"] == [] and c["source"].startswith("https://")


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_found_by_name(metric):
    read = harness.reader(metric)
    assert callable(read)
    entry = next(m for m in BENCH["per_layer"] if m["name"] == metric)
    assert entry["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    assert set(entry["workloads"]) <= set(CELLS)
    # every cell the metric lists reports the end-to-end metric it moves
    for cell in entry["workloads"]:
        assert entry["moves"] in [m["name"] for m in harness.reported(BENCH, cell, False)]


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")["bound"] == 0.25


def test_reported_without_workloads_key():
    bench = {"end_to_end": [{"name": "a"}, {"name": "b", "workloads": ["x"]}],
             "per_layer": [{"name": "p", "moves": "b"}, {"name": "q", "moves": "a"},
                           {"name": "r", "moves": "a", "workloads": ["y"]}]}
    assert [m["name"] for m in harness.reported(bench, "x", False)] == ["a", "b"]
    assert [m["name"] for m in harness.reported(bench, "x", True)] == ["p", "q"]
    assert [m["name"] for m in harness.reported(bench, "y", True)] == ["q", "r"]
