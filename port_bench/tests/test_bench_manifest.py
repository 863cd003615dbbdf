"""BENCHMARK.json and the files it names: every cell's configuration,
traffic and limits file and every per-layer metric's reader exist and are
found by name, and every name and unit keeps to the allowed characters."""

import json
import re

import pytest

from port_bench import manifest

M = manifest.load()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in M["workloads"]]


def test_top_level_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert M["paths"] == ["port_bench"]
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51
    assert len(M["command"]) <= 32


def test_names_and_units():
    named = (M["configs"] + M["workloads"] + M["end_to_end"] + M["per_layer"])
    names = [x["name"] for x in named]
    for n in names:
        assert NAME.match(n), n
    for kind in ("configs", "workloads"):
        ns = [x["name"] for x in M[kind]]
        assert len(ns) == len(set(ns))
    metrics = [m["name"] for m in M["end_to_end"] + M["per_layer"]]
    assert len(metrics) == len(set(metrics))
    for m in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for w in M["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]


def test_end_to_end_bounds():
    names = {m["name"] for m in M["end_to_end"]}
    assert "setup_s" in names
    for m in M["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_are_found_by_name(cell):
    c = manifest.cell(cell)
    assert c["config"]["name"] == next(
        w["config"] for w in M["workloads"] if w["name"] == cell)
    e2e = {m["name"] for m in c["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c["per_layer"]
    for m in c["per_layer"]:
        assert callable(manifest.reader(m["name"]))
        assert m["moves"] in e2e
    assert c["limits"] and all("limit" in v for v in c["limits"].values())


def test_configs_are_files_of_their_own():
    files = [c["file"] for c in M["configs"]]
    assert len(files) == len(set(files))
    for c in M["configs"]:
        assert c["file"].startswith("port_bench/configs/")
        with open(manifest.ROOT / c["file"]) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert c["reduced"] == []


def test_every_metric_lists_existing_cells():
    for m in M["end_to_end"] + M["per_layer"]:
        for w in m.get("workloads", []):
            assert w in CELLS, (m["name"], w)
