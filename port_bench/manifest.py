"""The benchmark's manifest, BENCHMARK.json at the root of the checkout,
and the files it names: each configuration's file, each traffic mix at
traffic/<name>.json, each cell's limits at limits/<cell>.json and each
per-layer metric's reader at metrics/<name>.py. A cell is found by its name
alone, so a later cell, mix, configuration or metric is a new file and a
new entry, never an edit of a file that is there."""

from __future__ import annotations

import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
MANIFEST = ROOT / "BENCHMARK.json"


def load(path: pathlib.Path = MANIFEST) -> dict:
    with open(path) as f:
        return json.load(f)


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, manifest: dict = None) -> dict:
    """The workload `name` with its configuration, traffic, limits and
    metrics loaded."""
    manifest = manifest or load()
    found = [w for w in manifest["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in {MANIFEST.name}: "
                       f"{[w['name'] for w in manifest['workloads']]}")
    w = found[0]
    conf = next(c for c in manifest["configs"] if c["name"] == w["config"])
    with open(ROOT / conf["file"]) as f:
        config = json.load(f)
    with open(HERE / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    with open(HERE / "limits" / f"{name}.json") as f:
        limits = json.load(f)
    return {
        "name": name, "chips": w["chips"], "config": config,
        "traffic": traffic, "limits": limits,
        "end_to_end": [m for m in manifest["end_to_end"] if applies(m, name)],
        "per_layer": [m for m in manifest["per_layer"] if applies(m, name)],
    }


def reader(metric_name: str):
    """The `read(ctx)` function of metrics/<metric_name>.py."""
    path = HERE / "metrics" / f"{metric_name}.py"
    spec = importlib.util.spec_from_file_location(
        f"port_bench.metrics.{metric_name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
