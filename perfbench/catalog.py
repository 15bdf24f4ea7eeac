"""Finds a cell's parts by the names `BENCHMARK.json` gives them:

- a configuration: the `file` of its entry in `configs`;
- a traffic mix: `perfbench/traffic/<traffic>.json`;
- a cell's limits: `perfbench/limits/<workload>.json`;
- a per-layer metric: `perfbench/metrics/<name>.py`, whose
  `read(readings)` returns a number, or None when it finds nothing to
  read.

Adding a configuration, a mix, a cell or a metric adds files and an
entry in `BENCHMARK.json`; nothing here changes."""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return load_json(os.path.join(ROOT, c["file"]))
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return load_json(os.path.join(HERE, "traffic", f"{name}.json"))


def limits(cell: str) -> dict:
    return load_json(os.path.join(HERE, "limits", f"{cell}.json"))["limits"]


def end_to_end(bench: dict, cell: str) -> list:
    return [m for m in bench["end_to_end"]
            if cell in m.get("workloads", [cell])]


def per_layer(bench: dict, cell: str) -> list:
    """The per-layer metrics a traced run of `cell` reports: those that
    list it, and those without a list whose end-to-end metric the cell
    reports."""
    reported = {m["name"] for m in end_to_end(bench, cell)}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in reported)]


def reader(name: str):
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
