"""Tiny rehearsals of each cell on the CPU, the command's refusal
without a card, and a mix, a cell and a metric added as files alone."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from perfbench import catalog, harness, roofline
from perfbench.tests import support

ROOT = catalog.ROOT
CELLS = [w["name"] for w in catalog.benchmark()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_rehearsal_is_correct(monkeypatch, cell):
    # long enough on the CPU to keep as many queries as the check needs
    run = support.run_small(monkeypatch, cell, seconds=8.0)
    r = run.result
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1
    assert set(r["metrics"]) == {"queries_per_s", "setup_s"}
    assert all(v["value"] > 0 for v in r["metrics"].values())
    assert list(r)[-1] == "checks"


def test_command_refuses_without_a_card():
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "perfbench", "run.py"),
         "--workload", CELLS[0], "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_command_needs_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and perfbench/, the
    command prints no result and fails."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "perfbench"), tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": ""})
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_new_mix_cell_and_metric_are_found_by_name(monkeypatch, tmp_path):
    """A later PR adds a traffic file, a metric reader, a limits file and
    entries in BENCHMARK.json; no existing file changes."""
    here = tmp_path / "perfbench"
    shutil.copytree(catalog.HERE, here,
                    ignore=shutil.ignore_patterns("__pycache__"))
    mix = catalog.traffic("tsbs-double-groupby-1")
    mix.update(fields=["usage_system"], workers=3, check_sample=4)
    (here / "traffic" / "dummy-mix.json").write_text(json.dumps(mix))
    (here / "metrics" / "dummy_rows_per_query.py").write_text(
        "def read(r):\n"
        "    return r.scan_work.rows * r.fields_per_query\n")
    (here / "limits" / "dummy-cell.json").write_text(json.dumps(
        {"limits": {"avg_gap": 0.001, "count_wrong": 0,
                    "series_wrong": 0, "queries_checked": 1}}))
    monkeypatch.setattr(catalog, "HERE", str(here))
    bench = catalog.benchmark()
    bench["workloads"].append({"name": "dummy-cell",
                               "config": "tsbs-cpu-only-1000-default",
                               "traffic": "dummy-mix", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "dummy_rows_per_query", "unit": "rows",
                               "better": "lower", "source": "program_counter",
                               "layer": "test", "moves": "queries_per_s"})
    run = support.run_small(monkeypatch, "dummy-cell", bench=bench)
    assert run.result["correct"], run.result["checks"]
    names = [m["name"] for m in catalog.per_layer(bench, "dummy-cell")]
    # a metric without a `workloads` list reads in every cell
    assert names == ["query_p95_ms", "dummy_rows_per_query"]
    readings = harness.Readings(
        queries=3, fields_per_query=1, counters={}, stages={}, trace=None,
        scan_work=roofline.field_scan_work(12, 43_200_000, 10_000,
                                           3_600_000, ["avg"]),
        segment_rows=12 * 720, card="cpu", latencies_ms=[1.0, 2.0])
    assert catalog.reader("dummy_rows_per_query")(readings) == 12 * 4320
