"""BENCHMARK.json keeps to the benchmark's contract: keys, names,
lengths, files found by name, bounds, and the configurations' cuts."""

import json
import os
import re

from perfbench import catalog

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = catalog.benchmark()


def line_ok(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_entries():
    cfg_names = {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line_ok(c["source"])
        assert line_ok(c["why"]) and c["file"].startswith("perfbench/")
        body = catalog.config(BENCH, c["name"])
        assert sorted(c["reduced"]) == sorted(body["reduced"])
        assert all(k in body for k in c["reduced"])
    seen = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in cfg_names
        assert w["chips"] == 1 and line_ok(w["why"])
        assert (w["config"], w["traffic"]) not in seen
        seen.add((w["config"], w["traffic"]))
        catalog.traffic(w["traffic"])
        catalog.limits(w["name"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["moves"] in e2e and line_ok(m["layer"])
        assert set(m.get("workloads", [])) <= {w["name"]
                                               for w in BENCH["workloads"]}
        assert callable(catalog.reader(m["name"]))


def test_configs_keep_example_toml_but_their_stated_changes():
    import tomllib

    with open(os.path.join(catalog.ROOT, "docs", "example.toml"), "rb") as f:
        example = tomllib.load(f)["metric_engine"]["time_merge_storage"]

    def flat(d, pre=""):
        out = {}
        for k, v in d.items():
            if isinstance(v, dict):
                out.update(flat(v, f"{pre}{k}."))
            else:
                out[pre + k] = v
        return out

    for c in BENCH["configs"]:
        body = catalog.config(BENCH, c["name"])
        got, want = flat(body["storage"]), flat(example)
        assert set(got) == set(want)
        changed = {k for k in got if got[k] != want[k]}
        assert changed == set(body["storage_changed_from_example_toml"])
