"""Mixes that name a host set per query (`host_draw`) and ask for exact
aggregates (`max`, `min`): the draws, the matcher the engine gets, the
check's new numbers against planted faults, TSBS `cpu-max-all-8` end to
end on a stub engine, a max mix on the real program, and today's two
mixes unchanged in their calls and their checks."""

import asyncio
import copy
import hashlib
import json
import shutil

import numpy as np
import pytest

from perfbench import catalog, check, control, deploy, harness, loadgen, tsbs
from perfbench.tests import support

MAX_MIX = "tsbs-cpu-max-all-8"
CONFIG = "tsbs-cpu-only-1000-cardcache"
EXACT_LIMITS = {"max_wrong": 0, "count_wrong": 0, "series_wrong": 0,
                "queries_checked": 1}


def test_host_draws_are_seeded_distinct_and_uniform():
    traffic, config = {"host_draw": 8}, {"scale": 40}
    draw = loadgen.host_drawer(traffic, config, [2**40 + 9, 3])
    again = loadgen.host_drawer(traffic, config, [2**40 + 9, 3])
    other = loadgen.host_drawer(traffic, config, [2**40 + 10, 3])
    sets = [draw(i) for i in range(4000)]
    for i in (0, 1, 3999):
        np.testing.assert_array_equal(sets[i], again(i))
    assert not all(np.array_equal(sets[i], other(i)) for i in range(5))
    assert all(len(set(h.tolist())) == 8 for h in sets)
    every = np.concatenate(sets)
    assert every.min() >= 0 and every.max() < 40
    hits = np.bincount(every, minlength=40)
    # 32,000 draws over 40 hosts: 800 each; chi-square, 39 degrees of
    # freedom, far under its 0.1% tail (72.1)
    chi2 = float(((hits - 800.0) ** 2 / 800.0).sum())
    assert chi2 < 72.1, chi2


def test_mix_without_host_draw_names_every_host():
    draw = loadgen.host_drawer({}, {"scale": 40}, [1, 3])
    assert draw(0) is None and draw(7) is None


def test_matcher_form():
    assert loadgen.host_matcher(np.array([7])) == ("hostname", "host_7")
    assert loadgen.host_matcher(np.array([7, 912, 3])) == \
        ("hostname", ("host_7", "host_912", "host_3"))


@pytest.mark.parametrize("n", [1, 3])
def test_issue_sends_one_matcher_after_the_filters(n):
    data = tsbs.generate(tsbs.TsbsConfig(num_hosts=6, span_ms=7_200_000,
                                         start_ms=0, seed=4))
    engine = support.StubEngine(data)
    traffic = {**catalog.traffic(MAX_MIX), "host_draw": n,
               "window_ms": 3_600_000}
    hosts = np.array([4, 1, 2][:n])
    out = asyncio.run(loadgen.issue(engine, traffic, ["usage_user"], "cpu",
                                    0, hosts=hosts))
    (call,) = engine.calls
    assert call[2] == (loadgen.host_matcher(hosts),)
    assert sorted(out["usage_user"]["tsids"] - 100) == sorted(hosts)


# ---- the check's new numbers, each against a planted fault ----------

def max_mix_answers(seed=5, queries=3, hosts=12):
    """A small cpu-max-all-8 run's kept answers, from the stub engine."""
    config = {**catalog.config(catalog.benchmark(), CONFIG), "scale": hosts}
    traffic = catalog.traffic(MAX_MIX)
    data = tsbs.generate(deploy.tsbs_config(config, seed))
    engine = support.StubEngine(data)
    starts = loadgen.window_starts(traffic, config,
                                   np.random.default_rng([seed, 1]), queries)
    draw = loadgen.host_drawer(traffic, config, [seed, 3])
    fields = loadgen.query_fields(traffic, config)
    kept = {i: asyncio.run(loadgen.issue(engine, traffic, fields, "cpu",
                                         int(st), hosts=draw(i)))
            for i, st in enumerate(starts)}
    keys = asyncio.run(engine.resolve_series(
        "cpu", [h + support.StubEngine.TSID_BASE for h in range(hosts)],
        None))
    return (kept, dict(enumerate(starts)), keys, data, traffic,
            {i: draw(i) for i in kept}, engine)


def judged(kept, starts, keys, data, traffic, hosts):
    numbers = check.compare(kept, starts, keys, data, traffic, "cpu", hosts)
    return check.judge(numbers, EXACT_LIMITS)


def test_sound_max_answers_are_correct():
    kept, starts, keys, data, traffic, hosts, _ = max_mix_answers()
    correct, checks = judged(kept, starts, keys, data, traffic, hosts)
    assert correct, checks
    assert list(checks) == ["max_wrong", "count_wrong", "series_wrong",
                            "queries_checked"]
    assert checks["max_wrong"]["value"] == 0


def one_ulp_up(kept):
    res = kept[0]["usage_idle"]
    grid = res["aggs"]["max"].copy()
    grid[1, 2] = np.nextafter(grid[1, 2], np.float32(np.inf))
    res["aggs"]["max"] = grid


def outside_row(kept):
    """A row of a host the query did not name, added."""
    res = kept[1]["usage_user"]
    named = set((res["tsids"] - 100).tolist())
    stranger = min(set(range(12)) - named) + 100
    res["tsids"] = np.append(res["tsids"], np.uint64(stranger))
    for k, g in res["aggs"].items():
        res["aggs"][k] = np.concatenate([g, g[:1]])


def missing_host(kept):
    res = kept[2]["usage_system"]
    res["tsids"] = res["tsids"][1:]
    res["aggs"] = {k: g[1:] for k, g in res["aggs"].items()}


def stale(kept):
    """Every answer is the first query's own."""
    for i in kept:
        if i:
            kept[i] = copy.deepcopy(kept[0])


FAULTS = {"max_one_ulp_off": (one_ulp_up, "max_wrong"),
          "row_outside_the_set": (outside_row, "series_wrong"),
          "drawn_host_missing": (missing_host, "series_wrong"),
          "stale_answer_repeated": (stale, "max_wrong")}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_is_not_correct(fault):
    plant, number = FAULTS[fault]
    kept, starts, keys, data, traffic, hosts, _ = max_mix_answers()
    plant(kept)
    correct, checks = judged(kept, starts, keys, data, traffic, hosts)
    assert not correct
    assert checks[number]["value"] > 0, checks


def test_min_is_compared_where_asked():
    kept, starts, keys, data, _, hosts, engine = max_mix_answers()
    traffic = {**catalog.traffic(MAX_MIX), "aggs": ["min", "avg"]}
    fields = loadgen.query_fields(traffic, {"fields": data.fields})
    kept = {i: asyncio.run(loadgen.issue(engine, traffic, fields, "cpu",
                                         starts[i], hosts=hosts[i]))
            for i in kept}
    numbers = check.compare(kept, starts, keys, data, traffic, "cpu", hosts)
    assert list(numbers) == ["avg_gap", "min_wrong", "count_wrong",
                             "series_wrong", "queries_checked"]
    assert numbers["min_wrong"] == 0 and numbers["avg_gap"] < 1e-4
    grid = kept[0]["usage_nice"]["aggs"]["min"]
    grid[0, 0] = np.nextafter(grid[0, 0], np.float32(-np.inf))
    numbers = check.compare(kept, starts, keys, data, traffic, "cpu", hosts)
    assert numbers["min_wrong"] == 1


@pytest.mark.parametrize("seed", [11, 2**35 + 3, 977])
def test_control_is_not_correct_on_the_max_mix(monkeypatch, seed):
    support.small_config(monkeypatch)
    config = catalog.config(catalog.benchmark(), CONFIG)
    out = control.run_mix(config, catalog.traffic(MAX_MIX),
                          {**EXACT_LIMITS, "queries_checked": 32}, seed)
    assert not out["correct"]
    assert out["checks"]["max_wrong"]["value"] > 0
    assert out["checks"]["series_wrong"]["value"] == 0


# ---- whole runs ------------------------------------------------------

def bench_with_cell(monkeypatch, tmp_path, mix: dict, limits: dict,
                    config: str = CONFIG):
    """BENCHMARK.json with one more cell, `mix-cell` on `config`, its
    traffic and limits files in a copy of perfbench/."""
    here = tmp_path / "perfbench"
    shutil.copytree(catalog.HERE, here,
                    ignore=shutil.ignore_patterns("__pycache__"))
    (here / "traffic" / "mix-under-test.json").write_text(json.dumps(mix))
    (here / "limits" / "mix-cell.json").write_text(
        json.dumps({"limits": limits}))
    monkeypatch.setattr(catalog, "HERE", str(here))
    bench = catalog.benchmark()
    bench["workloads"].append({"name": "mix-cell", "config": config,
                               "traffic": "mix-under-test", "chips": 1,
                               "why": "a test"})
    return bench


def test_cpu_max_all_8_end_to_end_on_a_stub_engine(monkeypatch, tmp_path):
    bench = bench_with_cell(monkeypatch, tmp_path, catalog.traffic(MAX_MIX),
                            {**EXACT_LIMITS, "queries_checked": 16})
    engine = support.StubEngine()
    support.stub_deploy(monkeypatch, engine)
    run = support.run_small(monkeypatch, "mix-cell", seconds=0.5,
                            bench=bench)
    r = run.result
    assert r["correct"], r["checks"]
    assert list(r["checks"]) == ["max_wrong", "count_wrong", "series_wrong",
                                 "queries_checked"]
    assert r["checks"]["queries_checked"]["value"] == 32
    matchers = [c[2] for c in engine.calls]
    assert all(len(m) == 1 and m[0][0] == "hostname"
               and isinstance(m[0][1], tuple) and len(set(m[0][1])) == 8
               for m in matchers)
    # warm-up and window draw from streams of their own
    assert len({m[0][1] for m in matchers}) > len(matchers) // 2


def test_max_mix_on_the_program(monkeypatch, tmp_path):
    """The real program on the CPU through a max mix of one drawn host a
    query, the matcher the engine takes today."""
    mix = {**catalog.traffic(MAX_MIX), "host_draw": 1, "check_sample": 8}
    bench = bench_with_cell(monkeypatch, tmp_path, mix,
                            {**EXACT_LIMITS, "queries_checked": 4})
    run = support.run_small(monkeypatch, "mix-cell", seconds=6.0,
                            bench=bench)
    r = run.result
    assert r["correct"], r["checks"]
    assert r["failed"] == 0
    assert r["checks"]["max_wrong"]["value"] == 0
    assert r["checks"]["queries_checked"]["value"] >= 4


# ---- today's mixes: the same engine calls and checks -----------------

# From the harness before mixes could draw hosts, at the seed below on
# the 12-host rehearsal, for each of the two mixes on the configuration
# it was first measured on: the sha256 of the repr of the first 16
# engine calls (warm-up, then the window), and the numbers of
# `check.compare` over the answers of the first 6 windows.
GOLDEN = {
    ("tsbs-cpu-only-1000-cardcache", "tsbs-double-groupby-all"): (
        "4900a9ce7b815a706e2be5e20b01532feee76526a0688e86648109b1297d8f1a",
        {"avg_gap": 3.814613393160471e-06, "count_wrong": 0,
         "series_wrong": 0, "queries_checked": 6}),
    ("tsbs-cpu-only-1000-default", "tsbs-double-groupby-1"): (
        "fa37d547fb07f5064e81122f99e4f715194db0bac851f9dfaaac40c65b5138a0",
        {"avg_gap": 3.8041125236532025e-06, "count_wrong": 0,
         "series_wrong": 0, "queries_checked": 6}),
}
GOLDEN_SEED = 2**33 + 7


@pytest.mark.parametrize("config_name, mix", sorted(GOLDEN))
def test_todays_mixes_issue_the_same_calls_and_checks(monkeypatch, tmp_path,
                                                      config_name, mix):
    calls_sha, numbers = GOLDEN[config_name, mix]
    traffic = catalog.traffic(mix)
    limits = {"avg_gap": 0.001, "count_wrong": 0, "series_wrong": 0,
              "queries_checked": 16}
    bench = bench_with_cell(monkeypatch, tmp_path, traffic, limits,
                            config_name)
    engine = support.StubEngine()
    support.stub_deploy(monkeypatch, engine)
    run = support.run_small(monkeypatch, "mix-cell", seed=GOLDEN_SEED,
                            seconds=0.2, bench=bench)
    assert run.result["correct"]
    assert list(run.result["checks"]) == list(numbers)
    first = repr(engine.calls[:16]).encode()
    assert hashlib.sha256(first).hexdigest() == calls_sha

    config = catalog.config(bench, config_name)
    s = harness.seed_words(GOLDEN_SEED)
    data = tsbs.generate(deploy.tsbs_config(config, s))
    stub = support.StubEngine(data)
    fields = loadgen.query_fields(traffic, config)
    starts = loadgen.window_starts(traffic, config,
                                   np.random.default_rng([s, 1]), 6)
    kept = {i: asyncio.run(loadgen.issue(stub, traffic, fields, "cpu",
                                         int(st)))
            for i, st in enumerate(starts)}
    keys = asyncio.run(stub.resolve_series(
        "cpu", [h + support.StubEngine.TSID_BASE
                for h in range(data.cfg.num_hosts)], None))
    got = check.compare(kept, dict(enumerate(starts)), keys, data, traffic,
                        "cpu")
    assert list(got.items()) == list(numbers.items())
