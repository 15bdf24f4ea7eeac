"""The PyTorch port's bench (horaedb_tpu_torch/bench) against the JAX
package's, on the CPU.

The TSBS generator gives byte-equal arrays and record batches in both
packages.  Every suite config 2-10 runs in both packages at 20,000 rows
and 2 iters (the port with device="cpu"): the same result keys and
unit, the same deterministic fields (rows, writes, store GET counts),
and a positive value.  The bench.py twin's headline and microbench run
at small sizes and check themselves against numpy.  The port's
plan_stage_snapshot has the JAX package's keys.  Without a card, and
without --device cpu, every entry point raises."""

import asyncio
import json

import numpy as np
import pyarrow as pa
import pytest

import horaedb_tpu.bench.suite as ref_suite
import horaedb_tpu.bench.tsbs as ref_tsbs
import horaedb_tpu.storage.read as ref_read
import horaedb_tpu_torch.bench.suite as port_suite
import horaedb_tpu_torch.bench.tsbs as port_tsbs
import horaedb_tpu_torch.storage.read as port_read
from horaedb_tpu_torch.bench import __main__ as port_main
from horaedb_tpu_torch.bench import headline
from horaedb_tpu_torch.common.error import Error

TSBS_CASES = [
    dict(num_hosts=4, num_fields=2, interval_ms=1000, span_ms=10_000,
         seed=1),
    dict(num_hosts=13, num_fields=10, interval_ms=10_000,
         span_ms=3_600_000, seed=42),
    dict(num_hosts=100, num_fields=3, interval_ms=10_000,
         span_ms=200_000, seed=20261017),
]

# fields a runner reports that do not depend on the clock: they must be
# equal across packages (every key must exist in both either way)
DETERMINISTIC = {
    2: ("unit", "metric"),
    3: ("unit", "metric", "engine_rows"),
    4: ("unit", "metric"),
    5: ("unit", "metric"),
    6: ("unit", "metric", "backend", "fallback"),
    7: ("unit", "metric"),
    8: ("unit", "metric", "writes", "concurrency"),
    9: ("unit", "metric", "rows", "store_latency_ms", "data_gets_cached",
        "data_gets_hbm_evicted", "data_gets_post_flush"),
    10: ("unit", "metric", "rows"),
}


@pytest.mark.parametrize("case", TSBS_CASES, ids=lambda c: str(c["seed"]))
@pytest.mark.parametrize("shuffle", [False, True])
def test_tsbs_arrays_byte_equal(case, shuffle):
    ref = ref_tsbs.generate_cpu_arrays(ref_tsbs.TsbsConfig(**case),
                                       shuffle=shuffle)
    got = port_tsbs.generate_cpu_arrays(port_tsbs.TsbsConfig(**case),
                                        shuffle=shuffle)
    assert list(got) == list(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        assert got[k].tobytes() == ref[k].tobytes(), k


@pytest.mark.parametrize("case", TSBS_CASES, ids=lambda c: str(c["seed"]))
@pytest.mark.parametrize("region", [False, True])
def test_tsbs_record_batches_equal(case, region):
    ref = ref_tsbs.cpu_record_batch(ref_tsbs.TsbsConfig(**case),
                                    include_region=region, shuffle=True)
    got = port_tsbs.cpu_record_batch(port_tsbs.TsbsConfig(**case),
                                     include_region=region, shuffle=True)
    assert got.schema == ref.schema
    assert got.equals(ref)
    assert port_tsbs.host_names(7) == ref_tsbs.host_names(7)
    assert list(port_tsbs.region_of_hosts(11)) == \
        list(ref_tsbs.region_of_hosts(11))
    assert port_tsbs.CPU_FIELDS == ref_tsbs.CPU_FIELDS
    assert port_tsbs.REGIONS == ref_tsbs.REGIONS


def test_runners_are_the_suite_configs_2_to_23():
    assert sorted(port_suite.RUNNERS) == list(range(2, 24))
    assert sorted(port_suite.RUNNERS) == sorted(ref_suite.RUNNERS)


@pytest.mark.parametrize("config", sorted(DETERMINISTIC))
def test_runner_matches_the_jax_package(config):
    ref = ref_suite.RUNNERS[config](rows=20_000, iters=2)
    got = port_suite.RUNNERS[config](rows=20_000, iters=2, device="cpu")
    assert sorted(got) == sorted(ref)
    for k in DETERMINISTIC[config]:
        assert got[k] == ref[k], (k, got[k], ref[k])
    assert got["value"] > 0 and got["vs_baseline"] > 0
    json.dumps(got)  # a result line


def test_engine_headline_runs():
    """The bench.py twin's default config: end to end through the
    engine at a tiny scale, checked against numpy by the runner; the
    cold query replays nothing, the cached ones are replays with 0 B
    up."""
    result = headline.run_engine_headline(rows=30_000, iters=2,
                                          device="cpu")
    assert result["unit"] == "ms"
    assert result["value"] > 0 and result["cold_p50_ms"] > 0
    assert result["rows"] == 30_000
    assert result["vs_baseline"] > 0 and result["cold_vs_baseline"] > 0
    assert result["rows_per_s_cached"] > 0 and result["rows_per_s_cold"] > 0
    assert result["cold_replay_hits"] == 0 and result["cold_h2d_bytes"] > 0
    assert result["cached_replay_hits"] == result["cached_queries"] == 2
    assert result["cached_h2d_bytes"] == 0
    assert result["stage_profile"]["sidecar_read_rows"] == 30_000


def test_kernel_microbench_runs():
    result = headline.run_kernel_microbench(rows=50_000, iters=2,
                                            device="cpu")
    assert result["unit"] == "ms"
    assert result["value"] > 0 and result["vs_baseline"] > 0
    assert result["metric"].startswith("device kernel: avg GROUP BY")


def test_plan_stage_snapshot_has_the_jax_keys():
    ref = ref_read.plan_stage_snapshot()
    got = port_read.plan_stage_snapshot()
    assert set(ref) <= set(got)
    own = {f"{s}_{u}" for s in ("segment_read", "merge")
           for u in ("s", "calls")} | {"merge_rows"}
    assert set(got) - set(ref) == own
    assert all(isinstance(v, (int, float)) for v in got.values())


def test_clear_scan_tiers_leaves_the_next_query_cold():
    """After _clear_scan_tiers the next query is no replay, and it
    uploads its columns again; the query after it is a replay."""
    from horaedb_tpu_torch.metric_engine import MetricEngine
    from horaedb_tpu_torch.objstore import MemoryObjectStore
    from horaedb_tpu_torch.ops.encode import h2d_bytes
    from horaedb_tpu_torch.storage.types import TimeRange

    rng = np.random.default_rng(5)
    t0, n = 1_700_000_000_000 // 7_200_000 * 7_200_000, 6_000
    names = pa.array([f"host_{i:03d}" for i in range(10)])

    async def go():
        e = await MetricEngine.open("clr", MemoryObjectStore(),
                                    device="cpu")
        try:
            await e.write_arrow("cpu", ["host"], port_suite._host_record_batch(
                names, rng.integers(0, 10, n),
                t0 + np.sort(rng.integers(0, 3_600_000, n)),
                rng.random(n)))

            async def q():
                return await e.query_downsample(
                    "cpu", [], TimeRange.new(t0, t0 + 3_600_000),
                    bucket_ms=60_000, aggs=("avg",))

            first = await q()
            await q()
            hits, up = port_read._REPLAY_HITS.value, h2d_bytes()
            port_suite._clear_scan_tiers(e.tables["data"])
            cold = await q()
            assert port_read._REPLAY_HITS.value == hits
            assert h2d_bytes() > up
            await q()
            assert port_read._REPLAY_HITS.value == hits + 1
            for k in first["aggs"]:
                np.testing.assert_array_equal(
                    port_suite._host(cold["aggs"][k]),
                    port_suite._host(first["aggs"][k]))
        finally:
            await e.close()

    asyncio.run(go())


def test_provenance_labels_the_backend():
    assert port_suite.provenance("cpu") == {"backend": "cpu",
                                            "fallback": True}


def _no_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_bench_main_raises_without_a_card(monkeypatch, capsys):
    _no_card(monkeypatch)
    monkeypatch.setenv("BENCH_ROWS", "1000")
    for config in ("0", "1", "2"):
        monkeypatch.setenv("BENCH_CONFIG", config)
        with pytest.raises(Error, match="CUDA"):
            port_main.main([])
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("config", range(11, 24))
def test_suite_runner_raises_without_a_card(monkeypatch, config):
    _no_card(monkeypatch)
    with pytest.raises(Error, match="CUDA"):
        port_suite.RUNNERS[config](20_000, 2)


def test_bench_main_runs_config_12_on_the_cpu(monkeypatch, capsys):
    """BENCH_CONFIG=12 through `python -m horaedb_tpu_torch.bench
    --device cpu`: one result line, labelled a CPU run."""
    monkeypatch.setenv("BENCH_CONFIG", "12")
    monkeypatch.setenv("BENCH_ROWS", "20000")
    monkeypatch.setenv("BENCH_ITERS", "2")
    port_main.main(["--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["unit"] == "ms" and line["rows"] == 20_000
    assert line["backend"] == "cpu" and line["fallback"] is True
    assert not any(line["launches"].values())


def test_bench_main_rejects_configs_past_23(monkeypatch):
    monkeypatch.setenv("BENCH_CONFIG", "24")
    with pytest.raises(Error, match="0-23"):
        port_main.main(["--device", "cpu"])


def test_bench_main_runs_on_the_cpu_when_asked(monkeypatch, capsys):
    monkeypatch.setenv("BENCH_CONFIG", "6")
    monkeypatch.setenv("BENCH_ITERS", "3")
    port_main.main(["--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    # config 6 is host work: its own label wins over the run's
    assert line["backend"] == "host" and line["fallback"] is False
    assert line["max_rss_mb"] > 0


def test_suite_main_raises_without_a_card(monkeypatch, capsys):
    _no_card(monkeypatch)
    with pytest.raises(Error, match="CUDA"):
        port_suite.main(["--config", "6", "--iters", "2"])
    for config in (2, 5):
        with pytest.raises(Error, match="CUDA"):
            port_suite.RUNNERS[config](20_000, 2)
    assert capsys.readouterr().out == ""
    port_suite.main(["--config", "6", "--iters", "2", "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["unit"] == "ms" and line["backend"] == "host"
