"""A tiny run of a cell on the CPU: the configuration cut to a few
hosts, the device cache cut by the same factor so that each cell keeps
its route, and the harness driven without its look for a card."""

from __future__ import annotations

import copy
import time

import torch

from perfbench import catalog, harness

HOSTS = 12


def small_config(monkeypatch, hosts: int = HOSTS) -> None:
    original = catalog.config

    def config(bench, name):
        c = copy.deepcopy(original(bench, name))
        scan = c["storage"]["scan"]
        scan["cache_max_rows"] = max(1, scan["cache_max_rows"] * hosts
                                     // c["scale"])
        c["scale"] = hosts
        return c

    monkeypatch.setattr(catalog, "config", config)


def run_small(monkeypatch, cell: str, seed: int = 2**33 + 7,
              seconds: float = 1.5, bench: dict = None):
    small_config(monkeypatch)
    return harness.run_cell(bench or catalog.benchmark(), cell, seed,
                            seconds, False, torch.device("cpu"),
                            time.perf_counter(), "cpu")


class StubEngine:
    """Stands in for `MetricEngine` where a test needs no engine: it
    answers the mixes' calls from the plain reference, rounded to
    float32 as the engine's aggregates are, and records each call.
    Series are numbered host + 100, so a result's tsids are not host
    indices.  A `hostname` matcher takes a name or a tuple of names."""

    TSID_BASE = 100

    def __init__(self, data=None, metric: str = "cpu"):
        self.data = data
        self.metric = metric
        self.calls = []

    def hosts_of(self, filters) -> list:
        n = self.data.cfg.num_hosts
        hosts = set(range(n))
        for key, value in filters:
            assert key == "hostname", key
            names = [value] if isinstance(value, str) else list(value)
            hosts &= {int(v[len("host_"):]) for v in names}
        return sorted(hosts)

    def answer(self, filters, time_range, bucket_ms, field, aggs) -> dict:
        import numpy as np

        from perfbench.reference import tsbs_downsample

        hosts = self.hosts_of(filters)
        d = self.data
        grids = tsbs_downsample.downsample(
            d.values[d.fields.index(field)], int(time_range.start),
            int(time_range.end) - int(time_range.start), bucket_ms,
            d.cfg.start_ms, d.cfg.interval_ms, aggs=tuple(aggs),
            hosts=np.asarray(hosts, dtype=np.int64))
        return {"tsids": [h + self.TSID_BASE for h in hosts],
                "num_buckets": grids["count"].shape[1],
                "aggs": {k: (v if k == "count" else v.astype(np.float32))
                         for k, v in grids.items()}}

    async def query_downsample(self, metric, filters, time_range,
                               bucket_ms, field="value", aggs=()):
        self.calls.append(("query_downsample", metric, tuple(filters),
                           int(time_range.start), int(time_range.end),
                           bucket_ms, field, tuple(aggs)))
        return self.answer(filters, time_range, bucket_ms, field, aggs)

    async def query_downsample_multi(self, metric, filters, time_range,
                                     bucket_ms, fields, aggs=()):
        self.calls.append(("query_downsample_multi", metric,
                           tuple(filters), int(time_range.start),
                           int(time_range.end), bucket_ms, tuple(fields),
                           tuple(aggs)))
        return {f: self.answer(filters, time_range, bucket_ms, f, aggs)
                for f in fields}

    async def resolve_series(self, metric, tsids, time_range) -> dict:
        from perfbench.control import series_key

        return {int(t): series_key(self.data, int(t) - self.TSID_BASE,
                                   metric) for t in tsids}

    async def close(self) -> None:
        pass


def stub_deploy(monkeypatch, engine: StubEngine) -> None:
    """`deploy` opens `engine` in the program's place, and its ingest
    hands it the generated data."""
    from perfbench import deploy

    async def open_engine(config, device):
        return engine

    async def ingest(eng, data, metric, chunk_ticks):
        eng.data = data
        return 0.0

    async def ssts_per_segment(eng, table="data"):
        return []

    monkeypatch.setattr(deploy, "open_engine", open_engine)
    monkeypatch.setattr(deploy, "ingest", ingest)
    monkeypatch.setattr(deploy, "ssts_per_segment", ssts_per_segment)
