"""Self-monitoring meta-ingest of the port (horaedb_tpu_torch/metric_engine/
meta.py) against the JAX package's (horaedb_tpu/metric_engine/meta.py,
tests/test_loops.py::TestMetaIngest), on the same seeded registry series,
the port on the CPU.

- The scrape snapshot: the same seeded probe families (gauges and
  counters with labelled children, a histogram, a series whose labels
  carry `name`, a NaN gauge) in each package's process registry, scraped
  under one injected clock, give the same __meta samples.
- An engine opened with `meta_config` on each package: one scrape is
  written through the WAL, flushed and rolled; the raw __meta rows and
  the rollup-served 1 min grid are equal across packages (the grids byte
  for byte, HORAEDB_FUSED_AGG=0 and HORAEDB_HOST_AGG=0 as in
  test_torch_rollup.py).
- The guards: a scrape re-entered from inside its own write is skipped
  and counted, a metric the write bumps lands in the next scrape, the
  `max_series` cap drops and counts the rest; and close() stops the
  scraper before the rollups and the tables, on both packages.

The registries are process-wide, so each test's probe families carry a
name of their own.  The scrape loop's interval is an hour: every scrape
here is driven by hand, none waits on wall time.
"""

import asyncio
import types

import numpy as np
import pytest

import horaedb_tpu.common.loops as ref_loops
import horaedb_tpu.metric_engine as ref_me
import horaedb_tpu.metric_engine.meta as ref_meta
import horaedb_tpu.objstore as ref_objstore
import horaedb_tpu.rollup as ref_rollup
import horaedb_tpu.storage.types as ref_types
import horaedb_tpu.utils as ref_utils
import horaedb_tpu.wal as ref_wal
import horaedb_tpu_torch.common.loops as port_loops
import horaedb_tpu_torch.metric_engine as port_me
import horaedb_tpu_torch.metric_engine.meta as port_meta
import horaedb_tpu_torch.objstore as port_objstore
import horaedb_tpu_torch.rollup as port_rollup
import horaedb_tpu_torch.storage.types as port_types
import horaedb_tpu_torch.utils as port_utils
import horaedb_tpu_torch.wal as port_wal

SEG = 2 * 3_600_000
T_SCRAPE = (1_700_000_000_000 // SEG) * SEG + 1_234_567


def _package(name, loops, me, meta, objstore, rollup, types_, utils, wal,
             open_kw):
    return types.SimpleNamespace(
        name=name, loops=loops.loops, MetricEngine=me.MetricEngine,
        MetaConfig=meta.MetaConfig, MetaIngest=meta.MetaIngest,
        ReadableDuration=meta.ReadableDuration,
        MemoryObjectStore=objstore.MemoryObjectStore,
        RollupConfig=rollup.RollupConfig, TimeRange=types_.TimeRange,
        registry=utils.registry, WalConfig=wal.WalConfig, open_kw=open_kw)


REF = _package("ref", ref_loops, ref_me, ref_meta, ref_objstore, ref_rollup,
               ref_types, ref_utils, ref_wal, {})
PORT = _package("port", port_loops, port_me, port_meta, port_objstore,
                port_rollup, port_types, port_utils, port_wal,
                {"device": "cpu"})
BOTH = [REF, PORT]


def run(coro):
    return asyncio.run(coro)


def meta_cfg(P, **kw):
    return P.MetaConfig(enabled=True,
                        interval=P.ReadableDuration.parse("1h"), **kw)


class FakeEngine:
    """The write surface MetaIngest needs: records every batch, and runs
    `on_write` inside the write (the recursion shape)."""

    rollups = None

    def __init__(self, on_write=None):
        self.calls = []
        self.on_write = on_write

    async def write(self, samples):
        self.calls.append(samples)
        if self.on_write is not None:
            await self.on_write(len(self.calls))


def seed_probes(P, prefix: str, seed: int) -> None:
    """The same seeded probe families in P's process registry."""
    rng = np.random.default_rng(seed)
    reg = P.registry
    g = reg.gauge(f"{prefix}_gauge", "probe gauge")
    g.set(float(rng.normal()))
    for i in range(int(rng.integers(2, 6))):
        g.labels(shard=f"s{i}", table=str(rng.choice(["data", "index"]))).set(
            float(rng.normal() * 1e3))
    c = reg.counter(f"{prefix}_total", "probe counter")
    for i in range(3):
        c.labels(kind=f"k{i}").inc(float(rng.integers(1, 100)))
    h = reg.histogram(f"{prefix}_seconds", "probe histogram")
    for v in rng.random(int(rng.integers(1, 20))):
        h.observe(float(v))
    # not representable as __meta: its own labels carry `name`
    reg.gauge(f"{prefix}_named", "probe with a name label").labels(
        name="x").set(1.0)
    # not a finite sample
    reg.gauge(f"{prefix}_nan", "probe NaN").set(float("nan"))


def probe_rows(samples, prefix: str) -> list:
    return [(s.name, [(l.name, l.value) for l in s.labels], s.timestamp,
             s.value) for s in samples
            if any(l.name == "name" and l.value.startswith(prefix)
                   for l in s.labels)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_snapshot_samples_match(seed):
    prefix = f"meta_probe_snap{seed}"
    rows = {}
    for P in BOTH:
        seed_probes(P, prefix, seed)
        fake = FakeEngine()
        mi = P.MetaIngest(fake, meta_cfg(P), clock=lambda: T_SCRAPE)
        assert run(mi.scrape_once()) == len(fake.calls[0])
        rows[P.name] = probe_rows(fake.calls[0], prefix)
    assert rows["port"] == rows["ref"]
    names = {dict(labs)["name"] for _n, labs, _t, _v in rows["port"]}
    assert f"{prefix}_seconds_sum" in names
    assert f"{prefix}_seconds_count" in names
    assert f"{prefix}_named" not in names and f"{prefix}_nan" not in names
    assert all(n == "__meta" and t == T_SCRAPE
               for n, _l, t, _v in rows["port"])


def snap(out: dict) -> tuple:
    grids = tuple(sorted(
        (k, np.asarray(v.cpu() if hasattr(v, "cpu") else v).dtype.str,
         np.asarray(v.cpu() if hasattr(v, "cpu") else v).tobytes())
        for k, v in out["aggs"].items()))
    return (tuple(out["tsids"]), out["num_buckets"], grids)


async def meta_engine_leg(P, wal_dir):
    prefix = "meta_probe_engine"
    P.registry.gauge(f"{prefix}_gauge", "probe gauge").labels(
        table="data").set(42.5)
    e = await P.MetricEngine.open(
        "m", P.MemoryObjectStore(), segment_ms=SEG,
        wal_config=P.WalConfig(enabled=True, dir=str(wal_dir)),
        rollup_config=P.RollupConfig(
            enabled=True, tiers=["1m", "1h"],
            roll_interval=P.ReadableDuration.parse("1h")),
        meta_config=meta_cfg(P), **P.open_kw)
    try:
        assert ("__meta", "value") in e.rollups.specs
        e.meta._clock = lambda: T_SCRAPE
        assert await e.meta.scrape_once() > 0
        await e.flush()
        await e.rollups.roll_now()
        lo = (T_SCRAPE // SEG) * SEG
        rng = P.TimeRange.new(lo, lo + SEG)
        filt = [("name", f"{prefix}_gauge")]
        tbl = await e.query("__meta", filt, rng)
        raw = (tbl.column("timestamp").to_pylist(),
               tbl.column("value").to_pylist())
        served = P.registry.counter("rollup_served_queries_total")
        before = served.total
        out = await e.query_downsample("__meta", filt, rng, bucket_ms=60_000)
        return raw, served.total - before, snap(out)
    finally:
        await e.close()


def test_engine_meta_rows_and_rollup_match(tmp_path, monkeypatch):
    monkeypatch.setenv("HORAEDB_FUSED_AGG", "0")
    monkeypatch.setenv("HORAEDB_HOST_AGG", "0")
    got = {P.name: run(meta_engine_leg(P, tmp_path / P.name)) for P in BOTH}
    raw, served, grids = got["port"]
    assert raw == ([T_SCRAPE], [42.5])
    assert served == 1
    assert got["port"][0] == got["ref"][0]
    assert got["port"][1] == got["ref"][1]
    # the tsids are the same series' hashes; the grids byte for byte
    assert grids == got["ref"][2]


async def reentrant_leg(P, prefix):
    skipped = P.registry.counter("meta_scrapes_skipped_total")
    seen = {}

    async def on_write(n):
        # a metric the write path itself bumps
        P.registry.gauge(f"{prefix}_during_write", "bumped inside the "
                         "meta write").set(1.0)
        if n == 1:
            before = skipped.value
            seen["reentrant"] = await mi.scrape_once()
            seen["skipped"] = skipped.value - before

    fake = FakeEngine(on_write)
    mi = P.MetaIngest(fake, meta_cfg(P), clock=lambda: T_SCRAPE)
    first = await mi.scrape_once()
    second = await mi.scrape_once()
    names = [{l.value for s in call for l in s.labels if l.name == "name"}
             for call in fake.calls]
    return (first > 0, second > 0, len(fake.calls), seen["reentrant"],
            seen["skipped"], f"{prefix}_during_write" in names[0],
            f"{prefix}_during_write" in names[1])


def test_inflight_skip_and_no_recursion():
    got = {P.name: run(reentrant_leg(P, f"meta_probe_reent_{P.name}"))
           for P in BOTH}
    assert got["port"] == got["ref"] == (True, True, 2, 0, 1, False, True)


@pytest.mark.parametrize("cap", [1, 5, 64])
def test_max_series_cap(cap):
    got = {}
    for P in BOTH:
        seed_probes(P, f"meta_probe_cap{cap}_{P.name}", cap)
        dropped = P.registry.counter("meta_samples_dropped_total")
        total = len(P.registry.samples())
        before = dropped.value
        fake = FakeEngine()
        mi = P.MetaIngest(fake, meta_cfg(P, max_series=cap),
                          clock=lambda: T_SCRAPE)
        n = run(mi.scrape_once())
        assert n == cap == len(fake.calls[0])
        # every series past the cap is dropped and counted, with the
        # unrepresentable ones before it
        assert dropped.value - before == total - cap
        assert all(s.name == "__meta" and s.field_name == "value"
                   and any(l.name == "name" for l in s.labels)
                   for s in fake.calls[0])
        got[P.name] = n
    assert got["port"] == got["ref"]


async def close_order_leg(P, wal_dir):
    e = await P.MetricEngine.open(
        "m", P.MemoryObjectStore(), segment_ms=SEG,
        wal_config=P.WalConfig(enabled=True, dir=str(wal_dir)),
        rollup_config=P.RollupConfig(
            enabled=True, tiers=["1m"],
            roll_interval=P.ReadableDuration.parse("1h")),
        meta_config=meta_cfg(P), **P.open_kw)
    assert P.loops.get("meta-ingest") is not None
    order = []

    def record(obj, attr, tag):
        inner = getattr(obj, attr)

        async def wrapped(*a, **kw):
            order.append(tag)
            return await inner(*a, **kw)

        setattr(obj, attr, wrapped)

    record(e.meta, "stop", "meta")
    record(e.rollups, "close", "rollups")
    for name, t in e.tables.items():
        record(t, "close", f"table:{name}")
    await e.close()
    return (order, e.meta is None,
            P.loops.get("meta-ingest") is None)


def test_close_stops_meta_first(tmp_path):
    got = {P.name: run(close_order_leg(P, tmp_path / P.name)) for P in BOTH}
    assert got["port"] == got["ref"]
    order, meta_gone, loop_gone = got["port"]
    assert order[:2] == ["meta", "rollups"]
    assert all(o.startswith("table:") for o in order[2:]) and order[2:]
    assert meta_gone and loop_gone
