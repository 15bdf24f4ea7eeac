"""Standing rollups of the port (horaedb_tpu_torch/rollup, the engine's
rollup branches and the WAL's rollup hooks) against the JAX package's
(horaedb_tpu/rollup, tests/test_rollup.py), on the same seeded inputs,
the port on the CPU.

- The tests/test_rollup.py scenarios run on both packages through a
  namespace per package, both with HORAEDB_FUSED_AGG=0 (the parts
  route, where the reference's byte-identity contract holds) and
  HORAEDB_HOST_AGG=0 (the JAX package's partial grids from its device
  program, float32 like the port's, not its float64 numpy twin): every
  query's rollup-served grid is byte for byte a from-raw recompute, and
  the two packages give the same tsids, grid bytes, rolled segments and
  stats() (seq numbers are SST ids, which differ between processes;
  their lag is compared as zero or not).
- The seeded interleaving harness (test_rollup_torture_fast) runs on the
  port.
- Queue C 7 (ROADMAP.md): on the fused route the JAX package's
  maintenance raises OverflowError; the port's manager always recomputes
  on the parts route, so on the same schedule it rolls and serves: byte
  for byte a parts-route recompute, and a fused-route recompute within
  the tolerance contract (count, min, max, last exact after a cast to
  f64; sum and avg rtol 1e-5).
"""

import asyncio
import tomllib
import types

import numpy as np
import pyarrow as pa
import pytest

import horaedb_tpu.common as ref_common
import horaedb_tpu.metric_engine as ref_me
import horaedb_tpu.objstore as ref_objstore
import horaedb_tpu.rollup as ref_rollup
import horaedb_tpu.rollup.manager as ref_manager
import horaedb_tpu.storage.config as ref_config
import horaedb_tpu.storage.types as ref_types
import horaedb_tpu.wal as ref_wal
import horaedb_tpu_torch.common as port_common
import horaedb_tpu_torch.metric_engine as port_me
import horaedb_tpu_torch.objstore as port_objstore
import horaedb_tpu_torch.rollup as port_rollup
import horaedb_tpu_torch.rollup.manager as port_manager
import horaedb_tpu_torch.storage.config as port_config
import horaedb_tpu_torch.storage.types as port_types
import horaedb_tpu_torch.wal as port_wal

SEG = 3_600_000
T0 = (1_700_000_000_000 // SEG) * SEG
AGG_SETS = [("avg",), ("sum",), ("min", "max"), ("last",),
            ("count", "sum", "min", "max", "avg", "last")]


def _package(name, common, me, objstore, rollup, manager, config, types_,
             wal, open_kw):
    return types.SimpleNamespace(
        name=name, ReadableDuration=common.ReadableDuration,
        Error=common.Error, MetricEngine=me.MetricEngine, Sample=me.Sample,
        Label=me.Label, MemoryObjectStore=objstore.MemoryObjectStore,
        RollupConfig=rollup.RollupConfig,
        rollup_from_dict=rollup.rollup_from_dict, split3=manager._split3,
        StorageConfig=config.StorageConfig, from_dict=config.from_dict,
        TimeRange=types_.TimeRange, WalConfig=wal.WalConfig,
        open_kw=open_kw)


REF = _package("ref", ref_common, ref_me, ref_objstore, ref_rollup,
               ref_manager, ref_config, ref_types, ref_wal, {})
PORT = _package("port", port_common, port_me, port_objstore, port_rollup,
                port_manager, port_config, port_types, port_wal,
                {"device": "cpu"})


def run(coro):
    return asyncio.run(coro)


def storage_cfg(P):
    cfg = P.from_dict(P.StorageConfig, {
        "scheduler": {"schedule_interval": "1h", "input_sst_min_num": 2},
    })
    cfg.manifest.merge_interval = P.ReadableDuration.parse("1h")
    cfg.scrub.interval = P.ReadableDuration.parse("1h")
    return cfg


def rollup_cfg(P, tiers=("1m", "10m"), specs=("cpu",)):
    # roll_interval long: the scenarios drive maintenance via roll_now()
    return P.RollupConfig(enabled=True, tiers=list(tiers), specs=list(specs),
                          roll_interval=P.ReadableDuration.parse("1h"))


def wal_cfg(P, wal_dir):
    return P.WalConfig(enabled=True, dir=str(wal_dir), flush_rows=10**6,
                       flush_bytes=1 << 30,
                       flush_age=P.ReadableDuration.parse("1h"),
                       flush_interval=P.ReadableDuration.parse("1h"))


async def open_engine(P, store, wal_dir=None, tiers=("1m", "10m"),
                      specs=("cpu",)):
    return await P.MetricEngine.open(
        "m", store, segment_ms=SEG, config=storage_cfg(P),
        wal_config=None if wal_dir is None else wal_cfg(P, wal_dir),
        rollup_config=rollup_cfg(P, tiers, specs), **P.open_kw)


def batch_of(rng, n, hosts=6, span_segs=3, t0=T0):
    ts = t0 + rng.integers(0, span_segs * SEG, n).astype(np.int64)
    hid = rng.integers(0, hosts, n)
    return pa.record_batch({
        "host": pa.array([f"h{i:02d}" for i in hid]),
        "timestamp": pa.array(ts, type=pa.int64()),
        "value": pa.array(rng.random(n), type=pa.float64()),
    })


def _np(grid) -> np.ndarray:
    if hasattr(grid, "cpu"):
        return grid.cpu().numpy()
    return np.asarray(grid)


def snap(out: dict) -> tuple:
    """A query result as comparable bytes: tsids, bucket count and each
    grid's dtype, shape and bytes."""
    grids = tuple(sorted(
        (k, _np(v).dtype.str, _np(v).shape, _np(v).tobytes())
        for k, v in out["aggs"].items()))
    return (tuple(out["tsids"]), out["num_buckets"], grids)


def stats_snap(st: dict) -> dict:
    """The rollup stats() surface minus SST-id-valued fields (ids come
    from each process's allocator), lag as zero-or-not."""
    out = {"tiers": {k: (v["bucket_ms"], v["ssts"], v["cell_rows"])
                     for k, v in st["tiers"].items()}, "specs": {}}
    for key, s in st["specs"].items():
        s = dict(s)
        s.pop("seq_newest_raw")
        s.pop("seq_rolled")
        s["lag_seqs"] = s["lag_seqs"] == 0
        out["specs"][key] = s
    return out


async def assert_equiv(e, rec, metric, filters, rng_t, bucket_ms, aggs,
                       expect_served=None):
    """THE correctness contract: the (possibly rollup-served) result is
    byte for byte a forced from-raw recompute (parts route)."""
    spec = e.rollups.specs.get((metric, "value"))
    before = spec.served_queries if spec else 0
    a = await e.query_downsample(metric, filters, rng_t, bucket_ms,
                                 aggs=aggs)
    b = await e.query_downsample(metric, filters, rng_t, bucket_ms,
                                 aggs=aggs, use_rollup=False)
    assert a["tsids"] == b["tsids"]
    assert a["num_buckets"] == b["num_buckets"]
    assert set(a["aggs"]) == set(b["aggs"])
    for k in b["aggs"]:
        ga, gb = _np(a["aggs"][k]), _np(b["aggs"][k])
        assert ga.dtype == gb.dtype and ga.shape == gb.shape, k
        assert ga.tobytes() == gb.tobytes(), \
            f"grid {k!r} not byte-identical (bucket={bucket_ms})"
    if expect_served is not None and spec is not None:
        assert (spec.served_queries - before == int(expect_served)), (
            spec.served_queries, before, expect_served)
    rec.append(("query", snap(a)))
    return a


async def roll(e, rec) -> dict:
    """A maintenance pass, recorded as the state it leaves: the rolled,
    dirty and unrollable segments.  (A write or a flush also wakes the
    background loop, whose pass may run first: the count one roll_now()
    returns depends on that timing, the state after it does not.)"""
    out = await e.rollups.roll_now()
    spec = e.rollups.specs[("cpu", "value")]
    rec.append(("rolled", sorted(spec.rolled), sorted(spec.dirty),
                sorted(spec.unrollable)))
    return out


# ---- the tests/test_rollup.py scenarios, one coroutine per package ------

async def sc_backfill(P, rec, tmp_path):
    e = await open_engine(P, P.MemoryObjectStore())
    try:
        rng = np.random.default_rng(1337)
        await e.write_arrow("cpu", ["host"], batch_of(rng, 8000))
        rolled = await e.rollups.roll_now()
        assert rolled["cpu:value"] == 3
        await roll(e, rec)
        q = P.TimeRange.new(T0, T0 + 3 * SEG)
        for aggs in AGG_SETS:
            for bucket in (60_000, 600_000):
                await assert_equiv(e, rec, "cpu", [], q, bucket, aggs,
                                   expect_served=True)
        await assert_equiv(e, rec, "cpu", [("host", "h03")], q, 60_000,
                           ("avg",), expect_served=True)
        st = await e.stats()
        spec = st["rollups"]["specs"]["cpu:value"]
        assert spec["lag_seqs"] == 0
        assert spec["rolled_segments"] == 3
        assert spec["coverage"] == 1.0
        assert spec["served_queries"] > 0
        rec.append(("stats", stats_snap(st["rollups"])))
    finally:
        await e.close()


async def sc_uncovered(P, rec, tmp_path):
    e = await open_engine(P, P.MemoryObjectStore())
    try:
        rng = np.random.default_rng(1)
        await e.write_arrow("cpu", ["host"], batch_of(rng, 2000))
        await roll(e, rec)
        spec = e.rollups.specs[("cpu", "value")]
        q = P.TimeRange.new(T0, T0 + 2 * SEG)
        # 90s is not a tier; unaligned start/end; unregistered metric
        await assert_equiv(e, rec, "cpu", [], q, 90_000, ("avg",),
                           expect_served=False)
        await assert_equiv(
            e, rec, "cpu", [], P.TimeRange.new(T0 + 1, T0 + SEG + 1),
            60_000, ("avg",), expect_served=False)
        assert not e.rollups.covers("mem", "value", 60_000, q)
        assert spec.served_queries == 0
    finally:
        await e.close()


async def sc_late_write(P, rec, tmp_path):
    e = await open_engine(P, P.MemoryObjectStore())
    try:
        rng = np.random.default_rng(2)
        await e.write_arrow("cpu", ["host"], batch_of(rng, 3000))
        await roll(e, rec)
        q = P.TimeRange.new(T0, T0 + 3 * SEG)
        await assert_equiv(e, rec, "cpu", [], q, 60_000, ("avg",),
                           expect_served=True)
        spec = e.rollups.specs[("cpu", "value")]
        await e.write([P.Sample("cpu", [P.Label("host", "h00")],
                                T0 + 5, 99.5)])
        assert spec.dirty or spec.rolling
        await assert_equiv(e, rec, "cpu", [], q, 60_000, ("avg", "last"),
                           expect_served=True)
        await roll(e, rec)
        assert not spec.dirty
        await assert_equiv(e, rec, "cpu", [], q, 60_000, ("avg", "last"),
                           expect_served=True)
    finally:
        await e.close()


async def sc_overwrite(P, rec, tmp_path):
    e = await open_engine(P, P.MemoryObjectStore())
    try:
        await e.write([P.Sample("cpu", [P.Label("host", "a")],
                                T0 + 100, 1.0)])
        await roll(e, rec)
        # same (series, ts) point overwritten: last-value wins end to
        # end, including through the re-rolled cell
        await e.write([P.Sample("cpu", [P.Label("host", "a")],
                                T0 + 100, 42.0)])
        await roll(e, rec)
        q = P.TimeRange.new(T0, T0 + SEG)
        out = await assert_equiv(e, rec, "cpu", [], q, 60_000,
                                 ("last", "count"), expect_served=True)
        assert _np(out["aggs"]["last"])[0, 0] == 42.0
        assert _np(out["aggs"]["count"])[0, 0] == 1.0
    finally:
        await e.close()


async def sc_topk_multi(P, rec, tmp_path):
    e = await open_engine(P, P.MemoryObjectStore())
    try:
        rng = np.random.default_rng(4)
        await e.write_arrow("cpu", ["host"], batch_of(rng, 3000))
        await roll(e, rec)
        q = P.TimeRange.new(T0, T0 + 3 * SEG)
        spec = e.rollups.specs[("cpu", "value")]
        a = await e.query_topk("cpu", [], q, 60_000, k=3)
        b = await e.query_topk("cpu", [], q, 60_000, k=3,
                               use_rollup=False)
        assert spec.served_queries == 1
        assert a["tsids"] == b["tsids"]
        for k in b["aggs"]:
            assert _np(a["aggs"][k]).tobytes() == \
                _np(b["aggs"][k]).tobytes(), k
        rec.append(("topk", snap(a)))
        ma = await e.query_downsample_multi("cpu", [], q, 60_000,
                                            fields=["value"])
        mb = await e.query_downsample_multi("cpu", [], q, 60_000,
                                            fields=["value"],
                                            use_rollup=False)
        assert spec.served_queries == 2
        assert snap(ma["value"]) == snap(mb["value"])
        rec.append(("multi", snap(ma["value"])))
    finally:
        await e.close()


async def sc_memtable_tail(P, rec, tmp_path):
    e = await open_engine(P, P.MemoryObjectStore(),
                          wal_dir=tmp_path / P.name)
    try:
        rng = np.random.default_rng(5)
        samples = [
            P.Sample("cpu", [P.Label("host", f"h{i % 4}")],
                     T0 + int(rng.integers(0, 2 * SEG)),
                     float(rng.random())) for i in range(400)]
        await e.write(samples)
        spec = e.rollups.specs[("cpu", "value")]
        rolled = await e.rollups.roll_now()
        assert rolled["cpu:value"] == 0  # all memtable-buffered
        q = P.TimeRange.new(T0, T0 + 2 * SEG)
        await assert_equiv(e, rec, "cpu", [], q, 60_000, ("avg",),
                           expect_served=False)
        # that raw aggregate flushed the memtables; now they roll
        await roll(e, rec)
        await assert_equiv(e, rec, "cpu", [], q, 60_000, ("avg",),
                           expect_served=True)
        # fresh acked rows ride the raw tail over the covered prefix
        await e.write([P.Sample("cpu", [P.Label("host", "hx")],
                                T0 + 2 * SEG + 123, 7.5)])
        assert e.tables["data"].memtable_segments()
        q3 = P.TimeRange.new(T0, T0 + 3 * SEG)
        await assert_equiv(e, rec, "cpu", [], q3, 60_000, ("avg", "last"),
                           expect_served=True)
        assert spec.served_queries == 2
    finally:
        await e.close()


async def sc_empty_prefix(P, rec, tmp_path):
    e = await open_engine(P, P.MemoryObjectStore())
    try:
        rng = np.random.default_rng(9)
        # data only in the LAST segment of a 6-segment range
        await e.write_arrow("cpu", ["host"],
                            batch_of(rng, 500, span_segs=1,
                                     t0=T0 + 5 * SEG))
        await roll(e, rec)
        q = P.TimeRange.new(T0, T0 + 6 * SEG)
        await assert_equiv(e, rec, "cpu", [], q, 60_000, ("avg",),
                           expect_served=True)
    finally:
        await e.close()


async def sc_unsplittable(P, rec, tmp_path):
    e = await open_engine(P, P.MemoryObjectStore())
    try:
        await e.write([
            P.Sample("cpu", [P.Label("host", "a")], T0 + 1, 3.0e38),
            P.Sample("cpu", [P.Label("host", "a")], T0 + 2, 3.0e38),
        ])
        with np.errstate(invalid="ignore"):
            await roll(e, rec)
        spec = e.rollups.specs[("cpu", "value")]
        assert spec.unrollable and not spec.rolled
        q = P.TimeRange.new(T0, T0 + SEG)
        out = await assert_equiv(e, rec, "cpu", [], q, 60_000, ("sum",),
                                 expect_served=False)
        assert np.isinf(_np(out["aggs"]["sum"])[0, 0])
        rolled = await e.rollups.roll_now()
        assert rolled["cpu:value"] == 0  # no churn
    finally:
        await e.close()


async def sc_lag(P, rec, tmp_path):
    e = await open_engine(P, P.MemoryObjectStore(),
                          wal_dir=tmp_path / P.name)
    try:
        await e.write([P.Sample("cpu", [P.Label("host", "a")],
                                T0 + 1, 1.0)])
        await e.flush()
        await roll(e, rec)
        st = (await e.rollups.stats())["specs"]["cpu:value"]
        assert st["lag_seqs"] == 0
        # a fresh ack in ANOTHER segment stays buffered: the tier
        # reports lag until it is flushed and rolled
        await e.write([P.Sample("cpu", [P.Label("host", "a")],
                                T0 + SEG + 1, 2.0)])
        st = await e.rollups.stats()
        assert st["specs"]["cpu:value"]["lag_seqs"] > 0
        rec.append(("stats", stats_snap(st)))
        await e.flush()
        await roll(e, rec)
        st = await e.rollups.stats()
        assert st["specs"]["cpu:value"]["lag_seqs"] == 0
        rec.append(("stats", stats_snap(st)))
    finally:
        await e.close()


async def sc_restart(P, rec, tmp_path):
    store = P.MemoryObjectStore()
    e = await open_engine(P, store)
    rng = np.random.default_rng(6)
    try:
        await e.write_arrow("cpu", ["host"], batch_of(rng, 3000))
        await roll(e, rec)
    finally:
        await e.close()
    e = await open_engine(P, store)
    try:
        spec = e.rollups.specs[("cpu", "value")]
        assert len(spec.rolled) == 3 and not spec.dirty
        q = P.TimeRange.new(T0, T0 + 3 * SEG)
        await assert_equiv(e, rec, "cpu", [], q, 60_000, ("avg",),
                           expect_served=True)
    finally:
        await e.close()


async def sc_partial_update(P, rec, tmp_path):
    store = P.MemoryObjectStore()
    e = await open_engine(P, store)
    rng = np.random.default_rng(8)
    try:
        await e.write_arrow("cpu", ["host"], batch_of(rng, 2000))
        await roll(e, rec)
        await e.write_arrow("cpu", ["host"],
                            batch_of(rng, 500, span_segs=1))

        async def boom(spec):
            raise OSError("simulated crash before state persist")

        e.rollups._persist = boom
        with pytest.raises(OSError):
            await e.rollups.roll_now()
    finally:
        await e.close()
    e = await open_engine(P, store)
    try:
        spec = e.rollups.specs[("cpu", "value")]
        # the changed segment's fingerprint no longer matches the
        # persisted state: dirty again on open
        assert spec.dirty
        rec.append(("dirty", sorted(spec.dirty)))
        q = P.TimeRange.new(T0, T0 + 3 * SEG)
        await assert_equiv(e, rec, "cpu", [], q, 60_000, ("avg",),
                           expect_served=True)
        await roll(e, rec)
        assert not spec.dirty
        await assert_equiv(e, rec, "cpu", [], q, 60_000, ("sum",),
                           expect_served=True)
    finally:
        await e.close()


async def sc_config(P, rec, tmp_path):
    cfg = P.rollup_from_dict(tomllib.loads("""
enabled = true
tiers = ["1m", "1h"]
roll_interval = "5s"
specs = ["cpu", "mem:usage_user"]
"""))
    assert cfg.enabled
    assert cfg.tier_millis() == [60_000, 3_600_000]
    assert cfg.spec_pairs() == [("cpu", "value"), ("mem", "usage_user")]
    assert cfg.roll_interval.seconds == 5.0
    rec.append(("config", cfg.tier_millis(), cfg.spec_pairs()))
    for bad in ({"tiers": ["1m", "1m"]}, {"tiers": ["0s"]},
                {"tiers": "1m"}, {"enabled": "yes"}, {"bogus": 1},
                {"roll_interval": 5}, {"specs": [""]}):
        with pytest.raises(P.Error):
            P.rollup_from_dict(bad)
    # 7m does not divide the 1 h segment: the open rejects it
    with pytest.raises(P.Error):
        await open_engine(P, P.MemoryObjectStore(), tiers=("7m",))
    rec.append(("rejects", 8))


async def sc_chunked_reject(P, rec, tmp_path):
    with pytest.raises(P.Error):
        await P.MetricEngine.open(
            "m", P.MemoryObjectStore(), segment_ms=SEG,
            config=storage_cfg(P), chunked_data=True,
            rollup_config=rollup_cfg(P), **P.open_kw)
    rec.append(("rejected",))


SCENARIOS = {
    "backfill": sc_backfill, "uncovered_shapes": sc_uncovered,
    "late_write": sc_late_write, "overwrite": sc_overwrite,
    "topk_multi_field": sc_topk_multi, "memtable_tail": sc_memtable_tail,
    "empty_prefix": sc_empty_prefix, "unsplittable": sc_unsplittable,
    "lag": sc_lag, "restart": sc_restart,
    "partial_update": sc_partial_update, "config": sc_config,
    "chunked_reject": sc_chunked_reject,
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_reference(name, tmp_path, monkeypatch):
    """Each scenario on both packages on the parts route: the contract
    holds in each, and the records (rolled counts, every query's tsids
    and grid bytes, stats()) are equal."""
    monkeypatch.setenv("HORAEDB_FUSED_AGG", "0")
    monkeypatch.setenv("HORAEDB_HOST_AGG", "0")
    recs = {}
    for P in (REF, PORT):
        rec = []
        run(SCENARIOS[name](P, rec, tmp_path))
        recs[P.name] = rec
    assert len(recs["port"]) == len(recs["ref"])
    for i, (a, b) in enumerate(zip(recs["port"], recs["ref"])):
        assert a == b, f"record {i} ({a[0]}) differs"


def test_split3_matches_reference():
    rng = np.random.default_rng(7)
    v = np.concatenate([
        rng.random(200) * 1e3, rng.random(200) * 1e-6,
        rng.random(200) * 1e12, np.asarray([0.0, 1.0, 2.0**52]),
        np.float64(np.float32(rng.random(50))),  # already f32-exact
    ])
    got, want = PORT.split3(v), REF.split3(v)
    hi, md, lo = got
    np.testing.assert_array_equal((hi + md) + lo, v)
    for part, ref in zip(got, want):
        np.testing.assert_array_equal(
            part.astype(np.float32).astype(np.float64), part)
        assert part.tobytes() == ref.tobytes()


def test_split3_parts_survive_the_port_scan():
    """The three f32 parts of a cell written to a tier table come back
    from the port's raw scan bit for bit (the f32 value encode)."""
    async def go():
        from horaedb_tpu_torch.storage.read import ScanRequest
        from horaedb_tpu_torch.storage.storage import (CloudObjectStorage,
                                                       WriteRequest)

        rng = np.random.default_rng(3)
        n = 500
        v = np.concatenate([rng.random(n // 2) * 1e9,
                            rng.integers(1, 10**6, n - n // 2) * 1.0])
        hi, md, lo = PORT.split3(v)
        t = await CloudObjectStorage.open(
            "tier", SEG, PORT.MemoryObjectStore(), port_manager.CELL_SCHEMA,
            port_manager.CELL_NUM_PKS, storage_cfg(PORT), device="cpu")
        try:
            cols = [np.full(n, 7, np.uint64),
                    rng.permutation(n).astype(np.uint64),
                    np.full(n, 9, np.uint64),
                    np.full(n, T0, np.int64), hi, md, lo, hi, md, lo,
                    hi, hi, hi, np.zeros(n)]
            await t.write(WriteRequest(pa.record_batch(
                [pa.array(c) for c in cols],
                schema=port_manager.CELL_SCHEMA),
                PORT.TimeRange.new(T0, T0 + 1)))
            batches = [b async for b in t.scan(ScanRequest(
                range=PORT.TimeRange.new(T0, T0 + SEG)))]
            tbl = pa.Table.from_batches(batches)
            order = np.argsort(cols[1])
            back = [tbl.column(c).to_numpy() for c in
                    ("count_hi", "count_md", "count_lo")]
            for part, want in zip(back, (hi, md, lo)):
                assert part.tobytes() == want[order].tobytes()
            np.testing.assert_array_equal(
                (back[0] + back[1]) + back[2], v[order])
        finally:
            await t.close()

    run(go())


# ---- the seeded interleaving harness, on the port -----------------------

async def run_rollup_schedule(i: int, tmp_path) -> None:
    """One seeded schedule: random writes (with duplicate-PK
    overwrites), flushes, compactions, rolls and restarts, with every
    query held byte-identical between the rollup-served and the
    from-raw paths."""
    P = PORT
    rng = np.random.default_rng(1337 + i)
    use_wal = bool(i % 2)
    wal_dir = tmp_path / f"wal-{i}"
    store = P.MemoryObjectStore()

    async def open_e():
        return await open_engine(P, store,
                                 wal_dir=wal_dir if use_wal else None)

    e = await open_e()
    rec = []
    try:
        hosts = [f"h{j:02d}" for j in range(5)]
        span_segs = 3

        async def op_write():
            n = int(rng.integers(10, 200))
            ts = T0 + rng.integers(0, span_segs * SEG, n).astype(np.int64)
            if rng.random() < 0.4 and n > 20:
                ts[: n // 2] = ts[n // 2: n // 2 + n // 2]  # dup PKs
            await e.write_arrow("cpu", ["host"], pa.record_batch({
                "host": pa.array([hosts[j] for j in
                                  rng.integers(0, len(hosts), n)]),
                "timestamp": pa.array(ts, type=pa.int64()),
                "value": pa.array(rng.random(n), type=pa.float64()),
            }))

        async def op_flush():
            await e.flush()

        async def op_roll():
            await e.rollups.roll_now()

        async def op_compact():
            await e.tables["data"].compact()
            for t in e.rollups.tiers.values():
                await t.compact()

        async def op_restart():
            nonlocal e
            await e.close()
            e = await open_e()

        async def op_query():
            bucket = int(rng.choice([60_000, 600_000]))
            lo_b = int(rng.integers(0, span_segs * SEG // bucket - 1))
            hi_b = int(rng.integers(lo_b + 1, span_segs * SEG // bucket + 1))
            q = P.TimeRange.new(T0 + lo_b * bucket, T0 + hi_b * bucket)
            aggs = AGG_SETS[int(rng.integers(0, len(AGG_SETS)))]
            filters = ([] if rng.random() < 0.6 else
                       [("host", hosts[int(rng.integers(0, len(hosts)))])])
            await assert_equiv(e, rec, "cpu", filters, q, bucket, aggs)

        ops = [op_write, op_flush, op_roll, op_compact, op_restart,
               op_query]
        weights = np.array([0.34, 0.1, 0.18, 0.06, 0.06, 0.26])
        await op_write()
        for _ in range(14):
            await ops[int(rng.choice(len(ops), p=weights))]()
        await op_roll()
        await op_query()
    finally:
        await e.close()


def test_rollup_torture_fast(tmp_path, monkeypatch):
    """Four seeded schedules on the port, on the parts route (where the
    byte-identity contract holds)."""
    monkeypatch.setenv("HORAEDB_FUSED_AGG", "0")

    async def go():
        for i in range(4):
            await run_rollup_schedule(i, tmp_path)

    run(go())


# ---- Queue C 7: maintenance on the fused route ---------------------------

def test_fused_route_reference_overflows_port_rolls(monkeypatch):
    """HORAEDB_FUSED_AGG=1 (the switch both packages honour) sends the
    JAX package's maintenance scans through the fused route: its
    np.nonzero of a JAX grid yields int32 indices and the bucket
    timestamps overflow (OverflowError).  The port's manager passes the
    parts route itself, so the same schedule rolls and serves: byte for
    byte a parts-route recompute, and a fused-route recompute within
    tolerance."""
    monkeypatch.setenv("HORAEDB_FUSED_AGG", "1")

    async def ref():
        e = await open_engine(REF, REF.MemoryObjectStore())
        try:
            rng = np.random.default_rng(1337)
            await e.write_arrow("cpu", ["host"], batch_of(rng, 8000))
            with pytest.raises(OverflowError):
                await e.rollups.roll_now()
        finally:
            await e.close()

    async def port():
        e = await open_engine(PORT, PORT.MemoryObjectStore())
        try:
            rng = np.random.default_rng(1337)
            await e.write_arrow("cpu", ["host"], batch_of(rng, 8000))
            assert (await e.rollups.roll_now())["cpu:value"] == 3
            q = PORT.TimeRange.new(T0, T0 + 3 * SEG)
            spec = e.rollups.specs[("cpu", "value")]
            for bucket in (60_000, 600_000):
                aggs = ("count", "sum", "min", "max", "avg", "last")
                served = await e.query_downsample("cpu", [], q, bucket,
                                                  aggs=aggs)
                fused = await e.query_downsample("cpu", [], q, bucket,
                                                 aggs=aggs,
                                                 use_rollup=False)
                assert hasattr(fused["aggs"]["count"], "cpu")  # fused
                assert served["tsids"] == fused["tsids"]
                for k, g in fused["aggs"].items():
                    got = _np(served["aggs"][k])
                    want = _np(g).astype(np.float64)
                    if k in ("sum", "avg"):
                        np.testing.assert_allclose(got, want, rtol=1e-5)
                    else:
                        assert got.tobytes() == want.tobytes(), k
                monkeypatch.setenv("HORAEDB_FUSED_AGG", "0")
                parts = await e.query_downsample("cpu", [], q, bucket,
                                                 aggs=aggs,
                                                 use_rollup=False)
                monkeypatch.setenv("HORAEDB_FUSED_AGG", "1")
                assert snap(served) == snap(parts)
            assert spec.served_queries == 2
        finally:
            await e.close()

    run(ref())
    run(port())


@pytest.mark.parametrize("seed", range(3))
def test_last_value_run_detection_on_the_cell_key(seed):
    """The cell key is four PKs, three uint64 and one int64, with ids
    above 2^63: the port's LastValueOperator (host-library run starts
    over int64 views) keeps the same rows as the reference's."""
    from horaedb_tpu.storage.operator import LastValueOperator as RefOp
    from horaedb_tpu_torch.storage.operator import LastValueOperator

    rng = np.random.default_rng(seed)
    n = 400
    tsid = rng.choice(np.array([3, 2**63 + 5, 2**64 - 1, 2**40],
                               dtype=np.uint64), n)
    bucket = T0 + rng.integers(-3, 3, n) * 60_000
    seq = rng.permutation(n).astype(np.uint64)
    cols = {"metric_id": np.full(n, 2**63 + 11, np.uint64), "tsid": tsid,
            "field_id": rng.choice(np.array([7, 2**64 - 2], np.uint64), n),
            "bucket_ts": bucket.astype(np.int64),
            "sum_hi": rng.random(n), "__seq__": seq}
    tbl = pa.table(cols)
    tbl = tbl.take(pa.compute.sort_indices(tbl, sort_keys=[
        (c, "ascending") for c in ("metric_id", "tsid", "field_id",
                                   "bucket_ts", "__seq__")]))
    batch = tbl.combine_chunks().to_batches()[0]
    got = LastValueOperator().merge_sorted_batch(batch, [0, 1, 2, 3])
    want = RefOp().merge_sorted_batch(batch, [0, 1, 2, 3])
    assert got.equals(want) and got.num_rows < n
