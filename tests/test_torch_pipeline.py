"""The cold-scan pipeline and the tier-2 reads of the port
(horaedb_tpu_torch/storage/pipeline.py, storage/read.py) against the JAX
package's, on the same seeded inputs, the port on the CPU.  The
scenarios of tests/test_pipeline.py and tests/test_scan_cache.py run on
both packages:

- rows and grids are byte for byte the same with the pipeline on and
  off, in each package, and the port's equal the reference's (rows
  exactly; count/min/max/last byte for byte, sum/avg within rtol 1e-5);
- seeded write/flush/compaction/eviction schedules through a WAL, each
  query cold with the pipeline on and off, against a last-write-wins
  model (the fast size);
- a scan abandoned midway drains: no task left, the in-flight gauge 0;
- the in-flight budget bounds the pipeline's host bytes;
- the stage metrics, the stall counters and cache_stats()["pipeline"];
- the [scan.pipeline] TOML section; pipeline off takes the pump;
- write-through admission: a query right after a write makes no store
  read, a flush with write_through = false fetches only the new SST,
  compaction invalidates its inputs and admits its output, and a tier
  of 0 B reads the store every time — the same GET counts in both
  packages (a counting store wrapper defined here).

Left out: the deadline test (the port has no deadline plane yet) and
the lint test (the port has no lint tool)."""

import asyncio
import random
import types

import numpy as np
import pyarrow as pa
import pytest

import horaedb_tpu.common as ref_common
import horaedb_tpu.common.runtimes as ref_runtimes
import horaedb_tpu.objstore as ref_objstore
import horaedb_tpu.ops as ref_ops
import horaedb_tpu.storage.config as ref_config
import horaedb_tpu.storage.pipeline as ref_pipeline
import horaedb_tpu.storage.read as ref_read
import horaedb_tpu.storage.storage as ref_storage
import horaedb_tpu.storage.types as ref_types
import horaedb_tpu.wal as ref_wal
import horaedb_tpu_torch.common as port_common
import horaedb_tpu_torch.common.runtimes as port_runtimes
import horaedb_tpu_torch.objstore as port_objstore
import horaedb_tpu_torch.ops as port_ops
import horaedb_tpu_torch.storage.config as port_config
import horaedb_tpu_torch.storage.pipeline as port_pipeline
import horaedb_tpu_torch.storage.read as port_read
import horaedb_tpu_torch.storage.storage as port_storage
import horaedb_tpu_torch.storage.types as port_types
import horaedb_tpu_torch.wal as port_wal

SEED = 1337
SEGMENT_MS = 3_600_000
SCHEMA = pa.schema([("k", pa.string()), ("ts", pa.int64()),
                    ("v", pa.float64())])


def _package(common, runtimes, objstore, ops, config, pipeline, read,
             storage, types_, wal, open_kw):
    return types.SimpleNamespace(
        ReadableDuration=common.ReadableDuration, runtimes=runtimes,
        MemoryObjectStore=objstore.MemoryObjectStore, F=ops,
        StorageConfig=config.StorageConfig,
        ScanPipelineConfig=config.ScanPipelineConfig,
        ThreadsConfig=config.ThreadsConfig, from_dict=config.from_dict,
        pipeline=pipeline, read=read, ScanRequest=read.ScanRequest,
        AggregateSpec=read.AggregateSpec,
        CloudObjectStorage=storage.CloudObjectStorage,
        WriteRequest=storage.WriteRequest, TimeRange=types_.TimeRange,
        IngestStorage=wal.IngestStorage, WalConfig=wal.WalConfig,
        open_kw=open_kw)


REF = _package(ref_common, ref_runtimes, ref_objstore, ref_ops, ref_config,
               ref_pipeline, ref_read, ref_storage, ref_types, ref_wal, {})
PORT = _package(port_common, port_runtimes, port_objstore, port_ops,
                port_config, port_pipeline, port_read, port_storage,
                port_types, port_wal, {"device": "cpu"})
BOTH = {"ref": REF, "port": PORT}
PACKAGES = pytest.mark.parametrize("name", list(BOTH))


@pytest.fixture(scope="module")
def pools():
    rts = {name: P.runtimes.from_config(P.ThreadsConfig())
           for name, P in BOTH.items()}
    yield rts
    for rt in rts.values():
        rt.close()


def run(coro):
    return asyncio.run(coro)


def counting_store(P, latency: float = 0.0):
    """The package's MemoryObjectStore counting data-plane reads by
    object kind (sidecar .enc, parquet .sst), with an optional delay
    before every read."""
    base = P.MemoryObjectStore

    class CountingStore(base):
        def __init__(self):
            super().__init__()
            self.enc_gets = self.sst_gets = self.enc_bytes = 0

        def _count(self, path: str, n: int) -> None:
            if path.endswith(".enc"):
                self.enc_gets += 1
                self.enc_bytes += n
            elif path.endswith(".sst"):
                self.sst_gets += 1

        async def get(self, path):
            if latency:
                await asyncio.sleep(latency)
            data = await base.get(self, path)
            self._count(path, len(data))
            return data

        async def get_range(self, path, start, end):
            if latency:
                await asyncio.sleep(latency)
            data = (await base.get(self, path))[start:end]
            self._count(path, len(data))
            return data

    return CountingStore()


def batch(rows):
    k, t, v = zip(*rows)
    return pa.record_batch(
        [pa.array(list(k)), pa.array(list(t), type=pa.int64()),
         pa.array(list(v), type=pa.float64())], schema=SCHEMA)


def wreq(P, rows):
    lo = min(r[1] for r in rows)
    hi = max(r[1] for r in rows) + 1
    return P.WriteRequest(batch(rows), P.TimeRange.new(lo, hi))


def storage_config(P, pipeline=None, cache=None):
    scan = {}
    if pipeline:
        scan["pipeline"] = pipeline
    if cache:
        scan["cache"] = cache
    cfg = P.from_dict(P.StorageConfig, {
        "scheduler": {"schedule_interval": "1h", "input_sst_min_num": 2},
        "scan": scan})
    cfg.manifest.merge_interval = P.ReadableDuration.parse("1h")
    cfg.scrub.interval = P.ReadableDuration.parse("1h")
    return cfg


async def open_storage(P, store, rt, pipeline=None, cache=None):
    return await P.CloudObjectStorage.open(
        "db", SEGMENT_MS, store, SCHEMA, 2,
        storage_config(P, pipeline, cache), runtimes=rt, **P.open_kw)


def wal_config(P, wal_dir):
    return P.WalConfig(enabled=True, dir=str(wal_dir), flush_rows=10**6,
                       flush_bytes=1 << 30,
                       flush_age=P.ReadableDuration.parse("1h"),
                       flush_interval=P.ReadableDuration.parse("1h"),
                       max_group_wait=P.ReadableDuration.from_millis(0))


async def scan_rows(P, s, pred=None):
    out = []
    async for b in s.scan(P.ScanRequest(range=P.TimeRange.new(0, 10**12),
                                        predicate=pred)):
        out.extend(zip(b.column(0).to_pylist(), b.column(1).to_pylist(),
                       b.column(2).to_pylist()))
    return sorted(out)


def agg_spec(P, lo: int, hi: int, bucket_ms: int = 60_000,
             which=("avg", "max", "last")):
    return P.AggregateSpec(group_col="k", ts_col="ts", value_col="v",
                           range_start=lo, bucket_ms=bucket_ms,
                           num_buckets=max(1, -(-(hi - lo) // bucket_ms)),
                           which=which)


def host_grids(out):
    values, grids = out
    return np.asarray(values), {k: np.asarray(v) for k, v in grids.items()}


async def both_modes(s, coro_fn):
    """`coro_fn()` cold with the pipeline ON then OFF (the window cache
    and the parts memo cleared before each, so both run the cold path);
    returns the two results."""
    out = []
    for enabled in (True, False):
        s.config.scan.pipeline.enabled = enabled
        s.reader.scan_cache.clear()
        s.reader.parts_memo.clear()
        out.append(await coro_fn())
    s.config.scan.pipeline.enabled = True
    return out


def assert_same_grids(a, b):
    va, ga = host_grids(a)
    vb, gb = host_grids(b)
    assert np.array_equal(va, vb)
    assert set(ga) == set(gb)
    for k in ga:
        assert ga[k].dtype == gb[k].dtype
        assert ga[k].tobytes() == gb[k].tobytes(), k


def assert_grids_match_reference(ref, port):
    vr, gr = host_grids(ref)
    vp, gp = host_grids(port)
    assert list(vp) == list(vr)
    assert set(gp) == set(gr)
    for k in gr:
        if k in ("sum", "avg"):
            np.testing.assert_allclose(gp[k], gr[k], rtol=1e-5, err_msg=k)
        else:
            np.testing.assert_array_equal(gp[k], gr[k], err_msg=k)


def leaked_tasks(before: set) -> list:
    return [t for t in asyncio.all_tasks() - before if not t.done()]


# ---------------------------------------------------------------------------
# bit-identical pipeline on/off, and the port against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fused", ["1", "0"], ids=["fused", "parts"])
def test_pipeline_bit_identical_shapes(pools, monkeypatch, fused):
    """Row scans (with and without predicates) and downsample grids
    (several aggregate sets and ranges) are byte-identical with the
    pipeline on and off over a multi-segment table with overwrites, in
    each package; the port's equal the reference's."""
    monkeypatch.setenv("HORAEDB_FUSED_AGG", fused)

    async def go(name):
        P = BOTH[name]
        s = await open_storage(P, P.MemoryObjectStore(), pools[name])
        out = []
        try:
            rng = random.Random(SEED)
            for seg in range(4):
                rows = [(f"k{rng.randint(0, 5)}",
                         seg * SEGMENT_MS + rng.randint(0, 3_599_000),
                         float(i)) for i in range(200)]
                await s.write(wreq(P, rows))
                # duplicate keys across writes exercise last-wins dedup
                await s.write(wreq(P, [(k, t, v + 1000.0)
                                       for k, t, v in rows[:50]]))
            span = (0, 4 * SEGMENT_MS)
            F = P.F
            preds = [None, F.Eq("k", "k1"),
                     F.And([F.Ge("ts", SEGMENT_MS // 2),
                            F.Lt("ts", 3 * SEGMENT_MS)])]
            for pred in preds:
                got_on, got_off = await both_modes(
                    s, lambda p=pred: scan_rows(P, s, p))
                assert got_on == got_off
                out.append(got_on)
            for which in (("avg",), ("min", "max"),
                          ("avg", "max", "last")):
                for lo, hi in (span, (SEGMENT_MS, 3 * SEGMENT_MS)):
                    req = P.ScanRequest(range=P.TimeRange.new(lo, hi))
                    spec = agg_spec(P, lo, hi, which=which)
                    a, b = await both_modes(
                        s, lambda r=req, sp=spec: s.scan_aggregate(r, sp))
                    assert_same_grids(a, b)
                    out.append(a)
        finally:
            await s.close()
        return out

    ref, port = run(go("ref")), run(go("port"))
    for r, p in zip(ref[:3], port[:3]):
        assert p == r and p
    for r, p in zip(ref[3:], port[3:]):
        assert_grids_match_reference(r, p)


def _chaos_schedule(P, rt, i: int, tmp_path) -> list:
    """One seeded schedule: random writes/flushes/compactions/evictions
    interleaved with queries that each run COLD twice — pipeline on and
    off — and must match each other and the last-write-wins model; one
    op flushes and compacts MID-scan.  Returns every query's rows."""

    async def go():
        rng = random.Random(SEED + i)
        inner = await open_storage(P, P.MemoryObjectStore(), rt)
        wal_dir = tmp_path / f"wal{i}"
        s = await P.IngestStorage.open(inner, str(wal_dir),
                                       wal_config(P, wal_dir))
        model: dict = {}
        seen: list = []
        seq = 0
        try:
            for _op in range(12):
                op = rng.choice(["write", "write", "write", "flush",
                                 "query", "agg", "compact", "evict",
                                 "midscan"])
                if op == "write":
                    rows = []
                    for _ in range(rng.randint(1, 5)):
                        seg = rng.randint(0, 2)
                        k = f"k{rng.randint(0, 5)}"
                        ts = seg * SEGMENT_MS + rng.randint(0, 999)
                        rows.append((k, ts, float(seq)))
                        seq += 1
                    seg0 = rows[0][1] // SEGMENT_MS
                    rows = [r for r in rows if r[1] // SEGMENT_MS == seg0]
                    await s.write(wreq(P, rows))
                    for k, ts, v in rows:
                        model[(k, ts)] = v
                elif op == "flush":
                    await s.flush_all()
                elif op == "compact":
                    await s.flush_all()
                    sched = inner.compact_scheduler
                    task = await sched.picker.pick_candidate()
                    if task is not None:
                        await sched.executor.execute(task)
                elif op == "evict":
                    inner.reader.scan_cache.clear()
                    if rng.random() < 0.5:
                        inner.reader.encoded_cache.clear()
                elif op == "agg":
                    await s.flush_all()  # the aggregate path is SST-only
                    lo, hi = 0, 3 * SEGMENT_MS
                    req = P.ScanRequest(range=P.TimeRange.new(lo, hi))
                    spec = agg_spec(P, lo, hi, bucket_ms=250)
                    a, b = await both_modes(
                        inner, lambda: inner.scan_aggregate(req, spec))
                    assert_same_grids(a, b)
                elif op == "midscan":
                    await s.flush_all()
                    got = []
                    n_before = 0
                    async for b in inner.scan(P.ScanRequest(
                            range=P.TimeRange.new(0, 10**12))):
                        if n_before == 0:
                            # a write + flush + compaction while the
                            # pipeline holds prefetched segments
                            k, ts, v = "k0", 0, float(seq)
                            seq += 1
                            await s.write(wreq(P, [(k, ts, v)]))
                            model[(k, ts)] = v
                            await s.flush_all()
                            sched = inner.compact_scheduler
                            task = await sched.picker.pick_candidate()
                            if task is not None:
                                await sched.executor.execute(task)
                        n_before += 1
                        got.extend(zip(b.column(0).to_pylist(),
                                       b.column(1).to_pylist(),
                                       b.column(2).to_pylist()))
                    # the scan's snapshot may or may not hold the
                    # mid-scan write: both are valid
                    want = sorted((k, ts, v) for (k, ts), v
                                  in model.items())
                    got = sorted(got)
                    if got != want:
                        stale = [r for r in want if r[:2] != (k, ts)] + \
                            [r for r in got if r[:2] == (k, ts)]
                        assert got == sorted(set(stale)), \
                            f"schedule {i} midscan diverged"
                else:
                    got_on, got_off = await both_modes(
                        inner, lambda: scan_rows(P, s))
                    want = sorted((k, ts, v) for (k, ts), v
                                  in model.items())
                    assert got_on == want, f"schedule {i} diverged"
                    assert got_on == got_off, \
                        f"schedule {i}: pipeline on != off"
                    seen.append(got_on)
            got_on, got_off = await both_modes(inner, lambda: scan_rows(P, s))
            want = sorted((k, ts, v) for (k, ts), v in model.items())
            assert got_on == want and got_on == got_off, \
                f"schedule {i} final state diverged"
            seen.append(got_on)
        finally:
            await s.close()
        return seen

    return run(go())


@pytest.mark.parametrize("i", [0, 1])
def test_seeded_pipeline_chaos_fast(pools, tmp_path, i):
    """The fast size of the seeded chaos schedules, on both packages:
    each holds its own model, and their rows agree query by query."""
    ref = _chaos_schedule(REF, pools["ref"], i, tmp_path / "ref")
    port = _chaos_schedule(PORT, pools["port"], i, tmp_path / "port")
    assert port == ref


# ---------------------------------------------------------------------------
# teardown, budget, observability, config
# ---------------------------------------------------------------------------


@PACKAGES
def test_client_abandon_mid_scan_drains(pools, name):
    """A consumer that abandons the scan midway triggers the
    deterministic teardown: no task of the scan survives, and the
    in-flight byte gauge reads 0."""
    P = BOTH[name]

    async def go():
        s = await open_storage(P, counting_store(P, latency=0.02),
                               pools[name])
        try:
            for seg in range(5):
                await s.write(wreq(P, [
                    (f"k{j % 3}", seg * SEGMENT_MS + j, float(j))
                    for j in range(200)]))
            s.reader.scan_cache.clear()
            s.reader.encoded_cache.clear()
            tasks_before = asyncio.all_tasks()
            agen = s.scan(P.ScanRequest(range=P.TimeRange.new(
                0, 5 * SEGMENT_MS)))
            async for _b in agen:
                break  # abandon after the first batch
            await agen.aclose()
            assert not leaked_tasks(tasks_before)
            assert P.pipeline._INFLIGHT_BYTES.value == 0
        finally:
            await s.close()

    run(go())


@PACKAGES
def test_inflight_budget_bounds_host_ram(pools, monkeypatch, name):
    """The high-water of in-flight bytes stays within the budget plus
    one segment (the always-admit-one rule), and a tight budget shows
    fetch stalls and a lower high-water than the default."""
    P = BOTH[name]
    monkeypatch.setenv("HORAEDB_FUSED_AGG", "0")

    async def go():
        # a small delay makes the default-budget fetches overlap (on an
        # instant store the consumer keeps up and nothing accumulates)
        s = await open_storage(P, counting_store(P, latency=0.01),
                               pools[name])
        try:
            for seg in range(8):
                await s.write(wreq(P, [
                    (f"k{j % 4}", seg * SEGMENT_MS + j, float(j))
                    for j in range(2000)]))

            async def cold_query():
                s.reader.scan_cache.clear()
                s.reader.encoded_cache.clear()
                s.reader.parts_memo.clear()
                req = P.ScanRequest(range=P.TimeRange.new(
                    0, 8 * SEGMENT_MS))
                return host_grids(await s.scan_aggregate(
                    req, agg_spec(P, 0, 8 * SEGMENT_MS)))

            stalls0 = P.pipeline.stall_counts()["fetch"]
            want = await cold_query()
            hw_default = s.reader._pipeline_high_water
            assert hw_default > 0
            # a 1-byte budget: one segment at a time, so the high-water
            # IS one segment's in-flight footprint
            s.reader._pipeline_high_water = 0
            s.config.scan.pipeline.inflight_bytes = 1
            got = await cold_query()
            per_seg = s.reader._pipeline_high_water
            assert per_seg < hw_default
            assert P.pipeline.stall_counts()["fetch"] > stalls0
            budget = 2 * per_seg
            s.reader._pipeline_high_water = 0
            s.config.scan.pipeline.inflight_bytes = budget
            got2 = await cold_query()
            assert s.reader._pipeline_high_water <= budget + per_seg
            for g in (got, got2):
                assert np.array_equal(g[0], want[0])
                for k in want[1]:
                    assert g[1][k].tobytes() == want[1][k].tobytes(), k
            return hw_default, per_seg
        finally:
            await s.close()

    run(go())


@PACKAGES
def test_stage_metrics_and_stats(pools, monkeypatch, name):
    P = BOTH[name]
    monkeypatch.setenv("HORAEDB_FUSED_AGG", "0")

    async def go():
        s = await open_storage(P, P.MemoryObjectStore(), pools[name])
        try:
            for seg in range(3):
                await s.write(wreq(P, [
                    (f"k{j % 3}", seg * SEGMENT_MS + j, float(j))
                    for j in range(100)]))
            sec = P.pipeline.STAGE_SECONDS
            before = {st: sec[st].count for st in sec}
            s.reader.scan_cache.clear()
            # tier 2 cleared too, so the fetches read the store
            s.reader.encoded_cache.clear()
            req = P.ScanRequest(range=P.TimeRange.new(0, 3 * SEGMENT_MS))
            await s.scan_aggregate(req, agg_spec(P, 0, 3 * SEGMENT_MS))
            assert sec["fetch"].count >= before["fetch"] + 3
            assert sec["decode"].count >= before["decode"] + 3
            assert sec["device"].count > before["device"]
            stats = s.reader.cache_stats()["pipeline"]
            assert stats["enabled"] and stats["high_water_bytes"] > 0
            assert stats["depth"] == 32
            assert stats["inflight_bytes"] == 256 << 20
            assert set(P.pipeline.stall_counts()) == {"fetch", "decode",
                                                      "device"}
            assert P.pipeline._INFLIGHT_BYTES.value == 0
            return sorted(stats)
        finally:
            await s.close()

    run(go())


@PACKAGES
def test_pipeline_config_toml(name):
    P = BOTH[name]
    cfg = P.from_dict(P.StorageConfig, {
        "scan": {"pipeline": {"enabled": False, "depth": 4,
                              "inflight_bytes": 1024},
                 "cache": {"tier2_max_bytes": 4096,
                           "write_through": False},
                 "stream_read_min_rows": 7, "stream_read_min_bytes": 9}})
    assert cfg.scan.pipeline.enabled is False
    assert cfg.scan.pipeline.depth == 4
    assert cfg.scan.pipeline.inflight_bytes == 1024
    assert cfg.scan.cache.tier2_max_bytes == 4096
    assert cfg.scan.cache.write_through is False
    assert (cfg.scan.stream_read_min_rows,
            cfg.scan.stream_read_min_bytes) == (7, 9)
    assert P.ScanPipelineConfig().enabled is True
    with pytest.raises(Exception):
        P.from_dict(P.StorageConfig, {"scan": {"pipeline": {"bogus": 1}}})
    with pytest.raises(Exception):
        P.from_dict(P.StorageConfig,
                    {"scan": {"pipeline": {"depth": "four"}}})


def test_config_defaults_match_reference():
    r, p = REF.StorageConfig().scan, PORT.StorageConfig().scan
    assert (p.cache.tier2_max_bytes, p.cache.write_through) == \
        (r.cache.tier2_max_bytes, r.cache.write_through)
    assert (p.pipeline.enabled, p.pipeline.depth,
            p.pipeline.inflight_bytes) == \
        (r.pipeline.enabled, r.pipeline.depth, r.pipeline.inflight_bytes)
    assert (p.stream_read_min_rows, p.stream_read_min_bytes) == \
        (r.stream_read_min_rows, r.stream_read_min_bytes)


@PACKAGES
def test_pipeline_off_uses_sequential_pump(pools, name):
    """enabled = false routes through the pump: no pipeline stage
    observations, no in-flight accounting."""
    P = BOTH[name]

    async def go():
        s = await open_storage(P, P.MemoryObjectStore(), pools[name],
                               pipeline={"enabled": False})
        try:
            await s.write(wreq(P, [("a", 10, 1.0), ("b", 20, 2.0)]))
            fetch0 = P.pipeline.STAGE_SECONDS["fetch"].count
            s.reader.scan_cache.clear()
            s.reader.encoded_cache.clear()
            assert await scan_rows(P, s) == [("a", 10, 1.0),
                                             ("b", 20, 2.0)]
            assert P.pipeline.STAGE_SECONDS["fetch"].count == fetch0
            assert s.reader._pipeline_high_water == 0
            assert s.reader.cache_stats()["pipeline"]["enabled"] is False
        finally:
            await s.close()

    run(go())


# ---------------------------------------------------------------------------
# write-through admission and incremental re-merge (tests/test_scan_cache)
# ---------------------------------------------------------------------------


def test_write_through_admission_serves_scans_without_store_reads(pools):
    """A query right after a write reads nothing from the store; after
    one entry is invalidated, only that SST's sidecar is fetched."""

    async def go(name):
        P = BOTH[name]
        store = counting_store(P)
        s = await open_storage(P, store, pools[name])
        log = []
        try:
            r1 = await s.write(wreq(P, [("a", 10, 1.0), ("b", 20, 2.0)]))
            cache = s.reader.encoded_cache
            log.append((cache.admissions, len(cache)))
            log.append(await scan_rows(P, s))
            log.append((store.enc_gets, store.sst_gets))
            await s.write(wreq(P, [("b", 20, 9.0), ("c", 30, 3.0)]))
            s.reader.scan_cache.clear()
            log.append(await scan_rows(P, s))
            log.append((store.enc_gets, store.sst_gets))
            cache.invalidate([r1.id])
            s.reader.scan_cache.clear()
            log.append(await scan_rows(P, s))
            log.append((store.enc_gets, store.sst_gets))
            log.append(cache.stats())
        finally:
            await s.close()
        return log

    ref, port = run(go("ref")), run(go("port"))
    assert port == ref
    assert port[0] == (1, 1)
    assert port[2] == (0, 0) and port[4] == (0, 0) and port[6] == (1, 0)
    assert port[5] == [("a", 10, 1.0), ("b", 20, 9.0), ("c", 30, 3.0)]


def test_flush_without_write_through_fetches_only_the_new_sst(pools,
                                                              tmp_path):
    """Through a WAL: with write_through on, the query after a flush
    makes 0 sidecar GETs; with it off, the segment re-merges from its
    resident parts and fetches only the flushed SST's sidecar."""

    async def go(name, write_through):
        P = BOTH[name]
        store = counting_store(P)
        inner = await open_storage(
            P, store, pools[name],
            cache={"write_through": write_through})
        wal_dir = tmp_path / f"{name}{int(write_through)}"
        s = await P.IngestStorage.open(inner, str(wal_dir),
                                       wal_config(P, wal_dir))
        try:
            await inner.write(wreq(P, [(f"k{j}", 1000 + j, float(j))
                                       for j in range(50)]))
            rows = await scan_rows(P, inner)  # reads (or not) the SST
            gets0 = store.enc_gets
            await s.write(wreq(P, [("k1", 1001, 99.0), ("z", 5, 7.0)]))
            await s.flush_all()
            inner.reader.scan_cache.clear()
            after = await scan_rows(P, inner)
            return (len(rows), gets0, store.enc_gets - gets0,
                    store.sst_gets, after,
                    inner.reader.encoded_cache.stats())
        finally:
            await s.close()

    for write_through in (True, False):
        ref = run(go("ref", write_through))
        port = run(go("port", write_through))
        assert port == ref
        assert port[2] == (0 if write_through else 1)
        assert port[3] == 0
        assert ("k1", 1001, 99.0) in port[4] and ("z", 5, 7.0) in port[4]


def test_tier2_disabled_reproduces_store_reads(pools):
    async def go(name):
        P = BOTH[name]
        store = counting_store(P)
        s = await open_storage(P, store, pools[name],
                               cache={"tier2_max_bytes": 0})
        try:
            await s.write(wreq(P, [("a", 10, 1.0)]))
            for _ in range(2):
                s.reader.scan_cache.clear()
                assert await scan_rows(P, s) == [("a", 10, 1.0)]
            return store.enc_gets, len(s.reader.encoded_cache)
        finally:
            await s.close()

    assert run(go("port")) == run(go("ref")) == (2, 0)


def test_compaction_invalidates_inputs_and_admits_output(pools):
    async def go(name):
        P = BOTH[name]
        store = counting_store(P)
        s = await open_storage(P, store, pools[name])
        try:
            ids = []
            for i in range(3):
                r = await s.write(wreq(P, [(f"k{i}", 10 + i, float(i)),
                                           ("dup", 50, float(i))]))
                ids.append(r.id)
            sched = s.compact_scheduler
            task = await sched.picker.pick_candidate()
            assert task is not None
            await sched.executor.execute(task)
            cache = s.reader.encoded_cache
            assert all(cache.get(fid, {"k"}) is None for fid in ids)
            ssts = await s.manifest.all_ssts()
            assert len(ssts) == 1
            assert cache.get(ssts[0].id, {"k", "ts", "v", "__seq__"}) \
                is not None
            before = store.enc_gets
            s.reader.scan_cache.clear()
            rows = await scan_rows(P, s)
            return (rows, store.enc_gets - before, store.sst_gets,
                    cache.invalidated, cache.admissions)
        finally:
            await s.close()

    port = run(go("port"))
    assert port == run(go("ref"))
    assert port == ([("dup", 50, 2.0), ("k0", 10, 0.0), ("k1", 11, 1.0),
                     ("k2", 12, 2.0)], 0, 0, 3, 4)
