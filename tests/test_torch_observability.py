"""The port's observability and public API against the JAX package's, on
the same engine scenarios (device="cpu" for the port):

- per-trace memory attribution (ParquetReader._mem_delta_marks /
  _mem_delta_attribute): a traced cold aggregate records
  mem_account_delta_<kind> counters equal to the reference's; nothing
  without a trace or with the ledger disabled (the twin of
  tests/test_memledger.py::TestTraceAttribution);
- the background-op traces ttl_gc, compaction (with its
  compaction.execute span) and scrub beside flush, rollup_pass and
  wal_commit (the twin of tests/test_loops.py::TestOpTraces), and the
  scrubber's `_now` clock seam;
- the trace counters stage_sidecar_read_ms, stage_combine_ms and
  scan_combine_memo_parts, the histogram storage_scan_seconds, the
  split of scan_colstack_cache_* from scan_stack_cache_*, and
  cache_stats()["decode"];
- the reference's last public API: RollupManager.unregister, the
  TimeMergeStorage ABC, CloudObjectStorage.value_idxes and
  IngestStorage.value_idxes.

Both packages take the parts route where grids or cache bytes are
compared (HORAEDB_FUSED_AGG=0), the JAX package with its device window
program (HORAEDB_HOST_AGG=0; the port has no host aggregation route);
the stack-cache counters need the fused route (HORAEDB_FUSED_AGG=1)."""

import asyncio
import types

import pyarrow as pa
import pytest

import horaedb_tpu.common.memledger as ref_memledger
import horaedb_tpu.metric_engine as ref_me
import horaedb_tpu.objstore as ref_objstore
import horaedb_tpu.rollup as ref_rollup
import horaedb_tpu.storage.compaction as ref_compaction
import horaedb_tpu.storage.config as ref_config
import horaedb_tpu.storage.read as ref_read
import horaedb_tpu.storage.storage as ref_storage
import horaedb_tpu.storage.types as ref_types
import horaedb_tpu.utils as ref_utils
import horaedb_tpu.wal.config as ref_walcfg
import horaedb_tpu.wal.ingest as ref_ingest
import horaedb_tpu_torch.common.memledger as port_memledger
import horaedb_tpu_torch.metric_engine as port_me
import horaedb_tpu_torch.objstore as port_objstore
import horaedb_tpu_torch.rollup as port_rollup
import horaedb_tpu_torch.storage.compaction as port_compaction
import horaedb_tpu_torch.storage.config as port_config
import horaedb_tpu_torch.storage.read as port_read
import horaedb_tpu_torch.storage.storage as port_storage
import horaedb_tpu_torch.storage.types as port_types
import horaedb_tpu_torch.utils as port_utils
import horaedb_tpu_torch.wal.config as port_walcfg
import horaedb_tpu_torch.wal.ingest as port_ingest

T0 = 1_700_000_000_000
HOUR = 3_600_000
OPS = ("flush", "rollup_pass", "scrub", "compaction", "wal_commit")


def _pkg(me, objstore, types_, utils, memledger, config, rollup, walcfg,
         read, storage, ingest, compaction, **open_kw):
    return types.SimpleNamespace(
        MetricEngine=me.MetricEngine, Sample=me.Sample, Label=me.Label,
        MemoryObjectStore=objstore.MemoryObjectStore,
        InstrumentedStore=objstore.InstrumentedStore,
        TimeRange=types_.TimeRange, registry=utils.registry,
        recorder=utils.recorder, tracing=utils.tracing,
        ledger=memledger.ledger, config=config,
        RollupConfig=rollup.RollupConfig, WalConfig=walcfg.WalConfig,
        read=read, storage=storage, ingest=ingest, compaction=compaction,
        open_kw=open_kw)


REF = _pkg(ref_me, ref_objstore, ref_types, ref_utils, ref_memledger,
           ref_config, ref_rollup, ref_walcfg, ref_read, ref_storage,
           ref_ingest, ref_compaction)
PORT = _pkg(port_me, port_objstore, port_types, port_utils,
            port_memledger, port_config, port_rollup, port_walcfg,
            port_read, port_storage, port_ingest, port_compaction,
            device="cpu")
BOTH = pytest.mark.parametrize("pkg", [REF, PORT], ids=["ref", "port"])


@pytest.fixture
def parts_route(monkeypatch):
    monkeypatch.setenv("HORAEDB_FUSED_AGG", "0")
    monkeypatch.setenv("HORAEDB_HOST_AGG", "0")


async def _open(pkg, root, **kw):
    return await pkg.MetricEngine.open(
        root, pkg.MemoryObjectStore(), segment_ms=2 * HOUR,
        **pkg.open_kw, **kw)


async def _write(pkg, e, n, hosts=5):
    await e.write([pkg.Sample(
        name="cpu", labels=[pkg.Label("host", f"h{i % hosts}")],
        timestamp=T0 + i * 100, value=float(i)) for i in range(n)])


def _cold(e):
    reader = e.tables["data"].reader
    reader.scan_cache.clear()
    reader.encoded_cache.clear()
    reader.parts_memo.clear()


async def _traced(pkg, coro_fn):
    pkg.recorder.configure(enabled=True, sample_rate=1.0)
    trace = pkg.recorder.start("/query")
    with pkg.tracing.trace_scope(trace):
        out = await coro_fn()
    pkg.recorder.finish(trace)
    return trace, out


def _deltas(trace) -> dict:
    return {k: v for k, v in trace.counters.items()
            if k.startswith("mem_account_delta_")}


# ---- per-trace memory attribution -----------------------------------------


def _attribution(pkg, tmp_path):
    async def go():
        e = await _open(pkg, f"{tmp_path}/m")
        try:
            await _write(pkg, e, 2000)
            _cold(e)
            trace, _ = await _traced(pkg, lambda: e.query_downsample(
                "cpu", [], pkg.TimeRange.new(T0, T0 + 300_000),
                bucket_ms=60_000, aggs=("avg",)))
            untraced = e.tables["data"].reader._mem_delta_marks()
            return _deltas(trace), untraced
        finally:
            await e.close()

    return asyncio.run(go())


def test_cold_scan_mem_deltas_equal_reference(parts_route, tmp_path):
    """Equal deltas in every account but the stack cache: the JAX
    package keeps its parts rounds' device stacks there, and the port
    builds parts rounds uncached (read.ParquetReader._build_round_stacks)
    and so records no stack-cache delta on this route."""
    ref, ref_untraced = _attribution(REF, tmp_path / "ref")
    got, untraced = _attribution(PORT, tmp_path / "port")
    assert got.get("mem_account_delta_encoded_cache", 0) > 0, got
    stack = "mem_account_delta_stack_cache"
    assert ref.pop(stack, 0) > 0 and stack not in got, (got, ref)
    assert got == ref
    # no ambient trace: no marks, no bookwork
    assert untraced is None and ref_untraced is None


def test_fused_route_mem_deltas(monkeypatch, tmp_path):
    """The port's default route on the CPU (fused) attributes too: tier
    2, the window cache and the round stacks all grow on a cold query."""
    monkeypatch.delenv("HORAEDB_FUSED_AGG", raising=False)
    got, _ = _attribution(PORT, tmp_path)
    for kind in ("encoded_cache", "scan_cache", "stack_cache"):
        assert got.get(f"mem_account_delta_{kind}", 0) > 0, (kind, got)


@BOTH
def test_disabled_ledger_skips_attribution(pkg, tmp_path):
    async def go():
        e = await _open(pkg, f"{tmp_path}/m")
        try:
            await _write(pkg, e, 500, hosts=1)
            _cold(e)
            pkg.ledger.configure(enabled=False)
            try:
                trace, _ = await _traced(pkg, lambda: e.query_downsample(
                    "cpu", [], pkg.TimeRange.new(T0, T0 + 60_000),
                    bucket_ms=60_000, aggs=("avg",)))
            finally:
                pkg.ledger.configure(enabled=True)
            return _deltas(trace)
        finally:
            await e.close()

    assert asyncio.run(go()) == {}


def test_row_scan_attributes(parts_route, tmp_path):
    """ParquetReader.execute (a row scan over a plan) records the window
    cache's growth as the reference's does."""
    def run(pkg, root):
        async def go():
            e = await _open(pkg, root)
            try:
                await _write(pkg, e, 2000)
                _cold(e)
                table = e.tables["data"]
                plan = await table.build_scan_plan(pkg.read.ScanRequest(
                    range=pkg.TimeRange.new(T0, T0 + 300_000)))

                async def rows():
                    n = 0
                    async for batch in table.reader.execute(plan):
                        n += batch.num_rows
                    return n

                trace, n = await _traced(pkg, rows)
                return _deltas(trace), n
            finally:
                await e.close()

        return asyncio.run(go())

    ref = run(REF, f"{tmp_path}/ref")
    got = run(PORT, f"{tmp_path}/port")
    assert got == ref
    assert got[0].get("mem_account_delta_scan_cache", 0) > 0


# ---- the background-op traces ---------------------------------------------


def _op_traces(pkg, tmp_path):
    async def go():
        cfg = pkg.config.from_dict(pkg.config.StorageConfig, {
            "scheduler": {"input_sst_min_num": 2,
                          "schedule_interval": "100ms"}})
        e = await pkg.MetricEngine.open(
            f"{tmp_path}/m", pkg.InstrumentedStore(pkg.MemoryObjectStore()),
            segment_ms=2 * HOUR, config=cfg,
            wal_config=pkg.WalConfig(enabled=True,
                                     dir=str(tmp_path / "wal")),
            rollup_config=pkg.RollupConfig(enabled=True, tiers=["1m", "1h"],
                                           specs=["cpu"]),
            **pkg.open_kw)
        try:
            pkg.recorder.clear()
            for batch in range(2):  # two flushes -> two data SSTs
                await e.write([pkg.Sample(
                    name="cpu", labels=[pkg.Label("host", f"h{i % 3}")],
                    timestamp=T0 + batch + i * 1000, value=float(i))
                    for i in range(50)])
                await e.flush()
            await e.rollups.roll_now()
            await e.tables["data"].scrub()
            await e.tables["data"].compact()  # trigger the picker
            for _ in range(100):
                if "compaction" in {t["op"] for t in
                                    pkg.recorder.list(200, kind="op")}:
                    break
                await asyncio.sleep(0.1)
            by_op: dict = {}
            for t in pkg.recorder.list(200, kind="op"):
                by_op.setdefault(t["op"], []).append(t)
            comp = pkg.recorder.get(by_op["compaction"][0]["trace_id"]) \
                if "compaction" in by_op else None
            scrub = pkg.recorder.get(by_op["scrub"][0]["trace_id"]) \
                if "scrub" in by_op else None
            queries = pkg.recorder.list(200, kind="query")
            return by_op, comp, scrub, queries
        finally:
            await e.close()

    return asyncio.run(go())


@BOTH
def test_flush_scrub_roll_compaction_op_traces(pkg, tmp_path, monkeypatch):
    monkeypatch.setenv("HORAEDB_FUSED_AGG", "0")
    by_op, comp, scrub, queries = _op_traces(pkg, tmp_path)
    for expected in OPS:
        assert expected in by_op, (expected, sorted(by_op))
    assert comp["kind"] == "op" and comp["op"] == "compaction"
    assert any(s["name"] == "compaction.execute" for s in comp["spans"])
    assert any(k.startswith("objstore_") for k in comp["counters"])
    assert scrub["kind"] == "op"
    assert any(k.startswith("objstore_") for k in scrub["counters"])
    assert all(t["kind"] == "query" for t in queries)


@BOTH
def test_ttl_gc_op_trace(pkg, tmp_path):
    """An expireds-only task runs gc_expired under its own op trace."""
    async def go():
        cfg = pkg.config.from_dict(pkg.config.StorageConfig, {
            "scheduler": {"schedule_interval": "1h"}})
        e = await pkg.MetricEngine.open(
            f"{tmp_path}/m", pkg.MemoryObjectStore(), segment_ms=2 * HOUR,
            config=cfg, **pkg.open_kw)
        try:
            await _write(pkg, e, 50)
            table = e.tables["data"]
            ssts = await table.manifest.all_ssts()
            pkg.recorder.clear()
            await table.compact_scheduler.executor.gc_expired(
                pkg.compaction.Task(inputs=[], expireds=list(ssts)))
            by_op = {t["op"] for t in pkg.recorder.list(50, kind="op")}
            return by_op, len(await table.manifest.all_ssts())
        finally:
            await e.close()

    ops, left = asyncio.run(go())
    assert "ttl_gc" in ops and left == 0


@BOTH
def test_scrubber_clock_seam(pkg, tmp_path):
    """Scrubber._now is the grace clock: an orphan younger than the grace
    period is kept, and deleted once the clock passes it."""
    async def go():
        e = await _open(pkg, f"{tmp_path}/m")
        try:
            table = e.tables["data"]
            store = table.store
            orphan = f"{table.root_path}/data/999999.sst"
            await store.put(orphan, b"x" * 10)
            scrubber = table.scrubber
            now = [1000.0]
            scrubber._now = lambda: now[0]
            first = await scrubber.scrub(grace_override_s=60.0)
            now[0] += 61.0
            second = await scrubber.scrub(grace_override_s=60.0)
            return first.as_dict(), second.as_dict()
        finally:
            await e.close()

    first, second = asyncio.run(go())
    assert first["orphans_in_grace"] == 1 and first["orphans_deleted"] == 0
    assert second["orphans_deleted"] == 1


# ---- scan counters ---------------------------------------------------------


def _counter(pkg, name, **labels):
    fam = pkg.registry.counter(name)
    return (fam.labels(**labels) if labels else fam).value


def _hist_count(pkg, name):
    return pkg.registry.histogram(name).count


def _scan_counters(pkg, tmp_path):
    """One cold traced aggregate, a PartsMemo-served query over a
    narrower bucket-aligned range, and a raw row scan: the trace
    counters and registry deltas."""
    async def go():
        e = await _open(pkg, f"{tmp_path}/m")
        try:
            await _write(pkg, e, 3000)
            _cold(e)
            rng = pkg.TimeRange.new(T0, T0 + 4 * HOUR)
            scan0 = _hist_count(pkg, "storage_scan_seconds")
            cold, _ = await _traced(pkg, lambda: e.query_downsample(
                "cpu", [], rng, bucket_ms=60_000, aggs=("avg",)))
            scan1 = _hist_count(pkg, "storage_scan_seconds")
            narrow, _ = await _traced(pkg, lambda: e.query_downsample(
                "cpu", [], pkg.TimeRange.new(T0, T0 + 2 * HOUR),
                bucket_ms=60_000, aggs=("avg",)))
            await e.query("cpu", [("host", "h1")], rng)
            scan2 = _hist_count(pkg, "storage_scan_seconds")
            return cold.counters, narrow.counters, scan1 - scan0, \
                scan2 - scan1
        finally:
            await e.close()

    return asyncio.run(go())


def test_trace_counters_and_scan_seconds_match_reference(parts_route,
                                                         tmp_path):
    r_cold, r_narrow, r_agg, r_rows = _scan_counters(REF, tmp_path / "r")
    cold, narrow, agg, rows = _scan_counters(PORT, tmp_path / "p")
    for counters, ref in ((cold, r_cold), (narrow, r_narrow)):
        for k in ("stage_sidecar_read_ms", "stage_combine_ms",
                  "scan_combine_memo_parts"):
            assert (k in counters) == (k in ref), (k, counters, ref)
    assert cold["stage_sidecar_read_ms"] > 0
    assert cold["stage_combine_ms"] > 0
    assert narrow["scan_combine_memo_parts"] == \
        r_narrow["scan_combine_memo_parts"] > 0
    assert (agg, rows) == (r_agg, r_rows)
    assert agg > 0 and rows > 0


def _stack_counts(pkg, tmp_path):
    """Fused route: a cold query, then one over another bucket-aligned
    range (no time leaf, so the same predicate): the column stacks hit,
    the per-range stacks miss."""
    async def go():
        e = await _open(pkg, f"{tmp_path}/m")
        try:
            await _write(pkg, e, 3000)
            names = ("scan_colstack_cache_hits_total",
                     "scan_colstack_cache_misses_total",
                     "scan_stack_cache_hits_total",
                     "scan_stack_cache_misses_total")
            before = {n: _counter(pkg, n) for n in names}
            for lo in (T0, T0 - 60_000):
                await e.query_downsample(
                    "cpu", [], pkg.TimeRange.new(lo, lo + 2 * HOUR),
                    bucket_ms=60_000, aggs=("avg",))
            return {n: _counter(pkg, n) - before[n] for n in names}
        finally:
            await e.close()

    return asyncio.run(go())


def test_colstack_counters_split_from_stack_counters(monkeypatch, tmp_path):
    monkeypatch.setenv("HORAEDB_FUSED_AGG", "1")
    monkeypatch.setenv("HORAEDB_HOST_AGG", "0")
    ref = _stack_counts(REF, tmp_path / "r")
    got = _stack_counts(PORT, tmp_path / "p")
    assert got == ref
    assert got["scan_colstack_cache_hits_total"] > 0
    assert got["scan_colstack_cache_misses_total"] > 0
    assert got["scan_stack_cache_misses_total"] > 0


@pytest.mark.parametrize("mode,forced", [("auto", None), ("device", None),
                                         ("host", None), ("auto", "1"),
                                         ("device", "0")])
def test_cache_stats_decode_section(monkeypatch, mode, forced):
    if forced is None:
        monkeypatch.delenv("HORAEDB_DEVICE_DECODE", raising=False)
    else:
        monkeypatch.setenv("HORAEDB_DEVICE_DECODE", forced)

    def stats(pkg):
        cfg = pkg.config.from_dict(pkg.config.StorageConfig, {
            "scan": {"decode": {"mode": mode,
                                "max_upload_bytes": 12345678}}})
        schema = pa.schema([("k", pa.string()), ("ts", pa.int64()),
                            ("v", pa.float64())])
        s = pkg.storage.CloudObjectStorage(
            "db", HOUR, pkg.MemoryObjectStore(), schema, 2, cfg,
            **pkg.open_kw)
        try:
            return s.reader.cache_stats()["decode"]
        finally:
            s.runtimes.close()

    assert stats(PORT) == stats(REF)


# ---- the last public API ---------------------------------------------------


@BOTH
def test_rollup_unregister(pkg, tmp_path):
    async def go():
        e = await pkg.MetricEngine.open(
            f"{tmp_path}/m", pkg.MemoryObjectStore(), segment_ms=2 * HOUR,
            rollup_config=pkg.RollupConfig(enabled=True, tiers=["1m"]),
            **pkg.open_kw)
        try:
            mgr = e.rollups
            spec = await mgr.register("cpu")
            path = mgr._state_path(spec)
            assert await mgr.store.get(path)
            first = await mgr.unregister("cpu")
            second = await mgr.unregister("cpu")
            try:
                await mgr.store.get(path)
                gone = False
            except Exception:  # noqa: BLE001 — each package's NotFound
                gone = True
            return first, second, gone, ("cpu", "value") in mgr.specs
        finally:
            await e.close()

    assert asyncio.run(go()) == (True, False, True, False)


def test_time_merge_storage_abc_matches_reference():
    r, p = REF.storage.TimeMergeStorage, PORT.storage.TimeMergeStorage
    assert p.__abstractmethods__ == r.__abstractmethods__
    assert issubclass(PORT.storage.CloudObjectStorage, p)
    assert issubclass(PORT.ingest.IngestStorage, p)
    with pytest.raises(TypeError):
        p()


def test_value_idxes_match_reference(tmp_path):
    def run(pkg, root):
        async def go():
            e = await pkg.MetricEngine.open(
                root, pkg.MemoryObjectStore(), segment_ms=2 * HOUR,
                wal_config=pkg.WalConfig(enabled=True,
                                         dir=f"{root}/wal"),
                **pkg.open_kw)
            try:
                data = e.tables["data"]
                assert isinstance(data, pkg.ingest.IngestStorage)
                out = {name: t.value_idxes for name, t in e.tables.items()}
                out["inner"] = data.inner.value_idxes
                return out
            finally:
                await e.close()

        return asyncio.run(go())

    got = run(PORT, str(tmp_path / "p"))
    assert got == run(REF, str(tmp_path / "r"))
    assert got["data"] == got["inner"] and got["data"]
