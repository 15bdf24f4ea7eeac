"""The WAL, the memtables and the hybrid scan of the port
(horaedb_tpu_torch/wal, storage/read.merge_memtable_overlay and the
storage seams) against the JAX package's (horaedb_tpu/wal,
tests/test_wal.py), on the same seeded inputs, the port on the CPU.

- WAL frames and segment files are byte for byte the reference's, and a
  log written by either package replays in the other.
- The overlay merge gives byte-equal Arrow batches.
- The hybrid-scan, group-failure, replay and truncation scenarios of
  tests/test_wal.py run on both packages and return equal rows.
- A fence that raises leaves no manifest entry; 12 seeded crash
  schedules keep every acked row exactly once (the port alone).
- A WAL-fronted MetricEngine agrees with the reference on raw rows,
  grids (count/min/max/last exact, sum/avg rtol 1e-5) and stats(); a
  flush makes the next fused query miss the replay, and its grids are
  byte-equal to a recompute from cold caches."""

import asyncio
import os
import random
import shutil
import types

import numpy as np
import pyarrow as pa
import pytest
from test_torch_engine import _compare

import horaedb_tpu.common as ref_common
import horaedb_tpu.common.error as ref_error
import horaedb_tpu.common.runtimes as ref_runtimes
import horaedb_tpu.objstore as ref_objstore
import horaedb_tpu.ops as ref_ops
import horaedb_tpu.storage.config as ref_config
import horaedb_tpu.storage.read as ref_read
import horaedb_tpu.storage.storage as ref_storage
import horaedb_tpu.storage.types as ref_types
import horaedb_tpu.wal as ref_wal
import horaedb_tpu.wal.log as ref_log
import horaedb_tpu_torch.common as port_common
import horaedb_tpu_torch.common.error as port_error
import horaedb_tpu_torch.common.runtimes as port_runtimes
import horaedb_tpu_torch.objstore as port_objstore
import horaedb_tpu_torch.ops as port_ops
import horaedb_tpu_torch.storage.config as port_config
import horaedb_tpu_torch.storage.read as port_read
import horaedb_tpu_torch.storage.storage as port_storage
import horaedb_tpu_torch.storage.types as port_types
import horaedb_tpu_torch.wal as port_wal
import horaedb_tpu_torch.wal.log as port_log
from horaedb_tpu_torch.objstore.api import ObjectStore
from horaedb_tpu_torch.utils import registry

SEGMENT_MS = 3_600_000
SCHEMA = pa.schema([("k", pa.string()), ("ts", pa.int64()),
                    ("v", pa.float64())])


def _package(common, error, runtimes, objstore, ops, config, read, storage,
             types_, wal, log, open_kw):
    return types.SimpleNamespace(
        ReadableDuration=common.ReadableDuration, Error=error.Error,
        runtimes=runtimes, MemoryObjectStore=objstore.MemoryObjectStore,
        Eq=ops.Eq, And=ops.And, StorageConfig=config.StorageConfig,
        ThreadsConfig=config.ThreadsConfig, from_dict=config.from_dict,
        UpdateMode=config.UpdateMode, ScanRequest=read.ScanRequest,
        AggregateSpec=read.AggregateSpec, read=read,
        CloudObjectStorage=storage.CloudObjectStorage,
        WriteRequest=storage.WriteRequest, TimeRange=types_.TimeRange,
        StorageSchema=types_.StorageSchema,
        IngestStorage=wal.IngestStorage, WalConfig=wal.WalConfig,
        Wal=log.Wal, encode_record=log.encode_record,
        decode_records=log.decode_records, open_kw=open_kw)


REF = _package(ref_common, ref_error, ref_runtimes, ref_objstore, ref_ops,
               ref_config, ref_read, ref_storage, ref_types, ref_wal,
               ref_log, {})
PORT = _package(port_common, port_error, port_runtimes, port_objstore,
                port_ops, port_config, port_read, port_storage, port_types,
                port_wal, port_log, {"device": "cpu"})
BOTH = {"ref": REF, "port": PORT}


@pytest.fixture(scope="module")
def pools():
    rts = {name: P.runtimes.from_config(P.ThreadsConfig())
           for name, P in BOTH.items()}
    yield rts
    for rt in rts.values():
        rt.close()


def run(coro):
    return asyncio.run(coro)


def batch(rows):
    k, t, v = zip(*rows)
    return pa.record_batch(
        [pa.array(list(k)), pa.array(list(t), type=pa.int64()),
         pa.array(list(v), type=pa.float64())], schema=SCHEMA)


def wreq(P, rows):
    lo = min(r[1] for r in rows)
    hi = max(r[1] for r in rows) + 1
    return P.WriteRequest(batch(rows), P.TimeRange.new(lo, hi))


def storage_config(P, mode=None):
    cfg = P.from_dict(P.StorageConfig, {
        "scheduler": {"schedule_interval": "1h", "input_sst_min_num": 2},
    })
    cfg.manifest.merge_interval = P.ReadableDuration.parse("1h")
    cfg.scrub.interval = P.ReadableDuration.parse("1h")
    if mode is not None:
        cfg.update_mode = mode
    return cfg


def wal_config(P, wal_dir, **kw):
    defaults = dict(enabled=True, dir=str(wal_dir), flush_rows=10**6,
                    flush_bytes=1 << 30,
                    flush_age=P.ReadableDuration.parse("1h"),
                    flush_interval=P.ReadableDuration.parse("1h"),
                    max_group_wait=P.ReadableDuration.from_millis(0))
    defaults.update(kw)
    return P.WalConfig(**defaults)


async def open_inner(P, store, rt, schema=SCHEMA, root="db", mode=None):
    return await P.CloudObjectStorage.open(
        root, SEGMENT_MS, store, schema, 2, storage_config(P, mode),
        runtimes=rt, **P.open_kw)


async def open_ingest(P, store, wal_dir, rt, on_op=None, **kw):
    inner = await open_inner(P, store, rt)
    return await P.IngestStorage.open(inner, str(wal_dir),
                                      wal_config(P, wal_dir, **kw),
                                      on_op=on_op)


async def scan_rows(P, s, pred=None):
    out = []
    async for b in s.scan(P.ScanRequest(range=P.TimeRange.new(0, 10**12),
                                        predicate=pred)):
        out.extend(zip(b.column(0).to_pylist(), b.column(1).to_pylist(),
                       b.column(2).to_pylist()))
    return sorted(out)


def wal_files(d):
    return sorted(f for f in os.listdir(d) if f.endswith(".wal"))


# ---- frames ---------------------------------------------------------------

FRAME_BATCHES = {
    "two_rows": ([("a", 1, 1.5), ("b", 2, 2.5)], 7, (1, 3)),
    "seeded": ([(f"k{i}", 1000 + i, float(v)) for i, v in
                enumerate(np.random.default_rng(11).random(37))],
               2**63 + 5, (-5, 10**12)),
    "one_row": ([("x", -7, -0.0)], 1, (-7, -6)),
}


@pytest.mark.parametrize("name", sorted(FRAME_BATCHES))
def test_frames_are_the_reference_bytes(name):
    rows, seq, (lo, hi) = FRAME_BATCHES[name]
    b = batch(rows)
    got = PORT.encode_record(seq, PORT.TimeRange.new(lo, hi), b)
    want = REF.encode_record(seq, REF.TimeRange.new(lo, hi), b)
    assert got == want
    recs = list(PORT.decode_records(got * 3))
    assert [(r.seq, int(r.time_range.start), int(r.time_range.end))
            for r in recs] == [(seq, lo, hi)] * 3
    assert all(r.batch.equals(b) for r in recs)


def _decode_cases():
    one = REF.encode_record(1, REF.TimeRange.new(1, 2), batch([("a", 1, 1.0)]))
    two = REF.encode_record(2, REF.TimeRange.new(2, 3), batch([("b", 2, 2.0)]))
    crc = bytearray(one + two)
    crc[12] ^= 0xFF  # a payload byte of record 0
    crc2 = bytearray(one + two)
    crc2[len(one) + 12] ^= 0xFF  # a payload byte of record 1
    short = bytearray(one + two)
    short[len(one):len(one) + 4] = (2).to_bytes(4, "little")  # len < meta
    return {
        "roundtrip": one + two + one,
        "torn_tail": one + two[: len(two) // 2],
        "crc_first": bytes(crc),
        "crc_second": bytes(crc2),
        "garbage_header": b"\xff" * 64,
        "short_length": bytes(short),
        "header_only_tail": one + two[:5],
    }


@pytest.mark.parametrize("case", sorted(_decode_cases()))
def test_decode_stops_at_the_same_record(case):
    blob = _decode_cases()[case]
    ref = list(REF.decode_records(blob))
    got = list(PORT.decode_records(blob))
    assert [r.seq for r in got] == [r.seq for r in ref]
    for g, r in zip(got, ref):
        assert g.batch.equals(r.batch)
        assert (int(g.time_range.start), int(g.time_range.end)) == \
            (int(r.time_range.start), int(r.time_range.end))
    want = {"roundtrip": 3, "torn_tail": 1, "crc_first": 0, "crc_second": 1,
            "garbage_header": 0, "short_length": 1, "header_only_tail": 1}
    assert len(got) == want[case]


# ---- the log --------------------------------------------------------------


async def _log_sequence(P, d, segment_bytes):
    """Append, rotate, mark_flushed and truncate; returns the segment
    files' bytes and the log's counters."""
    cfg = wal_config(P, d, segment_bytes=segment_bytes)
    wal = P.Wal(str(d), cfg)
    wal.replay()
    wal.start()
    rng = np.random.default_rng(5)
    for seq in range(1, 9):
        rows = [(f"k{int(i)}", int(seq * 10 + j), float(v))
                for j, (i, v) in enumerate(zip(rng.integers(0, 4, 3),
                                               rng.random(3)))]
        await wal.append(seq, P.TimeRange.new(seq * 10, seq * 10 + 3),
                         batch(rows))
    wal.mark_flushed([1, 2, 3])
    deleted = await wal.truncate()
    info = (wal.segment_count, wal.backlog_bytes, deleted)
    await wal.close()
    files = {f: open(os.path.join(d, f), "rb").read() for f in wal_files(d)}
    return files, info


@pytest.mark.parametrize("segment_bytes", [1, 700, 1 << 20])
def test_log_files_are_the_reference_bytes(tmp_path, segment_bytes):
    ref = run(_log_sequence(REF, tmp_path / "ref", segment_bytes))
    got = run(_log_sequence(PORT, tmp_path / "port", segment_bytes))
    assert got == ref
    assert got[0], "the sequence must leave segment files"


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_a_log_replays_in_the_other_package(tmp_path, writer, reader):
    W, R = BOTH[writer], BOTH[reader]

    async def go():
        wal = W.Wal(str(tmp_path), wal_config(W, tmp_path, segment_bytes=400))
        wal.replay()
        wal.start()
        for seq in (5, 6, 9):
            await wal.append(seq, W.TimeRange.new(seq, seq + 1),
                             batch([(f"k{seq}", seq, seq / 2)]))
        await wal.close()
        wal2 = R.Wal(str(tmp_path), wal_config(R, tmp_path))
        recs = wal2.replay()
        seg_count = wal2.segment_count
        await wal2.close()
        return recs, seg_count

    recs, seg_count = run(go())
    assert [r.seq for r in recs] == [5, 6, 9]
    assert [r.batch.column(0).to_pylist() for r in recs] == \
        [["k5"], ["k6"], ["k9"]]
    assert seg_count == len(wal_files(tmp_path)) >= 2


def test_group_commit_coalesces(tmp_path):
    fsyncs = []

    async def go():
        cfg = wal_config(PORT, tmp_path,
                         max_group_wait=PORT.ReadableDuration.from_millis(5))
        wal = PORT.Wal(str(tmp_path), cfg,
                       on_op=lambda op: fsyncs.append(op)
                       if op == "fsync" else None)
        wal.replay()
        wal.start()
        b = batch([("a", 1, 1.0)])
        await asyncio.gather(*[wal.append(seq, PORT.TimeRange.new(1, 2), b)
                               for seq in range(1, 33)])
        await wal.close()

    commits = registry.counter("wal_group_commits_total").labels(
        log=tmp_path.name)
    before = commits.value
    run(go())
    # 32 concurrent writers share fsyncs: one per group
    assert 1 <= len(fsyncs) < 32
    assert commits.value - before == len(fsyncs)


# ---- the overlay merge ----------------------------------------------------


def _overlay_inputs(P):
    """Seeded SST parts (merged, builtin columns kept) and memtable
    batches of one segment: 3 keys x 40 timestamps, half overwritten."""
    schema = P.StorageSchema.try_new(SCHEMA, 2, P.UpdateMode.OVERWRITE)
    rng = np.random.default_rng(7)
    keys = np.array(["a", "b", "c"], dtype=object)
    k = keys[rng.integers(0, 3, 120)]
    ts = rng.integers(0, 40, 120)
    sst = schema.fill_builtin_columns(
        pa.record_batch([pa.array(k), pa.array(ts, type=pa.int64()),
                         pa.array(rng.random(120))], schema=SCHEMA), 100)
    mem = []
    for i, seq in enumerate((150, 120, 90)):
        n = 30
        mem.append(schema.fill_builtin_columns(pa.record_batch(
            [pa.array(keys[rng.integers(0, 3, n)]),
             pa.array(rng.integers(0, 40, n), type=pa.int64()),
             pa.array(rng.random(n) + i)], schema=SCHEMA), seq))
    return schema, [sst], mem


OVERLAY_CASES = {
    "no_predicate": (None, False, None),
    "value_predicate": ("gt", False, None),
    "pk_and_value": ("and", False, None),
    "keep_builtin": (None, True, None),
    "projection": ("gt", False, [2]),
}


@pytest.mark.parametrize("case", sorted(OVERLAY_CASES))
def test_overlay_merge_is_the_reference_batch(case):
    kind, keep, proj = OVERLAY_CASES[case]
    out = {}
    for name, P in BOTH.items():
        schema, sst, mem = _overlay_inputs(P)
        ops = ref_ops if name == "ref" else port_ops
        pred = {None: None, "gt": ops.Gt("v", 0.8),
                "and": ops.And([ops.Eq("k", "b"), ops.Lt("v", 1.5)])}[kind]
        columns = P.read.plan_columns(schema, proj)
        out[name] = P.read.merge_memtable_overlay(schema, sst, mem, pred,
                                                  columns, keep)
    assert out["port"].equals(out["ref"])
    assert out["port"].schema.equals(out["ref"].schema)
    assert out["port"].num_rows > 0


# ---- the storage seams ----------------------------------------------------


def test_segment_filter_restricts_every_segment(pools):
    async def go():
        s = await open_inner(PORT, PORT.MemoryObjectStore(), pools["port"])
        try:
            for seg in range(3):
                await s.write(wreq(PORT, [("a", seg * SEGMENT_MS + 5,
                                           float(seg))]))
            req = PORT.ScanRequest(range=PORT.TimeRange.new(0, 10**12))
            keep = {0, 2 * SEGMENT_MS}
            got = []
            async for seg, b in s.scan_segments(
                    req, segment_filter=lambda x: x in keep):
                got.append((seg, None if b is None else
                            b.column(2).to_pylist()))
            rows = [b async for b in s.scan(
                req, segment_filter=lambda x: x == SEGMENT_MS)]
            return got, rows
        finally:
            await s.close()

    got, rows = run(go())
    assert [g for g in got if g[1] is not None] == \
        [(0, [0.0]), (2 * SEGMENT_MS, [2.0])]
    assert sorted(g[0] for g in got if g[1] is None) == [0, 2 * SEGMENT_MS]
    assert [b.column(2).to_pylist() for b in rows] == [[1.0]]


def test_pre_commit_runs_after_the_puts_and_before_the_manifest(pools):
    schema = PORT.StorageSchema.try_new(SCHEMA, 2, PORT.UpdateMode.OVERWRITE)
    stamped = pa.Table.from_batches([schema.fill_builtin_columns(
        batch([("b", 5, 2.0), ("a", 5, 1.0)]), 42)])

    async def go():
        store = PORT.MemoryObjectStore()
        s = await open_inner(PORT, store, pools["port"])
        seen = []

        async def ok():
            seen.append((len(await store.list("db/data/")),
                         len(await s.manifest.all_ssts())))

        async def boom():
            raise PORT.Error("fenced")

        try:
            await s.write_stamped(stamped, PORT.TimeRange.new(5, 6),
                                  pre_commit=ok)
            with pytest.raises(PORT.Error, match="fenced"):
                await s.write_stamped(stamped, PORT.TimeRange.new(5, 6),
                                      pre_commit=boom)
            return seen, len(await s.manifest.all_ssts()), \
                len(await store.list("db/data/"))
        finally:
            await s.close()

    seen, ssts, objects = run(go())
    assert seen == [(2, 0)]  # SST + sidecar put, manifest not yet
    assert ssts == 1 and objects == 4  # the fenced SST is an orphan


# ---- hybrid scan scenarios, both packages ---------------------------------


async def case_unflushed_rows_visible(P, d, rt):
    s = await open_ingest(P, P.MemoryObjectStore(), d, rt)
    try:
        await s.write(wreq(P, [("a", 10, 1.0), ("b", 20, 2.0)]))
        rows = await scan_rows(P, s)
        assert rows == [("a", 10, 1.0), ("b", 20, 2.0)]
        assert await s.manifest.all_ssts() == []
        return rows
    finally:
        await s.close()


async def case_last_value_across_flush(P, d, rt):
    s = await open_ingest(P, P.MemoryObjectStore(), d, rt)
    try:
        await s.write(wreq(P, [("a", 10, 1.0)]))
        await s.flush_all()
        assert len(await s.manifest.all_ssts()) == 1
        await s.write(wreq(P, [("a", 10, 9.0)]))
        first = await scan_rows(P, s)
        await s.flush_all()
        second = await scan_rows(P, s)
        assert first == second == [("a", 10, 9.0)]
        return first, second
    finally:
        await s.close()


async def case_predicate_after_dedup(P, d, rt):
    s = await open_ingest(P, P.MemoryObjectStore(), d, rt)
    try:
        await s.write(wreq(P, [("a", 10, 1.0), ("b", 11, 1.0)]))
        await s.flush_all()
        await s.write(wreq(P, [("a", 10, 5.0)]))
        out = (await scan_rows(P, s, pred=P.Eq("v", 1.0)),
               await scan_rows(P, s, pred=P.Eq("v", 5.0)),
               await scan_rows(P, s, pred=P.And([P.Eq("k", "a"),
                                                 P.Eq("v", 5.0)])),
               await scan_rows(P, s, pred=P.Eq("k", "b")))
        assert out == ([("b", 11, 1.0)], [("a", 10, 5.0)],
                       [("a", 10, 5.0)], [("b", 11, 1.0)])
        return out
    finally:
        await s.close()


async def case_multi_segment(P, d, rt):
    s = await open_ingest(P, P.MemoryObjectStore(), d, rt)
    try:
        await s.write(wreq(P, [("a", 10, 1.0)]))
        await s.flush_all()
        await s.write(wreq(P, [("b", SEGMENT_MS + 10, 2.0)]))
        await s.write(wreq(P, [("c", 2 * SEGMENT_MS + 10, 3.0)]))
        await s.flush_all()
        await s.write(wreq(P, [("c", 2 * SEGMENT_MS + 10, 4.0)]))
        rows = await scan_rows(P, s)
        assert rows == [("a", 10, 1.0), ("b", SEGMENT_MS + 10, 2.0),
                        ("c", 2 * SEGMENT_MS + 10, 4.0)]
        return rows
    finally:
        await s.close()


async def case_rows_threshold_flush(P, d, rt):
    s = await open_ingest(P, P.MemoryObjectStore(), d, rt, flush_rows=4,
                          flush_interval=P.ReadableDuration.from_millis(10))
    try:
        for i in range(6):
            await s.write(wreq(P, [(f"k{i}", 10 + i, float(i))]))
        for _ in range(500):
            if await s.manifest.all_ssts():
                break
            await asyncio.sleep(0.01)
        assert await s.manifest.all_ssts(), \
            "background flusher never drained the memtable"
        rows = await scan_rows(P, s)
        assert len(rows) == 6
        return rows
    finally:
        await s.close()


async def case_aggregate_flushes_then_delegates(P, d, rt):
    s = await open_ingest(P, P.MemoryObjectStore(), d, rt)
    try:
        await s.write(wreq(P, [("a", 10, 1.0), ("a", 70_000, 3.0),
                               ("b", 20, 2.0)]))
        spec = P.AggregateSpec(group_col="k", ts_col="ts", value_col="v",
                               range_start=0, bucket_ms=60_000,
                               num_buckets=2, which=("sum",))
        req = P.ScanRequest(range=P.TimeRange.new(0, 120_000))
        values, grids = await s.scan_aggregate(req, spec)
        assert len(await s.manifest.all_ssts()) == 1
        out = (list(values), np.asarray(
            grids["sum"] if isinstance(grids["sum"], np.ndarray)
            else grids["sum"].cpu().numpy()).tolist())
        assert out == (["a", "b"], [[1.0, 3.0], [2.0, 0.0]])
        return out
    finally:
        await s.close()


async def case_rows_visible_during_inflight_flush(P, d, rt):
    s = await open_ingest(P, P.MemoryObjectStore(), d, rt)
    try:
        await s.write(wreq(P, [("a", 10, 1.0), ("b", 20, 2.0)]))
        gate, entered = asyncio.Event(), asyncio.Event()
        real = s.inner.write_stamped

        async def slow_write_stamped(table, rng):
            entered.set()
            await gate.wait()
            return await real(table, rng)

        s.inner.write_stamped = slow_write_stamped
        flush_task = asyncio.create_task(s.flush_all())
        await asyncio.wait_for(entered.wait(), 10)
        mid = await scan_rows(P, s)
        assert s.ingest_stats()["memtable_rows"] == 2
        gate.set()
        await flush_task
        s.inner.write_stamped = real
        after = await scan_rows(P, s)
        assert mid == after == [("a", 10, 1.0), ("b", 20, 2.0)]
        assert s.ingest_stats()["memtable_rows"] == 0
        return mid, after
    finally:
        await s.close()


async def case_failed_group_write_rotates(P, d, rt):
    class FailOnce:
        fired = False

        def __call__(self, op):
            if op == "append" and not self.fired:
                self.fired = True
                raise OSError("simulated EIO mid-append")

    store = P.MemoryObjectStore()
    s = await open_ingest(P, store, d, rt, on_op=FailOnce())
    with pytest.raises(Exception):
        await s.write(wreq(P, [("lost", 10, 1.0)]))
    await s.write(wreq(P, [("kept", 20, 2.0)]))
    files = wal_files(d)
    assert len(files) == 2
    await s.abort()
    s2 = await open_ingest(P, store, d, rt)
    try:
        rows = await scan_rows(P, s2)
        assert rows == [("kept", 20, 2.0)]
        return rows, files
    finally:
        await s2.close()


async def case_stale_schema_replay(P, d, rt):
    store = P.MemoryObjectStore()
    s = await open_ingest(P, store, d, rt)
    await s.write(wreq(P, [("a", 10, 1.0)]))
    await s.abort()
    schema_b = pa.schema([("k", pa.string()), ("ts", pa.int64()),
                          ("other", pa.float64())])
    inner = await open_inner(P, store, rt, schema=schema_b, root="db2")
    s2 = await P.IngestStorage.open(inner, str(d), wal_config(P, d))
    try:
        rows = s2.ingest_stats()["memtable_rows"]
        await s2.wal.truncate()
        assert (rows, s2.wal.backlog_bytes) == (0, 0)
        return rows, s2.wal.backlog_bytes, wal_files(d)
    finally:
        await s2.close()


async def case_acked_rows_survive_abort(P, d, rt):
    store = P.MemoryObjectStore()
    s = await open_ingest(P, store, d, rt)
    await s.write(wreq(P, [("a", 10, 1.0)]))
    await s.write(wreq(P, [("b", 20, 2.0)]))
    await s.abort()
    s2 = await open_ingest(P, store, d, rt)
    try:
        rows = await scan_rows(P, s2)
        st = s2.ingest_stats()
        assert rows == [("a", 10, 1.0), ("b", 20, 2.0)]
        assert st["memtable_rows"] == 2 and st["wal_backlog_bytes"] > 0
        return rows, st["memtable_rows"], st["wal_backlog_bytes"]
    finally:
        await s2.close()


async def case_replay_over_flushed_sst_exactly_once(P, d, rt):
    store = P.MemoryObjectStore()
    wal_dir, backup = d / "wal", d / "bk"
    s = await open_ingest(P, store, wal_dir, rt)
    await s.write(wreq(P, [("a", 10, 1.0)]))
    await s.write(wreq(P, [("a", 10, 2.0), ("b", 20, 3.0)]))
    shutil.copytree(wal_dir, backup)
    await s.flush_all()
    await s.abort()
    shutil.rmtree(wal_dir)
    shutil.copytree(backup, wal_dir)
    s2 = await open_ingest(P, store, wal_dir, rt)
    try:
        expect = [("a", 10, 2.0), ("b", 20, 3.0)]
        first = await scan_rows(P, s2)
        await s2.flush_all()
        second = await scan_rows(P, s2)
        assert first == second == expect
        return first, second
    finally:
        await s2.close()


async def case_truncation_empties_wal_dir(P, d, rt):
    s = await open_ingest(P, P.MemoryObjectStore(), d, rt, segment_bytes=1)
    try:
        for i in range(4):
            await s.write(wreq(P, [(f"k{i}", 10 + i, float(i))]))
        before = s.wal.backlog_bytes
        await s.flush_all()
        files = wal_files(d)
        assert before > 0 and s.wal.backlog_bytes == 0 and len(files) <= 1
        return before, s.wal.backlog_bytes, len(files)
    finally:
        await s.close()


async def case_append_tables_skip_the_wal(P, d, rt):
    """IngestStorage refuses an Append table before it touches the log
    (the port's storage serves Overwrite tables only, so the table is a
    stub with an Append schema)."""
    inner = types.SimpleNamespace(schema=lambda: P.StorageSchema.try_new(
        SCHEMA, 2, P.UpdateMode.APPEND))
    with pytest.raises(P.Error, match="Overwrite"):
        await P.IngestStorage.open(inner, str(d / "wal"), wal_config(P, d))
    return os.path.exists(d / "wal")


CASES = {f.__name__[5:]: f for f in (
    case_unflushed_rows_visible, case_last_value_across_flush,
    case_predicate_after_dedup, case_multi_segment,
    case_rows_threshold_flush, case_aggregate_flushes_then_delegates,
    case_rows_visible_during_inflight_flush, case_failed_group_write_rotates,
    case_stale_schema_replay, case_acked_rows_survive_abort,
    case_replay_over_flushed_sst_exactly_once,
    case_truncation_empties_wal_dir, case_append_tables_skip_the_wal)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_scenario_matches_the_reference(case, tmp_path, pools):
    """The same scenario on both packages: the same rows and stats."""
    out = {}
    for name, P in BOTH.items():
        d = tmp_path / name
        d.mkdir()
        out[name] = run(CASES[case](P, d, pools[name]))
    assert out["port"] == out["ref"]


# ---- fencing and the flush barrier (the port) -----------------------------


@pytest.mark.parametrize("when", ["preflight", "pre_commit"])
def test_a_fence_that_raises_commits_nothing(tmp_path, pools, when):
    """A fence that fails at the pre-flight check, or only at the
    manifest publish, leaves no manifest entry; the rows stay readable,
    in the memtable and in the WAL."""

    class Fence:
        calls = 0

        async def check(self):
            self.calls += 1
            if when == "preflight" or self.calls > 1:
                raise PORT.Error("stale epoch")

    async def go():
        store = PORT.MemoryObjectStore()
        s = await open_ingest(PORT, store, tmp_path, pools["port"])
        try:
            await s.write(wreq(PORT, [("a", 10, 1.0), ("b", 20, 2.0)]))
            s.fence = Fence()
            with pytest.raises(PORT.Error, match="stale epoch"):
                await s.flush_all()
            ssts = await s.manifest.all_ssts()
            rows = await scan_rows(PORT, s)
            st = s.ingest_stats()
            objects = len(await store.list("db/data/"))
            s.fence = None
            await s.flush_all()
            return (ssts, rows, st, objects, s.fence,
                    len(await s.manifest.all_ssts()),
                    await scan_rows(PORT, s))
        finally:
            await s.close()

    ssts, rows, st, objects, _, ssts_after, rows_after = run(go())
    assert ssts == []
    assert rows == rows_after == [("a", 10, 1.0), ("b", 20, 2.0)]
    assert st["memtable_rows"] == 2 and st["wal_backlog_bytes"] > 0
    # pre-flight fails before the upload; pre_commit after it (orphans)
    assert objects == (0 if when == "preflight" else 2)
    assert ssts_after == 1


def test_flush_overlapping_waits_out_an_inflight_flush(tmp_path, pools):
    """The aggregate's pre-flush must not return while a background
    flush of an overlapping segment is still in flight: the replan
    would miss its rows.  A disjoint segment's flush is not waited for."""

    async def go():
        s = await open_ingest(PORT, PORT.MemoryObjectStore(), tmp_path,
                              pools["port"])
        try:
            await s.write(wreq(PORT, [("a", 10, 1.0)]))
            gate, entered = asyncio.Event(), asyncio.Event()
            real = s.inner.write_stamped

            async def held(table, rng):
                entered.set()
                await gate.wait()
                return await real(table, rng)

            s.inner.write_stamped = held
            inflight = asyncio.create_task(s._flush_segment(0))
            await asyncio.wait_for(entered.wait(), 10)
            s.inner.write_stamped = real
            disjoint = await asyncio.wait_for(s.flush_overlapping(
                PORT.TimeRange.new(5 * SEGMENT_MS, 6 * SEGMENT_MS)), 10)
            barrier = asyncio.create_task(
                s.flush_overlapping(PORT.TimeRange.new(0, 100)))
            await asyncio.sleep(0.05)
            waited = not barrier.done()
            gate.set()
            await barrier
            await inflight
            spec = PORT.AggregateSpec(group_col="k", ts_col="ts",
                                      value_col="v", range_start=0,
                                      bucket_ms=60_000, num_buckets=1,
                                      which=("sum",))
            values, grids = await s.scan_aggregate(
                PORT.ScanRequest(range=PORT.TimeRange.new(0, 60_000)), spec)
            return disjoint, waited, list(values), \
                grids["sum"].cpu().numpy().tolist()
        finally:
            await s.close()

    disjoint, waited, values, sums = run(go())
    assert disjoint == 0
    assert waited, "flush_overlapping returned before the in-flight flush"
    assert values == ["a"] and sums == [[1.0]]


def _route_counts():
    from horaedb_tpu_torch.ops import device_decode as dd

    return {r: dd._SORT_SKIPPED[r].value
            for r in ("compacted", "checked", "kway")}


def test_flushed_seqs_win_in_every_device_decode_route(tmp_path, pools,
                                                      monkeypatch):
    """Flushed SSTs keep each row's write seq: an overwrite through the
    WAL must win on the parts path's device decode in all three routes
    (one SST holding two entries with duplicate PKs: compacted; two SSTs
    whose runs are already in order: checked; two interleaved SSTs:
    kway), byte-equal to host decode and equal to the reference."""
    monkeypatch.setenv("HORAEDB_FUSED_AGG", "0")
    rng = np.random.default_rng(3)

    def rows(seg, keys, n, bump):
        return [(f"k{int(k)}", seg * SEGMENT_MS + int(t), float(v) + bump)
                for k, t, v in zip(rng.choice(keys, n),
                                   rng.integers(0, 3000, n),
                                   rng.random(n))]

    base = rows(0, [0, 1, 2, 3], 60, 0)
    writes = [
        # segment 0: two entries flushed as one SST, PKs repeated
        (base, [(k, t, v + 100) for k, t, v in base[:25]]),
        # segment 1: a second SST whose keys all sort after the first's
        (rows(1, [0, 1], 40, 0), rows(1, [3, 4], 40, 50)),
        # segment 2: a second SST interleaved with the first
        (rows(2, [0, 1, 2, 3], 50, 0), rows(2, [0, 1, 2, 3], 50, 200)),
    ]

    async def go(P, rt, decode):
        cfg_over = {"scan": {"decode": {"mode": decode}}} if decode else {}
        inner = await P.CloudObjectStorage.open(
            "db", SEGMENT_MS, P.MemoryObjectStore(), SCHEMA, 2,
            P.from_dict(P.StorageConfig, {
                "scheduler": {"schedule_interval": "1h"}, **cfg_over}),
            runtimes=rt, **P.open_kw)
        d = tmp_path / f"{'ref' if P is REF else decode}"
        s = await P.IngestStorage.open(inner, str(d), wal_config(P, d))
        try:
            for seg, (first, second) in enumerate(writes):
                await s.write(wreq(P, first))
                if seg:
                    await s.flush_all()
                await s.write(wreq(P, second))
                await s.flush_all()
            ssts = len(await s.manifest.all_ssts())
            spec = P.AggregateSpec(group_col="k", ts_col="ts", value_col="v",
                                   range_start=0, bucket_ms=600_000,
                                   num_buckets=18,
                                   which=("count", "sum", "min", "max",
                                          "last"))
            before = _route_counts()
            out = await s.scan_aggregate(
                P.ScanRequest(range=P.TimeRange.new(0, 3 * SEGMENT_MS)),
                spec)
            after = _route_counts()
            return out, ssts, {r: after[r] - before[r] for r in after}
        finally:
            await s.close()

    dev, ssts, routes = run(go(PORT, pools["port"], "device"))
    host, _, host_routes = run(go(PORT, pools["port"], "host"))
    ref, _, _ = run(go(REF, pools["ref"], None))
    assert ssts == 5
    assert routes == {"compacted": 1, "checked": 1, "kway": 1}
    assert host_routes == {"compacted": 0, "checked": 0, "kway": 0}
    assert list(dev[0]) == list(host[0]) == list(ref[0])
    for k in dev[1]:
        assert dev[1][k].tobytes() == host[1][k].tobytes(), k
        want = np.asarray(ref[1][k])
        if k == "sum":
            np.testing.assert_allclose(dev[1][k], want, rtol=1e-5)
        else:
            assert dev[1][k].tobytes() == want.tobytes(), k
    # the overwritten rows' newer values won: +100 in segment 0's max
    assert np.nanmax(dev[1]["max"][:, :6]) > 100


# ---- seeded crash schedules (the port) ------------------------------------


class SimCrash(Exception):
    pass


class Crashed(Exception):
    pass


class CrashStore(ObjectStore):
    """The port's MemoryObjectStore with seeded faults and a crash at a
    global op index: `halted` fails every later op until `revive()`.  A
    mutating op's fault lands before or after the op (a lost ack)."""

    def __init__(self, seed: int, fault_rate: float, crash_at):
        self.inner = PORT.MemoryObjectStore()
        self._rng = random.Random(seed)
        self.fault_rate = fault_rate
        self.crash_at = crash_at
        self.ops = 0
        self.halted = False

    def crash(self):
        self.halted = True

    def revive(self):
        self.halted = False
        self.crash_at = None
        self.fault_rate = 0.0

    async def _call(self, op, *args):
        if self.halted:
            raise SimCrash(f"store halted: {op}")
        self.ops += 1
        mutating = op in ("put", "delete")
        if self.crash_at is not None and self.ops >= self.crash_at:
            after = mutating and self._rng.random() < 0.5
            if after:
                await getattr(self.inner, op)(*args)
            self.crash()
            raise SimCrash(f"crash at store op #{self.ops} ({op})")
        fault = self.fault_rate and self._rng.random() < self.fault_rate
        after = fault and mutating and self._rng.random() < 0.5
        if fault and not after:
            raise PORT.Error(f"injected {op} failure")
        out = await getattr(self.inner, op)(*args)
        if after:
            raise PORT.Error(f"injected lost-ack {op} failure")
        return out

    async def put(self, path, data):
        return await self._call("put", path, data)

    async def get(self, path):
        return await self._call("get", path)

    async def get_range(self, path, start, end):
        return await self._call("get_range", path, start, end)

    async def head(self, path):
        return await self._call("head", path)

    async def delete(self, path):
        return await self._call("delete", path)

    async def list(self, prefix):
        return await self._call("list", prefix)


class CrashHook:
    """Crash-at-op for the WAL's durable transitions; it halts the store
    too, so a process death stops both planes at once."""

    def __init__(self, crash_at, store):
        self.ops = 0
        self.crash_at = crash_at
        self.store = store
        self.halted = False

    def __call__(self, op: str) -> None:
        if self.halted:
            raise SimCrash(f"halted: {op}")
        self.ops += 1
        if self.crash_at is not None and self.ops >= self.crash_at:
            self.halted = True
            self.store.crash()
            raise SimCrash(f"crash at wal op #{self.ops} ({op})")


async def run_wal_schedule(i: int, rt, base_dir) -> None:
    """Seeded write / flush / reopen / scan ops with a crash at a WAL or
    store op; after the restart every acked row is visible exactly once
    with a value no older than its last ack, and no row was never sent."""
    P = PORT
    rng = random.Random((1337 << 16) ^ i)
    store = CrashStore(rng.randrange(2**32), rng.choice([0.0, 0.0, 0.02]),
                       rng.randint(2, 80) if rng.random() < 0.5 else None)
    hook = CrashHook(rng.randint(2, 40) if rng.random() < 0.7 else None,
                     store)
    wal_dir = os.path.join(str(base_dir), f"sched{i}")
    acked: dict = {}
    attempted: dict = {}
    order = 0
    keys_used: list = []

    def next_rows():
        nonlocal order
        rows = []
        for _ in range(rng.randint(1, 3)):
            if keys_used and rng.random() < 0.3:
                k, ts = rng.choice(keys_used)
            else:
                seg = rng.randrange(2)
                k, ts = f"k{rng.randrange(6)}", \
                    seg * SEGMENT_MS + 10 + len(keys_used)
                keys_used.append((k, ts))
            rows.append((k, ts, float(order * 1000 + len(rows))))
        order += 1
        return rows

    def guard(coro):
        async def go():
            try:
                return await coro
            except asyncio.CancelledError:
                raise
            except BaseException:
                if store.halted or hook.halted:
                    hook.halted = True
                    raise Crashed from None
                raise
        return go()

    async def open_s():
        inner = await open_inner(P, store, rt)
        cfg = wal_config(P, wal_dir,
                         flush_rows=rng.choice([3, 20, 10**6]),
                         segment_bytes=rng.choice([1, 1 << 20]))
        try:
            return await P.IngestStorage.open(inner, wal_dir, cfg,
                                              on_op=hook)
        except BaseException:
            await inner.close()
            raise

    s = None
    try:
        s = await guard(open_s())
        for _ in range(rng.randint(4, 12)):
            op = rng.choices(["write", "flush", "reopen", "scan"],
                             weights=[65, 15, 10, 10])[0]
            if op == "write":
                rows = next_rows()
                this_order = order
                for k, ts, v in rows:
                    attempted.setdefault((k, ts), []).append((this_order, v))
                try:
                    await guard(s.write(wreq(P, rows)))
                except Crashed:
                    raise
                except Exception:
                    continue  # unacked: may or may not surface later
                for k, ts, v in rows:
                    acked[(k, ts)] = (this_order, v)
            elif op == "flush":
                try:
                    await guard(s.flush_all())
                except Crashed:
                    raise
                except Exception:
                    continue
            elif op == "reopen":
                try:
                    await guard(s.close(flush=rng.random() < 0.5))
                except Crashed:
                    s = None
                    raise
                except Exception:
                    pass
                s = None
                s = await guard(open_s())
            else:
                try:
                    rows = await guard(scan_rows(P, s))
                except Crashed:
                    raise
                except Exception:
                    continue
                seen = {(k, ts): v for k, ts, v in rows}
                assert len(seen) == len(rows), \
                    f"schedule {i}: duplicate rows mid-schedule"
                for key in acked:
                    assert key in seen, \
                        f"schedule {i}: acked row {key} missing pre-crash"
    except Crashed:
        pass
    finally:
        if s is not None:
            await s.abort()

    store.revive()
    hook.halted = False
    hook.crash_at = None
    s2 = await open_s()
    try:
        for attempt in range(2):  # scan, then flush + rescan
            seen: dict = {}
            for k, ts, v in await scan_rows(P, s2):
                assert (k, ts) not in seen, \
                    f"schedule {i}: duplicate row {(k, ts)} ({attempt})"
                seen[(k, ts)] = v
            for key, (ord_, v) in acked.items():
                assert key in seen, f"schedule {i}: acked row {key} lost"
                assert any(av == seen[key] for o, av in attempted[key]
                           if o >= ord_), \
                    f"schedule {i}: acked row {key} shows {seen[key]}, " \
                    f"older than its last ack {v}"
            for key, v in seen.items():
                assert any(av == v for _, av in attempted.get(key, [])), \
                    f"schedule {i}: ghost row {key}={v}"
            if attempt == 0:
                await s2.flush_all()
    finally:
        await s2.close()


@pytest.mark.parametrize("schedule", range(12))
def test_crash_schedule_keeps_acked_rows_exactly_once(schedule, tmp_path,
                                                      pools):
    run(run_wal_schedule(schedule, pools["port"], tmp_path))


# ---- the WAL-fronted engine -----------------------------------------------

ESEG = 2 * 3600 * 1000
ET0 = (1_700_000_000_000 // ESEG) * ESEG
HOSTS = 7


def _host_batch(seed, ticks, t_start, bump=0.0, hosts=HOSTS):
    rng = np.random.default_rng(seed)
    ts = t_start + np.repeat(np.arange(ticks, dtype=np.int64) * 60_000,
                             hosts)
    host = np.tile(np.arange(hosts), ticks)
    names = np.array([f"h{i}" for i in range(hosts)], dtype=object)
    return pa.record_batch({
        "host": pa.array(names[host]),
        "timestamp": pa.array(ts, type=pa.int64()),
        "value": pa.array(rng.random(len(ts)) * 100 + bump)})


def _grids_host(out):
    return {k: (v if isinstance(v, np.ndarray) else v.cpu().numpy())
            for k, v in out["aggs"].items()}


async def _engine_pair(tmp_path, scan=None):
    from horaedb_tpu.metric_engine import MetricEngine as RefEngine
    from horaedb_tpu_torch.metric_engine import MetricEngine as PortEngine

    scan = scan or {}
    ref = await RefEngine.open(
        "m", REF.MemoryObjectStore(), segment_ms=ESEG,
        config=REF.from_dict(REF.StorageConfig, {"scan": scan}),
        wal_config=wal_config(REF, tmp_path / "ref"))
    port = await PortEngine.open(
        "m", PORT.MemoryObjectStore(), segment_ms=ESEG,
        config=PORT.from_dict(PORT.StorageConfig, {"scan": scan}),
        device="cpu", wal_config=wal_config(PORT, tmp_path / "port"))
    return ref, port


def test_engine_behind_the_wal_matches_the_reference(tmp_path, monkeypatch):
    monkeypatch.setenv("HORAEDB_FUSED_AGG", "1")

    async def go():
        ref, port = await _engine_pair(tmp_path)
        try:
            for e in (ref, port):
                await e.write_arrow("cpu", ["host"],
                                    _host_batch(1, 150, ET0))
            rng_ref = REF.TimeRange.new(ET0, ET0 + 150 * 60_000)
            rng_port = PORT.TimeRange.new(ET0, ET0 + 150 * 60_000)
            # raw rows through the hybrid scan, before any flush
            r_rows = await ref.query("cpu", [("host", "h3")], rng_ref)
            g_rows = await port.query("cpu", [("host", "h3")], rng_port)
            assert g_rows.equals(r_rows) and g_rows.num_rows == 150
            r_st, g_st = await ref.stats(), await port.stats()
            for key in ("memtable_rows", "wal_backlog_bytes", "ssts",
                        "rows"):
                assert g_st[key] == r_st[key], key
            assert g_st["memtable_rows"] > 150 * HOSTS and g_st["ssts"] == 0
            # the aggregate flushes the overlapping memtables, then reads
            # pure SST state
            for aggs in (("avg",), ("count", "sum", "min", "max", "last")):
                r = await ref.query_downsample("cpu", [], rng_ref, 600_000,
                                               aggs=aggs)
                g = await port.query_downsample("cpu", [], rng_port, 600_000,
                                                aggs=aggs)
                _compare(r, g)
            r_st, g_st = await ref.stats(), await port.stats()
            for name in g_st["tables"]:
                for key in ("ssts", "rows"):
                    assert g_st["tables"][name][key] == \
                        r_st["tables"][name][key], (name, key)
                assert g_st["tables"][name]["ingest"]["memtable_rows"] == \
                    r_st["tables"][name]["ingest"]["memtable_rows"], name
            assert g_st["tables"]["data"]["ingest"]["memtable_rows"] == 0
            flushed = await port.flush()
            assert set(flushed) == set(port.tables)
            assert sum(v["flushed_rows"] for v in flushed.values()) > 0
            g_st = await port.stats()
            assert g_st["memtable_rows"] == 0
            assert g_st["last_flush_age_s"] is not None
            assert g_st["cache"]["scan_cache_bytes"] > 0
        finally:
            await ref.close()
            await port.close()

    run(go())


def test_engine_open_failure_unwinds_the_wal_fronts(tmp_path, monkeypatch):
    """A table that fails to open closes every table and WAL already
    opened; the same directory opens again afterwards."""
    from horaedb_tpu_torch.metric_engine import MetricEngine as PortEngine

    real = port_wal.IngestStorage.open
    opened = []

    async def flaky(inner, wal_dir, config, **kw):
        if wal_dir.endswith("index"):
            raise PORT.Error("injected open failure")
        s = await real(inner, wal_dir, config, **kw)
        opened.append(s)
        return s

    async def go():
        monkeypatch.setattr(port_wal.IngestStorage, "open", flaky)
        with pytest.raises(PORT.Error, match="injected"):
            await PortEngine.open("m", PORT.MemoryObjectStore(),
                                  segment_ms=ESEG, device="cpu",
                                  wal_config=wal_config(PORT, tmp_path))
        closed = [s.wal._commit_task is None and s._flusher_task is None
                  for s in opened]
        monkeypatch.setattr(port_wal.IngestStorage, "open", real)
        e = await PortEngine.open("m", PORT.MemoryObjectStore(),
                                  segment_ms=ESEG, device="cpu",
                                  wal_config=wal_config(PORT, tmp_path))
        await e.close()
        return closed

    closed = run(go())
    assert closed == [True, True, True]
    with pytest.raises(PORT.Error, match="wal.dir"):
        from horaedb_tpu_torch.metric_engine import MetricEngine

        run(MetricEngine.open("m", PORT.MemoryObjectStore(), device="cpu",
                              wal_config=PORT.WalConfig(enabled=True)))


def test_a_flush_invalidates_the_fused_replay(tmp_path, monkeypatch):
    """The replay key holds each segment's SST ids: the flush of a tail
    and of an overwrite adds an SST, so the next fused query misses the
    replay, re-reads only the changed segments and matches the reference;
    its grids are byte-equal to the same query from cold caches, and the
    query after it replays them."""
    from test_torch_replay import _same_bytes

    monkeypatch.setenv("HORAEDB_FUSED_AGG", "1")
    monkeypatch.setenv("HORAEDB_DEVCOL_STACK", "1")
    monkeypatch.setattr(port_read.ParquetReader, "_devcol_stack_ok",
                        lambda self: True)
    span_ms = 4 * ESEG

    async def go():
        ref, port = await _engine_pair(tmp_path, {"max_window_rows": 512})
        reader = port.tables["data"].reader
        rng_ref = REF.TimeRange.new(ET0, ET0 + span_ms)
        rng_port = PORT.TimeRange.new(ET0, ET0 + span_ms)

        async def query():
            r = await ref.query_downsample("cpu", [], rng_ref, 600_000,
                                           aggs=("avg",))
            g = await port.query_downsample("cpu", [], rng_port, 600_000,
                                            aggs=("avg",))
            _compare(r, g)
            return g

        try:
            for e in (ref, port):
                await e.write_arrow("cpu", ["host"],
                                    _host_batch(2, 6 * 60, ET0))
            await query()
            await query()
            assert (reader._replay_hits, reader._replay_misses) == (1, 1)
            for what, b in (
                    ("tail", _host_batch(3, 60, ET0 + 6 * 3_600_000)),
                    ("overwrite", _host_batch(4, 5, ET0, bump=1000.0))):
                for e in (ref, port):
                    await e.write_arrow("cpu", ["host"], b)
                hits0, misses0 = reader._replay_hits, reader._replay_misses
                reads0 = reader.scan_cache.misses
                after = await query()
                assert (reader._replay_hits - hits0,
                        reader._replay_misses - misses0) == (0, 1), what
                # only the flushed segment is read again
                assert reader.scan_cache.misses - reads0 == 1, what
                again = await query()
                assert reader._replay_hits - hits0 == 1, what
                _same_bytes(after, again, f"{what}: replay")
                reader.scan_cache.clear()
                reader._replay_cache.clear()
                cold = await query()
                _same_bytes(after, cold, f"{what}: cold recompute")
            return _grids_host(after)
        finally:
            await ref.close()
            await port.close()

    grids = run(go())
    assert grids["count"].sum() == HOSTS * (6 * 60 + 60)
