"""Compaction, the orphan scrubber and the compaction-race replans of the
port (storage/compaction.py, storage/gc.py, storage/storage.py).  The
cases mirror the JAX package's tests/test_storage.py (picker, in
-compaction exclusion, TTL split, merge and cleanup, scan after
compaction, fused restart on a race, expired-only GC) and
tests/test_fault_injection.py (failed output put, scrubbed input
delete), and hold the engine's query results after compaction against
the JAX package's."""

import asyncio

import numpy as np
import pyarrow as pa
import pytest
from test_torch_engine import END, SEG, T0, _batches, _compare

from horaedb_tpu.metric_engine import MetricEngine as RefEngine
from horaedb_tpu.objstore import MemoryObjectStore as RefStore
from horaedb_tpu.storage.types import TimeRange as RefRange
from horaedb_tpu_torch.common import ReadableDuration, now_ms
from horaedb_tpu_torch.common.loops import loops
from horaedb_tpu_torch.metric_engine import MetricEngine
from horaedb_tpu_torch.objstore import MemoryObjectStore, NotFoundError
from horaedb_tpu_torch.ops.downsample import ALL_AGGS
from horaedb_tpu_torch.storage import read as read_mod
from horaedb_tpu_torch.storage.compaction import TimeWindowCompactionStrategy
from horaedb_tpu_torch.storage.config import StorageConfig, from_dict
from horaedb_tpu_torch.storage.read import AggregateSpec, ScanRequest
from horaedb_tpu_torch.storage.sst import FileMeta, SstFile, segment_of
from horaedb_tpu_torch.storage.storage import CloudObjectStorage, WriteRequest
from horaedb_tpu_torch.storage.types import TimeRange, Timestamp

SEGMENT_MS = 3_600_000


def user_schema():
    return pa.schema([pa.field("host", pa.string()),
                      pa.field("ts", pa.int64()),
                      pa.field("cpu", pa.float64())])


def make_batch(rows):
    hosts, tss, cpus = zip(*rows)
    return pa.record_batch(
        [pa.array(list(hosts)), pa.array(list(tss), type=pa.int64()),
         pa.array(list(cpus), type=pa.float64())], schema=user_schema())


def wreq(rows, rng=None):
    ts = [r[1] for r in rows]
    rng = rng or (min(ts), max(ts) + 1)
    return WriteRequest(make_batch(rows), TimeRange.new(*rng))


class FaultStore(MemoryObjectStore):
    """A memory store whose next put/delete of a matching path fails."""

    def __init__(self):
        super().__init__()
        self._faults: list = []

    def fail_next(self, op: str, fragment: str) -> None:
        self._faults.append((op, fragment))

    def _maybe_fail(self, op: str, path: str) -> None:
        for i, (o, frag) in enumerate(self._faults):
            if o == op and frag in path:
                del self._faults[i]
                raise OSError(f"injected {op} fault: {path}")

    async def put(self, path, data):
        self._maybe_fail("put", path)
        await super().put(path, data)

    async def delete(self, path):
        self._maybe_fail("delete", path)
        await super().delete(path)


async def open_storage(store=None, **scheduler):
    cfg = from_dict(StorageConfig, {"scheduler": {
        "schedule_interval": "1h", **scheduler}})
    cfg.manifest.merge_interval = ReadableDuration.parse("1h")
    cfg.scrub.interval = ReadableDuration.parse("1h")
    return await CloudObjectStorage.open(
        "db", SEGMENT_MS, store or MemoryObjectStore(), user_schema(), 2,
        cfg, device="cpu")


async def collect(stream):
    return [b async for b in stream]


def rows_of(batches):
    out = []
    for b in batches:
        out.extend(zip(b.column(0).to_pylist(), b.column(1).to_pylist(),
                       b.column(2).to_pylist()))
    return out


async def scan_rows(s, lo=0, hi=10**10):
    return rows_of(await collect(s.scan(ScanRequest(
        range=TimeRange.new(lo, hi)))))


async def compact_once(s):
    task = await s.compact_scheduler.picker.pick_candidate()
    if task is not None:
        await s.compact_scheduler.executor.execute(task)
    return task


# ---------------------------------------------------------------------------
# picker
# ---------------------------------------------------------------------------


def mkfile(fid, start, end, size=100):
    return SstFile(fid, FileMeta(max_sequence=fid, num_rows=10, size=size,
                                 time_range=TimeRange.new(start, end)))


def strategy(**kw):
    args = dict(segment_duration_ms=100, new_sst_max_size=1000,
                input_sst_max_num=4, input_sst_min_num=2)
    args.update(kw)
    return TimeWindowCompactionStrategy(**args)


class TestPickerStrategy:
    def test_picks_newest_qualifying_segment(self):
        ssts = [mkfile(1, 0, 10), mkfile(2, 20, 30),
                mkfile(3, 100, 110), mkfile(4, 120, 130)]
        task = strategy().pick_candidate(ssts, None)
        assert sorted(f.id for f in task.inputs) == [3, 4]
        assert all(f.in_compaction for f in task.inputs)
        assert not any(f.in_compaction for f in ssts[:2])

    def test_in_compaction_files_excluded(self):
        ssts = [mkfile(1, 0, 10), mkfile(2, 20, 30)]
        ssts[0].mark_compaction()
        assert strategy().pick_candidate(ssts, None) is None
        # a failed task unmarks: the pair qualifies again
        ssts[0].unmark_compaction()
        assert strategy().pick_candidate(ssts, None) is not None

    def test_min_num_required(self):
        ssts = [mkfile(1, 0, 10), mkfile(2, 20, 30)]
        assert strategy(input_sst_min_num=3).pick_candidate(ssts, None) is None

    def test_size_budget_smallest_first(self):
        ssts = [mkfile(1, 0, 10, size=100), mkfile(2, 20, 30, size=100),
                mkfile(3, 40, 50, size=100), mkfile(4, 60, 70, size=500)]
        task = strategy(new_sst_max_size=250).pick_candidate(ssts, None)
        assert sorted(f.id for f in task.inputs) == [1, 2]  # budget 275

    def test_max_num_cap(self):
        ssts = [mkfile(i, i * 10, i * 10 + 5) for i in range(1, 7)]
        task = strategy(input_sst_max_num=3).pick_candidate(ssts, None)
        assert len(task.inputs) == 3

    def test_ttl_expired_split_out(self):
        ssts = [mkfile(1, 0, 10), mkfile(2, 20, 30),
                mkfile(3, 100, 110), mkfile(4, 120, 130)]
        # expire_time=50: files ending before 50 are expired
        task = strategy().pick_candidate(ssts, Timestamp(50))
        assert sorted(f.id for f in task.expireds) == [1, 2]
        assert sorted(f.id for f in task.inputs) == [3, 4]
        assert all(f.in_compaction for f in task.expireds)

    def test_expireds_only_task_when_no_rewrite_qualifies(self):
        ssts = [mkfile(1, 0, 10), mkfile(3, 100, 110)]
        task = strategy().pick_candidate(ssts, Timestamp(50))
        assert task.inputs == [] and [f.id for f in task.expireds] == [1]


# ---------------------------------------------------------------------------
# executor end to end
# ---------------------------------------------------------------------------


class TestCompactionEndToEnd:
    def test_compact_merges_files_and_cleans_up(self):
        async def go():
            store = MemoryObjectStore()
            s = await open_storage(store, input_sst_min_num=2)
            try:
                for rows in ([("a", 1000, 1.0), ("b", 2000, 2.0)],
                             [("b", 2000, 20.0), ("c", 3000, 3.0)],
                             [("c", 3000, 30.0)]):
                    await s.write(wreq(rows, (1000, 3001)))
                assert len(await s.manifest.all_ssts()) == 3
                task = await compact_once(s)
                assert task is not None and len(task.inputs) == 3
                ssts = await s.manifest.all_ssts()
                assert len(ssts) == 1
                new = ssts[0]
                assert new.meta.num_rows == 3
                assert new.meta.time_range == TimeRange.new(1000, 3001)
                # inputs gone; the output and its sidecar present
                objs = sorted(m.path for m in await store.list("db/data/"))
                assert objs == [f"db/data/{new.id}.enc",
                                f"db/data/{new.id}.sst"]
                assert await scan_rows(s, 0, 10_000) == [
                    ("a", 1000, 1.0), ("b", 2000, 20.0), ("c", 3000, 30.0)]
                # a single file is below min: nothing to pick
                assert await s.compact_scheduler.picker.pick_candidate() \
                    is None
            finally:
                await s.close()

        asyncio.run(go())

    def test_scan_after_compaction_dedups_vs_new_writes(self):
        async def go():
            s = await open_storage(input_sst_min_num=2)
            try:
                await s.write(wreq([("a", 1000, 1.0)]))
                await s.write(wreq([("a", 1000, 2.0)]))
                await compact_once(s)
                # a write AFTER compaction still shadows compacted rows
                await s.write(wreq([("a", 1000, 3.0)]))
                assert await scan_rows(s, 0, 10_000) == [("a", 1000, 3.0)]
            finally:
                await s.close()

        asyncio.run(go())

    def test_compaction_streams_output_in_bounded_chunks(self):
        async def go():
            store = MemoryObjectStore()
            chunk_sizes: list[int] = []
            real_put_stream = store.put_stream

            async def spying_put_stream(path, chunks):
                async def spy():
                    async for c in chunks:
                        chunk_sizes.append(len(c))
                        yield c

                return await real_put_stream(path, spy())

            store.put_stream = spying_put_stream
            cfg = from_dict(StorageConfig, {
                "scheduler": {"schedule_interval": "1h",
                              "input_sst_min_num": 2},
                "write": {"max_row_group_size": 1024}})
            s = await CloudObjectStorage.open(
                "db", SEGMENT_MS, store, user_schema(), 2, cfg, device="cpu")
            try:
                rng = np.random.default_rng(0)
                for _ in range(2):
                    rows = [(f"t{int(t) % 50:02d}", int(t), float(v))
                            for t, v in zip(rng.integers(0, SEGMENT_MS, 8000),
                                            rng.random(8000))]
                    await s.write(wreq(sorted(rows), (0, SEGMENT_MS)))
                before = await scan_rows(s, 0, SEGMENT_MS)
                assert await compact_once(s) is not None
                assert len(chunk_sizes) > 4, chunk_sizes
                assert max(chunk_sizes) < sum(chunk_sizes)
                assert await scan_rows(s, 0, SEGMENT_MS) == before
            finally:
                await s.close()

        asyncio.run(go())

    def test_trigger_wakes_the_scheduler(self):
        """trigger() runs the background picker -> executor now (the
        interval is an hour); its loops are registered while the table
        is open and gone after close."""
        async def go():
            s = await open_storage(input_sst_min_num=2)
            try:
                names = {h.name for h in loops.handles()}
                assert {"compact-picker:db", "compact-executor:db",
                        "orphan-scrubber:db"} <= names
                for i in range(3):
                    await s.write(wreq([("a", 1000 + i, float(i))]))
                await s.compact()
                for _ in range(200):
                    if len(await s.manifest.all_ssts()) == 1:
                        break
                    await asyncio.sleep(0.01)
                assert len(await s.manifest.all_ssts()) == 1
                assert [r[2] for r in await scan_rows(s)] == [0.0, 1.0, 2.0]
            finally:
                await s.close()
            assert not {h.name for h in loops.handles()} & {
                "compact-picker:db", "compact-executor:db"}

        asyncio.run(go())


class TestTtlGc:
    def test_expired_only_gc_runs_without_rewrite(self):
        async def go():
            store = MemoryObjectStore()
            cfg = from_dict(StorageConfig, {"scheduler": {
                "schedule_interval": "1h", "ttl": "1h",
                "input_sst_min_num": 5}})
            s = await CloudObjectStorage.open(
                "db", SEGMENT_MS, store, user_schema(), 2, cfg, device="cpu")
            try:
                now = now_ms()
                old = now - 3 * SEGMENT_MS  # ended long before now - ttl
                await s.write(wreq([("old", old, 1.0)]))
                await s.write(wreq([("new", now, 2.0)]))
                task = await s.compact_scheduler.picker.pick_candidate()
                assert task is not None
                assert task.inputs == [] and len(task.expireds) == 1
                await s.compact_scheduler.executor.execute(task)
                ssts = await s.manifest.all_ssts()
                assert len(ssts) == 1
                objs = sorted(m.path for m in await store.list("db/data/"))
                # the expired sst AND its sidecar are gone
                assert objs == [f"db/data/{ssts[0].id}.enc",
                                f"db/data/{ssts[0].id}.sst"]
                assert await scan_rows(s, 0, now + SEGMENT_MS) == [
                    ("new", now, 2.0)]
            finally:
                await s.close()

        asyncio.run(go())


# ---------------------------------------------------------------------------
# faults and the scrubber
# ---------------------------------------------------------------------------


class TestCompactionFaults:
    async def _setup(self, store):
        s = await open_storage(store, input_sst_min_num=2)
        # driven by hand: the background loops must not race the test
        await s.compact_scheduler.stop()
        for i in range(3):
            await s.write(wreq([("k", 1, float(i))], (1, 2)))
        return s

    def test_failed_output_put_unmarks_and_recovers(self):
        async def go():
            store = FaultStore()
            s = await self._setup(store)
            try:
                task = await s.compact_scheduler.picker.pick_candidate()
                assert task is not None
                store.fail_next("put", "/data/")
                with pytest.raises(OSError):
                    await s.compact_scheduler.executor.execute(task)
                # inputs unmarked -> re-pickable; memory accounting intact
                assert all(not f.in_compaction for f in task.inputs)
                assert s.compact_scheduler.executor.inused_memory == 0
                assert await scan_rows(s) == [("k", 1, 2.0)]
                await compact_once(s)
                assert len(await s.manifest.all_ssts()) == 1
                assert await scan_rows(s) == [("k", 1, 2.0)]
            finally:
                await s.close()

        asyncio.run(go())

    def test_failed_input_delete_is_tolerated_then_scrubbed(self):
        async def go():
            store = FaultStore()
            s = await self._setup(store)
            try:
                task = await s.compact_scheduler.picker.pick_candidate()
                store.fail_next("delete", "/data/")
                await s.compact_scheduler.executor.execute(task)  # no raise
                assert len(await s.manifest.all_ssts()) == 1
                assert await scan_rows(s) == [("k", 1, 2.0)]
                ssts = [m for m in await store.list("db/data/")
                        if m.path.endswith(".sst")]
                assert len(ssts) == 2  # 1 live + 1 leaked
                # within grace: observed, never deleted
                report = await s.scrub(grace_override_s=3600.0)
                assert report.orphans_seen >= 1
                assert report.orphans_deleted == 0
                # past grace: reclaimed; the referenced SST is intact
                report = await s.scrub(grace_override_s=0.0)
                assert report.orphans_deleted >= 1
                live_id = (await s.manifest.all_ssts())[0].id
                remaining = await store.list("db/data/")
                assert {m.path.rsplit("/", 1)[-1].split(".")[0]
                        for m in remaining} == {str(live_id)}
                assert await scan_rows(s) == [("k", 1, 2.0)]
            finally:
                await s.close()

        asyncio.run(go())

    def test_scrubber_deletes_only_orphans(self):
        async def go():
            store = MemoryObjectStore()
            s = await open_storage(store)
            try:
                await s.write(wreq([("a", 1, 1.0)]))
                await s.write(wreq([("b", 2, 2.0)]))
                live = sorted(m.path for m in await store.list("db/data/"))
                await store.put("db/data/123.sst", b"orphan")
                await store.put("db/data/123.enc", b"orphan")
                await store.put("db/data/notes.txt", b"never touched")
                report = await s.scrub(grace_override_s=0.0)
                assert report.orphans_deleted == 2
                assert report.unparseable == 1
                assert report.referenced == 2
                left = sorted(m.path for m in await store.list("db/data/"))
                assert left == sorted(live + ["db/data/notes.txt"])
                assert await scan_rows(s) == [("a", 1, 1.0), ("b", 2, 2.0)]
            finally:
                await s.close()

        asyncio.run(go())


# ---------------------------------------------------------------------------
# compaction races: the scans replan
# ---------------------------------------------------------------------------


async def _three_segments(s):
    """Segments 0 and 1 hold one SST each; segment 2 holds two, so the
    picker compacts segment 2 alone."""
    for seg in range(3):
        base = seg * SEGMENT_MS
        await s.write(wreq([("a", base + 1000, 1.0 + seg),
                            ("b", base + 2000, 2.0 + seg)]))
    await s.write(wreq([("a", 2 * SEGMENT_MS + 1000, 100.0),
                        ("c", 2 * SEGMENT_MS + 3000, 7.0)]))


def _agg_spec(which=("sum", "count")):
    return AggregateSpec(group_col="host", ts_col="ts", value_col="cpu",
                         range_start=0, bucket_ms=60_000,
                         num_buckets=3 * SEGMENT_MS // 60_000, which=which)


def _grids_np(out):
    values, grids = out
    return values, {k: (v if isinstance(v, np.ndarray) else v.cpu().numpy())
                    for k, v in grids.items()}


def test_scan_replans_after_compaction_deleted_its_ssts():
    """A plan built before a compaction reads SSTs the compaction then
    deleted: the scan replans the unfinished segments and returns the
    same rows, once each."""
    async def go():
        s = await open_storage(input_sst_min_num=2)
        try:
            await _three_segments(s)
            req = ScanRequest(range=TimeRange.new(0, 3 * SEGMENT_MS))
            want = await scan_rows(s, 0, 3 * SEGMENT_MS)
            s.reader.scan_cache.clear()
            stale = await s.build_scan_plan(req)
            assert await compact_once(s) is not None
            got = rows_of(await collect(s.scan(req, first_plan=stale)))
            assert got == want
        finally:
            await s.close()

    asyncio.run(go())


def test_fused_aggregate_restarts_on_compaction_race(monkeypatch):
    """A compaction race mid-aggregate restarts the fused path with a
    fresh plan: full, duplicate-free grids, and rows scanned counted
    once."""
    monkeypatch.setenv("HORAEDB_FUSED_AGG", "1")

    async def go():
        s = await open_storage()
        try:
            await s.write(wreq([("a", 1000, 1.0), ("a", 2000, 2.0),
                                ("b", 1000, 3.0), ("b", 2000, 4.0)],
                               (1000, 2001)))
            rows_before = read_mod._ROWS_SCANNED.value
            real = s.reader.execute_aggregate_fused
            calls = {"n": 0}

            async def flaky(plan, spec, counted=None):
                calls["n"] += 1
                if calls["n"] == 1:
                    # scan everything FIRST, then fail
                    await real(plan, spec, counted=counted)
                    raise NotFoundError("sst vanished (simulated race)")
                return await real(plan, spec, counted=counted)

            monkeypatch.setattr(s.reader, "execute_aggregate_fused", flaky)
            spec = AggregateSpec(group_col="host", ts_col="ts",
                                 value_col="cpu", range_start=0,
                                 bucket_ms=10_000, num_buckets=1,
                                 which=("sum", "count"))
            values, grids = await s.scan_aggregate(
                ScanRequest(range=TimeRange.new(0, 10_000)), spec)
            assert calls["n"] == 2
            got = {str(v): float(grids["sum"][i, 0])
                   for i, v in enumerate(values)}
            assert got == {"a": 3.0, "b": 7.0}
            assert float(grids["count"].sum()) == 4.0
            assert read_mod._ROWS_SCANNED.value - rows_before == 4
        finally:
            await s.close()

    asyncio.run(go())


@pytest.mark.parametrize("fused", ["1", "0"], ids=["fused", "parts"])
def test_aggregate_with_stale_plan_after_real_compaction(monkeypatch, fused):
    """The race for real: the plan predates a compaction of segment 2.
    The fused path restarts whole; the parts path keeps the segments it
    finished before the race and replans segment 2 alone.  Both give the
    grids of a fresh query."""
    monkeypatch.setenv("HORAEDB_FUSED_AGG", fused)

    async def go():
        cfg = from_dict(StorageConfig, {
            "scheduler": {"schedule_interval": "1h",
                          "input_sst_min_num": 2},
            # one window per round: each segment finishes on its own
            "scan": {"agg_batch_windows": 1, "prefetch_segments": 1}})
        s = await CloudObjectStorage.open(
            "db", SEGMENT_MS, MemoryObjectStore(), user_schema(), 2, cfg,
            device="cpu")
        try:
            await _three_segments(s)
            req = ScanRequest(range=TimeRange.new(0, 3 * SEGMENT_MS))
            stale = await s.build_scan_plan(req)
            assert await compact_once(s) is not None
            plans = []
            real = s.reader.aggregate_segments

            async def spy(plan, spec, top_k=None):
                plans.append([sg.segment_start for sg in plan.segments])
                async for out in real(plan, spec, top_k=top_k):
                    yield out

            monkeypatch.setattr(s.reader, "aggregate_segments", spy)
            got = _grids_np(await s.scan_aggregate(req, _agg_spec(),
                                                   first_plan=stale))
            s.reader.scan_cache.clear()
            s.reader.parts_memo.clear()
            want = _grids_np(await s.scan_aggregate(req, _agg_spec()))
            assert np.array_equal(got[0], want[0])
            for k in want[1]:
                np.testing.assert_array_equal(got[1][k], want[1][k])
            assert float(want[1]["count"].sum()) == 7.0
            if fused == "0":
                # attempt 1 finished segments 0 and 1; the replan read
                # segment 2 only (then the fresh query all three)
                assert plans[:2] == [[0, SEGMENT_MS, 2 * SEGMENT_MS],
                                     [2 * SEGMENT_MS]]
        finally:
            await s.close()

    asyncio.run(go())


def test_parts_race_skips_finished_segments(monkeypatch):
    """A simulated race after the first segment was yielded: the replan
    covers the remaining segments only, and the grids equal a fresh
    query's."""
    monkeypatch.setenv("HORAEDB_FUSED_AGG", "0")

    async def go():
        s = await open_storage()
        try:
            await _three_segments(s)
            real = s.reader.aggregate_segments
            plans = []

            async def flaky(plan, spec, top_k=None):
                plans.append([sg.segment_start for sg in plan.segments])
                async for out in real(plan, spec, top_k=top_k):
                    yield out
                    if len(plans) == 1:
                        raise NotFoundError("sst vanished (simulated race)")

            monkeypatch.setattr(s.reader, "aggregate_segments", flaky)
            req = ScanRequest(range=TimeRange.new(0, 3 * SEGMENT_MS))
            got = _grids_np(await s.scan_aggregate(req, _agg_spec(ALL_AGGS)))
            assert plans[0] == [0, SEGMENT_MS, 2 * SEGMENT_MS]
            assert plans[1] == [SEGMENT_MS, 2 * SEGMENT_MS]
            monkeypatch.setattr(s.reader, "aggregate_segments", real)
            s.reader.scan_cache.clear()
            s.reader.parts_memo.clear()
            want = _grids_np(await s.scan_aggregate(req, _agg_spec(ALL_AGGS)))
            assert np.array_equal(got[0], want[0])
            for k in want[1]:
                assert got[1][k].tobytes() == want[1][k].tobytes(), k
        finally:
            await s.close()

    asyncio.run(go())


# ---------------------------------------------------------------------------
# the engine: query results unchanged by compaction
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fused", ["1", "0"], ids=["fused", "parts"])
def test_engine_results_unchanged_by_compaction(monkeypatch, fused):
    """Overlapping writes, queried; every data segment compacted to one
    SST by the scheduler; queried again.  count/min/max/last exact and
    the parts path's sum/avg byte-equal to before; and both equal the
    JAX package's grids (sum/avg within rtol 1e-5).  The scan cache and
    the memo miss structurally after compaction."""
    monkeypatch.setenv("HORAEDB_FUSED_AGG", fused)
    cfg = from_dict(StorageConfig, {"scheduler": {
        "schedule_interval": "1h", "input_sst_min_num": 2}})

    async def run():
        ref = await RefEngine.open("t", RefStore(), segment_ms=SEG)
        e = await MetricEngine.open("t", MemoryObjectStore(), segment_ms=SEG,
                                    config=cfg, device="cpu")
        try:
            for b in _batches():
                await ref.write_arrow("cpu", ["host"], b)
                await e.write_arrow("cpu", ["host"], b)
            data = e.tables["data"]

            async def query():
                return await e.query_downsample(
                    "cpu", [], TimeRange.new(T0, END), 60_000, aggs=ALL_AGGS)

            before = await query()
            segs = lambda ssts: [segment_of(f, SEG) for f in ssts]  # noqa: E731
            s = segs(await data.manifest.all_ssts())
            compacted = {x for x in s if s.count(x) > 1}
            assert compacted
            for _ in range(20):
                await data.compact()
                await asyncio.sleep(0.05)
                s = segs(await data.manifest.all_ssts())
                if len(s) == len(set(s)):
                    break
            s = segs(await data.manifest.all_ssts())
            assert len(s) == len(set(s)), "a segment kept several SSTs"
            misses = data.reader.scan_cache.misses
            hits = data.reader.parts_memo.stats()["hits"]
            after = await query()
            assert data.reader.scan_cache.misses >= misses + len(compacted)
            # only the untouched segments can be served from the memo
            assert data.reader.parts_memo.stats()["hits"] - hits == (
                len(set(s)) - len(compacted) if fused == "0" else 0)
            assert after["tsids"] == before["tsids"]
            b_np = {k: np.asarray(v if isinstance(v, np.ndarray)
                                  else v.cpu().numpy())
                    for k, v in before["aggs"].items()}
            a_np = {k: np.asarray(v if isinstance(v, np.ndarray)
                                  else v.cpu().numpy())
                    for k, v in after["aggs"].items()}
            for k in b_np:
                if k in ("sum", "avg") and fused == "1":
                    np.testing.assert_allclose(a_np[k], b_np[k], rtol=1e-5)
                else:
                    assert a_np[k].tobytes() == b_np[k].tobytes(), k
            r = await ref.query_downsample("cpu", [], RefRange.new(T0, END),
                                           60_000, aggs=ALL_AGGS)
            _compare(r, after)
        finally:
            await ref.close()
            await e.close()

    asyncio.run(run())
