"""TimeMergeStorage facade (ref: src/storage/src/storage.rs).

`CloudObjectStorage` splits data into `segment_duration` time segments.
write() sorts a batch by PK, stamps builtin columns with the file id as
sequence, writes one Parquet SST plus its device-layout sidecar, and
records it in the manifest (ref: storage.rs:188-224, 306-332).  scan()
merges per segment on the host; scan_aggregate() runs the fused or the
parts aggregate (storage/read.py).  Both replan when a compaction
deletes an SST under them.  open() starts the compaction scheduler and
the orphan scrubber's loop (storage/compaction.py, storage/gc.py);
close() stops them.  On-disk layout matches the reference
(storage.rs:125-135) and the JAX package byte for byte:

    {root_path}/manifest/snapshot
    {root_path}/manifest/delta/{id}
    {root_path}/data/{id}.sst
    {root_path}/data/{id}.enc

The manifest plane reads and writes through `RetryingObjectStore`
([retry]); the data plane stays single-shot.
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass
from typing import AsyncIterator, Optional

import pyarrow as pa
import pyarrow.compute as pc

from horaedb_tpu_torch.common import runtimes as runtimes_mod
from horaedb_tpu_torch.common.error import ensure
from horaedb_tpu_torch.objstore import (NotFoundError, ObjectStore,
                                       RetryingObjectStore, RetryPolicy)
from horaedb_tpu_torch.storage import parquet_io, sidecar
from horaedb_tpu_torch.storage.config import StorageConfig, UpdateMode
from horaedb_tpu_torch.storage.gc import Scrubber, ScrubReport
from horaedb_tpu_torch.storage.manifest import Manifest
from horaedb_tpu_torch.storage.read import ParquetReader, ScanPlan, ScanRequest
from horaedb_tpu_torch.storage.sst import FileMeta, SstFile, sst_path
from horaedb_tpu_torch.storage.types import StorageSchema, TimeRange, Timestamp
from horaedb_tpu_torch.utils import registry

logger = logging.getLogger(__name__)

_WRITE_LATENCY = registry.histogram(
    "storage_write_seconds", "write path latency")
_ROWS_WRITTEN = registry.counter(
    "storage_rows_written_total", "rows written")


@dataclass
class WriteRequest:
    """(ref: storage.rs:58-63)"""

    batch: pa.RecordBatch  # user schema (no builtin columns)
    time_range: TimeRange
    # When false, the caller guarantees the batch does not cross a
    # segment boundary.
    enable_check: bool = True


@dataclass
class WriteResult:
    id: int
    seq: int
    size: int


class CloudObjectStorage:
    def __init__(self, root_path: str, segment_duration_ms: int,
                 store: ObjectStore, user_schema: pa.Schema,
                 num_primary_keys: int, config: Optional[StorageConfig] = None,
                 runtimes=None, device="cuda"):
        config = config or StorageConfig()
        self.root_path = root_path.rstrip("/")
        self.segment_duration_ms = segment_duration_ms
        self.store = store
        self.config = config
        self._schema = StorageSchema.try_new(user_schema, num_primary_keys,
                                             config.update_mode)
        self.manifest: Optional[Manifest] = None
        self.scrubber: Optional[Scrubber] = None
        self.compact_scheduler = None  # populated by open()
        # dedicated worker pools (ref: StorageRuntimes, storage.rs:91-104);
        # shared when a parent (e.g. MetricEngine) passes its own
        self._own_runtimes = runtimes is None
        self.runtimes = runtimes or runtimes_mod.from_config(
            config.threads, sst_override=config.scan.decode_workers)
        self.reader = ParquetReader(store, self.root_path, self._schema,
                                    config, segment_duration_ms,
                                    runtimes=self.runtimes, device=device)

    @classmethod
    async def open(cls, *args, **kwargs) -> "CloudObjectStorage":
        self = cls(*args, **kwargs)
        # the manifest plane gets the engine's ONE retry layer: a single
        # transient store error must not fail an otherwise-healthy
        # acknowledged write.  The data plane stays single-shot — SST
        # put failures surface to the write path's rollback discipline
        manifest_store: ObjectStore = self.store
        rc = self.config.retry
        if rc.enabled:
            manifest_store = RetryingObjectStore(self.store, RetryPolicy(
                max_retries=rc.max_retries,
                base_backoff_s=rc.base_backoff.seconds,
                max_backoff_s=rc.max_backoff.seconds,
                op_deadline_s=(rc.op_deadline.seconds
                               if rc.op_deadline else None),
                budget=float(rc.budget),
                budget_refill_per_s=rc.budget_refill_per_s))
        self.manifest = await Manifest.open(self.root_path, manifest_store,
                                            self.config.manifest,
                                            runtimes=self.runtimes)
        # the scrubber reconciles against the RAW store: its deletes are
        # already a retry loop (next pass)
        self.scrubber = Scrubber(self.root_path, self.store, self.manifest,
                                 self.config.scrub.grace_period.seconds)
        self.reader.resolve_segment_ssts = self._segment_ssts_now
        from horaedb_tpu_torch.storage.compaction import Scheduler

        self.compact_scheduler = Scheduler(self)
        await self.compact_scheduler.start()
        return self

    async def scrub(self, grace_override_s: Optional[float] = None
                    ) -> ScrubReport:
        """One orphan-reconcile pass (see storage/gc.py)."""
        ensure(self.scrubber is not None, "storage not opened")
        return await self.scrubber.scrub(grace_override_s=grace_override_s)

    async def _segment_ssts_now(self, segment_start: int,
                                scan_range: Optional[TimeRange]):
        """CURRENT SSTs of one segment that overlap the scan's range: a
        streamed segment uses this to survive a compaction race
        mid-segment (read.py).  The range filter mirrors
        build_scan_plan's manifest.find_ssts, so recovery cannot leak
        rows from SSTs the original plan excluded."""
        from horaedb_tpu_torch.storage.sst import segment_of

        ssts = await self.manifest.all_ssts()
        return [f for f in ssts
                if segment_of(f, self.segment_duration_ms) == segment_start
                and (scan_range is None
                     or f.meta.time_range.overlaps(scan_range))]

    async def compact(self) -> None:
        """Wake the compaction picker now (it also runs every
        scheduler.schedule_interval)."""
        if self.compact_scheduler is not None:
            await self.compact_scheduler.trigger()

    async def close(self) -> None:
        if self.compact_scheduler is not None:
            await self.compact_scheduler.stop()
        if self.manifest is not None:
            await self.manifest.close()
        self.reader.close()
        if self._own_runtimes:
            self.runtimes.close()

    def schema(self) -> StorageSchema:
        return self._schema

    def _sort_batch(self, batch: pa.RecordBatch) -> pa.RecordBatch:
        """Sort by primary keys ascending (ref: storage.rs:243-255)."""
        keys = [(n, "ascending") for n in self._schema.primary_key_names]
        return batch.take(pc.sort_indices(batch, sort_keys=keys))

    def validate_write(self, req: WriteRequest) -> None:
        ensure(self.manifest is not None, "storage not opened")
        ensure(req.batch.schema.equals(self._schema.user_schema),
               "write batch schema mismatch")
        # the scan path carries no null mask: reject nulls at write time
        for name, col in zip(req.batch.schema.names, req.batch.columns):
            ensure(col.null_count == 0,
                   f"write batch column {name!r} contains nulls")
        if req.enable_check:
            start_seg = req.time_range.start.truncate_by(
                self.segment_duration_ms)
            end_seg = Timestamp(int(req.time_range.end) - 1).truncate_by(
                self.segment_duration_ms)
            ensure(start_seg == end_seg,
                   f"write batch crosses segment boundary: {req.time_range}")

    async def write(self, req: WriteRequest) -> WriteResult:
        self.validate_write(req)
        t0 = time.perf_counter()
        file_id = SstFile.allocate_id()

        def prep():  # sort + builtin stamping are CPU work — off the loop
            return self._schema.fill_builtin_columns(
                self._sort_batch(req.batch), sequence=file_id)

        stamped = await self.runtimes.run("sst", prep)
        result = await self._persist_stamped(file_id, stamped,
                                             req.time_range)
        _WRITE_LATENCY.observe(time.perf_counter() - t0)
        return result

    async def write_stamped(self, table: pa.Table,
                            time_range: TimeRange,
                            pre_commit=None) -> WriteResult:
        """Write rows whose `__seq__` is already filled per row (the WAL
        flush, wal/ingest.py): the SST is sorted by (PK, __seq__) and
        the seqs are preserved, so a flush racing a newer write cannot
        lift old rows above it.

        `pre_commit` (an async callable) runs after the SST and sidecar
        puts and just before the manifest add: a raise there leaves an
        orphan SST object but no manifest entry, invisible to readers."""
        ensure(self.manifest is not None, "storage not opened")
        ensure(table.schema.names == self._schema.arrow_schema.names,
               "write_stamped expects the full stamped schema")
        file_id = SstFile.allocate_id()

        def prep():
            keys = [(n, "ascending") for n in self._schema.primary_key_names]
            keys.append((self._schema.arrow_schema.names[self._schema.seq_idx],
                         "ascending"))
            ordered = table.take(pc.sort_indices(table, sort_keys=keys))
            return ordered.combine_chunks().to_batches()[0]

        stamped = await self.runtimes.run("sst", prep)
        return await self._persist_stamped(file_id, stamped, time_range,
                                           pre_commit=pre_commit)

    async def _persist_stamped(self, file_id: int, stamped: pa.RecordBatch,
                               time_range: TimeRange,
                               pre_commit=None) -> WriteResult:
        """SST put overlapped with the sidecar put, both complete BEFORE
        the manifest add — readers never see a manifest-listed SST whose
        sidecar is still in flight, so a sidecar miss is permanent per
        id.  max_sequence tracks the file id."""
        path = sst_path(self.root_path, file_id)
        size, _ = await asyncio.gather(
            parquet_io.write_sst(self.store, path, [stamped],
                                 self.config.write, self._schema,
                                 runtimes=self.runtimes),
            self._write_sidecar(file_id, stamped))
        if pre_commit is not None:
            await pre_commit()
        meta = FileMeta(max_sequence=file_id, num_rows=stamped.num_rows,
                        size=size, time_range=time_range)
        await self.manifest.add_file(file_id, meta)
        _ROWS_WRITTEN.inc(stamped.num_rows)
        return WriteResult(id=file_id, seq=file_id, size=size)

    async def _write_sidecar(self, file_id: int,
                             stamped: pa.RecordBatch) -> None:
        """Best-effort device-layout sidecar next to the SST (see
        storage/sidecar.py): a pure cache — any failure is logged and
        swallowed, reads then decode the parquet.  The freshly encoded
        columns are admitted into the reader's tier-2 cache
        (storage/encoded_cache.py, write-through): the direct write path
        and the WAL flusher both land here (_persist_stamped), so a
        query right after a write or a flush reads nothing from the
        store."""
        if (self._schema.update_mode is not UpdateMode.OVERWRITE
                or not self.config.write.enable_sidecar
                or stamped.num_rows > self.config.write.sidecar_max_rows):
            return
        try:
            def build():
                cols = sidecar.encode_columns(stamped)
                if cols is None:
                    return None, None
                return cols, sidecar.serialize(cols, stamped.num_rows)

            cols, data = await self.runtimes.run("sst", build)
            if data is None:
                return
            # admit BEFORE the put: the entry is valid the instant the
            # columns exist (ids are immutable), and the SST becomes
            # visible to readers only after the manifest add
            self.reader.encoded_cache.admit(file_id, cols, stamped.num_rows)
            await self.store.put(
                sidecar.sidecar_path(self.root_path, file_id), data)
        except Exception as exc:  # noqa: BLE001 — cache write only
            logger.warning("sidecar write failed for sst %s: %s",
                           file_id, exc)

    # Scans race with compaction: the manifest can reference an SST that
    # compaction deletes before the scan's read runs.  The data lives on
    # in the compacted output, so the remedy is a fresh plan for the
    # not-yet-finished segments (bounded retries).
    _SCAN_RETRIES = 3

    async def scan(self, req: ScanRequest,
                   first_plan: Optional[ScanPlan] = None,
                   keep_builtin: bool = False,
                   segment_filter=None) -> AsyncIterator[pa.RecordBatch]:
        seg_iter = self.scan_segments(req, first_plan=first_plan,
                                      keep_builtin=keep_builtin,
                                      segment_filter=segment_filter)
        try:
            async for _seg, batch in seg_iter:
                if batch is not None:
                    yield batch
        finally:
            await seg_iter.aclose()

    async def scan_segments(self, req: ScanRequest,
                            first_plan: Optional[ScanPlan] = None,
                            keep_builtin: bool = False,
                            segment_filter=None):
        """scan() with segment attribution: yields (segment_start,
        batch) parts plus a (segment_start, None) completion marker per
        segment (the hybrid WAL scan overlays memtable rows per
        segment).  On a compaction race (NotFoundError) it replans and
        skips the segments already completed.  `segment_filter(
        segment_start) -> bool` restricts every attempt to one stable
        subset of segments."""
        done: set[int] = set()
        for attempt in range(self._SCAN_RETRIES + 1):
            # attempt 0 may reuse a caller-built plan (plan_query)
            plan = (first_plan if attempt == 0 and first_plan is not None
                    else await self.build_scan_plan(
                        req, keep_builtin=keep_builtin))
            plan.segments = [s for s in plan.segments
                             if s.segment_start not in done
                             and (segment_filter is None
                                  or segment_filter(s.segment_start))]
            exec_iter = self.reader.execute_segments(plan)
            try:
                async for seg_start, batch in exec_iter:
                    if batch is None:
                        # only now is the segment retry-safe to skip
                        done.add(seg_start)
                    yield seg_start, batch
                return
            except NotFoundError:
                if attempt == self._SCAN_RETRIES:
                    raise
                logger.info("scan raced a compaction (sst vanished); "
                            "replanning remaining segments")
            finally:
                await exec_iter.aclose()

    async def scan_aggregate(self, req: ScanRequest, spec,
                             first_plan: Optional[ScanPlan] = None,
                             top_k=None):
        """Downsample pushdown: merge + GROUP BY group_col, time(bucket);
        returns (group_values, grids).  See read.AggregateSpec and
        read.ParquetReader.execute_aggregate for the two paths.  On a
        compaction race the fused path restarts whole; the parts path
        skips the segments it finished before the race.

        `top_k` (a plan.TopKSpec) pushes the ranking into the combine on
        the parts path: it folds per-group spans into a bounded score
        pass and materializes only the k winners (combine_top_k).  The
        fused path's grids already live on the device, so it slices them
        with plan.apply_top_k.

        A first plan with `parts_route` set keeps the scan on the parts
        path, replans included (the rollup manager's recomputes;
        read.ScanPlan.parts_route)."""
        if first_plan is None:
            first_plan = await self.build_scan_plan(req)
        parts_route = first_plan.parts_route
        # a plan the near-data router covers takes the parts path: the
        # fused accumulator needs every segment's windows host-resident
        if (self.reader.fused_aggregate_ok(first_plan)
                and not self.reader.router_covers(first_plan)):
            from horaedb_tpu_torch.storage.plan import apply_top_k

            counted: set = set()  # rows scanned count once per query
            plan = first_plan
            for attempt in range(self._SCAN_RETRIES + 1):
                try:
                    values, grids = \
                        await self.reader.execute_aggregate_fused(
                            plan, spec, counted=counted)
                    if top_k is not None:
                        values, grids = apply_top_k(values, grids, top_k)
                    return values, grids
                except NotFoundError:
                    if attempt == self._SCAN_RETRIES:
                        raise
                    logger.info("fused aggregate raced a compaction; "
                                "restarting")
                    plan = await self.build_scan_plan(req)
        done: dict[int, list] = {}
        for attempt in range(self._SCAN_RETRIES + 1):
            # attempt 0 reuses the plan built for the fused gate
            plan = first_plan if attempt == 0 \
                else await self.build_scan_plan(req,
                                                parts_route=parts_route)
            plan.segments = [s for s in plan.segments
                             if s.segment_start not in done]
            try:
                async for seg_start, parts in \
                        self.reader.aggregate_segments(plan, spec,
                                                       top_k=top_k):
                    done[seg_start] = parts
                break
            except NotFoundError:
                if attempt == self._SCAN_RETRIES:
                    raise
                logger.info("aggregate scan raced a compaction; "
                            "replanning")
        all_parts = [p for seg in sorted(done) for p in done[seg]]
        return self.reader.finalize_aggregate(all_parts, spec, top_k=top_k)

    async def build_scan_plan(self, req: ScanRequest,
                              keep_builtin: bool = False,
                              parts_route: bool = False) -> ScanPlan:
        ensure(self.manifest is not None, "storage not opened")
        ssts = await self.manifest.find_ssts(req.range)
        plan = self.reader.build_plan(ssts, req, keep_builtin=keep_builtin)
        plan.parts_route = parts_route
        return plan

    async def plan_query(self, req: ScanRequest, spec=None, top_k=None,
                         parts_route: bool = False):
        """Build the QueryPlan every query shape routes through (see
        storage/plan.py): scan -> aggregate? -> top_k?.  `parts_route`
        keeps the aggregate on the parts path (ScanPlan.parts_route)."""
        from horaedb_tpu_torch.storage.plan import QueryPlan

        ensure(spec is not None or top_k is None,
               "top-k requires an aggregate stage")
        scan = await self.build_scan_plan(req, parts_route=parts_route)
        return QueryPlan(scan=scan, request=req, aggregate=spec,
                         top_k=top_k)

    def execute_plan(self, qp):
        """Row-scan plans return the async batch iterator; aggregate
        plans an awaitable of (group_values, grids).  A top-k stage is
        pushed down into the combine (scan_aggregate top_k=)."""
        if qp.aggregate is None:
            return self.scan(qp.request, first_plan=qp.scan)
        return self.scan_aggregate(qp.request, qp.aggregate,
                                   first_plan=qp.scan, top_k=qp.top_k)
