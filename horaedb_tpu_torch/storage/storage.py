"""TimeMergeStorage facade (ref: src/storage/src/storage.rs).

`CloudObjectStorage` splits data into `segment_duration` time segments.
write() sorts a batch by PK, stamps builtin columns with the file id as
sequence, writes one Parquet SST plus its device-layout sidecar, and
records it in the manifest (ref: storage.rs:188-224, 306-332).  scan()
merges per segment on the host; scan_aggregate() runs the fused device
aggregate (storage/read.py).  On-disk layout matches the reference
(storage.rs:125-135) and the JAX package byte for byte:

    {root_path}/manifest/snapshot
    {root_path}/manifest/delta/{id}
    {root_path}/data/{id}.sst
    {root_path}/data/{id}.enc

The compaction scheduler, the orphan scrubber and the manifest retry
layer of the JAX package are not ported yet.
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
from horaedb_tpu_torch.objstore import ObjectStore
from horaedb_tpu_torch.storage import parquet_io, sidecar
from horaedb_tpu_torch.storage.config import StorageConfig, UpdateMode
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
        self.manifest = await Manifest.open(self.root_path, self.store,
                                            self.config.manifest,
                                            runtimes=self.runtimes)
        return self

    async def close(self) -> None:
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
                            time_range: TimeRange) -> WriteResult:
        """Write rows whose `__seq__` is already filled per row: the SST
        is sorted by (PK, __seq__) and the seqs are preserved."""
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
        return await self._persist_stamped(file_id, stamped, time_range)

    async def _persist_stamped(self, file_id: int, stamped: pa.RecordBatch,
                               time_range: TimeRange) -> WriteResult:
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
        meta = FileMeta(max_sequence=file_id, num_rows=stamped.num_rows,
                        size=size, time_range=time_range)
        await self.manifest.add_file(file_id, meta)
        _ROWS_WRITTEN.inc(stamped.num_rows)
        return WriteResult(id=file_id, seq=file_id, size=size)

    async def _write_sidecar(self, file_id: int,
                             stamped: pa.RecordBatch) -> None:
        """Best-effort device-layout sidecar next to the SST (see
        storage/sidecar.py): a pure cache — any failure is logged and
        swallowed, reads then decode the parquet."""
        if (self._schema.update_mode is not UpdateMode.OVERWRITE
                or not self.config.write.enable_sidecar
                or stamped.num_rows > self.config.write.sidecar_max_rows):
            return
        try:
            data = await self.runtimes.run("sst", sidecar.build, stamped)
            if data is None:
                return
            await self.store.put(
                sidecar.sidecar_path(self.root_path, file_id), data)
        except Exception as exc:  # noqa: BLE001 — cache write only
            logger.warning("sidecar write failed for sst %s: %s",
                           file_id, exc)

    async def scan(self, req: ScanRequest,
                   first_plan: Optional[ScanPlan] = None,
                   keep_builtin: bool = False
                   ) -> AsyncIterator[pa.RecordBatch]:
        plan = first_plan if first_plan is not None \
            else await self.build_scan_plan(req, keep_builtin=keep_builtin)
        batches = self.reader.execute(plan)
        try:
            async for batch in batches:
                yield batch
        finally:
            await batches.aclose()

    async def scan_aggregate(self, req: ScanRequest, spec,
                             first_plan: Optional[ScanPlan] = None):
        """Downsample pushdown: merge + GROUP BY group_col, time(bucket)
        with the fused device aggregate; returns (group_values, grids).
        See read.AggregateSpec."""
        plan = first_plan if first_plan is not None \
            else await self.build_scan_plan(req)
        return await self.reader.execute_aggregate_fused(plan, spec)

    async def build_scan_plan(self, req: ScanRequest,
                              keep_builtin: bool = False) -> ScanPlan:
        ensure(self.manifest is not None, "storage not opened")
        ssts = await self.manifest.find_ssts(req.range)
        return self.reader.build_plan(ssts, req, keep_builtin=keep_builtin)

    async def plan_query(self, req: ScanRequest, spec=None):
        """Build the QueryPlan every query shape routes through (see
        storage/plan.py): scan -> aggregate?."""
        from horaedb_tpu_torch.storage.plan import QueryPlan

        scan = await self.build_scan_plan(req)
        return QueryPlan(scan=scan, request=req, aggregate=spec)

    def execute_plan(self, qp):
        """Row-scan plans return the async batch iterator; aggregate
        plans an awaitable of (group_values, grids)."""
        if qp.aggregate is None:
            return self.scan(qp.request, first_plan=qp.scan)
        return self.scan_aggregate(qp.request, qp.aggregate,
                                   first_plan=qp.scan)
