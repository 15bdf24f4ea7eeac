"""MetricEngine: the manager pipeline and the five tables (PyTorch port).

Write path (ref: metric_engine README pipeline; bodies built from RFC):
  samples -> MetricManager.populate_metric_ids
          -> IndexManager.populate_series_ids (+ index/series/tags rows)
          -> data table rows

Tables (RFC:106-137), each a CloudObjectStorage with the same segment
duration:

  metrics {metric_name, field_name | metric_id, field_id, field_type}
  series  {metric_id, tsid | series_key}
  tags    {metric_id, tag_key, tag_value | exists}
  index   {metric_id, tag_key, tag_value, tsid | exists}
  data    {metric_id, tsid, field_id, timestamp | value}

The engine runs on one torch device, chosen at open() and carried down
to the readers: "cuda" by default, and open() raises when no card is
present rather than carrying on on the CPU.  device="cpu" is for tests.

Ported: open/close (each table's compaction scheduler and scrubber
start and stop with it), the WAL front (`open(wal_config=...)` wraps
every table in wal.IngestStorage), `stats()` and `flush()`, the bulk
Arrow ingest (row layout), metric and series resolution, raw row
queries and the downsample query on the raw path, by the fused or the
parts aggregate.  Not ported yet: the scalar write path, the chunked
data layout, rollups, self-monitoring, scan agents, top-k and
multi-field queries (see ROADMAP.md).
"""

from __future__ import annotations

import asyncio
import os
from typing import Optional

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from horaedb_tpu_torch.common import runtimes as runtimes_mod
from horaedb_tpu_torch.common.error import Error, ensure
from horaedb_tpu_torch.objstore import ObjectStore
from horaedb_tpu_torch.ops.downsample import ALL_AGGS
from horaedb_tpu_torch.ops.filter import And, Eq, In, TimeRangePred
from horaedb_tpu_torch.storage.config import StorageConfig
from horaedb_tpu_torch.storage.read import AggregateSpec, ScanRequest
from horaedb_tpu_torch.storage.storage import CloudObjectStorage, WriteRequest
from horaedb_tpu_torch.storage.types import TimeRange, Timestamp
from horaedb_tpu_torch.utils import span
from horaedb_tpu_torch.wal import IngestStorage
from horaedb_tpu_torch.metric_engine.types import (
    Label,
    Sample,
    field_id_of,
    metric_id_of,
    series_key_of,
    tsid_of,
    tsids_of_keys,
)

_TABLE_SCHEMAS = {
    "metrics": (pa.schema([
        ("metric_name", pa.string()), ("field_name", pa.string()),
        ("metric_id", pa.uint64()), ("field_id", pa.uint64()),
        ("field_type", pa.int32()),
    ]), 2),
    "series": (pa.schema([
        ("metric_id", pa.uint64()), ("tsid", pa.uint64()),
        ("series_key", pa.binary()),
    ]), 2),
    "tags": (pa.schema([
        ("metric_id", pa.uint64()), ("tag_key", pa.string()),
        ("tag_value", pa.string()), ("exists", pa.int32()),
    ]), 3),
    "index": (pa.schema([
        ("metric_id", pa.uint64()), ("tag_key", pa.string()),
        ("tag_value", pa.string()), ("tsid", pa.uint64()),
        ("exists", pa.int32()),
    ]), 4),
    "data": (pa.schema([
        ("metric_id", pa.uint64()), ("tsid", pa.uint64()),
        ("field_id", pa.uint64()), ("timestamp", pa.int64()),
        ("value", pa.float64()),
    ]), 4),
}

FIELD_TYPE_FLOAT = 0
# keep per-segment registration dedup state for this many most-recently-
# USED segments (LRU)
_SEEN_SEGMENTS_KEPT = 4


def resolve_device(device):
    """The engine's torch device.  CUDA is the default; asking for it
    without a card raises — the engine never carries on on the CPU
    unless the caller asks for the CPU."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise Error("MetricEngine needs a CUDA device and none is "
                    "available; pass device='cpu' to run on the CPU")
    return dev


async def _collect(stream) -> list[pa.RecordBatch]:
    return [b async for b in stream]


def _unique_pairs(major, minor):
    """np.unique over (major, minor) int pairs, lexicographic order,
    packed into one int64 when ranges allow.  Returns (uniq_major,
    uniq_minor, first_index, inverse)."""
    maj = np.asarray(major).astype(np.int64, copy=False)
    mino = np.asarray(minor).astype(np.int64, copy=False)
    if len(maj) == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z, z, z
    mlo, nlo = int(maj.min()), int(mino.min())
    span_ = int(mino.max()) - nlo + 1
    if (int(maj.max()) - mlo + 1) * span_ < 2**62:
        packed = (maj - mlo) * np.int64(span_) + (mino - nlo)
        u, first, inv = np.unique(packed, return_index=True,
                                  return_inverse=True)
        return u // span_ + mlo, u % span_ + nlo, first, inv
    mat = np.stack([maj, mino], axis=1)
    up, first, inv = np.unique(mat, axis=0, return_index=True,
                               return_inverse=True)
    return up[:, 0], up[:, 1], first, inv.reshape(-1)


def _empty_result() -> pa.Table:
    return pa.table({"tsid": pa.array([], type=pa.uint64()),
                     "timestamp": pa.array([], type=pa.int64()),
                     "value": pa.array([], type=pa.float64())})


class _SegmentSeen:
    """Bounded (segment -> seen keys) registration cache.  Keys are added
    only AFTER the registration write succeeds, so a failed write is
    retried on the next ingest.  Eviction is LRU on read and write."""

    def __init__(self, keep: int = _SEEN_SEGMENTS_KEPT):
        from collections import OrderedDict

        self._by_segment: "OrderedDict[int, set]" = OrderedDict()
        self._keep = keep

    def __contains__(self, seg_key: tuple) -> bool:
        seg, key = seg_key
        entry = self._by_segment.get(seg)
        if entry is None:
            return False
        self._by_segment.move_to_end(seg)
        return key in entry

    def add(self, seg: int, key) -> None:
        if seg in self._by_segment:
            self._by_segment.move_to_end(seg)
        self._by_segment.setdefault(seg, set()).add(key)
        while len(self._by_segment) > self._keep:
            self._by_segment.popitem(last=False)


class MetricManager:
    """name -> MetricId resolution + metrics-table registration
    (ref: metric/mod.rs:25-50, body from RFC)."""

    def __init__(self, table: CloudObjectStorage, segment_ms: int):
        self.table = table
        self.segment_ms = segment_ms
        self._seen = _SegmentSeen()
        self._resolve_cache: dict[str, tuple[int, float]] = {}

    async def populate_metric_ids(self, samples: list[Sample]) -> None:
        by_seg: dict[int, dict] = {}
        for s in samples:
            s.name_id = metric_id_of(s.name)
            seg = int(Timestamp(s.timestamp).truncate_by(self.segment_ms))
            key = (s.name, s.field_name)
            if (seg, key) not in self._seen:
                by_seg.setdefault(seg, {})[key] = s.name_id
        for seg, items in by_seg.items():
            names = [k[0] for k in items]
            fnames = [k[1] for k in items]
            batch = pa.record_batch(
                [pa.array(names),
                 pa.array(fnames),
                 pa.array(list(items.values()), type=pa.uint64()),
                 pa.array([field_id_of(f) for f in fnames], type=pa.uint64()),
                 pa.array([FIELD_TYPE_FLOAT] * len(items), type=pa.int32())],
                schema=self.table.schema().user_schema)
            # registration rows cover the WHOLE segment so any query window
            # inside the segment finds them (Date == segment, RFC:104)
            await self.table.write(WriteRequest(
                batch, TimeRange.new(seg, seg + self.segment_ms)))
            for key in items:
                self._seen.add(seg, key)

    # positive name->id resolutions are cached briefly (the mapping is
    # immutable once registered); negatives are not cached
    _RESOLVE_TTL_S = 10.0

    async def resolve(self, metric_name: str,
                      time_range: TimeRange) -> Optional[int]:
        """metric name -> id via the metrics table (cache-through)."""
        import time as _time

        now = _time.monotonic()
        hit = self._resolve_cache.get(metric_name)
        if hit is not None and hit[1] > now:
            return hit[0]
        batches = await _collect(self.table.scan(ScanRequest(
            range=time_range, predicate=Eq("metric_name", metric_name))))
        for b in batches:
            if b.num_rows:
                mid = b.column(
                    b.schema.names.index("metric_id"))[0].as_py()
                if len(self._resolve_cache) > 1024:
                    self._resolve_cache.clear()
                self._resolve_cache[metric_name] = (
                    mid, now + self._RESOLVE_TTL_S)
                return mid
        return None


class IndexManager:
    """TSID resolution + series/tags/index registration per segment
    (ref: index/mod.rs:25-44, body from RFC:86-137)."""

    def __init__(self, series: CloudObjectStorage, tags: CloudObjectStorage,
                 index: CloudObjectStorage, segment_ms: int):
        self.series = series
        self.tags = tags
        self.index = index
        self.segment_ms = segment_ms
        self._seen = _SegmentSeen()  # (segment, tsid)

    async def populate_series_ids(self, samples: list[Sample]) -> None:
        new: dict[int, dict[int, Sample]] = {}
        for s in samples:
            ensure(s.name_id is not None, "populate_metric_ids must run first")
            s.series_id = tsid_of(s.name, s.labels)
            seg = int(Timestamp(s.timestamp).truncate_by(self.segment_ms))
            if (seg, s.series_id) not in self._seen:
                new.setdefault(seg, {})[s.series_id] = s
        for seg, by_tsid in new.items():
            await self._register(seg, list(by_tsid.values()))
            for tsid in by_tsid:
                self._seen.add(seg, tsid)

    async def _register(self, seg: int, samples: list[Sample]) -> None:
        rng = TimeRange.new(seg, seg + self.segment_ms)
        series_schema = self.series.schema().user_schema
        mids, tsids, keys = [], [], []
        t_mids, t_keys, t_vals = [], [], []
        i_mids, i_keys, i_vals, i_tsids = [], [], [], []
        for s in samples:
            mids.append(s.name_id)
            tsids.append(s.series_id)
            keys.append(series_key_of(s.name, s.labels))
            for lb in s.labels:
                t_mids.append(s.name_id)
                t_keys.append(lb.name)
                t_vals.append(lb.value)
                i_mids.append(s.name_id)
                i_keys.append(lb.name)
                i_vals.append(lb.value)
                i_tsids.append(s.series_id)
        await self.series.write(WriteRequest(pa.record_batch(
            [pa.array(mids, type=pa.uint64()), pa.array(tsids, type=pa.uint64()),
             pa.array(keys, type=pa.binary())], schema=series_schema), rng))
        if t_mids:
            ones = pa.array([1] * len(t_mids), type=pa.int32())
            await self.tags.write(WriteRequest(pa.record_batch(
                [pa.array(t_mids, type=pa.uint64()), pa.array(t_keys),
                 pa.array(t_vals), ones],
                schema=self.tags.schema().user_schema), rng))
            await self.index.write(WriteRequest(pa.record_batch(
                [pa.array(i_mids, type=pa.uint64()), pa.array(i_keys),
                 pa.array(i_vals), pa.array(i_tsids, type=pa.uint64()),
                 pa.array([1] * len(i_mids), type=pa.int32())],
                schema=self.index.schema().user_schema), rng))

    async def find_tsids(self, metric_id: int,
                         filters: list[tuple[str, str]],
                         time_range: TimeRange) -> Optional[set[int]]:
        """Inverted-index lookup: intersect TSID sets per label filter.
        Returns None when no filters were given (= all series)."""
        if not filters:
            return None
        result: Optional[set[int]] = None
        for key, value in filters:
            pred = And([Eq("metric_id", metric_id), Eq("tag_key", key),
                        Eq("tag_value", value)])
            tsids: set[int] = set()
            for b in await _collect(self.index.scan(ScanRequest(
                    range=time_range, predicate=pred))):
                col = b.column(b.schema.names.index("tsid"))
                tsids.update(col.to_pylist())
            result = tsids if result is None else (result & tsids)
            if not result:
                return set()
        return result


class MetricEngine:
    """The user-facing metric API over five storage instances."""

    def __init__(self, tables: dict[str, CloudObjectStorage], segment_ms: int,
                 device):
        self.tables = tables
        self.segment_ms = segment_ms
        self.device = device
        self.metric_manager = MetricManager(tables["metrics"], segment_ms)
        self.index_manager = IndexManager(tables["series"], tables["tags"],
                                          tables["index"], segment_ms)
        self._runtimes = None

    @classmethod
    async def open(cls, root_path: str, store: ObjectStore,
                   segment_ms: int = 2 * 3600 * 1000,
                   config: Optional[StorageConfig] = None,
                   device="cuda", wal_config=None) -> "MetricEngine":
        """Open the five tables under `root_path` on `device` ("cuda" by
        default; raises when the card is missing).  With an enabled
        `wal_config` every table is fronted by a WAL under
        `{wal_config.dir}/{table}` (wal/ingest.py): writes are acked at
        the group fsync and raw reads see the unflushed rows."""
        dev = resolve_device(device)
        cfg = config or StorageConfig()
        wal_on = wal_config is not None and wal_config.enabled
        if wal_on:
            ensure(wal_config.dir, "[wal] enabled requires wal.dir")
        # one set of worker pools shared by all five tables
        shared_runtimes = runtimes_mod.from_config(
            cfg.threads, sst_override=cfg.scan.decode_workers)
        tables = {}
        try:
            for name, (schema, num_pks) in _TABLE_SCHEMAS.items():
                table = await CloudObjectStorage.open(
                    f"{root_path}/{name}", segment_ms, store, schema,
                    num_pks, cfg, runtimes=shared_runtimes, device=dev)
                tables[name] = table
                if wal_on:
                    # every table of the row layout is Overwrite mode
                    tables[name] = await IngestStorage.open(
                        table, os.path.join(wal_config.dir, name),
                        wal_config)
        except BaseException:
            for t in tables.values():
                await t.close()
            shared_runtimes.close()
            raise
        self = cls(tables, segment_ms, dev)
        self._runtimes = shared_runtimes
        return self

    async def close(self) -> None:
        """Close the five tables: their compaction schedulers and scrub
        loops stop first, then their manifests and readers."""
        for t in self.tables.values():
            await t.close()
        if self._runtimes is not None:
            self._runtimes.close()

    async def stats(self) -> dict:
        """Data volume stored (rows, bytes and SSTs per table, from the
        manifests), each reader's cache residency and, with the WAL on,
        the buffered state: memtables and WAL backlog."""
        tables = {}
        rows = size = sst_count = 0
        mem_rows = mem_bytes = wal_backlog = 0
        last_flush_age = None
        wal_enabled = False
        for name, t in self.tables.items():
            ssts = await t.manifest.all_ssts()
            t_rows = sum(f.meta.num_rows for f in ssts)
            t_size = sum(f.meta.size for f in ssts)
            tables[name] = {"ssts": len(ssts), "rows": t_rows,
                            "bytes": t_size}
            rows += t_rows
            size += t_size
            sst_count += len(ssts)
            ingest = getattr(t, "ingest_stats", None)
            if ingest is not None:
                wal_enabled = True
                ing = ingest()
                tables[name]["ingest"] = ing
                mem_rows += ing["memtable_rows"]
                mem_bytes += ing["memtable_bytes"]
                wal_backlog += ing["wal_backlog_bytes"]
                age = ing["last_flush_age_s"]
                if age is not None and (last_flush_age is None
                                        or age > last_flush_age):
                    last_flush_age = age  # the most stale table
            tables[name]["cache"] = t.reader.cache_stats()
        caches = [v["cache"] for v in tables.values()]
        out = {"rows": rows, "bytes": size, "ssts": sst_count,
               "tables": tables,
               "cache": {
                   "scan_cache_bytes": sum(
                       c["scan_cache"]["bytes"] for c in caches),
                   **{f"encoded_cache_{k}": sum(
                       c["encoded_cache"][k] for c in caches)
                      for k in ("bytes", "entries", "hits", "misses")}}}
        if wal_enabled:
            out["memtable_rows"] = mem_rows
            out["memtable_bytes"] = mem_bytes
            out["wal_backlog_bytes"] = wal_backlog
            out["last_flush_age_s"] = last_flush_age
        return out

    async def flush(self) -> dict:
        """Drain every WAL-fronted table's memtables to SSTs.  Returns
        rows flushed per table."""
        out = {}
        for name, t in self.tables.items():
            flush_all = getattr(t, "flush_all", None)
            if flush_all is not None:
                out[name] = {"flushed_rows": await flush_all()}
        return out

    # ---- write ------------------------------------------------------------

    async def write_arrow(self, metric: str, tag_columns: list[str],
                          batch: pa.RecordBatch,
                          field: str = "value") -> None:
        """Vectorized bulk ingest: an Arrow batch with columns
        [*tag_columns, 'timestamp' int64, 'value' float64] for one metric.
        Python runs once per UNIQUE (segment, series) pair (id derivation
        and index registration); the per-row work is Arrow/numpy."""
        n = batch.num_rows
        if n == 0:
            return
        ensure("timestamp" in batch.schema.names
               and "value" in batch.schema.names,
               "write_arrow needs 'timestamp' and 'value' columns")
        for c in tag_columns:
            ensure(c in batch.schema.names,
                   f"write_arrow tag column {c!r} missing from batch")
            ensure(batch.column(batch.schema.names.index(c)).null_count == 0,
                   f"write_arrow tag column {c!r} contains nulls")
        try:
            ts_col = batch.column(
                batch.schema.names.index("timestamp")).cast(pa.int64())
            val_col = batch.column(
                batch.schema.names.index("value")).cast(pa.float64())
        except pa.ArrowInvalid as e:
            raise Error.context(
                "write_arrow timestamp/value columns must cast to "
                "int64/float64", e)
        ensure(ts_col.null_count == 0 and val_col.null_count == 0,
               "write_arrow timestamp/value columns contain nulls")

        # unique series via per-tag dictionary codes combined into one
        # composite code; products that would overflow take a row-wise
        # unique over the code matrix instead
        tag_arrays = [batch.column(batch.schema.names.index(c))
                      for c in tag_columns]
        per_tag_codes = []
        code_space = 1
        for arr in tag_arrays:
            d = pc.dictionary_encode(arr)
            d = d.combine_chunks() if isinstance(d, pa.ChunkedArray) else d
            per_tag_codes.append(np.asarray(d.indices).astype(np.int64))
            code_space *= max(1, len(d.dictionary))
        if code_space < 2**62:
            composite = np.zeros(n, dtype=np.int64)
            for c in per_tag_codes:
                card = int(c.max()) + 1 if len(c) else 1
                composite = composite * card + c
            uniq_codes, codes = np.unique(composite, return_inverse=True)
            num_series = len(uniq_codes)
        else:
            mat = np.stack(per_tag_codes, axis=1)
            uniq_rows, codes = np.unique(mat, axis=0, return_inverse=True)
            codes = codes.reshape(-1)
            num_series = len(uniq_rows)

        ts_np = ts_col.to_numpy()
        # segment assignment matches Timestamp.truncate_by (truncation
        # toward zero) so pre-epoch rows land where their registration
        # does
        seg = self.segment_ms
        q = np.where(ts_np >= 0, ts_np // seg, -((-ts_np) // seg))
        seg_ids = q * seg

        # registration per (segment, series): the index is Date-scoped
        # (RFC:104)
        _, _, pair_rows, _ = _unique_pairs(q, codes)
        reg_samples = []
        tsid_of_code = np.full(num_series, 0, dtype=np.uint64)
        mid = metric_id_of(metric)
        series_keys = []
        code_idxes = []
        for row in pair_rows:
            row = int(row)
            labels = [Label(c, str(tag_arrays[j][row].as_py()))
                      for j, c in enumerate(tag_columns)]
            series_keys.append(series_key_of(metric, labels))
            code_idxes.append(int(codes[row]))
            reg_samples.append(Sample(metric, labels, int(ts_np[row]), 0.0,
                                      field_name=field))
        tsid_of_code[code_idxes] = tsids_of_keys(series_keys)
        await self.metric_manager.populate_metric_ids(reg_samples)
        await self.index_manager.populate_series_ids(reg_samples)

        val_np = val_col.to_numpy()
        tsids = tsid_of_code[codes]
        data = self.tables["data"]
        fid = field_id_of(field)
        # per-segment SST writes overlap with bounded concurrency; a
        # TaskGroup settles every sibling before a failure propagates
        sem = asyncio.Semaphore(4)

        async def write_segment(seg_start: int) -> None:
            async with sem:
                m = seg_ids == seg_start
                seg_ts = ts_np[m]
                out = pa.record_batch(
                    [pa.array(np.full(int(m.sum()), mid, dtype=np.uint64)),
                     pa.array(tsids[m]),
                     pa.array(np.full(int(m.sum()), fid, dtype=np.uint64)),
                     pa.array(seg_ts, type=pa.int64()),
                     pa.array(val_np[m], type=pa.float64())],
                    schema=data.schema().user_schema)
                await data.write(WriteRequest(
                    out,
                    TimeRange.new(int(seg_ts.min()), int(seg_ts.max()) + 1)))

        try:
            async with asyncio.TaskGroup() as tg:
                for s in np.unique(seg_ids):
                    tg.create_task(write_segment(int(s)))
        except BaseException as eg:
            # callers catch concrete types, not an ExceptionGroup
            if hasattr(eg, "exceptions"):
                raise eg.exceptions[0]
            raise

    # ---- read -------------------------------------------------------------

    async def _data_predicate(self, metric: str,
                              filters: list[tuple[str, str]],
                              time_range: TimeRange, field: str,
                              ts_leaf: bool = True):
        """Data-table predicate for a query; None means provably empty.
        `ts_leaf=False` omits the time-range leaf: bucket-ALIGNED
        downsample queries enforce [start, end) exactly through the grid
        cut, and a predicate without the range keeps the cached windows
        and their memos range-independent."""
        mid = await self.metric_manager.resolve(metric, time_range)
        if mid is None:
            return None
        tsids = await self.index_manager.find_tsids(mid, filters, time_range)
        if tsids is not None and not tsids:
            return None
        preds = [Eq("metric_id", mid), Eq("field_id", field_id_of(field))]
        if ts_leaf:
            preds.append(TimeRangePred("timestamp", int(time_range.start),
                                       int(time_range.end)))
        if tsids is not None:
            preds.append(In("tsid", sorted(tsids)))
        return And(preds)

    async def query(self, metric: str, filters: list[tuple[str, str]],
                    time_range: TimeRange, field: str = "value") -> pa.Table:
        """Raw samples of one field of a metric matching all label
        filters, as an Arrow table (tsid, timestamp, value)."""
        with span("resolve"):
            pred = await self._data_predicate(metric, filters, time_range,
                                              field)
        if pred is None:
            return _empty_result()
        with span("scan"):
            qp = await self.tables["data"].plan_query(ScanRequest(
                range=time_range, predicate=pred))
            batches = await _collect(self.tables["data"].execute_plan(qp))
        if not batches:
            return _empty_result()
        return pa.Table.from_batches(batches).select(
            ["tsid", "timestamp", "value"])

    def _downsample_grid(self, time_range: TimeRange,
                         bucket_ms: int) -> tuple[int, bool]:
        """(num_buckets, aligned).  A bucket-ALIGNED range's grid cut IS
        the time filter, exactly — but only when the span covers at
        least one segment, where the read amplification is bounded by
        the two boundary segments."""
        span_ms = int(time_range.end) - int(time_range.start)
        ensure(span_ms < 2**31,
               f"query window of {span_ms}ms exceeds the int32 offset "
               "range (~24.8 days); split the query into smaller windows")
        num_buckets = -(-span_ms // bucket_ms)
        aligned = span_ms % bucket_ms == 0 and span_ms >= self.segment_ms
        return num_buckets, aligned

    async def _scan_downsample(self, metric: str,
                               filters: list[tuple[str, str]],
                               time_range: TimeRange, bucket_ms: int,
                               field: str, aggs: tuple,
                               top_k=None) -> dict:
        """Resolve, scan and shape a downsample: the downsample and
        top-k queries route through one QueryPlan."""
        num_buckets, aligned = self._downsample_grid(time_range, bucket_ms)
        with span("resolve"):
            pred = await self._data_predicate(metric, filters, time_range,
                                              field, ts_leaf=not aligned)
        with span("downsample"):
            if pred is None:
                return {"tsids": [], "num_buckets": num_buckets, "aggs": {}}
            spec = AggregateSpec(group_col="tsid", ts_col="timestamp",
                                 value_col="value",
                                 range_start=int(time_range.start),
                                 bucket_ms=bucket_ms,
                                 num_buckets=num_buckets, which=tuple(aggs))
            qp = await self.tables["data"].plan_query(
                ScanRequest(range=time_range, predicate=pred), spec=spec,
                top_k=top_k)
            group_values, grids = await self.tables["data"].execute_plan(qp)
        return {"tsids": [int(t) for t in group_values],
                "num_buckets": num_buckets,
                "aggs": grids if len(group_values) else {}}

    async def query_downsample(self, metric: str,
                               filters: list[tuple[str, str]],
                               time_range: TimeRange, bucket_ms: int,
                               field: str = "value",
                               aggs: tuple = ALL_AGGS,
                               use_rollup: bool = True) -> dict:
        """GROUP BY series, time(bucket) — the north-star query, executed
        as an aggregate pushdown on the engine's device.  `aggs` restricts
        which aggregates are computed (count always rides along).
        Returns {tsids, num_buckets, aggs: {agg -> (series, bucket)
        grid}} as the path that served the query gives them, as the
        reference does: the fused path's grids are tensors on the
        engine's device (except `last_ts`, a host float64 array of
        absolute ms); the parts path's (taken when the plan's rows
        exceed the scan-cache budget, storage/read.py
        fused_aggregate_ok) are the combine's host float64 arrays.
        `use_rollup` is accepted for API parity; the port has no
        rollups, so every query takes the raw path."""
        return await self._scan_downsample(metric, filters, time_range,
                                           bucket_ms, field, aggs)

    async def query_topk(self, metric: str,
                         filters: list[tuple[str, str]],
                         time_range: TimeRange, bucket_ms: int, k: int,
                         by: str = "max", largest: bool = True,
                         field: str = "value",
                         aggs: tuple = ALL_AGGS,
                         use_rollup: bool = True) -> dict:
        """Top-k series ranked by one aggregate over the window (BASELINE
        config 4's 'top-k hosts by max(cpu)' shape): the downsample
        QueryPlan with a TopK stage on top.  Rows come back best first,
        as host arrays: the parts path ranks in the combine and
        materializes only the k winners; the fused path slices its
        device grids (plan.apply_top_k).  `use_rollup` is accepted for
        API parity; the port has neither rollups nor the chunked layout,
        so every query takes the row layout's raw path."""
        from horaedb_tpu_torch.storage.plan import TopKSpec

        ensure(by in ALL_AGGS,
               f"unknown top-k aggregate {by!r}; supported: {ALL_AGGS}")
        return await self._scan_downsample(
            metric, filters, time_range, bucket_ms, field,
            tuple(sorted(set(aggs) | {by})),
            top_k=TopKSpec(k=k, by=by, largest=largest))
