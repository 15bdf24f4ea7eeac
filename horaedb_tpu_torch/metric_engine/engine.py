"""MetricEngine: the manager pipeline and the five tables (PyTorch port).

Write path (ref: metric_engine README pipeline; bodies built from RFC):
  samples -> MetricManager.populate_metric_ids
          -> IndexManager.populate_series_ids (+ index/series/tags rows)
          -> SampleManager.persist (data table rows)

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

The chunked data layout (`open(chunked_data=True)`, RFC:218-231): the
data table holds one row per (series, field, chunk window) whose
payload is a batch-encoded run of (ts, value) pairs
(metric_engine/chunks.py), in Append mode, so the BytesMerge operator
concatenates same-key payloads across files.  A chunked downsample
decodes the payloads in one host-library call and aggregates the whole
range in ONE ops.downsample.time_bucket_aggregate call on the engine's
device, behind a byte-budgeted decode cache.

Standing rollups (`open(rollup_config=...)`, rollup/manager.py): a
covered downsample or top-k query is served from pre-aggregated tier
cells plus a raw tail of the not-yet-rolled segments.

Ported: open/close (each table's compaction scheduler and scrubber
start and stop with it), the WAL front (`open(wal_config=...)` wraps
every Overwrite table in wal.IngestStorage), `stats()` and `flush()`,
the scalar `write()` and the bulk Arrow ingest (both layouts), metric
and series resolution, raw row queries, the downsample, multi-field
and top-k queries, rollups, the label/list APIs, and near-data scan
routing (`open(scanagent_config=...)`: the data table's aggregate scans
send covered segments to their scan agents, scanagent/client.py), and
self-monitoring (`open(meta_config=...)`: metric_engine/meta.py scrapes
the process's metrics registry into a `__meta` metric through this
engine's own write path).
"""

from __future__ import annotations

import asyncio
import logging
import os
from typing import Optional

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from horaedb_tpu_torch.common import runtimes as runtimes_mod
from horaedb_tpu_torch.common.error import Error, ensure
from horaedb_tpu_torch.common.memledger import ledger as memledger
from horaedb_tpu_torch.objstore import ObjectStore
from horaedb_tpu_torch.ops.downsample import ALL_AGGS
from horaedb_tpu_torch.ops.filter import And, Eq, In, TimeRangePred
from horaedb_tpu_torch.storage.config import StorageConfig
from horaedb_tpu_torch.storage.read import AggregateSpec, ScanRequest
from horaedb_tpu_torch.storage.storage import CloudObjectStorage, WriteRequest
from horaedb_tpu_torch.storage.types import TimeRange, Timestamp
from horaedb_tpu_torch.utils import registry, span
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

logger = logging.getLogger(__name__)

# chunked data table (RFC:218-231): (ts, value) pairs batch-encoded into
# opaque payloads, one row per (series, field, chunk window); Append mode
# so the BytesMerge path concatenates same-key payloads across files
_CHUNKED_DATA_SCHEMA = (pa.schema([
    ("metric_id", pa.uint64()), ("tsid", pa.uint64()),
    ("field_id", pa.uint64()), ("chunk_ts", pa.int64()),
    ("payload", pa.binary()),
]), 4)

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

    async def list_metrics(self, time_range: TimeRange) -> list[str]:
        """Distinct metric names active in the window."""
        names: set[str] = set()
        for b in await _collect(self.table.scan(ScanRequest(
                range=time_range))):
            col = b.column(b.schema.names.index("metric_name"))
            names.update(col.to_pylist())
        return sorted(names)

    async def list_fields(self, metric_name: str,
                          time_range: TimeRange) -> list[str]:
        """Distinct field names registered for a metric in the window."""
        fields: set[str] = set()
        for b in await _collect(self.table.scan(ScanRequest(
                range=time_range,
                predicate=Eq("metric_name", metric_name)))):
            col = b.column(b.schema.names.index("field_name"))
            fields.update(col.to_pylist())
        return sorted(fields)


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

    async def label_values(self, metric_id: int, tag_key: str,
                           time_range: TimeRange) -> list[str]:
        """Distinct values of one tag key (the tags table serves
        LabelValues, RFC:106-137)."""
        vals: set[str] = set()
        for b in await _collect(self.tags.scan(ScanRequest(
                range=time_range,
                predicate=And([Eq("metric_id", metric_id),
                               Eq("tag_key", tag_key)])))):
            col = b.column(b.schema.names.index("tag_value"))
            vals.update(col.to_pylist())
        return sorted(vals)

    async def label_names(self, metric_id: int,
                          time_range: TimeRange) -> list[str]:
        """Distinct tag keys of a metric in the window."""
        keys: set[str] = set()
        for b in await _collect(self.tags.scan(ScanRequest(
                range=time_range, predicate=Eq("metric_id", metric_id)))):
            col = b.column(b.schema.names.index("tag_key"))
            keys.update(col.to_pylist())
        return sorted(keys)

    async def resolve_series_keys(self, metric_id: int, tsids: list[int],
                                  time_range: TimeRange) -> dict[int, bytes]:
        pred = (And([Eq("metric_id", metric_id), In("tsid", tsids)])
                if tsids else Eq("metric_id", metric_id))
        out: dict[int, bytes] = {}
        for b in await _collect(self.series.scan(ScanRequest(
                range=time_range, predicate=pred))):
            t = b.column(b.schema.names.index("tsid")).to_pylist()
            k = b.column(b.schema.names.index("series_key")).to_pylist()
            out.update(zip(t, k))
        return out


class SampleManager:
    """Data-table persistence (ref: data/mod.rs:25-44, body from RFC)."""

    def __init__(self, table: CloudObjectStorage, segment_ms: int):
        self.table = table
        self.segment_ms = segment_ms

    async def persist_chunked(self, samples: list[Sample],
                              chunk_window_ms: int) -> None:
        """Opaque-chunk layout: one row per (series, field, chunk window)
        holding the encoded (ts, value) payload (RFC:218-231)."""
        from horaedb_tpu_torch.metric_engine import chunks

        groups: dict[tuple, list[Sample]] = {}
        for s in samples:
            ensure(s.series_id is not None,
                   "populate_series_ids must run first")
            # truncation toward zero breaks the window-containment
            # invariant for pre-epoch times: rejected explicitly
            ensure(s.timestamp >= 0,
                   "chunked data mode requires non-negative timestamps")
            chunk_ts = int(Timestamp(s.timestamp).truncate_by(
                chunk_window_ms))
            groups.setdefault(
                (s.name_id, s.series_id, field_id_of(s.field_name),
                 chunk_ts), []).append(s)

        by_seg: dict[int, list[tuple]] = {}
        for key, grp in groups.items():
            seg = int(Timestamp(key[3]).truncate_by(self.segment_ms))
            payload = chunks.encode_chunk(
                np.asarray([s.timestamp for s in grp], dtype=np.int64),
                np.asarray([s.value for s in grp], dtype=np.float64))
            by_seg.setdefault(seg, []).append((*key, payload))
        for seg, rows in sorted(by_seg.items()):
            # the file covers its chunk WINDOWS in full, so any query
            # range overlapping a window finds the file
            lo = min(r[3] for r in rows)
            hi = max(r[3] for r in rows) + chunk_window_ms
            batch = pa.record_batch(
                [pa.array([r[0] for r in rows], type=pa.uint64()),
                 pa.array([r[1] for r in rows], type=pa.uint64()),
                 pa.array([r[2] for r in rows], type=pa.uint64()),
                 pa.array([r[3] for r in rows], type=pa.int64()),
                 pa.array([r[4] for r in rows], type=pa.binary())],
                schema=self.table.schema().user_schema)
            await self.table.write(WriteRequest(
                batch, TimeRange.new(lo, hi)))

    async def persist(self, samples: list[Sample]) -> None:
        by_seg: dict[int, list[Sample]] = {}
        for s in samples:
            ensure(s.series_id is not None,
                   "populate_series_ids must run first")
            seg = int(Timestamp(s.timestamp).truncate_by(self.segment_ms))
            by_seg.setdefault(seg, []).append(s)
        for seg, seg_samples in sorted(by_seg.items()):
            lo = min(s.timestamp for s in seg_samples)
            hi = max(s.timestamp for s in seg_samples)
            batch = pa.record_batch(
                [pa.array([s.name_id for s in seg_samples],
                          type=pa.uint64()),
                 pa.array([s.series_id for s in seg_samples],
                          type=pa.uint64()),
                 pa.array([field_id_of(s.field_name) for s in seg_samples],
                          type=pa.uint64()),
                 pa.array([s.timestamp for s in seg_samples],
                          type=pa.int64()),
                 pa.array([s.value for s in seg_samples],
                          type=pa.float64())],
                schema=self.table.schema().user_schema)
            await self.table.write(WriteRequest(
                batch, TimeRange.new(lo, hi + 1)))


_CHUNK_CACHE_HITS = registry.counter(
    "chunk_decode_cache_hits_total",
    "chunked-layout decode cache hits (the chunked scan cache)")
_CHUNK_CACHE_MISSES = registry.counter(
    "chunk_decode_cache_misses_total",
    "chunked-layout decode cache misses")
_CHUNK_CACHE_EVICTIONS = registry.counter(
    "chunk_decode_cache_evictions_total",
    "chunked-layout decode cache evictions")


class MetricEngine:
    """The user-facing metric API over five storage instances.

    chunked_data=True switches the data table to the RFC's opaque-chunk
    layout: (ts, value) pairs batch-encoded per (series, field, chunk
    window) with Append/BytesMerge semantics (RFC:218-231)."""

    def __init__(self, tables: dict[str, CloudObjectStorage], segment_ms: int,
                 device, chunked_data: bool = False,
                 chunk_window_ms: int = 30 * 60 * 1000):
        self.tables = tables
        self.segment_ms = segment_ms
        self.device = device
        self.chunked_data = chunked_data
        self.chunk_window_ms = chunk_window_ms
        self.metric_manager = MetricManager(tables["metrics"], segment_ms)
        self.index_manager = IndexManager(tables["series"], tables["tags"],
                                          tables["index"], segment_ms)
        self.sample_manager = SampleManager(tables["data"], segment_ms)
        # standing rollup tiers (rollup/manager.py); populated by open()
        # when a [rollup] config enables them
        self.rollups = None
        # self-monitoring meta-ingest (metric_engine/meta.py); populated
        # by open() when a [meta] config enables it
        self.meta = None
        self._runtimes = None
        # chunked layout: the Append-mode data table bypasses the
        # reader's scan cache (host merge, uncached), so decoded sample
        # arrays get their own byte-budgeted LRU — keyed by (predicate,
        # exact range, SST-id set), so any write or compaction misses
        # it structurally.  Budget: the data table's scan-cache bytes,
        # which chunked mode otherwise leaves unused.
        if chunked_data:
            from horaedb_tpu_torch.storage.scan_cache import ByteLRU

            self._chunk_cache = ByteLRU(
                tables["data"].reader.cache_budget_bytes,
                hits=_CHUNK_CACHE_HITS, misses=_CHUNK_CACHE_MISSES,
                evictions=_CHUNK_CACHE_EVICTIONS, trace_tier="chunk")
            # memory plane: the chunked engine's decoded-sample LRU is
            # a byte budget like any reader cache
            self._chunk_mem_account = memledger.register(
                "chunk_cache:engine",
                lambda e: e._chunk_cache.total_bytes, anchor=self,
                kind="chunk_cache",
                budget=tables["data"].reader.cache_budget_bytes,
                owner="metric_engine")
        else:
            self._chunk_cache = None
            self._chunk_mem_account = None
        self._scanagent_client = None

    @classmethod
    async def open(cls, root_path: str, store: ObjectStore,
                   segment_ms: int = 2 * 3600 * 1000,
                   config: Optional[StorageConfig] = None,
                   device="cuda", wal_config=None,
                   chunked_data: bool = False,
                   chunk_window_ms: int = 30 * 60 * 1000,
                   rollup_config=None,
                   scanagent_config=None,
                   meta_config=None) -> "MetricEngine":
        """Open the five tables under `root_path` on `device` ("cuda" by
        default; raises when the card is missing).  With an enabled
        `wal_config` every Overwrite table is fronted by a WAL under
        `{wal_config.dir}/{table}` (wal/ingest.py): writes are acked at
        the group fsync and raw reads see the unflushed rows.
        `chunked_data` selects the chunked data layout (Append data
        table, no WAL in front of it); an enabled `rollup_config` opens
        the rollup tiers (row layout only); an active `scanagent_config`
        routes the data table's aggregate scans through its scan agents
        (row layout only); an enabled `meta_config` starts the
        meta-ingest scrape loop."""
        import dataclasses

        if chunked_data:
            ensure(chunk_window_ms <= segment_ms
                   and segment_ms % chunk_window_ms == 0,
                   "chunk window must evenly divide the segment duration")
        # argument-only check, before any table or pool opens: the
        # rollup maintenance and serve contract mirrors the row layout's
        # downsample pushdown; the chunked (Append) layout has none
        if rollup_config is not None and rollup_config.enabled:
            ensure(not chunked_data,
                   "[rollup] requires the row data layout "
                   "(chunked_data = false)")
        dev = resolve_device(device)
        cfg = config or StorageConfig()
        wal_on = wal_config is not None and wal_config.enabled
        if wal_on:
            ensure(wal_config.dir, "[wal] enabled requires wal.dir")
        schemas = dict(_TABLE_SCHEMAS)
        if chunked_data:
            schemas["data"] = _CHUNKED_DATA_SCHEMA
        # one set of worker pools shared by all five tables
        shared_runtimes = runtimes_mod.from_config(
            cfg.threads, sst_override=cfg.scan.decode_workers)
        tables = {}
        try:
            for name, (schema, num_pks) in schemas.items():
                tcfg = cfg
                if chunked_data and name == "data":
                    from horaedb_tpu_torch.storage.config import UpdateMode

                    tcfg = dataclasses.replace(
                        cfg, update_mode=UpdateMode.APPEND)
                table = await CloudObjectStorage.open(
                    f"{root_path}/{name}", segment_ms, store, schema,
                    num_pks, tcfg, runtimes=shared_runtimes, device=dev)
                tables[name] = table
                if wal_on:
                    if chunked_data and name == "data":
                        # an Append table has no __seq__ dedup, so a
                        # replay could duplicate rows: it keeps the
                        # direct write path
                        logger.info("wal: table %r is Append-mode; "
                                    "ingest WAL skipped", name)
                    else:
                        tables[name] = await IngestStorage.open(
                            table, os.path.join(wal_config.dir, name),
                            wal_config)
        except BaseException:
            for t in tables.values():
                await t.close()
            shared_runtimes.close()
            raise
        self = cls(tables, segment_ms, dev, chunked_data=chunked_data,
                   chunk_window_ms=chunk_window_ms)
        self._runtimes = shared_runtimes
        if rollup_config is not None and rollup_config.enabled:
            from horaedb_tpu_torch.rollup import RollupManager

            try:
                self.rollups = await RollupManager.open(
                    root_path, store, segment_ms, rollup_config, config,
                    shared_runtimes, tables["data"], device=dev)
            except BaseException:
                await self.close()
                raise
            self.rollups.attach(self)
            # flush completions make segments rollable (wal/ingest.py)
            data = tables["data"]
            if hasattr(data, "memtable_segments"):
                data.on_flush = self.rollups.note_flush
        if meta_config is not None and meta_config.enabled:
            # self-monitoring: scrape the process's own MetricsRegistry
            # into a __meta metrics table through this engine's normal
            # write path
            from horaedb_tpu_torch.metric_engine.meta import MetaIngest

            try:
                self.meta = MetaIngest(self, meta_config)
                await self.meta.start()
            except BaseException:
                await self.close()
                raise
        if (scanagent_config is not None and scanagent_config.active
                and not chunked_data):
            # near-data scan routing ([scanagent]): the DATA table's
            # aggregate scans consult the shard map and route covered
            # segments to their store-shard agents.  The index/series/
            # tags tables stay direct: their scans are row-shaped, tiny
            from horaedb_tpu_torch.scanagent import (ScanAgentClient,
                                                     ScanRouter)

            try:
                self._scanagent_client = ScanAgentClient(scanagent_config)
                data = tables["data"]
                base = getattr(data, "inner", data)  # unwrap WAL front
                base.reader.scan_router = ScanRouter(
                    scanagent_config, self._scanagent_client,
                    base.root_path, base.schema().user_schema,
                    base.schema().num_primary_keys,
                    base.segment_duration_ms)
            except BaseException:
                await self.close()
                raise
        return self

    async def close(self) -> None:
        """Close the rollup tiers, then the five tables (their
        compaction schedulers and scrub loops stop first), then the
        worker pools."""
        if self._scanagent_client is not None:
            await self._scanagent_client.close()
            self._scanagent_client = None
        if self.meta is not None:
            # the meta scraper writes through this engine: stop it
            # before anything under it goes away
            await self.meta.stop()
            self.meta = None
        if self.rollups is not None:
            await self.rollups.close()
            self.rollups = None
        for t in self.tables.values():
            await t.close()
        if self._chunk_cache is not None:
            # a closed engine's decoded chunks can never be read again,
            # and the ledger account goes with it
            self._chunk_cache.clear()
            memledger.deregister(self._chunk_mem_account)
            self._chunk_mem_account = None
        if self._runtimes is not None:
            self._runtimes.close()
            self._runtimes = None

    async def stats(self) -> dict:
        """Data volume stored (rows, bytes and SSTs per table, from the
        manifests), each reader's cache residency, with the WAL on the
        buffered state (memtables and WAL backlog), and with rollups on
        their lag and coverage."""
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
        if self.rollups is not None:
            out["rollups"] = await self.rollups.stats()
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

    async def write(self, samples: list[Sample]) -> None:
        """The three-stage pipeline (ref: metric_engine README diagram):
        metric ids, series ids and index rows, then the data rows."""
        if not samples:
            return
        try:
            with span("engine.write"):
                await self.metric_manager.populate_metric_ids(samples)
                await self.index_manager.populate_series_ids(samples)
                if self.chunked_data:
                    await self.sample_manager.persist_chunked(
                        samples, self.chunk_window_ms)
                else:
                    await self.sample_manager.persist(samples)
        finally:
            # the rollup delta feed, noted AFTER the writes (a pass
            # cannot consume the note while the rows are uncommitted)
            # and in the finally (a partly failed multi-segment write
            # still dirties whatever may have committed)
            if self.rollups is not None:
                by_metric: dict[str, set] = {}
                for s in samples:
                    by_metric.setdefault(s.name, set()).add(
                        int(Timestamp(s.timestamp).truncate_by(
                            self.segment_ms)))
                self.rollups.note_write(by_metric)

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
        data = self.tables["data"]
        fid = field_id_of(field)
        if self.chunked_data:
            await self._write_arrow_chunked(mid, fid, codes, tsid_of_code,
                                            ts_np, val_np)
            return
        tsids = tsid_of_code[codes]
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
        finally:
            # noted AFTER the writes, in the finally: see write()
            if self.rollups is not None:
                self.rollups.note_write(
                    {metric: {int(s) for s in np.unique(seg_ids)}})

    async def _write_arrow_chunked(self, mid, fid, codes, tsid_of_code,
                                   ts_np, val_np) -> None:
        """Bulk path of the chunked layout: rows grouped by (series,
        chunk window) in numpy, one payload encoded per group."""
        from horaedb_tpu_torch.metric_engine import chunks

        ensure(int(ts_np.min()) >= 0,
               "chunked data mode requires non-negative timestamps")
        window = self.chunk_window_ms
        chunk_idx = ts_np // window
        u_codes, u_cidx, _, inv = _unique_pairs(codes, chunk_idx)
        uniq_pairs = np.stack([u_codes, u_cidx * window], axis=1)
        order = np.argsort(inv, kind="stable")
        boundaries = np.concatenate(
            [[0], np.cumsum(np.bincount(inv, minlength=len(uniq_pairs)))])

        by_seg: dict[int, list[tuple]] = {}
        for g in range(len(uniq_pairs)):
            rows = order[boundaries[g]:boundaries[g + 1]]
            code_idx, c_ts = int(uniq_pairs[g, 0]), int(uniq_pairs[g, 1])
            payload = chunks.encode_chunk(ts_np[rows], val_np[rows])
            seg = int(Timestamp(c_ts).truncate_by(self.segment_ms))
            by_seg.setdefault(seg, []).append(
                (int(tsid_of_code[code_idx]), c_ts, payload))
        data = self.tables["data"]
        for seg, rows in sorted(by_seg.items()):
            lo = min(r[1] for r in rows)
            hi = max(r[1] for r in rows) + window
            batch = pa.record_batch(
                [pa.array(np.full(len(rows), mid, dtype=np.uint64)),
                 pa.array([r[0] for r in rows], type=pa.uint64()),
                 pa.array(np.full(len(rows), fid, dtype=np.uint64)),
                 pa.array([r[1] for r in rows], type=pa.int64()),
                 pa.array([r[2] for r in rows], type=pa.binary())],
                schema=data.schema().user_schema)
            await data.write(WriteRequest(batch, TimeRange.new(lo, hi)))

    # ---- read -------------------------------------------------------------

    async def _resolve_data_predicate(self, metric: str,
                                      filters: list[tuple[str, str]],
                                      time_range: TimeRange, field: str,
                                      ts_leaf: bool = True):
        """Data-table predicate for a query; None means provably empty.
        `ts_leaf=False` omits the time-range leaf: bucket-ALIGNED
        downsample queries enforce [start, end) exactly through the grid
        cut, and a predicate without the range keeps the cached windows
        and their memos range-independent."""
        parts = await self._data_pred_parts(metric, filters, time_range,
                                            ts_leaf)
        if parts is None:
            return None
        return And([parts[0], Eq("field_id", field_id_of(field))]
                   + parts[1:])

    async def _data_pred_parts(self, metric: str,
                               filters: list[tuple[str, str]],
                               time_range: TimeRange,
                               ts_leaf: bool = True):
        """The field-independent predicate leaves (metric id, time leaf,
        tsid In) shared by single- and multi-field queries; None means
        provably empty."""
        mid = await self.metric_manager.resolve(metric, time_range)
        if mid is None:
            return None
        tsids = await self.index_manager.find_tsids(mid, filters, time_range)
        if tsids is not None and not tsids:
            return None
        preds = [Eq("metric_id", mid)]
        if self.chunked_data:
            # a chunk's row key is its window start; a window overlapping
            # the query starts at or after truncate(start, window)
            # (chunked mode stores only non-negative timestamps, so the
            # truncation is a true floor)
            lo = int(Timestamp(max(0, int(time_range.start))).truncate_by(
                self.chunk_window_ms))
            preds.append(TimeRangePred("chunk_ts", lo, int(time_range.end)))
        elif ts_leaf:
            preds.append(TimeRangePred("timestamp", int(time_range.start),
                                       int(time_range.end)))
        if tsids is not None:
            preds.append(In("tsid", sorted(tsids)))
        return preds

    async def query(self, metric: str, filters: list[tuple[str, str]],
                    time_range: TimeRange, field: str = "value") -> pa.Table:
        """Raw samples of one field of a metric matching all label
        filters, as an Arrow table (tsid, timestamp, value)."""
        with span("resolve"):
            pred = await self._resolve_data_predicate(metric, filters,
                                                      time_range, field)
        if pred is None:
            return _empty_result()
        with span("scan"):
            qp = await self.tables["data"].plan_query(ScanRequest(
                range=time_range, predicate=pred))
            batches = await _collect(self.tables["data"].execute_plan(qp))
        if not batches:
            return _empty_result()
        if self.chunked_data:
            with span("chunk_decode"):
                return self._decode_chunk_batches(batches, time_range)
        return pa.Table.from_batches(batches).select(
            ["tsid", "timestamp", "value"])

    @staticmethod
    def _decode_chunk_arrays(batches: list[pa.RecordBatch],
                             time_range: TimeRange):
        """THE chunk-decode semantics (payloads -> (tsid, ts, value)
        numpy arrays, [start, end) masked), shared by the row-table and
        the device-downsample paths.  Each batch's payloads decode in
        one host-library call (native.chunk_decode_batch).  Returns None
        when no samples survive the mask."""
        from horaedb_tpu_torch import native

        out_tsid: list[np.ndarray] = []
        out_ts: list[np.ndarray] = []
        out_val: list[np.ndarray] = []
        lo, hi = int(time_range.start), int(time_range.end)
        for b in batches:
            payload_arr = b.column(b.schema.names.index("payload"))
            got = native.chunk_decode_batch(payload_arr)
            if got is None:
                # a malformed payload: the plain decoder names the fault
                for p in payload_arr.to_pylist():
                    native.decode_chunks_plain(p)
                raise Error("chunk payloads could not be decoded")
            ts, vals, counts = got
            tsids = np.repeat(
                b.column(b.schema.names.index("tsid")).to_numpy(
                    zero_copy_only=False), counts)
            m = (ts >= lo) & (ts < hi)
            if m.any():
                out_ts.append(ts[m])
                out_val.append(vals[m])
                out_tsid.append(tsids[m])
        if not out_ts:
            return None
        return (np.concatenate(out_tsid), np.concatenate(out_ts),
                np.concatenate(out_val))

    def _decode_chunk_batches(self, batches: list[pa.RecordBatch],
                              time_range: TimeRange) -> pa.Table:
        decoded = self._decode_chunk_arrays(batches, time_range)
        if decoded is None:
            return _empty_result()
        tsid_np, ts_np, val_np = decoded
        return pa.table({
            "tsid": pa.array(tsid_np, type=pa.uint64()),
            "timestamp": pa.array(ts_np, type=pa.int64()),
            "value": pa.array(val_np, type=pa.float64()),
        })

    async def resolve_series(self, metric: str, tsids: list[int],
                             time_range: TimeRange) -> dict[int, bytes]:
        """tsid -> human-readable series key, via the series table."""
        mid = await self.metric_manager.resolve(metric, time_range)
        if mid is None:
            return {}
        return await self.index_manager.resolve_series_keys(
            mid, tsids, time_range)

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
        fused_aggregate_ok) and a rollup-served query's are host float64
        arrays; the chunked layout's are host float32 arrays.

        When a standing rollup covers (metric, field, bucket), the grid
        is assembled from tier cells plus a raw tail for the
        not-yet-rolled segments (rollup/manager.py states its contract);
        `use_rollup=False` forces the raw path."""
        num_buckets, aligned = self._downsample_grid(time_range, bucket_ms)
        if self.chunked_data:
            with span("downsample_chunked"):
                return await self._downsample_chunked(
                    metric, filters, time_range, bucket_ms, num_buckets,
                    field=field, which=tuple(aggs))
        resolved = None
        if use_rollup:
            out, resolved = await self._try_rollup_serve(
                metric, filters, time_range, bucket_ms, num_buckets,
                field, tuple(aggs))
            if out is not None:
                return out
        with span("resolve"):
            pred = await self._resolved_or_build_predicate(
                metric, filters, time_range, field, not aligned, resolved)
        with span("downsample"):
            return await self._scan_downsample(pred, time_range,
                                               bucket_ms, num_buckets,
                                               aggs)

    def _pred_from_resolved(self, resolved, field: str,
                            time_range: TimeRange, ts_leaf: bool):
        """The _data_pred_parts leaf shape, rebuilt from an
        already-resolved (mid, tsids) pair — the same leaves in the same
        order, so scan-cache keys cannot drift between the paths."""
        mid, tsids = resolved
        preds = [Eq("metric_id", mid), Eq("field_id", field_id_of(field))]
        if ts_leaf:
            preds.append(TimeRangePred("timestamp", int(time_range.start),
                                       int(time_range.end)))
        if tsids is not None:
            preds.append(In("tsid", sorted(tsids)))
        return And(preds)

    async def _resolved_or_build_predicate(self, metric, filters,
                                           time_range, field: str,
                                           ts_leaf: bool, resolved):
        """Raw-path predicate, reusing the rollup probe's resolve and
        index lookup when one ran."""
        if resolved is not None:
            return self._pred_from_resolved(resolved, field, time_range,
                                            ts_leaf)
        return await self._resolve_data_predicate(metric, filters,
                                                  time_range, field,
                                                  ts_leaf=ts_leaf)

    async def _try_rollup_serve(self, metric, filters, time_range,
                                bucket_ms: int, num_buckets: int,
                                field: str, aggs: tuple):
        """Rollup coverage check + serve.  Returns (result, resolved):
        result None means take the raw path; resolved carries the
        probe's (mid, tsids) for the raw path to reuse.  All rollup-tier
        reads route through here."""
        if self.rollups is None or not self.rollups.covers(
                metric, field, bucket_ms, time_range):
            return None, None
        with span("rollup_plan"):
            mid = await self.metric_manager.resolve(metric, time_range)
            if mid is None:
                return {"tsids": [], "num_buckets": num_buckets,
                        "aggs": {}}, None
            tsids = await self.index_manager.find_tsids(mid, filters,
                                                        time_range)
            if tsids is not None and not tsids:
                return {"tsids": [], "num_buckets": num_buckets,
                        "aggs": {}}, None
        out = await self.rollups.try_serve(metric, mid, tsids, time_range,
                                           bucket_ms, field, aggs)
        return out, (mid, tsids)

    async def _scan_downsample(self, pred, time_range: TimeRange,
                               bucket_ms: int, num_buckets: int,
                               aggs: tuple, top_k=None,
                               parts_route: bool = False) -> dict:
        """Shared scan + result shaping of the row-layout downsample
        paths (single-field, multi-field, top-k and the rollup
        manager's recomputes, which pass `parts_route`): all route
        through one QueryPlan."""
        if pred is None:
            return {"tsids": [], "num_buckets": num_buckets, "aggs": {}}
        spec = AggregateSpec(group_col="tsid", ts_col="timestamp",
                             value_col="value",
                             range_start=int(time_range.start),
                             bucket_ms=bucket_ms, num_buckets=num_buckets,
                             which=tuple(aggs))
        qp = await self.tables["data"].plan_query(
            ScanRequest(range=time_range, predicate=pred), spec=spec,
            top_k=top_k, parts_route=parts_route)
        group_values, grids = await self.tables["data"].execute_plan(qp)
        return {"tsids": [int(t) for t in group_values],
                "num_buckets": num_buckets,
                "aggs": grids if len(group_values) else {}}

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
        device grids; a rollup-served or chunked query ranks its
        downsample grid on the host (plan.apply_top_k)."""
        from horaedb_tpu_torch.storage.plan import TopKSpec, apply_top_k

        ensure(by in ALL_AGGS,
               f"unknown top-k aggregate {by!r}; supported: {ALL_AGGS}")
        which = tuple(sorted(set(aggs) | {by}))
        tk = TopKSpec(k=k, by=by, largest=largest)

        def ranked(out: dict) -> dict:
            if out["tsids"]:
                values, grids = apply_top_k(
                    np.asarray(out["tsids"], dtype=np.uint64), out["aggs"],
                    tk)
                out["tsids"] = [int(t) for t in values]
                out["aggs"] = grids
            return out

        if self.chunked_data:
            return ranked(await self.query_downsample(
                metric, filters, time_range, bucket_ms, field=field,
                aggs=which))
        num_buckets, aligned = self._downsample_grid(time_range, bucket_ms)
        resolved = None
        if use_rollup:
            # a rollup-covered top-k is the covered downsample grid with
            # the TopK stage applied on the host (the chunked path's
            # shape): the same grids in, the same slice out
            out, resolved = await self._try_rollup_serve(
                metric, filters, time_range, bucket_ms, num_buckets,
                field, which)
            if out is not None:
                return ranked(out)
        pred = await self._resolved_or_build_predicate(
            metric, filters, time_range, field, not aligned, resolved)
        return await self._scan_downsample(
            pred, time_range, bucket_ms, num_buckets, which, top_k=tk)

    async def query_downsample_multi(self, metric: str,
                                     filters: list[tuple[str, str]],
                                     time_range: TimeRange, bucket_ms: int,
                                     fields: list[str],
                                     aggs: tuple = ALL_AGGS,
                                     use_rollup: bool = True) -> dict:
        """GROUP BY series, time(bucket) over SEVERAL fields of one
        metric with ONE metric/index resolve shared by every field's
        scan.  Returns {field: result}, each result shaped exactly like
        query_downsample's.  Fields partition the data table's rows, so
        each field's pushdown scan decodes only its own rows; the scans
        run one after another (each pipelines its own IO)."""
        ensure(len(fields) > 0, "fields must be non-empty")
        if self.chunked_data:
            return {f: await self.query_downsample(
                metric, filters, time_range, bucket_ms, field=f, aggs=aggs)
                for f in fields}
        num_buckets, aligned = self._downsample_grid(time_range, bucket_ms)
        out = {}
        remaining = list(fields)
        resolved = None
        covered = ([] if not use_rollup or self.rollups is None else
                   [f for f in remaining if self.rollups.covers(
                       metric, f, bucket_ms, time_range)])
        if covered:
            # per-field routing with ONE shared resolve: covered fields
            # read their rollup tier, the rest reuse (mid, tsids) below
            with span("rollup_plan"):
                mid = await self.metric_manager.resolve(metric,
                                                        time_range)
                tsids = (None if mid is None else
                         await self.index_manager.find_tsids(
                             mid, filters, time_range))
            if mid is None or (tsids is not None and not tsids):
                return {f: {"tsids": [], "num_buckets": num_buckets,
                            "aggs": {}} for f in fields}
            resolved = (mid, tsids)
            for f in covered:
                served = await self.rollups.try_serve(
                    metric, mid, tsids, time_range, bucket_ms, f,
                    tuple(aggs))
                if served is not None:
                    out[f] = served
                    remaining.remove(f)
            if not remaining:
                return out
        parts = None
        if resolved is None:
            parts = await self._data_pred_parts(metric, filters,
                                                time_range,
                                                ts_leaf=not aligned)
        for f in remaining:
            if resolved is not None:
                pred = self._pred_from_resolved(resolved, f, time_range,
                                                not aligned)
            else:
                pred = (None if parts is None else
                        And([parts[0], Eq("field_id", field_id_of(f))]
                            + parts[1:]))
            out[f] = await self._scan_downsample(pred, time_range,
                                                 bucket_ms, num_buckets,
                                                 aggs)
        return out

    async def _downsample_chunked(self, metric: str, filters, time_range,
                                  bucket_ms: int, num_buckets: int,
                                  field: str = "value",
                                  which: tuple = ALL_AGGS) -> dict:
        """Chunked-layout downsample that never builds an Arrow row
        table: chunk payloads batch-decode straight into the
        fixed-width arrays the device aggregate consumes.  Same grids as
        the row layout within the aggregate's tolerance contract.

        Repeat queries skip the (uncached Append-mode) scan AND the
        decode via the engine's decode LRU: the key is (canonical
        predicate, exact range, the data table's overlapping SST ids),
        so any write or compaction misses it, exactly like the row
        layout's scan cache.  The entry also keeps the padded device
        arrays, so a repeat uploads nothing and only re-runs the
        aggregate."""
        from horaedb_tpu_torch.ops.filter import canonical_predicate_key

        pred = await self._resolve_data_predicate(metric, filters,
                                                  time_range, field)
        if pred is None:
            return {"tsids": [], "num_buckets": num_buckets, "aggs": {}}
        ssts = await self.tables["data"].manifest.find_ssts(time_range)
        key = (canonical_predicate_key(pred),
               int(time_range.start), int(time_range.end),
               tuple(sorted(f.id for f in ssts)))
        entry = self._chunk_cache.get(key)
        fresh = entry is None
        if fresh:
            batches = await _collect(self.tables["data"].scan(ScanRequest(
                range=time_range, predicate=pred)))
            decoded = self._decode_chunk_arrays(batches, time_range)
            if decoded is None:
                return {"tsids": [], "num_buckets": num_buckets,
                        "aggs": {}}
            entry = {"decoded": decoded, "memo": {}}
        tsid_np, ts_np, val_np = entry["decoded"]
        out = self._downsample_arrays(tsid_np, ts_np, val_np, time_range,
                                      bucket_ms, num_buckets, which=which,
                                      memo=entry["memo"])
        if fresh:
            # charged after the memo is built, so the padded device
            # arrays count at their real size
            dev = entry["memo"].get("dev", {})
            nbytes = 24 * len(ts_np) + 1024 + sum(
                int(a.nbytes) for a in dev.values()
                if hasattr(a, "nbytes"))
            self._chunk_cache.put(key, entry, nbytes)
        return out

    def _downsample_arrays(self, tsid_np, ts_np, val_np,
                           time_range: TimeRange, bucket_ms: int,
                           num_buckets: int,
                           which: tuple = ALL_AGGS,
                           memo: Optional[dict] = None) -> dict:
        """ONE ops.downsample.time_bucket_aggregate call over decoded
        arrays on the engine's device (the bucket_window_partials kernel
        on the card, its plain version on the CPU).  `memo` (a chunk
        decode cache entry's) keeps the padded DEVICE arrays after the
        first aggregate, so repeats upload nothing; valid because the
        cache key pins the exact time range (ts offsets are
        range_start-relative).  Returns host arrays."""
        from horaedb_tpu_torch.ops.downsample import time_bucket_aggregate
        from horaedb_tpu_torch.ops.encode import pad_capacity, to_device

        n = len(ts_np)
        dev = memo.get("dev") if memo is not None else None
        if dev is None:
            # dense group ids without a full-length np.unique: chunk
            # decode emits long runs of equal tsids, so dense-ify the run
            # VALUES (about one per chunk row) and repeat the codes over
            # the run lengths — the output of np.unique(tsid_np,
            # return_inverse=True) at a fraction of the cost
            if n:
                new_run = np.empty(n, dtype=bool)
                new_run[0] = True
                np.not_equal(tsid_np[1:], tsid_np[:-1], out=new_run[1:])
                run_idx = np.flatnonzero(new_run)
                uniq, inv = np.unique(tsid_np[run_idx],
                                      return_inverse=True)
                run_lens = np.diff(np.append(run_idx, n))
                gid = np.repeat(inv.astype(np.int32), run_lens)
            else:
                uniq = np.empty(0, dtype=np.uint64)
                gid = np.empty(0, dtype=np.int32)
            ts_rel = ts_np - int(time_range.start)
            cap = pad_capacity(n)

            def pad(a, dtype):
                return to_device(np.pad(a.astype(dtype), (0, cap - n)),
                                 self.device)

            dev = {"uniq": uniq, "gid_host": gid, "ts_rel": ts_rel,
                   "ts": pad(ts_rel, np.int32), "gid": pad(gid, np.int32),
                   "val": pad(val_np, np.float32)}
            if memo is not None:
                memo["dev"] = dev
        uniq = dev["uniq"]
        aggs = time_bucket_aggregate(
            dev["ts"], dev["gid"], dev["val"], n, bucket_ms,
            num_groups=len(uniq), num_buckets=num_buckets, which=which)
        host = {k: v.cpu().numpy() for k, v in aggs.items()}
        if "last" in which:
            # the pushdown path's grid keys (it emits last_ts only
            # alongside last): per-cell max sample time (absolute ms as
            # float, NaN for empty cells)
            gid_h, ts_rel = dev["gid_host"], dev["ts_rel"]
            cell = gid_h.astype(np.int64) * num_buckets + ts_rel // bucket_ms
            last_ts = np.full(len(uniq) * num_buckets, -np.inf)
            np.maximum.at(last_ts, cell, ts_rel.astype(np.float64))
            last_ts = last_ts.reshape(len(uniq), num_buckets)
            host["last_ts"] = np.where(np.isinf(last_ts), np.nan,
                                       last_ts + int(time_range.start))
        return {"tsids": [int(t) for t in uniq],
                "num_buckets": num_buckets, "aggs": host}

    # ---- labels and lists -------------------------------------------------

    async def label_values(self, metric: str, tag_key: str,
                           time_range: TimeRange) -> list[str]:
        """Distinct values of one tag of a metric in the window
        (Prometheus /api/v1/label/<name>/values analogue)."""
        mid = await self.metric_manager.resolve(metric, time_range)
        if mid is None:
            return []
        return await self.index_manager.label_values(mid, tag_key,
                                                     time_range)

    async def label_names(self, metric: str,
                          time_range: TimeRange) -> list[str]:
        """Distinct tag keys of a metric in the window (Prometheus
        /api/v1/labels analogue)."""
        mid = await self.metric_manager.resolve(metric, time_range)
        if mid is None:
            return []
        return await self.index_manager.label_names(mid, time_range)

    async def list_metrics(self, time_range: TimeRange) -> list[str]:
        """Distinct metric names active in the window (Prometheus
        /api/v1/label/__name__/values analogue)."""
        return await self.metric_manager.list_metrics(time_range)

    async def list_fields(self, metric: str,
                          time_range: TimeRange) -> list[str]:
        """Distinct field names of a metric in the window."""
        return await self.metric_manager.list_fields(metric, time_range)
