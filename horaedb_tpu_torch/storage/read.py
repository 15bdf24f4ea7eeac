"""Merge-scan read path — the north-star pipeline (PyTorch port).

Per time segment (ref: src/storage/src/read.rs:429-494):

  SegmentRead (host, async)  — tier-2 encoded parts first
                               (storage/encoded_cache.py), then the
                               missing SSTs' sidecars (block-pruned under
                               a selective label filter), parquet when a
                               sidecar is missing or invalid (stats-pruned
                               row groups); a segment over the stream
                               threshold is read window by window
  Merge (host, numpy)        — k-way-merge permutation over the
                               pre-sorted SST runs + keep-last dedup,
                               cut into PK-range windows
  Filter (host mask)         — predicate tree -> row mask (gid -1)
  Aggregate (device), one of two paths (fused_aggregate_ok decides):
    fused  — rounds of windows are stacked on the device; each round is
             ONE bucket_round_accumulate call that folds its rows
             straight into a query-global accumulator; only the final
             grids leave the device.  Two-phase: every window is
             collected (pinned in host RAM) before the first round runs.
    parts  — segments stream through rounds of ONE
             bucket_window_partials call each; the round's partial
             grids come to the host once and fold in float64 in
             storage/combine.py (sparse or dense), behind a per-segment
             partial memo (PartsMemo) that serves narrowed ranges.

The fused path's round stacks live in a byte-bounded device LRU (the
stack cache, the scan cache's budget) in two entries per round: the
range-independent columns (ts, gid, val, n_valid) keyed by the round's
window objects, and the range-dependent remap/shift/lo (KBs).  Each
entry holds weak references to its windows and is dropped when they
are gone.  On a CUDA reader the columns are stacked from per-window
device copies memoized on the window, so a query over another
bucket-aligned range uploads only the small arrays (a range that cuts
a segment takes a time leaf, which keys those memos anew).  The parts
path builds its rounds uncached: its plans outgrow the byte bound.  A
completed fused query records its rounds (the fused replay cache, weak
references only): an identical repeat re-runs init -> rounds ->
finalize from the cached stacks in one pool dispatch, with no read, no
prep and no upload; any eviction, dead window or changed SST set takes
the full path and is counted.  drop_hbm_state() empties every
device-side tier and keeps the host windows.

Device decode ([scan.decode], ops/device_decode.py): on the parts path,
an eligible plan sends each sidecar segment's ENCODED columns to the
card raw, where leaf filter, merge, keep-last dedup and one
bucket_window_partials launch replace the host merge, the window cut and
the round stacks; the segment comes back as one finished part.  Mode
"auto" engages on a CUDA reader for the plans the fused gate declines;
"host" keeps host decode everywhere, the bit-identity control.

Cold reads run through the bounded pipeline (storage/pipeline.py):
store fetches, the per-segment decode and the device rounds overlap,
with at most `[scan.pipeline] depth` segments and `inflight_bytes` of
host memory in flight; a scan with no store I/O (every segment
tier-2 resident) and `enabled = false` take the sequential pump, with
bit-identical results.

Row scans decode the merged windows back to Arrow on the host.  Post-
merge host windows are cached per segment (storage/scan_cache.py), so a
repeat query skips the read and the merge; per-SST encoded parts are
cached under them (tier 2), admitted at write time.

Append tables (the chunked data layout) take a host path instead: each
segment's rows read from parquet (never sidecars: BytesMerge needs the
exact Arrow bytes), sorted by (PK, __seq__) and merged by the
BytesMerge operator, uncached; a streamed Append segment merges window
by window and re-resolves its SSTs after a compaction race mid-segment.
Aggregate plans consult the near-data router (scanagent/client.py)
first: covered segments' partials come from their agents while the
local pump scans the rest, and a failed agent segment falls back to the
local pump.  Deadline checkpoints sit between segments and windows, the
tenant scan-byte quota is charged where stage bytes are attributed, and
the reader's caches are memory-ledger accounts.  Not ported: mesh
rounds (and their decode rounds and stall counters), and the device
scalar cache (_scalar_cache), since the port passes the
bucket count and width to the kernel as host ints, so a replay has no
scalar to upload.
"""

from __future__ import annotations

import asyncio
import functools
import logging
import os
import threading
import time
import weakref
from collections import OrderedDict, deque
from dataclasses import dataclass
from dataclasses import replace as dc_replace
from typing import AsyncIterator, Optional

import numpy as np
import pyarrow as pa

from horaedb_tpu_torch.common.deadline import checkpoint as deadline_checkpoint
from horaedb_tpu_torch.common.error import Error, ensure
from horaedb_tpu_torch.common.memledger import ledger as memledger
from horaedb_tpu_torch.common.tenant import charge_scan_bytes
from horaedb_tpu_torch.objstore import NotFoundError, ObjectStore
from horaedb_tpu_torch.ops import bucket_agg, device_decode, encode
from horaedb_tpu_torch.ops import filter as filter_ops
from horaedb_tpu_torch.ops.downsample import ALL_AGGS, canonical_which
from horaedb_tpu_torch.storage import combine as combine_mod
from horaedb_tpu_torch.storage import parquet_io, sidecar
from horaedb_tpu_torch.storage.config import StorageConfig, UpdateMode
from horaedb_tpu_torch.storage.encoded_cache import EncodedSegmentCache
from horaedb_tpu_torch.storage.scan_cache import (
    MEMO_SLOTS,
    ScanCache,
    segment_cache_key,
)
from horaedb_tpu_torch.storage.sst import SstFile, segment_of, sst_path
from horaedb_tpu_torch.storage.types import (
    RESERVED_COLUMN_NAME,
    SEQ_COLUMN_NAME,
    StorageSchema,
    TimeRange,
)
from horaedb_tpu_torch.utils import registry, trace_add

logger = logging.getLogger(__name__)

_ROWS_SCANNED = registry.counter(
    "storage_rows_scanned_total", "rows produced by merge-scan")
# one labeled family per unit (stage= label); per-query attribution
# additionally lands on the ambient trace through _observe_stage
_STAGE_SECONDS = {
    s: registry.histogram("scan_stage_seconds",
                          "wall seconds per merge-scan plan stage"
                          ).labels(stage=s)
    for s in ("segment_read", "merge", "stack_build", "device_aggregate",
              "combine")
}
# rows and bytes of the segment reads by source: sidecar (tier 2 or the
# store) or parquet; the read's seconds go to segment_read
_STAGE_ROWS = {
    s: registry.counter("scan_stage_rows_total",
                        "rows entering each plan stage").labels(stage=s)
    for s in ("sidecar_read", "parquet_read")
}
_STAGE_BYTES = {
    s: registry.counter("scan_stage_bytes_total",
                        "bytes entering each plan stage").labels(stage=s)
    for s in ("sidecar_read", "parquet_read")
}


def _observe_stage(stage: str, seconds: float) -> None:
    """Attribute wall time to a plan stage: the cumulative registry
    histogram and, when a request trace is ambient, its profile."""
    _STAGE_SECONDS[stage].observe(seconds)
    trace_add(f"stage_{stage}_ms", seconds * 1e3)


_INCR_REMERGE = registry.counter(
    "scan_incremental_remerge_total",
    "segments re-merged from tier-2-resident parts with only the "
    "missing SSTs fetched (the post-flush path)")
# the parts path's rounds (one bucket_window_partials launch each) and
# its one device-to-host copy per round: the round's partial grids
_PARTS_ROUNDS = registry.counter(
    "scan_parts_rounds_total", "aggregate rounds run by the parts path")
_PARTIALS_D2H_BYTES = registry.counter(
    "scan_partials_d2h_bytes_total",
    "bytes of partial grids copied device-to-host by the parts path")
# the fused replay cache and the device stack cache: a repeat fused
# query replays its recorded rounds, a varied range reuses the cached
# column stacks (ops parity with scan_cache_*)
_REPLAY_HITS = registry.counter(
    "scan_replay_hits_total", "fused-replay plan cache hits")
_REPLAY_ROWS = registry.counter(
    "scan_replay_rows_total",
    "rows served from fused-replay hits without re-scanning")
_REPLAY_MISSES = registry.counter(
    "scan_replay_misses_total", "fused-replay plan cache misses")
_STACK_HITS = registry.counter(
    "scan_stack_cache_hits_total",
    "round-stack LRU hits (column and remap/shift/lo entries)")
_STACK_MISSES = registry.counter(
    "scan_stack_cache_misses_total", "round-stack LRU misses")
# fused replay plans kept per reader (weakref-only entries)
_REPLAY_SLOTS = 8
# rows -> bytes conversion for the cache_max_rows knob: a typical engine
# window is ~4 int32/f32 columns (16B) plus the memo allowance
_CACHE_BYTES_PER_ROW = 32
# accumulator identity of `last_ts` (and of an empty cell's partial)
_ACC_TS_MIN = -(2**31)
_F32_MAX = float(np.finfo(np.float32).max)

# [scan.decode] modes (storage/config.ScanDecodeConfig)
DECODE_MODES = ("auto", "device", "host")

# guards every window's memo put: memo stores run on worker-pool
# threads, and the byte accounting must not drift
_MEMO_LOCK = threading.Lock()


def _memo_store(w, key, value, nbytes: int) -> None:
    """Byte-bounded per-window memo put: the scan cache charges each
    window MEMO_SLOTS * (capacity*4 + 128) bytes of memo allowance, and
    this store keeps the real bytes under it.  A same-key put loses to
    the entry already stored (identical computation by a concurrent
    query)."""
    budget = MEMO_SLOTS * (w.capacity * 4 + 128)
    if nbytes > budget:
        return
    with _MEMO_LOCK:
        if key in w.memo:
            return
        if len(w.memo) >= MEMO_SLOTS or w.memo_bytes + nbytes > budget:
            w.memo.clear()
            w.memo_bytes = 0
        w.memo[key] = value
        w.memo_bytes += nbytes


@dataclass
class ScanRequest:
    """(ref: storage.rs:65-70)"""

    range: TimeRange
    predicate: Optional[filter_ops.Predicate] = None
    # indexes into the FULL storage schema (user columns + builtins)
    projections: Optional[list[int]] = None


@dataclass
class AggregateSpec:
    """Downsample pushdown: GROUP BY group_col, time(bucket) computed on
    device straight from the merge output."""

    group_col: str
    ts_col: str
    value_col: str
    range_start: int  # host-time of bucket 0
    bucket_ms: int
    num_buckets: int
    # which aggregates to compute (canonicalized; count always rides
    # along)
    which: tuple = ALL_AGGS

    def __post_init__(self):
        self.which = canonical_which(self.which)


@dataclass
class SegmentPlan:
    segment_start: int
    ssts: list[SstFile]
    columns: list[str]


@dataclass
class ScanPlan:
    segments: list[SegmentPlan]
    mode: UpdateMode
    predicate: Optional[filter_ops.Predicate]
    keep_builtin: bool
    # pyarrow expression pushed into the parquet reads (PK-only subtree
    # of `predicate`); the full predicate still applies post-merge
    pushdown: object = None
    # canonical string of the pushed subtree (scan-cache identity)
    pushdown_key: str = ""
    # flattened conjunction of the same pushed subtree for the sidecar
    # reads (None: shape not prunable)
    prune_leaves: Optional[list] = None
    # True when the pushed subtree IS the whole predicate: the read
    # already filtered exactly these rows, so post-merge re-evaluation
    # is a no-op and is skipped
    pushed_complete: bool = False
    range: Optional[TimeRange] = None
    # False for a compaction rewrite: its inputs are deleted right
    # after, so caching their merge would only evict hot entries
    use_cache: bool = True
    # worker pool of the plan's CPU work ("compact" for rewrites, so
    # they queue behind each other, not in front of serving scans)
    pool: str = "sst"
    # set by aggregate_segments when the plan takes the device decode:
    # sidecar segments then come back as finished DeviceParts
    decode_spec: Optional["AggregateSpec"] = None
    # set for the rollup manager's recomputes (maintenance and the raw
    # tail, rollup/manager.py): the fused gate declines the plan, so it
    # takes the parts route whatever its size, HORAEDB_FUSED_AGG
    # included — the route whose float64 grids the rollup cells store
    parts_route: bool = False
    # set by _cached_windows: whether this scan runs through the
    # pipeline, which the parts pump reads to run its rounds as a
    # background device stage
    pipeline_active: bool = False


class ParquetReader:
    """Builds and executes per-segment merge-scan plans
    (ref: ParquetReader, read.rs:407-494)."""

    def __init__(self, store: ObjectStore, root_path: str,
                 schema: StorageSchema, config: StorageConfig,
                 segment_duration_ms: int, runtimes=None, device="cuda"):
        self.store = store
        self.root_path = root_path
        self.schema = schema
        self.config = config
        self.segment_duration_ms = segment_duration_ms
        self.runtimes = runtimes
        self.device = device
        # optional async callback (segment_start, scan_range) -> current
        # SstFiles: set by CloudObjectStorage so a streamed Append
        # segment survives a compaction race mid-segment
        # (_stream_window_batches)
        self.resolve_segment_ssts = None
        ensure(config.scan.combine.mode in combine_mod.COMBINE_MODES,
               f"unknown [scan.combine] mode "
               f"{config.scan.combine.mode!r}; expected one of "
               f"{combine_mod.COMBINE_MODES}")
        # bad TOML fails the open, not a dashboard's first cold scan
        ensure(config.scan.decode.mode in DECODE_MODES,
               f"unknown [scan.decode] mode {config.scan.decode.mode!r}; "
               f"expected one of {DECODE_MODES}")
        cache_bytes = (config.scan.cache_max_bytes
                       or config.scan.cache_max_rows * _CACHE_BYTES_PER_ROW)
        self.cache_budget_bytes = cache_bytes
        self.scan_cache = ScanCache(cache_bytes)
        self.parts_memo = combine_mod.PartsMemo(
            config.scan.combine.memo_max_bytes)
        # tier 2: host-RAM per-SST encoded parts under the window cache
        # — a window-cache miss rebuilds from host memory, and a changed
        # SST set re-merges with only the missing SSTs fetched.  Also
        # owns the per-SST sidecar-missing negative memo
        self.encoded_cache = EncodedSegmentCache(
            config.scan.cache.tier2_max_bytes,
            write_through=config.scan.cache.write_through)
        # high-water of pipeline in-flight host bytes observed by this
        # reader's scans (pipeline.PipelineBudget)
        self._pipeline_high_water = 0
        # round stacks on the device: key -> (window weakrefs, arrays,
        # bytes), LRU by bytes under the scan cache's budget (host
        # windows live in host RAM, so the stacks are the device's
        # working set).  Worker-pool threads build rounds: locked.
        self._stack_cache: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._stack_cache_lock = threading.Lock()
        self._stack_cache_bytes = 0
        self._stack_cache_max = cache_bytes
        self._stack_cache_hits = 0
        self._stack_cache_misses = 0
        # fused replay plans: a completed fused aggregate's round
        # composition (stack keys and window weakrefs, no device memory
        # pinned); event-loop owned
        self._replay_cache: "OrderedDict[tuple, dict]" = OrderedDict()
        self._replay_hits = 0
        self._replay_misses = 0
        # near-data routing ([scanagent]): a ScanRouter attached here
        # sends covered segments' aggregate scans to their store-shard
        # agents and folds the returned partials through the normal
        # combine (scanagent/client.py); None = the direct-scan control
        self.scan_router = None
        # memory plane: every reader-owned byte budget registers a
        # ledger account tagged with its configured budget; close()
        # deregisters.  Anchored weakly on the reader.  The pipeline
        # module's process account must exist the moment a reader does
        from horaedb_tpu_torch.storage import pipeline as _pipeline  # noqa: F401
        self._mem_accounts = [
            # RESIDENT bytes, not the LRU's charged bytes (which
            # include a worst-case per-window memo allowance)
            memledger.register(
                f"scan_cache:{root_path}",
                lambda r: r._scan_cache_resident_bytes(), anchor=self,
                kind="scan_cache", budget=cache_bytes, owner=root_path),
            # round stacks live on the reader's device: host RAM on a
            # CPU reader, card memory on a CUDA one — there they are
            # not host RSS (memory_device_bytes covers them)
            memledger.register(
                f"stack_cache:{root_path}",
                lambda r: r._stack_cache_bytes, anchor=self,
                kind="stack_cache", budget=self._stack_cache_max,
                owner=root_path, host=not self.on_cuda),
            memledger.register(
                f"encoded_cache:{root_path}",
                lambda r: r.encoded_cache.total_bytes, anchor=self,
                kind="encoded_cache",
                budget=config.scan.cache.tier2_max_bytes,
                owner=root_path),
            memledger.register(
                f"parts_memo:{root_path}",
                lambda r: r.parts_memo.lru.total_bytes, anchor=self,
                kind="parts_memo",
                budget=config.scan.combine.memo_max_bytes,
                owner=root_path),
        ]

    @property
    def on_cuda(self) -> bool:
        import torch

        return torch.device(self.device).type == "cuda"

    def close(self) -> None:
        """Release every reader-owned cache tier and deregister ledger
        accounts: a closed table holds no attributable bytes
        (scan_cache_bytes{tier="tier2"} reads 0 afterwards)."""
        self.drop_hbm_state()
        self.scan_cache.clear()
        self.encoded_cache.clear()
        self.parts_memo.clear()
        for acct in self._mem_accounts:
            memledger.deregister(acct)
        self._mem_accounts = []
        memledger.reset_device_high_water()

    def _scan_cache_resident_bytes(self) -> int:
        """Actual bytes the window cache holds: column buffers at their
        padded widths plus MATERIALIZED memo bytes — the ledger's pull
        gauge (scan_cache.total_bytes charges the worst-case memo
        allowance up front instead)."""
        total = 0
        for windows in self.scan_cache.values():
            for w in windows:
                total += sum(int(c.dtype.itemsize) * w.capacity
                             for c in w.columns.values())
                total += int(w.memo_bytes)
        return total

    def drop_hbm_state(self) -> None:
        """Evict everything device-resident that derives from cached
        windows (round stacks, fused-replay plans, per-window memos:
        device column copies and group maps) while KEEPING the post-merge
        windows themselves, which live in host RAM.  The next query
        re-stacks and re-uploads from the host windows instead of
        re-reading and re-merging.  (Tests and benchmarks; production
        eviction is the LRUs' own.)"""
        with self._stack_cache_lock:
            self._stack_cache.clear()
            self._stack_cache_bytes = 0
        self._replay_cache.clear()
        with _MEMO_LOCK:
            for windows in self.scan_cache.values():
                for w in windows:
                    w.memo.clear()
                    w.memo_bytes = 0

    def cache_stats(self) -> dict:
        """Every reader-owned cache tier's residency and effectiveness,
        one dict per tier, and the pipeline's settings and high-water."""
        return {
            "scan_cache": {
                "entries": len(self.scan_cache),
                "bytes": self.scan_cache.total_bytes,
                "max_bytes": self.scan_cache.max_bytes,
                "hits": self.scan_cache.hits,
                "misses": self.scan_cache.misses,
            },
            "encoded_cache": self.encoded_cache.stats(),
            "pipeline": {
                "enabled": self.pipeline_on(),
                "depth": self.config.scan.pipeline.depth,
                "inflight_bytes": self.config.scan.pipeline.inflight_bytes,
                "high_water_bytes": self._pipeline_high_water,
            },
            "stack_cache": {
                "entries": len(self._stack_cache),
                "bytes": self._stack_cache_bytes,
                "max_bytes": self._stack_cache_max,
                "hits": self._stack_cache_hits,
                "misses": self._stack_cache_misses,
            },
        }

    # ---- plan construction -------------------------------------------------

    def build_plan(self, ssts: list[SstFile], request: ScanRequest,
                   keep_builtin: bool = False, use_cache: bool = True,
                   pool: str = "sst") -> ScanPlan:
        columns = plan_columns(self.schema, request.projections)
        by_segment: dict[int, list[SstFile]] = {}
        for f in ssts:
            by_segment.setdefault(
                segment_of(f, self.segment_duration_ms), []).append(f)
        segments = [
            SegmentPlan(segment_start=seg,
                        ssts=sorted(files, key=lambda f: f.id),
                        columns=columns)
            for seg, files in sorted(by_segment.items())
        ]
        pushdown = None
        pushdown_key = ""
        allowed = set(self.schema.primary_key_names)
        if request.predicate is not None:
            pushdown, pushdown_key = filter_ops.to_arrow_expression_with_key(
                request.predicate, allowed)
        prune_leaves, pushed_complete = parquet_io.conjunct_leaves_ex(
            request.predicate, allowed)
        return ScanPlan(segments=segments, mode=self.schema.update_mode,
                        predicate=request.predicate,
                        keep_builtin=keep_builtin, pushdown=pushdown,
                        pushdown_key=pushdown_key,
                        prune_leaves=prune_leaves,
                        pushed_complete=pushed_complete,
                        range=request.range, use_cache=use_cache,
                        pool=pool)

    # ---- row scans ---------------------------------------------------------

    async def execute(self, plan: ScanPlan) -> AsyncIterator[pa.RecordBatch]:
        """Row scan: one Arrow batch per non-empty merge window, in
        segment order."""
        seg_iter = self.execute_segments(plan)
        try:
            async for _seg_start, batch in seg_iter:
                if batch is not None:
                    yield batch
        finally:
            await seg_iter.aclose()

    async def execute_segments(self, plan: ScanPlan):
        """Row scan with segment attribution: (segment_start, batch) per
        non-empty merge window, then (segment_start, None) once the
        segment is complete — the unit a compaction-race replan skips
        (storage.CloudObjectStorage.scan_segments).  An Append table
        merges each segment on the host through the BytesMerge operator,
        uncached (_append_segment)."""
        if plan.mode is not UpdateMode.OVERWRITE:
            feed = self._segment_feed(plan, plan.segments)
            try:
                async for seg, is_streamed, table, _read_s in feed:
                    # cooperative deadline checkpoint: an expired query
                    # aborts between segments, not after a full scan
                    deadline_checkpoint()
                    async for out in self._append_segment(
                            seg, is_streamed, table, plan):
                        yield out
            finally:
                # an abandoned consumer tears the prefetch down now
                await feed.aclose()
            return
        windows_iter = self._cached_windows(plan)
        try:
            async for seg, windows in windows_iter:
                for w in windows:
                    # per-window deadline checkpoint (the merge loop's
                    # cooperative cancellation point)
                    deadline_checkpoint()
                    part = await self._run_pool(
                        self._window_to_arrow, w,
                        list(seg.columns), plan, pool=plan.pool)
                    if part is not None and part.num_rows:
                        part = self._strip_builtin(part, plan)
                        _ROWS_SCANNED.inc(part.num_rows)
                        yield seg.segment_start, part
                yield seg.segment_start, None
        finally:
            await windows_iter.aclose()

    async def _append_segment(self, seg: SegmentPlan, is_streamed: bool,
                              table, plan: ScanPlan):
        """One Append-mode segment's host merge, streamed or bulk.
        Yields (segment_start, batch) parts, then the completion
        marker.  A streamed segment merges window by window, so the
        host bound holds for Append tables too."""
        if is_streamed:
            async for batch in self._stream_window_batches(
                    seg, plan, strict_no_replay=True):
                deadline_checkpoint()
                part = await self._run_pool(
                    self._merge_segment_table,
                    pa.Table.from_batches([batch]), plan, pool=plan.pool)
                if part is not None and part.num_rows:
                    _ROWS_SCANNED.inc(part.num_rows)
                    yield seg.segment_start, part
            yield seg.segment_start, None
            return
        batch = await self._run_pool(self._merge_segment_table, table,
                                     plan, pool=plan.pool)
        if batch is not None and batch.num_rows:
            _ROWS_SCANNED.inc(batch.num_rows)
            yield seg.segment_start, batch
        yield seg.segment_start, None

    def _merge_segment_table(self, table: pa.Table,
                             plan: ScanPlan) -> Optional[pa.RecordBatch]:
        """Host (Append/BytesMerge) merge of one segment's table, cut
        into the same PK-range windows as the Overwrite path when the
        segment exceeds the window budget (the sort stays bounded)."""
        if table.num_rows == 0:
            return None
        batch = table.combine_chunks().to_batches()[0]
        window = self.config.scan.max_window_rows
        if batch.num_rows <= window:
            return self._strip_builtin(self._merge_on_host(batch, plan),
                                       plan)
        pk1 = batch.column(batch.schema.names.index(
            self._pk_names_in(batch.schema.names)[0]))
        # dense value-order ranks straight from Arrow (the comparator the
        # merge sort uses); cross-window order then follows value order
        ranks = np.asarray(pa.compute.rank(pk1, sort_keys="ascending",
                                           tiebreaker="dense"))
        parts = []
        for sel in _plan_pk_windows(ranks, window):
            part = self._merge_on_host(batch.take(pa.array(sel)), plan)
            if part is not None and part.num_rows:
                parts.append(part)
        if not parts:
            return None
        merged = (parts[0] if len(parts) == 1 else pa.Table.from_batches(
            parts).combine_chunks().to_batches()[0])
        return self._strip_builtin(merged, plan)

    def _merge_on_host(self, batch: pa.RecordBatch,
                       plan: ScanPlan) -> pa.RecordBatch:
        """Sort by (PK, __seq__) and apply the table's merge operator;
        the full predicate applies after the merge unless the read
        already applied all of it."""
        from horaedb_tpu_torch.storage.operator import build_operator

        pk_names = self._pk_names_in(batch.schema.names)
        sort_keys = [(n, "ascending") for n in pk_names + [SEQ_COLUMN_NAME]]
        batch = batch.take(pa.compute.sort_indices(batch,
                                                   sort_keys=sort_keys))
        names = batch.schema.names
        value_idxes = [names.index(n) for n in names
                       if n not in pk_names and n != SEQ_COLUMN_NAME]
        op = build_operator(plan.mode, value_idxes)
        # explicit indices: a projection may have reordered columns
        merged = op.merge_sorted_batch(
            batch, pk_indices=[names.index(n) for n in pk_names])
        if plan.predicate is not None and not plan.pushed_complete:
            mask = _eval_predicate_host(plan.predicate, merged)
            merged = merged.filter(pa.array(mask))
        return merged

    def _window_to_arrow(self, w: encode.DeviceBatch, names: list[str],
                         plan: ScanPlan) -> Optional[pa.RecordBatch]:
        # Predicates apply AFTER dedup: filtering before would break
        # last-value semantics when the predicate touches value columns
        # (a filtered-out newer row must still shadow an older row)
        arrow = encode.decode_to_arrow(w, names=names)
        if plan.predicate is not None and not plan.pushed_complete:
            mask = filter_ops.eval_predicate(plan.predicate, w)
            arrow = arrow.take(pa.array(np.flatnonzero(mask[:w.n_valid])))
        return arrow

    def _strip_builtin(self, batch: pa.RecordBatch,
                       plan: ScanPlan) -> pa.RecordBatch:
        if plan.keep_builtin:
            return batch
        keep = [c for c in batch.schema.names
                if not self.schema.is_builtin_name(c)]
        return batch.select(keep)

    # ---- segment windows ---------------------------------------------------

    def _cache_key(self, seg: SegmentPlan, plan: ScanPlan):
        # the canonical key of the PUSHED subtree is part of the cached
        # merge output's identity: a pushdown changes which rows were
        # read before the merge
        return segment_cache_key(
            seg.segment_start, (f.id for f in seg.ssts),
            tuple(seg.columns) + (plan.pushdown_key,))

    async def _cached_windows(self, plan: ScanPlan):
        """Per segment, in plan order, yield (seg, post-merge windows) —
        from the scan cache when the segment's (SST set, columns,
        pushdown) is unchanged, else by reading and merging it and
        populating the cache.  The reads run through the pipeline
        (storage/pipeline.py) when it is on and the scan has store I/O
        to hide, else through the sequential pump; both give the same
        windows.  A plan with use_cache False neither reads nor fills
        the cache."""
        cached: dict[int, list] = {}
        to_read: list[SegmentPlan] = []
        for seg in plan.segments:
            windows = (self.scan_cache.get(self._cache_key(seg, plan))
                       if plan.use_cache else None)
            if windows is None:
                to_read.append(seg)
            else:
                cached[id(seg)] = windows
        plan.pipeline_active = (self.pipeline_on()
                                and self._pipeline_has_io(plan, to_read))
        if plan.pipeline_active:
            inner = self._cached_windows_pipelined(plan, cached, to_read)
        else:
            inner = self._cached_windows_pump(plan, cached, to_read)
        try:
            async for out in inner:
                yield out
        finally:
            await inner.aclose()

    async def _cached_windows_pump(self, plan: ScanPlan, cached: dict,
                                   to_read: list):
        """The sequential pump: segment reads prefetched up to
        `prefetch_segments` ahead (_segment_feed), each segment merged
        in plan order on the pool, one at a time."""
        feed = self._segment_feed(plan, to_read)
        try:
            for seg in plan.segments:
                # cooperative deadline checkpoint between segments: a
                # query that ran out of budget stops reading/merging
                # instead of finishing a doomed scan
                deadline_checkpoint()
                if id(seg) in cached:
                    yield seg, cached[id(seg)]
                    continue
                read_seg, is_streamed, table, _read_s = \
                    await feed.__anext__()
                ensure(read_seg is seg, "segment feed out of plan order")
                if is_streamed:
                    windows, _read_s = await self._read_streamed_windows(
                        seg, plan)
                elif table.num_rows:
                    windows = await self._run_pool(
                        self._merge_segment, table, plan, pool=plan.pool)
                else:
                    windows = []
                del table
                if plan.use_cache and _cacheable_windows(windows):
                    self.scan_cache.put(self._cache_key(seg, plan), windows)
                yield seg, windows
        finally:
            await feed.aclose()

    def pipeline_on(self) -> bool:
        """Whether cold scans run through the bounded producer/consumer
        pipeline (storage/pipeline.py); [scan.pipeline] enabled = false
        keeps the sequential pump."""
        return self.config.scan.pipeline.enabled

    def _pipeline_has_io(self, plan: ScanPlan, to_read: list) -> bool:
        """Whether pipelining this scan can pay for itself: the pipeline
        hides object-store latency behind decode and device work, so a
        scan whose every bulk segment is already tier-2 resident (zero
        store I/O — the post-flush / warm-tier regime) runs the
        sequential pump instead, where the stages' concurrency would
        only contend for the same host cores.  Streamed segments read
        the store incrementally and any non-resident bulk segment
        fetches it, so either makes the pipeline worthwhile.  The probe
        is the cache's stats-free peek: it bumps no LRU recency and no
        hit/miss counter (the reads that follow do)."""
        if not self._sidecar_plan_ok(plan):
            return bool(to_read)  # every read is a store read
        leaf_cols = {lf.column for lf in plan.prune_leaves or []}

        def resident(seg: SegmentPlan) -> bool:
            if self.encoded_cache.is_assembly_failed(
                    frozenset(f.id for f in seg.ssts)):
                return False
            want = set(seg.columns) | leaf_cols
            return all(self.encoded_cache.peek(f.id, want)
                       for f in seg.ssts)

        return any(self._stream_segment(seg) or not resident(seg)
                   for seg in to_read)

    async def _cached_windows_pipelined(self, plan: ScanPlan,
                                        cached: dict, to_read: list):
        """Pipelined twin of the pump: fetch and decode run as
        background stages (storage/pipeline.py) while this consumer —
        the device stage's doorstep — yields segments in plan order.
        Same windows, same cache puts, same error positions; only the
        schedule differs."""
        from horaedb_tpu_torch.storage.pipeline import ScanPipeline

        pipe = ScanPipeline(self, plan, to_read)
        try:
            for seg in plan.segments:
                # cooperative deadline checkpoint between segments, same
                # position as the pump's
                deadline_checkpoint()
                if id(seg) in cached:
                    yield seg, cached[id(seg)]
                    continue
                got, windows, _read_s = await pipe.next_segment()
                ensure(got is seg, "scan pipeline out of plan order")
                if plan.use_cache and _cacheable_windows(windows):
                    self.scan_cache.put(self._cache_key(seg, plan), windows)
                yield seg, windows
        finally:
            # deterministic teardown: cancels the stage tasks and AWAITS
            # them, draining any in-flight pool job before the caller
            # proceeds to table/engine teardown
            await pipe.aclose()

    async def _segment_feed(self, plan: ScanPlan,
                            segments: list[SegmentPlan]):
        """The streamed/bulk split: yields (seg, is_streamed,
        table_or_None, read_s) in segment order.  The bulk prefetch is
        primed at once so store reads overlap any streamed segment
        processed before them."""
        streamed = {id(s) for s in segments if self._stream_segment(s)}
        bulk = [s for s in segments if id(s) not in streamed]
        read_iter = self._prefetch_tables(bulk, plan).__aiter__()
        primed: Optional[asyncio.Task] = (
            asyncio.ensure_future(read_iter.__anext__()) if bulk else None)
        try:
            for seg in segments:
                if id(seg) in streamed:
                    yield seg, True, None, 0.0
                    continue
                if primed is not None:
                    step, primed = primed, None
                    read_seg, table, read_s = await step
                else:
                    read_seg, table, read_s = await read_iter.__anext__()
                ensure(read_seg is seg, "segment prefetch out of order")
                yield seg, False, table, read_s
        finally:
            if primed is not None:
                primed.cancel()
                await asyncio.gather(primed, return_exceptions=True)
            # deterministic teardown of the prefetch generator: its read
            # tasks must be cancelled NOW, not at GC-time finalization
            await read_iter.aclose()

    async def _prefetch_tables(self, segments: list[SegmentPlan],
                               plan: ScanPlan):
        """Bounded segment prefetch: store reads overlap downstream work
        while at most scan.prefetch_segments tables are in memory (the
        permit is released only after the consumer is done with a
        segment).  Yields (segment, table, read_seconds)."""
        sem = asyncio.Semaphore(max(1, self.config.scan.prefetch_segments))

        async def read(seg: SegmentPlan):
            await sem.acquire()
            return await self._read_segment_any(seg, plan)

        tasks = [asyncio.create_task(read(seg)) for seg in segments]
        try:
            for seg, task in zip(segments, tasks):
                table, read_s = await task
                try:
                    yield seg, table, read_s
                finally:
                    sem.release()
        finally:
            for task in tasks:
                task.cancel()
            # drain, don't just cancel: a read whose pool job is
            # mid-flight only finishes after the job does, and failed
            # reads' exceptions are retrieved here
            await asyncio.gather(*tasks, return_exceptions=True)

    async def _run_pool(self, fn, *args, pool: str = "sst"):
        """CPU work (parquet codec, host merge, numpy prep, device
        dispatch) runs on a worker pool (`sst` unless the plan names
        another), never on the event loop (ref: dedicated runtimes,
        storage.rs:91-104)."""
        return await parquet_io._run(self.runtimes, pool, fn, *args)

    async def _read_segment_any(self, seg: SegmentPlan, plan: ScanPlan,
                                runner=None):
        """One bulk segment's cold read — tier 2 and the sidecars serve
        it, with only the missing SSTs fetched; parquet when any SST's
        sidecar is missing or invalid (a data-format choice, not a
        device fallback) — with its stage attribution.  Returns (table,
        read_seconds); `table` is a pa.Table or an EncodedSegment.
        Shared by the pump's prefetch and the pipeline's fetch stage,
        which bounds the CPU-side deserialize concurrency via
        `runner`."""
        t0 = time.perf_counter()
        table = None
        stage = "sidecar_read"
        if self._sidecar_plan_ok(plan):
            table = await self._read_segment_encoded(seg, plan,
                                                     runner=runner)
        if table is None:
            stage = "parquet_read"
            table = await self._read_segment_table(seg, plan)
        read_s = time.perf_counter() - t0
        _observe_stage("segment_read", read_s)
        _STAGE_ROWS[stage].inc(table.num_rows)
        _STAGE_BYTES[stage].inc(table.nbytes)
        trace_add(f"stage_{stage}_rows", table.num_rows)
        trace_add(f"stage_{stage}_bytes", table.nbytes)
        # tenant scan-byte budget: charged where the stage bytes are
        # attributed, observed at the deadline checkpoints
        charge_scan_bytes(table.nbytes)
        return table, read_s

    def _sidecar_plan_ok(self, plan: ScanPlan) -> bool:
        """Sidecars serve an OVERWRITE plan whose pushdown (when
        present) has a leaf conjunction the host can evaluate in encoded
        space."""
        if not self.config.scan.use_sidecar:
            return False
        if plan.mode is not UpdateMode.OVERWRITE:
            return False  # Append's BytesMerge needs exact Arrow bytes
        return plan.pushdown is None or plan.prune_leaves is not None

    def _resident_segment_parts(self, seg: SegmentPlan,
                                plan: ScanPlan) -> Optional[list]:
        """Event-loop-side tier-2 residency probe: every SST's encoded
        part for this plan's column set, straight from the cache — or
        None when any part is missing (or a negative memo says the
        sidecar path is doomed), in which case the full fetch path
        decides between store reads and parquet.  The pipeline's fetch
        stage uses it so all-resident segments read nothing."""
        if not self._sidecar_plan_ok(plan):
            return None
        if any(self.encoded_cache.is_missing(f.id) for f in seg.ssts):
            return None
        if self.encoded_cache.is_assembly_failed(
                frozenset(f.id for f in seg.ssts)):
            return None
        want = set(seg.columns) | {lf.column
                                   for lf in plan.prune_leaves or []}
        parts = []
        for f in seg.ssts:
            part = self.encoded_cache.get(f.id, want)
            if part is None:
                return None
            parts.append(part)
        return parts

    def _assemble_resident_segment(self, seg: SegmentPlan, parts: list,
                                   plan: ScanPlan
                                   ) -> Optional[sidecar.EncodedSegment]:
        """Pool-side assemble of tier-2-resident parts with the stage
        attribution the fetch path gives an assembled segment.  None =
        assembly failed (the CALLER memoizes the composition on the
        event loop and falls back to parquet — the cache's negative
        memos are loop-owned)."""
        t0 = time.perf_counter()
        defer = plan.decode_spec is not None
        try:
            es = sidecar.assemble_parts(
                parts, list(seg.columns),
                None if defer else plan.prune_leaves)
        except Exception as exc:  # noqa: BLE001 — cache read only
            logger.warning("sidecar assembly raised for segment %s: %s",
                           seg.segment_start, exc)
            es = None
        if es is None:
            return None
        if defer:
            es.pending_leaves = list(plan.prune_leaves or [])
        _observe_stage("segment_read", time.perf_counter() - t0)
        _STAGE_ROWS["sidecar_read"].inc(es.n)
        _STAGE_BYTES["sidecar_read"].inc(es.nbytes)
        trace_add("stage_sidecar_read_rows", es.n)
        trace_add("stage_sidecar_read_bytes", es.nbytes)
        charge_scan_bytes(es.nbytes)
        return es

    async def _read_segment_encoded(self, seg: SegmentPlan, plan: ScanPlan,
                                    runner=None
                                    ) -> Optional[sidecar.EncodedSegment]:
        """Segment read that never touches parquet: serve each SST's
        encoded part from tier 2 when resident, fetch only the missing
        SSTs' sidecars (block-pruned under selective leaves), and
        assemble filtered, concatenated encoded columns.  After a flush
        (one new small SST in an otherwise unchanged segment) only that
        SST crosses the wire — and with write-through admission not even
        that.  None (-> parquet) when any SST lacks a valid sidecar.
        `runner` overrides the pool dispatch of the CPU-bound
        deserialize/assemble steps."""
        if any(self.encoded_cache.is_missing(f.id) for f in seg.ssts):
            return None  # known-missing sidecar: skip the GETs entirely
        seg_ids = frozenset(f.id for f in seg.ssts)
        if self.encoded_cache.is_assembly_failed(seg_ids):
            return None  # this exact composition is known unassemblable
        leaves = plan.prune_leaves
        want = set(seg.columns) | {lf.column for lf in leaves or []}

        if runner is None:
            def runner(fn, *args):  # CPU-bound deserialize off the loop
                return self._run_pool(fn, *args, pool=plan.pool)

        parts: list = [None] * len(seg.ssts)
        fetch: list[tuple[int, SstFile]] = []
        for i, f in enumerate(seg.ssts):
            part = self.encoded_cache.get(f.id, want)
            if part is None:
                fetch.append((i, f))
            else:
                parts[i] = part
        if fetch and len(fetch) < len(seg.ssts):
            _INCR_REMERGE.inc()
        # per-SST GETs overlap WITHIN the segment (one gather), and the
        # prefetch or the pipeline overlaps segments on top
        got = await asyncio.gather(*(
            sidecar.load_sst_encoded(
                self.store, sidecar.sidecar_path(self.root_path, f.id),
                want, leaves, runner=runner)
            for _i, f in fetch), return_exceptions=True)
        for (i, f), res in zip(fetch, got):
            if isinstance(res, NotFoundError):
                # permanent for this id (ids are immutable and the
                # sidecar is written before the SST becomes visible)
                self.encoded_cache.mark_missing(f.id)
                return None
            if isinstance(res, BaseException):
                # transient store failure: the sidecar is a cache — the
                # parquet read is authoritative
                logger.warning("sidecar fetch failed for sst %s: %s",
                               f.id, res)
                return None
            if res is None:
                self.encoded_cache.mark_missing(f.id)
                logger.warning("invalid sidecar for sst %s; using "
                               "parquet", f.id)
                return None
            parts[i] = res
            # only COMPLETE parts are cacheable: a block-pruned load
            # returned a row subset tied to this plan's leaves
            if res[1] == f.meta.num_rows:
                self.encoded_cache.put(f.id, res[0], res[1])
        # a device-decode plan DEFERS the exact leaf mask: the card
        # evaluates the conjunction in encoded space, so the host never
        # pays the mask and the per-column compaction (a per-segment
        # fallback resolves the pending leaves on the host)
        defer = plan.decode_spec is not None
        try:
            es = await runner(sidecar.assemble_parts, parts,
                              list(seg.columns), None if defer else leaves)
        except Exception as exc:  # noqa: BLE001 — cache read only
            logger.warning("sidecar assembly raised for segment %s: %s",
                           seg.segment_start, exc)
            es = None
        if es is not None and defer:
            es.pending_leaves = list(leaves or [])
        if es is None:
            # cross-SST assembly failed: memoize the COMPOSITION, never
            # the member SSTs (each part deserialized fine, and the same
            # ids may assemble in another composition)
            self.encoded_cache.mark_assembly_failed(seg_ids)
            logger.warning("sidecar assembly failed for segment %s; "
                           "using parquet", seg.segment_start)
        return es

    async def _read_segment_table(self, seg: SegmentPlan,
                                  plan: ScanPlan) -> pa.Table:
        tables = await asyncio.gather(*(
            parquet_io.read_sst(self.store, sst_path(self.root_path, f.id),
                                columns=seg.columns, filters=plan.pushdown,
                                runtimes=self.runtimes, pool=plan.pool,
                                leaves=plan.prune_leaves,
                                # the manifest's size: big SSTs on remote
                                # stores stream into a file-backed mmap
                                size_hint=f.meta.size)
            for f in seg.ssts))
        return pa.concat_tables(tables)

    # ---- streamed segments -------------------------------------------------

    def _stream_segment(self, seg: SegmentPlan) -> bool:
        """True when this segment is read window by window instead of
        whole: manifest row count over the row threshold, OR stored
        byte size over the byte threshold — a wide-schema segment can
        be host-RAM-huge long before it reaches the row knob."""
        row_thresh = self.config.scan.stream_read_min_rows
        if row_thresh <= 0:
            return False  # 0 disables streaming entirely
        rows = sum(f.meta.num_rows for f in seg.ssts)
        if rows <= self.config.scan.max_window_rows:
            # everything fits one window: streaming would pay the
            # planning pass and still materialize the same window
            return False
        if rows > row_thresh:
            return True
        byte_thresh = self.config.scan.stream_read_min_bytes
        return byte_thresh > 0 and sum(
            f.meta.size for f in seg.ssts) > byte_thresh

    async def _read_streamed_windows(self, seg: SegmentPlan,
                                     plan: ScanPlan):
        """One streamed segment's windows: the sidecar stream first, the
        parquet two-pass streamer when a sidecar can't serve it.
        Returns (windows, read_seconds) — shared by the sequential pump
        and the pipeline's decode stage, so the two cannot drift."""
        t0 = time.perf_counter()
        es_iter = await self._open_sidecar_stream(seg, plan)
        if es_iter is not None:
            windows: list = []
            try:
                while True:
                    try:
                        es = await es_iter.__anext__()
                    except StopAsyncIteration:
                        return windows, time.perf_counter() - t0
                    except Exception as exc:  # noqa: BLE001 — the stream's
                        # reads only (a merge or kernel failure below is
                        # never caught): nothing of this segment has been
                        # yielded yet, so a whole-segment parquet read
                        # is clean
                        logger.warning(
                            "sidecar stream failed for segment %s (%s); "
                            "falling back to parquet", seg.segment_start,
                            exc)
                        break
                    windows.extend(await self._run_pool(
                        self._merge_segment, es, plan, pool=plan.pool))
            finally:
                await es_iter.aclose()
        windows = []
        async for batch in self._stream_window_batches(seg, plan):
            windows.extend(await self._run_pool(
                self._merge_batch, batch, pool=plan.pool))
        return windows, time.perf_counter() - t0

    async def _open_sidecar_stream(self, seg: SegmentPlan, plan: ScanPlan):
        """Streamed-segment windows straight from sidecars: PK
        value-range windows planned from per-block stats, each window
        loaded through the pruned loader with synthetic range leaves
        (sidecar.SstStreamSession / plan_stream_windows) — no parquet
        two-pass, no Arrow.  Returns an async generator of
        EncodedSegments, or None when any SST lacks a plannable sidecar
        (the parquet streamer serves the segment instead)."""
        if not self._sidecar_plan_ok(plan):
            return None
        if any(self.encoded_cache.is_missing(f.id) for f in seg.ssts):
            return None
        leaves = plan.prune_leaves or []
        want = set(seg.columns) | {lf.column for lf in leaves}

        def runner(fn, *args):
            return self._run_pool(fn, *args, pool=plan.pool)

        got = await asyncio.gather(*(
            sidecar.SstStreamSession.open(
                self.store, sidecar.sidecar_path(self.root_path, f.id),
                want, runner=runner)
            for f in seg.ssts), return_exceptions=True)
        sessions = []
        for f, res in zip(seg.ssts, got):
            if isinstance(res, NotFoundError) or res is None:
                # permanent per immutable id — the bulk path's memo
                self.encoded_cache.mark_missing(f.id)
                return None
            if isinstance(res, BaseException):
                logger.warning("sidecar stream open failed for sst "
                               "%s: %s", f.id, res)
                return None
            sessions.append(res)
        planned = await sidecar.plan_stream_windows(
            sessions, self._pk_names_in(list(seg.columns)),
            self.config.scan.max_window_rows)
        if planned is None:
            return None
        part_col, ranges = planned

        async def gen():
            rows = nbytes = 0
            for lo, hi in ranges:
                wleaves = list(leaves)
                if lo is not None:
                    wleaves.append(filter_ops.Ge(part_col, lo))
                if hi is not None:
                    wleaves.append(filter_ops.Lt(part_col, hi))
                parts = await asyncio.gather(*(
                    s.load_window(wleaves) for s in sessions))
                if any(p is None for p in parts):
                    raise Error("sidecar stream window failed")
                # a device-decode plan defers the exact window mask to
                # the dispatch — the synthetic range leaves keep windows
                # exactly disjoint there, as the host mask does
                defer = plan.decode_spec is not None
                es = await self._run_pool(
                    sidecar.assemble_parts, list(parts), list(seg.columns),
                    None if defer else wleaves, pool=plan.pool)
                if es is None:
                    raise Error("sidecar stream assembly failed")
                if defer:
                    es.pending_leaves = list(wleaves)
                if es.n:
                    rows += es.n
                    nbytes += es.nbytes
                    yield es
            # counters commit only on a COMPLETE stream: a mid-stream
            # failure re-serves the segment via parquet, which would
            # otherwise count the yielded windows twice
            _STAGE_ROWS["sidecar_read"].inc(rows)
            _STAGE_BYTES["sidecar_read"].inc(nbytes)
            trace_add("stage_sidecar_read_rows", rows)
            trace_add("stage_sidecar_read_bytes", nbytes)
            charge_scan_bytes(nbytes)

        return gen()

    async def _stream_window_batches(self, seg: SegmentPlan,
                                     plan: ScanPlan,
                                     strict_no_replay: bool = False):
        """The parquet streamer (the reference's pull-based batch
        streaming, read.rs:346-385, re-shaped for windows): pass 1 scans
        ONE PK column's values to plan value-range windows of <=
        max_window_rows; pass 2 reads each window's rows via parquet
        predicate pushdown.  Host materialization is bounded by the
        window budget, not the segment size.  Yields one Arrow batch
        per window, PK-range ascending, each encoded WINDOW-LOCALLY
        downstream.

        A compaction that deletes an input mid-segment: the segment's
        current SSTs are resolved again (resolve_segment_ssts; the
        compacted output holds the same rows) and the remaining value
        ranges, which partition rows independently of file boundaries,
        read from them.  After three failed attempts the NotFoundError
        goes to the caller's replan — unless `strict_no_replay` and a
        window was already yielded: an Append consumer has emitted it
        downstream, so a replan would duplicate rows, and the read
        fails with a non-retryable Error instead."""
        import pyarrow.compute as pc

        # one source per SST: local stores mmap, remote stores download
        # the object ONCE and serve both passes and every window from it
        sources = await asyncio.gather(*(
            parquet_io.open_sst_source(self.store,
                                       sst_path(self.root_path, f.id))
            for f in seg.ssts))

        pk_names = self._pk_names_in(seg.columns)
        values = counts = None
        part_col = pk_names[-1]
        for nm in pk_names:
            per_sst = await asyncio.gather(*(
                self._run_pool(src.value_counts, nm, pool=plan.pool)
                for src in sources))
            values, counts = parquet_io.merge_value_counts(per_sst)
            if len(values) == 0:
                return  # segment is empty
            if len(values) > 1:
                part_col = nm
                break
            # constant column: windowing on it cannot bound anything
        window = self.config.scan.max_window_rows
        ranges: list[tuple] = []
        start = acc = 0
        for i, c in enumerate(counts):
            if acc and acc + int(c) > window:
                ranges.append((values[start], values[i - 1]))
                start, acc = i, 0
            acc += int(c)
        if acc:
            ranges.append((values[start], values[-1]))

        def pyval(x):
            return x.item() if hasattr(x, "item") else x

        yielded_any = False
        for lo, hi in ranges:
            # streamed segments can span many windows: check the
            # deadline before paying for each window's pushdown read
            deadline_checkpoint()
            expr = (pc.field(part_col) >= pyval(lo)) \
                & (pc.field(part_col) <= pyval(hi))
            if plan.pushdown is not None:
                expr = expr & plan.pushdown
            refresh = False
            for attempt in range(3):
                try:
                    if refresh:
                        # re-resolution and re-open can race a second
                        # deletion: inside the try, they consume an
                        # attempt too
                        fresh = await self.resolve_segment_ssts(
                            seg.segment_start, plan.range)
                        sources = await asyncio.gather(*(
                            parquet_io.open_sst_source(
                                self.store, sst_path(self.root_path, f.id))
                            for f in fresh))
                        refresh = False
                    if not sources:
                        return  # the whole segment vanished (TTL GC)
                    tables = await asyncio.gather(*(
                        self._run_pool(functools.partial(
                            src.read, columns=seg.columns, filters=expr),
                            pool=plan.pool)
                        for src in sources))
                    break
                except NotFoundError:
                    if self.resolve_segment_ssts is None or attempt == 2:
                        if strict_no_replay and yielded_any:
                            raise Error(
                                f"streamed segment {seg.segment_start} "
                                "lost its SSTs mid-stream after retries; "
                                "failing rather than duplicating "
                                "already-emitted rows")
                        raise
                    refresh = True
            tbl = pa.concat_tables(tables)
            if tbl.num_rows:
                yielded_any = True
                yield tbl.combine_chunks().to_batches()[0]

    def _pk_names_in(self, columns: list[str]) -> list[str]:
        """PK names present, in SCHEMA order — the merge must sort by the
        declared key order even when a projection reordered columns."""
        present = set(columns)
        return [n for n in self.schema.primary_key_names if n in present]

    def _merge_segment(self, table, plan: Optional[ScanPlan] = None
                       ) -> list:
        """Pool-side encode + host merge of one segment's read result
        (pa.Table or sidecar.EncodedSegment) into post-merge windows.

        A plan routed to the device decode (plan.decode_spec set) sends
        an EncodedSegment through the dispatch instead: [DevicePart],
        the segment's finished aggregate partial.  A segment the
        dispatch declines takes the host merge with its reason counted,
        its deferred leaves applied first; a parquet segment of such a
        plan counts "parquet"."""
        decode = plan is not None and plan.decode_spec is not None
        if isinstance(table, sidecar.EncodedSegment):
            if decode:
                part = self._dispatch_device_decode(table, plan)
                if part is not None:
                    return [part]
            table = sidecar.apply_leaves_host(table)
        elif decode:
            device_decode.note_fallback("parquet")
        if not isinstance(table, sidecar.EncodedSegment):
            if table.num_rows == 0:
                return []
            return self._merge_batch(table.combine_chunks().to_batches()[0])
        t0 = time.perf_counter()
        try:
            return self._merge_windows(_encoded_to_device_batch(table),
                                       list(table.names))
        finally:
            _observe_stage("merge", time.perf_counter() - t0)

    def _merge_batch(self, batch: pa.RecordBatch) -> list:
        """Encode + host merge of one Arrow batch (a parquet segment, or
        one window of the parquet streamer)."""
        t0 = time.perf_counter()
        try:
            return self._merge_windows(encode.encode_batch(batch),
                                       list(batch.schema.names))
        finally:
            _observe_stage("merge", time.perf_counter() - t0)

    def _dispatch_device_decode(self, es: sidecar.EncodedSegment,
                                plan: ScanPlan
                                ) -> Optional[device_decode.DevicePart]:
        """One EncodedSegment through the device decode, finished; None
        (the reason counted) when its layout can't ride it."""
        spec = plan.decode_spec
        got = device_decode.prepare_dispatch(
            es, spec, pk_names=self._pk_names_in(list(es.names)),
            seq_name=SEQ_COLUMN_NAME, leaves=es.pending_leaves or [],
            max_bytes=self.config.scan.decode.max_upload_bytes,
            width=self._window_grid_width(spec),
            pad_capacity=encode.pad_capacity, device=self.device)
        if isinstance(got, str):
            device_decode.note_fallback(got)
            return None
        return got

    def _merge_windows(self, dev: encode.DeviceBatch, names: list) -> list:
        """The host merge (the JAX package's default host_perm layout):
        plan the k-way-merge permutation over the pre-sorted SST runs,
        keep the last row of each PK run, and hand out HOST-resident,
        padded windows of at most max_window_rows (PK-range partitions,
        so every equal-PK run lands in exactly one window)."""
        pk_names = self._pk_names_in(names)
        ensure(len(pk_names) == self.schema.num_primary_keys,
               "projection lost primary key columns")
        n = dev.n_valid
        if n == 0:
            return []
        host_cols = {name: np.asarray(c)[:n]
                     for name, c in dev.columns.items()}

        # sort-operand elision: PK columns constant across the segment
        # cannot affect the order
        def is_const(a: np.ndarray) -> bool:
            return len(a) == 0 or (a[0] == a[-1]
                                   and bool((a == a[0]).all()))

        sort_pk_names = [nm for nm in pk_names
                         if not is_const(host_cols[nm])] or pk_names[:1]
        seq_h = host_cols[SEQ_COLUMN_NAME]
        seq_ordered = bool(np.all(seq_h[1:] >= seq_h[:-1]))
        window = self.config.scan.max_window_rows
        if n <= window:
            selections: list = [None]
        else:
            selections = _plan_pk_windows(host_cols[sort_pk_names[0]],
                                          window)
        return [encode.DeviceBatch(columns=cols, encodings=enc, n_valid=k,
                                   capacity=cap)
                for cols, k, cap, enc in _host_merge_window_descs(
                    dev, host_cols, sort_pk_names, seq_h, seq_ordered,
                    selections, n)]

    # ---- aggregate dispatch ------------------------------------------------

    async def execute_aggregate(self, plan: ScanPlan, spec: AggregateSpec):
        """Merge + downsample, returning (group_values, grids) combined
        across all segments and windows, by the path fused_aggregate_ok
        picks: fused grids are tensors on the reader's device (last_ts a
        host float64 array), parts grids are the combine's host float64
        arrays."""
        if self.fused_aggregate_ok(plan):
            return await self.execute_aggregate_fused(plan, spec)
        # collected per segment and folded in segment order: memo-served
        # segments yield out of plan order, and the combine fold order
        # is part of the bit-identity contract
        done: dict[int, list] = {}
        async for seg_start, seg_parts in self.aggregate_segments(plan,
                                                                  spec):
            done[seg_start] = seg_parts
        parts = [p for s in sorted(done) for p in done[s]]
        return self.finalize_aggregate(parts, spec)

    def router_covers(self, plan: ScanPlan) -> bool:
        """Whether the attached near-data router would serve any of
        this plan's segments.  scan_aggregate consults it ahead of the
        fused gate: the fused accumulator needs every segment's windows
        host-resident — exactly the shipped-segment cost the agents
        exist to avoid — so covered plans take the parts path."""
        return (self.scan_router is not None
                and plan.range is not None
                and self.scan_router.covers_any(plan.segments))

    def fused_aggregate_ok(self, plan: Optional[ScanPlan] = None) -> bool:
        """Whether the fused device-accumulated aggregate serves this
        scan (see _fused_agg_ok_base for its own gates).  An explicit
        [scan.decode] mode = "device" outranks it for decode-eligible
        plans: the fused accumulator pays host decode for every window,
        the wall the device decode removes.  HORAEDB_FUSED_AGG=1 still
        wins."""
        if not self._fused_agg_ok_base(plan):
            return False
        if os.environ.get("HORAEDB_FUSED_AGG", "") == "1":
            return True
        return not (plan is not None and self._decode_mode() == "device"
                    and self._device_decode_plan_ok(plan, count=False))

    def _fused_agg_ok_base(self, plan: Optional[ScanPlan] = None) -> bool:
        """The fused aggregate's own gate.  The fused path is two-phase
        (all windows are collected before the union group space is
        known), so unlike the parts path it pins every window in host
        RAM for the query: a plan
        whose estimated rows x _CACHE_BYTES_PER_ROW exceed the scan
        cache budget takes the parts path.  HORAEDB_FUSED_AGG=1/0
        forces the fused path on/off, the budget included.

        The JAX package also declines on its XLA-CPU backend, where
        downloads are free and scatters slow.  That clause encodes
        XLA-CPU economics; the port's device="cpu" is a test mode, so
        it has no such clause and its CPU tests keep the fused path."""
        if plan is not None and plan.parts_route:
            return False
        forced = os.environ.get("HORAEDB_FUSED_AGG", "")
        if forced == "1":
            return True
        if forced == "0":
            return False
        if plan is not None:
            est_rows = sum(f.meta.num_rows
                           for seg in plan.segments for f in seg.ssts)
            if est_rows * _CACHE_BYTES_PER_ROW > self.cache_budget_bytes:
                return False
        return True

    def _decode_mode(self) -> str:
        """The [scan.decode] mode in force: HORAEDB_DEVICE_DECODE=1/0
        forces device/host over the config."""
        forced = os.environ.get("HORAEDB_DEVICE_DECODE", "")
        if forced == "1":
            return "device"
        if forced == "0":
            return "host"
        return self.config.scan.decode.mode

    def _device_decode_plan_ok(self, plan: ScanPlan,
                               count: bool = True) -> bool:
        """Plan-level gate of the device decode (ops/device_decode.py).
        Declines are counted in scan_decode_fallback_total:<reason>
        unless `count` is False (the fused gate probes without counting).

        "auto" engages on a CUDA reader for plans the fused aggregate
        declines on its own terms (the oversized cold shape whose
        windows can't pin in RAM anyway); a CPU reader keeps host
        decode.  "device" forces the dispatch wherever structurally
        possible; "host" is the bit-identity control.  The per-SEGMENT
        gates (encodings, dtype, upload budget) are in plan_dispatch."""
        mode = self._decode_mode()
        note = device_decode.note_fallback if count else (lambda _r: None)
        if mode == "host":
            return False
        if mode == "auto" and (not self.on_cuda
                               or self._fused_agg_ok_base(plan)):
            return False
        if plan.mode is not UpdateMode.OVERWRITE:
            note("append_mode")
            return False
        if plan.predicate is not None and not plan.pushed_complete:
            # value-column leaves interact with last-value dedup, and
            # Or/Not shapes have no pushed conjunction: host decode
            # evaluates those after the merge.  Checked before the
            # sidecar gate, which such a predicate also fails
            note("predicate")
            return False
        if not device_decode.leaf_shape_supported(plan.prune_leaves):
            note("predicate")
            return False
        if not self._sidecar_plan_ok(plan):
            note("no_sidecar")
            return False
        return True

    # ---- the parts path ----------------------------------------------------

    async def aggregate_segments(self, plan: ScanPlan, spec: AggregateSpec,
                                 top_k=None):
        """Per segment, yield (segment_start, partial parts) — the
        retryable unit of scan_aggregate (segments already yielded are
        skipped on a replan; a segment is yielded only once ALL its
        windows are aggregated).

        Memo-served segments come first and are dropped from the scan
        plan, so a narrowed/refined range re-scans only the delta
        segments; callers fold parts in sorted segment order, so yield
        order is free.  `top_k` is accepted for the multi-device
        device-scored route, which the port does not have yet: on one
        device every part goes to finalize_aggregate, which ranks."""
        ensure(plan.mode is UpdateMode.OVERWRITE,
               "aggregate pushdown requires Overwrite mode")
        # device decode: an eligible plan threads the spec to the segment
        # reads, whose sidecar segments come back as finished DeviceParts
        # (a copy, so the caller's plan stays reusable)
        if self._device_decode_plan_ok(plan):
            plan = dc_replace(plan, decode_spec=spec)
        memo = self.parts_memo
        use_memo = memo.enabled and plan.use_cache
        seg_keys: dict[int, tuple] = {}
        memo_pred_key = ""
        if use_memo:
            memo_pred_key = filter_ops.canonical_predicate_key(
                plan.predicate)
            remaining = []
            for seg in plan.segments:
                key = self._cache_key(seg, plan)
                seg_keys[seg.segment_start] = key
                got = memo.probe(key, seg.segment_start,
                                 self.segment_duration_ms, spec,
                                 memo_pred_key)
                if got is None:
                    remaining.append(seg)
                else:
                    yield seg.segment_start, got
            if len(remaining) < len(plan.segments):
                plan = dc_replace(plan, segments=remaining)
            if not remaining:
                return

        def memo_store(seg_start: int, parts: list) -> None:
            if use_memo:
                memo.store(seg_keys[seg_start], spec, memo_pred_key,
                           parts)

        router = self.scan_router
        covered: list = []
        uncovered = plan.segments
        if (router is not None and router.active
                and plan.range is not None):
            covered, uncovered = router.split(plan.segments)
        # every pump iteration below carries an explicit aclose on
        # abandonment: the pump's in-flight fetch/decode/device tasks
        # must not outlive a closed consumer into table teardown
        if not covered:
            pump = self._aggregate_segments_pump(plan, spec, memo_store)
            try:
                async for out in pump:
                    yield out
            finally:
                await pump.aclose()
            return
        # near-data routing: agent RPCs run as one background gather
        # while the local pump scans the uncovered segments, so the
        # coordinator's store reads and the agents' shard scans overlap
        agent_task = asyncio.create_task(
            router.gather(plan, spec, covered))
        try:
            if uncovered:
                pump = self._aggregate_segments_pump(
                    dc_replace(plan, segments=list(uncovered)), spec,
                    memo_store)
                try:
                    async for out in pump:
                        yield out
                finally:
                    await pump.aclose()
            served, failed = await agent_task
            agent_task = None
        finally:
            if agent_task is not None:
                # local-pump failure/cancellation: the gather must not
                # outlive the scan into table teardown
                agent_task.cancel()
                await asyncio.gather(agent_task, return_exceptions=True)
        for seg_start, parts in served:
            memo_store(seg_start, parts)
            yield seg_start, parts
        if failed:
            # THE declared fallback seam: failed covered segments go
            # through the exact local pump the unrouted scan uses —
            # direct store reads happen here and nowhere else on the
            # routed path
            pump = self._aggregate_segments_pump(
                dc_replace(plan, segments=list(failed)), spec, memo_store)
            try:
                async for out in pump:
                    yield out
            finally:
                await pump.aclose()

    async def _aggregate_segments_pump(self, plan: ScanPlan,
                                       spec: AggregateSpec, memo_store):
        """The local aggregate pipeline (read -> merge -> device rounds)
        over `plan.segments`.

        Windows from different segments batch into rounds of
        `scan.agg_batch_windows`, one kernel launch per round.  Segments
        partition time and windows partition PKs, so no two windows
        share a (group, bucket, timestamp) cell and the host combine has
        no tie-break subtleties.

        When the scan runs through the pipeline (plan.pipeline_active,
        decided by _cached_windows once it has probed for store I/O),
        ONE round runs as a background task — the device stage — while
        this loop pulls and preps the next windows; rounds still apply
        in dispatch order, so every segment's parts are the sequential
        path's."""
        from horaedb_tpu_torch.storage import pipeline as pipeline_mod

        batch_w = max(1, self.config.scan.agg_batch_windows)
        queue: list = []
        parts: dict[int, list] = {}
        pending: dict[int, int] = {}
        arrived: deque = deque()
        flush_task: Optional[asyncio.Task] = None

        def apply(flushed) -> None:
            for seg_start, part in flushed:
                parts[seg_start].append(part)
                pending[seg_start] -= 1

        async def settle_flush() -> None:
            nonlocal flush_task
            if flush_task is None:
                return
            t, flush_task = flush_task, None
            apply(await t)

        async def flush_round(chunk: list) -> list:
            # the stage's seconds are observed around the round itself
            # (pool-queue wait included), not dispatch-to-settle, which
            # would absorb the consumer's waits on fetch and decode
            t0 = time.perf_counter()
            out = await self._run_pool(self._flush_host_round, chunk, spec,
                                       plan, pool=plan.pool)
            pipeline_mod.observe_stage(
                "device", time.perf_counter() - t0,
                rows=sum(w.n_valid for _s, w, _p in chunk))
            return out

        async def flush(k: int) -> None:
            nonlocal flush_task
            chunk = queue[:k]
            del queue[:k]
            if not plan.pipeline_active:
                apply(await self._run_pool(self._flush_host_round, chunk,
                                           spec, plan, pool=plan.pool))
                return
            # stage-boundary checkpoint: no new device round for an
            # expired query (the in-flight one drains via settle)
            deadline_checkpoint()
            await settle_flush()
            flush_task = asyncio.create_task(flush_round(chunk))

        def finished():
            while arrived and pending[arrived[0]] == 0:
                s0 = arrived.popleft()
                seg_parts = parts.pop(s0)
                memo_store(s0, seg_parts)
                yield s0, seg_parts

        try:
            windows_iter = self._cached_windows(plan)
            try:
                async for seg, windows in windows_iter:
                    s = seg.segment_start
                    arrived.append(s)
                    parts[s] = []
                    pending[s] = 0

                    def prep_windows(ws=windows):
                        out = []
                        for w in ws:
                            # same semantics as the row path: post-dedup
                            # rows
                            _ROWS_SCANNED.inc(w.n_valid)
                            if isinstance(w, device_decode.DevicePart):
                                # a finished partial rides the queue
                                # with prep None, so a segment's parts
                                # keep their order; a provably empty one
                                # never enqueues (no flush would repay
                                # its pending count)
                                if w.part is not None:
                                    out.append((w, None))
                                continue
                            prep = self._window_groups(w, spec, plan)
                            if prep is not None:
                                out.append((w, prep))
                        return out

                    for w, prep in await self._run_pool(prep_windows,
                                                        pool=plan.pool):
                        queue.append((s, w, prep))
                        pending[s] += 1
                    while len(queue) >= batch_w:
                        await flush(batch_w)
                    for out in finished():
                        yield out
            except NotFoundError:
                # a compaction race: the round in flight still lands and
                # the segments it finishes are yielded, so the caller's
                # replan re-reads only the segments left
                await settle_flush()
                for out in finished():
                    yield out
                raise
            finally:
                await windows_iter.aclose()
            if queue:
                await flush(len(queue))
            await settle_flush()
            for out in finished():
                yield out
        finally:
            if flush_task is not None:
                # a cancelled or failed scan drains its in-flight round
                # (the pool job runs to completion regardless), so it
                # never races table teardown
                flush_task.cancel()
                await asyncio.gather(flush_task, return_exceptions=True)

    def _flush_host_round(self, items: list, spec: AggregateSpec,
                          plan: ScanPlan) -> list:
        """One round of host windows (possibly from several segments) as
        ONE bucket_window_partials launch over the round's stacks.

        items: [(seg_start, window, (group_values, gid_full, shift))].
        Returns [(seg_start, (round_values, bucket_lo, partial grids))]
        in item order; every part shares the round's union group values
        (rows a window didn't touch have count 0 and fold away in the
        combine).  The partial grids come to the host once per round;
        padding windows and groups are sliced away on the device first,
        and window-local last_ts is re-based to range-relative.

        Device-decode items (window a DevicePart, prep None) pass their
        finished part through in position, with no launch of their own."""
        if any(it[2] is None for it in items):
            host = [it for it in items if it[2] is not None]
            done = iter(self._flush_host_round(host, spec, plan)
                        if host else ())
            return [(s, w.part) if prep is None else next(done)
                    for s, w, prep in items]
        # pow2 width >= len(items): full rounds share one shape, tail
        # rounds use narrower ones
        batch_w = min(max(1, self.config.scan.agg_batch_windows),
                      1 << (len(items) - 1).bit_length())
        round_values = np.unique(np.concatenate([it[2][0] for it in items]))
        g = len(round_values)
        g_pad = max(8, 1 << (g - 1).bit_length())
        cap = max(it[1].capacity for it in items)
        # offset-encoded ts columns bound each window's bucket range (the
        # epoch is the segment table's min ts); anything else takes
        # full-range grids with lo=0
        local_ok = all(it[1].encodings[spec.ts_col].kind == "offset"
                       for it in items)
        width = (self._window_grid_width(spec) if local_ok
                 else spec.num_buckets)
        (ts_s, gid_s, val_s, _nv_d, nv_h, remap_d, shift_d, lo_d,
         lo) = self._build_round_stacks(items, spec, plan, batch_w, cap,
                                        g_pad, width, round_values,
                                        local_ok)
        t_dev = time.perf_counter()
        # rows past a window's own n_valid carry gid -1, so the round's
        # largest row count bounds every window
        stacked = bucket_agg.bucket_window_partials(
            ts_s, gid_s, val_s, remap_d, shift_d, lo_d, spec.num_buckets,
            spec.bucket_ms, num_groups=g_pad, width=width, which=spec.which,
            n_valid=int(nv_h.max()))
        _PARTS_ROUNDS.inc()
        host = {k: v[:len(items), :g].cpu().numpy()
                for k, v in stacked.items()}
        _PARTIALS_D2H_BYTES.inc(sum(int(v.nbytes) for v in host.values()))
        _observe_stage("device_aggregate", time.perf_counter() - t_dev)
        parts = []
        for d in range(len(items)):
            lo_w = int(lo[d])
            w_eff = min(width, spec.num_buckets - lo_w)
            grids = {k: v[d, :, :w_eff] for k, v in host.items()}
            if "last_ts" in grids:
                # window-local last_ts -> range_start-relative, so parts
                # with different offsets compare correctly
                lt = grids["last_ts"].astype(np.int64)
                grids["last_ts"] = np.where(
                    grids["count"] > 0, lt + lo_w * spec.bucket_ms, lt)
            parts.append((items[d][0], (round_values, lo_w, grids)))
        return parts

    def finalize_aggregate(self, parts: list, spec: AggregateSpec,
                           top_k=None):
        """Combine per-window parts into the user-facing grids
        (storage/combine.py, [scan.combine] mode), drop groups with no
        row in any bucket, and expose last_ts as absolute ms.

        A `top_k` spec (plan.TopKSpec) pushes the ranking into the
        combine (combine_top_k): only the k winners' rows are ever
        materialized, never the groups x buckets grid.  In `dense` mode
        the pushdown is off too: the control materializes the full grid
        and ranks with plan.apply_top_k, so the mode flag A/Bs the whole
        path."""
        mode = self.config.scan.combine.mode
        t0 = time.perf_counter()
        try:
            if top_k is not None and mode != "dense":
                # the pushdown drops all-empty groups before ranking,
                # the same groups as the drop below
                group_values, grids = combine_mod.combine_top_k(
                    parts, spec.num_buckets, spec.which, top_k)
            else:
                group_values, grids = combine_mod.combine_parts(
                    parts, spec.num_buckets, which=spec.which, mode=mode)
                # the aligned fast path omits the ts leaf
                # (query_downsample), so boundary-segment rows outside
                # [start, end) can register a group whose every cell is
                # empty
                if len(group_values):
                    nonzero = grids["count"].sum(axis=1) > 0
                    if not nonzero.all():
                        group_values = group_values[nonzero]
                        grids = {k: v[nonzero] for k, v in grids.items()}
                if top_k is not None:
                    from horaedb_tpu_torch.storage.plan import apply_top_k

                    group_values, grids = apply_top_k(group_values, grids,
                                                      top_k)
        finally:
            _observe_stage("combine", time.perf_counter() - t0)
        if len(group_values) and "last_ts" in grids:
            grids["last_ts"] = grids["last_ts"] + spec.range_start
        return group_values, grids

    # ---- fused aggregate ---------------------------------------------------

    async def execute_aggregate_fused(self, plan: ScanPlan,
                                      spec: AggregateSpec,
                                      counted: Optional[set] = None):
        """Merge + downsample with a QUERY-GLOBAL device accumulator:
        rounds of stacked windows aggregate and scatter into one
        (groups, buckets) grid set on the device; nothing is downloaded
        until the final grids.

        Two-phase: all windows are collected first so the union group
        space is known before any round runs (remap targets global rows
        directly).  A completed query is recorded in the replay cache;
        an identical repeat whose windows and stacks are all still
        cached replays its rounds instead (_fused_replay).

        Returns (group_values, grids): grids are tensors on the reader's
        device, except `last_ts`, which comes back as host float64
        absolute ms (int64 range needed).  `counted`: segments whose rows
        an earlier attempt of the same query already counted (a restart
        after a compaction race counts them once)."""
        replay_key = None
        if plan.use_cache:
            replay_key = self._replay_key(plan, spec)
            entry = self._replay_cache.get(replay_key)
            if entry is not None:
                # segment validation reads the (event-loop owned) scan
                # cache here; only the device rounds go to the pool
                grids = None
                if self._replay_segments_valid(entry):
                    grids = await self._run_pool(self._fused_replay, entry,
                                                 spec, pool=plan.pool)
                if grids is not None:
                    self._replay_cache.move_to_end(replay_key)
                    self._replay_hits += 1
                    _REPLAY_HITS.inc()
                    # nothing was read: replayed rows have their own
                    # counter, once per segment across race restarts
                    fresh = [(s, r) for s, r in entry["seg_rows"]
                             if counted is None or s not in counted]
                    if fresh:
                        _REPLAY_ROWS.inc(sum(r for _, r in fresh))
                        if counted is not None:
                            counted.update(s for s, _ in fresh)
                    values, grids = _drop_empty_groups_dev(entry["values"],
                                                           grids)
                    return values, _fused_last_ts_to_abs(grids, spec)
                self._replay_cache.pop(replay_key, None)
            self._replay_misses += 1
            _REPLAY_MISSES.inc()
        items: list = []
        seg_records: list = []
        seg_rows: list = []
        windows_iter = self._cached_windows(plan)
        try:
            async for seg, windows in windows_iter:
                s = seg.segment_start
                count_rows = counted is None or s not in counted
                if counted is not None:
                    counted.add(s)

                def prep(ws=windows, s=s, count_rows=count_rows):
                    out = []
                    for w in ws:
                        if count_rows:
                            _ROWS_SCANNED.inc(w.n_valid)
                        pr = self._window_groups(w, spec, plan)
                        if pr is not None:
                            out.append((s, w, pr))
                    return out

                items.extend(await self._run_pool(prep))
                if replay_key is not None:
                    seg_records.append((self._cache_key(seg, plan), tuple(
                        weakref.ref(w) for w in windows)))
                    seg_rows.append((s, sum(w.n_valid for w in windows)))
        finally:
            await windows_iter.aclose()
        if not items:
            empty = np.zeros((0, spec.num_buckets), dtype=np.float32)
            return np.asarray([]), {k: empty.copy() for k in
                                    set(spec.which) | {"count"}}
        all_values = np.unique(np.concatenate([it[2][0] for it in items]))
        g = len(all_values)
        g_pad = max(8, 1 << (g - 1).bit_length())
        local_ok = all(it[1].encodings[spec.ts_col].kind == "offset"
                       for it in items)
        width = (self._window_grid_width(spec) if local_ok
                 else spec.num_buckets)
        max_w = max(1, self.config.scan.agg_batch_windows)
        space_fp = (g, hash(all_values.tobytes()))
        recorded_rounds: list = []

        def build_rounds():
            # lazy: the next round's stacks are built while the device
            # still runs the previous round's launches
            i = 0
            while i < len(items):
                chunk = items[i:i + max_w]
                batch_w = min(max_w, 1 << (len(chunk) - 1).bit_length())
                cap = max(it[1].capacity for it in chunk)
                # the chunk offset `i` keeps consecutive rounds of one
                # segment that share (seg0, batch_w, cap) apart in the
                # stack cache
                stack_key = self._round_stack_key(
                    chunk[0][0], spec, plan, batch_w, cap, g_pad, width,
                    space_fp) + (i,)
                arrays = self._build_round_stacks(
                    chunk, spec, plan, batch_w, cap, g_pad, width,
                    all_values, local_ok, stack_key=stack_key)
                if replay_key is not None:
                    windows = tuple(it[1] for it in chunk)
                    recorded_rounds.append((
                        stack_key,
                        self._col_stack_key(windows, spec, plan, batch_w,
                                            cap),
                        tuple(weakref.ref(w) for w in windows)))
                i += len(chunk)
                yield arrays

        grids = await self._run_pool(
            self._fused_run_device_rounds, build_rounds(), spec,
            g, g_pad, width)
        if replay_key is not None:
            self._replay_cache[replay_key] = {
                "segments": seg_records, "rounds": recorded_rounds,
                "values": all_values, "g": g, "g_pad": g_pad,
                "width": width, "seg_rows": seg_rows}
            self._replay_cache.move_to_end(replay_key)
            while len(self._replay_cache) > _REPLAY_SLOTS:
                self._replay_cache.popitem(last=False)
        all_values, grids = _drop_empty_groups_dev(all_values, grids)
        return all_values, _fused_last_ts_to_abs(grids, spec)

    def _replay_key(self, plan: ScanPlan, spec: AggregateSpec) -> tuple:
        """Identity of a fused aggregate over a plan: the per-segment
        scan-cache keys (SST ids + columns + pushdown), the aggregate
        spec and the predicate.  A write or a compaction changes a
        segment's SST set and so the key."""
        seg_keys = tuple(self._cache_key(seg, plan) for seg in plan.segments)
        return (seg_keys, spec.group_col, spec.ts_col, spec.value_col,
                spec.range_start, spec.bucket_ms, spec.num_buckets,
                spec.which,
                filter_ops.canonical_predicate_key(plan.predicate))

    def _replay_segments_valid(self, entry: dict) -> bool:
        """Every segment's scan-cache entry must still hold the exact
        window objects recorded (a re-read, an eviction or a compaction
        breaks the identity).  Runs on the event loop, which owns the
        scan cache."""
        for key, refs in entry["segments"]:
            ws = self.scan_cache.get(key)
            if (ws is None or len(ws) != len(refs)
                    or any(r() is not w for r, w in zip(refs, ws))):
                return False
        return True

    def _fused_replay(self, entry: dict, spec: AggregateSpec):
        """Re-run a recorded fused aggregate in ONE worker-pool dispatch:
        every round's stacks must still be in the stack cache (checked
        before any device work); then the rounds run from them.  Returns
        the device grids, or None to take the full path."""
        rounds = []
        for stack_key, col_key, refs in entry["rounds"]:
            ws = tuple(r() for r in refs)
            if any(w is None for w in ws):
                return None
            cols = self._stack_cache_get(col_key, ws)
            small = self._stack_cache_get(stack_key, ws)
            if cols is None or small is None:
                return None
            rounds.append(cols + small)
        return self._fused_run_device_rounds(
            rounds, spec, entry["g"], entry["g_pad"], entry["width"])

    def _fused_run_device_rounds(self, rounds, spec: AggregateSpec, g: int,
                                 g_pad: int, width: int) -> dict:
        """The fused aggregate's device sequence, shared by the full path
        and the replay: acc init -> one accumulate per round -> finalize
        -> slice to g -> synchronize.  `rounds` is any iterable of stack
        tuples (a lazy generator on the full path, so stack building
        overlaps the device's rounds)."""
        import torch

        t0 = time.perf_counter()
        acc = fused_acc_init(num_groups=g_pad, num_buckets=spec.num_buckets,
                             which=spec.which, device=self.device)
        for (ts_s, gid_s, val_s, nv_d, nv_h, remap_d, shift_d, lo_d,
             lo_h) in rounds:
            fused_round_accumulate(acc, ts_s, gid_s, val_s, remap_d, shift_d,
                                   lo_d, lo_h, spec.num_buckets,
                                   spec.bucket_ms, num_groups=g_pad,
                                   width=width, which=spec.which,
                                   n_valid=nv_d, n_valid_host=nv_h)
        final = fused_finalize(acc, spec.which)
        out = {k: v[:g] for k, v in final.items()}
        if self.on_cuda:
            torch.cuda.synchronize(self.device)
        _observe_stage("device_aggregate", time.perf_counter() - t0)
        return out

    def _window_groups(self, w: encode.DeviceBatch, spec: AggregateSpec,
                       plan: ScanPlan):
        """Per-window prep: (group_values, gid_full, ts_shift) or None
        when the window contributes nothing.  Memoized on the window
        (keyed by group column + full predicate) so repeat queries over
        cached windows skip the dense-ification; only the shift depends
        on range_start and is derived per call."""
        memo_key = ("window_groups", spec.group_col, spec.ts_col,
                    filter_ops.canonical_predicate_key(plan.predicate))
        miss = object()
        cached_val = w.memo.get(memo_key, miss)
        if cached_val is miss:
            cached_val = self._window_groups_uncached(w, spec, plan)
            nbytes = 0 if cached_val is None else int(cached_val[1].nbytes)
            _memo_store(w, memo_key, cached_val, nbytes)
        if cached_val is None:
            return None
        group_values, gid_full, epoch = cached_val
        shift = epoch - spec.range_start  # host_ts = dev_ts + epoch
        ensure(abs(shift) < 2**31, "query range too far from segment epoch")
        return group_values, gid_full, shift

    def _window_groups_uncached(self, w: encode.DeviceBatch,
                                spec: AggregateSpec, plan: ScanPlan):
        k = w.n_valid
        cap = w.capacity
        if k == 0:
            return None
        keep = np.arange(cap) < k
        mask_all = True
        if plan.predicate is not None and not plan.pushed_complete:
            mask = filter_ops.eval_predicate(plan.predicate, w)
            mask_all = bool(mask[:k].all())
            keep = keep & mask
            if not mask_all and not keep.any():
                return None
        ts_enc = w.encodings[spec.ts_col]
        ensure(ts_enc.kind in ("offset", "numeric"),
               f"aggregate needs arithmetic timestamps, got "
               f"{ts_enc.kind!r} encoding for {spec.ts_col!r}")
        codes = np.asarray(w.columns[spec.group_col])
        enc_g = w.encodings[spec.group_col]
        if (mask_all and enc_g.kind == "dict" and len(enc_g.dictionary)
                and int(codes[:k].min()) == 0
                and int(codes[:k].max()) == len(enc_g.dictionary) - 1):
            # the window uses the WHOLE dictionary: its codes already
            # ARE the dense ids and the dictionary the sorted values
            gid_full = np.where(keep, codes, -1).astype(np.int32)
            return enc_g.dictionary, gid_full, ts_enc.epoch
        sel_codes = codes[keep]
        if len(sel_codes) == 0:
            return None
        uniq, dense = np.unique(sel_codes, return_inverse=True)
        gid_full = np.full(cap, -1, dtype=np.int32)
        gid_full[keep] = dense.astype(np.int32)
        return (_decode_group_values(uniq, enc_g), gid_full, ts_enc.epoch)

    def _window_grid_width(self, spec: AggregateSpec) -> int:
        """Static per-window grid width: a window's rows span at most one
        segment, so its buckets span at most segment_ms/bucket_ms (+2
        for epoch/range misalignment)."""
        need = self.segment_duration_ms // max(1, spec.bucket_ms) + 2
        return int(min(spec.num_buckets,
                       max(8, 1 << (need - 1).bit_length())))

    def _stack_cache_get(self, key: tuple, windows_now: tuple):
        """The stack cache's arrays under `key`, or None.  An entry whose
        window weakrefs no longer name `windows_now` (a window evicted
        and re-read, or a changed composition) is dropped: a miss."""
        with self._stack_cache_lock:
            entry = self._stack_cache.get(key)
            if entry is not None:
                refs, arrays, nbytes = entry
                if len(refs) == len(windows_now) and all(
                        r() is w for r, w in zip(refs, windows_now)):
                    self._stack_cache.move_to_end(key)
                    self._stack_cache_hits += 1
                    _STACK_HITS.inc()
                    return arrays
                del self._stack_cache[key]
                self._stack_cache_bytes -= nbytes
            self._stack_cache_misses += 1
            _STACK_MISSES.inc()
            return None

    def _stack_cache_put(self, key: tuple, windows_now: tuple,
                         arrays: tuple) -> None:
        """Store a round's arrays under `key` with weakrefs to its
        windows (no window is pinned), evicting least recently used
        entries past the byte bound; an entry larger than the bound is
        not stored."""
        nbytes = sum(int(a.nbytes) for a in arrays)
        refs = tuple(weakref.ref(w) for w in windows_now)
        with self._stack_cache_lock:
            if nbytes > self._stack_cache_max:
                return
            old = self._stack_cache.pop(key, None)
            if old is not None:
                self._stack_cache_bytes -= old[2]
            self._stack_cache[key] = (refs, arrays, nbytes)
            self._stack_cache_bytes += nbytes
            while (self._stack_cache_bytes > self._stack_cache_max
                   and self._stack_cache):
                _, (_, _, evicted) = self._stack_cache.popitem(last=False)
                self._stack_cache_bytes -= evicted

    def _devcol_stack_ok(self) -> bool:
        """Whether the fused rounds stack from per-window device columns
        (_window_device_cols) instead of a numpy stack and one bulk
        upload per array: on a CUDA reader, where the copies let a
        varied-range query (new round compositions: column-stack misses)
        re-stack arrays already on the device and upload only the small
        ones.  On the CPU the numpy stack is a memcpy."""
        return self.on_cuda

    def _window_device_cols(self, w: encode.DeviceBatch,
                            spec: AggregateSpec, plan: ScanPlan,
                            gid: np.ndarray) -> tuple:
        """(ts, gid, value) device copies of one host window at its own
        capacity: range-independent, memoized on the window."""
        memo_key = ("dev_cols", spec.group_col, spec.ts_col,
                    spec.value_col,
                    filter_ops.canonical_predicate_key(plan.predicate))
        miss = object()
        got = w.memo.get(memo_key, miss)
        if got is not miss:
            return got
        put = lambda a: encode.to_device(a, self.device)
        out = (put(np.asarray(w.columns[spec.ts_col], dtype=np.int32)),
               put(np.asarray(gid, dtype=np.int32)),
               put(np.asarray(w.columns[spec.value_col], dtype=np.float32)))
        _memo_store(w, memo_key, out, sum(int(a.nbytes) for a in out))
        return out

    @staticmethod
    def _round_stack_key(seg0: int, spec: AggregateSpec, plan: ScanPlan,
                         batch_w: int, cap: int, g_pad: int, width: int,
                         space_fp: tuple) -> tuple:
        """Stack-cache identity of one round's RANGE-DEPENDENT small
        arrays (remap, shift, lo); the fused replay records the same
        key, so it is computed one way only."""
        return (seg0, spec.group_col, spec.ts_col, spec.value_col,
                spec.bucket_ms, spec.range_start, batch_w, cap, g_pad, width,
                space_fp, filter_ops.canonical_predicate_key(plan.predicate))

    @staticmethod
    def _col_stack_key(windows_now: tuple, spec: AggregateSpec,
                       plan: ScanPlan, batch_w: int, cap: int) -> tuple:
        """Stack-cache identity of one round's RANGE-INDEPENDENT columns
        (ts, gid, val, n_valid): the round's window object ids (the
        entry's weakrefs guard against id reuse), never the range, so
        every query with the same round composition shares them."""
        return ("colstack", tuple(id(w) for w in windows_now),
                spec.group_col, spec.ts_col, spec.value_col, batch_w, cap,
                filter_ops.canonical_predicate_key(plan.predicate))

    def _build_round_stacks(self, items: list, spec: AggregateSpec,
                            plan: ScanPlan, batch_w: int, cap: int,
                            g_pad: int, width: int,
                            group_space: np.ndarray, local_ok: bool,
                            stack_key: Optional[tuple] = None) -> tuple:
        """One round of host windows on the device, in two parts: the
        columns (ts, gid, val and n_valid, on the device and on the host)
        and the small arrays (remap, shift, lo on the device, lo on the
        host).  With a `stack_key` (the fused rounds) each part goes
        through the stack cache, and a miss stacks the columns from the
        windows' memoized device copies (_devcol_stack_ok) or from numpy;
        without one (the parts path, whose plans outgrow the cache's
        byte bound, so a byte LRU would evict each round before its
        reuse) the round is built uncached from numpy, one upload per
        array.  Windows past len(items) pad the round with no-op rows
        (ts 0, gid -1, value 0, n_valid 0), the same bytes on either
        route.  Returns (ts, gid, val, n_valid, n_valid_host, remap,
        shift, lo, lo_host); the host copies bound the round's rows and
        columns without a device read."""
        cached = stack_key is not None
        windows_now = tuple(it[1] for it in items)
        cols = small = None
        if cached:
            col_key = self._col_stack_key(windows_now, spec, plan, batch_w,
                                          cap)
            cols = self._stack_cache_get(col_key, windows_now)
            small = self._stack_cache_get(stack_key, windows_now)
            if cols is not None and small is not None:
                return cols + small
        t0 = time.perf_counter()
        put = lambda a: encode.to_device(a, self.device)
        if cols is None:
            n_valid = np.zeros(batch_w, dtype=np.int32)
            for d, (_s, w, _prep) in enumerate(items):
                n_valid[d] = w.n_valid
            if cached and self._devcol_stack_ok():
                cols = self._stack_device_cols(items, spec, plan, batch_w,
                                               cap)
            else:
                ts_m = np.zeros((batch_w, cap), dtype=np.int32)
                gid_m = np.full((batch_w, cap), -1, dtype=np.int32)
                val_m = np.zeros((batch_w, cap), dtype=np.float32)
                for d, (_s, w, (_values, gid, _sh)) in enumerate(items):
                    ts_m[d, :w.capacity] = w.columns[spec.ts_col]
                    gid_m[d, :w.capacity] = gid
                    val_m[d, :w.capacity] = w.columns[spec.value_col]
                cols = (put(ts_m), put(gid_m), put(val_m))
            cols = cols + (put(n_valid), n_valid)
            if cached:
                self._stack_cache_put(col_key, windows_now, cols)
        if small is None:
            remap = np.zeros((batch_w, g_pad), dtype=np.int32)
            shift = np.zeros(batch_w, dtype=np.int32)
            lo = np.zeros(batch_w, dtype=np.int32)
            for d, (_s, _w, (values, _gid, sh)) in enumerate(items):
                remap[d, :len(values)] = np.searchsorted(group_space, values)
                shift[d] = sh
                if local_ok:
                    lo[d] = max(0, sh // spec.bucket_ms)
            small = (put(remap), put(shift), put(lo), lo)
            if cached:
                self._stack_cache_put(stack_key, windows_now, small)
        _observe_stage("stack_build", time.perf_counter() - t0)
        return cols + small

    def _stack_device_cols(self, items: list, spec: AggregateSpec,
                           plan: ScanPlan, batch_w: int, cap: int) -> tuple:
        """(ts, gid, val) stacks of a round from its windows' memoized
        device columns, padded on the device (ts/val 0, gid -1) to `cap`
        and with pad windows to `batch_w`."""
        import torch
        import torch.nn.functional as F

        rows: tuple = ([], [], [])
        for _s, w, (_values, gid, _sh) in items:
            pad = cap - w.capacity
            for out, col, fill in zip(
                    rows, self._window_device_cols(w, spec, plan, gid),
                    (0, -1, 0)):
                out.append(F.pad(col, (0, pad), value=fill) if pad else col)
        for out, dtype, fill in zip(rows, (torch.int32, torch.int32,
                                           torch.float32), (0, -1, 0)):
            out.extend([torch.full((cap,), fill, dtype=dtype,
                                   device=self.device)]
                       * (batch_w - len(items)))
        return tuple(torch.stack(out) for out in rows)


# ---------------------------------------------------------------------------
# fused device steps (counterparts of the JAX package's
# _fused_acc_init_jit, _fused_round_accumulate_jit, _fused_finalize_jit
# and _group_has_data_jit)
# ---------------------------------------------------------------------------


def fused_acc_init(*, num_groups: int, num_buckets: int, which: tuple,
                   device) -> dict:
    """Query-global accumulator grids with combine-identity inits:
    count/sum 0, min +F32_MAX, max -F32_MAX, last 0, last_ts INT32_MIN."""
    import torch

    shape = (num_groups, num_buckets)
    fields = bucket_agg.fields_for(which)
    acc = {"count": torch.zeros(shape, dtype=torch.float32, device=device)}
    if "sum" in fields:
        acc["sum"] = torch.zeros(shape, dtype=torch.float32, device=device)
    if "min" in fields:
        acc["min"] = torch.full(shape, _F32_MAX, dtype=torch.float32,
                                device=device)
    if "max" in fields:
        acc["max"] = torch.full(shape, -_F32_MAX, dtype=torch.float32,
                                device=device)
    if "last" in fields:
        acc["last"] = torch.zeros(shape, dtype=torch.float32, device=device)
        acc["last_ts"] = torch.full(shape, _ACC_TS_MIN, dtype=torch.int32,
                                    device=device)
    return acc


def fused_round_accumulate(acc: dict, ts, gid, vals, remap, shift, lo,
                           lo_host, total: int, bucket_ms: int, *,
                           num_groups: int, width: int, which: tuple,
                           n_valid=None, n_valid_host=None) -> dict:
    """One round of windows aggregated straight into the query-global
    accumulator, IN PLACE round over round (the JAX program donated its
    accumulator buffers for the same effect): one
    bucket_agg.bucket_round_accumulate call.  Window d covers global
    buckets [lo[d], lo[d] + width); columns past `total` are dropped,
    like the JAX scatter's mode="drop".  n_valid (device) and
    n_valid_host bound each window's rows; lo_host is lo on the host."""
    return bucket_agg.bucket_round_accumulate(
        acc, ts, gid, vals, remap, shift, lo, total, bucket_ms,
        num_groups=num_groups, width=width, which=which, n_valid=n_valid,
        lo_host=lo_host, n_valid_host=n_valid_host)


def fused_finalize(acc: dict, which: tuple) -> dict:
    """Finalize of the fused accumulator: min/max empty cells read
    +/-inf, avg/last NaN; last_ts stays int32 (range-relative)."""
    import torch

    count = acc["count"]
    empty = count == 0
    nan = torch.full_like(count, float("nan"))
    requested = set(which) | {"count"}
    out = {"count": count}
    if "sum" in acc and "sum" in requested:
        out["sum"] = acc["sum"]
    if "sum" in acc and "avg" in requested:
        out["avg"] = torch.where(empty, nan, acc["sum"] / count.clamp(min=1.0))
    if "min" in acc and "min" in requested:
        out["min"] = torch.where(empty, torch.full_like(count, float("inf")),
                                 acc["min"])
    if "max" in acc and "max" in requested:
        out["max"] = torch.where(empty, torch.full_like(count, float("-inf")),
                                 acc["max"])
    if "last" in acc and "last" in requested:
        out["last"] = torch.where(empty, nan, acc["last"])
        out["last_ts"] = acc["last_ts"]
    return out


def group_has_data(count):
    """Per-group any-data mask — G bools, the only bytes the empty-group
    check downloads."""
    return (count > 0).any(dim=1)


def _drop_empty_groups_dev(values: np.ndarray, grids: dict):
    """Drop groups with no row in any bucket (the aligned fast path can
    register groups whose rows all fall outside the range)."""
    if not len(values):
        return values, grids
    has = group_has_data(grids["count"]).cpu().numpy()
    if has.all():
        return values, grids
    idx = np.flatnonzero(has)
    import torch

    sel = torch.from_numpy(idx).to(grids["count"].device)
    return values[idx], {k: v.index_select(0, sel) for k, v in grids.items()}


def _fused_last_ts_to_abs(grids: dict, spec: AggregateSpec) -> dict:
    if "last_ts" in grids:
        # absolute float ms needs int64 range: host conversion
        count_h = grids["count"].cpu().numpy()
        lt = grids["last_ts"].cpu().numpy().astype(np.float64)
        grids["last_ts"] = np.where(count_h > 0, lt + spec.range_start,
                                    np.nan)
    return grids


def _cacheable_windows(windows: list) -> bool:
    """Only host-decoded window lists enter the scan cache: a DevicePart
    is an aggregate partial of one spec (serving it to a row scan or
    another aggregate would be wrong), and repeat aggregates are served
    by the PartsMemo already."""
    return all(isinstance(w, encode.DeviceBatch) for w in windows)


def _encoded_to_device_batch(es: sidecar.EncodedSegment
                             ) -> encode.DeviceBatch:
    """Pad sidecar columns to a capacity bucket — the only prep the
    already-device-layout data needs."""
    cap = encode.pad_capacity(es.n)
    columns = {}
    for name, arr in es.columns.items():
        padded = np.zeros(cap, dtype=arr.dtype)
        padded[:es.n] = arr
        columns[name] = padded
    return encode.DeviceBatch(columns=columns, encodings=es.encodings,
                              n_valid=es.n, capacity=cap)


def _decode_group_values(codes: np.ndarray, enc) -> np.ndarray:
    """Group codes -> host values (dictionary entries / epoch shift), in
    the same (sorted) order as the codes."""
    if enc.kind == "dict":
        return enc.dictionary[codes]
    if enc.kind == "offset":
        return codes.astype(np.int64) + enc.epoch
    return codes


# ---------------------------------------------------------------------------
# host merge
# ---------------------------------------------------------------------------


def _is_lex_sorted(keys: list[np.ndarray]) -> bool:
    """True iff rows are non-decreasing under lexicographic key order."""
    n = len(keys[0])
    if n <= 1:
        return True
    still_equal = np.ones(n - 1, dtype=bool)
    for c in keys:
        if bool(np.any(still_equal & (c[:-1] > c[1:]))):
            return False
        still_equal &= c[:-1] == c[1:]
        if not still_equal.any():
            return True
    return True


def _plan_merge_perm(sort_cols: list[np.ndarray],
                     seq: Optional[np.ndarray]) -> Optional[np.ndarray]:
    """Host half of the k-way merge of pre-sorted SST runs: None when
    the rows are already sorted, else an int32 permutation.  The packed
    lexicographic key goes through numpy's stable (radix) argsort;
    ranges beyond int64 use np.lexsort.  `seq` is passed ONLY when rows
    are not already in ascending sequence order (stability keeps row
    order within equal keys, which last-wins dedup needs)."""
    keys = list(sort_cols) + ([] if seq is None else [seq])
    n = len(keys[0])
    if n <= 1:
        return None
    if _is_lex_sorted(keys):
        return None
    packed = None
    span_prod = 1
    for c in keys:  # most-significant first
        c64 = c.astype(np.int64, copy=False)
        lo = int(c64.min())
        span = int(c64.max()) - lo + 1
        if span_prod * span >= 2**63:
            packed = None
            break
        span_prod *= span
        part = c64 - lo
        packed = part if packed is None else packed * span + part
    if packed is not None:
        return np.argsort(packed, kind="stable").astype(np.int32)
    return np.lexsort(tuple(reversed(keys))).astype(np.int32)


def _window_merge_sel(sort_cols: list[np.ndarray], seq_h: np.ndarray,
                      seq_ordered: bool, sel: np.ndarray) -> np.ndarray:
    perm = _plan_merge_perm([c[sel] for c in sort_cols],
                            None if seq_ordered else seq_h[sel])
    return sel if perm is None else sel[perm]


def _batch_merge_perm(sort_cols: list[np.ndarray], seq_h: np.ndarray,
                      seq_ordered: bool, n: int) -> Optional[np.ndarray]:
    return _plan_merge_perm([c[:n] for c in sort_cols],
                            None if seq_ordered else seq_h[:n])


def _host_merge_window_descs(dev: encode.DeviceBatch, host_cols: dict,
                             sort_pk_names: list[str], seq_h: np.ndarray,
                             seq_ordered: bool, selections: list,
                             n: int) -> list:
    """Per window: plan the merge permutation, keep the last row of each
    PK run, and emit padded host column dicts.  Returns
    [(cols, n_valid, capacity, encodings)]."""
    descs = []
    sort_cols = [host_cols[nm] for nm in sort_pk_names]
    for sel in selections:
        if sel is not None and not len(sel):
            continue
        if sel is None:
            base = _batch_merge_perm(sort_cols, seq_h, seq_ordered, n)
        else:
            base = _window_merge_sel(sort_cols, seq_h, seq_ordered, sel)
        keys = (sort_cols if base is None
                else [c[base] for c in sort_cols])
        keep = _host_dedup_keep(keys)
        k = int(keep.sum())
        if k == 0:
            continue
        if base is None:
            if k == n and sel is None:
                # no duplicates, already padded
                descs.append(({kk: np.asarray(v) for kk, v
                               in dev.columns.items()},
                              n, dev.capacity, dev.encodings))
                continue
            idx = np.flatnonzero(keep)
        else:
            idx = base if k == len(base) else base[keep]
        cap = encode.pad_capacity(k)
        cols = {kk: np.pad(v[idx], (0, cap - k))
                for kk, v in host_cols.items()}
        descs.append((cols, k, cap, dev.encodings))
    return descs


def _host_dedup_keep(sort_cols: list[np.ndarray]) -> np.ndarray:
    """Keep-mask over PK-SORTED rows: the LAST row of each equal-PK run
    survives (the highest-sequence row arrives last)."""
    n = len(sort_cols[0])
    if n == 0:
        return np.zeros(0, dtype=bool)
    keep = np.empty(n, dtype=bool)
    keep[-1] = True
    diff = np.zeros(n - 1, dtype=bool)
    for c in sort_cols:
        diff |= c[:-1] != c[1:]
    keep[:-1] = diff
    return keep


def _plan_pk_windows(pk1_codes: np.ndarray, window: int) -> list[np.ndarray]:
    """Partition rows into PK-range windows of <= `window` rows; rows
    sharing a first-PK code always land in one window, and windows are
    code-ascending, so concatenated outputs stay globally PK-sorted."""
    _, inv, counts = np.unique(pk1_codes, return_inverse=True,
                               return_counts=True)
    order = np.argsort(inv, kind="stable")
    boundaries = np.cumsum(np.concatenate([[0], counts]))
    nkeys = len(counts)
    windows: list[np.ndarray] = []
    s = 0
    while s < nkeys:
        e = int(np.searchsorted(boundaries, boundaries[s] + window,
                                side="right")) - 1
        if e <= s:
            e = s + 1  # single code over budget: a window of its own
        windows.append(order[boundaries[s]:boundaries[e]])
        s = e
    return windows


def _eval_predicate_host(pred, batch: pa.RecordBatch) -> np.ndarray:
    """Host twin of ops.filter.eval_predicate over an Arrow batch of raw
    values."""
    F = filter_ops
    if isinstance(pred, F.And):
        out = np.ones(batch.num_rows, dtype=bool)
        for c in pred.children:
            out &= _eval_predicate_host(c, batch)
        return out
    if isinstance(pred, F.Or):
        out = np.zeros(batch.num_rows, dtype=bool)
        for c in pred.children:
            out |= _eval_predicate_host(c, batch)
        return out
    if isinstance(pred, F.Not):
        return ~_eval_predicate_host(pred.child, batch)
    col = batch.column(batch.schema.names.index(pred.column))
    return F.leaf_mask_host(pred, col.to_numpy(zero_copy_only=False))


def plan_columns(schema: StorageSchema,
                 projections: Optional[list[int]]) -> list[str]:
    """The column set a merge plan reads for a projection: shared by
    build_plan and the memtable overlay (wal/ingest.py), so hybrid and
    pure-SST scans cannot disagree on shape."""
    proj = schema.fill_required_projections(projections)
    if proj is None:
        columns = list(schema.arrow_schema.names)
    else:
        columns = [schema.arrow_schema.names[i] for i in proj]
    # __reserved__ is never read (all-null, unused); __seq__ must be
    # read for dedup even when it will be stripped from the output.
    columns = [c for c in columns if c != RESERVED_COLUMN_NAME]
    if SEQ_COLUMN_NAME not in columns:
        columns.append(SEQ_COLUMN_NAME)
    return columns


def merge_memtable_overlay(schema: StorageSchema,
                           sst_parts: list[pa.RecordBatch],
                           mem_batches: list[pa.RecordBatch],
                           predicate,
                           columns: list[str],
                           keep_builtin: bool) -> Optional[pa.RecordBatch]:
    """Host merge of ONE segment's already-merged SST rows with its
    memtable overlay: the hybrid scan's last stage (wal/ingest.py).

    Both sources carry per-row `__seq__` (sst_parts from a keep_builtin
    plan, mem_batches stamped with each entry's write seq), so
    Overwrite's last-value rule is one sort by (PK, __seq__) keeping the
    final row of every PK run.  The full predicate applies AFTER the
    dedup, as on the pure-SST path: filtering first would resurrect
    overwritten rows.  Seqs are preserved end to end, so a replayed
    memtable row and its flushed SST twin tie on (PK, seq) with equal
    values, and either winning is exactly-once."""
    import pyarrow.compute as pc

    from horaedb_tpu_torch.storage.operator import LastValueOperator

    target = pa.schema([schema.arrow_schema.field(
        schema.arrow_schema.names.index(c)) for c in columns])
    parts = []
    for b in list(sst_parts) + list(mem_batches):
        if b.num_rows == 0:
            continue
        b = b.select(columns)
        if not b.schema.equals(target):
            b = b.cast(target)
        parts.append(b)
    if not parts:
        return None
    table = pa.Table.from_batches(parts, schema=target)
    sort_keys = [(n, "ascending") for n in schema.primary_key_names]
    sort_keys.append((SEQ_COLUMN_NAME, "ascending"))
    table = table.take(pc.sort_indices(table, sort_keys=sort_keys))
    batch = table.combine_chunks().to_batches()[0]
    pk_indices = [columns.index(n) for n in schema.primary_key_names]
    batch = LastValueOperator().merge_sorted_batch(batch, pk_indices)
    if predicate is not None and batch.num_rows:
        mask = _eval_predicate_host(predicate, batch)
        batch = batch.take(np.flatnonzero(mask))
    if not keep_builtin:
        batch = batch.select([c for c in batch.schema.names
                              if not StorageSchema.is_builtin_name(c)])
    return batch


def describe_plan(plan: ScanPlan) -> str:
    """Indented plan text for golden tests (the analogue of the
    reference's DisplayableExecutionPlan assertion)."""
    lines = [f"MergeScan: mode={plan.mode.value}, "
             f"keep_builtin={plan.keep_builtin}"]
    for seg in plan.segments:
        kind = ("DeviceMergeDedup" if plan.mode is UpdateMode.OVERWRITE
                else "HostBytesMerge")
        lines.append(f"  Segment[start={seg.segment_start}]: {kind}")
        if plan.predicate is not None:
            lines.append(f"    Filter: {plan.predicate!r}")
        files = ", ".join(f"{f.id}.sst" for f in seg.ssts)
        pushed = ", pushdown=yes" if plan.pushdown is not None else ""
        lines.append(f"    ParquetScan: files=[{files}], "
                     f"columns={seg.columns}{pushed}")
    return "\n".join(lines)
