"""Merge-scan read path — the north-star pipeline (PyTorch port).

Per time segment (ref: src/storage/src/read.rs:429-494):

  SegmentRead (host, async)  — sidecar columns first, parquet on a miss
  Merge (host, numpy)        — k-way-merge permutation over the
                               pre-sorted SST runs + keep-last dedup,
                               cut into PK-range windows
  Filter (host mask)         — predicate tree -> row mask (gid -1)
  FusedAggregate (device)    — rounds of windows go host-to-device as
                               one stack per array; each round is ONE
                               bucket_window_partials launch plus an
                               in-place scatter into a query-global
                               accumulator; only the final grids leave
                               the device

Row scans decode the merged windows back to Arrow on the host.  Post-
merge windows are cached per segment (storage/scan_cache.py), so a
repeat query skips the read and the merge.

Only OVERWRITE (last-value) tables are served; the JAX package's Append
merge, parts path, device decode, mesh rounds and stack/replay caches
are not ported yet.  The JAX package gated the fused aggregate to
accelerator backends; here it is the one aggregate path, and it runs on
whatever device the reader was opened for.
"""

from __future__ import annotations

import asyncio
import logging
import threading
import time
from dataclasses import dataclass
from typing import AsyncIterator, Optional

import numpy as np
import pyarrow as pa

from horaedb_tpu_torch.common.error import ensure
from horaedb_tpu_torch.objstore import NotFoundError, ObjectStore
from horaedb_tpu_torch.ops import bucket_agg, encode, filter as filter_ops
from horaedb_tpu_torch.ops.downsample import ALL_AGGS, canonical_which
from horaedb_tpu_torch.storage import parquet_io, sidecar
from horaedb_tpu_torch.storage.config import StorageConfig, UpdateMode
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
from horaedb_tpu_torch.utils import registry

logger = logging.getLogger(__name__)

_ROWS_SCANNED = registry.counter(
    "storage_rows_scanned_total", "rows produced by merge-scan")
_STAGE_SECONDS = {
    s: registry.histogram(f"scan_stage_seconds:{s}",
                          f"wall seconds in the {s} plan stage")
    for s in ("segment_read", "merge", "stack_build", "device_aggregate")
}
# rows -> bytes conversion for the cache_max_rows knob: a typical engine
# window is ~4 int32/f32 columns (16B) plus the memo allowance
_CACHE_BYTES_PER_ROW = 32
# accumulator identity of `last_ts` (and of an empty cell's partial)
_ACC_TS_MIN = -(2**31)
_F32_MAX = float(np.finfo(np.float32).max)

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
        ensure(schema.update_mode is UpdateMode.OVERWRITE,
               "the port serves OVERWRITE tables only")
        cache_bytes = (config.scan.cache_max_bytes
                       or config.scan.cache_max_rows * _CACHE_BYTES_PER_ROW)
        self.cache_budget_bytes = cache_bytes
        self.scan_cache = ScanCache(cache_bytes)
        # SST ids whose sidecar is known missing or invalid (ids are
        # immutable, and a sidecar is written before its SST becomes
        # visible, so a miss is permanent)
        self._sidecar_missing: set = set()

    def close(self) -> None:
        self.scan_cache.clear()
        self._sidecar_missing.clear()

    # ---- plan construction -------------------------------------------------

    def build_plan(self, ssts: list[SstFile], request: ScanRequest,
                   keep_builtin: bool = False) -> ScanPlan:
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
                        range=request.range)

    # ---- row scans ---------------------------------------------------------

    async def execute(self, plan: ScanPlan) -> AsyncIterator[pa.RecordBatch]:
        """Row scan: one Arrow batch per non-empty merge window, in
        segment order."""
        windows_iter = self._cached_windows(plan)
        try:
            async for seg, windows in windows_iter:
                for w in windows:
                    part = await self._run_pool(
                        self._window_to_arrow, w,
                        list(seg.columns), plan)
                    if part is not None and part.num_rows:
                        part = self._strip_builtin(part, plan)
                        _ROWS_SCANNED.inc(part.num_rows)
                        yield part
        finally:
            await windows_iter.aclose()

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
        pushdown) is unchanged, else by reading and merging (with up to
        `prefetch_segments` segments in flight) and populating the
        cache."""
        sem = asyncio.Semaphore(max(1, self.config.scan.prefetch_segments))
        tasks: dict[int, asyncio.Task] = {}
        cached: dict[int, list] = {}
        for seg in plan.segments:
            windows = self.scan_cache.get(self._cache_key(seg, plan))
            if windows is not None:
                cached[id(seg)] = windows

        async def load(seg: SegmentPlan) -> list:
            async with sem:
                t0 = time.perf_counter()
                table = await self._read_segment_any(seg, plan)
                _STAGE_SECONDS["segment_read"].observe(
                    time.perf_counter() - t0)
                return await self._run_pool(self._merge_segment, table)

        try:
            for seg in plan.segments:
                if id(seg) not in cached:
                    tasks[id(seg)] = asyncio.ensure_future(load(seg))
            for seg in plan.segments:
                if id(seg) in cached:
                    yield seg, cached[id(seg)]
                    continue
                windows = await tasks.pop(id(seg))
                self.scan_cache.put(self._cache_key(seg, plan), windows)
                yield seg, windows
        finally:
            # deterministic teardown: no read may outlive the scan
            for t in tasks.values():
                t.cancel()
            await asyncio.gather(*tasks.values(), return_exceptions=True)

    async def _run_pool(self, fn, *args, **kwargs):
        """CPU work (parquet codec, host merge, numpy prep, device
        dispatch) runs on the `sst` worker pool, never on the event loop
        (ref: dedicated runtimes, storage.rs:91-104)."""
        return await parquet_io._run(self.runtimes, "sst", fn, *args,
                                     **kwargs)

    async def _read_segment_any(self, seg: SegmentPlan, plan: ScanPlan):
        """One segment's read: sidecars first, parquet when any SST's
        sidecar is missing or invalid (a data-format choice, not a
        device fallback).  Returns an EncodedSegment or a pa.Table."""
        if self._sidecar_plan_ok(plan):
            es = await self._read_segment_encoded(seg, plan)
            if es is not None:
                return es
        return await self._read_segment_table(seg, plan)

    def _sidecar_plan_ok(self, plan: ScanPlan) -> bool:
        """Sidecars serve a plan whose pushdown (when present) has a leaf
        conjunction the host can evaluate in encoded space."""
        if not self.config.scan.use_sidecar:
            return False
        return plan.pushdown is None or plan.prune_leaves is not None

    async def _read_segment_encoded(self, seg: SegmentPlan, plan: ScanPlan
                                    ) -> Optional[sidecar.EncodedSegment]:
        if any(f.id in self._sidecar_missing for f in seg.ssts):
            return None
        leaves = plan.prune_leaves
        want = set(seg.columns) | {lf.column for lf in leaves or []}

        def runner(fn, *args):
            return self._run_pool(fn, *args)

        got = await asyncio.gather(*(
            sidecar.load_sst_encoded(
                self.store, sidecar.sidecar_path(self.root_path, f.id),
                want, runner=runner)
            for f in seg.ssts), return_exceptions=True)
        for f, res in zip(seg.ssts, got):
            if isinstance(res, NotFoundError) or res is None:
                self._sidecar_missing.add(f.id)
                return None
            if isinstance(res, BaseException):
                # transient store failure: the sidecar is a cache — the
                # parquet read is authoritative
                logger.warning("sidecar fetch failed for sst %s: %s",
                               f.id, res)
                return None
        try:
            return await runner(sidecar.assemble_parts, list(got),
                                list(seg.columns), leaves)
        except Exception as exc:  # noqa: BLE001 — cache read only
            logger.warning("sidecar assembly raised for segment %s: %s",
                           seg.segment_start, exc)
            return None

    async def _read_segment_table(self, seg: SegmentPlan,
                                  plan: ScanPlan) -> pa.Table:
        tables = await asyncio.gather(*(
            parquet_io.read_sst(self.store, sst_path(self.root_path, f.id),
                                columns=seg.columns, filters=plan.pushdown,
                                runtimes=self.runtimes)
            for f in seg.ssts))
        return pa.concat_tables(tables)

    def _pk_names_in(self, columns: list[str]) -> list[str]:
        """PK names present, in SCHEMA order — the merge must sort by the
        declared key order even when a projection reordered columns."""
        present = set(columns)
        return [n for n in self.schema.primary_key_names if n in present]

    def _merge_segment(self, table) -> list:
        """Pool-side encode + host merge of one segment's read result
        (pa.Table or sidecar.EncodedSegment) into post-merge windows."""
        t0 = time.perf_counter()
        try:
            if isinstance(table, sidecar.EncodedSegment):
                return self._merge_windows(_encoded_to_device_batch(table),
                                           list(table.names))
            if table.num_rows == 0:
                return []
            batch = table.combine_chunks().to_batches()[0]
            return self._merge_windows(encode.encode_batch(batch),
                                       list(batch.schema.names))
        finally:
            _STAGE_SECONDS["merge"].observe(time.perf_counter() - t0)

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

    # ---- fused aggregate ---------------------------------------------------

    async def execute_aggregate_fused(self, plan: ScanPlan,
                                      spec: AggregateSpec):
        """Merge + downsample with a QUERY-GLOBAL device accumulator:
        rounds of stacked windows aggregate and scatter into one
        (groups, buckets) grid set on the device; nothing is downloaded
        until the final grids.

        Two-phase: all windows are collected first so the union group
        space is known before any round runs (remap targets global rows
        directly).

        Returns (group_values, grids): grids are tensors on the reader's
        device, except `last_ts`, which comes back as host float64
        absolute ms (int64 range needed)."""
        items: list = []
        windows_iter = self._cached_windows(plan)
        try:
            async for seg, windows in windows_iter:
                s = seg.segment_start

                def prep(ws=windows, s=s):
                    out = []
                    for w in ws:
                        _ROWS_SCANNED.inc(w.n_valid)
                        pr = self._window_groups(w, spec, plan)
                        if pr is not None:
                            out.append((s, w, pr))
                    return out

                items.extend(await self._run_pool(prep))
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

        def build_rounds():
            # lazy: the next round's stacks are built while the device
            # still runs the previous round's launches
            i = 0
            while i < len(items):
                chunk = items[i:i + max_w]
                batch_w = min(max_w, 1 << (len(chunk) - 1).bit_length())
                cap = max(it[1].capacity for it in chunk)
                yield self._build_round_stacks(chunk, spec, batch_w, cap,
                                               g_pad, all_values, local_ok)
                i += len(chunk)

        grids = await self._run_pool(
            self._fused_run_device_rounds, build_rounds(), spec,
            g, g_pad, width)
        all_values, grids = _drop_empty_groups_dev(all_values, grids)
        return all_values, _fused_last_ts_to_abs(grids, spec)

    def _fused_run_device_rounds(self, rounds, spec: AggregateSpec, g: int,
                                 g_pad: int, width: int) -> dict:
        """acc init -> one accumulate per round -> finalize -> slice to
        g -> synchronize."""
        import torch

        t0 = time.perf_counter()
        acc = fused_acc_init(num_groups=g_pad, num_buckets=spec.num_buckets,
                             which=spec.which, device=self.device)
        for ts_s, gid_s, val_s, remap_d, shift_d, lo_d, lo_h in rounds:
            fused_round_accumulate(acc, ts_s, gid_s, val_s, remap_d, shift_d,
                                   lo_d, lo_h, spec.num_buckets,
                                   spec.bucket_ms, num_groups=g_pad,
                                   width=width, which=spec.which)
        final = fused_finalize(acc, spec.which)
        out = {k: v[:g] for k, v in final.items()}
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize(self.device)
        _STAGE_SECONDS["device_aggregate"].observe(time.perf_counter() - t0)
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

    def _build_round_stacks(self, items: list, spec: AggregateSpec,
                            batch_w: int, cap: int, g_pad: int,
                            group_space: np.ndarray, local_ok: bool):
        """Stack one round of host windows in numpy and copy each array
        to the device once.  Windows past len(items) pad the round with
        no-op rows (gid -1).  Returns (ts, gid, val, remap, shift, lo)
        on the device plus lo on the host (the scatter's slice bounds)."""
        t0 = time.perf_counter()
        ts_m = np.zeros((batch_w, cap), dtype=np.int32)
        gid_m = np.full((batch_w, cap), -1, dtype=np.int32)
        val_m = np.zeros((batch_w, cap), dtype=np.float32)
        remap = np.zeros((batch_w, g_pad), dtype=np.int32)
        shift = np.zeros(batch_w, dtype=np.int32)
        lo = np.zeros(batch_w, dtype=np.int32)
        for d, (_seg_start, w, (values, gid, sh)) in enumerate(items):
            ts_m[d, :w.capacity] = w.columns[spec.ts_col]
            gid_m[d, :w.capacity] = gid
            val_m[d, :w.capacity] = w.columns[spec.value_col]
            remap[d, :len(values)] = np.searchsorted(group_space, values)
            shift[d] = sh
            if local_ok:
                lo[d] = max(0, sh // spec.bucket_ms)
        put = lambda a: encode.to_device(a, self.device)
        out = (put(ts_m), put(gid_m), put(val_m), put(remap), put(shift),
               put(lo), lo)
        _STAGE_SECONDS["stack_build"].observe(time.perf_counter() - t0)
        return out


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
                           num_groups: int, width: int, which: tuple) -> dict:
    """One round of windows aggregated (one bucket_window_partials
    launch) AND scattered into the query-global accumulator.

    `acc` is updated IN PLACE round over round (the JAX program donated
    its accumulator buffers for the same effect).  Window d's grid
    covers global buckets [lo[d], lo[d] + width); columns past `total`
    are dropped, like the JAX scatter's mode="drop".  The scatter is a
    slice update per window, in window order: count/sum add, min/max
    fold, and `last` takes the window's value where its absolute ts is
    >= the accumulator's (the later window wins ties)."""
    import torch

    p = bucket_agg.bucket_window_partials(
        ts, gid, vals, remap, shift, lo, total, bucket_ms,
        num_groups=num_groups, width=width, which=which)
    for d in range(ts.shape[0]):
        c0 = int(lo_host[d])
        n = min(width, total - c0)
        if n <= 0:
            continue
        cols = slice(c0, c0 + n)
        acc["count"][:, cols] += p["count"][d, :, :n]
        if "sum" in acc:
            acc["sum"][:, cols] += p["sum"][d, :, :n]
        if "min" in acc:
            acc["min"][:, cols] = torch.minimum(acc["min"][:, cols],
                                                p["min"][d, :, :n])
        if "max" in acc:
            acc["max"][:, cols] = torch.maximum(acc["max"][:, cols],
                                                p["max"][d, :, :n])
        if "last" in acc:
            cur_ts = acc["last_ts"][:, cols]
            cur_last = acc["last"][:, cols]
            win_has = p["count"][d, :, :n] > 0
            win_ts = torch.where(win_has,
                                 p["last_ts"][d, :, :n] + c0 * bucket_ms,
                                 torch.full_like(cur_ts, _ACC_TS_MIN))
            take = win_has & (win_ts >= cur_ts)
            acc["last"][:, cols] = torch.where(take, p["last"][d, :, :n],
                                               cur_last)
            acc["last_ts"][:, cols] = torch.where(take, win_ts, cur_ts)
    return acc


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


def plan_columns(schema: StorageSchema,
                 projections: Optional[list[int]]) -> list[str]:
    """The column set a merge plan reads for a projection."""
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

