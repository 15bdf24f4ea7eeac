"""Standing rollups: incremental materialized downsample tiers (the
port's copy of the JAX package's rollup/manager.py).

A standing query registered per (metric, field) is maintained as
pre-aggregated cells — one row per (metric_id, tsid, field_id,
bucket_ts) holding the count/sum/min/max/last partials the downsample
grid needs — in one extra Overwrite-mode table per tier (e.g. 1m and
1h), stored alongside the raw SSTs and riding the same manifest,
compaction, scrub and cache machinery, on the engine's device.

Maintenance is SEGMENT-granular and recompute-from-raw:

  write/flush  -> the engine notes the touched raw segments dirty
  roll pass    -> every dirty/unfingerprinted segment without a live
                  memtable is re-aggregated from raw SSTs through the
                  engine's own downsample pushdown, its cells written
                  (Overwrite: a re-roll supersedes old cells under the
                  last-value `__seq__` rule), and its SST fingerprint
                  recorded
  state        -> {seq watermark, segment -> SST-id fingerprint} is
                  persisted to the object store only AFTER the cells
                  land; a crash in between just re-rolls (idempotent)

Rollup state never trusts a partial update: on open, any segment whose
current SST set differs from its recorded fingerprint is dirty again,
and acked-but-unflushed rows are excluded via the live memtable map.

Serving: the planner (MetricEngine.query_downsample) consults `covers()`
and `try_serve()`.  A query is rollup-served when its bucket matches a
tier exactly and its range is bucket-aligned; covered segments read
cells, while dirty/unrolled segments — the not-yet-rolled tail — are
recomputed from raw.

The recompute route.  Both the maintenance recompute and the raw tail
run on the PARTS route (host float64 combine of per-segment partial
grids), whatever the fused gate would pick for the same scan: the cell
encoding below stores exact f64 accumulators, and the fused route's
grids are float32.  So a rollup-served grid equals a from-raw recompute
on the parts route byte for byte, dtype included, and a recompute on
the fused route within its own tolerance contract (count, min, max and
last exact after a cast to f64; sum and avg rtol 1e-5).  The JAX
package lets the fused gate choose, and its maintenance fails on the
fused route (ROADMAP Queue C 7).
"""

from __future__ import annotations

import asyncio
import json
import logging
import time
from dataclasses import dataclass, field as dc_field
from typing import Optional

import numpy as np
import pyarrow as pa

from horaedb_tpu_torch.common.error import ensure
from horaedb_tpu_torch.common.loops import loops
from horaedb_tpu_torch.common.memledger import ledger as memledger
from horaedb_tpu_torch.objstore import NotFoundError, ObjectStore
from horaedb_tpu_torch.ops.downsample import ALL_AGGS
from horaedb_tpu_torch.ops.filter import And, Eq, In, TimeRangePred
from horaedb_tpu_torch.rollup.config import RollupConfig
from horaedb_tpu_torch.storage.read import ScanRequest
from horaedb_tpu_torch.storage.types import TimeRange, Timestamp
from horaedb_tpu_torch.utils import (WIDE_BUCKETS, op_trace, registry, span,
                                     trace_add)

logger = logging.getLogger(__name__)

# the partials every grid aggregate derives from (avg = sum/count at
# assembly, the raw combine's formula); maintenance requests these so
# stored cells are `which`-independent
ROLLUP_AGGS = ("count", "last", "max", "min", "sum")

# The scan path encodes float value columns to f32, so a stored cell
# value only survives the write->scan round trip if it is exactly
# f32-representable.  min/max/last are (they equal some f32-encoded
# sample value); the f64 accumulators count/sum are not, so they are
# stored as an exact three-way float32 split (hi = f32(v), md = f32(v -
# hi), lo = v - hi - md; summing the parts back in f64 is exact because
# they never overlap), and last_ts is stored relative to its bucket
# start (an integer < tier_ms < 2^24, f32-exact) and rebased at
# assembly.
_CELL_VALUE_COLS = ("count_hi", "count_md", "count_lo",
                    "sum_hi", "sum_md", "sum_lo",
                    "min", "max", "last", "last_ts_rel")

# cell schema: PK (metric_id, tsid, field_id, bucket_ts) + the stored
# partials.  Overwrite mode: a re-rolled bucket's new cell supersedes
# the old one in the merge, like any other last-value update.
CELL_SCHEMA = pa.schema(
    [("metric_id", pa.uint64()), ("tsid", pa.uint64()),
     ("field_id", pa.uint64()), ("bucket_ts", pa.int64())]
    + [(c, pa.float64()) for c in _CELL_VALUE_COLS])
CELL_NUM_PKS = 4

# a tier bucket must stay under 2^24 ms (~4.6 h) so last_ts_rel is an
# exactly f32-representable integer
_TIER_MS_MAX = 1 << 24


def _split3(v: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Exact triple-float split of finite f64 values: v == hi + md + lo
    with every part f32-representable (so each survives the scan
    path's f32 encode) and the f64 re-sum exact."""
    hi = v.astype(np.float32).astype(np.float64)
    r = v - hi
    md = r.astype(np.float32).astype(np.float64)
    lo = r - md
    return hi, md, lo


def _host(grid) -> np.ndarray:
    """A result grid as a host array, at the manager's numpy boundary
    (a fused-route grid would be a tensor on the engine's device)."""
    if hasattr(grid, "cpu"):
        return grid.cpu().numpy()
    return np.asarray(grid)


_SERVED = registry.counter(
    "rollup_served_queries_total",
    "downsample queries answered from a rollup tier "
    "(labels: table=metric, tier)")
_FALLBACK = registry.counter(
    "rollup_fallback_queries_total",
    "rollup-shaped queries that fell back to the raw scan "
    "(no covered segment)")
_PASSES = registry.counter(
    "rollup_roll_passes_total", "rollup maintenance passes")
_SEGMENTS_ROLLED = registry.counter(
    "rollup_segments_rolled_total",
    "raw segments (re)aggregated into rollup cells")
_CELLS_WRITTEN = registry.counter(
    "rollup_cells_written_total",
    "pre-aggregated cells written to rollup tiers")
_ROLL_SECONDS = registry.histogram(
    "rollup_roll_seconds",
    "per-segment roll latency (aggregate from raw + cell writes, all "
    "tiers)", buckets=WIDE_BUCKETS)
_LAG = registry.gauge(
    "rollup_lag_seqs",
    "newest raw write seq minus the newest seq incorporated into the "
    "rollup (labels: table=metric, field)")


async def _collect(stream) -> list[pa.RecordBatch]:
    return [b async for b in stream]


@dataclass
class RollupSpec:
    """One standing downsample query + its maintenance state."""

    metric: str
    field: str
    metric_id: int
    field_id: int
    # seg_start -> sorted SST-id fingerprint at roll time (persisted)
    rolled: dict[int, list[int]] = dc_field(default_factory=dict)
    # newest raw seq incorporated at the last successful pass (persisted)
    seq: int = 0
    # segments noted dirty since the last pass (in-memory; recovered on
    # open by diffing fingerprints against the live manifest)
    dirty: set[int] = dc_field(default_factory=set)
    # segments whose re-roll is IN FLIGHT this pass: coverage keeps
    # treating them as dirty until their fresh cells commit
    rolling: set[int] = dc_field(default_factory=set)
    # segments whose grid values cannot round-trip the cell encoding
    # (e.g. a sum beyond float32 range): raw-served until new data
    # dirties them
    unrollable: set[int] = dc_field(default_factory=set)
    served_queries: int = 0
    fallback_queries: int = 0

    @property
    def key(self) -> tuple[str, str]:
        return (self.metric, self.field)


class RollupManager:
    """Owns the tier tables, the standing-query registry, the
    maintenance loop, and the serve-time coverage API."""

    def __init__(self, tiers: dict[int, object], tier_names: dict[int, str],
                 store: ObjectStore, state_prefix: str, segment_ms: int,
                 config: RollupConfig, data_table):
        self.tiers = tiers  # tier_ms -> CloudObjectStorage
        self.tier_names = tier_names
        self.store = store
        self.state_prefix = state_prefix.rstrip("/")
        self.segment_ms = segment_ms
        self.config = config
        self._data = data_table
        self._engine = None  # attach() after MetricEngine construction
        self.specs: dict[tuple[str, str], RollupSpec] = {}
        self._roll_lock = asyncio.Lock()
        self._wake: Optional[asyncio.Event] = None
        self._task: Optional[asyncio.Task] = None
        self._stopping = False

    # ---- lifecycle --------------------------------------------------------

    @classmethod
    async def open(cls, root_path: str, store: ObjectStore, segment_ms: int,
                   config: RollupConfig, storage_config, runtimes,
                   data_table, device="cuda") -> "RollupManager":
        """Open the tier tables under `{root_path}/rollup/` on `device`
        (the engine's), recover persisted specs and register the
        configured ones, then start the maintenance loop."""
        import dataclasses

        from horaedb_tpu_torch.storage.config import (StorageConfig,
                                                      UpdateMode)
        from horaedb_tpu_torch.storage.storage import CloudObjectStorage

        tier_ms_list = config.tier_millis()
        for t in tier_ms_list:
            ensure(segment_ms % t == 0,
                   f"[rollup] tier {t}ms must evenly divide the segment "
                   f"duration ({segment_ms}ms): maintenance and serving "
                   "are segment-granular")
            ensure(t < _TIER_MS_MAX,
                   f"[rollup] tier {t}ms too coarse: bucket-relative "
                   f"last_ts must stay f32-exact (< {_TIER_MS_MAX}ms)")
        cfg = dataclasses.replace(storage_config or StorageConfig(),
                                  update_mode=UpdateMode.OVERWRITE)
        tiers: dict[int, object] = {}
        names: dict[int, str] = {}
        try:
            for name, tier_ms in zip(config.tiers, tier_ms_list):
                tiers[tier_ms] = await CloudObjectStorage.open(
                    f"{root_path}/rollup/{name}", segment_ms, store,
                    CELL_SCHEMA, CELL_NUM_PKS, cfg, runtimes=runtimes,
                    device=device)
                names[tier_ms] = name
        except BaseException:
            for t in tiers.values():
                await t.close()
            raise
        self = cls(tiers, names, store, f"{root_path}/rollup/_state",
                   segment_ms, config, data_table)
        try:
            await self._recover()
            for metric, fld in config.spec_pairs():
                if (metric, fld) not in self.specs:
                    await self.register(metric, fld)
        except BaseException:
            # a failed recover/registration must not leak the tier
            # tables' compaction schedulers
            for t in tiers.values():
                await t.close()
            raise
        self._wake = asyncio.Event()
        # threshold sized to a whole-table registration backfill, the
        # longest legitimate pass
        self._task = loops.spawn(
            self._loop, name=f"rollup:{root_path}", kind="rollup",
            owner="rollup", period_s=config.roll_interval.seconds,
            stall_threshold_s=600.0, backlog=self._backlog)
        # memory plane: the maintenance state — per-segment SST-id
        # fingerprints + dirty/rolling/unrollable sets — grows with
        # segment count (the tier tables' caches register via their own
        # readers)
        self._mem_account = memledger.register(
            f"rollup_state:{root_path}",
            lambda m: m.state_bytes(), anchor=self,
            kind="rollup_state", owner=root_path)
        if self.specs:
            # recovered/config-registered specs may have pending work
            # (their register()-time wake predates the event existing)
            self.wake()
        return self

    def attach(self, engine) -> None:
        """Back-reference to the MetricEngine whose downsample pushdown
        performs both maintenance recomputes and raw-tail serving."""
        self._engine = engine

    async def close(self) -> None:
        self._stopping = True
        if self._task is not None:
            self._wake.set()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        for t in self.tiers.values():
            await t.close()
        memledger.deregister(getattr(self, "_mem_account", None))
        self._mem_account = None

    def state_bytes(self) -> int:
        """Estimated host bytes of the in-memory maintenance state
        (the ledger's pull gauge): 28 B per small int + 56 B per list
        header for the fingerprints, 64 B per set member."""
        total = 0
        for spec in self.specs.values():
            total += 64 * (len(spec.dirty) + len(spec.rolling)
                           + len(spec.unrollable))
            total += sum(56 + 28 * len(ids)
                         for ids in spec.rolled.values())
        return total

    def _backlog(self) -> dict:
        """The watchdog's backlog hint: segments awaiting (or refused)
        a roll."""
        return {
            "dirty_segments": sum(len(s.dirty)
                                  for s in self.specs.values()),
            "rolling_segments": sum(len(s.rolling)
                                    for s in self.specs.values()),
            "unrollable_segments": sum(len(s.unrollable)
                                       for s in self.specs.values()),
            "specs": len(self.specs),
        }

    async def _recover(self) -> None:
        """Load persisted specs; any rolled segment whose CURRENT SST
        set differs from its recorded fingerprint is dirty again."""
        try:
            listing = await self.store.list(self.state_prefix + "/")
        except NotFoundError:
            listing = []
        for meta in listing:
            try:
                data = json.loads(await self.store.get(meta.path))
                spec = RollupSpec(
                    metric=data["metric"], field=data["field"],
                    metric_id=int(data["metric_id"]),
                    field_id=int(data["field_id"]),
                    rolled={int(k): [int(i) for i in v]
                            for k, v in data.get("rolled", {}).items()},
                    seq=int(data.get("seq", 0)))
            except (KeyError, ValueError, TypeError) as exc:
                logger.warning("rollup: dropping unreadable state %s: %s",
                               meta.path, exc)
                continue
            self.specs[spec.key] = spec
        if self.specs:
            by_seg = await self._data_fingerprints()
            for spec in self.specs.values():
                stale = {seg for seg, fp in spec.rolled.items()
                         if by_seg.get(seg) != fp}
                spec.dirty |= stale
                if stale:
                    logger.info(
                        "rollup %s:%s: %d segment(s) changed since the "
                        "last pass; re-rolling", spec.metric, spec.field,
                        len(stale))

    # ---- registration -----------------------------------------------------

    async def register(self, metric: str, field: str = "value"
                       ) -> RollupSpec:
        """Register a standing downsample query.  Idempotent; the
        initial backfill happens on the next maintenance pass (or an
        explicit roll_now)."""
        from horaedb_tpu_torch.metric_engine.types import (field_id_of,
                                                           metric_id_of)

        ensure(bool(metric), "rollup metric must be non-empty")
        spec = self.specs.get((metric, field))
        if spec is None:
            spec = RollupSpec(metric=metric, field=field,
                              metric_id=metric_id_of(metric),
                              field_id=field_id_of(field))
            self.specs[spec.key] = spec
            await self._persist(spec)
            logger.info("rollup registered: %s:%s (tiers %s)", metric,
                        field, sorted(self.tiers))
        self.wake()
        return spec

    def _state_path(self, spec: RollupSpec) -> str:
        return (f"{self.state_prefix}/"
                f"{spec.metric_id:016x}_{spec.field_id:016x}.json")

    async def _persist(self, spec: RollupSpec) -> None:
        payload = json.dumps({
            "metric": spec.metric, "field": spec.field,
            "metric_id": spec.metric_id, "field_id": spec.field_id,
            "seq": spec.seq,
            "rolled": {str(k): v for k, v in sorted(spec.rolled.items())},
        }).encode()
        await self.store.put(self._state_path(spec), payload)

    # ---- delta feed -------------------------------------------------------

    def note_write(self, segs_by_metric: dict) -> None:
        """Ingest-path hook: rows were just acked — mark exactly the
        segments that received samples dirty, per metric."""
        woke = False
        for spec in self.specs.values():
            segs = segs_by_metric.get(spec.metric)
            if segs:
                spec.dirty |= segs
                spec.unrollable -= segs  # new data: worth re-trying
                woke = True
        if woke:
            self.wake()

    def note_flush(self, segment_start: int) -> None:
        """A memtable just drained to an SST: the segment becomes
        rollable (it was dirty since its writes acked)."""
        del segment_start
        self.wake()

    def wake(self) -> None:
        if self._wake is not None:
            self._wake.set()

    # ---- maintenance ------------------------------------------------------

    async def _loop(self, hb) -> None:
        interval = self.config.roll_interval.seconds
        while not self._stopping:
            try:
                await asyncio.wait_for(self._wake.wait(), interval)
            except asyncio.TimeoutError:
                pass
            hb.beat()
            self._wake.clear()
            if self._stopping:
                return
            try:
                await self.roll_now()
                hb.ok()
            except asyncio.CancelledError:
                raise
            except Exception as exc:  # noqa: BLE001 — retried next tick
                hb.error(exc)
                logger.exception("rollup maintenance pass failed")

    async def _data_fingerprints(self) -> dict[int, list[int]]:
        from horaedb_tpu_torch.storage.sst import segment_of

        ssts = await self._data.manifest.all_ssts()
        by_seg: dict[int, list[int]] = {}
        for f in ssts:
            by_seg.setdefault(segment_of(f, self.segment_ms),
                              []).append(f.id)
        return {seg: sorted(ids) for seg, ids in by_seg.items()}

    def _memtable_segments(self) -> set[int]:
        fn = getattr(self._data, "memtable_segments", None)
        return fn() if fn is not None else set()

    async def roll_now(self) -> dict:
        """One maintenance pass over every spec: recompute dirty /
        unfingerprinted segments from raw, write their cells, persist
        state.  Returns {"metric:field": segments_rolled}."""
        ensure(self._engine is not None, "rollup manager not attached")
        out = {}
        async with self._roll_lock:
            _PASSES.inc()
            # one op trace per maintenance pass (a traced caller keeps
            # the scope)
            with op_trace("rollup_pass", slow_s=600.0,
                          specs=len(self.specs)):
                for spec in list(self.specs.values()):
                    rolled = await self._roll_spec(spec)
                    out[f"{spec.metric}:{spec.field}"] = rolled
        return out

    async def _roll_spec(self, spec: RollupSpec) -> int:
        # snapshot the pending notes: anything arriving mid-pass lands
        # in the fresh set and survives to the next pass.  Snapshotted
        # segments immediately enter `rolling` so coverage keeps
        # treating them as dirty until their fresh cells commit.
        taken, spec.dirty = spec.dirty, set()
        spec.rolling |= taken
        done = 0
        try:
            by_seg = await self._data_fingerprints()
            mem_segs = self._memtable_segments()
            target = (set(by_seg) | taken) - spec.unrollable
            to_roll = sorted(
                seg for seg in target
                if seg in taken or spec.rolled.get(seg) != by_seg.get(seg))
            spec.rolling |= set(to_roll)
            # acked-but-unflushed rows keep their segment dirty: reads
            # get them through the raw tail until the flush lands
            to_roll = [seg for seg in to_roll if seg not in mem_segs]
            for seg in to_roll:
                t0 = time.perf_counter()
                with span("rollup_roll", metric=spec.metric,
                          segment=seg):
                    ok = await self._roll_segment(spec, seg)
                spec.rolling.discard(seg)
                if not ok:
                    # grid values that cannot round-trip the cell
                    # encoding: this segment stays raw-served (not
                    # dirty — that would re-scan it every pass) until
                    # new data arrives
                    spec.unrollable.add(seg)
                    spec.rolled.pop(seg, None)
                    continue
                spec.rolled[seg] = by_seg.get(seg, [])
                done += 1
                _SEGMENTS_ROLLED.inc()
                _ROLL_SECONDS.observe(time.perf_counter() - t0)
        finally:
            # an interrupted or partial pass leaves every unfinished
            # segment dirty, never half-covered
            spec.dirty |= spec.rolling
            spec.rolling.clear()
            if done:
                incorporated = [i for ids in spec.rolled.values()
                                for i in ids]
                spec.seq = max([spec.seq] + incorporated)
                await self._persist(spec)
                await self._refresh_lag(spec)
        return done

    async def _roll_segment(self, spec: RollupSpec, seg: int) -> bool:
        """Recompute one raw segment's cells for every tier through the
        engine's own downsample pushdown on the parts route (the route
        the raw tail takes too).  False when the segment's values
        cannot be stored faithfully."""
        rng = TimeRange.new(seg, seg + self.segment_ms)
        pred = And([Eq("metric_id", spec.metric_id),
                    Eq("field_id", spec.field_id)])
        for tier_ms, table in sorted(self.tiers.items()):
            nb = self.segment_ms // tier_ms
            out = await self._engine._scan_downsample(
                pred, rng, tier_ms, nb, ROLLUP_AGGS, parts_route=True)
            if not await self._write_cells(spec, table, tier_ms, seg,
                                           out):
                return False
            if not out["tsids"]:
                # no rows of this metric in the segment: every tier is
                # empty — skip the remaining tiers' scans
                break
        return True

    async def _write_cells(self, spec: RollupSpec, table, tier_ms: int,
                           seg: int, out: dict) -> bool:
        from horaedb_tpu_torch.storage.storage import WriteRequest

        if not out["tsids"]:
            return True
        grids = {k: _host(v) for k, v in out["aggs"].items()}
        tsids = np.asarray(out["tsids"], dtype=np.uint64)
        gi, bi = np.nonzero(grids["count"] > 0)
        if len(gi) == 0:
            return True
        bucket_ts = seg + bi.astype(np.int64) * tier_ms
        n = len(gi)

        def cell(name: str) -> np.ndarray:
            return np.ascontiguousarray(
                grids[name][gi, bi].astype(np.float64, copy=False))

        count, sum_ = cell("count"), cell("sum")
        cols = (_split3(count) + _split3(sum_)
                + (cell("min"), cell("max"), cell("last"),
                   cell("last_ts") - bucket_ts))
        # the byte-identity contract enforced at WRITE time: simulate
        # the read path's f32 value-column encode over every stored
        # column and require the accumulators to reassemble exactly — a
        # value that cannot round-trip (e.g. a sum beyond f32 range)
        # would silently diverge from the raw path, so its segment
        # stays raw-served instead
        rb = [c.astype(np.float32).astype(np.float64) for c in cols]
        faithful = all(np.array_equal(a, b, equal_nan=True)
                       for a, b in zip(cols, rb)) \
            and np.array_equal((rb[0] + rb[1]) + rb[2], count,
                               equal_nan=True) \
            and np.array_equal((rb[3] + rb[4]) + rb[5], sum_,
                               equal_nan=True)
        if not faithful:
            logger.warning(
                "rollup %s:%s segment %d: grid values cannot round-trip "
                "the cell encoding; segment stays raw-served",
                spec.metric, spec.field, seg)
            return False
        batch = pa.record_batch(
            [pa.array(np.full(n, spec.metric_id, dtype=np.uint64)),
             pa.array(tsids[gi]),
             pa.array(np.full(n, spec.field_id, dtype=np.uint64)),
             pa.array(bucket_ts, type=pa.int64())]
            + [pa.array(c) for c in cols],
            schema=CELL_SCHEMA)
        await table.write(WriteRequest(
            batch, TimeRange.new(int(bucket_ts.min()),
                                 int(bucket_ts.max()) + tier_ms)))
        _CELLS_WRITTEN.inc(n)
        trace_add("rollup_cells_rows", n)
        return True

    async def _refresh_lag(self, spec: RollupSpec) -> None:
        newest = await self._newest_raw_seq()
        _LAG.labels(table=spec.metric,
                    field=spec.field).set(self._lag(spec, newest))

    async def _newest_raw_seq(self) -> int:
        ssts = await self._data.manifest.all_ssts()
        newest = max([f.meta.max_sequence for f in ssts], default=0)
        return max(newest, getattr(self._data, "last_seq", 0))

    def _lag(self, spec: RollupSpec, newest: int) -> int:
        """Newest raw seq minus the true incorporation watermark: the
        max rolled SST id, FLOORED by the oldest acked-but-unflushed
        seq — rows sitting in memtables are not in any tier."""
        w = spec.seq
        oldest_fn = getattr(self._data, "oldest_unflushed_seq", None)
        if oldest_fn is not None:
            oldest = oldest_fn()
            if oldest is not None:
                w = min(w, oldest - 1)
        return max(0, newest - w)

    # ---- serving ----------------------------------------------------------

    def covers(self, metric: str, field: str, bucket_ms: int,
               time_range: TimeRange) -> bool:
        """Cheap static coverage check the planner gates on: a standing
        query exists, the bucket matches a tier exactly, and the range
        is bucket-aligned (cells live on the absolute bucket grid)."""
        if (metric, field) not in self.specs or bucket_ms not in self.tiers:
            return False
        start, end = int(time_range.start), int(time_range.end)
        return (start >= 0 and end > start
                and start % bucket_ms == 0 and end % bucket_ms == 0)

    async def try_serve(self, metric: str, mid: int,
                        tsids: Optional[set], time_range: TimeRange,
                        bucket_ms: int, field: str,
                        aggs: tuple) -> Optional[dict]:
        """Serve a covered query from rollup cells, with dirty/unrolled
        segments recomputed from raw (the hybrid tail).  Returns None
        when no segment is covered — the caller falls back to the raw
        path wholesale."""
        spec = self.specs.get((metric, field))
        if spec is None or bucket_ms not in self.tiers \
                or not set(aggs) <= set(ALL_AGGS):
            return None
        if mid != spec.metric_id:
            return None  # hash collision paranoia: serve raw
        start, end = int(time_range.start), int(time_range.end)
        nb = (end - start) // bucket_ms
        mem_segs = self._memtable_segments()
        by_seg = await self._data_fingerprints()

        def seg_covered(seg: int) -> bool:
            if (seg in spec.dirty or seg in spec.rolling
                    or seg in mem_segs or seg in spec.unrollable):
                return False
            if seg in spec.rolled:
                return True
            # no SSTs, no buffered rows, never noted: provably empty —
            # trivially covered (contributes nothing)
            return seg not in by_seg

        seg0 = int(Timestamp(start).truncate_by(self.segment_ms))
        segs = list(range(seg0, end, self.segment_ms))
        covered = [s for s in segs if seg_covered(s)]
        tail = [s for s in segs if not seg_covered(s)]
        if not covered or len(tail) > len(covered):
            # nothing covered — or a mostly-unrolled range, where N
            # per-segment tail recomputes cost more than the ONE
            # ranged raw scan the fallback runs
            spec.fallback_queries += 1
            _FALLBACK.inc()
            return None
        with span("rollup_serve", metric=metric, tier=bucket_ms,
                  covered=len(covered), tail=len(tail)):
            out = await self._assemble(spec, mid, tsids, start, end,
                                       bucket_ms, nb, set(covered), tail,
                                       tuple(aggs))
        spec.served_queries += 1
        _SERVED.labels(table=metric,
                       tier=self.tier_names[bucket_ms]).inc()
        trace_add("rollup_served", 1)
        trace_add("rollup_tail_segments", len(tail))
        return out

    async def _read_cells(self, spec: RollupSpec, tsids: Optional[set],
                          start: int, end: int, bucket_ms: int,
                          covered: set):
        """Cells of the covered segments in [start, end), as numpy
        columns.  The tier-table scan is the ordinary merge path: a
        re-rolled bucket's latest cell wins by seq like any overwrite."""
        preds = [Eq("metric_id", spec.metric_id),
                 Eq("field_id", spec.field_id),
                 TimeRangePred("bucket_ts", start, end)]
        if tsids is not None:
            preds.append(In("tsid", sorted(tsids)))
        table = self.tiers[bucket_ms]
        batches = await _collect(table.scan(ScanRequest(
            range=TimeRange.new(start, end), predicate=And(preds))))
        if not batches:
            return None
        tbl = pa.Table.from_batches(batches)
        raw = {c: tbl.column(c).to_numpy(zero_copy_only=False)
               for c in ("tsid", "bucket_ts") + _CELL_VALUE_COLS}
        # reassemble the exact f64 accumulators from their f32 splits
        # and rebase last_ts from its bucket-relative offset
        cols = {
            "tsid": raw["tsid"], "bucket_ts": raw["bucket_ts"],
            "count": (raw["count_hi"] + raw["count_md"]) + raw["count_lo"],
            "sum": (raw["sum_hi"] + raw["sum_md"]) + raw["sum_lo"],
            "min": raw["min"], "max": raw["max"], "last": raw["last"],
            "last_ts": raw["bucket_ts"] + raw["last_ts_rel"],
        }
        # a dirty segment's stale cells must not leak into the grid —
        # its buckets are recomputed by the raw tail instead
        seg_of = (cols["bucket_ts"] // self.segment_ms) * self.segment_ms
        keep = np.isin(seg_of, np.asarray(sorted(covered), dtype=np.int64))
        if not keep.all():
            cols = {k: v[keep] for k, v in cols.items()}
        return cols if len(cols["tsid"]) else None

    async def _assemble(self, spec: RollupSpec, mid: int,
                        tsids: Optional[set], start: int, end: int,
                        bucket_ms: int, nb: int, covered: set,
                        tail: list, aggs: tuple) -> dict:
        cells = await self._read_cells(spec, tsids, start, end, bucket_ms,
                                       covered)
        # not-yet-rolled tail: recompute each segment from raw on the
        # parts route, as maintenance does (a WAL-fronted table flushes
        # overlapping memtables first, so acked rows are included)
        tail_parts = []
        preds = [Eq("metric_id", mid), Eq("field_id", spec.field_id)]
        if tsids is not None:
            preds.append(In("tsid", sorted(tsids)))
        # avg is derived from the f64 sum/count accumulators at the end
        # (the raw combine's own formula), so the tail must carry sum
        tail_which = tuple(set(aggs)
                           | ({"sum"} if "avg" in aggs else set()))
        for seg in tail:
            with span("rollup_tail", segment=seg):
                seg_nb = self.segment_ms // bucket_ms
                out = await self._engine._scan_downsample(
                    And(preds), TimeRange.new(seg, seg + self.segment_ms),
                    bucket_ms, seg_nb, tail_which, parts_route=True)
            if out["tsids"]:
                tail_parts.append(
                    (seg, out["tsids"],
                     {k: _host(v) for k, v in out["aggs"].items()}))

        tsid_sets = []
        if cells is not None:
            tsid_sets.append(np.unique(cells["tsid"]))
        for _seg, seg_tsids, _grids in tail_parts:
            tsid_sets.append(np.asarray(seg_tsids, dtype=np.uint64))
        if not tsid_sets:
            return {"tsids": [], "num_buckets": nb, "aggs": {}}
        all_tsids = np.unique(np.concatenate(tsid_sets))
        g = len(all_tsids)

        # accumulator grids with the raw combine's empty-cell identities
        count = np.zeros((g, nb), dtype=np.float64)
        sum_ = np.zeros((g, nb), dtype=np.float64)
        min_ = np.full((g, nb), np.inf, dtype=np.float64)
        max_ = np.full((g, nb), -np.inf, dtype=np.float64)
        last = np.full((g, nb), np.nan, dtype=np.float64)
        last_ts = np.full((g, nb), np.nan, dtype=np.float64)

        if cells is not None:
            rows = np.searchsorted(all_tsids, cells["tsid"])
            bcols = (cells["bucket_ts"] - start) // bucket_ms
            count[rows, bcols] = cells["count"]
            sum_[rows, bcols] = cells["sum"]
            min_[rows, bcols] = cells["min"]
            max_[rows, bcols] = cells["max"]
            last[rows, bcols] = cells["last"]
            last_ts[rows, bcols] = cells["last_ts"]

        for seg, seg_tsids, grids in tail_parts:
            rows = np.searchsorted(
                all_tsids, np.asarray(seg_tsids, dtype=np.uint64))
            # global grid columns this segment overlaps within [start,
            # end); buckets never straddle segments (tier | segment)
            lo_b = max(seg, start)
            hi_b = min(seg + self.segment_ms, end)
            src = slice((lo_b - seg) // bucket_ms,
                        (hi_b - seg) // bucket_ms)
            dst = slice((lo_b - start) // bucket_ms,
                        (hi_b - start) // bucket_ms)
            count[rows, dst] = grids["count"][:, src]
            if "sum" in grids:
                sum_[rows, dst] = grids["sum"][:, src]
            if "min" in grids:
                min_[rows, dst] = grids["min"][:, src]
            if "max" in grids:
                max_[rows, dst] = grids["max"][:, src]
            if "last" in grids:
                last[rows, dst] = grids["last"][:, src]
                last_ts[rows, dst] = grids["last_ts"][:, src]

        # drop groups with no row in ANY requested bucket — exactly the
        # raw finalize's discipline (a tail segment scan may register a
        # series whose in-range cells are all empty)
        nz = count.sum(axis=1) > 0
        if not nz.all():
            all_tsids = all_tsids[nz]
            count, sum_, min_, max_ = (a[nz] for a in
                                       (count, sum_, min_, max_))
            last, last_ts = last[nz], last_ts[nz]
        if not len(all_tsids):
            return {"tsids": [], "num_buckets": nb, "aggs": {}}

        requested = set(aggs) | {"count"}
        empty = count == 0
        grids_out: dict = {"count": count}
        if "sum" in requested:
            grids_out["sum"] = sum_
        if "avg" in requested:
            with np.errstate(invalid="ignore", divide="ignore"):
                grids_out["avg"] = np.where(empty, np.nan,
                                            sum_ / np.maximum(count, 1))
        if "min" in requested:
            grids_out["min"] = min_
        if "max" in requested:
            grids_out["max"] = max_
        if "last" in requested:
            grids_out["last"] = last
            grids_out["last_ts"] = last_ts
        return {"tsids": [int(t) for t in all_tsids],
                "num_buckets": nb, "aggs": grids_out}

    # ---- observability ----------------------------------------------------

    async def stats(self) -> dict:
        """Per-spec lag (newest raw seq vs newest rolled-up seq),
        segment coverage, serve counters, and per-tier cell volume from
        the tier manifests."""
        by_seg = await self._data_fingerprints()
        mem_segs = self._memtable_segments()
        newest = await self._newest_raw_seq()
        tiers = {}
        for tier_ms, table in sorted(self.tiers.items()):
            ssts = await table.manifest.all_ssts()
            tiers[self.tier_names[tier_ms]] = {
                "bucket_ms": tier_ms,
                "ssts": len(ssts),
                "cell_rows": sum(f.meta.num_rows for f in ssts),
                "bytes": sum(f.meta.size for f in ssts),
            }
        specs = {}
        for spec in self.specs.values():
            lag = self._lag(spec, newest)
            _LAG.labels(table=spec.metric, field=spec.field).set(lag)
            clean = [seg for seg in spec.rolled
                     if seg not in spec.dirty and seg not in spec.rolling
                     and seg not in mem_segs
                     and by_seg.get(seg) == spec.rolled[seg]]
            data_segs = len(set(by_seg) | mem_segs)
            specs[f"{spec.metric}:{spec.field}"] = {
                "metric": spec.metric,
                "field": spec.field,
                "seq_newest_raw": newest,
                "seq_rolled": spec.seq,
                "lag_seqs": lag,
                "data_segments": data_segs,
                "rolled_segments": len(clean),
                "dirty_segments": len(set(spec.dirty) | spec.rolling
                                      | spec.unrollable
                                      | (mem_segs & set(spec.rolled))),
                "coverage": (round(len(clean) / data_segs, 4)
                             if data_segs else 1.0),
                "served_queries": spec.served_queries,
                "fallback_queries": spec.fallback_queries,
            }
        return {"tiers": tiers, "specs": specs}
