"""IngestStorage: the durable-ingest front end over CloudObjectStorage.

Write path: validate -> allocate a seq (the SST id space, monotonic
across restarts) -> WAL group-commit append -> ACK after the group
fsync -> buffer the rows in the segment's memtable.  The object store
is not touched per write; a background flusher drains memtables to one
SST each through `CloudObjectStorage.write_stamped` (per-row seqs
preserved) once a memtable crosses flush_rows / flush_bytes /
flush_age, and only after the SST + manifest commit does the WAL
truncation point advance.

Crash safety:
- acked rows are in a fsynced WAL record; replay on open rebuilds the
  memtables, so they survive kill -9;
- a crash between the flush commit and the truncation replays rows an
  SST already holds: the preserved `__seq__` makes the duplicate
  collapse in the merge (exactly-once after scan);
- a crash mid-group loses only unacked writes (the group's waiters saw
  the failure).

Read path: the hybrid scan.  Segments with no memtable overlay take
the unchanged plan/pushdown path; overlay segments are scanned with
only the PK-only conjunct pushed down, builtin columns kept, and
host-merged with the memtable rows (read.merge_memtable_overlay), so
queries see acked-but-unflushed rows under the one last-value rule.
Aggregate plans flush the overlapping memtables first and replan: the
device grids then read pure SST state, so a flush turns a segment the
replay or the scan cache holds into a new SST set, and the next query
goes back through the kernels for it.

The rollup hooks: `last_seq` (the newest acked seq), `on_flush`
(called with the segment start after a flush commits),
`memtable_segments()` and `oldest_unflushed_seq()` (rollup/manager.py
keeps buffered segments raw-served and floors its lag watermark).

The planes: a tenant's ingest-rate gate (`admit_wal`) runs ahead of
the group commit; the memtables and the WAL backlog are memory-ledger
accounts; the flusher loop carries the watchdog's stall threshold and
backlog hint.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import AsyncIterator, Optional

import pyarrow as pa

from horaedb_tpu_torch.common.error import ensure
from horaedb_tpu_torch.common.loops import loops
from horaedb_tpu_torch.common.memledger import ledger as memledger
from horaedb_tpu_torch.common.tenant import current_tenant
from horaedb_tpu_torch.storage.config import UpdateMode
from horaedb_tpu_torch.storage.read import (
    ScanPlan,
    ScanRequest,
    merge_memtable_overlay,
    plan_columns,
)
from horaedb_tpu_torch.storage.sst import SstFile
from horaedb_tpu_torch.storage.storage import (TimeMergeStorage, WriteRequest,
                                               WriteResult)
from horaedb_tpu_torch.utils import (WIDE_BUCKETS, op_trace, registry, span,
                                     trace_add)
from horaedb_tpu_torch.wal.config import WalConfig
from horaedb_tpu_torch.wal.log import Wal
from horaedb_tpu_torch.wal.memtable import MemEntry, Memtable

logger = logging.getLogger(__name__)

_FLUSHES = registry.counter(
    "memtable_flushes_total", "memtable -> SST flushes")
_FLUSH_ROWS = registry.counter(
    "memtable_flush_rows_total", "rows drained from memtables into SSTs")
_FLUSH_FAILURES = registry.counter(
    "memtable_flush_failures_total",
    "flush attempts that failed (rows returned to the memtable)")
_REPLAYED_ROWS = registry.counter(
    "wal_replayed_rows_total", "rows rebuilt into memtables by replay")
_ACK_LATENCY = registry.histogram(
    "ingest_ack_seconds", "write() latency to the WAL-fsync ack point")


class IngestStorage(TimeMergeStorage):
    """WAL + memtable wrapper around a CloudObjectStorage.  Everything
    not ingest-related (schema, plan_query, manifest, reader, scrub,
    compaction) delegates to the wrapped storage."""

    def __init__(self, inner, wal: Wal, config: WalConfig,
                 clock=time.monotonic, on_op=None):
        self.inner = inner
        self.wal = wal
        self.config = config
        self._clock = clock
        self._on_op = on_op
        self._memtables: dict[int, Memtable] = {}
        # memtables whose flush is IN FLIGHT: they left _memtables (new
        # writes go to a fresh one) but stay visible to scans until the
        # SST + manifest commit lands; popping first would open a window
        # where acked rows are in neither source
        self._flushing: dict[int, list[Memtable]] = {}
        self._flush_lock = asyncio.Lock()
        self._flusher_task: Optional[asyncio.Task] = None
        self._flush_wake: Optional[asyncio.Event] = None
        self._stopping = False
        self._last_flush_at: Optional[float] = None
        # newest seq acked by this ingest front end (rollup lag signal)
        self.last_seq = 0
        # flush-commit hook: called with the segment start after an SST
        # + manifest commit lands (the rollup manager's delta feed)
        self.on_flush = None
        # ownership fence: when set, every flush revalidates it before
        # the SST upload and again just before the manifest commit
        # (write_stamped's pre_commit), so a holder that lost it never
        # commits; its rows stay readable and in the WAL
        self.fence = None
        self._mem_accounts: list = []

    def __getattr__(self, name):
        inner = self.__dict__.get("inner")
        if inner is None:
            raise AttributeError(name)
        return getattr(inner, name)

    # ---- lifecycle --------------------------------------------------------

    @classmethod
    async def open(cls, inner, wal_dir: str, config: WalConfig,
                   clock=time.monotonic, on_op=None) -> "IngestStorage":
        ensure(inner.schema().update_mode is UpdateMode.OVERWRITE,
               "the WAL ingest path requires Overwrite mode: replay "
               "dedups via __seq__, which Append tables do not have")
        wal = Wal(wal_dir, config, on_op=on_op)
        self = cls(inner, wal, config, clock=clock, on_op=on_op)
        records = await asyncio.to_thread(wal.replay)
        user_schema = inner.schema().user_schema
        replayed = 0
        dropped = []
        for rec in records:
            if not rec.batch.schema.equals(user_schema):
                logger.warning(
                    "wal %s: dropping replayed record seq=%s with stale "
                    "schema", wal_dir, rec.seq)
                dropped.append(rec.seq)
                continue
            self._insert(rec.seq, rec.batch, rec.time_range)
            replayed += rec.batch.num_rows
        if dropped:
            # unrecoverable under this schema: mark them flushed so
            # their segments can still truncate instead of pinning the
            # backlog (and re-dropping) on every restart
            wal.mark_flushed(dropped)
        _REPLAYED_ROWS.inc(replayed)
        if replayed:
            logger.info("wal %s: replayed %d rows into %d memtables",
                        wal_dir, replayed, len(self._memtables))
        wal.start()
        self._flush_wake = asyncio.Event()
        # stall threshold sized to a worst-case flush (a big memtable's
        # SST write runs minutes), not the poll period
        self._flusher_task = loops.spawn(
            self._flush_loop, name=f"wal-flusher:{wal_dir}",
            kind="wal-flusher", owner="wal",
            period_s=config.flush_interval.seconds,
            stall_threshold_s=300.0,
            backlog=self._flusher_backlog)
        # memory plane: acked-but-unflushed rows live twice — arrow
        # batches in memtables AND framed bytes in un-truncated WAL
        # segments.  The memtable budget is the flush threshold; the
        # WAL backlog is unbudgeted (it truncates after flush)
        self._mem_accounts = [
            memledger.register(
                f"memtable:{wal_dir}", lambda s: s.memtable_bytes_now(),
                anchor=self, kind="memtable",
                budget=config.flush_bytes, owner=wal_dir),
            memledger.register(
                f"wal_backlog:{wal_dir}",
                lambda s: s.wal.backlog_bytes, anchor=self,
                kind="wal_backlog", owner=wal_dir),
        ]
        return self

    def memtable_bytes_now(self) -> int:
        """Arrow bytes across live AND flush-in-flight memtables (the
        ledger's pull gauge)."""
        total = sum(mt.bytes for mt in self._memtables.values())
        for mts in self._flushing.values():
            total += sum(mt.bytes for mt in mts)
        return total

    def _flusher_backlog(self) -> dict:
        """The watchdog's backlog hint: what the flusher is behind on."""
        s = self.ingest_stats()
        return {"memtable_rows": s["memtable_rows"],
                "memtable_bytes": s["memtable_bytes"],
                "wal_backlog_bytes": s["wal_backlog_bytes"]}

    async def close(self, flush: bool = True) -> None:
        self._stopping = True
        if self._flusher_task is not None:
            self._flush_wake.set()
            try:
                await self._flusher_task
            except asyncio.CancelledError:
                pass
            self._flusher_task = None
        if flush:
            try:
                await self.flush_all()
            except Exception as exc:  # noqa: BLE001 — rows stay in the WAL
                logger.warning("final flush failed (rows remain in the "
                               "WAL for replay): %s", exc)
        await self.wal.close()
        for mt in self._memtables.values():
            mt.account_drop()
        self._memtables = {}
        for acct in self._mem_accounts:
            memledger.deregister(acct)
        self._mem_accounts = []
        await self.inner.close()

    async def abort(self) -> None:
        """Stop the loops WITHOUT flushing: what a process death leaves
        (the WAL replays the buffered rows at the next open)."""
        await self.close(flush=False)

    # ---- write ------------------------------------------------------------

    def _insert(self, seq: int, batch: pa.RecordBatch, time_range) -> int:
        seg = int(time_range.start.truncate_by(
            self.inner.segment_duration_ms))
        mt = self._memtables.get(seg)
        if mt is None:
            mt = self._memtables[seg] = Memtable(seg, self._clock())
        mt.add(MemEntry(seq=seq, batch=batch, time_range=time_range))
        return seg

    async def write(self, req: WriteRequest) -> WriteResult:
        self.inner.validate_write(req)
        # per-tenant ingest-rate gate, AHEAD of the group commit: a
        # flooding tenant is rejected (QuotaExceeded -> 429) before its
        # batch costs a WAL frame, an fsync share, or a seq
        tenant = current_tenant()
        if tenant is not None:
            tenant.admit_wal(req.batch.nbytes)
        t0 = time.perf_counter()
        seq = SstFile.allocate_id()
        # the span covers frame + enqueue + the group-commit fsync wait
        # (the ack point)
        with span("wal_append_fsync", rows=req.batch.num_rows):
            size = await self.wal.append(seq, req.time_range, req.batch)
        trace_add("wal_append_bytes", size)
        # the fsync ack point: the rows are durable from here on
        with span("memtable_insert"):
            seg = self._insert(seq, req.batch, req.time_range)
        self.last_seq = max(self.last_seq, seq)
        self._maybe_wake_flusher(self._memtables.get(seg))
        _ACK_LATENCY.observe(time.perf_counter() - t0)
        return WriteResult(id=seq, seq=seq, size=size)

    def _maybe_wake_flusher(self, mt: Optional[Memtable]) -> None:
        """O(1) on the ack path: only the memtable the write just landed
        in can have newly crossed a threshold."""
        if self._flush_wake is None or mt is None:
            return
        cfg = self.config
        if mt.rows >= cfg.flush_rows or mt.bytes >= cfg.flush_bytes:
            self._flush_wake.set()

    # ---- flush ------------------------------------------------------------

    async def _flush_loop(self, hb) -> None:
        interval = self.config.flush_interval.seconds
        while not self._stopping:
            try:
                await asyncio.wait_for(self._flush_wake.wait(), interval)
            except asyncio.TimeoutError:
                pass
            hb.beat()
            self._flush_wake.clear()
            if self._stopping:
                return
            try:
                await self._flush_due()
                hb.ok()
            except asyncio.CancelledError:
                raise
            except Exception as exc:  # noqa: BLE001 — retries next tick
                hb.error(exc)
                logger.exception("memtable flush pass failed")

    def _due(self, mt: Memtable) -> bool:
        cfg = self.config
        return (mt.rows >= cfg.flush_rows or mt.bytes >= cfg.flush_bytes
                or (self._clock() - mt.created_at)
                >= cfg.flush_age.seconds)

    async def _flush_due(self) -> int:
        flushed = 0
        for seg in sorted(self._memtables):
            mt = self._memtables.get(seg)
            if mt is not None and mt.entries and self._due(mt):
                flushed += await self._flush_segment(seg)
        return flushed

    async def flush_all(self) -> int:
        """Drain every memtable now (the engine's flush(), close, and the
        aggregate pre-flush).  Returns rows flushed."""
        return await self.flush_overlapping(None)

    async def flush_overlapping(self, time_range) -> int:
        flushed = 0
        for seg in sorted(self._memtables):
            mt = self._memtables.get(seg)
            if mt is None or not mt.entries:
                continue
            rng = mt.time_range
            if time_range is not None and rng is not None \
                    and not rng.overlaps(time_range):
                continue
            flushed += await self._flush_segment(seg)
        if self._flushing_overlaps(time_range):
            # barrier: a background flush already in flight popped its
            # memtable before we looked; its SST + manifest commit must
            # land before callers replan from the manifest, or an
            # aggregate would silently omit acked rows.  _flush_segment
            # holds _flush_lock for its whole duration, so acquiring it
            # once waits the in-flight flush out.  Only OVERLAPPING
            # in-flight flushes matter: a disjoint segment's flush is
            # not waited for.
            async with self._flush_lock:
                pass
        return flushed

    def _flushing_overlaps(self, time_range) -> bool:
        """Whether any in-flight flush holds rows overlapping
        `time_range` (None = any).  A drained memtable keeps its
        entries until the SST commit lands (scan visibility), so its
        time_range stays answerable; None ranges count as overlapping."""
        for mts in self._flushing.values():
            for mt in mts:
                rng = mt.time_range
                if (time_range is None or rng is None
                        or rng.overlaps(time_range)):
                    return True
        return False

    async def _flush_segment(self, seg: int) -> int:
        """Drain one memtable to one SST.  The order is the crash-safety
        invariant: (1) SST + manifest commit, (2) mark seqs flushed,
        (3) truncate sealed WAL segments.  A crash after (1) replays
        rows the SST already holds, and the seq-preserving dedup
        collapses them."""
        async with self._flush_lock:
            mt = self._memtables.pop(seg, None)
            if mt is None or not mt.entries:
                if mt is not None:
                    mt.account_drop()
                return 0
            # each flush is a background operation with its own op
            # trace — unless a query's aggregate pre-flush triggered
            # it, in which case it records as that query's span
            with op_trace("flush", slow_s=60.0, segment=seg,
                          rows=mt.rows):
                return await self._flush_taken(seg, mt)

    async def _flush_taken(self, seg: int, mt: Memtable) -> int:
        # the memtable stays scan-visible via _flushing while the SST
        # write is in flight; a concurrent scan's overlay snapshot
        # therefore always holds the rows, and once the manifest commit
        # lands the seq tie dedups the double
        self._flushing.setdefault(seg, []).append(mt)
        try:
            table, rng, seqs = mt.drain(self.inner.schema())
            if table is not None:
                fence = self.fence
                if fence is not None:
                    # cheap pre-flight: fail before paying the SST upload
                    # when the fence is ALREADY gone; pre_commit below
                    # checks again at the manifest publish
                    await fence.check()
                if self._on_op is not None:
                    self._on_op("flush")
                with span("memtable_flush", buckets=WIDE_BUCKETS,
                          segment=seg, rows=mt.rows):
                    if fence is not None:
                        await self.inner.write_stamped(
                            table, rng, pre_commit=fence.check)
                    else:
                        await self.inner.write_stamped(table, rng)
        except BaseException:
            # the rows are acked: put them back so reads keep serving
            # them; the WAL still covers them for replay
            _FLUSH_FAILURES.inc()
            self._flushing[seg].remove(mt)
            mt.account_drop()
            cur = self._memtables.get(seg)
            if cur is None:
                cur = self._memtables[seg] = Memtable(seg, mt.created_at)
            for e in mt.entries:
                cur.add(e)
            raise
        finally:
            if mt in self._flushing.get(seg, ()):
                self._flushing[seg].remove(mt)
            if not self._flushing.get(seg):
                self._flushing.pop(seg, None)
        mt.account_drop()
        self.wal.mark_flushed(seqs)
        await self.wal.truncate()
        self._last_flush_at = self._clock()
        _FLUSHES.inc()
        _FLUSH_ROWS.inc(mt.rows)
        if self.on_flush is not None:
            self.on_flush(seg)
        return mt.rows

    # ---- read -------------------------------------------------------------

    def _snapshot_overlay(self, scan_range) -> dict[int, list]:
        """Segment -> stamped memtable batches overlapping the scan.
        Taken BEFORE the SST plan is built: a flush racing the scan can
        only move rows into SSTs the later plan sees, so rows appear in
        at least one source (the seq tie collapses doubles)."""
        out: dict[int, list] = {}
        schema = self.inner.schema()
        flushing = [(seg, mt) for seg, mts in self._flushing.items()
                    for mt in mts]
        for seg, mt in list(self._memtables.items()) + flushing:
            batches = mt.stamped_batches(schema, scan_range)
            if batches:
                out.setdefault(seg, []).extend(batches)
        return out

    async def scan(self, req: ScanRequest,
                   first_plan: Optional[ScanPlan] = None,
                   keep_builtin: bool = False,
                   segment_filter=None) -> AsyncIterator[pa.RecordBatch]:
        schema = self.inner.schema()
        overlay = self._snapshot_overlay(req.range)
        if segment_filter is not None:
            overlay = {s: b for s, b in overlay.items() if segment_filter(s)}
        if not overlay:
            # pure-SST path; first_plan is NOT reused: it may predate a
            # flush that just emptied these memtables
            it = self.inner.scan(req, keep_builtin=keep_builtin,
                                 segment_filter=segment_filter)
            try:
                async for b in it:
                    yield b
            finally:
                await it.aclose()
            return
        mem_segs = set(overlay)
        # segments with no overlay: the unchanged plan/pushdown path
        it = self.inner.scan(
            req, keep_builtin=keep_builtin,
            segment_filter=lambda s: s not in mem_segs
            and (segment_filter is None or segment_filter(s)))
        try:
            async for b in it:
                yield b
        finally:
            await it.aclose()
        # overlay segments: value-column leaves must apply AFTER the
        # cross-source dedup (filtering first would resurrect
        # overwritten rows), but the PK-only conjunct drops whole PK
        # groups and commutes with last-value dedup, so its pushdown
        # stays and the hybrid reads stay pruned.  The full predicate
        # still applies after the dedup in the overlay merge.
        from horaedb_tpu_torch.ops import And
        from horaedb_tpu_torch.storage import parquet_io

        pk_leaves, _ = parquet_io.conjunct_leaves_ex(
            req.predicate, set(schema.primary_key_names))
        pk_pred = (None if not pk_leaves else
                   pk_leaves[0] if len(pk_leaves) == 1 else And(pk_leaves))
        hybrid_req = ScanRequest(range=req.range, predicate=pk_pred,
                                 projections=req.projections)
        columns = plan_columns(schema, req.projections)
        buffered: dict[int, list] = {}
        seg_iter = self.inner.scan_segments(
            hybrid_req, keep_builtin=True,
            segment_filter=lambda s: s in mem_segs)
        try:
            async for seg, batch in seg_iter:
                if batch is not None:
                    buffered.setdefault(seg, []).append(batch)
                    continue
                with span("memtable_overlay", segment=seg):
                    out = merge_memtable_overlay(
                        schema, buffered.pop(seg, []),
                        overlay.pop(seg, []),
                        req.predicate, columns, keep_builtin)
                if out is not None and out.num_rows:
                    trace_add("memtable_overlay_rows", out.num_rows)
                    yield out
        finally:
            await seg_iter.aclose()
        # segments living only in memtables (no SSTs yet)
        for seg in sorted(overlay):
            with span("memtable_overlay", segment=seg):
                out = merge_memtable_overlay(
                    schema, [], overlay[seg], req.predicate, columns,
                    keep_builtin)
            if out is not None and out.num_rows:
                trace_add("memtable_overlay_rows", out.num_rows)
                yield out

    async def scan_aggregate(self, req: ScanRequest, spec,
                             first_plan: Optional[ScanPlan] = None,
                             top_k=None):
        await self.flush_overlapping(req.range)
        return await self.inner.scan_aggregate(req, spec, top_k=top_k)

    async def plan_query(self, req: ScanRequest, spec=None, top_k=None,
                         parts_route: bool = False):
        return await self.inner.plan_query(req, spec=spec, top_k=top_k,
                                           parts_route=parts_route)

    def execute_plan(self, qp):
        if qp.aggregate is None:
            # the cached first plan is dropped: it may predate a flush
            # racing this query (one extra manifest lookup, in memory)
            return self.scan(qp.request)

        async def agg():
            # flush overlapping memtables, then REPLAN: the given plan
            # may predate this flush or a background one racing the
            # query (aggregate grids read pure SST state)
            await self.flush_overlapping(qp.request.range)
            qp2 = await self.inner.plan_query(
                qp.request, qp.aggregate, qp.top_k,
                parts_route=qp.scan.parts_route)
            return await self.inner.execute_plan(qp2)

        return agg()

    # ---- facade plumbing --------------------------------------------------

    def schema(self):
        return self.inner.schema()

    async def compact(self) -> None:
        await self.inner.compact()

    @property
    def value_idxes(self) -> list[int]:
        return self.inner.value_idxes

    def memtable_segments(self) -> set[int]:
        """Segments with acked-but-unflushed rows (live + in-flight
        flushes): the rollup manager excludes them from coverage, so
        buffered rows are always served through the raw tail."""
        return ({seg for seg, mt in self._memtables.items() if mt.entries}
                | {seg for seg, mts in self._flushing.items() if mts})

    def oldest_unflushed_seq(self) -> Optional[int]:
        """Min seq across acked-but-unflushed rows; None when fully
        flushed.  The rollup lag watermark never advances past an
        unflushed (hence unrolled) row's seq."""
        live = list(self._memtables.values()) + [
            mt for mts in self._flushing.values() for mt in mts]
        return min((e.seq for mt in live for e in mt.entries),
                   default=None)

    def ingest_stats(self) -> dict:
        """Buffered state + WAL backlog.  Counts include in-flight
        flushes (still buffered until the SST commit)."""
        live = list(self._memtables.values()) + [
            mt for mts in self._flushing.values() for mt in mts]
        rows = sum(mt.rows for mt in live)
        nbytes = sum(mt.bytes for mt in live)
        age = (None if self._last_flush_at is None
               else self._clock() - self._last_flush_at)
        return {"memtable_rows": rows, "memtable_bytes": nbytes,
                "wal_backlog_bytes": self.wal.backlog_bytes,
                "wal_segments": self.wal.segment_count,
                "last_flush_age_s": age}
