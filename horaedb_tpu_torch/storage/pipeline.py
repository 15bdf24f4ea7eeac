"""Bounded producer/consumer pipeline for the cold scan path.

Phase-at-a-time cold scans leave the card idle while the object store
answers and the store idle while the host decodes.  This module overlaps
the three as independent stages with bounded in-flight state:

  fetch   — per-segment store reads (tier-2-resident encoded parts skip
            the store via EncodedSegmentCache's subset-get; only missing
            SSTs cross the wire), up to `depth` segments in flight,
            admitted STRICTLY in plan order so a small depth can never
            hand its last slot to a later segment and deadlock the
            decode position;
  decode  — one segment at a time on the worker pool (the host merge and
            window cut, or the device decode's dispatch, in one pool
            call);
  device  — the consumer (aggregate rounds / row decode), fed through an
            ordered queue.

Backpressure: a `PipelineBudget` bounds both segments in flight
(`depth`) and host bytes held by the pipeline (`inflight_bytes`:
fetched-but-undecoded parts plus decoded-but-unconsumed windows), so a
slow device stage stalls fetch instead of ballooning host RAM.  One
oversized segment is always admitted — progress over the soft bound.

Teardown is deterministic: `aclose()` cancels the stage tasks and
AWAITS them.  A pool job already running cannot be interrupted, so
awaiting the cancelled task drains it: no pool job outlives the scan
that issued it into table or engine teardown.

`[scan.pipeline] enabled = false` routes scans through the sequential
pump in read._cached_windows; results are bit-identical either way.  So
does a scan with no store I/O to overlap — every bulk segment tier-2
resident (read._pipeline_has_io): with nothing to hide, stage
concurrency only contends for the same host cores.

An expired request deadline stops the fetch and decode stages at their
next segment boundary (common/deadline.py); the in-flight bytes are a
memory-ledger account.  The mesh stall counters live here too: the
[scan.mesh] round dispatcher is the device stage when the mesh is on.
"""

from __future__ import annotations

import asyncio
import os
import time
from typing import Optional

from horaedb_tpu_torch.common.deadline import checkpoint as deadline_checkpoint
from horaedb_tpu_torch.utils import registry, trace_add
from horaedb_tpu_torch.utils.tracing import record_interval

# per-stage occupancy of the pipeline beside the plan stages of
# storage/read.py (same family names): fetch ~= the segment reads,
# decode ~= the merge or device-decode dispatch, device ~= the parts
# path's aggregate rounds including pool-queue wait
PIPELINE_STAGES = ("fetch", "decode", "device")
STAGE_SECONDS = {
    s: registry.histogram("scan_stage_seconds",
                          "wall seconds per merge-scan plan stage"
                          ).labels(stage=s)
    for s in PIPELINE_STAGES
}
STAGE_ROWS = {
    s: registry.counter("scan_stage_rows_total",
                        "rows entering each plan stage").labels(stage=s)
    for s in PIPELINE_STAGES
}
STAGE_BYTES = {
    s: registry.counter("scan_stage_bytes_total",
                        "bytes entering each plan stage").labels(stage=s)
    for s in PIPELINE_STAGES
}
_STALLS = {
    s: registry.counter(
        "scan_pipeline_stalls_total",
        "times a pipeline stage waited on its neighbour (stage= is "
        "the stage that STARVED: fetch waits on the in-flight budget, "
        "decode on a store read, device on decode)").labels(stage=s)
    for s in PIPELINE_STAGES
}
_INFLIGHT_BYTES = registry.gauge(
    "scan_pipeline_inflight_bytes",
    "host bytes held in flight by scan pipelines (fetched parts + "
    "decoded windows not yet consumed)")

# memory plane: pipeline in-flight bytes are transient (per-scan
# budgets, exact through teardown) with no single resident owner, so
# the process-level account reads the gauge the budgets already keep
# exact — one source of truth, no double entry
from horaedb_tpu_torch.common.memledger import ledger as _memledger  # noqa: E402

_MEM_ACCOUNT = _memledger.register(
    "pipeline_inflight", lambda: int(_INFLIGHT_BYTES.value),
    kind="pipeline_inflight", owner="storage/pipeline")


# mesh-axis stalls live with the pipeline's stall telemetry: the mesh
# dispatcher IS the pipeline's device stage when [scan.mesh] is on —
# its rounds are fed by the same fetch/decode stages, with plan-order
# slot admission per mesh column (read._aggregate_segments_mesh)
MESH_AXES = ("time", "series")
_MESH_STALLS = {
    a: registry.counter(
        "scan_mesh_stalls_total",
        "mesh rounds dispatched with idle shards, per axis: time = "
        "the window feed filled fewer slots than the time axis (tail "
        "rounds or fetch/decode backpressure), series = the round's "
        "group space left whole series blocks empty").labels(axis=a)
    for a in MESH_AXES
}


def stall_counts() -> dict:
    """Cumulative per-stage stall counts."""
    return {s: int(c.value) for s, c in _STALLS.items()}


def mesh_stall_counts() -> dict:
    """Cumulative per-axis mesh stall counts (/stats mesh section)."""
    return {a: int(c.value) for a, c in _MESH_STALLS.items()}


def note_stall(stage: str) -> None:
    _STALLS[stage].inc()
    trace_add(f"pipeline_stall_{stage}", 1)


def note_mesh_stall(axis: str) -> None:
    _MESH_STALLS[axis].inc()
    trace_add(f"mesh_stall_{axis}", 1)


def observe_stage(stage: str, t0_ns: int, rows: int = 0, nbytes: int = 0,
                  t1_ns: Optional[int] = None,
                  seconds: Optional[float] = None) -> None:
    """Attribute the interval [t0_ns, t1_ns or now) of
    time.perf_counter_ns() to a pipeline stage; `seconds` charges less
    than the whole interval where part of it is another stage's (a
    streamed segment's reads)."""
    if t1_ns is None:
        t1_ns = time.perf_counter_ns()
    if seconds is None:
        seconds = (t1_ns - t0_ns) / 1e9
    STAGE_SECONDS[stage].observe(seconds)
    record_interval(stage, t0_ns, t1_ns, None)
    trace_add(f"stage_{stage}_ms", seconds * 1e3)
    if rows:
        STAGE_ROWS[stage].inc(rows)
        trace_add(f"stage_{stage}_rows", rows)
    if nbytes:
        STAGE_BYTES[stage].inc(nbytes)
        trace_add(f"stage_{stage}_bytes", nbytes)


def windows_nbytes(windows: list) -> int:
    """Host bytes held by a segment's decoded windows (column arrays;
    memo allowances are charged by the scan cache, not here).  A
    device-decoded segment's entry is a finished aggregate partial
    (ops.device_decode.DevicePart) whose host footprint is just its
    downloaded grids."""
    total = 0
    for w in windows:
        cols = getattr(w, "columns", None)
        if cols is None:
            total += int(getattr(w, "nbytes", 0))
        else:
            total += sum(int(c.nbytes) for c in cols.values())
    return total


class PipelineBudget:
    """Slot + byte admission for one scan's pipeline.

    Slots are granted to bulk segments STRICTLY in plan order (each
    caller presents its ticket index): out-of-order grants could hand
    the last slot to segment N+5 while the decode stage waits on
    segment N whose fetch cannot start — a deadlock at small depths.
    Streamed segments take no slot (they bound their own
    materialization window by window) and only charge bytes.
    """

    def __init__(self, max_bytes: int, depth: int):
        self.max_bytes = max(1, int(max_bytes))
        self.depth = max(1, int(depth))
        self.slots = 0
        self.bytes = 0
        self.high_water = 0
        self._turn = 0  # next ticket allowed to take a slot
        # one event PER WAITING TICKET: only the head-of-line ticket is
        # ever woken (on turn advance or freed room), so a release costs
        # O(1) instead of waking every parked fetch task
        self._waiters: dict[int, asyncio.Event] = {}

    def _has_room(self) -> bool:
        # always admit when nothing is in flight: a single segment
        # larger than the whole budget must still make progress
        if self.slots == 0 and self.bytes == 0:
            return True
        return self.slots < self.depth and self.bytes < self.max_bytes

    def _recheck(self) -> None:
        if self._has_room():
            self._wake_head()

    def _wake_head(self) -> None:
        ev = self._waiters.get(self._turn)
        if ev is not None:
            ev.set()

    async def admit(self, ticket: int, est_bytes: int = 0) -> None:
        """Take a fetch slot; waits while the pipeline is full or an
        earlier ticket has not been admitted yet.  `est_bytes` (the
        manifest-derived segment size estimate) is charged ON admission
        — an in-flight read counts against the budget BEFORE its bytes
        arrive, or N concurrent slow reads would all admit against an
        empty ledger and land together over budget.  The fetcher swaps
        the estimate for the actual bytes on completion."""
        stalled = False
        try:
            while self._turn != ticket or not self._has_room():
                if self._turn == ticket:
                    # only the head-of-line waiter reports backpressure;
                    # later tickets waiting their turn is not a stall
                    stalled = True
                ev = self._waiters.setdefault(ticket, asyncio.Event())
                ev.clear()
                await ev.wait()
        finally:
            self._waiters.pop(ticket, None)
        if stalled:
            note_stall("fetch")
        self._turn += 1
        self.slots += 1
        self.charge(est_bytes)
        # the NEW head re-evaluates room for itself
        self._wake_head()

    def charge(self, nbytes: int) -> None:
        if nbytes <= 0:
            return
        self.bytes += nbytes
        _INFLIGHT_BYTES.inc(nbytes)
        self.high_water = max(self.high_water, self.bytes)
        self._recheck()

    def release(self, nbytes: int) -> None:
        if nbytes > 0:
            self.bytes -= nbytes
            _INFLIGHT_BYTES.inc(-nbytes)
        self._recheck()

    def consume(self, nbytes: int, took_slot: bool) -> None:
        """The device stage picked a segment up: free its slot+bytes."""
        if took_slot:
            self.slots -= 1
        self.release(nbytes)

    def close(self) -> None:
        """Zero out whatever this pipeline still holds (teardown must
        leave the process-global in-flight gauge exact)."""
        if self.bytes:
            _INFLIGHT_BYTES.inc(-self.bytes)
            self.bytes = 0
        self.slots = 0
        for ev in self._waiters.values():
            ev.set()


class _Item:
    __slots__ = ("seg", "windows", "read_s", "nbytes", "took_slot")

    def __init__(self, seg, windows, read_s, nbytes, took_slot):
        self.seg = seg
        self.windows = windows
        self.read_s = read_s
        self.nbytes = nbytes
        self.took_slot = took_slot


class _Error:
    __slots__ = ("exc",)

    def __init__(self, exc):
        self.exc = exc


_DONE = object()


class ScanPipeline:
    """Owns the fetch and decode stages for one scan's to-read
    segments; read._cached_windows_pipelined is the consumer (yielding
    into the device stage).  Segments are produced in plan order."""

    # admission-time estimate of a segment's in-flight bytes, from the
    # manifest row counts (the scan cache's rows->bytes conversion);
    # swapped for the actual fetched size when the read completes
    _EST_BYTES_PER_ROW = 32

    def __init__(self, reader, plan, segments: list):
        self.reader = reader
        self.plan = plan
        self.segments = segments
        cfg = reader.config.scan.pipeline
        self.budget = PipelineBudget(cfg.inflight_bytes, cfg.depth)
        # unbounded on purpose: depth/bytes admission already bounds
        # what can sit here, and control messages (errors, completion)
        # must never block behind a full queue
        self._queue: asyncio.Queue = asyncio.Queue()
        self._streamed = {id(s) for s in segments
                          if reader._stream_segment(s)}
        self._reads: dict[int, asyncio.Task] = {}
        self._consumed = 0
        self._producer: Optional[asyncio.Task] = None
        # fetch-stage CPU bound: with `depth` reads in flight, letting
        # every one race its deserialize on the shared pool starves the
        # decode and device stages of cores.  I/O stays `depth`-wide;
        # the CPU-side deserialize/assemble runs at most half the cores
        # wide, leaving the other half for decode + device
        self._cpu_sem = asyncio.Semaphore(max(1, (os.cpu_count() or 4) // 2))
        # a plan that can't use sidecars reads whole parquet segments,
        # whose decodes run inside parquet_io.read_sst and can't go
        # through the bounded runner: cap those reads at the sequential
        # pump's width instead of `depth`, or `depth` parquet decodes
        # queue ahead of the decode/device stages on the shared pool
        self._plan_sidecar_ok = reader._sidecar_plan_ok(plan)
        self._read_sem = asyncio.Semaphore(max(4, os.cpu_count() or 4))
        if segments:
            ticket = 0
            for seg in segments:
                if id(seg) in self._streamed:
                    continue
                self._reads[id(seg)] = asyncio.create_task(
                    self._fetch(seg, ticket))
                ticket += 1
            self._producer = asyncio.create_task(self._produce())

    # ---- fetch stage -------------------------------------------------------

    async def _bounded_runner(self, fn, *args):
        async with self._cpu_sem:
            return await self.reader._run_pool(fn, *args,
                                               pool=self.plan.pool)

    async def _fetch(self, seg, ticket: int):
        est = sum(f.meta.num_rows
                  for f in seg.ssts) * self._EST_BYTES_PER_ROW
        await self.budget.admit(ticket, est)
        try:
            # inside the try: the admission-time estimate must release
            # on this exit too
            deadline_checkpoint()
            t0 = time.perf_counter_ns()
            resident = self.reader._resident_segment_parts(seg, self.plan)
            if resident is not None:
                # zero store I/O: assemble the tier-2-resident parts here
                # so segment N+1's assemble overlaps segment N's decode
                # and device work, through the BOUNDED runner so `depth`
                # resident segments can't flood the pool ahead of them
                es = await self._bounded_runner(
                    self.reader._assemble_resident_segment, seg,
                    resident, self.plan)
                if es is not None:
                    nbytes = int(es.nbytes)
                    self.budget.charge(nbytes)
                    t1 = time.perf_counter_ns()
                    read_s = (t1 - t0) / 1e9
                    observe_stage("fetch", t0, rows=int(es.n),
                                  nbytes=nbytes, t1_ns=t1)
                    return es, read_s, nbytes
                # assembly failed: memoize the composition (the negative
                # memo is event-loop owned — we are back on the loop)
                # and take the full fetch path, which now routes to
                # parquet, as the sequential path does
                self.reader.encoded_cache.mark_assembly_failed(
                    frozenset(f.id for f in seg.ssts))
            if self._plan_sidecar_ok:
                table, read_s = await self.reader._read_segment_any(
                    seg, self.plan, runner=self._bounded_runner)
            else:
                async with self._read_sem:
                    table, read_s = await self.reader._read_segment_any(
                        seg, self.plan, runner=self._bounded_runner)
            nbytes = int(table.nbytes)
            self.budget.charge(nbytes)
            observe_stage("fetch", t0, rows=int(table.num_rows),
                          nbytes=nbytes)
        finally:
            self.budget.release(est)
        return table, read_s, nbytes

    # ---- decode stage ------------------------------------------------------

    async def _produce(self) -> None:
        try:
            for seg in self.segments:
                # cooperative cancellation point between segments: an
                # expired deadline stops decoding a doomed scan (the
                # error flows to the consumer in order)
                deadline_checkpoint()
                if id(seg) in self._streamed:
                    item = await self._decode_streamed(seg)
                else:
                    item = await self._decode_bulk(seg)
                await self._queue.put(item)
            self._queue.put_nowait(_DONE)
        except asyncio.CancelledError:
            raise
        except BaseException as exc:  # noqa: BLE001 — relayed, not handled
            # surfaces to the consumer IN ORDER (all prior segments'
            # items are already queued), preserving the sequential
            # path's error position for the compaction-race replan
            self._queue.put_nowait(_Error(exc))

    async def _decode_bulk(self, seg) -> _Item:
        task = self._reads.pop(id(seg))
        if not task.done():
            note_stall("decode")
        table, read_s, fetch_bytes = await task
        t0 = time.perf_counter_ns()
        if table.num_rows:
            windows = await self.reader._run_pool(
                self.reader._merge_segment, table, self.plan,
                pool=self.plan.pool)
        else:
            windows = []
        del table
        nbytes = windows_nbytes(windows)
        # swap the fetched representation's bytes for the windows'
        self.budget.charge(nbytes)
        self.budget.release(fetch_bytes)
        observe_stage("decode", t0, rows=sum(w.n_valid for w in windows),
                      nbytes=nbytes)
        return _Item(seg, windows, read_s, nbytes, True)

    async def _decode_streamed(self, seg) -> _Item:
        # streamed segments interleave their own fetch and decode window
        # by window (bounded materialization); they take no pipeline
        # slot so later bulk fetches keep overlapping them, and only
        # their finished windows charge the byte budget
        t0 = time.perf_counter_ns()
        windows, read_s = await self.reader._read_streamed_windows(
            seg, self.plan)
        nbytes = windows_nbytes(windows)
        self.budget.charge(nbytes)
        t1 = time.perf_counter_ns()
        observe_stage("decode", t0, rows=sum(w.n_valid for w in windows),
                      nbytes=nbytes, t1_ns=t1,
                      seconds=(t1 - t0) / 1e9 - read_s)
        return _Item(seg, windows, read_s, nbytes, False)

    # ---- consumer API ------------------------------------------------------

    async def next_segment(self):
        """(seg, windows, read_seconds) in plan order; raises the
        producer's error at the exact segment position it occurred."""
        if self._queue.empty() and self._consumed:
            # empty AFTER the first segment is starvation; empty on the
            # first call is ramp-up and would make every pipelined scan
            # report a phantom device stall
            note_stall("device")
        item = await self._queue.get()
        self._consumed += 1
        if item is _DONE:
            # consumer asked past the last segment — a caller bug
            raise RuntimeError("scan pipeline exhausted")
        if isinstance(item, _Error):
            raise item.exc
        self.budget.consume(item.nbytes, item.took_slot)
        return item.seg, item.windows, item.read_s

    async def aclose(self) -> None:
        """Deterministic teardown: cancel every stage task and AWAIT
        them — a cancelled task whose pool job is mid-flight only
        finishes after the job does, so nothing this scan dispatched
        outlives it into table/engine teardown."""
        tasks = list(self._reads.values())
        self._reads.clear()
        if self._producer is not None:
            tasks.append(self._producer)
            self._producer = None
        for t in tasks:
            t.cancel()
        if tasks:
            await asyncio.gather(*tasks, return_exceptions=True)
        # record the observed high-water for cache_stats() before zeroing
        self.reader._pipeline_high_water = max(
            self.reader._pipeline_high_water, self.budget.high_water)
        self.budget.close()
