"""Time-window compaction: picker, executor, scheduler
(ref: src/storage/src/compaction/; the port's copy of the JAX package's
storage/compaction.py).

- Picker: TimeWindowCompactionStrategy — group non-in-compaction SSTs by
  segment, newest segment first, require >= input_sst_min_num files, pack
  smallest-first up to input_sst_max_num while the total size stays
  within 1.1 x new_sst_max_size (ref: picker.rs:62-188).  TTL-expired
  files are split out and deleted alongside; when no segment qualifies,
  an expireds-only GC task deletes them without a rewrite (the
  reference drops them at picker.rs:96 until a rewrite also fires).
  TTL math stays in milliseconds.
- Executor: memory-gated rewrite (ref: executor.rs:93-114) through THE
  SAME merge pipeline as scan (reader.execute, keep_builtin=True),
  streaming into one new SST plus its sidecar (up to
  write.sidecar_max_rows); the manifest update {add new, delete inputs
  + expireds} precedes best-effort object deletes
  (ref: executor.rs:155-222).
- Scheduler: a picker loop (interval or trigger signal) feeding a
  bounded task queue consumed by the executor (ref: scheduler.rs:49-159),
  and the orphan scrubber's loop.
"""

from __future__ import annotations

import asyncio
import logging
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Optional

import pyarrow as pa

from horaedb_tpu_torch.common.error import Error, ensure
from horaedb_tpu_torch.common.loops import loops
from horaedb_tpu_torch.common.tasks import cancel_and_wait
from horaedb_tpu_torch.common.time_ext import now_ms
from horaedb_tpu_torch.storage import parquet_io, sidecar
from horaedb_tpu_torch.storage.config import UpdateMode
from horaedb_tpu_torch.storage.manifest.encoding import ManifestUpdate
from horaedb_tpu_torch.storage.read import ScanRequest
from horaedb_tpu_torch.storage.sst import FileMeta, SstFile, segment_of, sst_path
from horaedb_tpu_torch.storage.types import (
    RESERVED_COLUMN_NAME,
    Timestamp,
    TimeRange,
)
from horaedb_tpu_torch.utils import WIDE_BUCKETS, op_trace, registry, span

if TYPE_CHECKING:
    from horaedb_tpu_torch.storage.storage import CloudObjectStorage

logger = logging.getLogger(__name__)

_COMPACTIONS = registry.counter(
    "compaction_completed_total", "compaction tasks completed")
_COMPACTION_ROWS = registry.counter(
    "compaction_rows_rewritten_total", "rows rewritten by compaction")
_TTL_GC_FILES = registry.counter(
    "ttl_gc_files_total", "expired ssts removed by TTL garbage collection")


@dataclass
class Task:
    """(ref: compaction/mod.rs:26-36)"""

    inputs: list[SstFile]
    expireds: list[SstFile] = field(default_factory=list)

    @property
    def input_size(self) -> int:
        return sum(f.size for f in self.inputs)


class TimeWindowCompactionStrategy:
    def __init__(self, segment_duration_ms: int, new_sst_max_size: int,
                 input_sst_max_num: int, input_sst_min_num: int):
        self.segment_duration_ms = segment_duration_ms
        self.new_sst_max_size = new_sst_max_size
        self.input_sst_max_num = input_sst_max_num
        self.input_sst_min_num = input_sst_min_num

    def pick_candidate(self, ssts: list[SstFile],
                       expire_time: Optional[Timestamp]) -> Optional[Task]:
        uncompacted = [f for f in ssts
                       if not f.in_compaction and not f.is_expired(expire_time)]
        expireds = [f for f in ssts
                    if not f.in_compaction and f.is_expired(expire_time)]

        by_segment: dict[int, list[SstFile]] = {}
        for f in uncompacted:
            seg = segment_of(f, self.segment_duration_ms)
            by_segment.setdefault(seg, []).append(f)

        inputs = self._pick_files(by_segment)
        if inputs is None:
            # no rewrite qualifies: an expireds-only GC task (pure
            # deletes, executor.gc_expired)
            if not expireds:
                return None
            for f in expireds:
                f.mark_compaction()
            return Task(inputs=[], expireds=expireds)
        for f in inputs + expireds:
            f.mark_compaction()
        return Task(inputs=inputs, expireds=expireds)

    def _pick_files(self, by_segment: dict[int, list[SstFile]]
                    ) -> Optional[list[SstFile]]:
        # newest segment first; compacting fresh data keeps read amp low
        for seg in sorted(by_segment, reverse=True):
            files = by_segment[seg]
            if len(files) < self.input_sst_min_num:
                continue
            files = sorted(files, key=lambda f: f.size)
            picked: list[SstFile] = []
            total = 0
            # assume ~10% shrink from dedup, so allow 1.1x the target size
            budget = int(self.new_sst_max_size * 1.1)
            for f in files[: self.input_sst_max_num]:
                total += f.size
                if total > budget:
                    break
                picked.append(f)
            if len(picked) >= self.input_sst_min_num:
                return picked
        return None


class Picker:
    """Serial-only candidate picker (ref: picker.rs:25-60)."""

    def __init__(self, storage: "CloudObjectStorage"):
        cfg = storage.config.scheduler
        self.storage = storage
        self.ttl_ms = cfg.ttl.millis if cfg.ttl else None
        self.strategy = TimeWindowCompactionStrategy(
            segment_duration_ms=storage.segment_duration_ms,
            new_sst_max_size=cfg.new_sst_max_size.bytes,
            input_sst_max_num=cfg.input_sst_max_num,
            input_sst_min_num=cfg.input_sst_min_num,
        )

    async def pick_candidate(self) -> Optional[Task]:
        ssts = await self.storage.manifest.all_ssts()
        expire_time = (Timestamp(now_ms() - self.ttl_ms)
                       if self.ttl_ms is not None else None)
        return self.strategy.pick_candidate(ssts, expire_time)


class Executor:
    """Memory-gated compaction rewrite (ref: executor.rs)."""

    def __init__(self, storage: "CloudObjectStorage", trigger: asyncio.Queue):
        self.storage = storage
        self.mem_limit = storage.config.scheduler.memory_limit.bytes
        self.inused_memory = 0
        self._trigger = trigger

    def _pre_check(self, task: Task) -> None:
        """Reserve task memory; raises WITHOUT reserving when over limit."""
        ensure(task.inputs, "compaction task with no inputs")
        task_size = task.input_size
        ensure(self.inused_memory + task_size <= self.mem_limit,
               f"Compaction memory usage too high, inused:{self.inused_memory}, "
               f"task_size:{task_size}, limit:{self.mem_limit}")
        self.inused_memory += task_size

    @staticmethod
    def _unmark(task: Task) -> None:
        """Failed tasks are unmarked so the picker can retry them
        (ref: executor.rs:123-137)."""
        for f in task.inputs + task.expireds:
            f.unmark_compaction()

    def _trigger_more(self) -> None:
        try:
            self._trigger.put_nowait(None)
        except asyncio.QueueFull:
            pass

    async def execute(self, task: Task) -> None:
        if not task.inputs:
            await self.gc_expired(task)
            return
        try:
            self._pre_check(task)
        except Error:
            # nothing was reserved — only unmark for re-pick
            self._unmark(task)
            raise
        ok = False
        try:
            await self._do_compaction(task)
            ok = True
        finally:
            self.inused_memory -= task.input_size
            if not ok:
                self._unmark(task)

    async def _delete_objects(self, file_ids: list[int]) -> None:
        """Best-effort parallel SST object deletes (the manifest is
        already updated, so errors are logged, never raised —
        ref: executor.rs:224-253).  Sidecars ride along silently."""
        # tier-2 entries of the deleted ids go first: those SSTs are never
        # read again, and every surviving SST's part stays resident
        self.storage.reader.encoded_cache.invalidate(file_ids)
        store, root = self.storage.store, self.storage.root_path
        results = await asyncio.gather(
            *(store.delete(sst_path(root, fid)) for fid in file_ids),
            return_exceptions=True)
        for fid, res in zip(file_ids, results):
            if isinstance(res, BaseException):
                logger.error("failed to delete sst %s: %s", fid, res)
        await asyncio.gather(
            *(store.delete(sidecar.sidecar_path(root, fid))
              for fid in file_ids),
            return_exceptions=True)

    async def gc_expired(self, task: Task) -> None:
        """TTL garbage collection: drop expired SSTs from the manifest,
        then best-effort delete the objects.  No rewrite, no memory gate
        (nothing is read)."""
        with op_trace("ttl_gc", slow_s=120.0,
                      expireds=len(task.expireds)):
            await self._gc_expired_traced(task)

    async def _gc_expired_traced(self, task: Task) -> None:
        ok = False
        try:
            to_deletes = [f.id for f in task.expireds]
            if not to_deletes:
                ok = True
                return
            await self.storage.manifest.update(
                ManifestUpdate(to_adds=[], to_deletes=to_deletes))
            ok = True
            _TTL_GC_FILES.inc(len(to_deletes))
            await self._delete_objects(to_deletes)
        finally:
            if not ok:
                self._unmark(task)

    async def _do_compaction(self, task: Task) -> None:
        # each rewrite is a background op with its own trace tree (the
        # store's GETs and bytes attribute to it); "slow" for a
        # compaction is ten minutes, and the compaction.execute span's
        # histogram takes the wide buckets, as rewrites outlast 10 s
        with op_trace("compaction", slow_s=600.0,
                      inputs=len(task.inputs), bytes=task.input_size):
            with span("compaction.execute", buckets=WIDE_BUCKETS,
                      inputs=len(task.inputs),
                      expireds=len(task.expireds), bytes=task.input_size):
                await self._do_compaction_traced(task)

    async def _do_compaction_traced(self, task: Task) -> None:
        self._trigger_more()
        storage = self.storage
        time_range = task.inputs[0].meta.time_range
        for f in task.inputs[1:]:
            time_range = time_range.merged(f.meta.time_range)

        # the same merge pipeline as scan, keeping builtin columns so
        # surviving rows retain their original sequences; no caching
        # (the inputs are deleted right after), CPU work on the
        # "compact" pool
        plan = storage.reader.build_plan(
            task.inputs, ScanRequest(range=TimeRange.new(-(2**63), 2**63 - 1)),
            keep_builtin=True, use_cache=False, pool="compact")

        file_id = SstFile.allocate_id()
        path = sst_path(storage.root_path, file_id)

        # batches stream through the parquet encoder INTO the store
        # (peak memory ~one row group); the sidecar's encoded columns
        # (~12 B/row) collect alongside up to write.sidecar_max_rows,
        # past which the sidecar is dropped to bound the rewrite's RSS
        sc_parts: Optional[list] = (
            [] if (storage.schema().update_mode is UpdateMode.OVERWRITE
                   and storage.config.write.enable_sidecar) else None)
        sc_rows = 0

        async def restored():
            nonlocal sc_parts, sc_rows
            async for batch in storage.reader.execute(plan):
                if sc_parts is not None:
                    sc_rows += batch.num_rows
                    if sc_rows > storage.config.write.sidecar_max_rows:
                        sc_parts = None
                    else:
                        part = await storage.runtimes.run(
                            "compact", sidecar.encode_columns, batch)
                        if part is None:
                            sc_parts = None
                        else:
                            sc_parts.append(part)
                yield _restore_reserved_column(batch, storage.schema())

        size, num_rows = await parquet_io.write_sst_streaming(
            storage.store, path, restored(), storage.config.write,
            storage.schema(), runtimes=storage.runtimes, pool="compact")
        if sc_parts:
            try:
                merged = await storage.runtimes.run(
                    "compact", sidecar.merge_parts, sc_parts)
                if merged is not None:
                    cols, n_enc = merged
                    # write-through admission: the compactor holds the
                    # output's encoded columns, so the first query after
                    # the compaction rebuilds from host RAM
                    storage.reader.encoded_cache.admit(file_id, cols, n_enc)
                    data = await storage.runtimes.run(
                        "compact", sidecar.serialize, cols, n_enc)
                    if data is not None:
                        await storage.store.put(
                            sidecar.sidecar_path(storage.root_path,
                                                 file_id), data)
            except Exception as exc:  # noqa: BLE001 — cache write only
                logger.warning("sidecar write failed for compacted sst "
                               "%s: %s", file_id, exc)
        sc_parts = None
        meta = FileMeta(max_sequence=file_id, num_rows=num_rows, size=size,
                        time_range=time_range)

        # 1. new SST into the manifest, THEN 2. delete inputs+expireds —
        # a crash in between leaves garbage objects, never data loss
        to_deletes = [f.id for f in task.expireds] + [f.id for f in task.inputs]
        await storage.manifest.update(ManifestUpdate(
            to_adds=[SstFile(file_id, meta)], to_deletes=to_deletes))

        _COMPACTIONS.inc()
        _COMPACTION_ROWS.inc(num_rows)

        # from here on, errors must not propagate (manifest updated)
        await self._delete_objects(to_deletes)


def _restore_reserved_column(batch: pa.RecordBatch, schema) -> pa.RecordBatch:
    """Scan output omits the all-null __reserved__ column; the SST schema
    requires it, so stamp it back before writing."""
    if RESERVED_COLUMN_NAME in batch.schema.names:
        return batch
    arrays = [batch.column(i) for i in range(batch.num_columns)]
    arrays.append(pa.nulls(batch.num_rows, type=pa.uint64()))
    names = list(batch.schema.names) + [RESERVED_COLUMN_NAME]
    out = pa.RecordBatch.from_arrays(arrays, names=names)
    # reorder to the full storage schema
    return out.select(schema.arrow_schema.names).cast(schema.arrow_schema)


class Scheduler:
    """Background picker + executor loops and the orphan scrubber's loop
    (ref: scheduler.rs:49-159)."""

    def __init__(self, storage: "CloudObjectStorage"):
        cfg = storage.config.scheduler
        self.storage = storage
        self.interval_s = cfg.schedule_interval.seconds
        self._trigger: asyncio.Queue = asyncio.Queue(maxsize=4)
        self._tasks: asyncio.Queue = asyncio.Queue(
            maxsize=cfg.max_pending_compaction_tasks)
        self.picker = Picker(storage)
        self.executor = Executor(storage, self._trigger)
        self._loops: list[asyncio.Task] = []
        # loops check this at every turn: a cancel delivered exactly as
        # a trigger token completes the wait_for can be swallowed
        # (common/tasks.py), so cancellation alone cannot be the exit
        self._stopping = False

    async def start(self) -> None:
        self._stopping = False
        root = self.storage.root_path
        # every loop registers with the watchdog (common/loops.py): the
        # picker's stall threshold scales with its period, the
        # executor's is sized to a worst-case rewrite
        self._loops = [
            loops.spawn(self._generate_task_loop,
                        name=f"compact-picker:{root}",
                        kind="compact-picker", owner="compaction",
                        period_s=self.interval_s,
                        backlog=self._backlog),
            loops.spawn(self._recv_task_loop,
                        name=f"compact-executor:{root}",
                        kind="compact-executor", owner="compaction",
                        stall_threshold_s=900.0,
                        backlog=self._backlog),
        ]
        scrub_cfg = self.storage.config.scrub
        if scrub_cfg.enabled:
            self._loops.append(loops.spawn(
                lambda hb: self._scrub_loop(hb, scrub_cfg.interval.seconds),
                name=f"orphan-scrubber:{root}", kind="orphan-scrubber",
                owner="compaction",
                period_s=scrub_cfg.interval.seconds,
                stall_threshold_s=300.0))

    def _backlog(self) -> dict:
        """The watchdog's backlog hint: pending compaction work (queued
        tasks and reserved rewrite memory)."""
        return {"pending_tasks": self._tasks.qsize(),
                "pending_triggers": self._trigger.qsize(),
                "inused_memory": self.executor.inused_memory}

    async def stop(self) -> None:
        # flag + cancel_and_wait: trigger tokens race stop() by design
        # (a failing execute's trigger_more against close)
        self._stopping = True
        for t in self._loops:
            await cancel_and_wait(t)
        self._loops = []

    async def trigger(self) -> None:
        """Manual compaction entry (ref: scheduler.rs:106-112)."""
        try:
            self._trigger.put_nowait(None)
        except asyncio.QueueFull:
            pass

    async def _generate_task_loop(self, hb) -> None:
        while not self._stopping:
            try:
                await asyncio.wait_for(self._trigger.get(),
                                       timeout=self.interval_s)
            except (TimeoutError, asyncio.TimeoutError):
                pass
            hb.beat()
            if self._stopping:
                return
            # the picker runs serially (in_compaction marking is the
            # lock); transient store errors must not kill the loop
            try:
                task = await self.picker.pick_candidate()
                hb.ok()
            except Exception as exc:  # noqa: BLE001 — retried next tick
                hb.error(exc)
                logger.exception("compaction pick failed; will retry")
                continue
            if task is not None:
                try:
                    self._tasks.put_nowait(task)
                except asyncio.QueueFull:
                    # never ran pre_check, so only unmark
                    logger.warning("compaction task queue full, dropping pick")
                    Executor._unmark(task)

    async def _recv_task_loop(self, hb) -> None:
        failure_streak = 0
        while not self._stopping:
            hb.idle()  # parked on the task queue (healthy silence)
            task = await self._tasks.get()
            hb.beat()
            try:
                await self.executor.execute(task)
                hb.ok()
                failure_streak = 0
            except Exception as exc:  # noqa: BLE001 — backoff + retry
                hb.error(exc)
                logger.exception("compaction task failed")
                # back off on repeated failure: a dead store otherwise
                # spins the pick -> execute -> trigger cycle at full speed
                failure_streak += 1
                await asyncio.sleep(min(5.0, 0.05 * 2 ** failure_streak))

    async def _scrub_loop(self, hb, interval_s: float) -> None:
        while not self._stopping:
            hb.idle()  # the inter-pass sleep is healthy
            await asyncio.sleep(interval_s)
            hb.beat()
            try:
                report = await self.storage.scrubber.scrub()
                hb.ok()
                if report.orphans_deleted or report.errors:
                    logger.info("scrub pass: %s", report.as_dict())
            except Exception as exc:  # noqa: BLE001 — retried next pass
                hb.error(exc)
                logger.exception("orphan scrub pass failed; will retry")
