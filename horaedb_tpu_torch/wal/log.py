"""Segmented write-ahead log with group commit.

On-disk layout: `{dir}/{id:020d}.wal`, append-only.  Each record is

    [u32 payload_len][u32 crc32(payload)]
    payload = [u64 seq][i64 range_start][i64 range_end][arrow IPC stream]

carrying ONE record batch in the table's USER schema.  The format is
the JAX package's byte for byte, so a log written by either package
replays in the other.  The seq is the write sequence the ingest layer
allocated (the id space SST file ids come from), so replayed rows keep
their place in the `__seq__` last-value rule and a re-flush after a
crash stays exactly-once.

Group commit: writers enqueue framed records and await; one committer
loop drains the queue (bounded by `max_group_bytes`, padded by a
`max_group_wait` coalescing window), writes the group to the active
segment, issues ONE fsync, then acks every waiter.  Rotation seals the
active segment past `segment_bytes`; `mark_flushed` + `truncate()`
delete sealed segments once every record in them reached an SST.

Every durable transition goes through `_op()`, so a test can inject a
crash at an exact op index.  Time never comes from the wall clock
here: replay order relies only on the persisted seqs.

Not ported yet: the replication hub's hooks (`verify_frames`,
`mirror_watermarks`, `segments()`, `read_tail`, `high_watermark`,
`flushed_seq` and the `retention` hook; ROADMAP Queue A 9b), so
`truncate` deletes every sealed, fully-flushed segment.
"""

from __future__ import annotations

import asyncio
import io
import logging
import os
import struct
import zlib
from dataclasses import dataclass, field as dc_field
from typing import Callable, Iterator, Optional

import pyarrow as pa

from horaedb_tpu_torch.common.error import Error, ensure
from horaedb_tpu_torch.common.loops import loops
from horaedb_tpu_torch.storage.types import TimeRange
from horaedb_tpu_torch.utils import op_trace, registry
from horaedb_tpu_torch.wal.config import WalConfig

logger = logging.getLogger(__name__)

_HEADER = struct.Struct("<II")   # payload_len, crc32
_META = struct.Struct("<Qqq")    # seq, range_start, range_end

_APPENDS = registry.counter(
    "wal_appends_total", "records appended to the WAL, by log")
_GROUP_COMMITS = registry.counter(
    "wal_group_commits_total", "group commits (one fsync each), by log")
_BYTES_WRITTEN = registry.counter(
    "wal_bytes_written_total", "bytes appended to WAL segments, by log")
_REPLAYED_RECORDS = registry.counter(
    "wal_replayed_records_total", "records recovered by replay, by log")
_REPLAY_CORRUPT = registry.counter(
    "wal_replay_corrupt_records_total",
    "torn/corrupt records skipped during replay")
_TRUNCATED_SEGMENTS = registry.counter(
    "wal_truncated_segments_total",
    "fully-flushed WAL segments deleted, by log")
_BACKLOG = registry.gauge(
    "wal_backlog_bytes",
    "bytes in WAL segments of open logs not yet truncated, by log")
_SEGMENTS = registry.gauge(
    "wal_segments", "live WAL segment files of open logs, by log")


class WalError(Error):
    """A WAL durable op failed (the write was NOT acked)."""


@dataclass
class WalRecord:
    seq: int
    time_range: TimeRange
    batch: pa.RecordBatch


@dataclass
class _Segment:
    id: int
    path: str
    size: int
    # seqs recorded in this segment that no SST covers yet; the segment
    # is deletable once sealed AND this drains empty
    pending: set = dc_field(default_factory=set)


def encode_record(seq: int, time_range: TimeRange,
                  batch: pa.RecordBatch) -> bytes:
    sink = pa.BufferOutputStream()
    with pa.ipc.new_stream(sink, batch.schema) as w:
        w.write_batch(batch)
    payload = _META.pack(seq, int(time_range.start),
                         int(time_range.end)) + sink.getvalue().to_pybytes()
    return _HEADER.pack(len(payload), zlib.crc32(payload)) + payload


def decode_records(blob: bytes, path: str = "<wal>") -> Iterator[WalRecord]:
    """Parse one segment's bytes.  Stops at the first torn/corrupt
    record: everything past a bad frame is unframed garbage (a crash
    mid-append), and no record after it can have been acked, since group
    commit acks in file order."""
    off = 0
    n = len(blob)
    while off + _HEADER.size <= n:
        length, crc = _HEADER.unpack_from(blob, off)
        start = off + _HEADER.size
        end = start + length
        if length < _META.size or end > n:
            _REPLAY_CORRUPT.inc()
            logger.warning("wal %s: torn record at offset %d", path, off)
            return
        payload = blob[start:end]
        if zlib.crc32(payload) != crc:
            _REPLAY_CORRUPT.inc()
            logger.warning("wal %s: crc mismatch at offset %d", path, off)
            return
        seq, rs, re = _META.unpack_from(payload, 0)
        try:
            with pa.ipc.open_stream(
                    io.BytesIO(payload[_META.size:])) as reader:
                table = reader.read_all()
        except pa.ArrowInvalid:
            _REPLAY_CORRUPT.inc()
            logger.warning("wal %s: bad arrow payload at offset %d",
                           path, off)
            return
        batches = table.combine_chunks().to_batches()
        batch = batches[0] if batches else pa.record_batch(
            [pa.array([], type=f.type) for f in table.schema],
            schema=table.schema)
        yield WalRecord(seq=seq, time_range=TimeRange.new(rs, re),
                        batch=batch)
        off = end


class Wal:
    """One table's segmented log + group-commit loop.

    All bookkeeping mutates on the event loop; blocking file I/O runs
    in a thread (asyncio.to_thread) with plain arguments, so threads
    never touch shared state.  Per-log metrics carry the log's directory
    name in theirs: `wal_appends_total:<log>`.
    """

    def __init__(self, wal_dir: str, config: WalConfig,
                 on_op: Optional[Callable[[str], None]] = None):
        self.dir = wal_dir
        self.config = config
        lab = {"log": os.path.basename(os.path.normpath(wal_dir)) or "wal"}
        self._log_label = lab["log"]
        self._m_appends = _APPENDS.labels(**lab)
        self._m_group_commits = _GROUP_COMMITS.labels(**lab)
        self._m_bytes_written = _BYTES_WRITTEN.labels(**lab)
        self._m_replayed = _REPLAYED_RECORDS.labels(**lab)
        self._m_truncated = _TRUNCATED_SEGMENTS.labels(**lab)
        self._m_backlog = _BACKLOG.labels(**lab)
        self._m_segments = _SEGMENTS.labels(**lab)
        self._on_op = on_op
        self._active: Optional[_Segment] = None
        self._active_file = None
        self._sealed: dict[int, _Segment] = {}
        self._next_id = 1
        self._queue: list = []          # [(blob, seq, future), ...]
        self._queue_bytes = 0
        self._wake: Optional[asyncio.Event] = None
        self._commit_task: Optional[asyncio.Task] = None
        self._stopping = False
        self._truncate_lock = asyncio.Lock()
        # serializes group writes against truncate() sealing the active
        # segment (both run on the event loop, but each awaits blocking
        # file work mid-flight)
        self._commit_lock = asyncio.Lock()

    # ---- open / replay ----------------------------------------------------

    def replay(self) -> list[WalRecord]:
        """Synchronous (call before serving): scan existing segments in
        id order, return every intact record, and register the segments
        as sealed (deletable once their seqs flush).  Appends always go
        to a FRESH segment, so a torn tail is never appended past."""
        os.makedirs(self.dir, exist_ok=True)
        out: list[WalRecord] = []
        ids = []
        for name in sorted(os.listdir(self.dir)):
            if not name.endswith(".wal"):
                continue
            try:
                seg_id = int(name[:-4])
            except ValueError:
                continue
            ids.append(seg_id)
            path = os.path.join(self.dir, name)
            with open(path, "rb") as f:
                blob = f.read()
            seg = _Segment(id=seg_id, path=path, size=len(blob))
            for rec in decode_records(blob, path):
                seg.pending.add(rec.seq)
                out.append(rec)
            self._sealed[seg_id] = seg
            self._m_backlog.inc(seg.size)
            self._m_segments.inc()
        self._next_id = max(ids, default=0) + 1
        self._m_replayed.inc(len(out))
        return out

    def start(self) -> None:
        ensure(self._commit_task is None, "wal already started")
        self._wake = asyncio.Event()
        # fsync rounds are seconds at worst even on sick disks; a
        # committer that stops beating for 30 s is wedged, not busy
        self._commit_task = loops.spawn(
            self._commit_loop, name=f"wal-commit:{self.dir}",
            kind="wal-commit", owner="wal", stall_threshold_s=30.0,
            backlog=lambda: {"queued_records": len(self._queue),
                             "queued_bytes": self._queue_bytes,
                             "backlog_bytes": self.backlog_bytes})

    async def close(self) -> None:
        self._stopping = True
        if self._commit_task is not None:
            self._wake.set()
            try:
                await self._commit_task
            except asyncio.CancelledError:
                pass
            self._commit_task = None
        for _, seq, fut in self._queue:
            if not fut.done():
                fut.set_exception(WalError("wal closed"))
        self._queue = []
        self._queue_bytes = 0
        if self._active_file is not None:
            try:
                self._active_file.close()
            except OSError:
                pass
            self._active_file = None
        # the backlog gauge tracks OPEN logs; the on-disk bytes persist
        # and re-register at the next replay
        for seg in list(self._sealed.values()):
            self._m_backlog.inc(-seg.size)
            self._m_segments.inc(-1)
        if self._active is not None:
            self._m_backlog.inc(-self._active.size)
            self._m_segments.inc(-1)
        self._sealed = {}
        self._active = None

    # ---- append (group commit) -------------------------------------------

    async def append(self, seq: int, time_range: TimeRange,
                     batch: pa.RecordBatch) -> int:
        """Frame + enqueue one record; resolves with the framed size
        AFTER the group's fsync reached disk (the ack point)."""
        ensure(self._commit_task is not None, "wal not started")
        blob = encode_record(seq, time_range, batch)
        fut = asyncio.get_running_loop().create_future()
        self._queue.append((blob, seq, fut))
        self._queue_bytes += len(blob)
        self._wake.set()
        return await fut

    async def _commit_loop(self, hb) -> None:
        cfg = self.config
        while True:
            hb.idle()  # parked on the un-timed wake (healthy silence)
            await self._wake.wait()
            hb.beat()
            self._wake.clear()
            if self._stopping and not self._queue:
                return
            while self._queue:
                hb.beat()
                if (cfg.max_group_wait.seconds > 0
                        and self._queue_bytes < cfg.max_group_bytes
                        and not self._stopping):
                    # coalescing window: let concurrent writers pile on
                    await asyncio.sleep(cfg.max_group_wait.seconds)
                group: list = []
                size = 0
                while self._queue and size < cfg.max_group_bytes:
                    item = self._queue.pop(0)
                    group.append(item)
                    size += len(item[0])
                self._queue_bytes -= size
                try:
                    # one op trace per group-commit fsync round
                    with op_trace("wal_commit", slow_s=5.0,
                                  log=self._log_label,
                                  records=len(group), bytes=size):
                        await self._commit_group(group, size)
                    hb.ok()
                except asyncio.CancelledError:
                    for _, _, fut in group:
                        if not fut.done():
                            fut.set_exception(WalError("wal cancelled"))
                    self._quarantine_active_nowait()
                    raise
                except Exception as exc:  # noqa: BLE001 — fail the group
                    hb.error(exc)
                    for _, _, fut in group:
                        if not fut.done():
                            fut.set_exception(
                                exc if isinstance(exc, WalError)
                                else WalError(f"wal append failed: {exc}"))
                    # the failed write may have left a TORN frame at the
                    # active segment's tail; appending past it would put
                    # later ACKED groups behind bytes replay cannot cross
                    # (decode stops at the first bad frame), so the next
                    # group must start a fresh segment
                    await self._quarantine_active()
            if self._stopping:
                return

    async def _commit_group(self, group: list, size: int) -> None:
        async with self._commit_lock:
            await self._commit_group_locked(group, size)

    async def _commit_group_locked(self, group: list, size: int) -> None:
        if self._active is None or (
                self._active.size + size > self.config.segment_bytes
                and self._active.size > 0):
            await self._rotate()
        seg = self._active
        f = self._active_file
        blobs = [blob for blob, _, _ in group]
        await asyncio.to_thread(self._write_group_blocking, f, blobs)
        seg.size += size
        for blob, seq, _ in group:
            seg.pending.add(seq)
        self._m_appends.inc(len(group))
        self._m_group_commits.inc()
        self._m_bytes_written.inc(size)
        self._m_backlog.inc(size)
        for blob, _, fut in group:
            if not fut.done():
                fut.set_result(len(blob))

    def _op(self, op: str) -> None:
        if self._on_op is not None:
            self._on_op(op)

    def _write_group_blocking(self, f, blobs: list) -> None:
        self._op("append")
        for blob in blobs:
            f.write(blob)
        f.flush()
        self._op("fsync")
        os.fsync(f.fileno())
        self._op("acked")

    def _seal_active(self):
        """Quarantine bookkeeping after a failed group write: seal the
        active segment so its intact prefix (every previously fsynced
        record) stays replayable and truncatable, and no later append
        lands past a possibly-torn tail frame.  Returns the file handle
        for the caller to close."""
        if self._active is None:
            return None
        seg, f = self._active, self._active_file
        self._active = None
        self._active_file = None
        self._sealed[seg.id] = seg
        return f

    async def _quarantine_active(self) -> None:
        f = self._seal_active()
        if f is not None:
            try:
                await asyncio.to_thread(f.close)
            except OSError:
                pass

    def _quarantine_active_nowait(self) -> None:
        """The cancellation path's twin (cannot await mid-unwind)."""
        f = self._seal_active()
        if f is not None:
            try:
                f.close()
            except OSError:
                pass

    async def _rotate(self) -> None:
        """Seal the active segment and open a fresh one (the new file
        plus a directory fsync, so the entry itself is durable)."""
        if self._active is not None:
            old_file = self._active_file
            self._sealed[self._active.id] = self._active
            self._active = None
            self._active_file = None
            await asyncio.to_thread(old_file.close)
        seg_id = self._next_id
        self._next_id += 1
        path = os.path.join(self.dir, f"{seg_id:020d}.wal")
        f = await asyncio.to_thread(self._open_segment_blocking, path)
        self._active = _Segment(id=seg_id, path=path, size=0)
        self._active_file = f
        self._m_segments.inc()

    def _open_segment_blocking(self, path: str):
        os.makedirs(self.dir, exist_ok=True)
        f = open(path, "ab")
        dir_fd = os.open(self.dir, os.O_RDONLY)
        try:
            os.fsync(dir_fd)
        finally:
            os.close(dir_fd)
        return f

    # ---- flush / truncation ----------------------------------------------

    def mark_flushed(self, seqs) -> None:
        """Record that these seqs are covered by a committed SST; their
        segments become truncatable once fully drained and sealed."""
        remaining = set(seqs)
        for seg in self._sealed.values():
            if seg.pending:
                seg.pending -= remaining
        if self._active is not None and self._active.pending:
            self._active.pending -= remaining

    async def truncate(self) -> int:
        """Delete sealed, fully-flushed segments.  The SST + manifest
        commit MUST precede the mark_flushed that makes a segment
        deletable: that order is the crash-safety invariant.  Returns
        the number of segments deleted."""
        async with self._truncate_lock:
            # a fully-drained, non-empty ACTIVE segment seals too: a
            # complete flush returns the steady-state backlog to zero
            # (the commit lock keeps a mid-flight group off the file)
            if (self._active is not None and self._active.size > 0
                    and not self._active.pending and not self._queue):
                async with self._commit_lock:
                    if (self._active is not None
                            and self._active.size > 0
                            and not self._active.pending
                            and not self._queue):
                        seg, f = self._active, self._active_file
                        self._active = None
                        self._active_file = None
                        self._sealed[seg.id] = seg
                        await asyncio.to_thread(f.close)
            dead = [seg for seg in self._sealed.values() if not seg.pending]
            for seg in dead:
                await asyncio.to_thread(self._unlink_blocking, seg.path)
                self._sealed.pop(seg.id, None)
                self._m_truncated.inc()
                self._m_backlog.inc(-seg.size)
                self._m_segments.inc(-1)
            return len(dead)

    def _unlink_blocking(self, path: str) -> None:
        self._op("truncate")
        try:
            os.unlink(path)
        except FileNotFoundError:
            pass
        dir_fd = os.open(self.dir, os.O_RDONLY)
        try:
            os.fsync(dir_fd)
        finally:
            os.close(dir_fd)

    # ---- introspection ----------------------------------------------------

    @property
    def backlog_bytes(self) -> int:
        total = sum(s.size for s in self._sealed.values())
        if self._active is not None:
            total += self._active.size
        return total

    @property
    def segment_count(self) -> int:
        return len(self._sealed) + (1 if self._active is not None else 0)
