"""SST file model (ref: src/storage/src/sst.rs).

File ids come from a process-wide monotonic counter seeded with wall-clock
nanoseconds so ids never go backwards across restarts (ref: sst.rs:36-46)
— the id doubles as the write sequence for cross-file dedup.
"""

from __future__ import annotations

from dataclasses import dataclass

from horaedb_tpu_torch.common.error import ensure
from horaedb_tpu_torch.common.id_alloc import MonotonicIdAllocator
from horaedb_tpu_torch.storage.types import TimeRange, Timestamp

DATA_PREFIX = "data"

FileId = int

_SST_IDS = MonotonicIdAllocator()


_U32_MAX = (1 << 32) - 1
_U64_MAX = (1 << 64) - 1


@dataclass(frozen=True)
class FileMeta:
    """Per-SST metadata (ref: sst.rs FileMeta, pb sst.proto SstMeta).

    num_rows and size are u32 on the wire (sst.proto SstMeta, snapshot
    record layout), so the bounds are enforced at construction — a write
    that would overflow must fail at write time, not inside the manifest
    merger.
    """

    max_sequence: int
    num_rows: int
    size: int
    time_range: TimeRange

    def __post_init__(self) -> None:
        ensure(0 <= self.max_sequence <= _U64_MAX,
               f"max_sequence out of u64 range: {self.max_sequence}")
        ensure(0 <= self.num_rows <= _U32_MAX,
               f"num_rows out of u32 range: {self.num_rows}")
        ensure(0 <= self.size <= _U32_MAX,
               f"sst size out of u32 range: {self.size} (split the write)")


class SstFile:
    __slots__ = ("id", "meta", "_in_compaction")

    def __init__(self, file_id: FileId, meta: FileMeta):
        self.id = file_id
        self.meta = meta
        self._in_compaction = False

    @staticmethod
    def allocate_id() -> FileId:
        return _SST_IDS.allocate()

    def mark_compaction(self) -> None:
        """The picker's lock: a marked file is never picked again until
        its task fails and unmarks it (ref: sst.rs)."""
        self._in_compaction = True

    def unmark_compaction(self) -> None:
        self._in_compaction = False

    @property
    def in_compaction(self) -> bool:
        return self._in_compaction

    def is_expired(self, expire_time: "Timestamp | None") -> bool:
        """TTL check: a file is expired when it ends before `expire_time`
        (ref: sst.rs:109-114)."""
        return (expire_time is not None
                and self.meta.time_range.end < expire_time)

    @property
    def size(self) -> int:
        return self.meta.size

    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, SstFile)
            and other.id == self.id
            and other.meta == self.meta
        )

    def __hash__(self) -> int:
        return hash(self.id)

    def __repr__(self) -> str:
        return (
            f"SstFile(id={self.id}, rows={self.meta.num_rows}, "
            f"size={self.meta.size}, range={self.meta.time_range}, "
            f"in_compaction={self._in_compaction})"
        )


def sst_path(prefix: str, file_id: FileId) -> str:
    """Object-store key for an SST (ref: sst.rs:202-204: `{prefix}/data/{id}.sst`)."""
    return f"{prefix}/{DATA_PREFIX}/{file_id}.sst"


def segment_of(f: "SstFile", segment_duration_ms: int) -> int:
    """The time segment an SST belongs to — THE segment-assignment rule
    (keyed by range START truncation, ref: storage.rs:342-350)."""
    return int(f.meta.time_range.start.truncate_by(segment_duration_ms))
