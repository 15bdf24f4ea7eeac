"""[wal] configuration: the durable-ingest front end (wal/ingest.py).

With the WAL enabled a write is acked after a group-commit fsync to a
local append-only log, and its rows wait in memtables, so small writes
stop paying a full object-store round trip each.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from horaedb_tpu_torch.common import ReadableDuration


@dataclass
class WalConfig:
    """Knobs for the WAL + memtable ingest subsystem.

    Group commit: concurrent writers queue framed records; one loop
    writes the queue to the active segment and issues ONE fsync for the
    whole group, then acks every waiter.  `max_group_bytes` flushes a
    group early; `max_group_wait` is the coalescing window a commit
    waits for more writers to pile on (0 = commit immediately).

    Flush: a memtable drains to one SST through the existing write path
    when it crosses `flush_rows` / `flush_bytes` / `flush_age`; only
    after the SST + manifest commit does the WAL truncation point
    advance (a crash between the two replays the rows, and the `__seq__`
    dedup makes that exactly-once).
    """

    enabled: bool = False
    # WAL directory (the engine appends a per-table subdirectory)
    dir: str = ""
    # rotate the active segment file past this many bytes; sealed
    # segments whose records are all flushed are deleted (truncation)
    segment_bytes: int = 64 << 20
    # group-commit triggers.  Writers that arrive during the previous
    # group's fsync already coalesce, so max_group_wait defaults to 0
    max_group_bytes: int = 1 << 20
    max_group_wait: ReadableDuration = field(
        default_factory=lambda: ReadableDuration.from_millis(0))
    # memtable flush thresholds
    flush_rows: int = 65536
    flush_bytes: int = 8 << 20
    flush_age: ReadableDuration = field(
        default_factory=lambda: ReadableDuration.from_secs(30))
    # background flusher poll period
    flush_interval: ReadableDuration = field(
        default_factory=lambda: ReadableDuration.from_secs(1))
