"""Per-time-segment mutable write buffer.

A memtable holds the acked-but-unflushed writes of ONE time segment
(keyed like SSTs: range-start truncation).  It serves reads at once:
`stamped_batches` hands the scan path full-schema batches with each
entry's write seq filled into `__seq__`, so the hybrid merge dedups
memtable rows against SST rows under the one last-value rule.  It
drains to a single SST via `drain()` once the flusher finds it over a
threshold.

Seqs are preserved end to end (write -> WAL -> memtable -> flushed
SST): restamping at flush time would let a flush racing a concurrent
write lift old rows above a newer, already-allocated seq.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import pyarrow as pa

from horaedb_tpu_torch.storage.types import StorageSchema, TimeRange
from horaedb_tpu_torch.utils import registry

_MEM_ROWS = registry.gauge(
    "memtable_rows", "acked rows buffered in memtables, not yet in SSTs")
_MEM_BYTES = registry.gauge(
    "memtable_bytes", "arrow bytes buffered in memtables")


@dataclass
class MemEntry:
    seq: int
    batch: pa.RecordBatch  # user schema
    time_range: TimeRange
    # the stamped (full-schema, seq-filled) twin, built once: the
    # hybrid scan snapshots every entry per query
    _stamped: Optional[pa.RecordBatch] = None

    def stamped(self, schema: StorageSchema) -> pa.RecordBatch:
        if self._stamped is None:
            self._stamped = schema.fill_builtin_columns(self.batch,
                                                        self.seq)
        return self._stamped


class Memtable:
    def __init__(self, segment_start: int, created_at: float):
        self.segment_start = segment_start
        self.created_at = created_at  # injected-clock time of first entry
        self.entries: list[MemEntry] = []
        self.rows = 0
        self.bytes = 0

    def add(self, entry: MemEntry) -> None:
        self.entries.append(entry)
        self.rows += entry.batch.num_rows
        self.bytes += entry.batch.nbytes
        _MEM_ROWS.inc(entry.batch.num_rows)
        _MEM_BYTES.inc(entry.batch.nbytes)

    def account_drop(self) -> None:
        """Gauge bookkeeping when this memtable leaves the live map
        (flushed or abandoned)."""
        _MEM_ROWS.inc(-self.rows)
        _MEM_BYTES.inc(-self.bytes)

    @property
    def time_range(self) -> Optional[TimeRange]:
        rng = None
        for e in self.entries:
            rng = e.time_range if rng is None else rng.merged(e.time_range)
        return rng

    @property
    def seqs(self) -> list[int]:
        return [e.seq for e in self.entries]

    def stamped_batches(self, schema: StorageSchema,
                        scan_range: Optional[TimeRange] = None
                        ) -> list[pa.RecordBatch]:
        """Full-schema batches with per-entry seqs stamped, filtered by
        range overlap per entry (the granularity the manifest filters
        SSTs at; row-exact time filtering stays the predicate's job)."""
        out = []
        for e in self.entries:
            if scan_range is not None and not e.time_range.overlaps(
                    scan_range):
                continue
            if e.batch.num_rows:
                out.append(e.stamped(schema))
        return out

    def drain(self, schema: StorageSchema):
        """(stamped concatenated table, union range, seqs) for the
        flusher: per-row seqs preserved; the SST write sorts by
        (PK, __seq__) so equal-PK runs stay in last-value order."""
        stamped = [e.stamped(schema)
                   for e in self.entries if e.batch.num_rows]
        if not stamped:
            return None, None, self.seqs
        return (pa.Table.from_batches(stamped), self.time_range, self.seqs)
