"""Core storage types: Timestamp, TimeRange, StorageSchema.

Mirrors src/storage/src/types.rs: the schema layout is
  pk1..pkN, value1..valueM, __seq__, __reserved__
with the two builtin UInt64 columns appended by the engine
(ref: types.rs:35-41, 160-196).  The per-file sequence stamped into
__seq__ is load-bearing for cross-file dedup: the merge path keeps the
row with the highest sequence among equal primary keys.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import pyarrow as pa

from horaedb_tpu_torch.common.error import ensure
from horaedb_tpu_torch.storage.config import UpdateMode

BUILTIN_COLUMN_NUM = 2
SEQ_COLUMN_NAME = "__seq__"
RESERVED_COLUMN_NAME = "__reserved__"

_I64_MIN = -(2**63)
_I64_MAX = 2**63 - 1


def _div_trunc(a: int, b: int) -> int:
    """Integer division truncating toward zero (Rust `/` on i64)."""
    q = a // b
    if a % b != 0 and (a < 0) != (b < 0):
        q += 1
    return q


class Timestamp(int):
    """Millisecond timestamp (ref: types.rs:45-86)."""

    MIN: "Timestamp"
    MAX: "Timestamp"

    def truncate_by(self, duration_ms: int) -> "Timestamp":
        """Align down toward zero to a duration boundary (ref: types.rs:82-85).

        Matches Rust i64 division semantics (truncation, not floor) so
        segment assignment of pre-epoch timestamps is bit-identical.
        """
        ensure(duration_ms > 0, "truncate_by needs a positive duration")
        return Timestamp(_div_trunc(int(self), duration_ms) * duration_ms)

    def __repr__(self) -> str:
        return f"Timestamp({int(self)})"


Timestamp.MIN = Timestamp(_I64_MIN)
Timestamp.MAX = Timestamp(_I64_MAX)


@dataclass(frozen=True, order=True)
class TimeRange:
    """Half-open range [start, end) (ref: types.rs:88-133)."""

    start: Timestamp
    end: Timestamp

    @classmethod
    def new(cls, start: int, end: int) -> "TimeRange":
        return cls(Timestamp(start), Timestamp(end))

    def overlaps(self, other: "TimeRange") -> bool:
        return self.start < other.end and other.start < self.end

    def contains(self, ts: int) -> bool:
        return self.start <= ts < self.end

    def merged(self, other: "TimeRange") -> "TimeRange":
        return TimeRange(
            Timestamp(min(self.start, other.start)),
            Timestamp(max(self.end, other.end)),
        )

    def __repr__(self) -> str:
        return f"[{int(self.start)}, {int(self.end)})"


@dataclass
class StorageSchema:
    """User schema + engine builtin columns (ref: types.rs:149-240).

    Layout: num_primary_keys PK columns first, then >=1 value columns,
    then __seq__ and __reserved__ (both UInt64, nullable) appended by us.
    """

    arrow_schema: pa.Schema
    num_primary_keys: int
    seq_idx: int
    reserved_idx: int
    value_idxes: list[int]
    update_mode: UpdateMode

    @classmethod
    def try_new(
        cls,
        user_schema: pa.Schema,
        num_primary_keys: int,
        update_mode: UpdateMode,
    ) -> "StorageSchema":
        ensure(num_primary_keys > 0, "num_primary_keys should be larger than 0")
        names = set(user_schema.names)
        ensure(
            SEQ_COLUMN_NAME not in names and RESERVED_COLUMN_NAME not in names,
            "schema should not use builtin column names",
        )
        num_fields = len(user_schema)
        value_idxes = list(range(num_primary_keys, num_fields))
        ensure(value_idxes, "no value column found")

        full = user_schema.append(pa.field(SEQ_COLUMN_NAME, pa.uint64())) \
                          .append(pa.field(RESERVED_COLUMN_NAME, pa.uint64()))
        return cls(
            arrow_schema=full,
            num_primary_keys=num_primary_keys,
            seq_idx=num_fields,
            reserved_idx=num_fields + 1,
            value_idxes=value_idxes,
            update_mode=update_mode,
        )

    @property
    def user_schema(self) -> pa.Schema:
        return pa.schema(
            [self.arrow_schema.field(i) for i in range(self.seq_idx)],
            metadata=self.arrow_schema.metadata,
        )

    @property
    def primary_key_names(self) -> list[str]:
        return self.arrow_schema.names[: self.num_primary_keys]

    @staticmethod
    def is_builtin_name(name: str) -> bool:
        return name in (SEQ_COLUMN_NAME, RESERVED_COLUMN_NAME)

    def fill_required_projections(self, projection: Optional[list[int]]) -> Optional[list[int]]:
        """PKs and __seq__ are always needed by the merge path
        (ref: types.rs:202-215).  Returns the augmented projection."""
        if projection is None:
            return None
        proj = list(projection)
        for i in range(self.num_primary_keys):
            if i not in proj:
                proj.append(i)
        if self.seq_idx not in proj:
            proj.append(self.seq_idx)
        return proj

    def fill_builtin_columns(self, batch: pa.RecordBatch, sequence: int) -> pa.RecordBatch:
        """Stamp the per-file sequence on every row (ref: types.rs:219-239)."""
        n = batch.num_rows
        if n == 0:
            return batch
        seq = pa.array(np.full(n, sequence, dtype=np.uint64))
        reserved = pa.nulls(n, type=pa.uint64())
        cols = list(batch.columns) + [seq, reserved]
        return pa.RecordBatch.from_arrays(cols, schema=self.arrow_schema)
