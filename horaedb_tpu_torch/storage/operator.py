"""Merge operators: row-merge semantics for equal primary keys
(ref: src/storage/src/operator.rs).

The Overwrite scan path keeps the last row of each PK run inside the
reader's merge; this module holds the host twin of that rule over a
PK-sorted Arrow batch, which the hybrid WAL scan applies to a segment's
SST rows plus its memtable rows (read.merge_memtable_overlay), and the
Append operator (BytesMerge), which the reader's host merge of an
Append table applies (read.ParquetReader._merge_on_host).  Run
detection over integer keys goes through the host library
(horaedb_tpu_torch.native); other key types compare in numpy.
"""

from __future__ import annotations

import numpy as np
import pyarrow as pa

from horaedb_tpu_torch import native
from horaedb_tpu_torch.common.error import Error, ensure


def _run_starts_host(batch: pa.RecordBatch,
                     pk_indices: list[int]) -> np.ndarray:
    """Boolean run-start mask over a PK-sorted batch.  pk_indices are
    explicit because a projection may have reordered columns: the PKs
    are not necessarily the first columns of the batch.  Integer key
    columns go through the host library's run_starts_i64; the others
    (strings) compare in numpy."""
    n = batch.num_rows
    if n == 0:
        return np.zeros(0, dtype=bool)
    int_cols: list[np.ndarray] = []
    other_cols: list[np.ndarray] = []
    for i in pk_indices:
        col = batch.column(i).to_numpy(zero_copy_only=False)
        if np.issubdtype(col.dtype, np.integer):
            int_cols.append(col.astype(np.int64, copy=False))
        else:
            other_cols.append(col)
    if int_cols:
        starts = native.run_starts_i64(int_cols)
    else:
        starts = np.zeros(n, dtype=bool)
        starts[0] = True
    for col in other_cols:
        starts[1:] |= col[1:] != col[:-1]
    return starts


class LastValueOperator:
    """Keep the last row of each group: the highest sequence wins
    (ref: operator.rs:37-44).  Overwrite mode."""

    def merge_sorted_batch(self, batch: pa.RecordBatch,
                           pk_indices: list[int]) -> pa.RecordBatch:
        n = batch.num_rows
        if n == 0:
            return batch
        starts = _run_starts_host(batch, pk_indices)
        return batch.take(pa.array(native.run_last_indices(starts)))


class BytesMergeOperator:
    """Concatenate Binary value columns across each group, in sequence
    order; non-value columns keep the group's first row
    (ref: operator.rs:46-111).  Append mode."""

    def __init__(self, value_idxes: list[int]):
        self.value_idxes = value_idxes

    def merge_sorted_batch(self, batch: pa.RecordBatch,
                           pk_indices: list[int]) -> pa.RecordBatch:
        n = batch.num_rows
        if n == 0:
            return batch
        for idx in self.value_idxes:
            t = batch.column(idx).type
            ensure(pa.types.is_binary(t) or pa.types.is_large_binary(t),
                   f"BytesMergeOperator requires binary columns, got {t}")

        starts = _run_starts_host(batch, pk_indices)
        first_idx = np.nonzero(starts)[0]
        group_of_row = np.cumsum(starts) - 1
        num_groups = len(first_idx)

        columns = []
        for idx in range(batch.num_columns):
            col = batch.column(idx)
            if idx not in self.value_idxes:
                columns.append(col.take(pa.array(first_idx)))
                continue
            # vectorized ragged concat: per-row byte lengths summed per
            # group, the rows' bytes already contiguous in group order
            ensure(col.null_count == 0,
                   "BytesMergeOperator input contains nulls (write path "
                   "rejects nulls; corrupt SST?)")
            flat = (col.cast(pa.binary())
                    if not pa.types.is_binary(col.type) else col)
            offsets = np.frombuffer(flat.buffers()[1], dtype=np.int32,
                                    count=n + 1, offset=flat.offset * 4)
            row_lens = (offsets[1:] - offsets[:-1]).astype(np.int64)
            group_lens = np.bincount(group_of_row, weights=row_lens,
                                     minlength=num_groups).astype(np.int64)
            values_buf = flat.buffers()[2]
            data = (np.frombuffer(values_buf, dtype=np.uint8)[
                offsets[0]:offsets[n]] if values_buf is not None
                else np.zeros(0, np.uint8))
            new_offsets = np.zeros(num_groups + 1, dtype=np.int32)
            np.cumsum(group_lens, out=new_offsets[1:])
            columns.append(pa.Array.from_buffers(
                pa.binary(), num_groups,
                [None, pa.py_buffer(new_offsets.tobytes()),
                 pa.py_buffer(data.tobytes())]))
        return pa.RecordBatch.from_arrays(columns, schema=batch.schema)


def build_operator(update_mode, value_idxes: list[int]):
    """The merge operator of a table's update mode."""
    from horaedb_tpu_torch.storage.config import UpdateMode

    if update_mode is UpdateMode.OVERWRITE:
        return LastValueOperator()
    if update_mode is UpdateMode.APPEND:
        return BytesMergeOperator(value_idxes)
    raise Error(f"unknown update mode: {update_mode}")
