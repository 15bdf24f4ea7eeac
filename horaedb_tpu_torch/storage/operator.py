"""Merge operators: row-merge semantics for equal primary keys
(ref: src/storage/src/operator.rs).

The Overwrite scan path keeps the last row of each PK run inside the
reader's merge; this module holds the host twin of that rule over a
PK-sorted Arrow batch, which the hybrid WAL scan applies to a segment's
SST rows plus its memtable rows (read.merge_memtable_overlay).  Run
detection over integer keys goes through the host library
(horaedb_tpu_torch.native); other key types compare in numpy.  The
Append operator (BytesMerge) is not ported yet.
"""

from __future__ import annotations

import numpy as np
import pyarrow as pa

from horaedb_tpu_torch import native


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
