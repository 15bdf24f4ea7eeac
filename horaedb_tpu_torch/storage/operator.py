"""Merge operators: row-merge semantics for equal primary keys
(ref: src/storage/src/operator.rs).

The Overwrite scan path keeps the last row of each PK run inside the
reader's merge; this module holds the host twin of that rule over a
PK-sorted Arrow batch, which the hybrid WAL scan applies to a segment's
SST rows plus its memtable rows (read.merge_memtable_overlay).  Run
detection is vectorised numpy.  The Append operator (BytesMerge) is not
ported yet.
"""

from __future__ import annotations

import numpy as np
import pyarrow as pa


def _run_starts_host(batch: pa.RecordBatch,
                     pk_indices: list[int]) -> np.ndarray:
    """Boolean run-start mask over a PK-sorted batch.  pk_indices are
    explicit because a projection may have reordered columns: the PKs
    are not necessarily the first columns of the batch."""
    n = batch.num_rows
    starts = np.zeros(n, dtype=bool)
    if n == 0:
        return starts
    starts[0] = True
    for i in pk_indices:
        col = batch.column(i).to_numpy(zero_copy_only=False)
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
        idx = np.flatnonzero(starts)
        last_idx = np.append(idx[1:] - 1, n - 1)
        return batch.take(pa.array(last_idx))
