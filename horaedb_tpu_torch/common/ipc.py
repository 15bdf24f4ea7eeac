"""Arrow IPC stream serialization — the single home for the cluster's
wire format (write plane and query plane must not drift).

Downsample grids also travel as Arrow (downsample_to_arrow /
downsample_from_arrow): one row per series, each aggregate a
FixedSizeList<f64>[num_buckets] column.  The JSON grid encoding turns
every f64 cell into decimal text (and NaN into null) — 2.6x the zstd'd
Arrow bytes even on incompressible random grids, more on real data."""

from __future__ import annotations

import io
from typing import Optional, Union

import numpy as np
import pyarrow as pa
import pyarrow.ipc

COMPRESSIONS = (None, "zstd", "lz4")


def serialize_stream(data: Union[pa.Table, pa.RecordBatch],
                     compression: Optional[str] = None) -> bytes:
    """Serialize a Table/RecordBatch as an IPC stream, optionally with
    compressed buffers.  Compression is OPT-IN per message: readers
    auto-detect, but not every Arrow implementation ships every codec,
    so public endpoints only compress when the client asked."""
    if compression not in COMPRESSIONS:
        raise ValueError(f"unsupported IPC compression {compression!r}; "
                         f"expected one of {COMPRESSIONS}")
    sink = io.BytesIO()
    opts = pyarrow.ipc.IpcWriteOptions(compression=compression)
    with pyarrow.ipc.new_stream(sink, data.schema, options=opts) as writer:
        if isinstance(data, pa.RecordBatch):
            writer.write_batch(data)
        else:
            writer.write_table(data)
    return sink.getvalue()


def downsample_to_arrow(out: dict) -> pa.Table:
    """Encode a query_downsample result ({tsids, num_buckets, aggs:
    {name: (n, num_buckets) float grid}}) as an Arrow table.  NaN cells
    stay NaN (no None round trip)."""
    nb = max(1, int(out["num_buckets"]))
    tsids = np.asarray(out["tsids"], dtype=np.uint64)
    n = len(tsids)
    cols: dict = {"tsid": pa.array(tsids, type=pa.uint64())}
    for name, grid in out["aggs"].items():
        g = np.ascontiguousarray(np.asarray(grid, dtype=np.float64))
        g = g.reshape(n, nb) if n else np.zeros((0, nb))
        cols[f"agg_{name}"] = pa.FixedSizeListArray.from_arrays(
            pa.array(g.reshape(-1), type=pa.float64()), nb)
    return pa.table(cols, metadata={
        b"num_buckets": str(int(out["num_buckets"])).encode()})


def downsample_from_arrow(tbl: pa.Table) -> dict:
    """Inverse of downsample_to_arrow."""
    meta = tbl.schema.metadata or {}
    if b"num_buckets" not in meta:
        raise ValueError(
            "downsample table missing num_buckets metadata "
            "(malformed peer response)")
    nb = int(meta[b"num_buckets"])
    tsids = tbl.column("tsid").to_numpy(zero_copy_only=False)
    n = len(tsids)
    aggs = {}
    for name in tbl.schema.names:
        if not name.startswith("agg_"):
            continue
        col = tbl.column(name).combine_chunks()
        # width comes from the FixedSizeList type itself so the grid
        # shape always matches what the peer encoded (nb==0 encodes as
        # width-1 grids; trusting metadata alone would mis-reshape)
        width = col.type.list_size
        flat = col.values.to_numpy(zero_copy_only=False)
        aggs[name[len("agg_"):]] = flat.reshape(n, width)
    return {"tsids": [int(t) for t in tsids], "num_buckets": nb,
            "aggs": aggs}
