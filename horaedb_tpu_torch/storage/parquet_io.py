"""Parquet SST encode/decode on top of the ObjectStore.

Maps WriteConfig onto pyarrow writer properties the way the reference maps
its config onto parquet-rs WriterProperties (ref: src/storage/src/
storage.rs:257-297 build_write_props): row-group size, write batch size,
global + per-column dictionary/compression/encoding, and sorting-columns
metadata recording the (pk..., seq) sort order.  The files are the JAX
package's files byte for byte, so either package reads the other's SSTs.

Reads decode through pyarrow with the pushed-down predicate as a dataset
filter; the JAX package's stats-pruned decode and streamed fetch are not
ported yet.
"""

from __future__ import annotations

import io
from typing import Optional

import pyarrow as pa
import pyarrow.parquet as pq

from horaedb_tpu_torch.objstore import NotFoundError, ObjectStore
from horaedb_tpu_torch.storage.config import WriteConfig
from horaedb_tpu_torch.storage.types import StorageSchema


def writer_options(config: WriteConfig, schema: StorageSchema) -> dict:
    """pyarrow ParquetWriter kwargs from a WriteConfig."""
    names = schema.arrow_schema.names

    def dict_enabled(n: str) -> bool:
        opt = config.column_options.get(n)
        if opt is not None and opt.enable_dict is not None:
            return opt.enable_dict
        return config.enable_dict

    per_col_dict = {n: dict_enabled(n) for n in names}
    if all(v == config.enable_dict for v in per_col_dict.values()):
        use_dictionary: object = config.enable_dict
    else:
        use_dictionary = [n for n, v in per_col_dict.items() if v]

    compression: object = config.compression.value
    per_col_comp = {
        n: config.column_options[n].compression.value
        for n in names
        if n in config.column_options and config.column_options[n].compression
    }
    if per_col_comp:
        compression = {n: per_col_comp.get(n, config.compression.value) for n in names}

    per_col_enc = {
        n: config.column_options[n].encoding
        for n in names
        if n in config.column_options and config.column_options[n].encoding
    }
    if per_col_enc:
        # per-column overrides must not drop the global default elsewhere
        column_encoding: object = (
            {n: per_col_enc.get(n, config.encoding) for n in names}
            if config.encoding else per_col_enc)
    else:
        column_encoding = config.encoding

    kwargs = dict(
        use_dictionary=use_dictionary,
        compression=compression,
        write_statistics=True,
        write_batch_size=config.write_batch_size,
    )
    if column_encoding:
        kwargs["column_encoding"] = column_encoding
    if config.enable_sorting_columns:
        kwargs["sorting_columns"] = [
            pq.SortingColumn(i) for i in range(schema.num_primary_keys)
        ] + [pq.SortingColumn(schema.seq_idx)]
    return kwargs


def encode_sst(batches: list[pa.RecordBatch], config: WriteConfig,
               schema: StorageSchema) -> bytes:
    """Serialize sorted, builtin-stamped batches into one Parquet file."""
    sink = io.BytesIO()
    writer = pq.ParquetWriter(sink, schema.arrow_schema,
                              **writer_options(config, schema))
    try:
        for batch in batches:
            writer.write_batch(batch, row_group_size=config.max_row_group_size)
    finally:
        writer.close()
    return sink.getvalue()


async def _run(runtimes, pool: str, fn, *args, **kwargs):
    """Run CPU work on a named pool (common.runtimes), falling back to
    asyncio's default thread pool when no runtimes were provided — the
    event loop itself NEVER encodes/decodes parquet (ref: dedicated
    runtimes, storage.rs:91-104)."""
    import asyncio
    import functools

    if runtimes is not None:
        return await runtimes.run(pool, fn, *args, **kwargs)
    return await asyncio.to_thread(functools.partial(fn, *args, **kwargs))


async def write_sst(store: ObjectStore, path: str,
                    batches: list[pa.RecordBatch], config: WriteConfig,
                    schema: StorageSchema, runtimes=None) -> int:
    """Encode + put; returns the file size in bytes."""
    data = await _run(runtimes, "sst", encode_sst, batches, config, schema)
    await store.put(path, data)
    return len(data)


class _DrainableSink(io.RawIOBase):
    """File-like sink the ParquetWriter writes into; drain() hands the
    bytes accumulated since the last drain to the store stream, so the
    encoded SST never exists in one buffer."""

    def __init__(self) -> None:
        self._chunks: list[bytes] = []
        self._pos = 0

    def writable(self) -> bool:
        return True

    def write(self, b) -> int:
        data = bytes(b)
        self._chunks.append(data)
        self._pos += len(data)
        return len(data)

    def tell(self) -> int:
        return self._pos

    def drain(self) -> bytes:
        out = b"".join(self._chunks)
        self._chunks.clear()
        return out


async def write_sst_streaming(store: ObjectStore, path: str, batches,
                              config: WriteConfig, schema: StorageSchema,
                              runtimes=None, pool: str = "compact"
                              ) -> tuple[int, int]:
    """Stream an async iterator of sorted batches through the parquet
    encoder INTO the store: each flushed row group is handed to
    store.put_stream as it encodes, so peak RSS for a large SST is about
    one row group (ref: storage.rs:192-212, executor.rs:155-222).  A
    mid-stream failure propagates out of put_stream's iterator and
    leaves no readable object.  Returns (size, num_rows)."""
    import asyncio

    sink = _DrainableSink()
    writer = pq.ParquetWriter(sink, schema.arrow_schema,
                              **writer_options(config, schema))
    rows = 0

    async def chunks():
        nonlocal rows
        closed = False
        pending = None  # the in-flight pool job using `writer`

        async def run_writer(fn, *args, **kwargs):
            # shielded so a CANCELLED caller leaves `pending` visible:
            # the pool job keeps running after cancellation, and the
            # finally below waits it out before touching the writer
            # (ParquetWriter is not thread-safe)
            nonlocal pending
            pending = asyncio.ensure_future(
                _run(runtimes, pool, fn, *args, **kwargs))
            try:
                return await asyncio.shield(pending)
            finally:
                if pending.done():
                    pending = None

        try:
            async for batch in batches:
                rows += batch.num_rows
                # slice to row-group size so every flushed group drains
                # to the store before the next encodes
                step = max(1, config.max_row_group_size)
                for off in range(0, batch.num_rows, step):
                    await run_writer(writer.write_batch,
                                     batch.slice(off, step),
                                     row_group_size=step)
                    data = sink.drain()
                    if data:
                        yield data
            await run_writer(writer.close)
            closed = True
            tail = sink.drain()
            if tail:
                yield tail
        finally:
            if pending is not None and not pending.done():
                await asyncio.gather(pending, return_exceptions=True)
            if not closed:
                writer.close()

    size = await store.put_stream(path, chunks())
    return size, rows


def conjunct_leaves_ex(pred, allowed: set) -> tuple[Optional[list], bool]:
    """conjunct_leaves plus a `complete` flag: True iff EVERY leaf of
    the predicate was collected (And-of-leaves shape, all columns in
    `allowed`) — i.e. the pushed conjunction IS the whole predicate.
    One walker decides both so the leaf-type list cannot drift."""
    from horaedb_tpu_torch.ops import filter as F

    leaves: list = []
    complete = True

    def walk(p) -> bool:
        nonlocal complete
        if isinstance(p, F.And):
            return all(walk(c) for c in p.children)
        if isinstance(p, (F.Eq, F.Lt, F.Le, F.Gt, F.Ge, F.In,
                          F.TimeRangePred)):
            if p.column not in allowed:
                # the arrow pushdown DROPS non-allowed leaves (they are
                # applied post-merge); mirror that by skipping the leaf
                complete = False
                return True
            leaves.append(p)
            return True
        if isinstance(p, (F.Or, F.Not, F.Ne)):
            return False
        return False

    if pred is None:
        return None, False
    if not walk(pred) or not leaves:
        # no constraint survives: unfiltered reads stay on pq.read_table
        # (multithreaded column decode), pruning would add nothing
        return None, False
    return leaves, complete


async def read_sst(store: ObjectStore, path: str,
                   columns: Optional[list[str]] = None,
                   filters=None, runtimes=None) -> pa.Table:
    """Read an SST, optionally a column subset and a pushed-down
    predicate (a pyarrow expression over PK columns: row-group pruning
    via parquet statistics plus row filtering — the reference's
    ParquetExec pruning predicate, read.rs:442-465).  Decode runs on a
    worker pool."""
    local_path = getattr(store, "local_path", None)
    if local_path is not None:
        try:
            return await _run(runtimes, "sst", pq.read_table,
                              local_path(path), columns=columns,
                              memory_map=True, filters=filters)
        except FileNotFoundError as e:
            raise NotFoundError(f"object not found: {path}") from e
    data = await store.get(path)
    return await _run(runtimes, "sst", pq.read_table, pa.BufferReader(data),
                      columns=columns, filters=filters)
