"""Parquet SST encode/decode on top of the ObjectStore.

Maps WriteConfig onto pyarrow writer properties the way the reference maps
its config onto parquet-rs WriterProperties (ref: src/storage/src/
storage.rs:257-297 build_write_props): row-group size, write batch size,
global + per-column dictionary/compression/encoding, and sorting-columns
metadata recording the (pk..., seq) sort order.  The files are the JAX
package's files byte for byte, so either package reads the other's SSTs.

Reads with a conjunction of PK leaves prune row groups against parquet
statistics and decode only the groups that can match (read_pruned);
other predicate shapes go through pyarrow's dataset filter.  Large
objects on remote stores stream into a file-backed mmap
(_fetch_mapped), and streamed segments read one SST several times from
one SstSource.
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


def merge_value_counts(pairs: list) -> tuple:
    """Fold (values, counts) pairs into one sorted pair.  Dtype-
    preserving: the first non-empty pair fixes the value dtype (uint64
    tsids must never pass through a float64 concat)."""
    import numpy as np

    values = counts = None
    for v, c in pairs:
        if not len(v):
            continue
        if values is None:
            values, counts = v, np.asarray(c, dtype=np.int64)
            continue
        allv = np.concatenate([values, v])
        allc = np.concatenate([counts, c])
        values, inv = np.unique(allv, return_inverse=True)
        counts = np.bincount(inv, weights=allc).astype(np.int64)
    if values is None:
        return np.asarray([]), np.asarray([], dtype=np.int64)
    return values, counts


# ---------------------------------------------------------------------------
# Stats-pruned structured reads.
#
# pq.read_table(filters=...) routes through the dataset scanner, whose
# per-call overhead and row-level expression evaluation cost a multiple
# of a plain decode on the segment-read shapes the engine issues.  The
# scan predicate is a small
# conjunctive tree over PK columns, so we prune row groups against
# parquet statistics ourselves (the reference's pruning predicate,
# read.rs:442-465), decode with ParquetFile.read_row_groups, and apply
# residual filters as numpy masks only on boundary groups.  Columns
# pinned by an Eq leaf whose stats prove min==max==value everywhere are
# not decoded at all — they are reconstructed as constants.
# ---------------------------------------------------------------------------


def conjunct_leaves(pred, allowed: set) -> Optional[list]:
    """Flatten an And-tree of stats-checkable leaves over `allowed`
    columns.  Returns None when the tree contains Or/Not/unsupported
    leaves or columns outside `allowed` — callers then fall back to the
    expression path (exactly the rows the pushdown would keep must be
    kept, so anything not provably equivalent opts out)."""
    return conjunct_leaves_ex(pred, allowed)[0]


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


def _leaf_vs_stats(leaf, stats) -> str:
    """Classify one row group against one leaf: 'empty' (no row can
    match), 'full' (every row matches), or 'partial'."""
    from horaedb_tpu_torch.ops import filter as F

    if stats is None or not stats.has_min_max:
        return "partial"
    lo, hi = stats.min, stats.max
    if isinstance(lo, float):
        # parquet min/max statistics IGNORE NaN (a [1.0, NaN] group
        # reports min=max=1.0, null_count=0), and NaN fails every
        # comparison — so a float group can never be proven 'full'.
        # 'empty' survives: NaN rows can't match either, so a group
        # with no possible non-NaN match stays empty.
        verdict = _leaf_vs_minmax(leaf, lo, hi, F)
        return "partial" if verdict == "full" else verdict
    return _leaf_vs_minmax(leaf, lo, hi, F)


def _leaf_vs_minmax(leaf, lo, hi, F) -> str:
    try:
        if isinstance(leaf, F.Eq):
            if leaf.value < lo or leaf.value > hi:
                return "empty"
            return "full" if lo == hi == leaf.value else "partial"
        if isinstance(leaf, F.TimeRangePred):
            if hi < leaf.start or lo >= leaf.end:
                return "empty"
            return ("full" if lo >= leaf.start and hi < leaf.end
                    else "partial")
        if isinstance(leaf, F.Lt):
            if lo >= leaf.value:
                return "empty"
            return "full" if hi < leaf.value else "partial"
        if isinstance(leaf, F.Le):
            if lo > leaf.value:
                return "empty"
            return "full" if hi <= leaf.value else "partial"
        if isinstance(leaf, F.Gt):
            if hi <= leaf.value:
                return "empty"
            return "full" if lo > leaf.value else "partial"
        if isinstance(leaf, F.Ge):
            if hi < leaf.value:
                return "empty"
            return "full" if lo >= leaf.value else "partial"
        if isinstance(leaf, F.In):
            vals = [v for v in leaf.values if lo <= v <= hi]
            if not vals:
                return "empty"
            if lo == hi and lo in leaf.values:
                return "full"
            return "partial"
    except TypeError:
        # stats/value type mismatch (e.g. bytes vs int): never prune
        return "partial"
    return "partial"


def _residual_mask(leaves: list, tbl: pa.Table):
    """numpy row mask for the leaves not proven full on this run."""
    import numpy as np

    from horaedb_tpu_torch.ops.filter import leaf_mask_host

    mask = np.ones(tbl.num_rows, dtype=bool)
    for leaf in leaves:
        col = tbl.column(leaf.column).to_numpy(zero_copy_only=False)
        mask &= leaf_mask_host(leaf, col)
    return mask


def _stats_constant(md, col_i: int, groups: list):
    """The single value column `col_i` provably holds across `groups`
    (min==max everywhere, no nulls), or None."""
    value = None
    for g in groups:
        st = md.row_group(g).column(col_i).statistics
        if (st is None or not st.has_min_max
                or not getattr(st, "has_null_count", False)
                or st.null_count or st.min != st.max):
            return None
        if value is None:
            value = st.min
        elif value != st.min:
            return None
    return value


def read_pruned(pf: pq.ParquetFile, columns: Optional[list[str]],
                leaves: list) -> pa.Table:
    """Decode `columns` of the row groups that can match the conjunction
    `leaves`, filtering boundary groups row-level.  Row-level equivalent
    to pq.read_table(filters=<AND of leaves>) on non-null data."""
    import numpy as np

    from horaedb_tpu_torch.ops import filter as F

    md = pf.metadata
    names = [md.schema.column(i).name for i in range(md.num_columns)]
    col_idx = {n: i for i, n in enumerate(names)}
    out_cols = list(columns) if columns is not None else names

    # per-group classification
    selected: list[tuple[int, tuple]] = []  # (group, residual leaves)
    full_eq: dict[str, object] = {}  # col -> pinned value, candidate
    for leaf in leaves:
        if isinstance(leaf, F.Eq) and leaf.column in col_idx:
            full_eq.setdefault(leaf.column, leaf.value)
    for g in range(md.num_row_groups):
        rg = md.row_group(g)
        residual = []
        empty = False
        for leaf in leaves:
            i = col_idx.get(leaf.column)
            if i is None:
                residual.append(leaf)  # missing column: be conservative
                continue
            st = rg.column(i).statistics
            verdict = _leaf_vs_stats(leaf, st)
            # any nulls in the group break both 'full' proofs and numpy
            # residual compares — never trust stats without a null count.
            # ('empty' survives: null rows fail every comparison under
            # SQL semantics, so a group with no possible match stays
            # empty regardless of nulls.)
            if verdict != "empty" and (
                    st is None or not getattr(st, "has_null_count", False)
                    or st.null_count):
                raise _PruneUnsupported()
            if verdict == "empty":
                empty = True
                break
            if verdict == "partial":
                residual.append(leaf)
        if empty:
            continue
        # a pinned-Eq candidate must be proven 'full' in EVERY selected
        # group — a group where it is merely residual disqualifies it
        for col in list(full_eq):
            lf = next(l for l in leaves
                      if isinstance(l, F.Eq) and l.column == col)
            if lf in residual or col not in col_idx:
                full_eq.pop(col, None)
        selected.append((g, tuple(residual)))

    schema = pf.schema_arrow
    if not selected:
        arrays = [pa.array([], type=schema.field(n).type) for n in out_cols]
        return pa.Table.from_arrays(arrays, names=out_cols)

    # columns provably constant across every selected group are not
    # decoded; rebuild them as constants afterwards (plain types only —
    # the reconstruction goes through np.full)
    def _elidable(c: str) -> bool:
        # floats are NOT elidable: parquet stats ignore NaN, so
        # min==max with null_count=0 does not prove a float column
        # constant ([1.0, NaN, 1.0] reports min=max=1.0) and np.full
        # reconstruction would silently drop the NaNs
        t = schema.field(c).type
        return pa.types.is_integer(t) or pa.types.is_string(t)

    elide = {c: v for c, v in full_eq.items()
             if c in out_cols and _elidable(c)}
    # beyond predicate-pinned columns, ANY projected column whose stats
    # prove one constant value across every selected group skips decode
    # (__seq__ is constant in every un-compacted SST; a single-metric
    # table's ids too even without a predicate)
    residual_cols = {l.column for _, res in selected for l in res}
    for c in out_cols:
        if c in elide or not _elidable(c) or c in residual_cols \
                or c not in col_idx:
            continue
        const = _stats_constant(md, col_idx[c], [g for g, _ in selected])
        if const is not None:
            elide[c] = const
    decode_cols = [c for c in out_cols if c not in elide]
    # residual evaluation may need a column the projection dropped
    extra = sorted({l.column for _, res in selected for l in res}
                   - set(decode_cols))
    read_cols = decode_cols + extra

    if not decode_cols and not any(res for _, res in selected):
        # every projected column is an elided constant and no residual
        # filter remains: nothing needs decoding — build the constants
        # at the selected groups' total row count directly
        # (pa.concat_tables over zero-column tables would drop the count)
        n = sum(md.row_group(g).num_rows for g, _ in selected)
        arrays = []
        for c in out_cols:
            t = schema.field(c).type
            arrays.append(pa.array(
                np.full(n, elide[c], dtype=t.to_pandas_dtype()), type=t))
        return pa.Table.from_arrays(arrays, names=out_cols)

    # consecutive groups with the same residual decode as one run
    runs: list[tuple[list[int], tuple]] = []
    for g, residual in selected:
        if runs and runs[-1][1] == residual and runs[-1][0][-1] == g - 1:
            runs[-1][0].append(g)
        else:
            runs.append(([g], residual))
    parts = []
    for groups, residual in runs:
        tbl = pf.read_row_groups(groups, columns=read_cols,
                                 use_threads=False)
        if residual:
            mask = _residual_mask(list(residual), tbl)
            if not mask.all():
                tbl = tbl.filter(pa.array(mask))
        # with an empty projection the residual columns must stay in the
        # part — a zero-column table loses its row count in concat
        parts.append(tbl.select(decode_cols)
                     if extra and decode_cols else tbl)
    out = pa.concat_tables(parts)
    for c in elide:
        t = schema.field(c).type
        arr = pa.array(np.full(out.num_rows, elide[c],
                               dtype=t.to_pandas_dtype()), type=t)
        out = out.append_column(pa.field(c, t), arr)
    return out.select(out_cols)


class _PruneUnsupported(Exception):
    """Internal: this file/predicate cannot be pruned safely; callers
    fall back to the expression path."""


class SstSource:
    """One SST opened for several reads (the streamed segment read does
    one pass-1 column scan plus one pass-2 filtered read PER WINDOW).
    Local stores serve every read from the mmap'd file; other stores
    fetch the object bytes ONCE and serve all reads from that buffer —
    never one download per window.  Methods are synchronous; call them
    via asyncio.to_thread from async code."""

    def __init__(self, path: Optional[str] = None,
                 data: Optional[bytes] = None):
        self._path = path
        self._data = data

    def _source(self):
        # a fresh reader per call: BufferReader is stateful and parquet
        # readers seek it
        return self._path if self._path is not None \
            else pa.BufferReader(self._data)

    def read(self, columns: Optional[list[str]] = None,
             filters=None) -> pa.Table:
        try:
            return pq.read_table(self._source(), columns=columns,
                                 memory_map=self._path is not None,
                                 filters=filters)
        except FileNotFoundError as e:
            # local-path sources re-open per call; a compaction may have
            # deleted the file — surface the store contract's error so
            # callers can re-resolve/retry
            raise NotFoundError(f"object not found: {self._path}") from e

    def value_counts(self, column: str) -> tuple:
        """(values, counts) of one column, streamed row-group-wise so
        host memory is bounded by row-group size + distinct values."""
        import numpy as np

        try:
            pf = pq.ParquetFile(self._source(),
                                memory_map=self._path is not None)
        except FileNotFoundError as e:
            raise NotFoundError(f"object not found: {self._path}") from e
        acc = (np.asarray([]), np.asarray([], dtype=np.int64))
        try:
            for batch in pf.iter_batches(columns=[column]):
                col = batch.column(0).to_numpy(zero_copy_only=False)
                v, c = np.unique(col, return_counts=True)
                acc = merge_value_counts([acc, (v, c)])
        finally:
            pf.close()
        return acc


async def open_sst_source(store: ObjectStore, path: str) -> SstSource:
    local_path = getattr(store, "local_path", None)
    if local_path is not None:
        return SstSource(path=local_path(path))
    return SstSource(data=await store.get(path))


def _read_pruned_source(source, columns, leaves, memory_map) -> pa.Table:
    pf = pq.ParquetFile(source, memory_map=memory_map)
    try:
        return read_pruned(pf, columns, leaves)
    finally:
        pf.close()


# whole-SST fetches at/above this size stream (ObjectStore.get_stream)
# into an anonymous temp file and decode from a file-backed mmap —
# peak anonymous RSS is one stream chunk, and the kernel page cache
# owns (and can evict) the object bytes.  Below it, one get() into a
# bytes buffer stays cheaper (no filesystem round trip).
STREAM_FETCH_MIN_BYTES = 64 << 20

# memory plane: live streamed-SST mappings.  Page-cache-backed, but
# they count against RSS while hot and must be attributable (a
# dead-agent fallback streaming large SSTs shows up here, not as a
# leak).  Charged at map time, credited by a weakref finalizer when the
# last buffer reference drops (the mapping's lifetime is the buffer's)
from horaedb_tpu_torch.common.memledger import ledger as _memledger  # noqa: E402

_STREAM_MMAP_ACCOUNT = _memledger.flow(
    "streamed_mmap", kind="streamed_mmap", owner="storage/parquet_io")


async def _fetch_mapped(store: ObjectStore, path: str, runtimes,
                        pool: str) -> pa.Buffer:
    """Stream an object into an unlinked temp file and return a
    pa.Buffer over its read-only mmap — drop-in for the bytes that
    store.get would have returned, without the resident copy."""
    import mmap
    import tempfile
    import weakref

    f = tempfile.TemporaryFile(prefix="sst-stream-")
    try:
        stream = store.get_stream(path)
        try:
            async for chunk in stream:
                # writes on the decode pool: the event loop never
                # blocks on disk
                await _run(runtimes, pool, f.write, chunk)
        finally:
            await stream.aclose()
        f.flush()
        size = f.tell()
        if size == 0:
            return pa.py_buffer(b"")
        # the mapping (and the unlinked file behind it) lives exactly
        # as long as the returned buffer
        mapped = mmap.mmap(f.fileno(), size, access=mmap.ACCESS_READ)
        _STREAM_MMAP_ACCOUNT.charge(size)
        weakref.finalize(mapped, _STREAM_MMAP_ACCOUNT.credit, size)
        return pa.py_buffer(mapped)
    finally:
        f.close()


async def read_sst(store: ObjectStore, path: str,
                   columns: Optional[list[str]] = None,
                   filters=None, runtimes=None,
                   pool: str = "sst", leaves: Optional[list] = None,
                   size_hint: Optional[int] = None) -> pa.Table:
    """Read an SST, optionally a column subset and a pushed-down
    predicate (row-group pruning via parquet statistics + row filtering
    — the reference's ParquetExec pruning predicate, read.rs:442-465).

    `leaves` (a conjunct_leaves result) selects the fast stats-pruned
    decode; `filters` (a pyarrow expression) is the fallback for
    predicate shapes the pruner refuses.  Both keep exactly the same
    rows.  Local stores expose a filesystem path for mmap'd reads; other
    stores go through a bytes buffer — except objects whose `size_hint`
    (the manifest's SST size) reaches STREAM_FETCH_MIN_BYTES, which
    stream chunk-wise into a file-backed mmap instead of buffering the
    whole object in RSS.  Decode always runs on a worker pool.
    """
    local_path = getattr(store, "local_path", None)
    if local_path is not None:
        try:
            if leaves is not None:
                try:
                    return await _run(runtimes, pool, _read_pruned_source,
                                      local_path(path), columns, leaves,
                                      True)
                except _PruneUnsupported:
                    pass  # nulls in a predicate column: expression path
            return await _run(runtimes, pool, pq.read_table,
                              local_path(path), columns=columns,
                              memory_map=True, filters=filters)
        except FileNotFoundError as e:
            # a compaction deleted the SST between plan and read: map to
            # the store contract's error so scan retries replan (the
            # non-local branch gets this from store.get)
            raise NotFoundError(f"object not found: {path}") from e
    if size_hint is not None and size_hint >= STREAM_FETCH_MIN_BYTES:
        data = await _fetch_mapped(store, path, runtimes, pool)
    else:
        data = await store.get(path)  # fetched ONCE, shared by both paths
    if leaves is not None:
        try:
            return await _run(runtimes, pool, _read_pruned_source,
                              pa.BufferReader(data), columns, leaves, False)
        except _PruneUnsupported:
            pass
    return await _run(runtimes, pool, pq.read_table, pa.BufferReader(data),
                      columns=columns, filters=filters)
