"""Device-layout sidecars: the SST's columns persisted in the exact
fixed-width encoding the device scan consumes.

The cold scan path is structurally bound by Arrow/parquet decode plus
per-scan re-encode (dictionary np.unique, int64->int32 offset shifts,
f64->f32 casts) — the same bottleneck the reference acknowledges on its
CPU path (ref: src/storage/src/read.rs:477-478 "TODO: fetch using
multiple threads").  Instead of adding decode threads, each SST
write/compaction also persists a sidecar object (`{id}.enc` next to
`{id}.sst`) holding the post-encode layout of ops/encode.py: dict codes
with their sorted dictionaries, epoch-relative int32 offsets, float32
values.  A cold scan then reconstructs device batches with
np.frombuffer — no decompression, no np.unique, no casts.

The sidecar is strictly a CACHE:
- parquet stays the durable/compatibility format; the manifest never
  references sidecars;
- the loader validates magic + version and falls back to the parquet
  path on ANY mismatch or absence — correctness never depends on it;
- SST objects are immutable and ids never reused, so a sidecar can
  never be stale; deletes ride along with SST deletes, best-effort.

Binary layout (version 1, little-endian):

    [8s magic "HDTPENC1"] [u32 header_len] [header JSON]
    [pad to 16] [section 0] [pad to 16] [section 1] ...

The header lists per-column metadata with section offsets relative to
the (aligned) data start.  String dictionaries are stored as an int32
offsets section plus a UTF-8 blob section; numeric dictionaries as raw
int64.
"""

from __future__ import annotations

import asyncio
import json
import struct
from dataclasses import dataclass
from typing import Optional

import numpy as np
import pyarrow as pa

from horaedb_tpu_torch.common.error import Error
from horaedb_tpu_torch.objstore import NotFoundError
from horaedb_tpu_torch.ops import encode
from horaedb_tpu_torch.storage.types import RESERVED_COLUMN_NAME

_MAGIC = b"HDTPENC1"
_VERSION = 1
_ALIGN = 16

# per-column block statistics granularity: each int32 column records
# min/max per block of this many rows, enabling the loader to fetch
# only candidate byte ranges for selective (point-query) leaf sets —
# the sidecar's analogue of parquet row-group pruning
BLOCK_ROWS = 65536

SIDECAR_SUFFIX = ".enc"

# arrow types the sidecar can carry (str(pa_type) -> type); anything
# else makes the whole file non-encodable (the writer skips it)
_ARROW_TYPES = {
    str(t): t for t in (
        pa.int8(), pa.int16(), pa.int32(), pa.int64(),
        pa.uint8(), pa.uint16(), pa.uint32(), pa.uint64(),
        pa.float32(), pa.float64(),
        pa.string(), pa.large_string(), pa.binary(),
    )
}

_NP_DTYPES = {"int32": np.int32, "float32": np.float32}


def sidecar_path(prefix: str, file_id: int) -> str:
    return f"{prefix}/data/{file_id}{SIDECAR_SUFFIX}"


# ---------------------------------------------------------------------------
# encode / serialize
# ---------------------------------------------------------------------------


def encode_columns(batch: pa.RecordBatch) -> Optional[dict]:
    """Encode every storable column of a PK-sorted stamped batch into
    the device layout: {name: (unpadded np array, ColumnEncoding)}.
    Returns None when any column can't be represented (unknown type,
    nulls) — except __reserved__, which is all-null by design and never
    read (build_plan drops it), so it is simply omitted."""
    out: dict = {}
    for name, col in zip(batch.schema.names, batch.columns):
        if name == RESERVED_COLUMN_NAME:
            continue
        if str(col.type) not in _ARROW_TYPES or col.null_count:
            return None
        try:
            arr, enc = encode.encode_column(col, name)
        except Exception:
            return None
        out[name] = (arr, enc)
    return out or None


# largest storable blob-dictionary payload: offsets are int32 on disk,
# so a dictionary whose concatenated bytes reach 2^31 cannot be
# represented — the writer must refuse (silent int32 cumsum wraparound
# would serve WRONG VALUES on read)
_DICT_BLOB_MAX = 2**31


def _dict_sections(dictionary: np.ndarray) -> Optional[tuple[dict, list]]:
    """(meta, sections) for one dictionary: numeric dicts as one raw
    int64 section, string/bytes dicts as int32 offsets + blob."""
    if dictionary.dtype == np.int64:
        return {"dict_kind": "i64", "dict_len": len(dictionary)}, \
            [dictionary.tobytes()]
    if dictionary.dtype == object:
        blobs = []
        for v in dictionary:
            if isinstance(v, bytes):
                blobs.append(v)
            elif isinstance(v, str):
                blobs.append(v.encode("utf-8"))
            else:
                return None
        lens = [len(b) for b in blobs]
        if sum(lens) >= _DICT_BLOB_MAX:
            # int32 offsets would wrap: not storable (caller falls back
            # to parquet-only for this SST)
            return None
        offsets = np.zeros(len(blobs) + 1, dtype=np.int64)
        np.cumsum(lens, out=offsets[1:])
        offsets = offsets.astype(np.int32)
        return ({"dict_kind": "blob", "dict_len": len(dictionary)},
                [offsets.tobytes(), b"".join(blobs)])
    return None


def serialize(columns: dict, n_rows: int) -> Optional[bytes]:
    """Pack encoded columns into one sidecar blob, or None when a
    dictionary isn't storable."""
    sections: list[bytes] = []
    col_meta = []
    for name, (arr, enc) in columns.items():
        if len(arr) != n_rows or str(arr.dtype) not in _NP_DTYPES:
            return None
        meta = {"name": name, "kind": enc.kind, "dtype": str(arr.dtype),
                "arrow": str(enc.arrow_type), "epoch": int(enc.epoch),
                "section": len(sections)}
        sections.append(np.ascontiguousarray(arr).tobytes())
        if arr.dtype == np.int32 and n_rows:
            # per-block min/max over the ENCODED values (codes/offsets
            # are order-preserving, so leaf constants translate into
            # this space); one i32 section [mins..., maxes...].
            # reduceat handles the ragged tail block exactly, with no
            # padded copy of the column
            starts = np.arange(0, n_rows, BLOCK_ROWS)
            stats = np.concatenate([
                np.minimum.reduceat(arr, starts),
                np.maximum.reduceat(arr, starts)])
            meta["bstats_section"] = len(sections)
            sections.append(stats.astype(np.int32).tobytes())
        if enc.kind == "dict":
            ds = _dict_sections(enc.dictionary)
            if ds is None:
                return None
            dmeta, dsec = ds
            meta.update(dmeta)
            meta["dict_section"] = len(sections)
            sections.extend(dsec)
        col_meta.append(meta)

    offsets = []
    pos = 0
    for s in sections:
        pos = -(-pos // _ALIGN) * _ALIGN
        offsets.append(pos)
        pos += len(s)
    header = json.dumps({
        "version": _VERSION, "n_rows": n_rows,
        "sections": offsets, "columns": col_meta,
    }).encode("utf-8")

    parts = [_MAGIC, struct.pack("<I", len(header)), header]
    head_len = sum(len(p) for p in parts)
    parts.append(b"\0" * (-(-head_len // _ALIGN) * _ALIGN - head_len))
    pos = 0
    for off, s in zip(offsets, sections):
        parts.append(b"\0" * (off - pos))
        parts.append(s)
        pos = off + len(s)
    return b"".join(parts)


def build(batch: pa.RecordBatch) -> Optional[bytes]:
    """One-call write-side helper: encode + serialize, None when the
    batch isn't representable."""
    cols = encode_columns(batch)
    if cols is None:
        return None
    return serialize(cols, batch.num_rows)


# ---------------------------------------------------------------------------
# deserialize
# ---------------------------------------------------------------------------


def _parse_header(buf) -> Optional[tuple[dict, int]]:
    """(header, data_start) or None.  `buf` must contain at least the
    whole header (magic + length + JSON)."""
    try:
        if len(buf) < 12 or buf[:8] != _MAGIC:
            return None
        (header_len,) = struct.unpack_from("<I", buf, 8)
        if len(buf) < 12 + header_len:
            return None
        header = json.loads(bytes(buf[12:12 + header_len]).decode("utf-8"))
        if header.get("version") != _VERSION:
            return None
        data_start = -(-(12 + header_len) // _ALIGN) * _ALIGN
        return header, data_start
    except (KeyError, ValueError, struct.error, UnicodeDecodeError):
        return None


def header_span(buf_head: bytes) -> Optional[int]:
    """Total header bytes (magic + length + JSON) from the blob's first
    bytes, or None when they aren't a sidecar prefix."""
    if len(buf_head) < 12 or buf_head[:8] != _MAGIC:
        return None
    (header_len,) = struct.unpack_from("<I", buf_head, 8)
    return 12 + header_len


def deserialize(buf: bytes,
                want: Optional[set] = None) -> Optional[tuple[dict, int]]:
    """Parse a sidecar blob into ({name: (np view, ColumnEncoding)},
    n_rows).  Arrays are zero-copy views into `buf`.  `want` restricts
    which columns materialize (None = all); a wanted column missing from
    the file returns None (caller falls back to parquet)."""
    try:
        parsed = _parse_header(buf)
        if parsed is None:
            return None
        header, data_start = parsed
        n_rows = int(header["n_rows"])
        offsets = header["sections"]
        by_name = {m["name"]: m for m in header["columns"]}
        names = list(by_name) if want is None else [n for n in want]
        cols: dict = {}
        for name in names:
            m = by_name.get(name)
            if m is None:
                return None
            arrow_t = _ARROW_TYPES.get(m["arrow"])
            dtype = _NP_DTYPES.get(m["dtype"])
            if arrow_t is None or dtype is None:
                return None
            arr = np.frombuffer(buf, dtype=dtype, count=n_rows,
                                offset=data_start + offsets[m["section"]])
            if m["kind"] == "dict":
                dictionary = _load_dict(buf, m, data_start, offsets)
                if dictionary is None:
                    return None
                enc = encode.ColumnEncoding("dict", arrow_t,
                                            dictionary=dictionary)
            elif m["kind"] == "offset":
                enc = encode.ColumnEncoding("offset", arrow_t,
                                            epoch=int(m["epoch"]))
            else:
                enc = encode.ColumnEncoding("numeric", arrow_t)
            cols[name] = (arr, enc)
        return cols, n_rows
    except (KeyError, ValueError, IndexError, struct.error,
            json.JSONDecodeError, UnicodeDecodeError):
        return None


def _load_dict(buf: bytes, m: dict, data_start: int,
               offsets: list) -> Optional[np.ndarray]:
    sec = m.get("dict_section")
    dlen = int(m.get("dict_len", -1))
    if sec is None or dlen < 0:
        return None
    if m.get("dict_kind") == "i64":
        return np.frombuffer(buf, dtype=np.int64, count=dlen,
                             offset=data_start + offsets[sec])
    if m.get("dict_kind") == "blob":
        offs = np.frombuffer(buf, dtype=np.int32, count=dlen + 1,
                             offset=data_start + offsets[sec])
        base = data_start + offsets[sec + 1]
        # a wrapped/corrupt offsets section must read as INVALID, not
        # slice garbage: offsets are non-decreasing from 0 and the blob
        # must actually contain the last offset (truncated objects)
        if not _blob_offsets_ok(offs, len(buf) - base):
            return None
        # zero-copy view of the blob section; decode is one C++ pass
        return _decode_blob_dict(offs, memoryview(buf)[base:],
                                 m["arrow"] == "binary")
    return None


def _blob_offsets_ok(offs: np.ndarray, blob_len: int) -> bool:
    """Validate a blob dictionary's offsets section: starts at 0,
    non-decreasing (an int32 cumsum wraparound in a pre-fix writer shows
    up as a decrease or a negative), and the final offset fits the
    available blob bytes."""
    if len(offs) == 0 or int(offs[0]) != 0:
        return False
    if bool(np.any(offs[1:] < offs[:-1])):
        return False
    return int(offs[-1]) <= blob_len


# ---------------------------------------------------------------------------
# cross-SST concat (one segment = several sorted SST runs)
# ---------------------------------------------------------------------------


def _materialize_i64(arr: np.ndarray, enc: encode.ColumnEncoding
                     ) -> np.ndarray:
    if enc.kind == "offset":
        return arr.astype(np.int64) + enc.epoch
    if enc.kind == "dict":
        return enc.dictionary[arr]
    return arr.astype(np.int64)


# max dictionary size after a cross-SST union remap, matching
# encode._dictionary_encode: the merge kernel reserves INT32_MAX as its
# padding sentinel, so the largest code must stay strictly below it —
# a sentinel-sized union would alias real codes with padding
_MAX_DICT_CODES = 2**31 - 1


def concat_encoded(parts: list[dict], names: list[str]
                   ) -> Optional[tuple[dict, dict, int]]:
    """Concatenate per-SST encoded columns (in SST/run order — the merge
    relies on runs arriving in sequence order) into one column set:
    (columns, encodings, n_rows).

    dict columns re-map onto the sorted union dictionary (codes stay
    order-preserving); offset columns re-base to the smallest epoch when
    the combined span still fits int32; mixed/overflowing int64 columns
    fall back to materializing values and re-encoding.  Returns None
    only for irreconcilable arrow types."""
    if len(parts) == 1:
        cols = {n: parts[0][n][0] for n in names}
        encs = {n: parts[0][n][1] for n in names}
        return cols, encs, len(next(iter(cols.values()))) if names else 0

    out_cols: dict = {}
    out_encs: dict = {}
    n_total = 0
    for name in names:
        arrs = [p[name][0] for p in parts]
        encs = [p[name][1] for p in parts]
        atypes = {str(e.arrow_type) for e in encs}
        if len(atypes) != 1:
            return None
        arrow_t = encs[0].arrow_type
        kinds = {e.kind for e in encs}
        if kinds == {"numeric"}:
            out = np.concatenate(arrs)
            enc = encode.ColumnEncoding("numeric", arrow_t)
        elif kinds == {"offset"}:
            epochs = [e.epoch for e in encs]
            lo = min(epochs)
            hi = max(e.epoch + (int(a.max()) if len(a) else 0)
                     for a, e in zip(arrs, encs))
            if hi - lo < 2**31 - 1:
                out = np.concatenate([
                    a + np.int32(e.epoch - lo)
                    for a, e in zip(arrs, encs)])
                enc = encode.ColumnEncoding("offset", arrow_t, epoch=lo)
            else:
                out, enc = _concat_as_dict(arrs, encs, arrow_t)
                if enc is None:
                    return None
        elif kinds <= {"dict", "offset"} and all(
                e.kind == "offset" or e.dictionary.dtype == np.int64
                for e in encs):
            if kinds == {"dict"}:
                union = np.unique(np.concatenate(
                    [e.dictionary for e in encs]))
                if len(union) >= _MAX_DICT_CODES:
                    return None  # codes would alias the pad sentinel
                out = np.concatenate([
                    np.searchsorted(union, e.dictionary).astype(
                        np.int32)[a]
                    for a, e in zip(arrs, encs)])
                enc = encode.ColumnEncoding("dict", arrow_t,
                                            dictionary=union)
            else:
                out, enc = _concat_as_dict(arrs, encs, arrow_t)
                if enc is None:
                    return None
        elif kinds == {"dict"}:
            # string/bytes dictionaries: object-dtype union keeps codes
            # order-preserving (np.unique sorts); re-check the union
            # bound after remap — per-part dictionaries each fit, their
            # union may not
            union = np.unique(np.concatenate([e.dictionary for e in encs]))
            if len(union) >= _MAX_DICT_CODES:
                return None  # codes would alias the pad sentinel
            out = np.concatenate([
                np.searchsorted(union, e.dictionary).astype(np.int32)[a]
                for a, e in zip(arrs, encs)])
            enc = encode.ColumnEncoding("dict", arrow_t, dictionary=union)
        else:
            return None
        out_cols[name] = out
        out_encs[name] = enc
        n_total = len(out)
    return out_cols, out_encs, n_total


def _concat_as_dict(arrs: list, encs: list, arrow_t) -> tuple:
    """Fallback: materialize int64 values and dictionary-encode the
    concatenation (sorted-run fast path inside _dictionary_encode).
    (None, None) when the combined dictionary would reach the merge
    kernel's pad sentinel — caller returns None → parquet fallback."""
    values = np.concatenate([
        _materialize_i64(a, e) for a, e in zip(arrs, encs)])
    try:
        codes, dictionary = encode._dictionary_encode(values)
    except Error:
        return None, None  # dictionary overflow: not representable
    if len(dictionary) >= _MAX_DICT_CODES:
        return None, None
    return codes, encode.ColumnEncoding("dict", arrow_t,
                                        dictionary=dictionary)


def merge_parts(parts: list[dict]) -> Optional[tuple[dict, int]]:
    """Concat per-batch encoded parts into ONE part ({name: (arr,
    enc)}, n_rows), or None when the parts aren't mergeable.  Streamed
    writers (compaction) serialize the result into one sidecar."""
    if not parts:
        return None
    names = list(parts[0].keys())
    if any(list(p.keys()) != names for p in parts[1:]):
        return None
    cc = concat_encoded(parts, names)
    if cc is None:
        return None
    cols, encs, n = cc
    return {nm: (cols[nm], encs[nm]) for nm in names}, n


# ---------------------------------------------------------------------------
# read-side assembly
# ---------------------------------------------------------------------------


@dataclass
class EncodedSegment:
    """One segment's rows straight from sidecars — the parquet-free twin
    of the Arrow table the parquet read returns.  Columns are unpadded,
    filtered (prune leaves applied) and concatenated in SST/run order,
    ready for the merge's window prep.

    `pending_leaves` is set (a list, possibly empty) when the read
    DEFERRED the exact leaf mask to the device-decode dispatch
    (ops/device_decode.py): its planning selects the surviving rows on
    the host where the leaves drop rows, and the card evaluates
    the conjunction in encoded space over what is uploaded; None means
    the leaves were applied here.  A host fallback for a deferred
    segment calls apply_leaves_host first."""

    columns: dict
    encodings: dict
    n: int
    names: list
    pending_leaves: Optional[list] = None
    # sorted SST runs concatenated (None = unknown).  One run is (pk,
    # seq)-sorted by construction: both write paths sort before the SST
    # put and compaction emits merge-sorted output
    source_runs: Optional[int] = None
    # rows per run in concatenation order (sum == n), so the device
    # decode can k-way merge the presorted runs (ops/merge.py); None =
    # boundaries unknown, and the decode takes the sort route
    run_lengths: Optional[tuple] = None

    @property
    def num_rows(self) -> int:
        return self.n

    @property
    def nbytes(self) -> int:
        return sum(int(a.nbytes) for a in self.columns.values())


def apply_leaves_host(es: EncodedSegment) -> EncodedSegment:
    """Resolve a deferred leaf conjunction on the host — the fallback
    when a segment routed to the device decode turns out ineligible at
    dispatch: the mask and compaction assemble_parts would have done,
    with each run's survivors counted so the run boundaries stay valid.
    No-op for a segment with nothing pending."""
    from horaedb_tpu_torch.ops import filter as filter_ops

    leaves = es.pending_leaves
    if not leaves:
        es.pending_leaves = None
        return es
    if es.n:
        batch = encode.DeviceBatch(columns=es.columns,
                                   encodings=es.encodings,
                                   n_valid=es.n, capacity=es.n)
        mask = np.asarray(filter_ops.eval_predicate(
            filter_ops.And(tuple(leaves)), batch))
        if not mask.all():
            return take_rows(es, np.flatnonzero(mask))
    return EncodedSegment(columns=es.columns, encodings=es.encodings,
                          n=es.n, names=es.names,
                          source_runs=es.source_runs,
                          run_lengths=es.run_lengths)


def take_rows(es: EncodedSegment, idx: np.ndarray,
              names: Optional[list] = None) -> EncodedSegment:
    """The rows of `es` at the ascending indices `idx`, with nothing
    pending: a subsequence of each run, so every run stays sorted, and
    each run's survivors counted so the run boundaries stay valid (a run
    may end empty).  `names` limits the columns gathered (every column
    by default)."""
    cols = {nm: es.columns[nm][idx]
            for nm in (es.columns if names is None else names)}
    run_lengths = es.run_lengths
    if run_lengths is not None:
        bounds = np.searchsorted(idx, np.cumsum((0,) + tuple(run_lengths)))
        run_lengths = tuple(int(k) for k in np.diff(bounds))
    return EncodedSegment(columns=cols, encodings=es.encodings,
                          n=len(idx),
                          names=es.names if names is None else list(names),
                          source_runs=es.source_runs,
                          run_lengths=run_lengths)


def assemble_parts(parts: list, columns: list,
                   leaves: Optional[list]) -> Optional[EncodedSegment]:
    """Apply the pruned-read leaf conjunction per SST part (row-level
    equivalent to the parquet path's read_pruned / filters=pushdown) and
    concatenate the runs in SST order, recording each run's rows.
    `parts` are (cols, n) pairs as returned by
    deserialize()/load_sst_encoded()."""
    from horaedb_tpu_torch.ops import filter as filter_ops

    leaves = leaves or []
    out_parts = []
    run_lengths = []
    for cols, n in parts:
        if leaves and n:
            batch = encode.DeviceBatch(
                columns={nm: a for nm, (a, _) in cols.items()},
                encodings={nm: e for nm, (_, e) in cols.items()},
                n_valid=n, capacity=n)
            mask = np.asarray(filter_ops.eval_predicate(
                filter_ops.And(tuple(leaves)), batch))
            if not mask.all():
                idx = np.flatnonzero(mask)
                cols = {nm: (a[idx], e) for nm, (a, e) in cols.items()}
                n = len(idx)
        out_parts.append({nm: cols[nm] for nm in columns})
        run_lengths.append(int(n))
    cc = concat_encoded(out_parts, list(columns))
    if cc is None:
        return None
    out_cols, out_encs, n_total = cc
    return EncodedSegment(columns=out_cols, encodings=out_encs,
                          n=n_total, names=list(columns),
                          source_runs=len(parts),
                          run_lengths=tuple(run_lengths))


def _decode_blob_dict(offs: np.ndarray, blob: bytes,
                      is_binary: bool) -> np.ndarray:
    """Object dictionary from (offsets, blob) in ONE C++ pass: wrap the
    validated sections as a zero-copy Arrow binary/utf8 array and let
    Arrow materialize the objects — the per-entry Python slice+decode
    loop this replaces was decode CPU per DICTIONARY entry, which at
    high series cardinality dominated sidecar assemble on low-core
    hosts (ROADMAP item 1 residual).  Callers have already validated
    the offsets (_blob_offsets_ok shape: start 0, non-decreasing,
    final offset within the blob)."""
    n = len(offs) - 1
    offs32 = np.ascontiguousarray(offs, dtype=np.int32)
    arr = pa.Array.from_buffers(
        pa.binary() if is_binary else pa.utf8(), n,
        [None, pa.py_buffer(offs32), pa.py_buffer(blob)])
    return arr.to_numpy(zero_copy_only=False)


# ---------------------------------------------------------------------------
# selective fetch (block pruning) — the sidecar's analogue of parquet
# row-group pruning for point queries on remote stores
# ---------------------------------------------------------------------------

# below this object size a whole-object GET beats extra round trips
_PARTIAL_MIN_BYTES = 1 << 20
# the header probe: big enough for any realistic header JSON, small
# enough that the probe's byte copy is noise.  Objects smaller than
# this arrive complete in the probe (short read, one request);
# unprunable larger objects pay probe + ONE plain GET — cheaper than
# a probe-sized head reused via range-read + concat, which copies the
# whole object twice on host-backed stores
_HEAD_BYTES = 64 << 10
# above this surviving-row fraction the partial fetch saves too little
# (range reads cost extra round trips; at half the bytes they still
# win — a point-query run straddling a block boundary keeps 2 blocks,
# which must stay under this at the common 4-8 block SST sizes)
_PARTIAL_MAX_FRAC = 0.5


def _block_mask_for_leaf(leaf, enc, mins: np.ndarray,
                         maxs: np.ndarray) -> Optional[np.ndarray]:
    """Conservative per-block MAY-match mask for one leaf over encoded
    -space block stats; None = this leaf cannot prune.  The inequality
    forms mirror ops.filter.eval_predicate exactly (dict codes have no
    '<=' constant, hence the side-specific thresholds)."""
    from horaedb_tpu_torch.ops import filter as F
    from horaedb_tpu_torch.ops.filter import (
        _const_code_exact,
        _const_code_lower,
        _const_code_upper,
    )

    if isinstance(leaf, F.Eq):
        c = _const_code_exact(enc, leaf.value)
        if c is None:
            return np.zeros(len(mins), dtype=bool)
        return (mins <= c) & (c <= maxs)
    if isinstance(leaf, F.In):
        codes = sorted(c for c in (_const_code_exact(enc, v)
                                   for v in leaf.values) if c is not None)
        if not codes:
            return np.zeros(len(mins), dtype=bool)
        arr = np.asarray(codes)
        idx = np.searchsorted(arr, mins)
        ok = idx < len(arr)
        out = np.zeros(len(mins), dtype=bool)
        out[ok] = arr[np.minimum(idx[ok], len(arr) - 1)] <= maxs[ok]
        return out
    if isinstance(leaf, F.Lt):
        return mins < _const_code_lower(enc, leaf.value)
    if isinstance(leaf, F.Le):
        t = _const_code_upper(enc, leaf.value)
        return mins < t if enc.kind == "dict" else mins <= t
    if isinstance(leaf, F.Gt):
        if enc.kind == "dict":
            return maxs >= _const_code_upper(enc, leaf.value)
        return maxs > _const_code_lower(enc, leaf.value)
    if isinstance(leaf, F.Ge):
        return maxs >= _const_code_lower(enc, leaf.value)
    if isinstance(leaf, F.TimeRangePred):
        lo = _const_code_lower(enc, leaf.start)
        hi = _const_code_lower(enc, leaf.end)
        return (maxs >= lo) & (mins < hi)
    return None


class _Sections:
    """Byte-range reader over one sidecar object with a tiny per-query
    cache, so a dictionary needed by both the pruning loop and the
    column load downloads once."""

    def __init__(self, store, path: str, data_start: int):
        self.store = store
        self.path = path
        self.data_start = data_start
        self._cache: dict = {}
        # decoded ColumnEncoding per column name — a leaf column that is
        # also a wanted column builds its (possibly large) dictionary
        # exactly once per SST load
        self.enc_cache: dict = {}

    async def fetch(self, offset: int, nbytes: int,
                    cache: bool = True) -> bytes:
        key = (offset, nbytes)
        got = self._cache.get(key)
        if got is None:
            lo = self.data_start + offset
            got = await self.store.get_range(self.path, lo, lo + nbytes)
            # data-column chunks pass cache=False: a streamed session
            # reads each window's disjoint ranges exactly once, and
            # pinning them would re-materialize the whole segment —
            # the residency streaming exists to avoid
            if cache and nbytes <= (4 << 20):
                self._cache[key] = got
        return got


async def _dict_for(meta: dict, header: dict, secs: _Sections,
                    runner=None) -> Optional[np.ndarray]:
    offsets = header["sections"]
    dlen = int(meta.get("dict_len", -1))
    sec = meta.get("dict_section")
    if sec is None or dlen < 0:
        return None
    if meta.get("dict_kind") == "i64":
        raw = await secs.fetch(offsets[sec], dlen * 8)
        return np.frombuffer(raw, dtype=np.int64, count=dlen)
    if meta.get("dict_kind") == "blob":
        raw = await secs.fetch(offsets[sec], (dlen + 1) * 4)
        offs = np.frombuffer(raw, dtype=np.int32, count=dlen + 1)
        if len(offs) == 0 or int(offs[0]) != 0 \
                or bool(np.any(offs[1:] < offs[:-1])):
            return None  # wrapped/corrupt offsets: invalid, not garbage
        blob = await secs.fetch(offsets[sec + 1], int(offs[-1]))
        if len(blob) < int(offs[-1]):
            return None  # truncated object
        is_binary = meta["arrow"] == "binary"
        if runner is not None:
            # per-entry Python decode loop: CPU-bound, off the loop
            return await runner(_decode_blob_dict, offs, blob, is_binary)
        return _decode_blob_dict(offs, blob, is_binary)
    return None


async def _encoding_for(meta: dict, header: dict, secs: _Sections,
                        runner=None):
    cached = secs.enc_cache.get(meta["name"])
    if cached is not None:
        return cached
    arrow_t = _ARROW_TYPES.get(meta["arrow"])
    if arrow_t is None:
        return None
    if meta["kind"] == "offset":
        enc = encode.ColumnEncoding("offset", arrow_t,
                                    epoch=int(meta["epoch"]))
    elif meta["kind"] == "numeric":
        enc = encode.ColumnEncoding("numeric", arrow_t)
    else:
        dictionary = await _dict_for(meta, header, secs, runner)
        if dictionary is None:
            return None
        enc = encode.ColumnEncoding("dict", arrow_t,
                                    dictionary=dictionary)
    secs.enc_cache[meta["name"]] = enc
    return enc


async def load_sst_encoded(store, path: str, want: set,
                           leaves: Optional[list], runner=None):
    """Fetch one SST's sidecar columns as ({name: (arr, enc)}, n_rows).

    When the leaf conjunction is selective, per-block stats narrow the
    fetch to candidate ROW ranges via store.get_range — whole columns
    are never downloaded for a point query over a big SST.  Pruning is
    conservative (block granularity); assemble_parts' exact leaf mask
    still applies after.  Falls back to a whole-object read (reusing
    the probed head bytes) when pruning cannot help.  `runner`
    (async callable(fn, *args), e.g. a worker-pool dispatch) carries
    the CPU-bound deserialize so callers keep it off the event loop.
    None = invalid sidecar (caller falls back to parquet);
    NotFoundError propagates."""
    async def _des(buf):
        if runner is None:
            return deserialize(buf, want)
        return await runner(deserialize, buf, want)

    leaves = leaves or []
    if not leaves:
        # nothing to prune with: one whole-object GET, no header probe
        return await _des(await store.get(path))
    head = await store.get_range(path, 0, _HEAD_BYTES)
    if len(head) < _HEAD_BYTES:
        # short read = the WHOLE object is already in hand; larger
        # objects that turn out unprunable pay probe + one plain GET
        # (the deliberate trade documented at _HEAD_BYTES — a plain
        # GET is zero-copy on host-backed stores)
        return await _des(head)
    try:
        span = header_span(head)
        if span is not None and span > len(head):
            head = bytes(head) + bytes(
                await store.get_range(path, len(head), span))
        parsed = _parse_header(head)
        if parsed is None:
            # not a (readable) header: a full read preserves the
            # corrupt-blob fallback semantics
            return await _des(await store.get(path))
        header, data_start = parsed
        n_rows = int(header["n_rows"])
        by_name = {m["name"]: m for m in header["columns"]}
        if any(nm not in by_name for nm in want):
            return None
        offsets = header["sections"]
        approx_bytes = data_start + (max(offsets) if offsets else 0)
        nblocks = -(-n_rows // BLOCK_ROWS) if n_rows else 0
        # leaf columns are always in `want` (callers build it that
        # way), so their presence was vetted by the want check above
        prunable = (leaves and nblocks > 1
                    and approx_bytes >= _PARTIAL_MIN_BYTES)
        if not prunable:
            return await _des(await store.get(path))
        return await _load_pruned(store, path, want, leaves, runner,
                                  header, data_start, n_rows, nblocks,
                                  _des)
    except (KeyError, IndexError, ValueError, TypeError, struct.error):
        # a magic-valid but malformed header (bad indices, truncated
        # sections) must read as INVALID — the caller memoizes the miss
        # permanently, same as an unparseable blob.  Store/IO errors
        # propagate instead: the caller treats those as TRANSIENT (no
        # memo), so one network hiccup can't blacklist a valid sidecar
        return None


async def _gather_or_cancel(*coros):
    """gather() that never strands a sibling: when one awaitable
    raises, the rest are cancelled AND awaited before the error
    propagates — an orphaned store read must not outlive its scan into
    table/engine teardown (the deterministic-teardown discipline the
    scan pipeline enforces at every stage boundary)."""
    tasks = [asyncio.ensure_future(c) for c in coros]
    try:
        return await asyncio.gather(*tasks)
    except BaseException:
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        raise


async def _leaf_block_mask(leaves, by_name, header, secs, nblocks,
                           runner):
    """(mask, pruned_any) over blocks for a leaf conjunction, or None
    when an encoding can't be built (caller falls back).

    Each stats-bearing column's (encoding, block stats) loads ONCE and
    the columns load CONCURRENTLY: a leaf-serial chain would pay ~2
    store round trips per leaf."""
    offsets = header["sections"]
    metas, seen = [], set()
    for leaf in leaves:
        meta = by_name[leaf.column]
        if "bstats_section" not in meta or leaf.column in seen:
            continue
        seen.add(leaf.column)
        metas.append(meta)

    async def load(meta):
        enc, raw = await _gather_or_cancel(
            _encoding_for(meta, header, secs, runner),
            secs.fetch(offsets[meta["bstats_section"]], nblocks * 8))
        return meta["name"], enc, raw

    by_col = {}
    for name, enc, raw in await _gather_or_cancel(
            *(load(m) for m in metas)):
        if enc is None:
            return None
        by_col[name] = (enc, np.frombuffer(raw, dtype=np.int32,
                                           count=2 * nblocks))
    mask = np.ones(nblocks, dtype=bool)
    pruned_any = False
    for leaf in leaves:
        got = by_col.get(leaf.column)
        if got is None:
            continue  # no block stats for this column: can't prune
        enc, stats = got
        lm = _block_mask_for_leaf(leaf, enc, stats[:nblocks],
                                  stats[nblocks:])
        if lm is not None:
            mask &= lm
            pruned_any = True
    return mask, pruned_any


def _mask_to_ranges(mask: np.ndarray, n_rows: int) -> list[tuple[int, int]]:
    """Contiguous surviving-block runs -> row ranges."""
    ranges: list[tuple[int, int]] = []
    b = 0
    nblocks = len(mask)
    while b < nblocks:
        if not mask[b]:
            b += 1
            continue
        b0 = b
        while b < nblocks and mask[b]:
            b += 1
        ranges.append((b0 * BLOCK_ROWS, min(b * BLOCK_ROWS, n_rows)))
    return ranges


async def _load_columns(by_name, header, secs, want, ranges, runner):
    """Fetch each wanted column's bytes for the row ranges; ({name:
    (arr, enc)}, total_rows) or None on an unsupported column."""
    offsets = header["sections"]
    total = sum(hi - lo for lo, hi in ranges)

    async def load_col(name: str):
        meta = by_name[name]
        dtype = _NP_DTYPES.get(meta["dtype"])
        enc = await _encoding_for(meta, header, secs, runner)
        if dtype is None or enc is None:
            return name, None
        base = offsets[meta["section"]]
        isz = np.dtype(dtype).itemsize
        chunks = await asyncio.gather(*(
            secs.fetch(base + isz * lo, isz * (hi - lo), cache=False)
            for lo, hi in ranges))
        arrs = [np.frombuffer(c, dtype=dtype) for c in chunks]
        if not arrs:
            # every block pruned (key absent from this SST): a valid
            # EMPTY part, not an error — concat/assemble handle it
            return name, (np.empty(0, dtype=dtype), enc)
        return name, (np.concatenate(arrs) if len(arrs) > 1 else arrs[0],
                      enc)

    loaded = await asyncio.gather(*(load_col(nm) for nm in want))
    cols = {}
    for name, got in loaded:
        if got is None:
            return None
        cols[name] = got
    return cols, total


async def _load_pruned(store, path, want, leaves, runner, header,
                       data_start, n_rows, nblocks, _des):
    by_name = {m["name"]: m for m in header["columns"]}
    secs = _Sections(store, path, data_start)
    got = await _leaf_block_mask(leaves, by_name, header, secs, nblocks,
                                 runner)
    if got is None:
        return await _des(await store.get(path))
    mask, pruned_any = got
    kept = int(mask.sum())
    if (not pruned_any or kept == nblocks
            or kept * BLOCK_ROWS > _PARTIAL_MAX_FRAC * n_rows):
        return await _des(await store.get(path))
    ranges = _mask_to_ranges(mask, n_rows)
    return await _load_columns(by_name, header, secs, want, ranges,
                               runner)


# ---------------------------------------------------------------------------
# streamed-segment serving: PK-value-range windows from block stats
# ---------------------------------------------------------------------------


class SstStreamSession:
    """Prepared per-SST sidecar session for STREAMED segments: the
    header (and, lazily, dictionaries) probe once; each window then
    loads only the blocks intersecting its PK value range.  Small
    objects that fit the probe parse once and serve every window from
    memory."""

    @classmethod
    async def open(cls, store, path: str, want: set, runner=None):
        """None = no usable sidecar (caller falls back to the parquet
        streamer); NotFoundError propagates."""
        head = await store.get_range(path, 0, _HEAD_BYTES)
        self = cls()
        self.store, self.path, self.runner = store, path, runner
        self.want = set(want)
        self._full = None
        try:
            if len(head) < _HEAD_BYTES:
                full = deserialize(head, self.want)
                if full is None:
                    return None
                self._full = full
                return self
            span = header_span(head)
            if span is not None and span > len(head):
                head = bytes(head) + bytes(
                    await store.get_range(path, len(head), span))
            parsed = _parse_header(head)
            if parsed is None:
                return None
            self.header, self.data_start = parsed
            self.n_rows = int(self.header["n_rows"])
            self.by_name = {m["name"]: m for m in self.header["columns"]}
            if any(nm not in self.by_name for nm in self.want):
                return None
            self.nblocks = -(-self.n_rows // BLOCK_ROWS) \
                if self.n_rows else 0
            self.secs = _Sections(store, path, self.data_start)
            return self
        except NotFoundError:
            raise
        except Exception:
            return None

    async def _dict_values(self, meta, codes: np.ndarray):
        """Dictionary entries for `codes` WITHOUT downloading the whole
        dictionary: ONE ranged read spanning [min(code), max(code)] for
        i64 dicts (tsid's case — ~8 B/entry over the needed span); blob
        dicts load whole via the enc cache (tag dictionaries are
        small).  Returns an array aligned with `codes`, or None."""
        if meta.get("dict_kind") == "i64":
            lo_c, hi_c = int(codes.min()), int(codes.max())
            off = self.header["sections"][meta["dict_section"]]
            raw = await self.secs.fetch(off + 8 * lo_c,
                                        8 * (hi_c - lo_c + 1))
            span = np.frombuffer(raw, dtype=np.int64,
                                 count=hi_c - lo_c + 1)
            return span[codes.astype(np.int64) - lo_c]
        enc = await _encoding_for(meta, self.header, self.secs,
                                  self.runner)
        if enc is None or enc.dictionary is None:
            return None
        return enc.dictionary[codes.astype(np.int64)]

    async def block_value_ranges(self, column: str):
        """Per-block (min_value, max_value, rows) of `column`, or None
        when stats/encodings can't support window planning."""
        if self._full is not None:
            cols = self._full[0]
            if column not in cols:
                return None
            arr, enc = cols[column]
            n = self._full[1]
            if n == 0:
                return []
            vals = encode.decode_column(arr, enc, n).to_numpy(
                zero_copy_only=False)
            return [(vals.min(), vals.max(), n)]
        meta = self.by_name.get(column)
        if meta is None or "bstats_section" not in meta:
            return None
        raw = await self.secs.fetch(
            self.header["sections"][meta["bstats_section"]],
            self.nblocks * 8)
        stats = np.frombuffer(raw, dtype=np.int32, count=2 * self.nblocks)
        mins_c, maxs_c = stats[:self.nblocks], stats[self.nblocks:]
        if meta["kind"] == "offset":
            mins_v = mins_c.astype(np.int64) + int(meta["epoch"])
            maxs_v = maxs_c.astype(np.int64) + int(meta["epoch"])
        elif meta["kind"] == "numeric":
            mins_v, maxs_v = mins_c, maxs_c
        elif meta["kind"] == "dict":
            mins_v = await self._dict_values(meta, mins_c)
            maxs_v = await self._dict_values(meta, maxs_c)
            if mins_v is None or maxs_v is None:
                return None
        else:
            return None
        out = []
        for b in range(self.nblocks):
            rows = min(BLOCK_ROWS, self.n_rows - b * BLOCK_ROWS)
            out.append((mins_v[b], maxs_v[b], rows))
        return out

    async def load_window(self, leaves: list):
        """(cols, n) of the blocks intersecting the leaf conjunction
        (window range leaves + the plan's own pushed leaves); the exact
        mask applies later in assemble_parts.  None on malformed."""
        if self._full is not None:
            return self._full
        got = await _leaf_block_mask(leaves, self.by_name, self.header,
                                     self.secs, self.nblocks, self.runner)
        if got is None:
            return None
        mask, _pruned = got
        ranges = _mask_to_ranges(mask, self.n_rows)
        return await _load_columns(self.by_name, self.header, self.secs,
                                   self.want, ranges, self.runner)


async def plan_stream_windows(sessions: list, pk_names: list,
                              max_window_rows: int):
    """(partition_column, [(lo, hi), ...]) value-range windows over the
    first PK column whose values vary, sized so the blocks intersecting
    each range hold ~max_window_rows rows (soft bound: straddling
    blocks count toward both sides).  Ranges are [lo, hi) with None as
    -inf/+inf; equal-PK rows always land in exactly one window, which
    is what cross-SST dedup requires.  None = planning impossible
    (missing stats): fall back to the parquet streamer."""
    for col in pk_names:
        infos = await asyncio.gather(*(
            s.block_value_ranges(col) for s in sessions))
        if any(info is None for info in infos):
            return None
        blocks = [blk for info in infos for blk in info]
        if not blocks:
            return col, [(None, None)]
        lo = min(b[0] for b in blocks)
        hi = max(b[1] for b in blocks)
        if lo == hi:
            continue  # constant column cannot bound anything
        blocks.sort(key=lambda b: (b[0], b[1]))
        bounds: list = []
        acc = 0
        for bmin, _bmax, rows in blocks:
            if acc >= max_window_rows and (not bounds
                                           or bmin > bounds[-1]):
                # cut BETWEEN blocks at this block's min value: works
                # for ints and strings alike, no +1 arithmetic
                bounds.append(bmin)
                acc = 0
            acc += rows
        edges = [None] + bounds + [None]
        return col, list(zip(edges[:-1], edges[1:]))
    return None  # every PK constant: nothing to window on
