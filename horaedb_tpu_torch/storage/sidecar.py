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

import json
import struct
from dataclasses import dataclass
from typing import Optional

import numpy as np
import pyarrow as pa

from horaedb_tpu_torch.common.error import Error
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


# ---------------------------------------------------------------------------
# read-side assembly
# ---------------------------------------------------------------------------


@dataclass
class EncodedSegment:
    """One segment's rows straight from sidecars — the parquet-free twin
    of the Arrow table the parquet read returns.  Columns are unpadded,
    filtered (prune leaves applied) and concatenated in SST/run order,
    ready for the merge's window prep."""

    columns: dict
    encodings: dict
    n: int
    names: list

    @property
    def num_rows(self) -> int:
        return self.n

    @property
    def nbytes(self) -> int:
        return sum(int(a.nbytes) for a in self.columns.values())


def assemble_parts(parts: list, columns: list,
                   leaves: Optional[list]) -> Optional[EncodedSegment]:
    """Apply the pruned-read leaf conjunction per SST part (row-level
    equivalent to the parquet path's read_pruned / filters=pushdown) and
    concatenate the runs in SST order.  `parts` are (cols, n) pairs as
    returned by deserialize()/load_sst_encoded()."""
    from horaedb_tpu_torch.ops import filter as filter_ops

    leaves = leaves or []
    out_parts = []
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
    cc = concat_encoded(out_parts, list(columns))
    if cc is None:
        return None
    out_cols, out_encs, n_total = cc
    return EncodedSegment(columns=out_cols, encodings=out_encs,
                          n=n_total, names=list(columns))


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



async def load_sst_encoded(store, path: str, want: set, runner=None):
    """Fetch one SST's sidecar columns as ({name: (arr, enc)}, n_rows)
    with one whole-object GET.  `runner` (async callable(fn, *args),
    e.g. a worker-pool dispatch) carries the CPU-bound deserialize off
    the event loop.  None = invalid sidecar (caller falls back to
    parquet); NotFoundError propagates.  The JAX package's block-pruned
    ranged fetch for point queries is not ported yet."""
    buf = await store.get(path)
    if runner is None:
        return deserialize(buf, want)
    return await runner(deserialize, buf, want)
