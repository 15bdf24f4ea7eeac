"""Scan-agent wire format: the aggregate plan request (JSON) and the
per-segment partial response (Arrow IPC).

A partial is exactly `_flush_window_batch`'s part shape —
`(group_values, bucket_lo, grids)` with `grids` a dict of
(groups, width) numpy arrays — because that is the shape every existing
consumer (sorted-segment-order combine, the PartsMemo, the cluster
downsample merge) already folds.  Serialization must round-trip BOTH
values and dtypes exactly: the coordinator's combine is byte-identity
-tested against the direct scan, so a uint64 group column must not come
back int64 and a float32 grid must not come back float64.

Each part travels as one self-contained Arrow IPC stream (its own
schema: a `__values__` column of length `groups` plus one
FixedSizeList<width> column per grid), framed by a JSON header that
carries the per-part bucket_lo, dtype tags, and grid widths.  Framing:

    HSAP1 | u32 header_len | header JSON | (u32 blob_len | IPC blob)*
"""

from __future__ import annotations

import base64
import json
import struct

import numpy as np
import pyarrow as pa
import pyarrow.ipc

from horaedb_tpu_torch.common.error import Error, ensure
from horaedb_tpu_torch.ops import filter as filter_ops
from horaedb_tpu_torch.storage.sst import FileMeta, SstFile
from horaedb_tpu_torch.storage.types import TimeRange

MAGIC = b"HSAP1"

# ---------------------------------------------------------------------------
# predicate tree <-> JSON
# ---------------------------------------------------------------------------

_LEAF_OPS = {"eq": filter_ops.Eq, "ne": filter_ops.Ne,
             "lt": filter_ops.Lt, "le": filter_ops.Le,
             "gt": filter_ops.Gt, "ge": filter_ops.Ge}


def _encode_value(v):
    if isinstance(v, bool):
        return {"t": "bool", "v": bool(v)}
    if isinstance(v, (int, np.integer)):
        return {"t": "i", "v": int(v)}
    if isinstance(v, (float, np.floating)):
        return {"t": "f", "v": float(v)}
    if isinstance(v, str):
        return {"t": "s", "v": v}
    if isinstance(v, (bytes, np.bytes_)):
        return {"t": "b", "v": base64.b64encode(bytes(v)).decode("ascii")}
    raise Error(f"unsupported predicate constant type {type(v).__name__}")


def _decode_value(obj):
    t, v = obj["t"], obj["v"]
    if t == "bool":
        return bool(v)
    if t == "i":
        return int(v)
    if t == "f":
        return float(v)
    if t == "s":
        return v
    if t == "b":
        return base64.b64decode(v)
    raise Error(f"unknown predicate constant tag {t!r}")


def encode_predicate(pred) -> "dict | None":
    if pred is None:
        return None
    if isinstance(pred, (filter_ops.And, filter_ops.Or)):
        op = "and" if isinstance(pred, filter_ops.And) else "or"
        return {"op": op,
                "children": [encode_predicate(c) for c in pred.children]}
    if isinstance(pred, filter_ops.Not):
        return {"op": "not", "child": encode_predicate(pred.child)}
    if isinstance(pred, filter_ops.In):
        vals = pred.values
        if isinstance(vals, np.ndarray):
            # dtype preserved: In-list membership in encoded space keys
            # off exact values, and the canonical predicate key renders
            # each element — the agent must rebuild the same array
            return {"op": "in", "col": pred.column,
                    "nd": vals.dtype.str,
                    "values": [_encode_value(v) for v in vals.tolist()]}
        return {"op": "in", "col": pred.column,
                "values": [_encode_value(v) for v in vals]}
    if isinstance(pred, filter_ops.TimeRangePred):
        return {"op": "range", "col": pred.column,
                "start": int(pred.start), "end": int(pred.end)}
    for name, cls in _LEAF_OPS.items():
        if isinstance(pred, cls):
            return {"op": name, "col": pred.column,
                    "value": _encode_value(pred.value)}
    raise Error(f"unsupported predicate node {type(pred).__name__}")


def decode_predicate(obj):
    if obj is None:
        return None
    op = obj["op"]
    if op in ("and", "or"):
        children = [decode_predicate(c) for c in obj["children"]]
        return (filter_ops.And(children) if op == "and"
                else filter_ops.Or(children))
    if op == "not":
        return filter_ops.Not(decode_predicate(obj["child"]))
    if op == "in":
        values = [_decode_value(v) for v in obj["values"]]
        if "nd" in obj:
            return filter_ops.In(obj["col"],
                                 np.asarray(values, dtype=obj["nd"]))
        return filter_ops.In(obj["col"], values)
    if op == "range":
        return filter_ops.TimeRangePred(obj["col"], int(obj["start"]),
                                        int(obj["end"]))
    cls = _LEAF_OPS.get(op)
    if cls is None:
        raise Error(f"unknown predicate op {op!r}")
    return cls(obj["col"], _decode_value(obj["value"]))


# ---------------------------------------------------------------------------
# scan request <-> JSON
# ---------------------------------------------------------------------------


def encode_scan_request(table: str, segment_start: int,
                        ssts: list, time_range,
                        predicate, spec,
                        projections=None) -> dict:
    """The POST /v1/scan body for ONE segment: the coordinator's view
    of the segment's SST set travels with the request, so the agent
    serves exactly the files the coordinator planned (a stale shard
    map or a racing compaction surfaces as stale_ssts, not as silently
    different data)."""
    return {
        "table": table,
        "segment_start": int(segment_start),
        "ssts": [{"id": int(f.id),
                  "rows": int(f.meta.num_rows),
                  "size": int(f.meta.size),
                  "seq": int(f.meta.max_sequence),
                  "range": [int(f.meta.time_range.start),
                            int(f.meta.time_range.end)]}
                 for f in ssts],
        "range": [int(time_range.start), int(time_range.end)],
        "predicate": encode_predicate(predicate),
        "projections": (None if projections is None
                        else [int(i) for i in projections]),
        "spec": {
            "group_col": spec.group_col, "ts_col": spec.ts_col,
            "value_col": spec.value_col,
            "range_start": int(spec.range_start),
            "bucket_ms": int(spec.bucket_ms),
            "num_buckets": int(spec.num_buckets),
            "which": list(spec.which),
        },
    }


def decode_scan_request(body: dict):
    """-> (table, segment_start, [SstFile], TimeRange, predicate,
    AggregateSpec, projections)."""
    from horaedb_tpu_torch.storage.read import AggregateSpec

    ensure(isinstance(body, dict), "scan request must be a JSON object")
    for key in ("table", "segment_start", "ssts", "range", "spec"):
        ensure(key in body, f"scan request missing {key!r}")
    ssts = [SstFile(int(f["id"]), FileMeta(
        max_sequence=int(f["seq"]), num_rows=int(f["rows"]),
        size=int(f["size"]),
        time_range=TimeRange.new(int(f["range"][0]),
                                 int(f["range"][1]))))
        for f in body["ssts"]]
    rng = TimeRange.new(int(body["range"][0]), int(body["range"][1]))
    s = body["spec"]
    spec = AggregateSpec(
        group_col=s["group_col"], ts_col=s["ts_col"],
        value_col=s["value_col"], range_start=int(s["range_start"]),
        bucket_ms=int(s["bucket_ms"]),
        num_buckets=int(s["num_buckets"]), which=tuple(s["which"]))
    proj = body.get("projections")
    if proj is not None:
        proj = [int(i) for i in proj]
    return (body["table"], int(body["segment_start"]), ssts, rng,
            decode_predicate(body.get("predicate")), spec, proj)


# ---------------------------------------------------------------------------
# parts <-> Arrow IPC
# ---------------------------------------------------------------------------


def _values_to_arrow(values: np.ndarray):
    """(arrow array, dtype tag) for a part's group-values array.  The
    tag drives exact dtype restoration on decode."""
    dt = values.dtype
    if dt.kind in "iuf":
        return pa.array(np.ascontiguousarray(values)), f"np:{dt.str}"
    if dt.kind == "S":
        return (pa.array(values.tolist(), type=pa.binary()),
                f"np:{dt.str}")
    if dt.kind == "U":
        return (pa.array(values.tolist(), type=pa.string()),
                f"np:{dt.str}")
    if dt.kind == "O":
        items = values.tolist()
        if all(isinstance(v, bytes) for v in items):
            return pa.array(items, type=pa.binary()), "obj:bytes"
        if all(isinstance(v, str) for v in items):
            return pa.array(items, type=pa.string()), "obj:str"
        if all(isinstance(v, int) for v in items):
            return pa.array(items, type=pa.int64()), "obj:int"
        raise Error("unsupported mixed-type group values")
    raise Error(f"unsupported group-values dtype {dt!r}")


def _values_from_arrow(col: pa.Array, tag: str) -> np.ndarray:
    if tag.startswith("np:"):
        dt = np.dtype(tag[3:])
        if dt.kind in "iuf":
            return col.to_numpy(zero_copy_only=False).astype(dt,
                                                             copy=False)
        return np.asarray(col.to_pylist(), dtype=dt)
    if tag == "obj:bytes":
        return np.asarray([bytes(v) for v in col.to_pylist()],
                          dtype=object)
    if tag == "obj:str":
        return np.asarray(col.to_pylist(), dtype=object)
    if tag == "obj:int":
        return np.asarray([int(v) for v in col.to_pylist()],
                          dtype=object)
    raise Error(f"unknown group-values tag {tag!r}")


def _part_to_ipc(values: np.ndarray, grids: dict) -> tuple[bytes, dict]:
    """One part's grids as a single-batch IPC stream + its header
    entry.  Grids ride as FixedSizeList<width> columns over `groups`
    rows so the exact (g, w) shape reconstructs without trusting the
    header for anything but dtype."""
    varr, vtag = _values_to_arrow(values)
    g = len(values)
    cols: dict = {"__values__": varr}
    meta: dict = {"values": vtag, "grids": {}}
    for name, grid in grids.items():
        arr = np.ascontiguousarray(grid)
        ensure(arr.ndim == 2 and arr.shape[0] == g,
               f"grid {name!r} shape {arr.shape} does not match "
               f"{g} groups")
        w = int(arr.shape[1])
        ensure(w >= 1, f"grid {name!r} has zero width")
        flat = pa.array(arr.reshape(-1))
        cols[f"g_{name}"] = pa.FixedSizeListArray.from_arrays(flat, w)
        meta["grids"][name] = arr.dtype.str
    batch = pa.record_batch(cols)
    sink = pa.BufferOutputStream()
    with pyarrow.ipc.new_stream(sink, batch.schema) as writer:
        writer.write_batch(batch)
    return sink.getvalue().to_pybytes(), meta


def _part_from_ipc(blob: bytes, meta: dict,
                   lo: int) -> tuple[np.ndarray, int, dict]:
    tbl = pyarrow.ipc.open_stream(blob).read_all().combine_chunks()
    values = _values_from_arrow(tbl.column("__values__").combine_chunks(),
                                meta["values"])
    g = len(values)
    grids = {}
    for name, dt in meta["grids"].items():
        col = tbl.column(f"g_{name}").combine_chunks()
        w = col.type.list_size
        flat = col.values.to_numpy(zero_copy_only=False)
        grids[name] = flat.astype(np.dtype(dt),
                                  copy=False).reshape(g, w)
    return values, int(lo), grids


def encode_parts(parts: list) -> bytes:
    """Serialize one segment's part list (window order preserved —
    the combine folds a segment's parts in exactly this order)."""
    blobs = []
    entries = []
    for values, lo, grids in parts:
        blob, meta = _part_to_ipc(values, grids)
        meta["lo"] = int(lo)
        entries.append(meta)
        blobs.append(blob)
    header = json.dumps({"version": 1, "parts": entries}).encode()
    out = bytearray(MAGIC)
    out += struct.pack("<I", len(header))
    out += header
    for blob in blobs:
        out += struct.pack("<I", len(blob))
        out += blob
    return bytes(out)


def decode_parts(data: bytes) -> list:
    ensure(data[:len(MAGIC)] == MAGIC,
           "malformed partial payload (bad magic)")
    off = len(MAGIC)
    (hlen,) = struct.unpack_from("<I", data, off)
    off += 4
    header = json.loads(data[off:off + hlen].decode())
    ensure(header.get("version") == 1,
           f"unsupported partial payload version "
           f"{header.get('version')!r}")
    off += hlen
    parts = []
    for meta in header["parts"]:
        (blen,) = struct.unpack_from("<I", data, off)
        off += 4
        parts.append(_part_from_ipc(data[off:off + blen], meta,
                                    meta["lo"]))
        off += blen
    ensure(off == len(data), "trailing bytes in partial payload")
    return parts
