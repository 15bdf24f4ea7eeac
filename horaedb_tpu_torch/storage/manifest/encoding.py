"""Manifest wire formats (ref: src/storage/src/manifest/encoding.rs).

Two formats, kept byte-compatible with the reference since they are a
compatibility surface and a bench target (SURVEY.md section 2.1):

- Delta files: proto3 `ManifestUpdate` (sst.proto:24-47) — encoded with
  our minimal prost-compatible wire codec.
- Snapshot: custom little-endian binary — 14-byte header
  `{magic u32 = 0xCAFE_1234, version u8, flag u8, length u64}`
  (encoding.rs:90-153) followed by fixed 32-byte records
  `{id u64, time_range 2x i64, size u32, num_rows u32}` (encoding.rs:161-238).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

from horaedb_tpu_torch import native
from horaedb_tpu_torch.common import protowire as pw
from horaedb_tpu_torch.common.error import ensure
from horaedb_tpu_torch.storage.sst import FileId, FileMeta, SstFile
from horaedb_tpu_torch.storage.types import TimeRange

# ---------------------------------------------------------------------------
# Delta: proto3 ManifestUpdate
# ---------------------------------------------------------------------------


@dataclass
class ManifestUpdate:
    """One delta-log entry (ref: encoding.rs:31-76)."""

    to_adds: list[SstFile] = field(default_factory=list)
    to_deletes: list[FileId] = field(default_factory=list)


def _encode_time_range(tr: TimeRange) -> bytes:
    out = bytearray()
    pw.encode_i64_field(1, int(tr.start), out)
    pw.encode_i64_field(2, int(tr.end), out)
    return bytes(out)


def _decode_time_range(buf: bytes) -> TimeRange:
    start = end = 0
    pos = 0
    while pos < len(buf):
        fnum, wtype, pos = pw.decode_tag(buf, pos)
        if fnum == 1 and wtype == pw.WIRE_VARINT:
            v, pos = pw.decode_varint(buf, pos)
            start = pw.decode_i64(v)
        elif fnum == 2 and wtype == pw.WIRE_VARINT:
            v, pos = pw.decode_varint(buf, pos)
            end = pw.decode_i64(v)
        else:
            pos = pw.skip_field(buf, pos, wtype)
    return TimeRange.new(start, end)


def _encode_sst_meta(meta: FileMeta) -> bytes:
    out = bytearray()
    pw.encode_u64_field(1, meta.max_sequence, out)
    pw.encode_u64_field(2, meta.num_rows, out)
    pw.encode_u64_field(3, meta.size, out)
    # prost models time_range as Some(msg) and always emits the field, even
    # zero-length for a default value — match that for byte compatibility.
    pw.encode_len_field(4, _encode_time_range(meta.time_range), out)
    return bytes(out)


def _decode_sst_meta(buf: bytes) -> FileMeta:
    max_sequence = num_rows = size = 0
    time_range = TimeRange.new(0, 0)
    pos = 0
    while pos < len(buf):
        fnum, wtype, pos = pw.decode_tag(buf, pos)
        if fnum == 1 and wtype == pw.WIRE_VARINT:
            max_sequence, pos = pw.decode_varint(buf, pos)
        elif fnum == 2 and wtype == pw.WIRE_VARINT:
            num_rows, pos = pw.decode_varint(buf, pos)
        elif fnum == 3 and wtype == pw.WIRE_VARINT:
            size, pos = pw.decode_varint(buf, pos)
        elif fnum == 4 and wtype == pw.WIRE_LEN:
            payload, pos = pw.read_len_payload(buf, pos)
            time_range = _decode_time_range(payload)
        else:
            pos = pw.skip_field(buf, pos, wtype)
    return FileMeta(max_sequence=max_sequence, num_rows=num_rows, size=size,
                    time_range=time_range)


def _encode_sst_file(f: SstFile) -> bytes:
    out = bytearray()
    pw.encode_u64_field(1, f.id, out)
    pw.encode_len_field(2, _encode_sst_meta(f.meta), out)
    return bytes(out)


def _decode_sst_file(buf: bytes) -> SstFile:
    file_id = 0
    meta: FileMeta | None = None
    pos = 0
    while pos < len(buf):
        fnum, wtype, pos = pw.decode_tag(buf, pos)
        if fnum == 1 and wtype == pw.WIRE_VARINT:
            file_id, pos = pw.decode_varint(buf, pos)
        elif fnum == 2 and wtype == pw.WIRE_LEN:
            payload, pos = pw.read_len_payload(buf, pos)
            meta = _decode_sst_meta(payload)
        else:
            pos = pw.skip_field(buf, pos, wtype)
    ensure(meta is not None, "file meta is missing")
    return SstFile(file_id, meta)


def encode_manifest_update(update: ManifestUpdate) -> bytes:
    out = bytearray()
    for f in update.to_adds:
        pw.encode_len_field(1, _encode_sst_file(f), out)
    pw.encode_packed_u64_field(2, update.to_deletes, out)
    return bytes(out)


def decode_manifest_update(buf: bytes) -> ManifestUpdate:
    update = ManifestUpdate()
    pos = 0
    while pos < len(buf):
        fnum, wtype, pos = pw.decode_tag(buf, pos)
        if fnum == 1 and wtype == pw.WIRE_LEN:
            payload, pos = pw.read_len_payload(buf, pos)
            update.to_adds.append(_decode_sst_file(payload))
        elif fnum == 2 and wtype == pw.WIRE_LEN:  # packed
            payload, pos = pw.read_len_payload(buf, pos)
            p = 0
            while p < len(payload):
                v, p = pw.decode_varint(payload, p)
                update.to_deletes.append(v)
        elif fnum == 2 and wtype == pw.WIRE_VARINT:  # unpacked fallback
            v, pos = pw.decode_varint(buf, pos)
            update.to_deletes.append(v)
        else:
            pos = pw.skip_field(buf, pos, wtype)
    return update


# ---------------------------------------------------------------------------
# Snapshot: custom binary
# ---------------------------------------------------------------------------

_HEADER_STRUCT = struct.Struct("<IBBQ")
_RECORD_STRUCT = struct.Struct("<QqqII")

# the wire constants and the array codec are the host library's
SNAPSHOT_MAGIC = native.SNAPSHOT_MAGIC
SNAPSHOT_VERSION = native.SNAPSHOT_VERSION
RECORD_DTYPE = native.RECORD_DTYPE
HEADER_LENGTH = _HEADER_STRUCT.size  # 14
RECORD_LENGTH = _RECORD_STRUCT.size  # 32
assert RECORD_LENGTH == RECORD_DTYPE.itemsize


@dataclass
class SnapshotHeader:
    """14-byte snapshot header (ref: encoding.rs:90-153).

    SnapshotHeader/SnapshotRecord state the wire format record by
    record; Snapshot encodes and decodes whole arrays at once through
    the host library (horaedb_tpu_torch.native)."""

    magic: int = SNAPSHOT_MAGIC
    version: int = SNAPSHOT_VERSION
    flag: int = 0
    length: int = 0

    def to_bytes(self) -> bytes:
        return _HEADER_STRUCT.pack(self.magic, self.version, self.flag, self.length)

    @classmethod
    def from_bytes(cls, buf: bytes) -> "SnapshotHeader":
        ensure(len(buf) >= HEADER_LENGTH, "snapshot header truncated")
        magic, version, flag, length = _HEADER_STRUCT.unpack_from(buf)
        ensure(magic == SNAPSHOT_MAGIC, "invalid bytes to convert to header")
        return cls(magic=magic, version=version, flag=flag, length=length)


@dataclass(frozen=True)
class SnapshotRecord:
    """Fixed 32-byte record (ref: encoding.rs:161-238)."""

    id: int
    time_range: TimeRange
    size: int
    num_rows: int

    def to_bytes(self) -> bytes:
        return _RECORD_STRUCT.pack(
            self.id, int(self.time_range.start), int(self.time_range.end),
            self.size, self.num_rows,
        )

    @classmethod
    def from_bytes(cls, buf: bytes, offset: int = 0) -> "SnapshotRecord":
        fid, start, end, size, num_rows = _RECORD_STRUCT.unpack_from(buf, offset)
        return cls(id=fid, time_range=TimeRange.new(start, end),
                   size=size, num_rows=num_rows)


class Snapshot:
    """Full SST listing: header + record array (ref: encoding.rs:283-344).

    Array-backed: records live in a numpy structured array whose memory
    layout IS the wire layout, so encode/decode are a header plus one
    memcpy (the host library's codec) instead of per-record Python
    packing.
    """

    def __init__(self, records: "np.ndarray | None" = None):
        self.records = (records if records is not None
                        else np.empty(0, dtype=RECORD_DTYPE))

    @classmethod
    def from_bytes(cls, buf: bytes) -> "Snapshot":
        return cls(native.snapshot_decode(buf))

    def into_bytes(self) -> bytes:
        return native.snapshot_encode(self.records)

    def __len__(self) -> int:
        return len(self.records)

    @property
    def ids(self) -> list[int]:
        return self.records["id"].tolist()

    def add_records(self, files: list[SstFile]) -> None:
        """Add files, replacing any record with the same id.

        Replacement (not append) keeps the delta fold idempotent: a crash
        between snapshot-put and delta-deletion replays deltas on the next
        merge, and replayed adds must not duplicate records.
        """
        if not files:
            return
        incoming = np.array(
            [(f.id, int(f.meta.time_range.start), int(f.meta.time_range.end),
              f.meta.size, f.meta.num_rows) for f in files],
            dtype=RECORD_DTYPE)
        keep = ~np.isin(self.records["id"], incoming["id"])
        self.records = np.concatenate([self.records[keep], incoming])

    def delete_records(self, to_deletes: list[FileId]) -> None:
        """Delete by id; ids already absent are ignored (replay tolerance —
        the reference only debug-asserts here, encoding.rs:313-321)."""
        if not to_deletes:
            return
        dels = np.asarray(to_deletes, dtype=np.uint64)
        self.records = self.records[~np.isin(self.records["id"], dels)]

    def into_ssts(self) -> list[SstFile]:
        # max_sequence == file id by construction (ref: encoding.rs:243-252)
        return [
            SstFile(int(r["id"]), FileMeta(
                max_sequence=int(r["id"]), num_rows=int(r["num_rows"]),
                size=int(r["size"]),
                time_range=TimeRange.new(int(r["start"]), int(r["end"]))))
            for r in self.records
        ]
