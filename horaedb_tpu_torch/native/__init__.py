"""ctypes bindings of the port's host library (csrc/host_native.cpp):
the manifest snapshot codec, primary-key run detection, SeaHash, and
the batch decode of chunk payloads.

The library is compiled with g++ (-O3 -fPIC -shared -std=c++17) into
horaedb_tpu_torch/build/ at first use, keyed by the source's content,
and loaded with ctypes.  Nothing here runs at import.  A failed build or
load raises `Error` with the compiler's output: there is no fallback.
Each entry keeps its plain version beside it (`*_plain`: numpy or pure
Python, the same results byte for byte), which the tests hold the
library against.  `is_loaded()` never triggers a build: a request-path
single-key hash must not block behind a compile.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
import threading
from typing import Optional

import numpy as np

from horaedb_tpu_torch.common.error import Error, ensure

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "host_native.cpp")
BUILD_DIR = os.path.join(_PKG, "build")
CXX = "g++"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()

# the snapshot wire format: a 14-byte header {magic u32, version u8,
# flag u8, body length u64}, then 32-byte records whose structured
# dtype's memory layout IS the wire layout
SNAPSHOT_MAGIC = 0xCAFE_1234
SNAPSHOT_VERSION = 1
RECORD_DTYPE = np.dtype(
    [("id", "<u8"), ("start", "<i8"), ("end", "<i8"),
     ("size", "<u4"), ("num_rows", "<u4")], align=False)

_HEADER = struct.Struct("<IBBQ")
_HEADER_LEN = _HEADER.size
_RECORD_LEN = RECORD_DTYPE.itemsize
assert (_HEADER_LEN, _RECORD_LEN) == (14, 32)


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"libhost_native_{digest}.so")


def build() -> str:
    """Compile the library unless it exists; return its path."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [CXX, *CXX_FLAGS, "-o", tmp, SOURCE]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise Error(f"host library build failed ({' '.join(cmd)}): "
                    f"{e}") from e
    if proc.returncode != 0:
        raise Error(f"host library build failed ({' '.join(cmd)}):\n"
                    f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return path


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            path = build()
            try:
                lib = ctypes.CDLL(path)
                _bind(lib)
            except (OSError, AttributeError) as e:
                raise Error(f"host library load failed ({path}): {e}") \
                    from e
            _lib = lib
        return _lib


def _bind(lib: ctypes.CDLL) -> None:
    vp, sz = ctypes.c_void_p, ctypes.c_size_t
    lib.snapshot_encode.restype = ctypes.c_longlong
    lib.snapshot_encode.argtypes = [vp, sz, vp, sz]
    lib.snapshot_decode.restype = ctypes.c_longlong
    lib.snapshot_decode.argtypes = [vp, sz, vp, sz]
    lib.run_starts_i64.restype = None
    lib.run_starts_i64.argtypes = [ctypes.POINTER(vp), ctypes.c_int, sz, vp]
    lib.run_last_indices.restype = sz
    lib.run_last_indices.argtypes = [vp, sz, vp]
    lib.seahash64.restype = ctypes.c_uint64
    lib.seahash64.argtypes = [ctypes.c_char_p, sz]
    lib.seahash64_batch.restype = None
    lib.seahash64_batch.argtypes = [ctypes.c_char_p, vp, sz, vp]
    lib.chunk_batch_capacity.restype = ctypes.c_longlong
    lib.chunk_batch_capacity.argtypes = [vp, vp, sz]
    lib.chunk_batch_decode.restype = ctypes.c_longlong
    lib.chunk_batch_decode.argtypes = [vp, vp, sz, vp, vp, vp]


def available() -> bool:
    """Build and load the library (raises if either fails)."""
    return _load() is not None


def is_loaded() -> bool:
    """True iff the library is ALREADY loaded; never triggers a build."""
    return _lib is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


# ---------------------------------------------------------------------------
# snapshot codec
# ---------------------------------------------------------------------------


def snapshot_encode(records: np.ndarray) -> bytes:
    """records: RECORD_DTYPE structured array -> snapshot bytes.  An
    empty snapshot is zero bytes, not a header-only buffer: the
    reference decodes empty bytes as the default snapshot but rejects
    header-only buffers."""
    records = np.ascontiguousarray(records, dtype=RECORD_DTYPE)
    n = len(records)
    if n == 0:
        return b""
    out = np.empty(_HEADER_LEN + n * _RECORD_LEN, dtype=np.uint8)
    written = _load().snapshot_encode(_ptr(records), n, _ptr(out),
                                      out.nbytes)
    ensure(written == out.nbytes, f"snapshot encode wrote {written} B")
    return out.tobytes()


def snapshot_decode(buf: bytes) -> np.ndarray:
    """snapshot bytes -> RECORD_DTYPE structured array (validates the
    header)."""
    if not buf:
        return np.empty(0, dtype=RECORD_DTYPE)
    n_max = max(0, len(buf) - _HEADER_LEN) // _RECORD_LEN
    out = np.empty(n_max, dtype=RECORD_DTYPE)
    src = np.frombuffer(buf, dtype=np.uint8)
    n = _load().snapshot_decode(_ptr(src), len(buf), _ptr(out), n_max)
    if n == -2:
        raise Error("invalid bytes to convert to header")
    if n == -5:
        raise Error(f"snapshot version is newer than supported "
                    f"{SNAPSHOT_VERSION}")
    if n == -6:
        raise Error("snapshot body is empty (header-only buffer); "
                    "an empty snapshot is encoded as zero bytes")
    ensure(n >= 0, f"snapshot decode failed (code {n}): length mismatch")
    return out[:n]


def snapshot_encode_plain(records: np.ndarray) -> bytes:
    records = np.ascontiguousarray(records, dtype=RECORD_DTYPE)
    if len(records) == 0:
        return b""
    return _HEADER.pack(SNAPSHOT_MAGIC, SNAPSHOT_VERSION, 0,
                        len(records) * _RECORD_LEN) + records.tobytes()


def snapshot_decode_plain(buf: bytes) -> np.ndarray:
    """The library's checks in its order, with its messages."""
    if not buf:
        return np.empty(0, dtype=RECORD_DTYPE)
    ensure(len(buf) >= _HEADER_LEN,
           "snapshot decode failed (code -1): length mismatch")
    magic, ver, _flag, length = _HEADER.unpack_from(buf)
    ensure(magic == SNAPSHOT_MAGIC, "invalid bytes to convert to header")
    ensure(ver <= SNAPSHOT_VERSION,
           f"snapshot version is newer than supported {SNAPSHOT_VERSION}")
    ensure(length > 0, "snapshot body is empty (header-only buffer); "
           "an empty snapshot is encoded as zero bytes")
    body = buf[_HEADER_LEN:]
    ensure(length == len(body) and length % _RECORD_LEN == 0,
           "snapshot decode failed (code -3): length mismatch")
    return np.frombuffer(body, dtype=RECORD_DTYPE).copy()


# ---------------------------------------------------------------------------
# run detection (the host merge's last-value rule)
# ---------------------------------------------------------------------------


def run_starts_i64(cols: list) -> np.ndarray:
    """Run-start mask over sorted int64 key columns."""
    n = len(cols[0]) if cols else 0
    if n == 0:
        return np.zeros(0, dtype=bool)
    c_cols = [np.ascontiguousarray(c, dtype=np.int64) for c in cols]
    ptrs = (ctypes.c_void_p * len(c_cols))(
        *[c.ctypes.data_as(ctypes.c_void_p).value for c in c_cols])
    out = np.zeros(n, dtype=np.uint8)
    _load().run_starts_i64(ptrs, len(c_cols), n, _ptr(out))
    return out.astype(bool)


def run_last_indices(starts: np.ndarray) -> np.ndarray:
    """Last row index of each run, from a run-start mask."""
    n = len(starts)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    starts_u8 = np.ascontiguousarray(starts, dtype=np.uint8)
    out = np.empty(n, dtype=np.int64)
    k = _load().run_last_indices(_ptr(starts_u8), n, _ptr(out))
    return out[:k]


def run_starts_i64_plain(cols: list) -> np.ndarray:
    n = len(cols[0]) if cols else 0
    starts = np.zeros(n, dtype=bool)
    if n == 0:
        return starts
    starts[0] = True
    for c in cols:
        c = np.asarray(c)
        starts[1:] |= c[1:] != c[:-1]
    return starts


def run_last_indices_plain(starts: np.ndarray) -> np.ndarray:
    n = len(starts)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    idx = np.nonzero(starts)[0]
    return np.append(idx[1:] - 1, n - 1).astype(np.int64)


# ---------------------------------------------------------------------------
# SeaHash (metric and series ids)
# ---------------------------------------------------------------------------


def seahash64(buf: bytes) -> int:
    return int(_load().seahash64(buf, len(buf)))


def seahash64_batch(keys: list) -> np.ndarray:
    """Hash many keys in one call: uint64 hashes aligned with `keys`."""
    lib = _load()
    lens = np.fromiter((len(k) for k in keys), dtype=np.int64,
                       count=len(keys))
    offsets = np.zeros(len(keys) + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    out = np.empty(len(keys), dtype=np.uint64)
    lib.seahash64_batch(b"".join(keys), _ptr(offsets), len(keys),
                        _ptr(out))
    return out


def seahash64_plain(buf: bytes) -> int:
    from horaedb_tpu_torch.common.seahash import hash64_plain

    return hash64_plain(buf)


def seahash64_batch_plain(keys: list) -> np.ndarray:
    return np.fromiter((seahash64_plain(k) for k in keys), dtype=np.uint64,
                       count=len(keys))


# ---------------------------------------------------------------------------
# chunk payloads: batch decode
# ---------------------------------------------------------------------------


def chunk_decode_batch(payloads):
    """Decode MANY chunk payloads (one per (series, field) row) in one
    call: per payload, every chunk decoded, stable-sorted by timestamp,
    and the last point per timestamp kept.

    `payloads` is a pyarrow binary Array (zero-copy: the call reads the
    array's own offsets and data buffers) or a list of bytes.  Returns
    (ts int64, values f64, counts int64 per payload), ts/values
    concatenated in payload order, or None when the input shape is not
    supported or a payload is malformed (decode_chunks_plain names the
    fault)."""
    lib = _load()
    holder, data_ptr, offsets, n = _payload_buffers(payloads)
    if data_ptr is None:
        return None
    if n == 0:
        return (np.empty(0, np.int64), np.empty(0, np.float64),
                np.empty(0, np.int64))
    off_ptr = _ptr(offsets)
    cap = lib.chunk_batch_capacity(data_ptr, off_ptr, n)
    if cap < 0:
        return None
    ts = np.empty(int(cap), dtype=np.int64)
    vals = np.empty(int(cap), dtype=np.float64)
    counts = np.empty(n, dtype=np.int64)
    total = lib.chunk_batch_decode(data_ptr, off_ptr, n, _ptr(ts),
                                   _ptr(vals), _ptr(counts))
    del holder  # the source buffer stays alive through both calls
    if total < 0:
        return None
    return ts[:int(total)], vals[:int(total)], counts


def _arrow_buffers(payloads):
    """Seam over Array.buffers(): some pyarrow builds hand back no data
    buffer for an all-empty binary array."""
    return payloads.buffers()


def _payload_buffers(payloads):
    """(holder, data_ptr, int64 offsets (n+1), n) for the C ABI; data_ptr
    is None for an input shape the call cannot take.  `holder` keeps the
    buffer alive; a sliced pyarrow array's offset is honoured."""
    import pyarrow as pa

    if isinstance(payloads, pa.ChunkedArray):
        payloads = payloads.combine_chunks()
    if isinstance(payloads, pa.Array) and pa.types.is_binary(payloads.type):
        if payloads.null_count:
            return None, None, None, 0
        _validity, off_buf, data_buf = _arrow_buffers(payloads)
        if data_buf is None:
            return None, None, None, 0
        offs = np.frombuffer(off_buf, dtype=np.int32)[
            payloads.offset:payloads.offset + len(payloads) + 1]
        return (data_buf, ctypes.c_void_p(data_buf.address),
                np.ascontiguousarray(offs, dtype=np.int64), len(payloads))
    if isinstance(payloads, (list, tuple)):
        lens = np.fromiter((len(p) for p in payloads), dtype=np.int64,
                           count=len(payloads))
        offsets = np.zeros(len(payloads) + 1, dtype=np.int64)
        np.cumsum(lens, out=offsets[1:])
        buf = np.frombuffer(b"".join(payloads) or b"\x00", dtype=np.uint8)
        return buf, _ptr(buf), offsets, len(payloads)
    return None, None, None, 0


# The chunk format (v1 raw, magic 0xC7; v2, magic 0xC8):
#   v1 := magic u8 | count u32 | ts_base i64 | ts_delta i32[count]
#         | values f64[count]
#   v2 := magic u8 | count u32 | ts_base i64 | d1 i32 | dod_w u8
#         | vmode u8 | vp1 u8 | vp2 u8 | v0 f64 | dod i{dod_w}[count-2]
#         | value body
# vmode 0: XOR of consecutive f64 bit patterns shifted right by vp1
# bytes, u{vp2}[count-1]; vmode 1: v = k / 10^vp1 with the deltas of k
# as i{vp2}[count-1].  Equal timestamps: the LAST occurrence wins.
_MAGIC_V1 = 0xC7
_HEADER_V1 = struct.Struct("<BIq")
_MAGIC_V2 = 0xC8
_HEADER_V2 = struct.Struct("<BIqiBBBBd")
_INT_DTYPES = {1: np.int8, 2: np.int16, 4: np.int32, 8: np.int64}
_MAX_CHUNK_POINTS = 1 << 27


def _decode_v1(payload: bytes, off: int, n: int):
    _magic, count, base = _HEADER_V1.unpack_from(payload, off)
    off += _HEADER_V1.size
    ensure(1 <= count <= _MAX_CHUNK_POINTS,
           f"implausible chunk point count {count}")
    if off + count * 12 > n:
        raise Error("truncated chunk body")
    deltas = np.frombuffer(payload, dtype="<i4", count=count, offset=off)
    off += count * 4
    vals = np.frombuffer(payload, dtype="<f8", count=count, offset=off)
    off += count * 8
    return base + deltas.astype(np.int64), np.asarray(vals), off


def _unpack_low_bytes(buf: bytes, count: int, width: int) -> np.ndarray:
    if width == 0 or count == 0:
        return np.zeros(count, dtype=np.uint64)
    raw = np.frombuffer(buf, dtype=np.uint8, count=count * width)
    out = np.zeros((count, 8), dtype=np.uint8)
    out[:, :width] = raw.reshape(count, width)
    return out.reshape(-1).view("<u8").astype(np.uint64)


def _decode_v2(payload: bytes, off: int, n: int):
    if off + _HEADER_V2.size > n:
        raise Error("truncated chunk header")
    (_magic, count, base, d1, dod_w, vmode, vp1, vp2,
     v0) = _HEADER_V2.unpack_from(payload, off)
    off += _HEADER_V2.size
    ensure(1 <= count <= _MAX_CHUNK_POINTS,
           f"implausible chunk point count {count}")
    ensure(dod_w in (0, 1, 2, 4), f"bad chunk dod width {dod_w}")
    if vmode == 1:
        ensure(vp1 <= 4 and vp2 in (0, 1, 2, 4, 8),
               f"bad scaled-int params e={vp1} w={vp2}")
    elif vmode == 0:
        ensure(vp1 <= 7 and vp2 <= 8 and vp1 + vp2 <= 8,
               f"bad xor params shift={vp1} w={vp2}")
    else:
        raise Error(f"unknown chunk value mode {vmode}")
    n_dod = max(0, count - 2)
    n_val = max(0, count - 1)
    if off + n_dod * dod_w + n_val * vp2 > n:
        raise Error("truncated chunk body")
    if dod_w:
        dod = np.frombuffer(payload, dtype=_INT_DTYPES[dod_w], count=n_dod,
                            offset=off).astype(np.int64)
        off += n_dod * dod_w
    else:
        dod = np.zeros(n_dod, dtype=np.int64)
    ts = np.empty(count, dtype=np.int64)
    ts[0] = base
    if count > 1:
        deltas = np.empty(count - 1, dtype=np.int64)
        deltas[0] = d1
        if count > 2:
            deltas[1:] = d1 + np.cumsum(dod)
        ts[1:] = base + np.cumsum(deltas)
    if vmode == 1:
        if vp2:
            vdeltas = np.frombuffer(payload, dtype=_INT_DTYPES[vp2],
                                    count=n_val, offset=off).astype(np.int64)
            off += n_val * vp2
        else:
            vdeltas = np.zeros(n_val, dtype=np.int64)
        scale = 10.0 ** vp1
        ks = np.empty(count, dtype=np.int64)
        ks[0] = int(np.round(v0 * scale))
        if count > 1:
            ks[1:] = ks[0] + np.cumsum(vdeltas)
        return ts, ks.astype(np.float64) / scale, off
    xor = _unpack_low_bytes(payload[off:], n_val, vp2) << np.uint64(8 * vp1)
    off += n_val * vp2
    bits = np.empty(count, dtype=np.uint64)
    bits[0] = np.array([v0], dtype="<f8").view("<u8")[0]
    if count > 1:
        bits[1:] = np.bitwise_xor.accumulate(
            np.concatenate([bits[:1], xor]))[1:]
    return ts, bits.view(np.float64), off


def decode_chunks_plain(payload: bytes) -> tuple:
    """One (possibly concatenated, possibly mixed-version) payload ->
    (ts int64, values float64), sorted by ts, the last point per
    timestamp kept.  Raises `Error` on a malformed payload."""
    if not payload:
        return np.empty(0, dtype=np.int64), np.empty(0, dtype=np.float64)
    all_ts, all_vals = [], []
    off, n = 0, len(payload)
    while off < n:
        magic = payload[off]
        if magic == _MAGIC_V1:
            if off + _HEADER_V1.size > n:
                raise Error("truncated chunk header")
            ts, vals, off = _decode_v1(payload, off, n)
        elif magic == _MAGIC_V2:
            ts, vals, off = _decode_v2(payload, off, n)
        else:
            raise Error(f"bad chunk magic 0x{magic:02x} at offset {off}")
        all_ts.append(ts)
        all_vals.append(vals)
    ts = np.concatenate(all_ts)
    vals = np.concatenate(all_vals)
    order = np.argsort(ts, kind="stable")
    ts, vals = ts[order], vals[order]
    keep = np.ones(len(ts), dtype=bool)
    keep[:-1] = ts[:-1] != ts[1:]
    return ts[keep], vals[keep]


def chunk_decode_batch_plain(payloads):
    """chunk_decode_batch's contract through decode_chunks_plain."""
    import pyarrow as pa

    if isinstance(payloads, (pa.Array, pa.ChunkedArray)):
        if payloads.null_count or not pa.types.is_binary(payloads.type):
            return None
        payloads = payloads.to_pylist()
    try:
        decoded = [decode_chunks_plain(p) for p in payloads]
    except Error:
        return None
    counts = np.array([len(t) for t, _v in decoded], dtype=np.int64)
    if not decoded:
        return (np.empty(0, np.int64), np.empty(0, np.float64), counts)
    return (np.concatenate([t for t, _v in decoded]),
            np.concatenate([v for _t, v in decoded]), counts)
