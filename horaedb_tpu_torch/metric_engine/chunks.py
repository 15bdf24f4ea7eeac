"""Opaque chunk codec of the chunked data layout (the port's copy of the
JAX package's metric_engine/chunks.py; the encoded bytes are equal).

RFC 20240827 (data design): "Timestamp and Value are encoded by the
upper layer itself; data is batched — e.g. 30 minutes compressed into
one row", with the engine's Append/BytesMerge path concatenating chunk
payloads for the same primary key across files.

v2 (compressed, magic 0xC8 — the one written):

    chunk := magic u8 | count u32 | ts_base i64 | d1 i32
             | dod_w u8 | vmode u8 | vp1 u8 | vp2 u8 | v0 f64
             | dod i{dod_w}[count-2] | value body

Timestamps store delta-of-delta with a per-chunk byte width (a regular
scrape interval makes every dod zero: dod_w = 0).  Values pick the
smaller of two bodies per chunk: vmode 0, the XOR of consecutive f64
bit patterns shifted by the chunk-wide common trailing zero bytes and
truncated to the significant byte width, u{vp2}[count-1]; vmode 1, when
every value is exactly k / 10^e for an integer k, the deltas of k as
i{vp2}[count-1].  The v1 raw layout (magic 0xC7) is still decoded.

Decoding lives in the host library (native.chunk_decode_batch, one call
for many payloads) beside its plain numpy version
(native.decode_chunks_plain, one payload).  Duplicate policy: chunks
arrive in sequence order (BytesMerge concatenates in (pk, __seq__)
order), so for equal timestamps the LAST occurrence wins.
"""

from __future__ import annotations

import struct

import numpy as np

from horaedb_tpu_torch.common.error import Error, ensure

_MAGIC_V2 = 0xC8
# magic u8 | count u32 | ts_base i64 | d1 i32 | dod_w u8 | vmode u8
# | vp1 u8 | vp2 u8 | v0 f64
_HEADER_V2 = struct.Struct("<BIqiBBBBd")

_INT_DTYPES = {1: np.int8, 2: np.int16, 4: np.int32, 8: np.int64}
_VMODE_XOR = 0
_VMODE_SCALED = 1


def _int_width(m: int) -> int:
    """Smallest signed byte width holding |values| <= m."""
    return 1 if m < 2**7 else 2 if m < 2**15 else 4 if m < 2**31 else 8


def _scaled_int_body(values: np.ndarray):
    """(exponent, width, bytes) when every value is exactly k/10^e for
    int k with |k| < 2^53, else None."""
    for e in (0, 1, 2, 3, 4):
        scaled = values * (10.0 ** e)
        k = np.round(scaled)
        if np.abs(k).max(initial=0) >= 2**53:
            return None
        if not (k / (10.0 ** e) == values).all():
            continue
        deltas = np.diff(k.astype(np.int64))
        if not len(deltas) or not deltas.any():
            return e, 0, b""
        w = _int_width(int(np.abs(deltas).max()))
        return e, w, deltas.astype(_INT_DTYPES[w]).tobytes()
    return None


def _pack_low_bytes(x: np.ndarray, width: int) -> bytes:
    """Low `width` bytes of each uint64 (little-endian)."""
    if width == 0 or not len(x):
        return b""
    return np.ascontiguousarray(x, dtype="<u8").view(np.uint8) \
        .reshape(-1, 8)[:, :width].tobytes()


def encode_chunk(ts: np.ndarray, values: np.ndarray) -> bytes:
    """Encode one chunk (v2); ts int64 ms (any order, will be sorted),
    values float64 aligned with ts."""
    ensure(len(ts) == len(values), "ts/values length mismatch")
    ensure(len(ts) > 0, "empty chunk")
    order = np.argsort(ts, kind="stable")
    ts = np.asarray(ts, dtype=np.int64)[order]
    values = np.asarray(values, dtype=np.float64)[order]
    count = len(ts)
    base = int(ts[0])
    ensure(int(ts[-1]) - base < 2**31, "chunk time span exceeds int32 deltas")

    # timestamps: delta-of-delta with per-chunk byte width
    deltas = np.diff(ts)
    d1 = int(deltas[0]) if count > 1 else 0
    dod = np.diff(deltas)  # (count-2,)
    dod_w = 0
    if len(dod) and (dod != 0).any():
        dod_w = _int_width(int(np.abs(dod).max()))
        if dod_w == 8:
            raise Error("chunk interval jump exceeds int32")
    dod_bytes = (dod.astype(_INT_DTYPES[dod_w]).tobytes() if dod_w else b"")

    # value mode 0: consecutive XOR, shifted by common trailing-zero
    # bytes, truncated to the significant byte width
    bits = values.view(np.uint64)
    xor = bits[1:] ^ bits[:-1]  # (count-1,)
    xor_shift = 0
    xor_w = 0
    nz = xor[xor != 0]
    if len(nz):
        # trailing/leading zero BYTES common to every non-zero xor
        as_bytes = np.ascontiguousarray(nz, dtype="<u8").view(np.uint8) \
            .reshape(-1, 8)
        cols = np.flatnonzero((as_bytes != 0).any(axis=0))
        xor_shift = int(cols[0])
        xor_w = int(cols[-1]) - xor_shift + 1

    # value mode 1: exact decimal-scaled integer deltas; pick whichever
    # body is smaller
    scaled = _scaled_int_body(values)
    if scaled is not None and scaled[1] < xor_w:
        e, w, body = scaled
        vmode, vp1, vp2 = _VMODE_SCALED, e, w
    else:
        vmode, vp1, vp2 = _VMODE_XOR, xor_shift, xor_w
        body = _pack_low_bytes(xor >> np.uint64(8 * xor_shift), xor_w)

    return (_HEADER_V2.pack(_MAGIC_V2, count, base, d1, dod_w, vmode,
                            vp1, vp2, float(values[0]))
            + dod_bytes + body)

