"""Host-side encode/decode between Arrow RecordBatches and device batches.

The device kernels want fixed-width int32/float32 columns; Arrow
delivers int64 timestamps, utf8 strings, and u64 sequences.  The bridge:

- string/binary  → order-preserving dictionary codes (Arrow C++
                   dictionary_encode, re-ranked to sorted order) + a host
                   dictionary for decode and predicate-constant lookup.
- int64 ts/seq   → int32 offset from a per-batch epoch (timestamps), or
                   order-preserving rank codes (sequences).  Ranks preserve
                   comparison order, which is all the merge needs.
- float64        → float32 (values; aggregation in f32, see downsample.py).
- rows           → padded to capacity buckets (next power of two, min 128)
                   so round stacks come in a small set of shapes.

Decode inverts the mapping for result batches.  Every host-to-device
copy goes through `to_device`, which counts the bytes it moves.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from horaedb_tpu_torch.common import deviceprof
from horaedb_tpu_torch.common.error import Error, ensure
from horaedb_tpu_torch.utils import registry

_INT32_MIN = np.int32(-(2**31))
_INT32_MAX = np.int32(2**31 - 1)

_F32_MAX = np.float32(np.finfo(np.float32).max)
# f64→f32 overflow policy: finite values beyond the f32 range CLAMP to
# ±f32::MAX and count here, instead of silently becoming inf and
# poisoning every aggregate over the segment.  Actual ±inf inputs pass
# through unchanged (the caller said inf, the cast didn't invent it).
_ENCODE_OVERFLOW = registry.counter(
    "horaedb_encode_overflow_total",
    "finite f64 values clamped to the f32 range during device encoding")

_H2D_BYTES = registry.counter(
    "horaedb_h2d_bytes_total", "bytes copied host-to-device by to_device")

MIN_CAPACITY = 128


def to_device(arr: np.ndarray, device):
    """THE host-to-device copy: a numpy array -> torch tensor on
    `device`, with the bytes counted in horaedb_h2d_bytes_total and
    charged to the device profiler's h2d transfers (also for a CPU
    device, where the copy is a memcpy)."""
    import torch

    t0 = time.perf_counter()
    t = torch.from_numpy(np.ascontiguousarray(arr))
    _H2D_BYTES.inc(int(t.nbytes))
    out = t.to(device)
    deviceprof.charge_transfer("h2d", int(t.nbytes),
                               seconds=time.perf_counter() - t0)
    return out


def h2d_bytes() -> int:
    """Bytes moved by to_device so far in this process."""
    return int(_H2D_BYTES.value)


def pad_to(arr: np.ndarray, cap: int) -> np.ndarray:
    """`arr` zero-padded to `cap` rows, every byte written: a window's
    memory accounts charge its padded width, and a calloc'd tail would
    stay unmapped (not resident) until something first wrote it."""
    out = np.empty(cap, dtype=arr.dtype)
    n = len(arr)
    out[:n] = arr
    out[n:] = 0
    return out


def pad_capacity(n: int) -> int:
    """Static-shape bucket for n rows: next power of two, >= MIN_CAPACITY."""
    cap = MIN_CAPACITY
    while cap < n:
        cap *= 2
    return cap


@dataclass(frozen=True)
class ColumnEncoding:
    """How one host column maps onto its device representation.

    kinds:
      numeric — value used as-is (int32/float32)
      offset  — host_value = epoch + device_value (timestamps: preserves
                arithmetic, so bucket = offset // width works on device)
      dict    — device value indexes `dictionary` (strings, and int64
                columns whose span exceeds int32 — e.g. __seq__, whose
                wall-clock-nanosecond values are near-constant-distinct
                per file but span far more than 2^31).  The dictionary is
                sorted, so codes are order-preserving — all compares and
                sorts need (strings via _dictionary_encode_arrow, int64
                via np.unique).
    """

    kind: str  # "numeric" | "dict" | "offset"
    arrow_type: pa.DataType
    dictionary: Optional[np.ndarray] = None  # kind == "dict"
    epoch: int = 0  # kind == "offset"


@dataclass
class DeviceBatch:
    """A padded columnar batch.

    `columns` maps name → (capacity,)-shaped numpy array or torch tensor
    on the chosen device (int32 or float32); rows [0, n_valid) are real,
    the rest padding.  `encodings`
    carries the host-side metadata needed to decode or to translate
    predicate constants.  `memo` holds derived per-batch artifacts (e.g.
    dense group mappings) so repeat queries over a cached batch skip
    recomputation; it is never part of the batch's identity.
    """

    columns: dict
    encodings: dict[str, ColumnEncoding]
    n_valid: int
    capacity: int
    memo: dict = field(default_factory=dict)
    # bytes currently held by `memo` values (maintained by the reader's
    # byte-bounded memo store; the scan cache charges an allowance for
    # this — see scan_cache.windows_nbytes)
    memo_bytes: int = 0

    @property
    def names(self) -> list[str]:
        return list(self.columns.keys())


def _offset_span_ok(np_col: np.ndarray) -> bool:
    if not len(np_col):
        return True
    # strictly below INT32_MAX: the merge kernel reserves the max value as
    # its padding sentinel (ops/merge.py)
    return int(np_col.max()) - int(np_col.min()) < int(_INT32_MAX)


def _encode_offset(np_col: np.ndarray) -> tuple[np.ndarray, int]:
    lo = int(np_col.min()) if len(np_col) else 0
    return (np_col - lo).astype(np.int32), lo


def _dictionary_encode(np_col: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    # Codes must be order-preserving (code comparison == value
    # comparison — load-bearing for the device sort producing the same
    # order as the reference's arrow sort), i.e. the dictionary is
    # sorted.  SST columns usually arrive already PK-sorted, where the
    # uniques are just the run starts — three O(n) passes instead of
    # np.unique's argsort.
    if len(np_col) and bool(np.all(np_col[:-1] <= np_col[1:])):
        new_run = np.empty(len(np_col), dtype=bool)
        new_run[0] = True
        np.not_equal(np_col[1:], np_col[:-1], out=new_run[1:])
        codes = np.cumsum(new_run, dtype=np.int64) - 1
        dictionary = np_col[new_run]
    else:
        dictionary, codes = np.unique(np_col, return_inverse=True)
    # strictly below INT32_MAX: the merge kernel reserves the max int32 as
    # its padding sentinel, so the largest code must never equal it
    ensure(len(dictionary) < int(_INT32_MAX), "dictionary overflow")
    return codes.astype(np.int32), dictionary


def _dictionary_encode_arrow(col: pa.Array) -> tuple[np.ndarray, np.ndarray]:
    """Order-preserving dictionary codes via Arrow's C++ kernels.

    pyarrow's dictionary_encode assigns codes by first appearance; we
    re-rank them by sorted dictionary order so code comparison == value
    comparison (same contract as _dictionary_encode) without touching
    per-row Python objects.
    """
    dict_arr = pc.dictionary_encode(col)
    if isinstance(dict_arr, pa.ChunkedArray):
        dict_arr = dict_arr.combine_chunks()
    codes = dict_arr.indices.to_numpy(zero_copy_only=False)
    dictionary = dict_arr.dictionary.to_numpy(zero_copy_only=False)
    # see _dictionary_encode: max code must stay below the pad sentinel
    ensure(len(dictionary) < int(_INT32_MAX), "dictionary overflow")
    order = np.argsort(dictionary)  # sorts only the uniques
    rank = np.empty(len(order), dtype=np.int32)
    rank[order] = np.arange(len(order), dtype=np.int32)
    return rank[codes], dictionary[order]


def encode_column(col: pa.Array, name: str) -> tuple[np.ndarray, ColumnEncoding]:
    t = col.type
    if pa.types.is_floating(t):
        host = col.to_numpy(zero_copy_only=False)
        with np.errstate(over="ignore"):  # overflow handled below
            out = host.astype(np.float32)
        if host.dtype == np.float64:
            overflow = np.isinf(out) & np.isfinite(host)
            n = int(np.count_nonzero(overflow))
            if n:
                _ENCODE_OVERFLOW.inc(n)
                np.copyto(out, np.sign(host).astype(np.float32) * _F32_MAX,
                          where=overflow)
        return out, ColumnEncoding("numeric", t)
    if pa.types.is_integer(t):
        np_col = col.to_numpy(zero_copy_only=False)
        if np_col.dtype in (np.int8, np.int16, np.int32, np.uint8, np.uint16):
            return np_col.astype(np.int32), ColumnEncoding("numeric", t)
        # int64/uint64/uint32: shift to an epoch when the span fits int32
        # (timestamps — keeps device arithmetic), else rank-encode through
        # a sorted-unique dictionary (sequences — exact and ordered).
        ensure(len(np_col) == 0 or int(np_col.max()) <= 2**63 - 1,
               "u64 values beyond i64::MAX are not supported on device")
        np64 = np_col.astype(np.int64)
        if _offset_span_ok(np64):
            dev, epoch = _encode_offset(np64)
            return dev, ColumnEncoding("offset", t, epoch=epoch)
        codes, dictionary = _dictionary_encode(np64)
        return codes, ColumnEncoding("dict", t, dictionary=dictionary)
    if pa.types.is_string(t) or pa.types.is_large_string(t) or pa.types.is_binary(t):
        codes, dictionary = _dictionary_encode_arrow(col)
        return codes, ColumnEncoding("dict", t, dictionary=dictionary)
    raise Error(f"unsupported column type for device encoding: {name}: {t}")


def encode_batch(batch: pa.RecordBatch, capacity: Optional[int] = None,
                 device=None) -> DeviceBatch:
    """Encode an Arrow batch into a padded DeviceBatch.

    With `device` set each padded column is copied there (to_device);
    by default the columns stay numpy arrays for the caller to move.
    """
    n = batch.num_rows
    cap = capacity if capacity is not None else pad_capacity(n)
    ensure(cap >= n, f"capacity {cap} < rows {n}")
    columns = {}
    encodings = {}
    for name, col in zip(batch.schema.names, batch.columns):
        # No silent null-fill: a null turned into 0.0 would corrupt
        # min/count/avg downstream.  Null masks are not carried on device
        # yet, so reject at the boundary.
        ensure(col.null_count == 0,
               f"column {name!r} contains nulls; device encoding carries no "
               "null mask — drop or fill nulls before writing")
        dev, enc = encode_column(col, name)
        padded = pad_to(dev, cap)
        columns[name] = padded if device is None \
            else to_device(padded, device)
        encodings[name] = enc
    return DeviceBatch(columns=columns, encodings=encodings, n_valid=n, capacity=cap)


def _host(col) -> np.ndarray:
    return col if isinstance(col, np.ndarray) else col.cpu().numpy()


def decode_column(dev_col, enc: ColumnEncoding, n_valid: int) -> pa.Array:
    host = _host(dev_col)[:n_valid]
    if enc.kind == "numeric":
        return pa.array(host, type=enc.arrow_type).cast(enc.arrow_type)
    if enc.kind == "offset":
        return pa.array(host.astype(np.int64) + enc.epoch, type=enc.arrow_type)
    if enc.kind == "dict":
        if enc.dictionary.dtype == object:
            # string/binary: build a DictionaryArray (one C++ gather) and
            # cast instead of materializing Python objects per row
            dict_values = pa.array(enc.dictionary, type=enc.arrow_type)
            darr = pa.DictionaryArray.from_arrays(
                pa.array(host, type=pa.int32()), dict_values)
            return darr.cast(enc.arrow_type)
        return pa.array(enc.dictionary[host], type=enc.arrow_type)
    raise Error(f"unknown encoding kind: {enc.kind}")


def decode_to_arrow(batch: DeviceBatch, schema: Optional[pa.Schema] = None,
                    names: Optional[list[str]] = None) -> pa.RecordBatch:
    names = names if names is not None else batch.names
    arrays = [decode_column(batch.columns[n], batch.encodings[n], batch.n_valid)
              for n in names]
    if schema is not None:
        return pa.RecordBatch.from_arrays(arrays, schema=schema)
    return pa.RecordBatch.from_arrays(arrays, names=names)
