"""The plain reference of a TSBS downsample query, in numpy, from the
generated values that were handed to the ingest.

`values[h, t]` is one field of host `h` at tick `t` (`start_ms + t *
interval_ms`).  For a window [lo, lo + window_ms) and buckets of
`bucket_ms` counted from `lo`, a cell (h, b) holds the mean and the
count of the host's samples whose time lies in bucket b.

`precision="bfloat16"` computes the control: the same query with every
sample rounded to bfloat16 and the sums kept in float32, the step below
the float32 the engine's aggregates are held to."""

from __future__ import annotations

import numpy as np


def to_bfloat16(x: np.ndarray) -> np.ndarray:
    """Round float32 values to bfloat16 (nearest, ties to even), kept
    in float32."""
    u = x.astype(np.float32).view(np.uint32)
    u = (u + (((u >> 16) & 1) + 0x7FFF)) & np.uint32(0xFFFF0000)
    return u.view(np.float32)


def bucket_ticks(lo: int, window_ms: int, bucket_ms: int, start_ms: int,
                 interval_ms: int, num_ticks: int) -> list:
    """[first, end) tick of each bucket of the window."""
    out = []
    for b in range(-(-window_ms // bucket_ms)):
        b_lo = lo + b * bucket_ms
        b_hi = min(lo + window_ms, b_lo + bucket_ms)
        first = -(-(b_lo - start_ms) // interval_ms)
        end = -(-(b_hi - start_ms) // interval_ms)
        out.append((min(max(first, 0), num_ticks),
                    min(max(end, 0), num_ticks)))
    return out


def downsample(values: np.ndarray, lo: int, window_ms: int, bucket_ms: int,
               start_ms: int, interval_ms: int,
               precision: str = "float64") -> tuple:
    """(avg, count), each of shape (hosts, buckets); an empty cell's
    mean is NaN."""
    hosts, num_ticks = values.shape
    spans = bucket_ticks(lo, window_ms, bucket_ms, start_ms, interval_ms,
                         num_ticks)
    avg = np.full((hosts, len(spans)), np.nan)
    count = np.zeros((hosts, len(spans)), dtype=np.int64)
    for b, (first, end) in enumerate(spans):
        if end <= first:
            continue
        block = values[:, first:end]
        if precision == "float64":
            sums = block.sum(axis=1, dtype=np.float64)
        elif precision == "bfloat16":
            sums = to_bfloat16(block).sum(axis=1, dtype=np.float32)
        else:
            raise ValueError(f"unknown precision {precision!r}")
        count[:, b] = end - first
        avg[:, b] = sums / (end - first)
    return avg, count
