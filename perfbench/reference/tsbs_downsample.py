"""The plain reference of a TSBS downsample query, in numpy, from the
generated values that were handed to the ingest.

`values[h, t]` is one field of host `h` at tick `t` (`start_ms + t *
interval_ms`).  For a window [lo, lo + window_ms) and buckets of
`bucket_ms` counted from `lo`, a cell (h, b) holds the aggregates of
the host's samples whose time lies in bucket b: the mean, the max, the
min and the count.  An empty cell's mean is NaN, its max -inf and its
min +inf, as the engine gives them.

`precision="bfloat16"` computes the control: the same query with every
sample rounded to bfloat16 and the sums kept in float32, the step below
the float32 the engine's aggregates are held to."""

from __future__ import annotations

from typing import Optional

import numpy as np

AGGS = ("avg", "max", "min")
EMPTY = {"avg": np.nan, "max": -np.inf, "min": np.inf}


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
               start_ms: int, interval_ms: int, aggs: tuple = ("avg",),
               hosts: Optional[np.ndarray] = None,
               precision: str = "float64") -> dict:
    """{agg: grid} for each of `aggs` and always `count`, each of shape
    (hosts, buckets), in float64 (`count` int64).  `hosts` picks the
    rows, in its order; None is every host."""
    unknown = set(aggs) - set(AGGS)
    if unknown:
        raise ValueError(f"unknown aggregates {sorted(unknown)}")
    if precision not in ("float64", "bfloat16"):
        raise ValueError(f"unknown precision {precision!r}")
    if hosts is not None:
        values = values[hosts]
    rows, num_ticks = values.shape
    spans = bucket_ticks(lo, window_ms, bucket_ms, start_ms, interval_ms,
                         num_ticks)
    out = {a: np.full((rows, len(spans)), EMPTY[a]) for a in aggs}
    count = np.zeros((rows, len(spans)), dtype=np.int64)
    for b, (first, end) in enumerate(spans):
        if end <= first:
            continue
        block = values[:, first:end]
        if precision == "bfloat16":
            block = to_bfloat16(block)
        count[:, b] = end - first
        if "avg" in out:
            sums = block.sum(axis=1, dtype=np.float64
                             if precision == "float64" else np.float32)
            out["avg"][:, b] = sums / (end - first)
        if "max" in out:
            out["max"][:, b] = block.max(axis=1)
        if "min" in out:
            out["min"][:, b] = block.min(axis=1)
    out["count"] = count
    return out
