"""Range-vector functions over downsample grids (rate / increase /
delta); the port's copy of the JAX package's metric_engine/functions.py.

They operate on the (series, bucket) grids query_downsample returns.
Pure numpy: the grids are tiny compared to the scanned data, so this is
frontend work, not device work.

Counter semantics follow Prometheus: `increase` sums positive deltas
(counter resets — a drop in value — contribute the post-reset value),
`rate` is increase per second, `delta` is the raw last-first difference
for gauges.
"""

from __future__ import annotations

import numpy as np


def _per_bucket_last(aggs: dict) -> np.ndarray:
    last = aggs["last"]
    if hasattr(last, "cpu"):  # a fused-path grid: a tensor on its device
        last = last.cpu().numpy()
    return np.asarray(last, dtype=np.float64)


def delta(aggs: dict, bucket_ms: int) -> np.ndarray:
    """Gauge delta per bucket: last(bucket) - last(previous bucket).
    First bucket and buckets following an empty bucket are NaN."""
    last = _per_bucket_last(aggs)
    out = np.full_like(last, np.nan)
    out[:, 1:] = last[:, 1:] - last[:, :-1]
    return out


def increase(aggs: dict, bucket_ms: int) -> np.ndarray:
    """Counter increase per bucket, reset-aware: last - prev_last,
    except on a counter reset (value dropped), where the post-reset
    value itself is the increase.  NaN where either side is empty."""
    last = _per_bucket_last(aggs)
    out = np.full_like(last, np.nan)
    prev = last[:, :-1]
    cur = last[:, 1:]
    raw = cur - prev
    out[:, 1:] = np.where(np.isnan(prev) | np.isnan(cur), np.nan,
                          np.where(raw >= 0, raw, cur))
    return out


def rate(aggs: dict, bucket_ms: int) -> np.ndarray:
    """Counter rate per second per bucket (increase / bucket seconds)."""
    return increase(aggs, bucket_ms) / (bucket_ms / 1000.0)
