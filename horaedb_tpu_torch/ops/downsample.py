"""Time-bucketed downsampling as segmented reductions (PyTorch).

Counterpart of horaedb_tpu/ops/downsample.py.  The output is a dense
(num_groups, num_buckets) grid — group ids are dictionary codes, bucket
ids are (ts - range_start) // bucket_ms.

Split into partial grids and a finalize step so the fused reader can
fold partials of many windows into one accumulator before finalizing —
the identity elements (0, +/-inf, INT32_MIN) combine correctly, NaNs
would not.  Every partial grid comes out of ops.bucket_agg, whose CUDA
kernel serves tensors on the card and whose plain version serves CPU
tensors.
"""

from __future__ import annotations

import numpy as np

from horaedb_tpu_torch.ops import bucket_agg

ALL_AGGS = ("count", "sum", "min", "max", "avg", "last")


def canonical_which(which) -> tuple:
    which = tuple(sorted(set(which)))
    unknown = set(which) - set(ALL_AGGS)
    if unknown:
        raise ValueError(f"unknown aggregates {sorted(unknown)}; "
                         f"supported: {ALL_AGGS}")
    return which


def partial_aggregate(ts_offset, group_ids, values, n_valid, bucket_ms: int,
                      num_groups: int, num_buckets: int,
                      which: tuple = ALL_AGGS) -> dict:
    """Raw aggregate grids of one (capacity,) batch, all
    (num_groups, num_buckets): count, sum, min (+inf where empty), max
    (-inf where empty), last_ts (INT32_MIN where empty), last (0 where
    empty) — restricted to `which` plus dependencies."""
    which = canonical_which(which)
    out = bucket_agg.bucket_window_partials(
        ts_offset[None, :], group_ids[None, :], values[None, :], None, None,
        None, num_buckets, bucket_ms, num_groups=num_groups,
        width=num_buckets, which=which, n_valid=int(n_valid))
    return {k: v[0] for k, v in out.items()}


def window_local_partials(ts, gid_local, vals, remap, shift: int, lo: int,
                          total_buckets: int, bucket_ms: int, *,
                          num_groups: int, num_buckets: int,
                          which: tuple = ALL_AGGS) -> dict:
    """One window's partial grids over its LOCAL bucket range (see
    horaedb_tpu's window_local_partials for the argument contract);
    the fused reader calls bucket_agg.bucket_window_partials on a whole
    round of windows instead."""
    import torch

    dev = ts.device
    which = canonical_which(which)
    out = bucket_agg.bucket_window_partials(
        ts[None, :], gid_local[None, :], vals[None, :], remap[None, :],
        torch.tensor([shift], dtype=torch.int32, device=dev),
        torch.tensor([lo], dtype=torch.int32, device=dev), total_buckets,
        bucket_ms, num_groups=num_groups, width=num_buckets, which=which)
    return {k: v[0] for k, v in out.items()}


def combine_partial_pair(cur: dict, prev: dict) -> dict:
    """Pairwise combine of two partial-grid dicts over the SAME local
    bucket span — the associative op of the mesh scan's segmented
    time-axis reduction (parallel/scan.py mesh_run_partials).  `prev` is
    the EARLIER prefix; ties on last_ts keep `cur` (the later window
    wins, the host fold's `>=` take in storage/combine.py).  Exact for
    count while a cell's count stays < 2^24, for min/max/last (selection
    ops), and for sum only where one window contributes a cell — the
    dispatcher's gates keep anything else off the mesh.  Returns new
    tensors: neither input is written."""
    import torch

    out = {"count": cur["count"] + prev["count"]}
    if "sum" in cur:
        out["sum"] = cur["sum"] + prev["sum"]
    if "min" in cur:
        out["min"] = torch.minimum(cur["min"], prev["min"])
    if "max" in cur:
        out["max"] = torch.maximum(cur["max"], prev["max"])
    if "last" in cur:
        take_cur = cur["last_ts"] >= prev["last_ts"]
        out["last"] = torch.where(take_cur, cur["last"], prev["last"])
        out["last_ts"] = torch.where(take_cur, cur["last_ts"],
                                     prev["last_ts"])
    return out


def finalize_aggregate(partial: dict, which: tuple = ALL_AGGS) -> dict:
    """Combined partial grids -> user-facing aggregates.  Empty cells:
    count 0, sum 0, min +inf, max -inf, avg/last NaN."""
    import torch

    want = set(which) | {"count"}
    count = partial["count"]
    empty = count == 0
    nan = torch.full_like(count, float("nan"))
    out = {"count": count}
    if "sum" in partial and "sum" in want:
        out["sum"] = partial["sum"]
    if "sum" in partial and "avg" in want:
        out["avg"] = torch.where(empty, nan,
                                 partial["sum"] / count.clamp(min=1.0))
    if "min" in partial and "min" in want:
        out["min"] = partial["min"]
    if "max" in partial and "max" in want:
        out["max"] = partial["max"]
    if "last" in partial and "last" in want:
        out["last"] = torch.where(empty, nan, partial["last"])
    return out


def time_bucket_aggregate(ts_offset, group_ids, values, n_valid,
                          bucket_ms: int, num_groups: int, num_buckets: int,
                          which: tuple = ALL_AGGS,
                          device="cuda") -> dict:
    """Single-batch aggregate: partial + finalize.

    ts_offset: int32 (capacity,) offsets from the query range start;
    group_ids: int32 (capacity,) dictionary codes; values: float32
    (capacity,); rows [0, n_valid) real.  numpy inputs are copied to
    `device` (the card by default); tensors are used where they lie.
    Returns {agg: (num_groups, num_buckets) tensor} holding `count` plus
    the requested aggregates."""
    from horaedb_tpu_torch.ops.encode import to_device

    def dev(a, dtype):
        if isinstance(a, np.ndarray):
            return to_device(a.astype(dtype, copy=False), device)
        return a

    which = canonical_which(which)
    return finalize_aggregate(
        partial_aggregate(dev(ts_offset, np.int32), dev(group_ids, np.int32),
                          dev(values, np.float32), n_valid, bucket_ms,
                          num_groups, num_buckets, which=which),
        which=which)


def partials_from_numpy(grids: dict, device="cpu") -> dict:
    """A partial-grid dict of numpy arrays (e.g. the JAX package's
    results through np.asarray) -> the port's tensors on `device`."""
    import torch

    return {k: torch.from_numpy(np.array(v, copy=True)).to(
        device) for k, v in grids.items()}


def partials_to_numpy(grids: dict) -> dict:
    """Inverse of partials_from_numpy: tensors -> host numpy arrays,
    through the device profiler's download seam."""
    from horaedb_tpu_torch.common import deviceprof

    return {k: deviceprof.download(v) for k, v in grids.items()}
