"""Time-bucket aggregate of a round of windows: the hand-written CUDA
kernel (csrc/bucket_agg.cu) and its plain PyTorch versions.

Counterpart of horaedb_tpu/ops/pallas_kernels.py and of the XLA program
horaedb_tpu/storage/read.py::_fused_round_accumulate_jit.  One kernel
source, one accumulate core (the window prologue of
ops.downsample.window_local_partials — remap, shift, total-bucket drop,
lo rebase — fused with the segmented aggregate), two entries:

- `bucket_window_partials`: the partial grids of W windows,
  (W, num_groups, width) per field, the same bytes on every launch: its
  sum is an integer sum of per-cell fixed-point images, so it does not
  depend on the order of the atomics (see csrc/bucket_agg.cu).
- `bucket_round_accumulate`: the same rows folded straight into the
  query-global accumulator of storage.read.fused_acc_init, in place; no
  partial grid is written.  Its sum is the same ordered integer sum over
  the round's rows, added to the accumulator with one float add per
  cell, so a query's grids are the same bytes on every run (the fused
  replay's contract).

Each entry dispatches on where its tensors lie: CUDA tensors launch the
kernel (or raise), CPU tensors take the entry's plain version.  There is
no fallback from one to the other.  The kernel builds with nvcc at first
use into horaedb_tpu_torch/build/ and binds through ctypes.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

import numpy as np

from horaedb_tpu_torch.common.error import Error, ensure
from horaedb_tpu_torch.ops import nvcc

_F32_MAX = float(np.finfo(np.float32).max)
_I32_MIN = -(2**31)

# accumulator fields in output order; `which` selects a subset
FIELDS = ("count", "sum", "min", "max", "last_ts", "last")
_FIELD_BITS = {"sum": 2, "min": 4, "max": 8, "last": 16}

SOURCE = os.path.join(nvcc.CSRC, "bucket_agg.cu")
BUILD_DIR = nvcc.BUILD_DIR

# launches of the kernel, counted by each entry's wrapper where it
# launches and nowhere else (the plain versions do not count)
LAUNCHES = {"bucket_window_partials": 0, "bucket_round_accumulate": 0}

_lib = None
_lib_lock = threading.Lock()


def fields_for(which) -> tuple:
    """Partial-grid fields for an aggregate set, dependencies included:
    avg needs sum, last needs last_ts, count always rides along."""
    want = set(which)
    if "avg" in want:
        want.add("sum")
    if "last" in want:
        want.add("last_ts")
    want.add("count")
    return tuple(f for f in FIELDS if f in want)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def library_path() -> str:
    return nvcc.library_path(SOURCE)


def nvcc_command(out_path: str) -> list:
    return nvcc.nvcc_command(SOURCE, out_path)


def build() -> str:
    """Compile the kernel unless this source's library is built; return
    the library path (the compiler's report: build_log())."""
    return nvcc.build(SOURCE)


def build_log() -> str:
    return nvcc.build_log(SOURCE)


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            P, I = ctypes.c_void_p, ctypes.c_int
            fn = lib.horaedb_bucket_window_partials
            fn.argtypes = [P, P, P, P, I, P, P, I, I, I, I, I, I, I, I,
                           P, P, P, P, P, P, P, I, P, P, P, I, P]
            fn.restype = I
            fn = lib.horaedb_bucket_round_accumulate
            fn.argtypes = [P, P, P, P, I, P, P, P, I, I, I, I, I, I, I, I,
                           P, P, P, P, P, P, P, I, I, I, I, P]
            fn.restype = I
            _lib = lib
        return _lib


def _check(name: str, t, dtype, shape: tuple, device) -> None:
    import torch

    ensure(isinstance(t, torch.Tensor), f"{name} must be a tensor")
    ensure(t.dtype == dtype, f"{name} must be {dtype}, got {t.dtype}")
    ensure(tuple(t.shape) == shape,
           f"{name} must have shape {shape}, got {tuple(t.shape)}")
    ensure(t.device == device, f"{name} is on {t.device}, expected {device}")
    ensure(t.is_contiguous(), f"{name} must be contiguous")


def _check_round(entry: str, ts, gid_local, vals, remap, shift, lo,
                 bucket_ms: int, num_groups: int, width: int) -> tuple:
    """Checks shared by both entries on a CUDA round; returns
    (W, cap, remap_len)."""
    import torch

    ensure(ts.device.type == "cuda",
           f"{entry} runs on cuda or cpu, not {ts.device}")
    dev = ts.device
    ensure(ts.dim() == 2, "ts must be (windows, capacity)")
    W, cap = ts.shape
    _check("ts", ts, torch.int32, (W, cap), dev)
    _check("gid_local", gid_local, torch.int32, (W, cap), dev)
    _check("vals", vals, torch.float32, (W, cap), dev)
    remap_len = 0
    if remap is not None:
        ensure(remap.dim() == 2 and remap.shape[0] == W and remap.shape[1] > 0,
               "remap must be (windows, R>0)")
        remap_len = int(remap.shape[1])
        _check("remap", remap, torch.int32, (W, remap_len), dev)
    for name, t in (("shift", shift), ("lo", lo)):
        if t is not None:
            _check(name, t, torch.int32, (W,), dev)
    ensure(bucket_ms > 0, "bucket_ms must be positive")
    ensure(num_groups >= 0 and width >= 0, "negative grid extent")
    # the `last` key packs w * cap + row + 1 into 32 bits
    ensure(W * cap < 2**32 - 1, "round too large for the `last` key")
    return W, cap, remap_len


def _field_mask(fields: tuple) -> int:
    mask = 1
    for f, bit in _FIELD_BITS.items():
        if f in fields:
            mask |= bit
    return mask


def _ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


def bucket_window_partials(ts, gid_local, vals, remap, shift, lo,
                           total_buckets: int, bucket_ms: int, *,
                           num_groups: int, width: int, which: tuple,
                           n_valid: Optional[int] = None) -> dict:
    """Partial grids of W windows: {field: (W, num_groups, width)}.

    ts, gid_local: int32 (W, cap); vals: float32 (W, cap); remap: int32
    (W, R) local code -> union group row, or None for the identity (gids
    pass through and are range-checked); shift, lo: int32 (W,) or None
    for zeros.  Rows at or past `n_valid` (default cap) are dropped, as
    are rows whose query-global bucket reaches `total_buckets`.  See
    csrc/bucket_agg.cu for the arithmetic and the empty-cell
    conventions.  On the card every field, the sum included, is the
    same bytes on every launch for the same input (the ordered sum).
    CUDA tensors launch the kernel; CPU tensors run the plain version."""
    if ts.device.type == "cpu":
        return bucket_window_partials_plain(
            ts, gid_local, vals, remap, shift, lo, total_buckets, bucket_ms,
            num_groups=num_groups, width=width, which=which,
            n_valid=n_valid)
    return _launch_partials(ts, gid_local, vals, remap, shift, lo,
                            total_buckets, bucket_ms, num_groups=num_groups,
                            width=width, which=which, n_valid=n_valid,
                            ordered=True)


def _sum_bits(cell_rows: int) -> int:
    """B of the ordered sum: each value enters as an int64 of at most
    2^B in magnitude, and a cell takes at most `cell_rows` rows (a
    window's n_valid for partials, W x max_rows for a round), so
    cell_rows * 2^B < 2^62."""
    return 62 - max(1, int(cell_rows)).bit_length()


def _launch_partials(ts, gid_local, vals, remap, shift, lo,
                     total_buckets: int, bucket_ms: int, *, num_groups: int,
                     width: int, which: tuple, n_valid: Optional[int],
                     ordered: bool) -> dict:
    """The partial-grid kernel on CUDA tensors.  `ordered` False keeps
    the one-pass float atomicAdd sum, whose bytes vary from launch to
    launch; only chip_smoke.py asks for it, to time it beside the
    ordered sum."""
    import torch

    W, cap, remap_len = _check_round(
        "bucket_window_partials", ts, gid_local, vals, remap, shift, lo,
        bucket_ms, num_groups, width)
    dev = ts.device
    ensure(W * num_groups * width < 2**31, "grid too large")
    n_valid = cap if n_valid is None else max(0, min(int(n_valid), cap))
    fields = fields_for(which)
    shape = (W, num_groups, width)
    out = {}
    for f in fields:
        out[f] = torch.empty(shape, dtype=torch.int32 if f == "last_ts"
                             else torch.float32, device=dev)
    key = (torch.empty(shape, dtype=torch.int64, device=dev)
           if "last" in fields else None)
    ordered = ordered and "sum" in fields
    ex = sp = isum = None
    if ordered:
        ex = torch.empty(shape, dtype=torch.int32, device=dev)
        sp = torch.empty(shape, dtype=torch.int32, device=dev)
        isum = torch.empty(shape, dtype=torch.int64, device=dev)
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.horaedb_bucket_window_partials(
            _ptr(ts), _ptr(gid_local), _ptr(vals), _ptr(remap), remap_len,
            _ptr(shift), _ptr(lo), W, cap, n_valid, num_groups, width,
            int(total_buckets), int(bucket_ms), _field_mask(fields),
            _ptr(out["count"]), _ptr(out.get("sum")), _ptr(out.get("min")),
            _ptr(out.get("max")), _ptr(out.get("last")),
            _ptr(out.get("last_ts")), _ptr(key), int(ordered), _ptr(ex),
            _ptr(sp), _ptr(isum), _sum_bits(n_valid), stream)
    if rc != 0:
        raise Error(f"bucket_window_partials launch failed: cudaError {rc}")
    LAUNCHES["bucket_window_partials"] += 1
    return out


def _round_columns(lo_host, n_valid_host, width: int,
                  total_buckets: int) -> tuple:
    """Accumulator columns [c0, c1) a round can touch: the union of its
    non-empty windows' [lo, lo + width), cut at total_buckets."""
    lo_h = np.asarray(lo_host, dtype=np.int64)
    if n_valid_host is not None:
        lo_h = lo_h[np.asarray(n_valid_host) > 0]
    if not len(lo_h):
        return 0, 0
    c0 = int(max(0, lo_h.min()))
    c1 = int(min(total_buckets, lo_h.max() + width))
    return c0, max(c0, c1)


def bucket_round_accumulate(acc: dict, ts, gid_local, vals, remap, shift,
                            lo, total_buckets: int, bucket_ms: int, *,
                            num_groups: int, width: int, which: tuple,
                            n_valid=None, lo_host=None,
                            n_valid_host=None) -> dict:
    """Fold one round of W windows straight into the query-global
    accumulator `acc` (storage.read.fused_acc_init's grids, each
    (num_groups, total_buckets)), in place, and return it.

    Window d's rows land at accumulator column lo[d] + b; columns at or
    past `total_buckets` are dropped.  count/sum add, min/max fold, and
    `last` takes the round's value where its range-relative ts is >=
    the accumulator's (later windows, then later rounds, win ties) —
    the semantics of the JAX package's _fused_round_accumulate_jit.
    On the card the round's sum is the ordered integer sum of its rows,
    added with one float add per cell: the same bytes on every launch.
    n_valid: int32 (W,) rows per window, or None for all `cap` rows.
    lo_host / n_valid_host: host copies of lo / n_valid (numpy); they
    bound the grid and the scratch to the round's rows and columns
    without a device read, so n_valid_host comes with n_valid or not at
    all.  CUDA tensors launch the kernel (one launch counted per round);
    CPU tensors run the plain version."""
    ensure(n_valid_host is None or n_valid is not None,
           "n_valid_host needs the n_valid it copies")
    if ts.device.type == "cpu":
        return bucket_round_accumulate_plain(
            acc, ts, gid_local, vals, remap, shift, lo, total_buckets,
            bucket_ms, num_groups=num_groups, width=width, which=which,
            n_valid=n_valid, lo_host=lo_host)
    return _launch_round(acc, ts, gid_local, vals, remap, shift, lo,
                         total_buckets, bucket_ms, num_groups=num_groups,
                         width=width, which=which, n_valid=n_valid,
                         lo_host=lo_host, n_valid_host=n_valid_host,
                         ordered=True)


def _launch_round(acc: dict, ts, gid_local, vals, remap, shift, lo,
                  total_buckets: int, bucket_ms: int, *, num_groups: int,
                  width: int, which: tuple, n_valid, lo_host, n_valid_host,
                  ordered: bool) -> dict:
    """The round kernel on CUDA tensors.  `ordered` False keeps the
    one-pass float atomicAdd sum, whose bytes vary from launch to
    launch; only chip_smoke.py asks for it, to count its byte patterns
    and time it beside the ordered sum."""
    import torch

    W, cap, remap_len = _check_round(
        "bucket_round_accumulate", ts, gid_local, vals, remap, shift, lo,
        bucket_ms, num_groups, width)
    dev = ts.device
    total = int(total_buckets)
    ensure(num_groups * total < 2**31, "accumulator too large")
    fields = fields_for(which)
    for f in fields:
        ensure(f in acc, f"accumulator lacks field {f!r}")
        _check(f"acc[{f!r}]", acc[f], torch.int32 if f == "last_ts"
               else torch.float32, (num_groups, total), dev)
    max_rows = cap
    if n_valid is not None:
        _check("n_valid", n_valid, torch.int32, (W,), dev)
        if n_valid_host is not None:
            max_rows = int(np.clip(np.asarray(n_valid_host), 0, cap).max(
                initial=0))
    if lo_host is not None:
        ensure(int(np.asarray(lo_host).min(initial=0)) >= 0,
               "lo must be non-negative")
        c0, c1 = _round_columns(lo_host, n_valid_host, width, total)
    else:
        c0, c1 = 0, total
    ordered = ordered and "sum" in fields
    # int64 scratch cells over the round's columns: the `last` keys, and
    # the ordered sum's int64 sums + int32 exponent images and flags
    per_cell = ("last" in fields) + 2 * ordered
    scratch = (torch.empty(per_cell * num_groups * (c1 - c0),
                           dtype=torch.int64, device=dev)
               if per_cell and c1 > c0 else None)
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.horaedb_bucket_round_accumulate(
            _ptr(ts), _ptr(gid_local), _ptr(vals), _ptr(remap), remap_len,
            _ptr(shift), _ptr(lo), _ptr(n_valid), W, cap, max_rows,
            num_groups, width, total, int(bucket_ms), _field_mask(fields),
            _ptr(acc["count"]), _ptr(acc.get("sum")), _ptr(acc.get("min")),
            _ptr(acc.get("max")), _ptr(acc.get("last")),
            _ptr(acc.get("last_ts")), _ptr(scratch), c0, c1 - c0,
            int(ordered), _sum_bits(W * max_rows), stream)
    if rc != 0:
        raise Error(f"bucket_round_accumulate launch failed: cudaError {rc}")
    LAUNCHES["bucket_round_accumulate"] += 1
    return acc


def _floor_div(a, b: int):
    import torch

    return torch.div(a, b, rounding_mode="floor")


def bucket_window_partials_plain(ts, gid_local, vals, remap, shift, lo,
                                 total_buckets: int, bucket_ms: int, *,
                                 num_groups: int, width: int, which: tuple,
                                 n_valid=None) -> dict:
    """Plain PyTorch version of the kernel (same signature and outputs),
    mirroring horaedb_tpu's window_local_partials -> partial_aggregate:
    segment sum/min/max into a grid with one overflow cell per window,
    and a two-pass `last` (max ts per cell, then max row at that ts).
    n_valid may also be an int32 (W,) tensor of rows per window."""
    import torch

    W, cap = ts.shape
    dev = ts.device
    i32 = torch.int32
    iota = torch.arange(cap, dtype=torch.int64, device=dev)
    if isinstance(n_valid, torch.Tensor):
        valid = iota[None, :] < n_valid.to(dev, torch.int64)[:, None]
    else:
        n_valid = cap if n_valid is None else max(0, min(int(n_valid), cap))
        valid = (iota < n_valid)[None, :]
    g = gid_local
    if remap is not None:
        idx = gid_local.clamp(0, remap.shape[1] - 1).long()
        g = torch.where(gid_local >= 0, torch.gather(remap, 1, idx),
                        torch.full_like(gid_local, -1))
    zeros = torch.zeros(W, dtype=i32, device=dev)
    sh = (shift if shift is not None else zeros).to(i32)[:, None]
    lo_w = (lo if lo is not None else zeros).to(i32)[:, None]
    # int32 arithmetic wraps exactly like the JAX package's jnp int32
    ts_global = ts + sh
    g = torch.where(_floor_div(ts_global, bucket_ms) < total_buckets, g,
                    torch.full_like(g, -1))
    ts_local = ts_global - lo_w * bucket_ms
    bucket = _floor_div(ts_local, bucket_ms)
    in_grid = (valid & (bucket >= 0) & (bucket < width)
               & (g >= 0) & (g < num_groups))
    ncell = num_groups * width
    seg = torch.where(in_grid, g.long() * width + bucket.long(),
                      torch.full_like(bucket, ncell, dtype=torch.int64))
    flat = (torch.arange(W, device=dev, dtype=torch.int64)[:, None]
            * (ncell + 1) + seg).reshape(-1)
    size = W * (ncell + 1)

    def grid(a):
        return a.reshape(W, ncell + 1)[:, :ncell].reshape(
            W, num_groups, width).contiguous()

    fields = fields_for(which)
    v = vals.reshape(-1)
    m = in_grid.reshape(-1)
    out = {"count": grid(torch.zeros(size, dtype=torch.float32, device=dev)
                         .index_add_(0, flat, m.to(torch.float32)))}
    if "sum" in fields:
        out["sum"] = grid(torch.zeros(size, dtype=torch.float32, device=dev)
                          .index_add_(0, flat, torch.where(
                              m, v, torch.zeros_like(v))))
    if "min" in fields:
        out["min"] = grid(torch.full((size,), float("inf"), device=dev)
                          .scatter_reduce_(0, flat, torch.where(
                              m, v, torch.full_like(v, _F32_MAX)), "amin"))
    if "max" in fields:
        out["max"] = grid(torch.full((size,), float("-inf"), device=dev)
                          .scatter_reduce_(0, flat, torch.where(
                              m, v, torch.full_like(v, -_F32_MAX)), "amax"))
    if "last" in fields:
        tl = ts_local.reshape(-1)
        tmax = torch.full((size,), _I32_MIN, dtype=i32, device=dev) \
            .scatter_reduce_(0, flat, torch.where(
                m, tl, torch.full_like(tl, _I32_MIN)), "amax")
        at_max = m & (tl == tmax[flat])
        rows = iota.repeat(W)
        last_row = torch.full((size,), -1, dtype=torch.int64, device=dev) \
            .scatter_reduce_(0, flat, torch.where(
                at_max, rows, torch.full_like(rows, -1)), "amax")
        win_base = (torch.arange(size, device=dev) // (ncell + 1)) * cap
        pick = v[(win_base + last_row.clamp(0, cap - 1)).clamp(
            0, max(0, v.numel() - 1))] if v.numel() else \
            torch.zeros(size, device=dev)
        out["last"] = grid(torch.where(last_row >= 0, pick,
                                       torch.zeros_like(pick)))
        out["last_ts"] = grid(tmax)
    return {f: out[f] for f in fields}


def fold_window_partials(acc: dict, p: dict, lo_host, total_buckets: int,
                         bucket_ms: int, width: int) -> dict:
    """Scatter W window partial grids into the query-global accumulator,
    in place: a slice update per window, in window order — count/sum
    add, min/max fold, and `last` takes the window's value where its
    range-relative ts is >= the accumulator's (the later window wins
    ties)."""
    import torch

    for d in range(p["count"].shape[0]):
        c0 = int(lo_host[d])
        n = min(width, total_buckets - c0)
        if n <= 0:
            continue
        cols = slice(c0, c0 + n)
        acc["count"][:, cols] += p["count"][d, :, :n]
        if "sum" in acc:
            acc["sum"][:, cols] += p["sum"][d, :, :n]
        if "min" in acc:
            acc["min"][:, cols] = torch.minimum(acc["min"][:, cols],
                                                p["min"][d, :, :n])
        if "max" in acc:
            acc["max"][:, cols] = torch.maximum(acc["max"][:, cols],
                                                p["max"][d, :, :n])
        if "last" in acc:
            cur_ts = acc["last_ts"][:, cols]
            cur_last = acc["last"][:, cols]
            win_has = p["count"][d, :, :n] > 0
            win_ts = torch.where(win_has,
                                 p["last_ts"][d, :, :n] + c0 * bucket_ms,
                                 torch.full_like(cur_ts, _I32_MIN))
            take = win_has & (win_ts >= cur_ts)
            acc["last"][:, cols] = torch.where(take, p["last"][d, :, :n],
                                               cur_last)
            acc["last_ts"][:, cols] = torch.where(take, win_ts, cur_ts)
    return acc


def bucket_round_accumulate_plain(acc: dict, ts, gid_local, vals, remap,
                                  shift, lo, total_buckets: int,
                                  bucket_ms: int, *, num_groups: int,
                                  width: int, which: tuple, n_valid=None,
                                  lo_host=None) -> dict:
    """Plain PyTorch version of bucket_round_accumulate: the round's
    partial grids (bucket_window_partials_plain), then the per-window
    slice updates of fold_window_partials."""
    p = bucket_window_partials_plain(
        ts, gid_local, vals, remap, shift, lo, total_buckets, bucket_ms,
        num_groups=num_groups, width=width, which=which, n_valid=n_valid)
    if lo_host is None:
        lo_host = (lo.cpu().numpy() if lo is not None
                   else np.zeros(ts.shape[0], np.int32))
    return fold_window_partials(acc, p, lo_host, total_buckets, bucket_ms,
                                width)
