"""Time-bucket window partials: the hand-written CUDA kernel
(csrc/bucket_agg.cu) and its plain PyTorch version.

Counterpart of horaedb_tpu/ops/pallas_kernels.py.  One call computes the
partial grids of W windows at once — the window prologue of
ops.downsample.window_local_partials (remap, shift, total-bucket drop,
lo rebase) fused with the segmented aggregate — so a fused aggregate
round is one launch.

`bucket_window_partials` dispatches on where its tensors lie: CUDA
tensors launch the kernel (or raise), CPU tensors take
`bucket_window_partials_plain`.  There is no fallback from one to the
other.  The kernel builds with nvcc at first use into
horaedb_tpu_torch/build/ and binds through ctypes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

from horaedb_tpu_torch.common.error import Error, ensure

_F32_MAX = float(np.finfo(np.float32).max)
_I32_MIN = -(2**31)

# accumulator fields in output order; `which` selects a subset
FIELDS = ("count", "sum", "min", "max", "last_ts", "last")
_FIELD_BITS = {"sum": 2, "min": 4, "max": 8, "last": 16}

_HERE = os.path.dirname(os.path.abspath(__file__))
_PKG = os.path.dirname(_HERE)
SOURCE = os.path.join(_PKG, "csrc", "bucket_agg.cu")
BUILD_DIR = os.path.join(_PKG, "build")

# launches of the kernel, counted by the wrapper where it launches and
# nowhere else (the plain version does not count)
LAUNCHES = {"bucket_window_partials": 0}

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
    """Build output for the current source (keyed by its content, so an
    edited source rebuilds)."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"libbucket_agg_{digest}.so")


def nvcc_command(out_path: str) -> list:
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if not os.path.exists(nvcc):
        nvcc = "nvcc"
    return [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            "-Xptxas", "-v", "-o", out_path, SOURCE]


def build(verbose: bool = False) -> str:
    """Compile the kernel (if this source's library is not built yet)
    and return the library path.  The compiler's report (registers,
    spills) is returned in verbose mode through build_log()."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.run(nvcc_command(tmp), capture_output=True, text=True)
    if proc.returncode != 0:
        raise Error(f"nvcc failed for {SOURCE}:\n{proc.stderr}")
    os.replace(tmp, path)
    _BUILD_LOG["text"] = proc.stderr
    if verbose:
        print(proc.stderr)
    return path


_BUILD_LOG = {"text": ""}


def build_log() -> str:
    return _BUILD_LOG["text"]


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            fn = lib.horaedb_bucket_window_partials
            P, I = ctypes.c_void_p, ctypes.c_int
            fn.argtypes = [P, P, P, P, I, P, P, I, I, I, I, I, I, I, I,
                           P, P, P, P, P, P, P, P]
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
    conventions.  CUDA tensors launch the kernel; CPU tensors run the
    plain version."""
    import torch

    if ts.device.type == "cpu":
        return bucket_window_partials_plain(
            ts, gid_local, vals, remap, shift, lo, total_buckets, bucket_ms,
            num_groups=num_groups, width=width, which=which,
            n_valid=n_valid)
    ensure(ts.device.type == "cuda",
           f"bucket_window_partials runs on cuda or cpu, not {ts.device}")
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
    ensure(W * num_groups * width < 2**31, "grid too large")
    n_valid = cap if n_valid is None else max(0, min(int(n_valid), cap))
    fields = fields_for(which)
    mask = 1
    for f, bit in _FIELD_BITS.items():
        if f in fields:
            mask |= bit
    shape = (W, num_groups, width)
    out = {}
    for f in fields:
        out[f] = torch.empty(shape, dtype=torch.int32 if f == "last_ts"
                             else torch.float32, device=dev)
    key = (torch.empty(shape, dtype=torch.int64, device=dev)
           if "last" in fields else None)
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.horaedb_bucket_window_partials(
            ptr(ts), ptr(gid_local), ptr(vals), ptr(remap), remap_len,
            ptr(shift), ptr(lo), W, cap, n_valid, num_groups, width,
            int(total_buckets), int(bucket_ms), mask, ptr(out["count"]),
            ptr(out.get("sum")), ptr(out.get("min")), ptr(out.get("max")),
            ptr(out.get("last")), ptr(out.get("last_ts")), ptr(key), stream)
    if rc != 0:
        raise Error(f"bucket_window_partials launch failed: cudaError {rc}")
    LAUNCHES["bucket_window_partials"] += 1
    return out


def _floor_div(a, b: int):
    import torch

    return torch.div(a, b, rounding_mode="floor")


def bucket_window_partials_plain(ts, gid_local, vals, remap, shift, lo,
                                 total_buckets: int, bucket_ms: int, *,
                                 num_groups: int, width: int, which: tuple,
                                 n_valid: Optional[int] = None) -> dict:
    """Plain PyTorch version of the kernel (same signature and outputs),
    mirroring horaedb_tpu's window_local_partials -> partial_aggregate:
    segment sum/min/max into a grid with one overflow cell per window,
    and a two-pass `last` (max ts per cell, then max row at that ts)."""
    import torch

    W, cap = ts.shape
    dev = ts.device
    i32 = torch.int32
    n_valid = cap if n_valid is None else max(0, min(int(n_valid), cap))
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
    iota = torch.arange(cap, dtype=torch.int64, device=dev)
    in_grid = ((iota < n_valid)[None, :] & (bucket >= 0) & (bucket < width)
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
