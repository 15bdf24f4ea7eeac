"""Device merge: the variadic lexicographic sort and the k-way merge of
presorted runs that the device decode (ops/device_decode.py) uses to
bring a segment's rows to (pk, seq, row) order on the card.

Counterpart of horaedb_tpu/ops/merge.py's `lex_sort`,
`kway_merge_perm` / `_kway_merge_perm_impl` and `runs_lex_sorted_np`.

- `lex_sort` is torch code: stable sorts from the last key to the
  first, so equal keys keep their row order (lax.sort with the row
  index as the final key).
- `kway_merge_perm` is the hand-written CUDA kernel of
  csrc/merge_path.cu (one launch per level of a pairwise merge tree,
  each pair of blocks cut into shared-memory tiles) on a CUDA tensor
  and its plain version, `kway_merge_perm_plain`, on a CPU tensor; any
  other device raises.  There is no fallback from one to the other.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import threading

import numpy as np

from horaedb_tpu_torch.common import deviceprof
from horaedb_tpu_torch.common.error import Error, ensure
from horaedb_tpu_torch.ops import nvcc

SOURCE = os.path.join(nvcc.CSRC, "merge_path.cu")
# the kernel's static limits and tile (csrc/merge_path.cu MAX_KEYS,
# MAX_RUNS, THREADS, ITEMS, TILE): a block of THREADS threads merges a
# tile of TILE output slots, ITEMS a thread
MAX_KEYS = 16
MAX_RUNS = 128
THREADS = 128
ITEMS = 4
TILE = THREADS * ITEMS

# launches of the kernel (one per merge level), counted by the wrapper
# where it launches and nowhere else
LAUNCHES = {"kway_merge_perm": 0}

_lib = None
_lib_lock = threading.Lock()


def reset_launches() -> None:
    LAUNCHES["kway_merge_perm"] = 0


def build() -> str:
    return nvcc.build(SOURCE)


def build_log() -> str:
    return nvcc.build_log(SOURCE)


def _load():
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            P, I = ctypes.c_void_p, ctypes.c_int
            fn = lib.horaedb_kway_merge_level
            fn.argtypes = [P, I, P, I, I, I, I, P, P, P]
            fn.restype = I
            _lib = lib
        return _lib


def lex_sort(operands: tuple, num_keys: int) -> tuple:
    """Sort every operand by the first `num_keys` lexicographically; rows
    with equal keys keep their order.  A stable torch.sort per key, from
    the last key to the first."""
    import torch

    n = operands[0].shape[0]
    perm = torch.arange(n, device=operands[0].device)
    for k in reversed(range(num_keys)):
        perm = perm[torch.sort(operands[k][perm], stable=True).indices]
    return tuple(op[perm] for op in operands)


def _check_merge(keys: tuple, run_offsets, num_runs: int):
    import torch

    ensure(len(keys) > 0, "kway_merge_perm needs a key column")
    dev = keys[0].device
    cap = keys[0].shape[0]
    ensure(num_runs >= 1 and num_runs & (num_runs - 1) == 0,
           f"num_runs must be a power of two, got {num_runs}")
    for i, k in enumerate(keys):
        ensure(isinstance(k, torch.Tensor) and k.dtype == torch.int32
               and tuple(k.shape) == (cap,) and k.device == dev,
               f"key {i} must be int32 ({cap},) on {dev}")
    ensure(isinstance(run_offsets, torch.Tensor)
           and run_offsets.dtype == torch.int32
           and tuple(run_offsets.shape) == (num_runs + 1,)
           and run_offsets.device == dev,
           f"run_offsets must be int32 ({num_runs + 1},) on {dev}")
    return dev, cap


@deviceprof.seam(name="kway_merge_perm", static=("num_runs",))
def kway_merge_perm(keys: tuple, run_offsets, *, num_runs: int,
                    n_valid: int):
    """Permutation that stably merges `num_runs` presorted runs.

    keys: int32 (cap,) tensors in compare-priority order; the rows of
    run r, [run_offsets[r], run_offsets[r + 1]), are sorted by them.
    run_offsets: int32 (num_runs + 1,), non-decreasing, the last entry
    cap; num_runs a power of two, empty runs allowed.  Returns perm
    int32 (cap,): gathering by perm gives the stable sort by (pad,
    keys..., row) with pad = row >= n_valid, so padding rows sink.  CUDA
    tensors launch the kernel, log2(num_runs) launches; CPU tensors run
    kway_merge_perm_plain."""
    import torch

    dev, cap = _check_merge(keys, run_offsets, num_runs)
    if dev.type == "cpu":
        return kway_merge_perm_plain(keys, run_offsets, num_runs=num_runs,
                                     n_valid=n_valid)
    ensure(dev.type == "cuda",
           f"kway_merge_perm runs on cuda or cpu, not {dev}")
    ensure(len(keys) <= MAX_KEYS and num_runs <= MAX_RUNS,
           f"kway_merge_perm takes at most {MAX_KEYS} keys and "
           f"{MAX_RUNS} runs")
    n_valid = max(0, min(int(n_valid), cap))
    for k in keys:
        ensure(k.is_contiguous(), "key columns must be contiguous")
    offs = run_offsets.contiguous()
    if num_runs == 1:
        return torch.arange(cap, dtype=torch.int32, device=dev)
    lib = _load()
    key_ptrs = (ctypes.c_void_p * len(keys))(*[k.data_ptr() for k in keys])
    # each level writes the row of one scratch tensor that the level
    # before did not; the last level's row is returned
    bufs = torch.empty((2, cap), dtype=torch.int32, device=dev).unbind()
    current = torch.cuda.current_device()
    idx = current if dev.index is None else dev.index
    src = None
    level = 1
    with (contextlib.nullcontext() if idx == current
          else torch.cuda.device(idx)):
        stream = torch.cuda.current_stream(idx).cuda_stream
        while level < num_runs:
            dst = bufs[0] if src is not bufs[0] else bufs[1]
            rc = lib.horaedb_kway_merge_level(
                key_ptrs, len(keys), offs.data_ptr(), num_runs, cap, n_valid,
                level, None if src is None else src.data_ptr(),
                dst.data_ptr(), stream)
            if rc != 0:
                raise Error(f"kway_merge_perm launch failed: cudaError {rc}")
            LAUNCHES["kway_merge_perm"] += 1
            deviceprof.note_launch("kway_merge_perm")
            src = dst
            level *= 2
    return src


def kway_merge_perm_plain(keys: tuple, run_offsets, *, num_runs: int,
                          n_valid: int):
    """Plain PyTorch version of kway_merge_perm: the JAX package's level
    loop (_kway_merge_perm_impl) with the pad bit as the first key, a
    fixed-step lexicographic binary search per slot, and a scatter
    through the level's permutation (unique indices, deterministic)."""
    import torch

    dev = keys[0].device
    cap = keys[0].shape[0]
    iota = torch.arange(cap, dtype=torch.int64, device=dev)
    offs = run_offsets.to(torch.int64)
    run_of = (torch.searchsorted(offs, iota, right=True) - 1).clamp(
        0, num_runs - 1)
    cols = ((iota >= int(n_valid)).to(torch.int32),) + tuple(keys)
    perm = iota
    n_steps = max(1, cap - 1).bit_length() + 1
    level = 1
    while level < num_runs:
        ks = [c[perm] for c in cols]  # keys in block-sorted order
        base = 2 * level * ((run_of[perm] // level) // 2)
        start, mid, end = offs[base], offs[base + level], offs[base + 2 * level]
        in_a = iota < mid
        lo = torch.where(in_a, mid, start)
        hi = torch.where(in_a, end, mid)
        for _ in range(n_steps):
            active = lo < hi
            probe = torch.div(lo + hi, 2, rounding_mode="floor").clamp(
                0, cap - 1)
            lt = torch.zeros(cap, dtype=torch.bool, device=dev)
            eq = torch.ones(cap, dtype=torch.bool, device=dev)
            for k in ks:
                p = k[probe]
                lt = lt | (eq & (p < k))
                eq = eq & (p == k)
            go = active & torch.where(in_a, lt, lt | eq)
            lo = torch.where(go, probe + 1, lo)
            hi = torch.where(go | ~active, hi, probe)
        new_slot = torch.where(in_a, iota + (lo - mid), (iota - mid) + lo)
        perm = torch.empty_like(perm).index_put_((new_slot,), perm)
        level *= 2
    return perm.to(torch.int32)


def runs_lex_sorted_np(key_cols: list, offsets) -> bool:
    """Host-side admission check for `kway_merge_perm`: every run is
    individually lex-sorted by `key_cols` (numpy arrays).  O(n) per key
    column — the per-run twin of the whole-segment sortedness probe."""
    for a, b in zip(offsets[:-1], offsets[1:]):
        if b - a <= 1:
            continue
        later = np.zeros(b - a - 1, dtype=bool)
        for col in key_cols:
            seg = np.asarray(col[a:b])
            cur, nxt = seg[:-1], seg[1:]
            if ((cur > nxt) & ~later).any():
                return False
            later = later | (cur < nxt)
    return True


# ---------------------------------------------------------------------------
# device merge-dedup (horaedb_tpu/ops/merge.py _merge_dedup_impl and
# _dedup_presorted_impl): the device_sort layout and the 1-D segment
# mesh's shard-local merge rounds (parallel/scan.sharded_merge_dedup)
# ---------------------------------------------------------------------------

_PAD_SENTINEL = 2**31 - 1


def sorted_run_starts(pk_cols: tuple, valid):
    """Boolean mask of primary-key run starts over sorted columns: rows
    i and i-1 are in one run iff every PK column is equal.  Padding
    rows never start a run."""
    import torch

    neq = torch.zeros(valid.shape, dtype=torch.bool, device=valid.device)
    for col in pk_cols:
        neq = neq | (col != torch.roll(col, 1))
    first = torch.zeros_like(neq)
    first[0] = True
    return (first | neq) & valid


def _last_of_runs(run_starts, valid, cap: int):
    """(gather_idx, num_runs): the position of each run's LAST row in
    run order (the JAX package's segment_max over masked row indices),
    0 past the last run as there.  Written with one scatter through
    unique indices (the discard slot aside), so it is deterministic."""
    import torch

    dev = valid.device
    iota = torch.arange(cap, dtype=torch.int64, device=dev)
    run_ids = torch.cumsum(run_starts.to(torch.int64), 0) - 1
    num_runs = run_starts.to(torch.int32).sum()
    nxt_start = torch.ones(cap, dtype=torch.bool, device=dev)
    nxt_start[:-1] = run_starts[1:] | ~valid[1:]
    is_last = valid & nxt_start
    buf = torch.zeros(cap + 1, dtype=torch.int64, device=dev)
    buf.scatter_(0, torch.where(is_last, run_ids,
                                torch.full_like(run_ids, cap)), iota)
    return buf[:cap], num_runs


def _n_valid_mask(n_valid, cap: int, dev):
    import torch

    iota = torch.arange(cap, dtype=torch.int64, device=dev)
    if isinstance(n_valid, torch.Tensor):
        return iota < n_valid.to(dev, torch.int64).reshape(())
    return iota < int(n_valid)


def merge_dedup_last(pk_cols: tuple, seq, value_cols: tuple, n_valid,
                     seq_in_row_order: bool = False):
    """Sort + dedup, keeping the last-by-sequence row per primary key.

    pk_cols: int32 (capacity,) tensors in schema order; seq: int32;
    value_cols: carried columns of any dtype; n_valid: real rows (an int
    or a 0-/1-element tensor).  `seq_in_row_order` only when seq is
    non-decreasing with the row index: the stable PK sort then already
    puts the highest-seq row last in each run.  Returns (out_pk_cols,
    out_seq, out_value_cols, out_valid_mask, num_runs): sorted by PK,
    padded to capacity, the first num_runs rows valid."""
    import torch

    cols = tuple(pk_cols) + (seq,) + tuple(value_cols)
    num_pks = len(pk_cols)
    num_keys = num_pks + (0 if seq_in_row_order else 1)
    cap = cols[0].shape[0]
    dev = cols[0].device
    iota = torch.arange(cap, dtype=torch.int32, device=dev)
    valid = _n_valid_mask(n_valid, cap, dev)
    # sort only the keys plus a row index; padding sorts last through
    # the int32 max sentinel, and the row index keeps the sort stable
    sentinel = torch.full((cap,), _PAD_SENTINEL, dtype=torch.int32,
                          device=dev)
    keys = tuple(torch.where(valid, c, sentinel) for c in cols[:num_keys])
    sorted_all = lex_sort(keys + (iota,), num_keys=num_keys)
    sorted_keys, perm = sorted_all[:-1], sorted_all[-1].long()
    sorted_valid = _n_valid_mask(n_valid, cap, dev)[perm]
    run_starts = sorted_run_starts(sorted_keys[:num_pks], sorted_valid)
    gather_idx, num_runs = _last_of_runs(run_starts, sorted_valid, cap)
    src_rows = perm[gather_idx]
    out_cols = tuple(c[src_rows] for c in cols)
    out_valid = iota < num_runs
    return (out_cols[:num_pks], out_cols[num_pks], out_cols[num_pks + 1:],
            out_valid, num_runs)


def dedup_sorted_last(pk_cols: tuple, seq, value_cols: tuple, n_valid,
                      perm=None):
    """Dedup WITHOUT a device sort: rows are already (or, after `perm`,
    become) sorted by PK with the preferred row of each run last.  One
    gather, the run mask and the segmented last-select.  Returns what
    merge_dedup_last returns."""
    import torch

    cols = tuple(pk_cols) + (seq,) + tuple(value_cols)
    num_pks = len(pk_cols)
    cap = cols[0].shape[0]
    dev = cols[0].device
    if perm is not None:
        p = perm.long()
        cols = tuple(c[p] for c in cols)
    valid = _n_valid_mask(n_valid, cap, dev)
    run_starts = sorted_run_starts(cols[:num_pks], valid)
    gather_idx, num_runs = _last_of_runs(run_starts, valid, cap)
    out_cols = tuple(c[gather_idx] for c in cols)
    out_valid = torch.arange(cap, dtype=torch.int32, device=dev) < num_runs
    return (out_cols[:num_pks], out_cols[num_pks], out_cols[num_pks + 1:],
            out_valid, num_runs)


# Which merge strategy a scan's windows take (storage/read.py):
#   host_perm   — the host plans the k-way merge permutation and keeps
#                 the last row per PK run in numpy; the default;
#   device_sort — windows merge on the device with merge_dedup_last (on
#                 the 1-D segment mesh: shard-local merge rounds); kept
#                 for A/B runs, as in the JAX package.
_MERGE_IMPLS = ("host_perm", "device_sort")
_merge_impl = "host_perm"


def set_merge_impl(name: str) -> None:
    global _merge_impl
    if name not in _MERGE_IMPLS:
        raise ValueError(f"unknown merge impl {name!r}; "
                         f"expected one of {_MERGE_IMPLS}")
    _merge_impl = name


def merge_impl() -> str:
    return _merge_impl


set_merge_impl(os.environ.get("HORAEDB_MERGE_IMPL", "host_perm"))
