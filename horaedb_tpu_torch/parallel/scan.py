"""Mesh scan programs over the segment mesh and the 2-D scan mesh
(PyTorch port of horaedb_tpu/parallel/scan.py).

The JAX package compiles each program as one `shard_map` over a mesh
and lets XLA run the collectives.  Here a program is a plain function
run by one controller process: it runs the per-shard body on each
slot's device (under that device's context, on its current stream) and
carries each collective out as explicit copies plus a reduction in a
FIXED RANK ORDER, so a result's bytes never depend on the order in
which copies arrive:

  psum / pmin / pmax   a fold over the shards' tensors in rank order on
                       rank 0's device; every shard receives the result
                       (t.to(device): no copy where the device repeats);
  ppermute             t.to(devices[dst]) per the permutation, ordered
                       against the producing stream by torch's
                       cross-device copy.

No program synchronizes the card: the only syncs are the downloads the
JAX package's reader makes too.  A program never writes its inputs, and
the state updates that the JAX package donates (mesh_score_update,
mesh_additive_update) write only into their state, which mesh_*_init
allocates per series block — slots that share a device share input
tensors (shard_time_axis uploads once per device) but never a tensor
that is written.

Data layout: a `ShardedArray` holds one block per mesh slot (a tensor
on that slot's device, leading axis kept) for a global array split over
some mesh axes and replicated over the rest.  The per-shard bodies take
block [0]; a leading block axis larger than one (more rows than mesh
slots) raises, as the JAX package does at trace time.

Row-bound arguments (`n_valid`) are host ints or host int arrays where
the kernels take them so (ops/bucket_agg.py, ops/merge.py): the kernels'
launch geometry is a host decision, and reading it from the card would
be a sync.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import numpy as np

from horaedb_tpu_torch.common import deviceprof
from horaedb_tpu_torch.common.error import Error, ensure
from horaedb_tpu_torch.ops import bucket_agg, downsample
from horaedb_tpu_torch.ops import merge as merge_ops
from horaedb_tpu_torch.ops.topk import (pair_add, pair_max_normalized,
                                        top_k_groups)
from horaedb_tpu_torch.parallel.mesh import (SEGMENT_AXIS, SERIES_AXIS,
                                             TIME_AXIS, Mesh)

_F32_MAX = float(np.finfo(np.float32).max)
_TS_MIN = -(2**31)


def on_device(dev):
    """The context a slot's body runs under: the slot's card (so its
    launches go to that card's current stream); nothing on the CPU."""
    if dev.type == "cuda":
        import torch

        return torch.cuda.device(dev)
    return contextlib.nullcontext()


class ShardedArray:
    """A global array split over `spec` (mesh axis names, one per split
    leading dim) and replicated over the other axes: `blocks[i]` is mesh
    slot i's block, a tensor on mesh.devices[i] (None on replica slots a
    program did not fill).  `numpy()` assembles the global array on the
    host; `row(t)` only the global leading index t."""

    def __init__(self, mesh: Mesh, blocks: list, spec: tuple,
                 shape: tuple) -> None:
        ensure(len(blocks) == mesh.size, "one block per mesh slot")
        self.mesh = mesh
        self.blocks = blocks
        self.spec = tuple(spec)
        self.shape = tuple(shape)

    @property
    def nbytes(self) -> int:
        b = next(x for x in self.blocks if x is not None)
        per = int(b.element_size())
        n = 1
        for s in self.shape:
            n *= int(s)
        return n * per

    def _owner(self, split_index: tuple) -> int:
        """Flat slot of the replica-0 block at the split coordinates."""
        idx = []
        it = iter(split_index)
        for a in self.mesh.axis_names:
            idx.append(next(it) if a in self.spec else 0)
        return self.mesh.slot(*idx)

    def block(self, *split_index: int):
        return self.blocks[self._owner(split_index)]

    def row(self, t: int, timed: bool = True) -> np.ndarray:
        """Global leading index `t` on the host (the download of one
        slot's rows; split series blocks concatenate along the next
        axis).  `timed` as deviceprof.download takes it."""
        lead = self.mesh.shape[self.spec[0]]
        per = self.shape[0] // lead
        ti, r = divmod(int(t), per)
        if len(self.spec) == 1:
            return deviceprof.download(self.block(ti)[r], timed)
        ser = self.mesh.shape[self.spec[1]]
        return np.concatenate(
            [deviceprof.download(self.block(ti, s)[r], timed)
             for s in range(ser)], axis=0)

    def numpy(self) -> np.ndarray:
        return np.stack([self.row(t) for t in range(self.shape[0])]) \
            if self.shape[0] else np.zeros(self.shape)


def _place(mesh: Mesh, arr, spec: tuple) -> ShardedArray:
    """Place a host array (numpy or a host tensor) split over the first
    mesh axis named in `spec` and replicated over the others: one upload
    per distinct device, of the span of rows its slots need, each slot
    taking a view of its own rows (slots naming one device share it)."""
    import torch

    if isinstance(arr, ShardedArray):
        return arr
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    arr = np.asarray(arr)
    axis = spec[0]
    n = mesh.shape[axis]
    ensure(arr.ndim >= 1 and arr.shape[0] % n == 0,
           f"leading axis {arr.shape[0] if arr.ndim else 0} does not "
           f"split over the {n}-slot {axis!r} axis")
    k = arr.shape[0] // n
    ax_pos = mesh.axis_names.index(axis)
    index = [mesh.coords(slot)[ax_pos] for slot in range(mesh.size)]
    span: dict = {}
    for dev, i in zip(mesh.devices, index):
        lo, hi = span.get(dev, (i, i))
        span[dev] = (min(lo, i), max(hi, i))
    uploaded = {dev: deviceprof.device_put(arr[lo * k:(hi + 1) * k], dev)
                for dev, (lo, hi) in span.items()}
    blocks = [uploaded[dev][(i - span[dev][0]) * k:
                            (i - span[dev][0] + 1) * k]
              for dev, i in zip(mesh.devices, index)]
    return ShardedArray(mesh, blocks, (axis,), arr.shape)


def stack_time_axis(mesh: Mesh, rows: list, cap: int,
                    dtype) -> ShardedArray:
    """The (time, cap) matrix whose slot t holds `rows[t]` zero-padded
    to `cap` (slots past len(rows) all zero), placed as shard_time_axis
    places it, but assembled on each device: every slot's real rows
    upload straight into a zeroed device block, so no host stack is
    built and no padding crosses the bus.  The whole assembly, the
    blocks' allocation included, is charged as one h2d transfer of the
    real rows' bytes."""
    import torch

    t0 = time.perf_counter()
    n = mesh.shape[TIME_AXIS]
    ax_pos = mesh.axis_names.index(TIME_AXIS)
    index = [mesh.coords(slot)[ax_pos] for slot in range(mesh.size)]
    span: dict = {}
    for dev, i in zip(mesh.devices, index):
        lo, hi = span.get(dev, (i, i))
        span[dev] = (min(lo, i), max(hi, i))
    tdtype = torch.from_numpy(np.zeros(0, dtype=dtype)).dtype
    placed = {}
    nbytes = 0
    for dev, (lo, hi) in span.items():
        blk = torch.zeros((hi - lo + 1, cap), dtype=tdtype, device=dev)
        for t in range(lo, min(hi + 1, len(rows))):
            if len(rows[t]):
                src = torch.from_numpy(np.ascontiguousarray(rows[t]))
                blk[t - lo, :len(src)].copy_(src)
                nbytes += int(src.nbytes)
        placed[dev] = blk
    blocks = [placed[dev][i - span[dev][0]:i - span[dev][0] + 1]
              for dev, i in zip(mesh.devices, index)]
    out = ShardedArray(mesh, blocks, (TIME_AXIS,), (n, cap))
    deviceprof.charge_transfer("h2d", nbytes,
                               seconds=time.perf_counter() - t0)
    return out


def shard_leading_axis(mesh: Mesh, arr) -> ShardedArray:
    """Place an (n_devices * k, ...) host array sharded over the segment
    axis."""
    return _place(mesh, arr, (SEGMENT_AXIS,))


def shard_time_axis(mesh: Mesh, arr) -> ShardedArray:
    """Place a (time * k, ...) host array sharded over the scan mesh's
    time axis, replicated over series: series shards re-aggregate every
    row for their own group block (the series axis divides resident grid
    STATE and combine egress, not row work)."""
    return _place(mesh, arr, (TIME_AXIS,))


def _scalar(x) -> int:
    """A replicated scalar argument (int, numpy or a host tensor) as a
    host int."""
    return int(np.asarray(x).reshape(-1)[0]) if not isinstance(x, int) \
        else x


def _check_block_is_one(block) -> None:
    """The shard bodies index block [0]; a leading axis larger than the
    mesh would silently drop segments."""
    if block.shape[0] != 1:
        raise Error(
            f"leading axis {block.shape[0]} exceeds the mesh: stack exactly "
            "one segment batch per device (pad the device axis, or scan in "
            "rounds)")


# ---- collectives in fixed rank order ------------------------------------


def _reduce(tensors: list, op) -> "object":
    """Fold shard tensors in rank order on rank 0's device."""
    dev = tensors[0].device
    acc = tensors[0]
    for t in tensors[1:]:
        acc = op(acc, t.to(dev))
    return acc


def _combine_partials(ps: list, ranks: Optional[list] = None) -> dict:
    """Cross-shard combination of partial aggregate grids (psum of
    count and sum, pmin/pmax of min and max).  `last` goes to the shard
    holding the latest timestamp; a tie goes to the higher rank.  The
    result lives on rank 0's device."""
    import torch

    out = {"count": _reduce([p["count"] for p in ps], torch.add)}
    if "sum" in ps[0]:
        out["sum"] = _reduce([p["sum"] for p in ps], torch.add)
    if "min" in ps[0]:
        out["min"] = _reduce([p["min"] for p in ps], torch.minimum)
    if "max" in ps[0]:
        out["max"] = _reduce([p["max"] for p in ps], torch.maximum)
    if "last" in ps[0]:
        dev = ps[0]["count"].device
        ranks = list(range(len(ps))) if ranks is None else ranks
        g_last_ts = _reduce([p["last_ts"] for p in ps], torch.maximum)
        elig = [p["last_ts"].to(dev) == g_last_ts for p in ps]
        g_rank = _reduce([torch.where(e, torch.full_like(g_last_ts, r),
                                      torch.full_like(g_last_ts, -1))
                          for e, r in zip(elig, ranks)], torch.maximum)
        out["last"] = _reduce(
            [torch.where(e & (g_rank == r), p["last"].to(dev),
                         torch.zeros_like(p["last"].to(dev)))
             for e, r, p in zip(elig, ranks, ps)], torch.add)
        out["last_ts"] = g_last_ts
    return out


def _finalize_topk(combined: dict, k: int):
    import torch

    final = downsample.finalize_aggregate(combined)
    scores = torch.amax(torch.where(final["count"] > 0, final["max"],
                                    torch.full_like(final["max"],
                                                    float("-inf"))), dim=1)
    top_vals, top_idx = top_k_groups(scores.to(torch.float32), k=k)
    return final, top_vals, top_idx


def _shard_partial(ts, gid, vals, n_valid: int, bucket_ms: int, *,
                   num_groups: int, num_buckets: int) -> dict:
    """Per-shard prelude of the downsample programs: one window's
    partial grids from its (1, capacity) block (rows past n_valid and
    buckets past num_buckets dropped)."""
    _check_block_is_one(ts)
    return {k: v[0] for k, v in bucket_agg.bucket_window_partials(
        ts, gid, vals, None, None, None, num_buckets, bucket_ms,
        num_groups=num_groups, width=num_buckets,
        which=downsample.ALL_AGGS, n_valid=int(n_valid)).items()}


def sharded_downsample_query(mesh: Mesh, *, num_groups: int,
                             num_buckets: int, k: int):
    """The multi-slot downsample + top-k query.

    Returns fn(ts, gid, vals, n_valid, bucket_ms): the first three
    (n_devices, capacity) int32/int32/float32 arrays sharded on the
    leading axis (ShardedArray or host arrays, placed here), n_valid
    (n_devices,) int32 host rows per shard, bucket_ms a scalar.  Output:
    (finalized (num_groups, num_buckets) grids, top-k values, top-k
    group indices), on rank 0's device."""

    def fn(ts, gid, vals, n_valid, bucket_ms):
        ts, gid, vals = (shard_leading_axis(mesh, a)
                         for a in (ts, gid, vals))
        nv = _host_rows(n_valid, mesh.size)
        bms = _scalar(bucket_ms)
        ps = []
        for i, dev in enumerate(mesh.devices):
            with on_device(dev):
                ps.append(_shard_partial(
                    ts.blocks[i], gid.blocks[i], vals.blocks[i], nv[i],
                    bms, num_groups=num_groups, num_buckets=num_buckets))
        return _finalize_topk(_combine_partials(ps), k)

    return deviceprof.seam(fn, name="sharded_downsample_query")


def _host_rows(n_valid, n: int) -> np.ndarray:
    """Per-shard row counts as a host array: a ShardedArray's blocks are
    downloaded (its caller built it from host rows)."""
    if isinstance(n_valid, ShardedArray):
        n_valid = n_valid.numpy()
    out = np.asarray(n_valid).reshape(-1)
    ensure(out.shape[0] >= n, "n_valid needs one entry per shard")
    if out.shape[0] > n:
        raise Error(
            f"leading axis {out.shape[0] // n} exceeds the mesh: stack "
            "exactly one segment batch per device (pad the device axis, "
            "or scan in rounds)")
    return out


def sharded_remap_partials(mesh: Mesh, *, num_groups: int,
                           num_buckets: int,
                           which: tuple = downsample.ALL_AGGS):
    """Batched multi-slot partial aggregation with the per-window group
    remap: each slot remaps its window's local dense group ids into the
    round's union space, shifts timestamps into query-range offsets and
    aggregates a window-LOCAL grid (num_buckets wide, from the window's
    `lo` bucket) with the hand kernel bucket_window_partials.  Per-slot
    grids come back as (n_devices, G, B) ShardedArrays for the host's
    float64 fold.

    fn(ts, gid, vals, remap, shift, lo, total_buckets, bucket_ms,
       n_valid=None): ts/gid/vals (n_devices, capacity), remap
    (n_devices, num_groups), shift/lo (n_devices,), all sharded on the
    leading axis; total_buckets and bucket_ms scalars; n_valid the host
    row bound of the round (the kernel's ordered-sum bound, as the
    single-device round passes it; default the capacity)."""

    def fn(ts, gid, vals, remap, shift, lo, total, bucket_ms,
           n_valid: Optional[int] = None):
        ts, gid, vals, remap, shift, lo = (
            shard_leading_axis(mesh, a)
            for a in (ts, gid, vals, remap, shift, lo))
        tot, bms = _scalar(total), _scalar(bucket_ms)
        outs: dict = {}
        for i, dev in enumerate(mesh.devices):
            _check_block_is_one(ts.blocks[i])
            with on_device(dev):
                p = bucket_agg.bucket_window_partials(
                    ts.blocks[i], gid.blocks[i], vals.blocks[i],
                    remap.blocks[i], shift.blocks[i], lo.blocks[i], tot,
                    bms, num_groups=num_groups, width=num_buckets,
                    which=which, n_valid=n_valid)
            for kk, v in p.items():
                outs.setdefault(kk, []).append(v)
        return {kk: ShardedArray(mesh, v, (SEGMENT_AXIS,),
                                 (mesh.size, num_groups, num_buckets))
                for kk, v in outs.items()}

    return deviceprof.seam(fn, name="sharded_remap_partials")


def sharded_merge_dedup(mesh: Mesh, *, num_pks: int):
    """The multi-slot merge-dedup: segments are the shard axis and dedup
    is segment-scoped, so this is shard-local merge_dedup_last with NO
    collectives.  fn(pks, seq, values, n_valid) over (n_devices,
    capacity) arrays sharded on the leading axis; n_valid (n_devices,)
    host rows.  Outputs keep the sharded layout, plus a per-shard
    (n_devices,) run count."""
    del num_pks  # the tuple arity fixes it

    def fn(pks, seq, values, n_valid):
        pks = tuple(shard_leading_axis(mesh, a) for a in pks)
        seq = shard_leading_axis(mesh, seq)
        values = tuple(shard_leading_axis(mesh, a) for a in values)
        nv = _host_rows(n_valid, mesh.size)
        cap = seq.shape[1]
        out_pk = [[] for _ in pks]
        out_val = [[] for _ in values]
        out_seq, out_valid, runs = [], [], []
        for i, dev in enumerate(mesh.devices):
            _check_block_is_one(seq.blocks[i])
            with on_device(dev):
                o_pk, o_seq, o_val, o_valid, n_runs = \
                    merge_ops.merge_dedup_last(
                        tuple(c.blocks[i][0] for c in pks),
                        seq.blocks[i][0],
                        tuple(v.blocks[i][0] for v in values), int(nv[i]))
            for lst, c in zip(out_pk, o_pk):
                lst.append(c[None])
            for lst, c in zip(out_val, o_val):
                lst.append(c[None])
            out_seq.append(o_seq[None])
            out_valid.append(o_valid[None])
            runs.append(n_runs.reshape(1))
        shape = (mesh.size, cap)

        def sh(blocks, s=shape):
            return ShardedArray(mesh, blocks, (SEGMENT_AXIS,), s)

        return (tuple(sh(b) for b in out_pk), sh(out_seq),
                tuple(sh(b) for b in out_val), sh(out_valid),
                sh(runs, (mesh.size,)))

    return deviceprof.seam(fn, name="sharded_merge[merge_dedup_last]")


# ---------------------------------------------------------------------------
# the 2-D (time, series) scan mesh ([scan.mesh])
# ---------------------------------------------------------------------------


def _series_block(num_groups: int, series_n: int) -> int:
    if num_groups % series_n:
        raise Error(
            f"mesh group space {num_groups} not divisible by the "
            f"series axis ({series_n}) — pad g to a multiple")
    return num_groups // series_n


def _series_slice(p: dict, j: int, gb: int) -> dict:
    """Full-width compute, series-block slice AFTER: every cell's
    accumulation is the single-device kernel's; only the resident state
    and the combine payload shrink to the (gb, width) block."""
    return {k: v[j * gb:(j + 1) * gb] for k, v in p.items()}


def _segmented_time_combine(mesh: Mesh, states: list, seg_ids) -> list:
    """Inclusive SEGMENTED scan over the time axis in log2(time)
    ppermute steps: a slot folds in its left neighbour's prefix ONLY
    when it belongs to the same segment (seg id match; slots with no
    left neighbour keep their state).  `states[slot]` are the per-slot
    (gb, width) grids, `seg_ids` the time-sharded (time,) ids.  Every
    step builds new tensors from the previous step's (value semantics:
    a slot's prefix is never written through an alias).  Shared by the
    host-window and the decode round programs: the combine IS the byte
    identity surface."""
    import torch

    time_n = mesh.shape[TIME_AXIS]
    series_n = mesh.shape[SERIES_AXIS]
    sid = [seg_ids.blocks[s].reshape(-1)[:1] for s in range(mesh.size)]
    step = 1
    while step < time_n:
        new = list(states)
        for t in range(step, time_n):
            for s in range(series_n):
                dst = mesh.slot(t, s)
                src = mesh.slot(t - step, s)
                dev = mesh.devices[dst]
                with on_device(dev):
                    prev = {k: v.to(dev) for k, v in states[src].items()}
                    ok = sid[src].to(dev) == sid[dst]
                    combined = downsample.combine_partial_pair(states[dst],
                                                               prev)
                    new[dst] = {k: torch.where(ok, combined[k],
                                               states[dst][k])
                                for k in states[dst]}
        states = new
        step *= 2
    return states


def _grid_output(mesh: Mesh, states: list, num_groups: int,
                 width: int) -> dict:
    time_n = mesh.shape[TIME_AXIS]
    return {k: ShardedArray(mesh, [st[k][None] for st in states],
                            (TIME_AXIS, SERIES_AXIS),
                            (time_n, num_groups, width))
            for k in states[0]}


def mesh_run_partials(mesh: Mesh, *, num_groups: int, num_buckets: int,
                      which: tuple):
    """The 2-D mesh scan program: per-window partial grids sharded
    (time = one merge window per slot, series = group blocks) and a
    SEGMENTED reduction over the time axis — same-segment slots combine
    into per-run grids, different segments never mix.

    fn(ts, gid, vals, remap, shift, lo, seg_ids, total, bucket_ms,
       n_valid=None):
      ts/gid/vals: (time, capacity) sharded on the time axis;
      remap: (time, num_groups) int32 — window-local code -> round row;
      shift/lo: (time,) int32 per-window epoch offset / first bucket;
      seg_ids: (time,) int32 — slots of one segment share an id and are
        CONSECUTIVE; padding slots carry unique negative ids;
      total, bucket_ms: scalars; n_valid: the round's host row bound
        (the kernel's ordered-sum bound, as the single-device round
        passes it).

    Output: dict of (time, num_groups, num_buckets) ShardedArrays split
    (time, series); slot t holds the combined grids of its segment's
    slots up to t, so a run's TAIL slot holds the whole run — the
    reader downloads tails only.

    Exactness: each window's partials come from the SAME full-width
    kernel launch shape as the single-device round and are block-sliced
    per series shard after; the combine is exact for count (below
    2^24), min/max/last (selection, later slot wins ties) and for sum
    exactly when no cell has two contributing windows (the reader's
    gates)."""
    series_n = mesh.shape[SERIES_AXIS]
    gb = _series_block(num_groups, series_n)

    def fn(ts, gid, vals, remap, shift, lo, seg_ids, total, bucket_ms,
           n_valid: Optional[int] = None):
        ts, gid, vals, remap, shift, lo, seg_ids = (
            shard_time_axis(mesh, a)
            for a in (ts, gid, vals, remap, shift, lo, seg_ids))
        tot, bms = _scalar(total), _scalar(bucket_ms)
        states = []
        for i, dev in enumerate(mesh.devices):
            _check_block_is_one(ts.blocks[i])
            j = mesh.coords(i)[1]
            with on_device(dev):
                p = bucket_agg.bucket_window_partials(
                    ts.blocks[i], gid.blocks[i], vals.blocks[i],
                    remap.blocks[i], shift.blocks[i], lo.blocks[i], tot,
                    bms, num_groups=num_groups, width=num_buckets,
                    which=which, n_valid=n_valid)
                states.append(_series_slice({k: v[0] for k, v in p.items()},
                                            j, gb))
        states = _segmented_time_combine(mesh, states, seg_ids)
        return _grid_output(mesh, states, num_groups, num_buckets)

    return deviceprof.seam(fn, name="mesh_run_partials")


def mesh_decode_partials(mesh: Mesh, *, num_groups: int, num_buckets: int,
                         which: tuple, key_slots: tuple, num_pks: int,
                         group_pos: int, ts_pos: int, val_slot: int,
                         leaf_prog: tuple, route: str, num_runs: int):
    """The mesh-placed decode round: each time slot starts from its
    segment's raw encoded sidecar columns and runs leaf filter → (k-way
    merge | sort | presorted) → keep-last dedup
    (device_decode.decode_rows_core, whose k-way route launches
    kway_merge_perm) → bucket_window_partials → the segmented combine.

    fn(cols, n_valid, leaf_consts, run_offsets, shift, lo, seg_ids,
       total, bucket_ms):
      cols: tuple of (time, capacity) int32 encoded columns (the value
        column float32), sharded on the time axis;
      n_valid: (time,) host int rows per slot (suffix is padding);
      leaf_consts: tuple of (time, L_i) int32 leaf-constant stacks;
      run_offsets: (time, num_runs + 1) int32 per-slot run bounds;
      shift/lo/seg_ids: (time,) int32 as in mesh_run_partials;
      total, bucket_ms: scalars.

    Slot-local group codes ARE the round rows (identity remap).
    Output: (grids, kept) — grids as in mesh_run_partials, kept a
    (time,) ShardedArray of post-dedup survivor counts."""
    import torch

    from horaedb_tpu_torch.ops import device_decode

    series_n = mesh.shape[SERIES_AXIS]
    time_n = mesh.shape[TIME_AXIS]
    gb = _series_block(num_groups, series_n)

    def fn(cols, n_valid, leaf_consts, run_offsets, shift, lo, seg_ids,
           total, bucket_ms):
        cols = tuple(shard_time_axis(mesh, c) for c in cols)
        leaf_consts = tuple(shard_time_axis(mesh, c) for c in leaf_consts)
        run_offsets, shift, lo, seg_ids = (
            shard_time_axis(mesh, a)
            for a in (run_offsets, shift, lo, seg_ids))
        nv = _host_rows(n_valid, time_n)
        tot, bms = _scalar(total), _scalar(bucket_ms)
        states, kept = [], []
        for i, dev in enumerate(mesh.devices):
            _check_block_is_one(cols[0].blocks[i])
            t, j = mesh.coords(i)
            n_t = int(nv[t])
            with on_device(dev):
                keys_s, gid, val_s, n_rows = device_decode.decode_rows_core(
                    tuple(c.blocks[i][0] for c in cols), n_t,
                    tuple(c.blocks[i][0] for c in leaf_consts),
                    run_offsets.blocks[i][0], key_slots=key_slots,
                    num_pks=num_pks, group_pos=group_pos,
                    val_slot=val_slot, leaf_prog=leaf_prog, route=route,
                    num_runs=num_runs)
                remap = torch.arange(num_groups, dtype=torch.int32,
                                     device=dev)[None]
                p = bucket_agg.bucket_window_partials(
                    keys_s[ts_pos][None], gid[None], val_s[None], remap,
                    shift.blocks[i], lo.blocks[i], tot, bms,
                    num_groups=num_groups, width=num_buckets, which=which,
                    n_valid=n_t)
                states.append(_series_slice({k: v[0] for k, v in p.items()},
                                            j, gb))
                kept.append(n_rows.reshape(1).to(torch.int32))
        states = _segmented_time_combine(mesh, states, seg_ids)
        return (_grid_output(mesh, states, num_groups, num_buckets),
                ShardedArray(mesh, kept, (TIME_AXIS,), (time_n,)))

    return deviceprof.seam(fn, name="mesh_decode_partials")


# ---- device-resident top-k score state -------------------------------------
#
# The egress-bounded top-k path (read._aggregate_topk_mesh): round
# outputs stay on the mesh; only a per-group score vector and the k
# winners' grid rows download.  The state is split by series block, each
# block on the device of slot (0, s); a round folds into it slot by slot
# in time order.  Rankings by min/max/last are SELECTION ops, so
# accumulating their cells across rounds is exact, and prefix slots
# (non-tails) may feed the state too: a prefix's cells are a subset of
# its run's.  `lo` is the per-slot first bucket on the HOST (the reader
# keeps it there), so a slot's column slice is a host decision.


def _state_devices(mesh: Mesh) -> list:
    return [mesh.device(0, s) for s in range(mesh.shape[SERIES_AXIS])]


def mesh_score_init(mesh: Mesh, num_groups: int, padded_buckets: int,
                    by: str) -> list:
    """Identity-filled score state, one dict per series block.
    `padded_buckets` leaves one round-width of slack past the query's
    grid so a slot's column slice never clamps."""
    import torch

    gb = _series_block(num_groups, mesh.shape[SERIES_AXIS])
    fill = {"min": _F32_MAX, "max": -_F32_MAX, "last": 0.0}[by]
    out = []
    for dev in _state_devices(mesh):
        st = {"by": torch.full((gb, padded_buckets), fill,
                               dtype=torch.float32, device=dev),
              "has": torch.zeros((gb, padded_buckets), dtype=torch.bool,
                                 device=dev)}
        if by == "last":
            st["ts"] = torch.full((gb, padded_buckets), _TS_MIN,
                                  dtype=torch.int32, device=dev)
        out.append(st)
    return out


def _slot_block(grid: ShardedArray, t: int, s: int, dev):
    return grid.block(t, s)[0].to(dev)


def mesh_score_update(state: list, by_grid: ShardedArray,
                      count_grid: ShardedArray,
                      last_ts: Optional[ShardedArray], lo, bucket_ms: int,
                      *, by: str) -> list:
    """Fold one round's (time, groups, width) outputs into the score
    state, slot by slot in time order (later wins ties for `last`).
    The state is updated IN PLACE (it is the round's accumulator, as the
    JAX program's donated state is); the round's grids are only read.
    `lo` is the (time,) host first-bucket offsets."""
    import torch

    mesh = by_grid.mesh
    lo_h = np.asarray(lo).reshape(-1)
    width = by_grid.shape[2]
    for s, (st, dev) in enumerate(zip(state, _state_devices(mesh))):
        with on_device(dev):
            for t in range(by_grid.shape[0]):
                a, b = int(lo_h[t]), int(lo_h[t]) + width
                has_t = _slot_block(count_grid, t, s, dev) > 0
                cand = _slot_block(by_grid, t, s, dev)
                cur_by = st["by"][:, a:b]
                if by == "min":
                    new_by = torch.minimum(cur_by, cand)
                elif by == "max":
                    new_by = torch.maximum(cur_by, cand)
                else:  # last: select by global (range-relative) timestamp
                    cur_ts = st["ts"][:, a:b]
                    cand_ts = torch.where(
                        has_t, _slot_block(last_ts, t, s, dev)
                        + a * int(bucket_ms),
                        torch.full_like(cur_ts, _TS_MIN))
                    take = cand_ts >= cur_ts
                    new_by = torch.where(take, cand, cur_by)
                    st["ts"][:, a:b] = torch.where(take, cand_ts, cur_ts)
                st["by"][:, a:b] = new_by
                st["has"][:, a:b] |= has_t
    return state


def mesh_score_finalize(state: list, *, largest: bool,
                        num_buckets: int):
    """(scores, has_any) per group, on the host — the ONLY full-group
    bytes the top-k path downloads.  Score formula mirrors
    combine_top_k's: the best count>0 cell of the ranking grid (NaN
    cells propagate, as in the host's np.max)."""
    import torch

    scores, has = [], []
    for st in state:
        by_grid = st["by"][:, :num_buckets]
        h = st["has"][:, :num_buckets]
        fill = float("-inf") if largest else float("inf")
        masked = torch.where(h, by_grid, torch.full_like(by_grid, fill))
        sc = masked.amax(dim=1) if largest else masked.amin(dim=1)
        # amax/amin propagate NaN, as jnp's max/min do
        scores.append(deviceprof.download(sc))
        has.append(deviceprof.download(h.any(dim=1)))
    return np.concatenate(scores), np.concatenate(has)


# ---- additive (count/sum/avg) score state ----------------------------------
#
# Additive rankings fold TAIL slots only (a prefix would double-count)
# and keep each cell as an exact (hi, lo) double-float pair
# (ops/topk.pair_add): while every add is provably exact and dense, the
# host's float64 fold of the same addends in the same order equals
# hi + lo bit for bit.  Any add that is not provably exact sets the
# sticky `lossy` flag and the query downgrades to full parts (counted
# `additive_topk`).


def mesh_additive_init(mesh: Mesh, num_groups: int, padded_buckets: int,
                       by: str) -> list:
    """Zero-filled additive score state per series block, distinct
    buffers per plane (the update writes each in place)."""
    import torch

    gb = _series_block(num_groups, mesh.shape[SERIES_AXIS])
    out = []
    for dev in _state_devices(mesh):
        def z():
            return torch.zeros((gb, padded_buckets), dtype=torch.float32,
                               device=dev)
        st = {"has": torch.zeros((gb, padded_buckets), dtype=torch.bool,
                                 device=dev),
              "lossy": torch.zeros((), dtype=torch.bool, device=dev)}
        if by in ("count", "avg"):
            st["cnt_hi"], st["cnt_lo"] = z(), z()
        if by in ("sum", "avg"):
            st["sum_hi"], st["sum_lo"] = z(), z()
        out.append(st)
    return out


def mesh_additive_update(state: list, count_grid: ShardedArray,
                         sum_grid: ShardedArray, tails, lo, *,
                         by: str) -> list:
    """Fold one round's outputs into the additive state — TAIL slots
    only (`tails` the (time,) host run-tail mask).  Masked slots add
    nothing and stay out of the lossy accounting; the state is updated
    in place, the grids only read."""
    import torch

    mesh = count_grid.mesh
    lo_h = np.asarray(lo).reshape(-1)
    tails_h = np.asarray(tails).reshape(-1)
    width = count_grid.shape[2]
    planes = {"count": ("cnt",), "sum": ("sum",),
              "avg": ("cnt", "sum")}[by]
    grids = {"cnt": count_grid, "sum": sum_grid}
    for s, (st, dev) in enumerate(zip(state, _state_devices(mesh))):
        with on_device(dev):
            for t in range(count_grid.shape[0]):
                if not bool(tails_h[t]):
                    continue
                a, b = int(lo_h[t]), int(lo_h[t]) + width
                add = _slot_block(count_grid, t, s, dev) > 0
                for name in planes:
                    x = torch.where(add, _slot_block(grids[name], t, s, dev),
                                    torch.zeros((), dtype=torch.float32,
                                                device=dev))
                    h2, l2, exact = pair_add(st[name + "_hi"][:, a:b],
                                             st[name + "_lo"][:, a:b], x)
                    st[name + "_hi"][:, a:b] = h2
                    st[name + "_lo"][:, a:b] = l2
                    st["lossy"] |= torch.any(add & ~exact)
                st["has"][:, a:b] |= add
    return state


def mesh_additive_finalize(state: list, *, by: str, largest: bool,
                           num_buckets: int) -> dict:
    """Reduce the additive state to the download payload, on the host.
    count/sum: the per-group extreme cell as an exact (hi, lo) pair;
    avg: the full (groups, buckets) pair grids for the host's float64
    divide.  `lossy` rides along."""
    out: dict = {"lossy": any(bool(deviceprof.download(st["lossy"]))
                              for st in state)}
    has = [st["has"][:, :num_buckets] for st in state]
    out["has_any"] = np.concatenate(
        [deviceprof.download(h.any(dim=1)) for h in has])
    if by == "avg":
        for name in ("cnt", "sum"):
            for part in ("_hi", "_lo"):
                out[name + part] = np.concatenate(
                    [deviceprof.download(st[name + part][:, :num_buckets])
                     for st in state])
        out["has"] = np.concatenate([deviceprof.download(h) for h in has])
        return out
    name = {"count": "cnt", "sum": "sum"}[by]
    his, los = [], []
    for st, h in zip(state, has):
        s_hi, s_lo = pair_max_normalized(
            st[name + "_hi"][:, :num_buckets],
            st[name + "_lo"][:, :num_buckets], h, axis=1, largest=largest)
        his.append(deviceprof.download(s_hi))
        los.append(deviceprof.download(s_lo))
    out["score_hi"], out["score_lo"] = np.concatenate(his), \
        np.concatenate(los)
    return out


def mesh_take_rows(grids: dict, idx) -> dict:
    """Winner-row gather on the mesh: each time slot's (groups, width)
    grids sliced to the k winners' rows (global group rows `idx`, host
    ints) BEFORE download — the O(k x buckets x aggs) egress.  Rows of
    series block s are taken on its slot and assembled in `idx` order on
    slot (t, 0); the result is a (time, k, width) ShardedArray split
    over time."""
    import torch

    out = {}
    idx_h = np.asarray(idx, dtype=np.int64).reshape(-1)
    for k, g in grids.items():
        mesh = g.mesh
        series_n = mesh.shape[SERIES_AXIS]
        time_n = mesh.shape[TIME_AXIS]
        gb = g.shape[1] // series_n
        blocks: list = [None] * mesh.size
        for t in range(time_n):
            dev0 = mesh.device(t, 0)
            parts = []
            for s in range(series_n):
                sel = idx_h[(idx_h // gb) == s] - s * gb
                if not len(sel):
                    continue
                dev = mesh.device(t, s)
                with on_device(dev):
                    rows = g.block(t, s)[0].index_select(
                        0, torch.as_tensor(sel, device=dev))
                parts.append(rows.to(dev0))
            with on_device(dev0):
                # idx may be in any order: the parts follow series order,
                # so put each row back at its position in idx
                cat = torch.cat(parts) if parts else g.block(t, 0)[0][:0]
                order = np.argsort(np.argsort(idx_h // gb, kind="stable"),
                                   kind="stable")
                blocks[mesh.slot(t, 0)] = cat.index_select(
                    0, torch.as_tensor(order, device=dev0))[None]
        out[k] = ShardedArray(mesh, blocks, (TIME_AXIS,),
                              (time_n, len(idx_h), g.shape[2]))
    return out
