#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (horaedb_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py [--rows N] [--config4-rows N] [--json PATH]

Phases, each printed as it runs with its seconds; any failure exits
non-zero and prints no result line:

1. device: find the card, print `nvidia-smi` name and power limit.
2. build: compile every kernel of the main path with nvcc (sm_90a), one
   compiler per source (csrc/bucket_agg.cu, csrc/merge_path.cu), and the
   host library (csrc/host_native.cpp) with g++, started together.
3. kernel: both entries of csrc/bucket_agg.cu (bucket_window_partials,
   bucket_round_accumulate) against their plain PyTorch versions on the
   card — random rows, edge cases, int32 wrap of the shifted and rebased
   timestamps, NaN/+-inf values, a large group count, `last` ties across
   windows and rounds, and a round shaped like the main path's
   (merge-ordered rows, 72,000 valid of 131,072 slots) — then their
   times at that round (device time of back-to-back calls, CUDA
   events), the bound, the slice route of the first port (partial grids
   + per-window torch slice updates), the partials' one-pass float
   atomic sum, and a one-call `index_add_` yardstick.
4. merge kernel: kway_merge_perm (csrc/merge_path.cu) byte for byte
   against its plain version and np.lexsort on (row, keys..., pad) on
   merge_cases: 2, 4, 8, 64 and 128 runs, empty runs, equal keys across
   runs, int32 extremes, no pad zone, pairs already in order, in reverse
   and equal at the junction, runs of TILE-1, TILE, TILE+1 and 2 TILE+3
   rows, a tile of equal keys across two runs, 2 and 16 key columns, and
   three segments of the engine's shape: the main path's (two SST runs
   of config 1, 72,000 rows of 131,072 slots, 2 levels), the compaction
   phase's (4 SSTs, 136,800 rows of 262,144, 3 levels) and one of 64
   flushes (72,000 rows of 131,072, 7 levels); decode_rows_core on the
   card against its CPU run (3 routes x 9 leaf programs); then the
   kernel timed at those three segments, the whole call and each level
   (torch.profiler), beside its bound, its plain version and the
   multi-pass stable torch.sort the sort route would pay; with
   --parent DIR, the kernel of that checkout too, in turns.
5. determinism: bucket_window_partials launched twice and
   bucket_round_accumulate 5 times (fresh accumulators) on the same
   merge-ordered round (W=16, cap=131072, G=128) at 1 min, 1 h and 1 day
   buckets (6, 360 and 8,640 rows per cell) and on unsorted random rows
   (sparse and 1,024 rows per cell): every field byte-equal between the
   launches and within rtol of the plain version; each entry's float
   atomic sum launched 5 times beside it and its distinct byte patterns
   counted; both entries' ordered and atomic sums timed at 1 h.
6. end to end, fused: the north-star workload (BASELINE config 1 of
   bench.py: 10M rows, 100 hosts, 10 s scrape, 1 m buckets, 2 h
   segments, an in-memory object store, 1M-row write chunks) through
   MetricEngine.write_arrow and query_downsample(aggs=("avg",)) over
   whole buckets with the scan cache at 4 x rows (bench.py's setting, so
   the fused path serves), once cold and 5 times cached, checked against
   a numpy bincount of the same rows.  Every cached query must be a
   replay hit with 0 B host-to-device and the cold query's bytes in
   every field; bucket_round_accumulate's launch count over the six
   queries must equal the fused rounds they ran, and the device decode
   must not engage.  Then one cached query under torch.profiler (kernel
   launches and device time by kernel name, byte-equal grids); the
   first half, an interior quarter and the last half of the range
   (bucket-aligned: each under 1 MB host-to-device, checked against its
   own bincount); the full range unaligned, [T0, T0 + span) (its time
   leaf keys new memos: the first query uploads the columns again, 3
   repeats must be replays with 0 B up and its bytes);
   drop_hbm_state() and the full range again (the full path's upload,
   the replay's bytes); the cell's peak device memory.  "Cold" is true
   cold: tier 2 (the encoded cache, filled by write-through at ingest,
   whose stats are printed) is emptied with the window cache first.
   Then the query served from tier 2 (windows and device state
   dropped, tier 2 kept: 0 store GETs when every part is resident) and
   the pipeline on and off in turns on true-cold queries (walls, stalls
   per stage, in-flight high-water, the host's core count); every grid
   byte-equal to the cold query's.  Each cold-read record carries the
   store GETs and bytes (a counting MemoryObjectStore), segment_read
   summed and the bytes uploaded.  Then the top-k legs on this engine:
   query_topk(k=10) by max, by avg smallest first and by last over the
   same range, each run twice (the second must be a replay with 0 B
   host-to-device), byte-equal to query_downsample + plan.apply_top_k
   on the same engine, the winners' rows and the ranking checked against
   numpy.
7. op path: ops.downsample.time_bucket_aggregate over the same 10M rows
   as one batch (time-major rows: runs of one row per cell), checked
   against the bincount; bucket_window_partials' launch count over that
   call must be one.
8. end to end, parts: two more MetricEngines on the same store with the
   default StorageConfig, whose fused gate declines the 10M rows: one as
   it is ([scan.decode] mode "auto": device decode on the card) and one
   with mode "host" (host decode, the control), in turns device, host,
   device, host.  Each: cold avg at 1 min (device leg: every segment
   decoded on the card, no fallback, no sort, one bucket_window_partials
   launch per segment and one kway_merge_perm launch per merge level of
   each multi-SST segment; host leg: one partials launch per round) and
   all aggregates at 1 h against numpy; the repeat served from the
   PartsMemo (all 139 segments); a narrowed range whose memo-served
   bytes equal a cold recompute in sparse and dense combine; two cold
   1 h queries byte-equal; and the two legs' grids byte-equal; each
   cold query's peak device memory, with the stack cache untouched (the
   parts path builds its rounds uncached).  Every cold query empties
   tier 2 first.  Then, on the device-decode engine: a true-cold query
   and the same query served from tier 2 (GETs, bytes, segment_read,
   upload; byte-equal); the pipeline on and off in turns; a filtered
   query (host = 'host_042') against numpy, its store bytes beside the
   unfiltered query's; a streamed check leg (max_window_rows 16,384 and
   stream_read_min_rows 32,768, two printed cuts: every segment read
   window by window from the sidecars) byte-equal to the bulk read.
   Then the top-k legs of phase 6 on the device-decode engine, where
   the pushdown must materialize k x 16,667 buckets x grids cells and
   equal the dense control byte for byte.  Then
   single segments decoded alone (host clock, host cProfile) and one
   cold device-decode query under torch.profiler.
9. compaction: 4 overlapping SSTs in each of 12 segments (newer values
   on some hosts), queried on the fused path and on the parts path with
   device decode (the k-way route, 8 runs) and with host decode,
   compacted by the scheduler to one SST per segment, queried again
   (device decode on the compacted route; count/min/max/last and the
   parts path's sum/avg byte-equal, device and host decode byte-equal,
   the fused sum/avg within rtol 1e-5, the caches missing
   structurally); then the scrubber deletes one injected orphan and
   keeps every referenced SST and sidecar.
10. wal, three legs: (a) host work: acked writes/s and p99 ack latency
   of one row a write under 32 concurrent writers on a LocalObjectStore
   on the machine's disk, one SST per write (256 writes) against the
   WAL at max_group_wait 0, 1 and 4 ms (2,000 writes each), every acked
   row read back after a flush (the shape of the JAX package's bench
   config 8); (b) the 10M rows ingested through a WAL-fronted engine
   (fused path, scan cache at 4 x rows) and flushed, tier 2's stats, a
   true-cold query and 5 replays, a live tail of 360 writes of one tick x 100 hosts (its ack
   p50/p99; the data memtable must hold its 36,000 rows and a raw query
   must return one host's 360 rows before any flush), the query that
   flushes it (a replay miss, 0 store GETs: the flush admitted the new
   SSTs into tier 2; its upload, then a replay with 0 B up),
   100 rows of the first segment overwritten, a 60-tick tail left
   unflushed, abort() of every table and a reopen that replays it, every
   grid against numpy; (c) the same store with the default
   StorageConfig (device decode: the flushed segments' two SSTs merge
   with kway_merge_perm) against mode "host", byte-equal.  The three
   kernel entries' launches on (b) and (c), counted from 0 around them,
   must each be above 0.
11. topk ops: ops/topk.py on the card against its CPU run on the same
   inputs: top_k_groups (ties, signed zeros, NaN, +-inf, k above the
   group count, largest and smallest, 100 and 100,000 groups; values'
   bytes and indices equal) and two_sum, pair_add and
   pair_max_normalized on 10^6 seeded normal-range f32 triples
   (byte-equal).
12. config4: BASELINE config 4, the JAX package's run_config4 shape (64
   overlapping SSTs of --config4-rows / 64 rows, 64M by default and the
   cut from 1B printed; 100 hosts as a string PK, one 1 h segment,
   seed 0) through plan_query / execute_plan with a TopK stage (top 10
   by max, one 50-minute bucket).  The route is read from the gates and
   must be the reference's: the fused gate declines, device decode in
   "auto", the segment streamed in PK-range windows (below 8,388,608
   rows it is not, and the phase fails).  Legs: true cold, tier-2-
   served, 5 repeats (memo-served), the query without the TopK stage
   (per-host counts against numpy) and the dense control (byte-equal
   to the pushdown), then one cold query under torch.profiler; per leg
   its ms, store GETs and bytes, launches counted from 0, decode
   fallbacks (must be 0), streamed windows, the combine's materialized
   and grid cells (k x buckets x grids and 100), tier 2's hits, misses
   and evictions, and peak device memory.  The top 10, each winner's
   count and max (f32, byte-equal) against numpy's keep-last dedup of
   the same rows.
13. rollup: the JAX package's bench config 11 (suite.py run_config11)
   at 10M rows (100 hosts, 10 s scrape, 139 2 h segments, seed 11) on
   an engine with rollup tiers 1m and 1h: ingest, the (cpu, value)
   standing query registered and the roll_now() backfill (139
   segments, each tier recomputed
   on the parts route: device decode and one bucket_window_partials a
   segment), stats() (lag 0, coverage 1.0, tier sizes), a cross-check
   per dashboard shape (the served grid byte for byte a parts-route
   recompute, within tolerance of the default fused route, and against
   numpy), the rollup-served mix (12 rotating 6 h @ 1 m zooms and the
   full-span @ 1 h overview, 277 buckets, aggs avg, 12 repetitions, the
   tier tables' window caches dropped before each query: 0 data-plane
   GETs), the raw cold mix (3 repetitions, the data table true cold),
   p50/p99 per shape and the mix speedup, a served top-k equal to
   apply_top_k of the served grid, and a late write served as cells
   plus a one-segment raw tail that roll_now() then re-rolls alone.
   Then the same objects behind the reference's seeded 25 ms store
   (FaultInjectingStore(seed=11, latency_range=(0.025, 0.025))): a
   second engine whose recovered spec covers the data, and the
   in-memory engine beside it, 3 turns of a served and a raw cold
   zoom + overview on each; grids equal across stores; both mix
   speedups against the reference's 5x bar.
14. chunked: tools/chunked_vs_row.py's deployment at 10M rows (one-
   decimal gauges from seed 0, 30-minute chunk windows) in a chunked
   and a row-layout engine: both ingests and stored bytes; the cold avg
   at 1 min over the whole span, p50 of 3 in turns with the row
   layout's cold query, against numpy and the row layout; one
   bucket_window_partials launch per cold chunked query (W = 1, 10M
   valid rows of 16,777,216 slots), held against its plain version on
   the card, 5 launches byte-equal, timed beside its bound, its plain
   version and index_add_; a repeat from the decode cache with 0 B up;
   two writes of one (series, ts) keep the later value; an Append
   compaction of one segment changes no result.
15. scanagent: the JAX package's bench config 17 (suite.py
   run_config17) at config 1's shape (10M rows, 100 hosts, 10 s, 139
   2 h segments, seed 17, scan cache 4 x rows) over a seeded 25 ms
   store (FaultInjectingStore(seed=17)) under a data-byte counter: the
   cold dashboard mix (a full-span 1 h avg overview and two rotating
   6 h zooms at 1 m, avg and max), 2 true-cold reps a leg.  Legs: off
   (the default route, fused), off on the parts route, agent (an
   AgentService on this card colocated with the raw inner store: device
   decode, kway_merge_perm and bucket_window_partials at the agent, 0
   decode fallbacks, 0 coordinator GETs), agent_killed (fallback direct
   reads) and disk (a LocalObjectStore: 0 coordinator segment reads,
   then a dead-agent fallback that streams its SSTs).  Per leg: p50,
   store data bytes and GETs, partial bytes, coordinator bytes; the
   agent leg's grids byte-equal to the parts-route off leg, the fused
   off leg within rtol 1e-5, every grid against numpy; the
   coordinator-bytes ratio against the reference's 5x bar; one
   stitched trace of an agent-served query; the memory ledger (also
   printed after config 1): attributed bytes per account kind against
   RSS, CUDA live bytes against max_memory_allocated.
16. a JSON line of per-kernel numbers (with `wal_launches`,
   `config4_launches`, the rollup, chunked and scanagent cells'
   launches beside `launches`, and the partials entry's time at the
   chunked shape), the total seconds, the card line again, and the
   last line {"ok": true, "device": {...}}.

Needs one CUDA card; a missing card is a failure, never a CPU run.
"""

from __future__ import annotations

import argparse
import asyncio
import cProfile
import json
import math
import os
import pstats
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HBM_BYTES_PER_S = 3.35e12  # H100 SXM published memory rate

ALL_AGGS = ("count", "sum", "min", "max", "avg", "last")
BMS = 60_000  # 1 min buckets
F32_MAX = 3.4028234663852886e38
SOURCE = "horaedb_tpu_torch/csrc/bucket_agg.cu"
REPLACES = "horaedb_tpu/ops/pallas_kernels.py:48"


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Median per-call time of `fn` on the card, one event pair per call
    (host launch overhead included when it exceeds the device work)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def device_ms(fns, reps: int = 40) -> float:
    """Device time per call of `reps` back-to-back calls, cycling through
    `fns` (copies of the inputs larger than L2 in all, so each call reads
    from HBM): a sleep kernel holds the card while the host enqueues the
    calls, so the event pair times the queued device work alone."""
    import torch

    fns = list(fns) if isinstance(fns, (list, tuple)) else [fns]
    for f in fns:
        f()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(reps):
        fns[i % len(fns)]()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int((2.0 * host_s + 2e-3) * 2e9))
    s.record()
    for i in range(reps):
        fns[i % len(fns)]()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / reps


def compare(got: dict, ref: dict, what: str) -> float:
    """NaN-aware: the isnan masks must agree; where neither side is NaN,
    count/min/max/last/last_ts are exact and sum is within rtol 1e-5.
    Returns the largest absolute difference there (inf == inf counts
    as 0)."""
    import torch

    if set(got) != set(ref):
        raise AssertionError(f"{what}: fields {sorted(got)} != {sorted(ref)}")
    worst = 0.0
    for f in ref:
        a, b = got[f].cpu(), ref[f].cpu()
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{what}: field {f}: {a.shape} {a.dtype} "
                                 f"!= {b.shape} {b.dtype}")
        if a.is_floating_point():
            nan_a, nan_b = torch.isnan(a), torch.isnan(b)
            if not torch.equal(nan_a, nan_b):
                raise AssertionError(f"{what}: field {f}: NaN cells differ")
            a, b = a[~nan_a], b[~nan_b]
        if f == "sum":
            ok = bool(torch.isclose(a, b, rtol=1e-5, atol=0.0).all())
        else:
            ok = torch.equal(a, b)
        if not ok:
            raise AssertionError(f"{what}: field {f} disagrees with plain")
        d = (a.double() - b.double()).abs()
        d = torch.where(torch.isnan(d), torch.zeros_like(d), d)
        worst = max(worst, float(d.max()) if d.numel() else 0.0)
    return worst


def _bits(u: int):
    import numpy as np

    return np.array([u], np.uint32).view(np.float32)[0]


def main_path_round(rng, W=16, cap=131072, series=100, ticks=720, G=128,
                    bucket_ms=BMS):
    """A round shaped like the main path's: window d is segment d (2 h
    at the default 720 ticks), its rows merge-ordered by (series, ts) at
    a 10 s scrape (100 series x 720 ticks = 72,000 valid rows of `cap`),
    the rest padding; lo steps by the window's whole buckets."""
    import numpy as np

    n = series * ticks
    seg_ms = ticks * 10_000
    ts = np.zeros((W, cap), np.int32)
    gid = np.full((W, cap), -1, np.int32)
    vals = np.zeros((W, cap), np.float32)
    for d in range(W):
        ts[d, :n] = np.tile(np.arange(ticks, dtype=np.int32) * 10_000, series)
        gid[d, :n] = np.repeat(np.arange(series, dtype=np.int32), ticks)
        vals[d, :n] = (rng.random(n) * 100).astype(np.float32)
    remap = np.tile(np.arange(G, dtype=np.int32), (W, 1))
    shift = (np.arange(W) * seg_ms).astype(np.int32)
    lo = (shift // bucket_ms).astype(np.int32)
    nv = np.full(W, n, np.int32)
    total = W * seg_ms // bucket_ms
    return (ts, gid, vals, remap, shift, lo, nv), total


def window_width(window_ms: int, bucket_ms: int) -> int:
    """The reader's per-window grid width (read._window_grid_width)."""
    need = window_ms // bucket_ms + 2
    return max(8, 1 << (need - 1).bit_length())


def partials_times(ba, stack, total: int, G: int, width: int,
                   bucket_ms: int, plain_reps: int = 8) -> dict:
    """bucket_window_partials (ordered sum, and the one-pass float
    atomic sum) at one round shape, avg set and all aggregates: device
    ms over 4 copies of the row stacks (4 x 25 MB > 50 MB of L2), the
    plain version, a one-call index_add_ of (1, v) pairs into the
    precomputed window cells, and the bytes bound."""
    import numpy as np
    import torch

    dev = torch.device("cuda")

    def d(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    ts, gid, vals, remap, shift, lo, nv = stack
    W, cap = ts.shape
    n_valid = int(nv.max())
    copies = [[d(ts), d(gid), d(vals)] for _ in range(4)]
    small = [d(remap), d(shift), d(lo)]

    def fn(c, which=("avg",), ordered=True):
        return lambda: ba._launch_partials(
            *c, *small, total, bucket_ms, num_groups=G, width=width,
            which=which, n_valid=n_valid, ordered=ordered)

    out = {"ms": device_ms([fn(c) for c in copies]),
           "ms_atomic_sum": device_ms([fn(c, ordered=False)
                                       for c in copies]),
           "ms_all_aggs": device_ms([fn(c, ALL_AGGS) for c in copies]),
           "ms_all_aggs_atomic_sum": device_ms(
               [fn(c, ALL_AGGS, False) for c in copies]),
           "plain_ms": device_ms([lambda c=c: ba.bucket_window_partials_plain(
               *c, *small, total, bucket_ms, num_groups=G, width=width,
               which=("avg",), n_valid=n_valid) for c in copies],
               reps=plain_reps)}
    valid = np.arange(cap)[None, :] < nv[:, None]
    g_u = np.take_along_axis(remap, np.clip(gid, 0, G - 1), 1)
    tg = ts.astype(np.int64) + shift[:, None]
    b = tg // bucket_ms - lo[:, None]
    win_cell = ((np.arange(W)[:, None] * G + g_u) * width + b)[valid]
    n_rows = int(valid.sum())
    pairs = torch.stack([torch.ones(n_rows, device=dev),
                         d(vals[valid])], dim=1)
    win_idx = d(win_cell)
    out["library_ms"] = device_ms(lambda: torch.zeros(
        W * G * width, 2, device=dev).index_add_(0, win_idx, pairs))
    # valid rows read once (12 B), per-window scalars, and each output
    # cell of count and sum written once
    nbytes = n_rows * 12 + W * (G * 4 + 12) + W * G * width * 2 * 4
    out["bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
    out["bytes"] = nbytes
    out["rows"] = n_rows
    return out


def kernel_phase(ba, fused) -> list:
    """Both entries against their plain versions on the card, then their
    times at the main path's round shape."""
    import numpy as np
    import torch

    dev = torch.device("cuda")

    def d(a):
        return None if a is None else torch.from_numpy(
            np.ascontiguousarray(a)).to(dev)

    worst = {"bucket_window_partials": 0.0, "bucket_round_accumulate": 0.0}

    def check_partials(what, stack, G, width, total, which, n_valid=None):
        ts, gid, vals, remap, shift, lo = stack[:6]
        args = [d(ts), d(gid), d(vals), d(remap), d(shift), d(lo), total, BMS]
        kw = dict(num_groups=G, width=width, which=which, n_valid=n_valid)
        ref = ba.bucket_window_partials_plain(*args, **kw)
        got = ba.bucket_window_partials(*args, **kw)
        torch.cuda.synchronize()
        worst["bucket_window_partials"] = max(
            worst["bucket_window_partials"],
            compare(got, ref, f"partials {what} {which}"))
        return got

    def check_rounds(what, rounds, G, width, total, which):
        acc_p = fused.fused_acc_init(num_groups=G, num_buckets=total,
                                     which=which, device=dev)
        stacks = []
        for ts, gid, vals, remap, shift, lo, nv in rounds:
            args = [d(ts), d(gid), d(vals), d(remap), d(shift), d(lo),
                    total, BMS]
            kw = dict(num_groups=G, width=width, which=which, n_valid=d(nv),
                      lo_host=lo)
            stacks.append((args, kw, nv))
            ba.bucket_round_accumulate_plain(acc_p, *args, **kw)
        acc_k = fused.fused_acc_init(num_groups=G, num_buckets=total,
                                     which=which, device=dev)
        for args, kw, nv in stacks:
            ba.bucket_round_accumulate(acc_k, *args, n_valid_host=nv, **kw)
        torch.cuda.synchronize()
        worst["bucket_round_accumulate"] = max(
            worst["bucket_round_accumulate"],
            compare(acc_k, acc_p, f"round {what} {which}"))
        return acc_k

    def check_both(what, stack, G, width, total, whiches=(ALL_AGGS,)):
        nv = stack[6]
        scalar = int(nv[0]) if (nv == nv[0]).all() else None
        for which in whiches:
            if scalar is not None:
                check_partials(what, stack, G, width, total, which, scalar)
            check_rounds(what, [stack], G, width, total, which)

    rng = np.random.default_rng(0)
    # random rows over the main path's round size: every
    # row its own run; duplicate max-ts rows across a 1024-row tile
    W, cap, G, width, total = 16, 131072, 128, 128, 150
    ts = rng.integers(-2 * BMS, 140 * BMS, (W, cap)).astype(np.int32)
    gid = rng.integers(-1, 110, (W, cap)).astype(np.int32)
    vals = (rng.random((W, cap)) * 100).astype(np.float32)
    ts[:, 2040:2060] = 7 * BMS + 5
    gid[:, 2040:2060] = 3
    remap = np.stack([rng.permutation(G).astype(np.int32) for _ in range(W)])
    shift = rng.integers(-BMS, BMS, W).astype(np.int32)
    lo = rng.integers(0, 30, W).astype(np.int32)
    random_stack = (ts, gid, vals, remap, shift, lo, np.full(W, cap, np.int32))
    check_both("random", random_stack, G, width, total, (ALL_AGGS, ("avg",)))

    # edge cases: identity remap with gids past the grid (and -1 and a
    # huge one that would overflow gid*width), rows past n_valid, rows
    # past the total bucket count, negative local offsets
    e_ts = rng.integers(-3 * BMS, 40 * BMS, (2, 4096)).astype(np.int32)
    e_gid = rng.integers(-1, G + 6, (2, 4096)).astype(np.int32)
    e_gid[0, 7] = 2**30
    e_vals = (rng.random((2, 4096)) * 10).astype(np.float32)
    for n_valid in (4096, 3000):
        check_both(f"edge n_valid={n_valid}",
                   (e_ts, e_gid, e_vals, None, np.array([5, -BMS], np.int32),
                    np.array([0, 3], np.int32), np.full(2, n_valid, np.int32)),
                   G, 32, 30)
    # int32 wrap: ts near 2^31 and a shift past it, so tg wraps negative
    # in window 1, and lo far out, so tl wraps too
    lo_far = 2**31 // BMS - 30
    w_ts = rng.integers(lo_far * BMS, 2**31 - 1, (2, 4096)).astype(np.int32)
    w_gid = rng.integers(-1, 16, (2, 4096)).astype(np.int32)
    check_both("wrap", (w_ts, w_gid, e_vals, None,
                        np.array([0, 20 * BMS], np.int32),
                        np.array([lo_far, lo_far - 40], np.int32),
                        np.full(2, 4096, np.int32)), 16, 64, lo_far + 60)

    # NaN and +-inf: +NaN and -NaN in different cells among finite values,
    # a cell holding only +inf and one holding only -inf (identity remap,
    # no shift/lo: group g, bucket b <- gid g, ts b * BMS + k)
    W, cap, G, width, total = 2, 4096, 16, 16, 40
    n_ts = (rng.integers(0, width, (W, cap)) * BMS
            + rng.integers(0, BMS, (W, cap))).astype(np.int32)
    n_gid = rng.integers(5, G, (W, cap)).astype(np.int32)
    n_vals = (rng.random((W, cap)) * 10).astype(np.float32)
    special = [  # (window, group, bucket, values)
        (0, 1, 2, [1.0, _bits(0x7FC00000), 3.0, 2.0]),
        (0, 2, 3, [5.0, _bits(0xFFC00000), 4.0, 6.0]),
        (1, 3, 4, [np.inf, np.inf]),
        (1, 4, 5, [-np.inf]),
    ]
    row = 100
    for w, g, b, vs in special:
        for k, v in enumerate(vs):
            n_ts[w, row], n_gid[w, row], n_vals[w, row] = b * BMS + k, g, v
            row += 37
    n_vals[1, 3000:3010] = _bits(0x7FC00000)  # NaNs among random cells
    nan_stack = (n_ts, n_gid, n_vals, None, None, np.zeros(W, np.int32),
                 np.full(W, cap, np.int32))
    for which in (ALL_AGGS, ("min", "max")):
        p = check_partials("nan", nan_stack, G, width, total, which)
        acc = check_rounds("nan", [nan_stack], G, width, total, which)
        for f in ("min", "max"):
            if not (torch.isnan(p[f][0, 1, 2]) and torch.isnan(p[f][0, 2, 3])
                    and torch.isnan(acc[f][1, 2])
                    and torch.isnan(acc[f][2, 3])):
                raise AssertionError(f"nan: a NaN value did not make {f} NaN")
        if not (float(p["min"][1, 3, 4]) == math.inf
                and float(acc["min"][3, 4]) == F32_MAX
                and float(p["max"][1, 4, 5]) == -math.inf
                and float(acc["max"][4, 5]) == -F32_MAX):
            raise AssertionError("nan: +-inf-only cells break the identities")

    # a large group count: 8192 groups x 128 buckets per window
    W, cap, G, width, total = 2, 8192, 8192, 128, 256
    big = (rng.integers(0, 200 * BMS, (W, cap)).astype(np.int32),
           rng.integers(-1, G, (W, cap)).astype(np.int32),
           (rng.random((W, cap)) * 100).astype(np.float32),
           np.stack([rng.permutation(G).astype(np.int32) for _ in range(W)]),
           np.zeros(W, np.int32), rng.integers(0, 100, W).astype(np.int32),
           np.full(W, cap, np.int32))
    check_both("large G", big, G, width, total)

    # `last` ties: every window of two rounds ends its rows on the same
    # max ts of union cell (1, 5); round 2 has a padding window
    W, cap, G, width, total = 4, 1024, 4, 8, 12
    tie_rounds = []
    for r in range(2):
        t_ts = rng.integers(0, 6 * BMS, (W, cap)).astype(np.int32)
        t_gid = rng.integers(-1, G, (W, cap)).astype(np.int32)
        t_vals = (rng.random((W, cap)) * 100).astype(np.float32)
        t_remap = np.stack([rng.permutation(G).astype(np.int32)
                            for _ in range(W)])
        t_shift = rng.integers(0, 3 * BMS, W).astype(np.int32)
        t_lo = rng.integers(0, 4, W).astype(np.int32)
        t_nv = np.array([cap, cap - 7, cap - 100, 0 if r else cap], np.int32)
        for w in range(W):
            t_remap[w, 0] = 1
            for k in (1, 5, 9):  # in-window ties too: the later row wins
                t_ts[w, t_nv[w] - k] = 6 * BMS - 1 - int(t_shift[w])
                t_gid[w, t_nv[w] - k] = 0
                t_vals[w, t_nv[w] - k] = 1000.0 * (r + 1) + 10 * w + k
        tie_rounds.append((t_ts, t_gid, t_vals, t_remap, t_shift, t_lo,
                           t_nv))
    for which in (ALL_AGGS, ("last",)):
        acc = check_rounds("ties", tie_rounds, G, width, total, which)
        if float(acc["last"][1, 5]) != 2000.0 + 10 * (W - 2) + 1:
            raise AssertionError("ties: the last window of round 2 must win")

    # the main path's round shape
    main_stack, m_total = main_path_round(rng)
    W, cap, G, width = 16, 131072, 128, 128
    check_both("main-path", main_stack, G, width, m_total,
               (ALL_AGGS, ("avg",)))
    log(f"kernel: both entries match plain on random, edge, int32-wrap, "
        f"NaN/inf, large-G, tie and main-path rounds (max_abs_err "
        f"{worst!r}); updates run-length reduced in registers, then "
        f"global atomics (the partials' sum as int64 fixed point)")

    # times at the main path's round (avg set): 4 copies of the stacks
    # (4 x 25 MB > 50 MB of L2)
    which = ("avg",)
    ts, gid, vals, remap, shift, lo, nv = main_stack
    copies = [[d(ts), d(gid), d(vals)] for _ in range(4)]
    remap_d, shift_d, lo_d, nv_d = d(remap), d(shift), d(lo), d(nv)
    n_rows = int(nv.sum())
    acc = fused.fused_acc_init(num_groups=G, num_buckets=m_total,
                               which=which, device=dev)

    def round_fn(c, which=which):
        a = acc if which == ("avg",) else fused.fused_acc_init(
            num_groups=G, num_buckets=m_total, which=which, device=dev)
        return lambda: ba.bucket_round_accumulate(
            a, *c, remap_d, shift_d, lo_d, m_total, BMS, num_groups=G,
            width=width, which=which, n_valid=nv_d, lo_host=lo,
            n_valid_host=nv)

    def slice_fn(c):
        return lambda: ba.fold_window_partials(
            acc, ba.bucket_window_partials(
                *c, remap_d, shift_d, lo_d, m_total, BMS, num_groups=G,
                width=width, which=which), lo, m_total, BMS, width)

    def atomic_fn(c):
        return lambda: ba._launch_round(
            acc, *c, remap_d, shift_d, lo_d, m_total, BMS, num_groups=G,
            width=width, which=which, n_valid=nv_d, lo_host=lo,
            n_valid_host=nv, ordered=False)

    r_ms = device_ms([round_fn(c) for c in copies])
    r_atomic_ms = device_ms([atomic_fn(c) for c in copies])
    r_all_ms = device_ms([round_fn(c, ALL_AGGS) for c in copies])
    r_call_ms = cuda_ms(round_fn(copies[0]), reps=30)
    r_plain_ms = device_ms([lambda c=c: ba.bucket_round_accumulate_plain(
        acc, *c, remap_d, shift_d, lo_d, m_total, BMS, num_groups=G,
        width=width, which=which, n_valid=nv_d, lo_host=lo)
        for c in copies], reps=8)
    slice_ms = device_ms([slice_fn(c) for c in copies], reps=12)
    pt = partials_times(ba, main_stack, m_total, G, width, BMS)

    # yardsticks: one index_add_ of (1, v) pairs at precomputed cells
    # of the valid rows (the prologue is not part of the call)
    valid = np.arange(cap)[None, :] < nv[:, None]
    g_u = np.take_along_axis(remap, np.clip(gid, 0, G - 1), 1)
    tg = ts.astype(np.int64) + shift[:, None]
    b = tg // BMS - lo[:, None]
    col = lo[:, None] + b
    acc_cell = (g_u.astype(np.int64) * m_total + col)[valid]
    pairs = torch.stack([torch.ones(n_rows, device=dev),
                         d(vals[valid])], dim=1)
    acc_idx = d(acc_cell)
    r_lib_ms = device_ms(lambda: torch.zeros(
        G * m_total, 2, device=dev).index_add_(0, acc_idx, pairs))
    # bound: valid rows read once (12 B), per-window scalars, and each
    # touched accumulator cell read and written once, 2 fields for avg
    touched = len(np.unique(acc_cell))
    in_bytes = n_rows * 12 + W * (G * 4 + 12)
    r_bytes = in_bytes + touched * 2 * 4 * 2
    r_bound = r_bytes / HBM_BYTES_PER_S * 1e3
    log(f"kernel: main-path round (W={W} cap={cap} valid={n_rows} G={G} "
        f"width={width} total={m_total} which={which}):")
    log(f"kernel:   bucket_round_accumulate (ordered sum) {r_ms!r} ms "
        f"(one-pass float atomic sum {r_atomic_ms!r} ms; all aggs "
        f"{r_all_ms!r} ms; one call with host overhead {r_call_ms!r} ms), "
        f"plain {r_plain_ms!r} ms, slice route (partials + slice updates) "
        f"{slice_ms!r} ms, index_add_ {r_lib_ms!r} ms, bound {r_bound!r} ms "
        f"({r_bytes} bytes, {touched} touched cells)")
    log(f"kernel:   bucket_window_partials (ordered sum) {pt['ms']!r} ms "
        f"(all aggs {pt['ms_all_aggs']!r} ms); one-pass float atomic sum "
        f"{pt['ms_atomic_sum']!r} ms (all aggs "
        f"{pt['ms_all_aggs_atomic_sum']!r} ms); plain {pt['plain_ms']!r} "
        f"ms, index_add_ {pt['library_ms']!r} ms, bound "
        f"{pt['bound_ms']!r} ms ({pt['bytes']} bytes)")

    # the random input's partial grids, also timed with one event pair
    # per call (host launch overhead included), as the port's first
    # kernel was timed
    ts, gid, vals, remap, shift, lo, _nv = random_stack
    rnd = [d(ts), d(gid), d(vals), d(remap), d(shift), d(lo), 150, BMS]
    p_rand_call_ms = cuda_ms(lambda: ba.bucket_window_partials(
        *rnd, num_groups=G, width=width, which=which), reps=30)
    p_rand_ms = device_ms(lambda: ba.bucket_window_partials(
        *rnd, num_groups=G, width=width, which=which))
    log(f"kernel: random input, bucket_window_partials: "
        f"{p_rand_call_ms!r} ms per call (event pair), {p_rand_ms!r} ms "
        f"device")

    common = {"route": "cuda", "source": SOURCE, "replaces": REPLACES,
              "bound_by": "bytes"}
    return [
        dict(common, name="bucket_window_partials", launches=0,
             max_abs_err=worst["bucket_window_partials"], ms=pt["ms"],
             plain_ms=pt["plain_ms"], bound_ms=pt["bound_ms"],
             library_ms=pt["library_ms"], ms_all_aggs=pt["ms_all_aggs"],
             ms_atomic_sum=pt["ms_atomic_sum"],
             ms_all_aggs_atomic_sum=pt["ms_all_aggs_atomic_sum"],
             random_input_ms=p_rand_ms,
             random_input_call_ms=p_rand_call_ms),
        dict(common, name="bucket_round_accumulate", launches=0,
             also_replaces="horaedb_tpu/storage/read.py:4501",
             max_abs_err=worst["bucket_round_accumulate"], ms=r_ms,
             plain_ms=r_plain_ms, bound_ms=r_bound, library_ms=r_lib_ms,
             ms_all_aggs=r_all_ms, ms_atomic_sum=r_atomic_ms,
             call_ms=r_call_ms,
             slice_route_ms=slice_ms),
    ]


def round_patterns(ba, fused, args, kw, nv, lo, ordered: bool,
                   launches: int = 5) -> tuple:
    """The round entry launched `launches` times on fresh accumulators:
    the distinct byte patterns of each field, and the last result."""
    import torch

    seen: dict = {}
    for _ in range(launches):
        acc = fused.fused_acc_init(num_groups=kw["num_groups"],
                                   num_buckets=args[6], which=kw["which"],
                                   device=args[0].device)
        ba._launch_round(acc, *args, n_valid_host=nv, lo_host=lo,
                         ordered=ordered, **kw)
        torch.cuda.synchronize()
        for f, t in acc.items():
            seen.setdefault(f, set()).add(t.cpu().numpy().tobytes())
    return {f: len(v) for f, v in seen.items()}, acc


def determinism_phase(ba, fused) -> dict:
    """Both entries launched several times on the same round: every
    field must be byte-equal between the launches and within rtol of
    the plain version.  Merge-ordered rounds at 1 min, 1 h and 1 day
    buckets, and unsorted random rows (sparse and dense).
    bucket_window_partials is launched twice; bucket_round_accumulate 5
    times on fresh accumulators.  The one-pass float atomic sum of each
    entry is launched 5 times on each round beside it, and its distinct
    byte patterns counted (the fault the ordered sum removes); the
    ordered round is timed at the 1 h round beside its float atomic
    sum."""
    import numpy as np
    import torch

    dev = torch.device("cuda")

    def d(a):
        return None if a is None else torch.from_numpy(
            np.ascontiguousarray(a)).to(dev)

    rng = np.random.default_rng(1)
    W, cap, G = 16, 131072, 128
    cases = []
    for name, bucket, series, ticks in (("1 min", 60_000, 100, 720),
                                        ("1 h", 3_600_000, 100, 720),
                                        ("1 day", 86_400_000, 15, 8640)):
        stack, total = main_path_round(rng, W, cap, series, ticks, G, bucket)
        cases.append((name, stack, total,
                      window_width(ticks * 10_000, bucket), bucket,
                      min(ticks, bucket // 10_000)))
    # unsorted rows: sparse random cells, and dense ones (1,024 rows per
    # cell: 16 groups x 8 buckets per window)
    for name, groups, span_b in (("unsorted", 110, 140),
                                 ("unsorted dense", 16, 8)):
        ts = rng.integers(0, span_b * BMS, (W, cap)).astype(np.int32)
        gid = rng.integers(0, groups, (W, cap)).astype(np.int32)
        vals = (rng.random((W, cap)) * 100).astype(np.float32)
        remap = np.stack([rng.permutation(G).astype(np.int32)
                          for _ in range(W)])
        stack = (ts, gid, vals, remap, np.zeros(W, np.int32),
                 np.zeros(W, np.int32), np.full(W, cap, np.int32))
        cases.append((name, stack, span_b, window_width(span_b * BMS, BMS),
                      BMS, cap // (groups * span_b)))
    out = {}
    for name, stack, total, width, bucket, per_cell in cases:
        ts, gid, vals, remap, shift, lo, nv = stack
        args = [d(ts), d(gid), d(vals), d(remap), d(shift), d(lo), total,
                bucket]
        n_valid = int(nv.max())
        worst = 0.0
        for which in (ALL_AGGS, ("avg",)):
            kw = dict(num_groups=G, width=width, which=which,
                      n_valid=n_valid)
            first = ba.bucket_window_partials(*args, **kw)
            second = ba.bucket_window_partials(*args, **kw)
            torch.cuda.synchronize()
            for f in first:
                if (first[f].cpu().numpy().tobytes()
                        != second[f].cpu().numpy().tobytes()):
                    raise AssertionError(
                        f"determinism {name} {which}: field {f} differs "
                        f"between two launches")
            worst = max(worst, compare(
                first, ba.bucket_window_partials_plain(*args, **kw),
                f"determinism {name} {which}"))
        atomic = {ba._launch_partials(
            *args, num_groups=G, width=width, which=("avg",),
            n_valid=n_valid, ordered=False)["sum"].cpu().numpy().tobytes()
            for _ in range(5)}
        # the round entry: 5 launches, each on a fresh accumulator, with
        # the ordered sum (every field one pattern) and with the float
        # atomic sum (its pattern count logged)
        r_worst = 0.0
        for which in (ALL_AGGS, ("avg",)):
            kw = dict(num_groups=G, width=width, which=which, n_valid=d(nv))
            pats, acc = round_patterns(ba, fused, args, kw, nv, lo, True)
            if any(n != 1 for n in pats.values()):
                raise AssertionError(
                    f"determinism {name} {which}: the round entry gave "
                    f"{pats} byte patterns in 5 launches")
            plain = fused.fused_acc_init(num_groups=G, num_buckets=total,
                                         which=which, device=dev)
            ba.bucket_round_accumulate_plain(plain, *args, lo_host=lo, **kw)
            r_worst = max(r_worst, compare(
                acc, plain, f"determinism round {name} {which}"))
        r_atomic, _acc = round_patterns(
            ba, fused, args, dict(num_groups=G, width=width,
                                    which=ALL_AGGS, n_valid=d(nv)),
            nv, lo, False)
        out[name] = {"rows_per_cell": per_cell, "width": width,
                     "max_abs_err": worst,
                     "atomic_sum_patterns_in_5": len(atomic),
                     "round_max_abs_err": r_worst,
                     "round_atomic_patterns_in_5": r_atomic}
        log(f"determinism: {name} ({per_cell} rows per cell): partials "
            f"two launches byte-equal in every field, max_abs_err "
            f"{worst!r} against plain, the float atomic sum gave "
            f"{len(atomic)} distinct byte patterns in 5 launches; round "
            f"5 launches byte-equal in every field, max_abs_err "
            f"{r_worst!r} against plain, its float atomic sum gave "
            f"{r_atomic['sum']} patterns of the sum in 5 launches "
            f"(every field: {r_atomic})")
    name, stack, total, width, bucket, _per_cell = cases[1]
    out["times_1h"] = partials_times(ba, stack, total, G, width, bucket)
    t = out["times_1h"]
    log(f"determinism: 1 h round (width {width}): partials ordered "
        f"{t['ms']!r} ms (all aggs {t['ms_all_aggs']!r}), float atomic sum "
        f"{t['ms_atomic_sum']!r} ms (all aggs "
        f"{t['ms_all_aggs_atomic_sum']!r}), plain {t['plain_ms']!r} ms, "
        f"index_add_ {t['library_ms']!r} ms, bound {t['bound_ms']!r} ms")
    ts, gid, vals, remap, shift, lo, nv = stack
    copies = [[d(ts), d(gid), d(vals)] for _ in range(4)]
    small = [d(remap), d(shift), d(lo)]
    acc = fused.fused_acc_init(num_groups=G, num_buckets=total,
                               which=("avg",), device=dev)
    nv_d = d(nv)

    def round_fn(c, ordered):
        return lambda: ba._launch_round(
            acc, *c, *small, total, bucket, num_groups=G, width=width,
            which=("avg",), n_valid=nv_d, lo_host=lo, n_valid_host=nv,
            ordered=ordered)

    out["round_times_1h"] = {
        "ms": device_ms([round_fn(c, True) for c in copies]),
        "ms_atomic_sum": device_ms([round_fn(c, False) for c in copies])}
    t = out["round_times_1h"]
    log(f"determinism: 1 h round, bucket_round_accumulate (avg): ordered "
        f"{t['ms']!r} ms, float atomic sum {t['ms_atomic_sum']!r} ms")
    return out


def kway_case(rng, real_runs: int, max_len: int = 3000, nkeys: int = 5,
              ties: bool = False, extremes: bool = False,
              empty: bool = False, full: bool = False, lens=None,
              layout=None):
    """Presorted runs of int32 keys laid out as the device decode lays
    out a segment: the runs, then the zero pad zone as its own run, the
    run count padded to a power of two with empty runs.  `lens` fixes
    the run lengths.  `layout` cuts one sorted sequence into the runs:
    "in order" (each run above the one before), "reverse" (each run
    below it) or "junction" (in order, each run starting with the row
    that ends the one before); "tie block" gives every run equal keys
    but for 3 low rows at its head and 3 high rows at its tail, so each
    pair still merges.  Returns (keys (nkeys, cap), offsets, num_runs,
    n)."""
    import numpy as np

    lens = (rng.integers(1, max_len, real_runs) if lens is None
            else np.asarray(lens, np.int64))
    if empty:
        lens[rng.random(real_runs) < 0.4] = 0
    n = int(lens.sum())
    cap = n if full else max(128, 1 << max(0, n - 1).bit_length())
    hi = 2 if ties else 1000
    if layout in ("in order", "reverse", "junction"):
        rows = rng.integers(-hi, hi, (n, nkeys)).astype(np.int32)
        rows = rows[np.lexsort(rows.T[::-1])]
        bounds = np.cumsum(lens)[:-1]
        if layout == "junction":
            rows[bounds] = rows[bounds - 1]
        runs = np.split(rows, bounds)
        if layout == "reverse":
            # run r takes the r-th slice from the top, each sorted
            runs = np.split(rows[::-1], np.cumsum(lens)[:-1])
            runs = [r[::-1] for r in runs]
    else:
        runs = []
        for length in lens:
            k = rng.integers(-hi, hi, (int(length), nkeys)).astype(np.int32)
            if extremes:
                k[:, 0] = rng.choice(np.array([-2**31, 2**31 - 1, 0],
                                              np.int32), int(length))
                k[:, -1] = rng.choice(np.array([-2**31, 2**31 - 1],
                                               np.int32), int(length))
            if layout == "tie block":
                k[:] = 0
                k[:3, 0], k[-3:, 0] = -1, 1
            runs.append(k[np.lexsort(k.T[::-1])])
    keys = np.zeros((cap, nkeys), np.int32)
    keys[:n] = np.concatenate(runs)
    num_runs = 1 << max(1, real_runs).bit_length()
    offs = np.full(num_runs + 1, cap, np.int32)
    offs[:real_runs + 1] = np.concatenate([[0], np.cumsum(lens)])
    offs[real_runs] = n
    return np.ascontiguousarray(keys.T), offs, num_runs, n


def segment_keys(runs):
    """The merge keys of one segment of the data table, (metric_id,
    tsid, field_id, timestamp, __seq__) as the device decode uploads
    them: one run per SST, each a (series, ticks) block in (series, tick)
    order with __seq__ the SST's index, at a 10 s scrape; then the pad
    zone and empty runs up to a power of two.  `runs` is a list of
    (series ids, first tick, end tick).  Returns (keys (5, cap),
    offsets, num_runs, n)."""
    import numpy as np

    cols = []
    for r, (series, t0, t1) in enumerate(runs):
        series = np.asarray(series, np.int32)
        m = len(series) * (t1 - t0)
        cols.append(np.stack([
            np.zeros(m, np.int32),
            np.repeat(series, t1 - t0),
            np.zeros(m, np.int32),
            np.tile(np.arange(t0, t1, dtype=np.int32) * 10_000, len(series)),
            np.full(m, r, np.int32)]))
    lens = [c.shape[1] for c in cols]
    n = sum(lens)
    cap = 1 << (n - 1).bit_length()
    keys = np.zeros((5, cap), np.int32)
    keys[:, :n] = np.concatenate(cols, axis=1)
    num_runs = 1 << len(runs).bit_length()
    offs = np.full(num_runs + 1, cap, np.int32)
    offs[:len(runs) + 1] = np.concatenate([[0], np.cumsum(lens)])
    return keys, offs, num_runs, n


def main_path_segment(series=100, ticks=720, split=640):
    """One two-SST segment of BASELINE config 1: run 0 the ticks before
    a 1M-row write chunk's boundary, run 1 the rest; 72,000 rows of
    131,072 slots, 4 runs (2 levels)."""
    hosts = range(series)
    return segment_keys([(hosts, 0, split), (hosts, split, ticks)])


def compaction_segment():
    """One segment of the compaction phase before compaction: 4 SSTs
    (every host, then hosts 0-29, 20-49 and 40-69 with newer values),
    720 ticks x 190 host series = 136,800 rows of 262,144 slots, 8 runs
    (3 levels)."""
    return segment_keys([(range(100), 0, 720), (range(0, 30), 0, 720),
                         (range(20, 50), 0, 720), (range(40, 70), 0, 720)])


def flush_segment(flushes=64, series=100, ticks=720):
    """A segment written in `flushes` small flushes before compaction
    caught up: each SST every series over its slice of the 720 ticks;
    at 64 (the most the device decode's k-way route admits) 72,000 rows
    of 131,072 slots, 128 runs (7 levels)."""
    cuts = [round(ticks * f / flushes) for f in range(flushes + 1)]
    return segment_keys([(range(series), cuts[f], cuts[f + 1])
                         for f in range(flushes)])


def level_ms(run, copies, levels: int, reps: int = 12) -> list:
    """Device time of each of the `levels` merge levels (one kernel
    launch each) of `run`, cycling through `copies` of the keys: the
    median over `reps` calls of the kernel's CUPTI record under
    torch.profiler.  A window that lost a record is taken again, at most
    twice."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run(copies[0])
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(reps):
                run(copies[i % len(copies)])
            torch.cuda.synchronize()
        recs = sorted((e.time_range.start, e.time_range.elapsed_us())
                      for e in prof.events()
                      if e.device_type == DeviceType.CUDA
                      and "kway_merge_level" in e.name)
        if len(recs) == reps * levels:
            return [statistics.median(d for _, d in recs[lv::levels]) / 1e3
                    for lv in range(levels)]
    raise AssertionError(f"merge levels: {len(recs)} kernel records over "
                         f"{reps} calls of {levels} levels")


def host_ms(fn, reps: int = 50) -> float:
    """Median host time of one call of `fn`: the wrapper's own cost, as
    the card runs the launches after the call returns (synchronized
    between calls, so no queue builds up)."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(times) * 1e3


def time_merge_shape(mg, case, parent=None) -> dict:
    """kway_merge_perm timed at one segment shape, keys read from HBM (as
    many copies as exceed L2, cycled): device time of the whole call
    (back-to-back calls, CUDA events), of each level (torch.profiler),
    and per call with host overhead; beside the plain version, the
    multi-pass stable torch.sort the sorted route pays, and the bytes
    bound.  With `parent` (the merge module of another checkout), that
    kernel too, in turns parent, this, this, parent."""
    import torch

    dev = torch.device("cuda")
    keys, offs, num_runs, n = case
    cap = keys.shape[1]
    levels = num_runs.bit_length() - 1
    copies = [tuple(torch.from_numpy(k).to(dev) for k in keys)
              for _ in range(max(4, math.ceil(60e6 / keys.nbytes)))]
    od = torch.from_numpy(offs).to(dev)
    plain = mg.kway_merge_perm_plain(copies[0], od, num_runs=num_runs,
                                     n_valid=n).cpu().numpy().tobytes()

    def timed(mod) -> dict:
        def run(c):
            return mod.kway_merge_perm(c, od, num_runs=num_runs, n_valid=n)

        if run(copies[0]).cpu().numpy().tobytes() != plain:
            raise AssertionError(f"kway at cap {cap}, {num_runs} runs: "
                                 f"{mod.__name__} != plain")
        return {"ms": device_ms([lambda c=c: run(c) for c in copies]),
                "level_ms": level_ms(run, copies, levels),
                "call_ms": cuda_ms(lambda: run(copies[0]), reps=30),
                "host_ms": host_ms(lambda: run(copies[0]))}

    turns = {"this": [], "parent": []}
    for who in ["parent", "this", "this", "parent"] if parent else ["this"]:
        turns[who].append(timed(parent if who == "parent" else mg))

    def summary(ts: list) -> dict:
        return {"ms": statistics.median(t["ms"] for t in ts),
                "level_ms": [statistics.median(lv) for lv in
                             zip(*(t["level_ms"] for t in ts))],
                "call_ms": statistics.median(t["call_ms"] for t in ts),
                "host_ms": statistics.median(t["host_ms"] for t in ts)}

    iota = torch.arange(cap, dtype=torch.int32, device=dev)
    pad = (iota >= n).to(torch.int32)
    # the function moves each key column in once and perm out once
    nbytes = cap * 4 * (len(keys) + 1) + offs.nbytes
    out = {"cap": cap, "n": n, "num_runs": num_runs, "keys": len(keys),
           "levels": levels, **summary(turns["this"]),
           "plain_ms": device_ms([lambda c=c: mg.kway_merge_perm_plain(
               c, od, num_runs=num_runs, n_valid=n) for c in copies],
               reps=4),
           # the sorted route's cost: stable torch.sort per key, pad first
           "library_ms": device_ms([lambda c=c: mg.lex_sort(
               (pad,) + c + (iota,), num_keys=1 + len(c)) for c in copies],
               reps=10),
           "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
           "turns": turns}
    if parent:
        out["parent"] = summary(turns["parent"])
    return out


def merge_cases(T: int) -> dict:
    """The merge kernel's inputs, seeded: random runs at 2-128 runs,
    empty runs, ties, int32 extremes, no pad zone; pairs in order, in
    reverse and equal at the junction; runs of T - 1, T, T + 1 and
    2 T + 3 rows for a tile of T slots; a tile of equal keys across two
    runs; 2 and 16 key columns; and three segments of the engine's own
    shape."""
    import numpy as np

    rng = np.random.default_rng(3)
    return {
        "2 runs": kway_case(rng, 1),
        "4 runs": kway_case(rng, 3),
        "8 runs": kway_case(rng, 7),
        "64 runs": kway_case(rng, 63, max_len=400),
        "128 runs": kway_case(rng, 64, max_len=400),
        "empty runs": kway_case(rng, 12, empty=True),
        "equal keys across runs": kway_case(rng, 6, ties=True),
        "int32 extremes": kway_case(rng, 5, extremes=True),
        "no pad zone": kway_case(rng, 4, full=True),
        "pairs in order": kway_case(rng, 5, layout="in order"),
        "pairs in reverse": kway_case(rng, 5, layout="reverse"),
        "pairs equal at the junction": kway_case(rng, 5, layout="junction"),
        "runs of TILE-1, TILE, TILE+1, 2 TILE+3": kway_case(
            rng, 4, lens=[T - 1, T, T + 1, 2 * T + 3]),
        "a tile of equal keys across two runs": kway_case(
            rng, 2, lens=[T + 500, T + 700], layout="tie block"),
        "2 keys": kway_case(rng, 5, nkeys=2, ties=True),
        "16 keys": kway_case(
            rng, 5, nkeys=16, ties=True),
        "main path": main_path_segment(),
        "compaction segment": compaction_segment(),
        "64 flushes": flush_segment(),
    }


def merge_kernel_phase(mg, dd, parent=None) -> dict:
    """kway_merge_perm against its plain version (byte for byte) and
    np.lexsort on (row, keys..., pad) on seeded inputs; decode_rows_core
    on the card against its CPU run on every leaf opcode and all three
    routes; then the kernel timed at three segment shapes (beside the
    kernel of `parent`, another checkout's merge module, if given)."""
    import numpy as np
    import torch

    dev = torch.device("cuda")
    cases = merge_cases(mg.TILE)
    for name, (keys, offs, num_runs, n) in cases.items():
        kd = tuple(torch.from_numpy(k).to(dev) for k in keys)
        od = torch.from_numpy(offs).to(dev)
        got = mg.kway_merge_perm(kd, od, num_runs=num_runs, n_valid=n)
        plain = mg.kway_merge_perm_plain(kd, od, num_runs=num_runs,
                                         n_valid=n)
        torch.cuda.synchronize()
        got = got.cpu().numpy()
        if got.tobytes() != plain.cpu().numpy().tobytes():
            raise AssertionError(f"kway {name}: kernel != plain")
        cap = keys.shape[1]
        pad = (np.arange(cap) >= n).astype(np.int32)
        want = np.lexsort((np.arange(cap),) + tuple(keys[::-1]) + (pad,))
        if not np.array_equal(got, want):
            raise AssertionError(f"kway {name}: kernel != np.lexsort")
    log(f"kernel: kway_merge_perm byte-equal to its plain version and to "
        f"np.lexsort on {len(cases)} inputs ({', '.join(cases)})")

    # decode_rows_core: a 3-run segment (k, ts, seq, v, n), on the card
    # and on the CPU
    seg_rng = np.random.default_rng(4)
    parts, lens = [], []
    for r in range(3):
        m = 20_000
        k = seg_rng.integers(0, 64, m)
        ts = seg_rng.integers(0, 2000, m) * 1000
        order = np.lexsort((ts, k))
        k, ts = k[order], ts[order]
        keep = np.ones(m, bool)
        keep[1:] = (k[1:] != k[:-1]) | (ts[1:] != ts[:-1])
        k, ts = k[keep], ts[keep]
        v = (seg_rng.random(len(k)) * 100).astype(np.float32)
        parts.append(np.stack([k, ts, np.full(len(k), r), v.view(np.int32),
                               seg_rng.integers(-3, 3, len(k))]))
        lens.append(len(k))
    n = sum(lens)
    cap = 1 << (n - 1).bit_length()
    cols = np.zeros((5, cap), np.int32)
    cols[:, :n] = np.concatenate(parts, axis=1)
    offs = np.array([0, lens[0], lens[0] + lens[1], n, cap], np.int32)
    one_run = cols.copy()
    order = np.lexsort((one_run[1, :n], one_run[0, :n]))
    one_run[:, :n] = one_run[:, :n][:, order]
    progs = {
        "none": ((), ()),
        "eq": (((0, dd._OP_EQ),), ([3],)),
        "lt": (((1, dd._OP_LT),), ([900_000],)),
        "le": (((1, dd._OP_LE),), ([900_000],)),
        "gt": (((1, dd._OP_GT),), ([400_000],)),
        "ge": (((0, dd._OP_GE),), ([9],)),
        "range": (((1, dd._OP_RANGE),), ([200_000, 1_700_000],)),
        "in": (((0, dd._OP_IN),), ([1, 4, 6, 40, 63],)),
        "leaf-only column": (((4, dd._OP_GE),), ([0],)),
    }

    def on(device, arr):
        t = [torch.from_numpy(c.copy()).to(device) for c in arr]
        t[3] = t[3].view(torch.float32)
        return tuple(t)

    checked = 0
    for route in ("presorted", "kway", "sorted"):
        src = one_run if route == "presorted" else cols
        for name, (prog, consts) in progs.items():
            outs = []
            for device in ("cpu", dev):
                c = tuple(torch.tensor(x, dtype=torch.int32, device=device)
                          for x in consts)
                o = None if route != "kway" else torch.from_numpy(offs).to(
                    device)
                outs.append(dd.decode_rows_core(
                    on(device, src), n, c, o, key_slots=(0, 1, 2), num_pks=2,
                    group_pos=0, val_slot=3, leaf_prog=prog, route=route,
                    num_runs=4 if route == "kway" else 0))
            torch.cuda.synchronize()
            (ck, cg, cv, cn), (gk, gg, gv, gn) = outs
            same = (all(a.numpy().tobytes() == b.cpu().numpy().tobytes()
                        for a, b in zip(ck + (cg, cv), gk + (gg, gv)))
                    and int(cn) == int(gn))
            if not same:
                raise AssertionError(f"decode_rows_core {route} {name}: "
                                     f"card != CPU")
            checked += 1
    log(f"kernel: decode_rows_core on the card byte-equal to its CPU run in "
        f"{checked} cases (3 routes x {len(progs)} leaf programs, "
        f"{n} rows)")

    # times at three shapes: the main path's two-SST segment, the
    # compaction phase's four-SST segment, a segment of 64 flushes
    out = {"shapes": {}, "max_abs_err": 0}
    for name in ("main path", "compaction segment", "64 flushes"):
        t = out["shapes"][name] = time_merge_shape(mg, cases[name], parent)
        vs = (f"; parent {t['parent']['ms']!r} ms device, levels "
              f"{t['parent']['level_ms']!r} ms, {t['parent']['call_ms']!r} "
              f"ms per call, host {t['parent']['host_ms']!r} ms"
              if parent else "")
        log(f"kernel: kway_merge_perm at the {name} (cap {t['cap']}, "
            f"{t['n']} rows, {t['num_runs']} runs, {t['levels']} levels, "
            f"{t['keys']} keys): {t['ms']!r} ms device, levels "
            f"{t['level_ms']!r} ms, {t['call_ms']!r} ms per call with host "
            f"overhead, host {t['host_ms']!r} ms; plain {t['plain_ms']!r} "
            f"ms, multi-pass stable torch.sort {t['library_ms']!r} ms, bound "
            f"{t['bound_ms']!r} ms ({t['bytes']} bytes){vs}")
    main = out["shapes"]["main path"]
    for k in ("ms", "level_ms", "call_ms", "host_ms", "plain_ms",
              "library_ms", "bound_ms", "levels"):
        out[k] = main[k]
    return out


async def profile_query(query) -> dict:
    """One query under torch.profiler: device kernels (and copies) by
    name with their summed device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = await query()
    busy: dict = {}
    kernels = copies = 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        busy[e.name] = busy.get(e.name, 0.0) + e.time_range.elapsed_us()
        if e.name.startswith(("Memcpy", "Memset")):
            copies += 1
        else:
            kernels += 1
    runtime_launches = sum(1 for e in prof.events()
                           if e.name.startswith("cudaLaunchKernel"))
    return {"out": out, "kernels": kernels, "copies_and_sets": copies,
            "runtime_launch_calls": runtime_launches,
            "device_busy_us": sum(busy.values()),
            "busy_us_by_name": dict(sorted(busy.items(),
                                           key=lambda kv: -kv[1])[:12])}


async def end_to_end(rows: int, ba, mg) -> dict:
    """BASELINE config 1 through the port's public entry points."""
    import numpy as np
    import pyarrow as pa
    import torch

    from horaedb_tpu_torch.common.error import Error
    from horaedb_tpu_torch.metric_engine import MetricEngine
    from horaedb_tpu_torch.metric_engine.types import Label, tsid_of
    from horaedb_tpu_torch.storage.config import StorageConfig, from_dict
    from horaedb_tpu_torch.storage.types import TimeRange

    d = config1_rows(rows)
    hosts, interval, segment_ms = d["hosts"], d["interval"], d["segment_ms"]
    per_host, T0, n, names = d["per_host"], d["T0"], d["n"], d["names"]
    ts, host_id, vals = d["ts"], d["host_id"], d["vals"]
    bucket_ms = 60_000
    span = per_host * interval
    assert span < 2**31, "query window must fit int32 offsets"
    num_buckets = -(-span // bucket_ms)
    log(f"e2e: {n:,} rows, {hosts} hosts x {num_buckets} buckets, "
        f"{span // segment_ms + 1} segments")

    cfg = from_dict(StorageConfig, {
        "scheduler": {"schedule_interval": "1h"},
        "scan": {"cache_max_rows": rows * 4}})
    torch.cuda.reset_peak_memory_stats()
    store = counting_store()
    e = await MetricEngine.open("bench", store, segment_ms=segment_ms,
                                config=cfg)
    try:
        t0 = time.perf_counter()
        chunk = max(1, 1_000_000 // hosts) * hosts
        for lo in range(0, n, chunk):
            hi = min(n, lo + chunk)
            batch = pa.record_batch({
                "host": pa.DictionaryArray.from_arrays(
                    pa.array(host_id[lo:hi]), names),
                "timestamp": pa.array(ts[lo:hi], type=pa.int64()),
                "value": pa.array(vals[lo:hi], type=pa.float64()),
            })
            for _attempt in range(5):
                try:
                    await e.write_arrow("cpu", ["host"], batch)
                    break
                except Error:
                    # manifest delta backpressure: fold, retry the chunk
                    # (duplicates dedup by (tsid, ts) last-wins)
                    await e.tables["data"].manifest.trigger_merge()
            else:
                raise Error("ingest failed after 5 backpressure retries")
        ingest_s = time.perf_counter() - t0
        log(f"e2e: ingest {n:,} rows in {ingest_s!r} s")

        # whole buckets: the same grid and rows as [T0, T0 + span), and
        # no time leaf, so other bucket-aligned ranges share the windows'
        # memos (the grid cut is the range filter)
        rng_q = TimeRange.new(T0, T0 + num_buckets * bucket_ms)

        async def query(rng_t=rng_q):
            out = await e.query_downsample("cpu", [], rng_t,
                                           bucket_ms=bucket_ms,
                                           aggs=("avg",))
            torch.cuda.synchronize()
            return out

        reader = e.tables["data"].reader
        # write-through admitted every SST's columns into tier 2; report
        # it, then empty it with the window cache: the cold query reads
        # the store (true cold)
        tier2_ingest = reader.encoded_cache.stats()
        log(f"e2e: tier 2 after ingest {json.dumps(tier2_ingest)}"
            + ("" if not tier2_ingest["evictions"] else
               f" ({tier2_ingest['evictions']} parts evicted: the tier's "
               f"{tier2_ingest['max_bytes']} B do not hold every SST)"))
        reader.scan_cache.clear()
        reader.encoded_cache.clear()
        from horaedb_tpu_torch.ops.encode import h2d_bytes
        from horaedb_tpu_torch.utils import registry

        def stages(before: dict) -> dict:
            # per-stage wall seconds (and host-to-device bytes) of a
            # query, from the registry's cumulative histograms
            now = registry.snapshot()
            return {series_label(k): now[k] - before.get(k, 0.0)
                    for k in now if k.startswith("scan_stage_seconds{")}

        # the main path's run: launch counts from 0, read right after
        ba.reset_launches()
        mg.reset_launches()
        decode0 = decode_counts()

        async def timed(rng_t, want_replay: bool, what: str):
            # one query: its wall, stages, host-to-device bytes and
            # replay deltas; the replay must serve it or not, as asked
            snap, h2d0 = registry.snapshot(), h2d_bytes()
            hits0, misses0 = reader._replay_hits, reader._replay_misses
            got0, pipe0 = store.snap(), pipeline_snap(reader)
            t0 = time.perf_counter()
            out = await query(rng_t)
            wall = time.perf_counter() - t0
            rec = {"ms": wall * 1e3, "stages": stages(snap),
                   "h2d_bytes": h2d_bytes() - h2d0,
                   "replay_hits": reader._replay_hits - hits0,
                   "replay_misses": reader._replay_misses - misses0,
                   **store.since(got0), **pipeline_since(reader, pipe0)}
            if (rec["replay_hits"], rec["replay_misses"]) != \
                    ((1, 0) if want_replay else (0, 1)):
                raise AssertionError(f"e2e {what}: replay hits/misses "
                                     f"{rec['replay_hits']}/"
                                     f"{rec['replay_misses']}")
            return out, rec

        out, cold = await timed(rng_q, False, "cold")
        cached = []
        for i in range(5):
            got, rec = await timed(rng_q, True, f"cached {i}")
            if rec["h2d_bytes"] != 0:
                raise AssertionError(f"e2e cached {i}: {rec['h2d_bytes']} "
                                     f"B host-to-device")
            same_bytes(got, out, f"e2e cached {i} vs cold")
            cached.append(rec)
        log(f"e2e: 5 cached queries served by the replay (hits/misses "
            f"{[(c['replay_hits'], c['replay_misses']) for c in cached]}), "
            f"0 B host-to-device each, byte-equal to the cold query in "
            f"every field")
        launches = ba.LAUNCHES["bucket_round_accumulate"]
        windows = sum(len(ws) for ws in reader.scan_cache.values())
        per_query = math.ceil(windows / cfg.scan.agg_batch_windows)
        if launches == 0 or launches != 6 * per_query:
            raise AssertionError(
                f"kernel launches {launches} != 6 queries x {per_query} "
                f"rounds ({windows} windows)")
        if ba.LAUNCHES["bucket_window_partials"] != 0:
            raise AssertionError("e2e: the fused path wrote partial grids")
        if any(counts_delta(decode0, decode_counts()).values()) \
                or mg.LAUNCHES["kway_merge_perm"]:
            raise AssertionError("e2e: the device decode engaged on the "
                                 "fused path")
        log(f"e2e: bucket_round_accumulate launches {launches} = 6 queries "
            f"x {per_query} rounds; the device decode did not engage")

        tsid_of_host = np.array([tsid_of("cpu", [Label("host", f"host_{i:03d}")])
                                 for i in range(hosts)], dtype=np.uint64)
        order = np.argsort(tsid_of_host)

        def check(got, start_b: int, nb: int, what: str):
            # numpy bincount of the rows in [T0 + start_b, + nb) buckets
            off = ts - T0 - start_b * bucket_ms
            sel = (off >= 0) & (off < nb * bucket_ms)
            cell = host_id[sel].astype(np.int64) * nb + off[sel] // bucket_ms
            counts = np.bincount(cell, minlength=hosts * nb).reshape(
                hosts, nb)
            sums = np.bincount(cell, weights=vals[sel],
                               minlength=hosts * nb).reshape(hosts, nb)
            if got["tsids"] != [int(t) for t in tsid_of_host[order]]:
                raise AssertionError(f"e2e {what}: tsids differ from the "
                                     f"written series")
            got_count = got["aggs"]["count"].cpu().numpy()
            got_avg = got["aggs"]["avg"].cpu().numpy()
            if got_count.shape != (hosts, nb):
                raise AssertionError(f"e2e {what}: grid shape "
                                     f"{got_count.shape}")
            if not np.array_equal(got_count,
                                  counts[order].astype(np.float32)):
                raise AssertionError(f"e2e {what}: count grid differs from "
                                     f"bincount")
            occ = counts[order] > 0
            with np.errstate(invalid="ignore"):
                want_avg = sums[order] / counts[order]
            if not np.isfinite(got_avg[occ]).all() \
                    or not np.isnan(got_avg[~occ]).all():
                raise AssertionError(f"e2e {what}: avg has non-finite "
                                     f"occupied cells or non-NaN empty cells")
            np.testing.assert_allclose(got_avg[occ], want_avg[occ],
                                       rtol=1e-5)
            return counts, sums

        counts, sums = check(out, 0, num_buckets, "full range")
        log("e2e: grids match the numpy bincount (count exact, avg rtol "
            "1e-5)")
        profile = await profile_cached(query, out, ba)

        # other ranges over the same cached windows, bucket-aligned (no
        # time leaf): the column stacks of new round compositions come
        # from the windows' device copies, so only KBs go up
        half, quarter = num_buckets // 2, num_buckets // 4
        varied = {}
        for what, start_b, nb in (("first half", 0, half),
                                  ("interior quarter", 3 * num_buckets // 8,
                                   quarter),
                                  ("last half", half, num_buckets - half)):
            rng_v = TimeRange.new(T0 + start_b * bucket_ms,
                                  T0 + (start_b + nb) * bucket_ms)
            got, rec = await timed(rng_v, False, what)
            check(got, start_b, nb, what)
            if rec["h2d_bytes"] >= 1_000_000:
                raise AssertionError(f"e2e {what}: {rec['h2d_bytes']} B "
                                     f"host-to-device")
            rec["buckets"] = [start_b, nb]
            varied[what] = rec
            log(f"e2e: {what} (buckets {start_b}..{start_b + nb}): "
                f"{rec['ms']!r} ms, {rec['h2d_bytes']} B host-to-device, "
                f"grids match the numpy bincount")
        # the full range unaligned, [T0, T0 + span): the query shape of
        # earlier runs (1 ms shorter where span is whole buckets: the
        # same rows and grid).  Its time leaf keys new window memos and
        # stacks, so the first query re-uploads the columns; the repeats
        # must be replays with 0 B up and the first one's bytes
        rng_u = TimeRange.new(T0, T0 + span - (span % bucket_ms == 0))
        got_u, unaligned = await timed(rng_u, False, "unaligned cold")
        check(got_u, 0, num_buckets, "unaligned full range")
        unaligned_cached = []
        for i in range(3):
            got, rec = await timed(rng_u, True, f"unaligned cached {i}")
            if rec["h2d_bytes"] != 0:
                raise AssertionError(f"e2e unaligned cached {i}: "
                                     f"{rec['h2d_bytes']} B host-to-device")
            same_bytes(got, got_u, f"e2e unaligned cached {i} vs its cold")
            unaligned_cached.append(rec)
        unaligned["cached_ms"] = [c["ms"] for c in unaligned_cached]
        unaligned["cached_p50_ms"] = statistics.median(
            unaligned["cached_ms"])
        log(f"e2e: unaligned full range [T0, T0 + span): first query "
            f"{unaligned['ms']!r} ms, {unaligned['h2d_bytes']} B "
            f"host-to-device, grids match the numpy bincount; 3 repeats "
            f"served by the replay, 0 B up, byte-equal to it: "
            f"{unaligned['cached_ms']!r} ms")
        # the device state dropped: the full path re-uploads the windows'
        # columns and gives the replay's bytes
        reader.drop_hbm_state()
        got, dropped = await timed(rng_q, False, "after drop_hbm_state")
        same_bytes(got, out, "e2e after drop_hbm_state vs cold")
        log(f"e2e: after drop_hbm_state the full path took "
            f"{dropped['ms']!r} ms and {dropped['h2d_bytes']} B "
            f"host-to-device; grids byte-equal to the replay's")
        peak = torch.cuda.max_memory_allocated()
        stack_stats = reader.cache_stats()["stack_cache"]
        log(f"e2e: peak device memory of the fused cell {peak} B; stack "
            f"cache {json.dumps(stack_stats)}")

        # served from tier 2: the windows and the device state dropped,
        # the encoded parts kept (the cold query put every complete part)
        reader.drop_hbm_state()
        reader.scan_cache.clear()
        got, tier2 = await timed(rng_q, False, "tier-2-served")
        same_bytes(got, out, "e2e tier-2-served vs true cold")
        for what, rec in (("true cold", cold), ("tier-2-served", tier2)):
            log(f"e2e fused {what}: {rec['ms']!r} ms, {rec['gets']} store "
                f"GETs of {rec['get_bytes']} B, segment_read "
                f"{rec['stages'].get('segment_read', 0.0)!r} s summed, "
                f"{rec['h2d_bytes']} B host-to-device")
        if tier2["gets"] and not tier2_ingest["evictions"]:
            raise AssertionError(f"e2e tier-2-served: {tier2['gets']} "
                                 f"store GETs with every part resident")
        log("e2e: tier-2-served grids byte-equal to the true-cold query's")

        # the pipeline on and off, in turns, on true-cold queries
        pipe_turns = []
        for enabled in (True, False, True, False):
            reader.config.scan.pipeline.enabled = enabled
            true_cold(reader)
            got, rec = await timed(rng_q, False,
                                   f"pipeline {'on' if enabled else 'off'}")
            same_bytes(got, out, f"e2e pipeline {enabled} vs true cold")
            rec["enabled"] = enabled
            pipe_turns.append(rec)
        reader.config.scan.pipeline.enabled = True
        log(f"e2e fused: pipeline on/off/on/off on true-cold queries "
            f"({os.cpu_count()} host cores): "
            + "; ".join(f"{'on' if r['enabled'] else 'off'} {r['ms']!r} ms,"
                        f" stalls {json.dumps(r['stalls'])}, high-water "
                        f"{r['high_water_bytes']} B" for r in pipe_turns)
            + "; grids byte-equal")
        # the top-k legs on this (fused) engine, over the same range
        want = host_major_reference(vals.astype(np.float32), hosts,
                                    per_host, T0, interval, bucket_ms,
                                    num_buckets)
        topk = await topk_legs(e, "fused", rng_q, num_buckets,
                               {k: v[order] for k, v in want.items()},
                               [int(t) for t in tsid_of_host[order]])
        cached_ms = [c["ms"] for c in cached]
        cached_p50 = statistics.median(cached_ms)
        res = {"rows": n, "ingest_s": ingest_s, "cold_ms": cold["ms"],
               "cached_p50_ms": cached_p50, "cached_ms": cached_ms,
               "cold_rows_per_s": n / cold["ms"] * 1e3,
               "cached_rows_per_s": n / cached_p50 * 1e3,
               "windows": windows, "rounds_per_query": per_query,
               "cold_stage_s": cold["stages"],
               "cold_h2d_bytes": cold["h2d_bytes"],
               "last_cached_stage_s": cached[-1]["stages"],
               "cached_h2d_bytes": [c["h2d_bytes"] for c in cached],
               "cached_replay": [[c["replay_hits"], c["replay_misses"]]
                                 for c in cached],
               "varied": varied, "unaligned": unaligned,
               "after_drop": dropped,
               "launches": launches, "profile": profile,
               "stack_cache": stack_stats,
               "max_memory_allocated": peak,
               "tier2_after_ingest": tier2_ingest, "true_cold": cold,
               "tier2_served": tier2,
               "pipeline_turns": pipe_turns, "host_cores": os.cpu_count(),
               "topk": topk}
        log("e2e: " + json.dumps(res))
        res["op"] = op_path(ba, ts - T0, host_id, vals, hosts, num_buckets,
                            counts, sums)
        res["ledger"] = ledger_report("config 1 (fused engine open)")
    finally:
        await e.close()
    t0 = time.perf_counter()
    res["parts"] = await parts_phase(ba, mg, store, T0, per_host, hosts,
                                     interval, segment_ms, vals)
    log(f"phase parts: {time.perf_counter() - t0!r} s")
    return res


def host_major_reference(vals32, hosts: int, per_host: int, T0: int,
                         interval: int, bucket_ms: int,
                         num_buckets: int) -> dict:
    """numpy grids of the end-to-end rows (row i: tick i // hosts, host
    i % hosts, bucket-aligned T0) in host order, with the combine's
    empty-cell conventions: count, sum, min, max, avg, last, last_ts
    (absolute ms)."""
    import numpy as np

    vh = vals32.reshape(per_host, hosts).T  # (hosts, ticks), time order
    tpb = bucket_ms // interval
    starts = np.arange(0, per_host, tpb)
    ends = np.append(starts[1:], per_host)
    k = len(starts)
    out = {"count": np.zeros((hosts, num_buckets)),
           "sum": np.zeros((hosts, num_buckets)),
           "min": np.full((hosts, num_buckets), np.inf),
           "max": np.full((hosts, num_buckets), -np.inf),
           "avg": np.full((hosts, num_buckets), np.nan),
           "last": np.full((hosts, num_buckets), np.nan),
           "last_ts": np.full((hosts, num_buckets), np.nan)}
    out["count"][:, :k] = ends - starts
    out["sum"][:, :k] = np.add.reduceat(vh.astype(np.float64), starts, 1)
    out["min"][:, :k] = np.minimum.reduceat(vh, starts, 1)
    out["max"][:, :k] = np.maximum.reduceat(vh, starts, 1)
    out["avg"][:, :k] = out["sum"][:, :k] / out["count"][:, :k]
    out["last"][:, :k] = vh[:, ends - 1]
    out["last_ts"][:, :k] = T0 + (ends - 1) * interval
    return out


def same_bytes(a: dict, b: dict, what: str) -> None:
    """Two query_downsample results byte for byte: tsids and every grid
    (host arrays or tensors)."""
    import numpy as np

    if a["tsids"] != b["tsids"] or sorted(a["aggs"]) != sorted(b["aggs"]):
        raise AssertionError(f"{what}: tsids or aggregates differ")
    for k in a["aggs"]:
        x, y = (np.asarray(v if isinstance(v, np.ndarray)
                           else v.cpu().numpy())
                for v in (a["aggs"][k], b["aggs"][k]))
        if x.dtype != y.dtype or x.tobytes() != y.tobytes():
            raise AssertionError(f"{what}: grid {k} differs in its bytes")


def decode_counts() -> dict:
    """The device decode's counters: stage rows, routes, fallbacks."""
    from horaedb_tpu_torch.ops import device_decode as dd

    out = {"rows": dd._STAGE_ROWS.value, "sorted": dd._SORT_RAN.value}
    out.update({r: c.value for r, c in dd._SORT_SKIPPED.items()})
    out.update({f"fallback:{r}": v for r, v in dd.fallback_counts().items()})
    return out


def counts_delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after}


async def decode_alone(e, full: tuple, plan) -> dict:
    """The device decode of single segments with nothing else running:
    the engine's own plan and predicate, each segment read, then
    dispatched and finalized alone, timed on the host clock to its
    synchronized end (the k-way segments and the first 16 others)."""
    import torch

    from horaedb_tpu_torch.storage.read import AggregateSpec, ScanRequest
    from horaedb_tpu_torch.storage.types import TimeRange

    data = e.tables["data"]
    reader = data.reader
    pred = await e._resolve_data_predicate(
        "cpu", [], TimeRange.new(*full), "value", ts_leaf=False)
    spec = AggregateSpec(group_col="tsid", ts_col="timestamp",
                         value_col="value", range_start=full[0],
                         bucket_ms=BMS,
                         num_buckets=(full[1] - full[0]) // BMS,
                         which=("avg",))
    qplan = await data.build_scan_plan(ScanRequest(
        range=TimeRange.new(*full), predicate=pred))
    qplan.decode_spec = spec
    multi = [s for s in qplan.segments if len(s.ssts) > 1]
    single = [s for s in qplan.segments if len(s.ssts) == 1][:16]
    out = {}
    prof = cProfile.Profile()
    reads = []
    for name, segs in (("compacted", single), ("kway", multi)):
        read = [await reader._read_segment_encoded(seg, qplan)
                for seg in segs]
        reads += read
        times = []
        for es in read:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            part = reader._dispatch_device_decode(es, qplan)
            times.append((time.perf_counter() - t0) * 1e3)
            if part is None or part.part is None:
                raise AssertionError(f"decode alone: {name} segment "
                                     f"declined")
        # the same dispatches again under the profiler (its cost shifts
        # the proportions, so the times above are taken without it)
        for es in read:
            prof.enable()
            reader._dispatch_device_decode(es, qplan)
            prof.disable()
        out[name] = {"segments": len(segs), "ms": times,
                     "median_ms": statistics.median(times) if times else None}
    log(f"parts: device decode of one segment alone, median "
        f"{out['compacted']['median_ms']!r} ms over "
        f"{out['compacted']['segments']} single-SST segments, "
        f"{out['kway']['median_ms']!r} ms over {out['kway']['segments']} "
        f"k-way segments (host clock, to the synchronized end)")
    # all of them again from 4 threads at once, nothing else running:
    # does a dispatch slow down beside other dispatches alone?
    def timed(es):
        t0 = time.perf_counter()
        reader._dispatch_device_decode(es, qplan)
        return (time.perf_counter() - t0) * 1e3

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=4) as pool:
        conc = list(pool.map(timed, reads))
    wall = (time.perf_counter() - t0) * 1e3
    out["concurrent"] = {"threads": 4, "segments": len(reads),
                         "median_ms": statistics.median(conc),
                         "wall_ms": wall, "ms": conc}
    log(f"parts: the same {len(reads)} dispatches from 4 threads at once: "
        f"median {statistics.median(conc)!r} ms each, {wall!r} ms wall "
        f"(sequential: {sum(out['compacted']['ms'] + out['kway']['ms'])!r} "
        f"ms)")
    # where the host time of those dispatches goes, by function
    st = pstats.Stats(prof)
    rows = sorted(st.stats.items(), key=lambda kv: -kv[1][2])[:15]
    out["host_profile"] = [
        {"fn": f"{os.path.basename(f)}:{ln}:{fn}", "calls": nc,
         "tottime_ms": tt * 1e3, "cumtime_ms": ct * 1e3}
        for (f, ln, fn), (_cc, nc, tt, ct, _callers) in rows]
    for r in out["host_profile"]:
        log(f"parts: decode alone host profile: {r['fn']} calls "
            f"{r['calls']} self {r['tottime_ms']:.3f} ms cumulative "
            f"{r['cumtime_ms']:.3f} ms")
    return out


async def parts_phase(ba, mg, store, T0: int, per_host: int, hosts: int,
                      interval: int, segment_ms: int, vals) -> dict:
    """BASELINE config 1 on the parts path: two more engines on the same
    store with the default StorageConfig, one as it is ([scan.decode]
    mode "auto": device decode on the card) and one with mode "host"
    (host decode, the control), run in turns: device, host, device,
    host."""
    import numpy as np
    import torch

    from horaedb_tpu_torch.metric_engine import MetricEngine
    from horaedb_tpu_torch.metric_engine.types import Label, tsid_of
    from horaedb_tpu_torch.ops.encode import h2d_bytes
    from horaedb_tpu_torch.storage.config import StorageConfig, from_dict
    from horaedb_tpu_torch.storage.read import ScanRequest
    from horaedb_tpu_torch.storage.types import TimeRange
    from horaedb_tpu_torch.utils import registry

    engines = {
        "device": await MetricEngine.open("bench", store,
                                          segment_ms=segment_ms,
                                          config=StorageConfig()),
        "host": await MetricEngine.open("bench", store,
                                        segment_ms=segment_ms,
                                        config=from_dict(StorageConfig, {
                                            "scan": {"decode": {
                                                "mode": "host"}}}))}
    try:
        n_seg = -(-per_host * interval // segment_ms)
        # the full range, whole segments: bucket-aligned at 1 min and 1 h,
        # so it carries no time leaf and a narrowed range shares its memo
        full = (T0, T0 + n_seg * segment_ms)
        data = engines["device"].tables["data"]
        plan = await data.build_scan_plan(
            ScanRequest(range=TimeRange.new(*full)))
        est = sum(f.meta.num_rows for sg in plan.segments for f in sg.ssts)
        for name, e in engines.items():
            if e.tables["data"].reader.fused_aggregate_ok(plan):
                raise AssertionError(f"parts: the fused gate took the plan "
                                     f"at the default budget ({name})")
        multi = [len(sg.ssts) for sg in plan.segments if len(sg.ssts) > 1]
        log(f"parts: the fused gate declines at the default budget: {est:,} "
            f"rows x 32 B = {est * 32:,} B > "
            f"{data.reader.cache_budget_bytes:,} B ({len(plan.segments)} "
            f"segments, {len(multi)} of them with more than one SST: "
            f"{multi})")
        tsid_of_host = np.array([tsid_of("cpu", [Label("host",
                                                       f"host_{i:03d}")])
                                 for i in range(hosts)], dtype=np.uint64)
        order = np.argsort(tsid_of_host)
        vals32 = vals.astype(np.float32)

        def delta(before: dict) -> dict:
            now = registry.snapshot()
            d = {k: now[k] - before.get(k, 0.0) for k in now
                 if k.startswith(("scan_stage_seconds{", "scan_parts_",
                                  "scan_partials_", "scan_combine_memo",
                                  "scan_decode_", "scan_stage_rows",
                                  "scan_stage_bytes"))}
            return {k: v for k, v in d.items()
                    if v or k == "scan_parts_rounds_total"}

        def check(out, bucket_ms, exact, close):
            nb = (full[1] - full[0]) // bucket_ms
            want = host_major_reference(vals32, hosts, per_host, T0,
                                        interval, bucket_ms, nb)
            if out["tsids"] != [int(t) for t in tsid_of_host[order]]:
                raise AssertionError("parts: tsids differ")
            for k in exact:
                if not np.array_equal(out["aggs"][k], want[k][order],
                                      equal_nan=True):
                    raise AssertionError(f"parts: {k} differs from numpy")
            for k in close:
                np.testing.assert_allclose(out["aggs"][k], want[k][order],
                                           rtol=1e-5)

        async def leg(name: str, turn: int) -> dict:
            e = engines[name]
            data = e.tables["data"]
            reader = data.reader

            async def query(rng, bucket_ms, aggs):
                snap, h2d0 = registry.snapshot(), h2d_bytes()
                t0 = time.perf_counter()
                out = await e.query_downsample(
                    "cpu", [], TimeRange.new(*rng), bucket_ms=bucket_ms,
                    aggs=aggs)
                torch.cuda.synchronize()
                d = delta(snap)
                d["h2d_bytes"] = h2d_bytes() - h2d0
                return out, (time.perf_counter() - t0) * 1e3, d

            tag = f"parts [{name} decode, turn {turn}]"
            reader.scan_cache.clear()
            reader.parts_memo.clear()
            reader.encoded_cache.clear()
            # the main path's run: launch counts from 0, read right after
            ba.reset_launches()
            mg.reset_launches()
            c0 = decode_counts()
            torch.cuda.reset_peak_memory_stats()
            cold, cold_ms, cold_d = await query(full, BMS, ("avg",))
            peak = torch.cuda.max_memory_allocated()
            stack = reader.cache_stats()["stack_cache"]
            launches = dict(ba.LAUNCHES, **mg.LAUNCHES)
            dc = counts_delta(c0, decode_counts())
            rounds = int(cold_d["scan_parts_rounds_total"])
            falls = {k: v for k, v in dc.items()
                     if k.startswith("fallback:") and v}
            dc = {k: v for k, v in dc.items() if not k.startswith("fallback:")}
            if name == "device":
                routed = dc["compacted"] + dc["checked"] + dc["kway"]
                levels = sum(k.bit_length() for k in multi)
                if not (dc["rows"] == est and routed == len(plan.segments)
                        and dc["sorted"] == 0 and not falls
                        and dc["kway"] == len(multi)):
                    raise AssertionError(f"{tag}: device decode did not "
                                         f"serve every segment: {dc}")
                if not (launches["bucket_window_partials"] == routed
                        and rounds == 0
                        and launches["bucket_round_accumulate"] == 0
                        and launches["kway_merge_perm"] == levels):
                    raise AssertionError(
                        f"{tag}: launches {launches}, {rounds} host rounds; "
                        f"want {routed} partials and {levels} merge levels")
            elif not (launches["bucket_window_partials"] == rounds > 0
                      and launches["bucket_round_accumulate"] == 0
                      and launches["kway_merge_perm"] == 0
                      and dc["rows"] == 0 and not falls):
                raise AssertionError(f"{tag}: launches {launches} for "
                                     f"{rounds} rounds, decode {dc}")
            if stack["entries"] or stack["hits"] or stack["misses"]:
                raise AssertionError(f"{tag}: the parts path went through "
                                     f"the stack cache: {stack}")
            check(cold, BMS, ("count",), ("avg",))
            log(f"{tag}: cold avg at 1 min {cold_ms!r} ms; launches "
                f"{launches}, {rounds} host rounds; decode counters {dc}; "
                f"grids match numpy (count exact, avg rtol 1e-5); peak "
                f"device memory {peak} B; stack cache untouched; "
                f"stages {json.dumps(cold_d)}")

            memo0 = reader.parts_memo.stats()["hits"]
            repeat, repeat_ms, repeat_d = await query(full, BMS, ("avg",))
            hits = reader.parts_memo.stats()["hits"] - memo0
            if hits != len(plan.segments):
                raise AssertionError(f"{tag}: repeat served {hits} of "
                                     f"{len(plan.segments)} segments from "
                                     f"memo")
            same_bytes(repeat, cold, f"{tag}: memo-served repeat")

            # interior whole segments: the same bucket phase, no time leaf
            a, b = n_seg // 4, n_seg - n_seg // 4
            narrow = (T0 + a * segment_ms, T0 + b * segment_ms)
            memo0 = reader.parts_memo.stats()["hits"]
            nar, nar_ms, nar_d = await query(narrow, BMS, ("avg",))
            nar_hits = reader.parts_memo.stats()["hits"] - memo0
            if nar_hits != b - a:
                raise AssertionError(f"{tag}: narrowed range: {nar_hits} "
                                     f"memo hits for {b - a} segments")
            for mode in ("sparse", "dense"):
                data.config.scan.combine.mode = mode
                reader.scan_cache.clear()
                reader.parts_memo.clear()
                reader.encoded_cache.clear()
                same_bytes(nar, (await query(narrow, BMS, ("avg",)))[0],
                           f"{tag}: narrowed vs {mode}")
            data.config.scan.combine.mode = "sparse"

            hour = []
            for _ in range(2):
                reader.scan_cache.clear()
                reader.parts_memo.clear()
                reader.encoded_cache.clear()
                hour.append(await query(full, 3_600_000, ALL_AGGS))
            check(hour[0][0], 3_600_000,
                  ("count", "min", "max", "last", "last_ts"), ("sum", "avg"))
            same_bytes(hour[0][0], hour[1][0], f"{tag}: cold 1 h twice")
            log(f"{tag}: memo-served repeat {repeat_ms!r} ms ({hits} memo "
                f"hits); narrowed (segments {a}-{b - 1}) {nar_ms!r} ms "
                f"({nar_hits} hits, bytes equal to sparse and dense "
                f"recomputes); cold 1 h all aggregates {hour[0][1]!r} / "
                f"{hour[1][1]!r} ms, numpy-checked, byte-equal")
            return {"cold": cold, "hour": hour[0][0], "numbers": {
                "cold_ms": cold_ms, "memo_ms": repeat_ms,
                "narrowed_ms": nar_ms, "hour_cold_ms": [h[1] for h in hour],
                "launches": launches, "host_rounds": rounds,
                "decode_counts": dc, "peak_device_memory": peak,
                "stack_cache": stack,
                "cold_stages": cold_d, "memo_stages": repeat_d,
                "narrowed_stages": nar_d, "hour_stages": hour[0][2]}}

        turns = {"device": [], "host": []}
        for turn in (1, 2):
            for name in ("device", "host"):
                turns[name].append(await leg(name, turn))
        for turn in range(2):
            dev, host = turns["device"][turn], turns["host"][turn]
            same_bytes(dev["cold"], host["cold"],
                       f"parts: device vs host decode, cold 1 min avg, "
                       f"turn {turn + 1}")
            same_bytes(dev["hour"], host["hour"],
                       f"parts: device vs host decode, cold 1 h all "
                       f"aggregates, turn {turn + 1}")
        log("parts: device decode and host decode byte-equal (cold 1 min "
            "avg, cold 1 h all aggregates) in both turns")
        reads = await parts_reads_legs(engines, store, turns, full, check,
                                       T0, per_host, hosts, interval,
                                       segment_ms, vals32, tsid_of_host)
        # the top-k legs on the device-decode engine, over the fused
        # cell's range (whole 1 min buckets)
        nb = -(-per_host * interval // BMS)
        want = host_major_reference(vals32, hosts, per_host, T0, interval,
                                    BMS, nb)
        topk = await topk_legs(engines["device"], "parts",
                               TimeRange.new(T0, T0 + nb * BMS), nb,
                               {k: v[order] for k, v in want.items()},
                               [int(t) for t in tsid_of_host[order]])
        log(f"parts: peak device memory of the cold query by turn: device "
            f"leg {[t['numbers']['peak_device_memory'] for t in turns['device']]}"
            f" B, host leg "
            f"{[t['numbers']['peak_device_memory'] for t in turns['host']]} B")
        alone = await decode_alone(engines["device"], full, plan)
        e = engines["device"]
        e.tables["data"].reader.parts_memo.clear()
        e.tables["data"].reader.scan_cache.clear()
        prof = await profile_query(lambda: e.query_downsample(
            "cpu", [], TimeRange.new(*full), bucket_ms=BMS, aggs=("avg",)))
        prof.pop("out")
        log(f"parts: one cold device-decode query under torch.profiler: "
            f"{prof['kernels']} device kernels, {prof['copies_and_sets']} "
            f"copies/sets, device busy {prof['device_busy_us']!r} us; by "
            f"name: " + json.dumps(prof["busy_us_by_name"]))
        first = turns["device"][0]["numbers"]["launches"]
        return {"launches": first["bucket_window_partials"],
                "kway_launches": first["kway_merge_perm"],
                "segments": len(plan.segments), "multi_sst_segments": multi,
                "est_rows": est,
                "budget_bytes": data.reader.cache_budget_bytes,
                "device": [t["numbers"] for t in turns["device"]],
                "host": [t["numbers"] for t in turns["host"]],
                "decode_alone": alone, "cold_profile": prof,
                "reads": reads, "topk": topk}
    finally:
        for e in engines.values():
            await e.close()


async def parts_reads_legs(engines, store, turns, full, check, T0: int,
                           per_host: int, hosts: int, interval: int,
                           segment_ms: int, vals32, tsid_of_host) -> dict:
    """The cold-read legs of the parts path with device decode: a true
    cold query (every tier empty) and the same query served from tier 2;
    the pipeline on and off in turns; a filtered query (host_042); and
    a streamed check leg.  Every grid is held against the device leg's
    cold grids byte for byte, or against numpy."""
    import numpy as np
    import torch

    from horaedb_tpu_torch.metric_engine import MetricEngine
    from horaedb_tpu_torch.ops.encode import h2d_bytes
    from horaedb_tpu_torch.storage import sidecar
    from horaedb_tpu_torch.storage.config import StorageConfig, from_dict
    from horaedb_tpu_torch.storage.read import ScanRequest
    from horaedb_tpu_torch.storage.types import TimeRange
    from horaedb_tpu_torch.utils import registry

    e = engines["device"]
    reader = e.tables["data"].reader
    want = turns["device"][0]["cold"]

    async def query(eng, filters=(), rng=full):
        r = eng.tables["data"].reader
        snap, h2d0 = registry.snapshot(), h2d_bytes()
        got0, pipe0 = store.snap(), pipeline_snap(r)
        t0 = time.perf_counter()
        out = await eng.query_downsample("cpu", list(filters),
                                         TimeRange.new(*rng), bucket_ms=BMS,
                                         aggs=("avg",))
        torch.cuda.synchronize()
        now = registry.snapshot()
        rec = {"ms": (time.perf_counter() - t0) * 1e3,
               "h2d_bytes": h2d_bytes() - h2d0,
               "segment_read_s": now.get(STAGE_SECONDS % "segment_read",
                                         0.0)
               - snap.get(STAGE_SECONDS % "segment_read", 0.0),
               **store.since(got0), **pipeline_since(r, pipe0)}
        return out, rec

    res = {}
    true_cold(reader)
    got, res["true_cold"] = await query(e)
    same_bytes(got, want, "parts: true cold vs the device leg's cold")
    reader.scan_cache.clear()
    reader.parts_memo.clear()
    got, res["tier2_served"] = await query(e)
    same_bytes(got, want, "parts: tier-2-served vs true cold")
    if res["tier2_served"]["gets"] and \
            not reader.encoded_cache.stats()["evictions"]:
        raise AssertionError(f"parts: tier-2-served query made "
                             f"{res['tier2_served']['gets']} store GETs")
    for what in ("true_cold", "tier2_served"):
        r = res[what]
        log(f"parts [device decode] {what}: {r['ms']!r} ms, {r['gets']} "
            f"store GETs of {r['get_bytes']} B, segment_read "
            f"{r['segment_read_s']!r} s summed, {r['h2d_bytes']} B "
            f"host-to-device")
    log(f"parts: tier-2-served grids byte-equal to true cold; tier 2 "
        f"{json.dumps(reader.encoded_cache.stats())}")

    res["pipeline_turns"] = []
    for enabled in (True, False, True, False):
        reader.config.scan.pipeline.enabled = enabled
        true_cold(reader)
        got, rec = await query(e)
        same_bytes(got, want, f"parts: pipeline {enabled} vs cold")
        rec["enabled"] = enabled
        res["pipeline_turns"].append(rec)
    reader.config.scan.pipeline.enabled = True
    log(f"parts [device decode]: pipeline on/off/on/off on true-cold "
        f"queries ({os.cpu_count()} host cores): "
        + "; ".join(f"{'on' if r['enabled'] else 'off'} {r['ms']!r} ms, "
                    f"stalls {json.dumps(r['stalls'])}, high-water "
                    f"{r['high_water_bytes']} B"
                    for r in res["pipeline_turns"])
        + "; grids byte-equal")

    # one host: a label filter whose leaves reach the segment reads
    true_cold(reader)
    plan = await e.tables["data"].build_scan_plan(
        ScanRequest(range=TimeRange.new(*full)))
    n_ssts = sum(len(sg.ssts) for sg in plan.segments)
    got, rec = await query(e, [("host", "host_042")])
    nb = (full[1] - full[0]) // BMS
    ref = host_major_reference(vals32, hosts, per_host, T0, interval, BMS,
                               nb)
    if got["tsids"] != [int(tsid_of_host[42])]:
        raise AssertionError(f"parts filtered: tsids {got['tsids']}")
    if not np.array_equal(np.asarray(got["aggs"]["count"])[0],
                          ref["count"][42]):
        raise AssertionError("parts filtered: count differs from numpy")
    np.testing.assert_allclose(np.asarray(got["aggs"]["avg"])[0],
                               ref["avg"][42], rtol=1e-5)
    # a sidecar loads block-pruned only when at most half its rows may
    # match (storage/sidecar.py, _PARTIAL_MAX_FRAC); past that it is read
    # whole after a header probe, so the filter may add one probe a SST
    probe = sidecar._HEAD_BYTES
    if rec["get_bytes"] > res["true_cold"]["get_bytes"] + n_ssts * probe:
        raise AssertionError(f"parts filtered: {rec['get_bytes']} B "
                             f"fetched, unfiltered "
                             f"{res['true_cold']['get_bytes']} B")
    res["filtered"] = rec
    log(f"parts [device decode] filtered host = 'host_042', true cold: "
        f"{rec['ms']!r} ms, {rec['gets']} store GETs of {rec['get_bytes']} "
        f"B (unfiltered: {res['true_cold']['gets']} GETs of "
        f"{res['true_cold']['get_bytes']} B; {n_ssts} data SSTs of "
        f"{per_host * hosts // n_ssts:,} rows on average, "
        f"{sidecar.BLOCK_ROWS:,}-row sidecar blocks), {rec['h2d_bytes']} B "
        f"host-to-device; grids match numpy")

    # streamed check leg (not a cell): windows of 16,384 rows, segments
    # over 32,768 rows read window by window
    cut = {"max_window_rows": 16_384, "stream_read_min_rows": 32_768}
    log(f"streamed: scale cuts max_window_rows {cut['max_window_rows']:,} "
        f"(default {StorageConfig().scan.max_window_rows:,}) and "
        f"stream_read_min_rows {cut['stream_read_min_rows']:,} (default "
        f"{StorageConfig().scan.stream_read_min_rows:,})")
    s_e = await MetricEngine.open("bench", store, segment_ms=segment_ms,
                                  config=from_dict(StorageConfig,
                                                   {"scan": cut}))
    try:
        s_r = s_e.tables["data"].reader
        plan_segs = await s_e.tables["data"].build_scan_plan(
            ScanRequest(range=TimeRange.new(*full)))
        streamed = sum(1 for sg in plan_segs.segments
                       if s_r._stream_segment(sg))
        if streamed != len(plan_segs.segments):
            raise AssertionError(f"streamed: {streamed} of "
                                 f"{len(plan_segs.segments)} segments "
                                 f"stream")
        side0 = registry.snapshot().get(
            'scan_stage_rows_total{stage="sidecar_read"}', 0.0)
        got, rec = await query(s_e)
        side = registry.snapshot().get(
            'scan_stage_rows_total{stage="sidecar_read"}', 0.0) - side0
        same_bytes(got, want, "streamed vs the bulk read")
        check(got, BMS, ("count",), ("avg",))
        rec["segments"] = streamed
        rec["sidecar_rows"] = side
        res["streamed"] = rec
        log(f"streamed: {streamed} segments read window by window from "
            f"the sidecars ({int(side):,} rows): {rec['ms']!r} ms, "
            f"{rec['gets']} store GETs of {rec['get_bytes']} B; grids "
            f"byte-equal to the bulk read and match numpy")
    finally:
        await s_e.close()
    return res


async def compaction_phase(ba, mg) -> dict:
    """4 overlapping SSTs in each of 12 segments, both paths (the parts
    path with device decode and with host decode), compaction to one SST
    per segment, all three again, then the scrubber."""
    import numpy as np
    import pyarrow as pa

    from horaedb_tpu_torch.metric_engine import MetricEngine
    from horaedb_tpu_torch.objstore import MemoryObjectStore
    from horaedb_tpu_torch.storage.config import StorageConfig, from_dict
    from horaedb_tpu_torch.storage.sst import segment_of
    from horaedb_tpu_torch.storage.types import TimeRange

    hosts, interval, segment_ms, n_seg = 100, 10_000, 2 * 3600 * 1000, 12
    ticks = n_seg * segment_ms // interval
    T0 = (1_700_000_000_000 // segment_ms) * segment_ms
    rng = np.random.default_rng(2)
    names = pa.array([f"host_{i:03d}" for i in range(hosts)])
    store = MemoryObjectStore()
    cfg = from_dict(StorageConfig, {"scheduler": {
        "schedule_interval": "1h", "input_sst_min_num": 4}})
    e = await MetricEngine.open("compact", store, segment_ms=segment_ms,
                                config=cfg)
    try:
        # batch 0: every host; batches 1-3: 30 hosts each, newer values
        for k, hs in enumerate((np.arange(hosts), np.arange(0, 30),
                                np.arange(20, 50), np.arange(40, 70))):
            tick = np.repeat(np.arange(ticks, dtype=np.int64), len(hs))
            host = np.tile(hs.astype(np.int32), ticks)
            await e.write_arrow("cpu", ["host"], pa.record_batch({
                "host": pa.DictionaryArray.from_arrays(pa.array(host), names),
                "timestamp": pa.array(T0 + tick * interval),
                "value": pa.array(rng.random(len(tick)) * 100 + 1000 * k)}))
        data = e.tables["data"]

        async def per_segment() -> list:
            return [segment_of(f, segment_ms)
                    for f in await data.manifest.all_ssts()]

        segs = await per_segment()
        if sorted(segs.count(s) for s in set(segs)) != [4] * n_seg:
            raise AssertionError(f"compaction: SSTs per segment "
                                 f"{sorted(segs.count(s) for s in set(segs))}")
        rng_q = TimeRange.new(T0, T0 + n_seg * segment_ms)

        async def both(when: str) -> dict:
            """The fused path, then the parts path with device decode
            ("auto" on the card) and with host decode, every cache cold
            before each parts leg (so neither is served the other's
            windows or parts)."""
            out = {}
            for path, flags in (
                    ("fused", {"HORAEDB_FUSED_AGG": "1"}),
                    ("parts", {"HORAEDB_FUSED_AGG": "0"}),
                    ("parts_host", {"HORAEDB_FUSED_AGG": "0",
                                    "HORAEDB_DEVICE_DECODE": "0"})):
                if path != "fused":
                    data.reader.scan_cache.clear()
                    data.reader.parts_memo.clear()
                os.environ.update(flags)
                ba.reset_launches()
                mg.reset_launches()
                c0 = decode_counts()
                try:
                    out[path] = await e.query_downsample(
                        "cpu", [], rng_q, bucket_ms=600_000, aggs=ALL_AGGS)
                finally:
                    for k in flags:
                        del os.environ[k]
                dc = counts_delta(c0, decode_counts())
                kway = mg.LAUNCHES["kway_merge_perm"]
                if path == "parts":
                    route = "kway" if when == "before" else "compacted"
                    if not (dc[route] == n_seg and dc["sorted"] == 0
                            and kway == (3 * n_seg if route == "kway" else 0)
                            and not any(v for k, v in dc.items()
                                        if k.startswith("fallback:"))):
                        raise AssertionError(
                            f"compaction: device decode {when} compaction: "
                            f"{dc}, {kway} merge launches")
                    log(f"compaction: {when} compaction the parts path's "
                        f"{n_seg} segments took the {route} route on the "
                        f"card ({kway} kway_merge_perm launches, "
                        f"{int(dc['rows'])} source rows decoded)")
                elif dc["rows"] or kway:
                    raise AssertionError(f"compaction: {path} engaged the "
                                         f"device decode")
            same_bytes(out["parts"], out["parts_host"],
                       f"compaction: device vs host decode {when}")
            return out

        before = await both("before")
        for path, out in before.items():
            count = out["aggs"]["count"]
            count = np.asarray(count if isinstance(count, np.ndarray)
                               else count.cpu().numpy())
            if count.shape != (hosts, n_seg * 12) or not (count == 60).all():
                raise AssertionError(f"compaction: {path} counts before "
                                     f"compaction are not 60 per cell")
        t0 = time.perf_counter()
        deadline = t0 + 300
        while True:
            segs = await per_segment()
            if len(segs) == len(set(segs)) == n_seg:
                break
            if time.perf_counter() > deadline:
                raise AssertionError("compaction: segments not compacted "
                                     "within 300 s")
            await data.compact()
            await asyncio.sleep(0.25)
        compact_s = time.perf_counter() - t0
        misses0 = data.reader.scan_cache.misses
        memo0 = data.reader.parts_memo.stats()
        after = await both("after")
        memo1 = data.reader.parts_memo.stats()
        if (data.reader.scan_cache.misses - misses0 < n_seg
                or memo1["hits"] != memo0["hits"]
                or memo1["misses"] - memo0["misses"] < n_seg):
            raise AssertionError("compaction: the scan cache or the memo "
                                 "served compacted segments")
        same_bytes(after["parts"], before["parts"],
                   "compaction: parts path before/after")
        exact = {k: v for k, v in after["fused"]["aggs"].items()
                 if k not in ("sum", "avg")}
        same_bytes({"tsids": after["fused"]["tsids"], "aggs": exact},
                   {"tsids": before["fused"]["tsids"],
                    "aggs": {k: before["fused"]["aggs"][k] for k in exact}},
                   "compaction: fused path before/after")
        worst = 0.0
        for k in ("sum", "avg"):
            a = after["fused"]["aggs"][k].cpu().numpy()
            b = before["fused"]["aggs"][k].cpu().numpy()
            np.testing.assert_allclose(a, b, rtol=1e-5)
            worst = max(worst, float(np.abs(a.astype(np.float64) - b).max()))
        log(f"compaction: 48 SSTs -> {n_seg} in {compact_s!r} s; device "
            f"and host decode byte-equal before and after it; after it "
            f"the parts path is byte-equal to before, the fused path exact "
            f"in count/min/max/last and within rtol 1e-5 in sum/avg "
            f"(max_abs_err {worst!r}); scan cache and memo missed every "
            f"compacted segment")

        data_dir = "compact/data/data/"
        live = sorted(m.path for m in await store.list(data_dir))
        orphan = f"{data_dir}1.sst"
        await store.put(orphan, b"orphan")
        report = await data.scrub(grace_override_s=0.0)
        left = sorted(m.path for m in await store.list(data_dir))
        ids = {f.id for f in await data.manifest.all_ssts()}
        want = sorted(f"{data_dir}{i}{ext}" for i in ids
                      for ext in (".sst", ".enc"))
        if report.orphans_deleted != 1 or left != live or left != want:
            raise AssertionError(f"compaction: scrub {report.as_dict()}")
        log(f"compaction: the scrubber deleted the injected orphan and kept "
            f"all {len(ids)} referenced SSTs and their sidecars "
            f"({report.as_dict()})")
        return {"compact_s": compact_s, "fused_max_abs_err": worst,
                "scrub": report.as_dict()}
    finally:
        await e.close()


def counting_store():
    """A MemoryObjectStore that counts its data-plane reads: GETs and
    ranged GETs of sidecars (.enc) and SSTs (.sst), and their bytes."""
    from horaedb_tpu_torch.objstore import MemoryObjectStore

    class CountingStore(MemoryObjectStore):
        def __init__(self):
            super().__init__()
            self.gets = 0
            self.get_bytes = 0

        def _count(self, path: str, data: bytes) -> bytes:
            if path.endswith((".enc", ".sst")):
                self.gets += 1
                self.get_bytes += len(data)
            return data

        async def get(self, path):
            return self._count(path, await super().get(path))

        async def get_range(self, path, start, end):
            data = await MemoryObjectStore.get(self, path)
            if not (start == 0 and end >= len(data)):
                data = data[start:end]
            return self._count(path, data)

        def snap(self) -> tuple:
            return self.gets, self.get_bytes

        def since(self, snap: tuple) -> dict:
            return {"gets": self.gets - snap[0],
                    "get_bytes": self.get_bytes - snap[1]}

    return CountingStore()


def pipeline_snap(reader) -> dict:
    """The pipeline's stall counts now; zeroes the reader's high-water,
    so the next query records its own."""
    from horaedb_tpu_torch.storage import pipeline

    reader._pipeline_high_water = 0
    return pipeline.stall_counts()


def pipeline_since(reader, snap: dict) -> dict:
    from horaedb_tpu_torch.storage import pipeline

    now = pipeline.stall_counts()
    return {"stalls": {k: now[k] - snap[k] for k in now},
            "high_water_bytes": reader._pipeline_high_water}


def true_cold(reader) -> None:
    """Every tier of one table's reader emptied: the window cache, the
    device state, tier 2 and the parts memo."""
    reader.drop_hbm_state()
    reader.scan_cache.clear()
    reader.encoded_cache.clear()
    reader.parts_memo.clear()


def scratch_dir(tag: str) -> str:
    """A fresh directory on the machine's disk beside this script (the
    WAL's fsyncs must reach a real file system); removed by the caller."""
    import tempfile

    return tempfile.mkdtemp(prefix=f".wal_smoke_{tag}_",
                            dir=os.path.dirname(os.path.abspath(__file__)))


async def wal_ingest_leg() -> dict:
    """Leg (a), host work: acked writes/s and p99 ack latency at one row
    per write under 32 concurrent writers on a LocalObjectStore, one SST
    per write (256 writes) against the WAL at max_group_wait 0, 1 and 4
    ms (2,000 writes each); every acked row read back after a flush.
    The shape of the JAX package's bench config 8
    (horaedb_tpu/bench/suite.py:976)."""
    import shutil

    import numpy as np
    import pyarrow as pa

    from horaedb_tpu_torch.common import ReadableDuration
    from horaedb_tpu_torch.objstore.local import LocalObjectStore
    from horaedb_tpu_torch.storage.config import StorageConfig, from_dict
    from horaedb_tpu_torch.storage.read import ScanRequest
    from horaedb_tpu_torch.storage.storage import (CloudObjectStorage,
                                                   WriteRequest)
    from horaedb_tpu_torch.storage.types import TimeRange
    from horaedb_tpu_torch.wal import IngestStorage, WalConfig

    seg_ms, writers = 3_600_000, 32
    schema = pa.schema([("k", pa.string()), ("ts", pa.int64()),
                        ("v", pa.float64())])

    def storage_cfg():
        c = from_dict(StorageConfig, {
            "scheduler": {"schedule_interval": "1h"}})
        c.manifest.merge_interval = ReadableDuration.parse("1h")
        c.scrub.interval = ReadableDuration.parse("1h")
        return c

    async def drive(s, n):
        lat = []

        async def worker(w):
            for i in range(w, n, writers):
                ts = 10 + i
                b = pa.record_batch(
                    [pa.array([f"k{i % 97}"]), pa.array([ts], pa.int64()),
                     pa.array([float(i)], pa.float64())], schema=schema)
                t0 = time.perf_counter()
                await s.write(WriteRequest(b, TimeRange.new(ts, ts + 1)))
                lat.append(time.perf_counter() - t0)

        t0 = time.perf_counter()
        await asyncio.gather(*[worker(w) for w in range(writers)])
        wall = time.perf_counter() - t0
        return {"writes": n, "writes_per_s": n / wall,
                "p99_ack_ms": float(np.percentile(lat, 99) * 1e3),
                "p50_ack_ms": float(np.percentile(lat, 50) * 1e3)}

    async def read_back(s, n):
        got = {}
        async for b in s.scan(ScanRequest(range=TimeRange.new(0, 10**9))):
            for ts, v in zip(b.column(1).to_pylist(), b.column(2).to_pylist()):
                got[ts] = v
        if got != {10 + i: float(i) for i in range(n)}:
            raise AssertionError(f"wal (a): {len(got)} rows read back of "
                                 f"{n} acked")

    out = {}
    tmp = scratch_dir("a")
    try:
        s = await CloudObjectStorage.open("db", seg_ms,
                                          LocalObjectStore(f"{tmp}/base"),
                                          schema, 2, storage_cfg())
        try:
            out["baseline"] = await drive(s, 256)
            await read_back(s, 256)
        finally:
            await s.close()
        log(f"wal (a) [host work]: one SST per write: "
            f"{out['baseline']['writes_per_s']!r} acked writes/s, p99 ack "
            f"{out['baseline']['p99_ack_ms']!r} ms (256 writes, 32 writers)")
        for wait_ms in (0, 1, 4):
            inner = await CloudObjectStorage.open(
                "db", seg_ms, LocalObjectStore(f"{tmp}/data{wait_ms}"),
                schema, 2, storage_cfg())
            wc = WalConfig(
                enabled=True, dir=f"{tmp}/wal{wait_ms}",
                max_group_wait=ReadableDuration.from_millis(wait_ms),
                flush_rows=1 << 30, flush_bytes=1 << 40,
                flush_age=ReadableDuration.parse("1h"),
                flush_interval=ReadableDuration.parse("1h"))
            s = await IngestStorage.open(inner, wc.dir, wc)
            try:
                commits = registry_value(
                    f'wal_group_commits_total{{log="wal{wait_ms}"}}')
                rec = await drive(s, 2000)
                rec["group_commits"] = registry_value(
                    f'wal_group_commits_total{{log="wal{wait_ms}"}}') \
                    - commits
                await s.flush_all()
                await read_back(s, 2000)
            finally:
                await s.close()
            rec["vs_baseline"] = (rec["writes_per_s"]
                                  / out["baseline"]["writes_per_s"])
            out[f"wal_wait_{wait_ms}ms"] = rec
            log(f"wal (a) [host work]: WAL, max_group_wait {wait_ms} ms: "
                f"{rec['writes_per_s']!r} acked writes/s "
                f"({rec['vs_baseline']!r} x the baseline), p99 ack "
                f"{rec['p99_ack_ms']!r} ms, {rec['group_commits']} group "
                f"commits for 2000 writes; flushed, every acked row read "
                f"back")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def registry_snapshot() -> dict:
    from horaedb_tpu_torch.utils import registry

    return registry.snapshot()


STAGE_SECONDS = 'scan_stage_seconds{stage="%s"}'


def series_label(key: str) -> str:
    """The label value of a one-label series key (`name{k="v"}`), or the
    bare name of an unlabelled one."""
    return key.split('"')[1] if "{" in key else key


async def traced(coro):
    """Run `coro` under a request trace; (its result, the trace's
    counters)."""
    from horaedb_tpu_torch.utils import tracing

    trace = tracing.recorder.start("chip_smoke", forced=True)
    try:
        with tracing.trace_scope(trace):
            out = await coro
    finally:
        done = tracing.recorder.finish(trace)
    return out, done["counters"]


def registry_value(name: str) -> float:
    from horaedb_tpu_torch.utils import registry

    return registry.snapshot().get(name, 0.0)


def config1_rows(rows: int) -> dict:
    """BASELINE config 1's rows (bench.py): 100 hosts, 10 s scrape,
    values from seed 0, row i at tick i // 100 of host i % 100."""
    import numpy as np
    import pyarrow as pa

    hosts, interval, segment_ms = 100, 10_000, 2 * 3600 * 1000
    per_host = max(1, rows // hosts)
    T0 = (1_700_000_000_000 // segment_ms) * segment_ms
    rng = np.random.default_rng(0)
    n = per_host * hosts
    return {"hosts": hosts, "interval": interval, "segment_ms": segment_ms,
            "per_host": per_host, "T0": T0, "n": n,
            "ts": T0 + np.repeat(np.arange(per_host, dtype=np.int64)
                                 * interval, hosts),
            "host_id": np.tile(np.arange(hosts, dtype=np.int32), per_host),
            "vals": (rng.random(n) * 100).astype(np.float64),
            "names": pa.array([f"host_{i:03d}" for i in range(hosts)])}


def host_batch(names, host_id, ts, vals):
    import pyarrow as pa

    return pa.record_batch({
        "host": pa.DictionaryArray.from_arrays(pa.array(host_id), names),
        "timestamp": pa.array(ts, type=pa.int64()),
        "value": pa.array(vals, type=pa.float64())})


def check_grid(got, ts, host_id, vals, T0, nb, bucket_ms, hosts, order,
               tsids, what: str) -> None:
    """count exact and avg within rtol 1e-5 of a numpy bincount of the
    rows (ts, host_id, vals) over [T0, T0 + nb buckets)."""
    import numpy as np

    off = ts - T0
    sel = (off >= 0) & (off < nb * bucket_ms)
    cell = host_id[sel].astype(np.int64) * nb + off[sel] // bucket_ms
    counts = np.bincount(cell, minlength=hosts * nb).reshape(hosts, nb)
    sums = np.bincount(cell, weights=vals[sel],
                       minlength=hosts * nb).reshape(hosts, nb)
    if got["tsids"] != tsids:
        raise AssertionError(f"{what}: tsids differ from the written series")
    grid = {k: np.asarray(v if isinstance(v, np.ndarray) else v.cpu().numpy())
            for k, v in got["aggs"].items()}
    if grid["count"].shape != (hosts, nb) or not np.array_equal(
            grid["count"], counts[order].astype(grid["count"].dtype)):
        raise AssertionError(f"{what}: count grid differs from numpy")
    occ = counts[order] > 0
    with np.errstate(invalid="ignore"):
        want = sums[order] / counts[order]
    if not np.isfinite(grid["avg"][occ]).all() \
            or not np.isnan(grid["avg"][~occ]).all():
        raise AssertionError(f"{what}: avg has non-finite occupied or "
                             f"non-NaN empty cells")
    np.testing.assert_allclose(grid["avg"][occ], want[occ], rtol=1e-5,
                               err_msg=what)


async def wal_phase(rows: int, ba, mg, fused_ingest_s: float) -> dict:
    """The wal cell: (a) durable ingest on the host; (b) BASELINE config
    1 through a WAL-fronted engine on the fused path, with a live tail,
    an overwrite and a crash; (c) the same store on the parts path with
    device decode, against host decode."""
    import shutil

    import numpy as np
    import torch

    from horaedb_tpu_torch.common import ReadableDuration
    from horaedb_tpu_torch.common.error import Error
    from horaedb_tpu_torch.metric_engine import MetricEngine
    from horaedb_tpu_torch.metric_engine.types import Label, tsid_of
    from horaedb_tpu_torch.ops.encode import h2d_bytes
    from horaedb_tpu_torch.storage.config import StorageConfig, from_dict
    from horaedb_tpu_torch.storage.read import ScanRequest
    from horaedb_tpu_torch.storage.types import TimeRange
    from horaedb_tpu_torch.utils import registry
    from horaedb_tpu_torch.wal import WalConfig

    res = {"a": await wal_ingest_leg()}
    d = config1_rows(rows)
    hosts, interval, seg_ms = d["hosts"], d["interval"], d["segment_ms"]
    per_host, T0, n, names = d["per_host"], d["T0"], d["n"], d["names"]
    ts, host_id, vals = d["ts"], d["host_id"], d["vals"].copy()
    bucket_ms, tail_ticks, crash_ticks = BMS, 360, 60
    tsid_of_host = np.array([tsid_of("cpu", [Label("host", f"host_{i:03d}")])
                             for i in range(hosts)], dtype=np.uint64)
    order = np.argsort(tsid_of_host)
    tsids = [int(t) for t in tsid_of_host[order]]
    rng = np.random.default_rng(7)

    def tail(first_tick: int, ticks: int):
        t = T0 + np.repeat(np.arange(first_tick, first_tick + ticks,
                                     dtype=np.int64) * interval, hosts)
        h = np.tile(np.arange(hosts, dtype=np.int32), ticks)
        return t, h, rng.random(len(t)) * 100

    tmp = scratch_dir("b")
    store = counting_store()
    wal_cfg = WalConfig(enabled=True, dir=f"{tmp}/wal",
                        flush_interval=ReadableDuration.parse("1h"),
                        flush_age=ReadableDuration.parse("1h"))
    fused_cfg = from_dict(StorageConfig, {
        "scheduler": {"schedule_interval": "1h"},
        "scan": {"cache_max_rows": rows * 4}})
    # whole buckets covering the data and both tails: one range for
    # every query of (b), so a stale replay would serve it
    nb = -(-(per_host + tail_ticks + crash_ticks) * interval // bucket_ms)
    rng_q = TimeRange.new(T0, T0 + nb * bucket_ms)

    async def flush_all(e):
        for _attempt in range(5):
            try:
                return await e.flush()
            except Error:
                # manifest delta backpressure: fold, then flush again
                await e.tables["data"].manifest.trigger_merge()
        raise Error("wal: flush failed after 5 backpressure retries")

    try:
        # ---- (b) live tail over config 1, fused --------------------------
        ba.reset_launches()
        mg.reset_launches()
        decode0 = decode_counts()
        e = await MetricEngine.open("bench", store, segment_ms=seg_ms,
                                    config=fused_cfg, wal_config=wal_cfg)
        reader = e.tables["data"].reader
        t0 = time.perf_counter()
        chunk = max(1, 1_000_000 // hosts) * hosts
        for lo in range(0, n, chunk):
            hi = min(n, lo + chunk)
            await e.write_arrow("cpu", ["host"], host_batch(
                names, host_id[lo:hi], ts[lo:hi], vals[lo:hi]))
        acked_s = time.perf_counter() - t0
        # the flusher ran on this event loop beside the writes (memtables
        # past flush_rows); flush() waits out any flush still in flight
        await flush_all(e)
        ingest_s = time.perf_counter() - t0
        st = await e.stats()
        log(f"wal (b): ingest {n:,} rows through the WAL: acked in "
            f"{acked_s!r} s, flushed in {ingest_s!r} s (the fused cell's "
            f"WAL-off ingest: {fused_ingest_s!r} s); data table "
            f"{st['tables']['data']['ssts']} SSTs, memtable rows "
            f"{st['memtable_rows']}, WAL backlog {st['wal_backlog_bytes']} B")
        if st["tables"]["data"]["rows"] != n or st["memtable_rows"]:
            raise AssertionError(f"wal (b): after flush() {st}")

        async def timed(want_replay: bool, what: str):
            # wall, upload, replay deltas, and the seconds of the flush
            # and of each scan stage (summed over concurrent reads)
            snap, snap_h2d = registry.snapshot(), h2d_bytes()
            hits0, misses0 = reader._replay_hits, reader._replay_misses
            got0 = store.snap()
            t0 = time.perf_counter()
            out = await e.query_downsample("cpu", [], rng_q,
                                           bucket_ms=bucket_ms,
                                           aggs=("avg",))
            torch.cuda.synchronize()
            now = registry.snapshot()
            rec = {"ms": (time.perf_counter() - t0) * 1e3,
                   "h2d_bytes": h2d_bytes() - snap_h2d,
                   **store.since(got0),
                   "replay": [reader._replay_hits - hits0,
                              reader._replay_misses - misses0],
                   "stages": {series_label(k): now[k] - snap.get(k, 0.0)
                              for k in now
                              if (k.startswith("scan_stage_seconds{")
                                  or k == "span_memtable_flush_seconds")
                              and now[k] != snap.get(k, 0.0)}}
            if rec["replay"] != ([1, 0] if want_replay else [0, 1]):
                raise AssertionError(f"wal (b) {what}: replay hits/misses "
                                     f"{rec['replay']}")
            return out, rec

        live = [(ts, host_id, vals)]
        tier2_ingest = reader.encoded_cache.stats()
        log(f"wal (b): tier 2 after ingest and flush "
            f"{json.dumps(tier2_ingest)}")
        # true cold, as the fused cell's: the cold query reads the store
        reader.scan_cache.clear()
        reader.encoded_cache.clear()

        def rows_now():
            return tuple(np.concatenate([p[i] for p in live])
                         for i in range(3))

        def check(out, what):
            check_grid(out, *rows_now(), T0, nb, bucket_ms, hosts, order,
                       tsids, what)

        cold, cold_rec = await timed(False, "cold")
        check(cold, "cold")
        cached = []
        for i in range(5):
            got, rec = await timed(True, f"cached {i}")
            if rec["h2d_bytes"]:
                raise AssertionError(f"wal (b) cached {i}: "
                                     f"{rec['h2d_bytes']} B up")
            same_bytes(got, cold, f"wal (b) cached {i} vs cold")
            cached.append(rec)
        log(f"wal (b): cold {cold_rec['ms']!r} ms (stages "
            f"{json.dumps(cold_rec['stages'])}), "
            f"{cold_rec['h2d_bytes']} B up; 5 replays "
            f"{[c['ms'] for c in cached]!r} ms, 0 B up, byte-equal; grids "
            f"match numpy over {nb} buckets")

        # the live tail: one tick x 100 hosts a write, 360 writes
        t_ts, t_h, t_v = tail(per_host, tail_ticks)
        acks = []
        for j in range(tail_ticks):
            sl = slice(j * hosts, (j + 1) * hosts)
            t0 = time.perf_counter()
            await e.write_arrow("cpu", ["host"],
                                host_batch(names, t_h[sl], t_ts[sl], t_v[sl]))
            acks.append((time.perf_counter() - t0) * 1e3)
        live.append((t_ts, t_h, t_v))
        st = await e.stats()
        mem = {k: v["ingest"]["memtable_rows"]
               for k, v in st["tables"].items()}
        log(f"wal (b): tail of {tail_ticks} writes x {hosts} rows: ack "
            f"p50 {float(np.percentile(acks, 50))!r} ms, p99 "
            f"{float(np.percentile(acks, 99))!r} ms; memtable rows before "
            f"any flush {mem}")
        if mem["data"] != tail_ticks * hosts:
            raise AssertionError(f"wal (b): data memtable rows {mem}")
        # engine reads through the WAL front: the tail's new series are
        # resolved from the registration tables' memtables
        raw = await e.query("cpu", [("host", "host_042")], TimeRange.new(
            int(t_ts[0]), int(t_ts[-1]) + 1))
        sel = t_h == 42
        if (raw.num_rows != tail_ticks
                or raw.column("timestamp").to_pylist() != t_ts[sel].tolist()
                or raw.column("value").to_pylist() != t_v[sel].tolist()):
            raise AssertionError(f"wal (b): raw query of the unflushed tail "
                                 f"gave {raw.num_rows} rows")
        log(f"wal (b): raw query of host_042 over the tail: its "
            f"{tail_ticks} unflushed rows through the hybrid scan")
        # a stale replay after a flush: the flush adds an SST to segment
        # 138 and makes 139, so the replay key changes; a hit would
        # return the pre-flush grid
        after, after_rec = await timed(False, "after the tail")
        st = await e.stats()
        if st["tables"]["data"]["ingest"]["memtable_rows"]:
            raise AssertionError("wal (b): the aggregate left rows in the "
                                 "data memtable")
        check(after, "after the tail")
        # write-through: the flush admitted the tail's SSTs into tier 2,
        # and the cold query put every other part, so nothing is read
        if after_rec["gets"]:
            raise AssertionError(f"wal (b): the query after the tail made "
                                 f"{after_rec['gets']} store GETs "
                                 f"({after_rec['get_bytes']} B)")
        again, again_rec = await timed(True, "replay after the tail")
        if again_rec["h2d_bytes"]:
            raise AssertionError("wal (b): replay after the tail uploaded")
        same_bytes(again, after, "wal (b) replay after the tail")
        log(f"wal (b): the query after the tail flushed it (data memtable "
            f"rows 0), missed the replay: {after_rec['ms']!r} ms "
            f"(stages {json.dumps(after_rec['stages'])}; segment_read "
            f"{after_rec['stages'].get('segment_read', 0.0)!r} s summed), "
            f"{after_rec['gets']} store GETs (write-through), "
            f"{after_rec['h2d_bytes']} B up, grids match numpy over "
            f"{n + tail_ticks * hosts:,} rows; the next one a replay, "
            f"{again_rec['ms']!r} ms, 0 B up, byte-equal")

        # overwrite 100 rows of the first segment, flush, query: per-row
        # seqs in a flushed SST, the newer write must win in the host
        # merge here and in device decode's k-way route in (c)
        o_idx = np.arange(0, 100 * 37, 37)  # first segment's rows
        o_v = rng.random(len(o_idx)) * 100 + 1000
        await e.write_arrow("cpu", ["host"], host_batch(
            names, host_id[o_idx], ts[o_idx], o_v))
        await flush_all(e)
        vals[o_idx] = o_v  # live[0] holds vals: the numpy side overwritten
        over, over_rec = await timed(False, "after the overwrite")
        check(over, "after the overwrite")
        log(f"wal (b): 100 rows of the first segment overwritten through "
            f"the WAL and flushed: {over_rec['ms']!r} ms (stages "
            f"{json.dumps(over_rec['stages'])}), "
            f"{over_rec['h2d_bytes']} B up, grids match numpy with the new "
            f"values")

        # crash: a 60-tick tail left unflushed, every table aborted
        c_ts, c_h, c_v = tail(per_host + tail_ticks, crash_ticks)
        for j in range(crash_ticks):
            sl = slice(j * hosts, (j + 1) * hosts)
            await e.write_arrow("cpu", ["host"],
                                host_batch(names, c_h[sl], c_ts[sl], c_v[sl]))
        live.append((c_ts, c_h, c_v))
        for t in e.tables.values():
            await t.abort()
        e._runtimes.close()
        replayed0 = registry_value("wal_replayed_rows_total")
        t0 = time.perf_counter()
        e = await MetricEngine.open("bench", store, segment_ms=seg_ms,
                                    config=fused_cfg, wal_config=wal_cfg)
        recover_s = time.perf_counter() - t0
        reader = e.tables["data"].reader
        replayed = registry_value("wal_replayed_rows_total") - replayed0
        st = await e.stats()
        if st["tables"]["data"]["ingest"]["memtable_rows"] != \
                crash_ticks * hosts:
            raise AssertionError(f"wal (b): recovered data memtable rows "
                                 f"{st['tables']['data']['ingest']}")
        rec_out, rec_rec = await timed(False, "after recovery")
        launches_b = dict(ba.LAUNCHES, **mg.LAUNCHES)
        check(rec_out, "after recovery")
        log(f"wal (b): crash with {crash_ticks * hosts} rows unflushed; "
            f"reopened in {recover_s!r} s replaying {int(replayed)} rows "
            f"(all tables); the first query {rec_rec['ms']!r} ms (stages "
            f"{json.dumps(rec_rec['stages'])}), its grids "
            f"include them and match numpy")
        await flush_all(e)
        await e.close()
        dc = counts_delta(decode0, decode_counts())
        if any(dc.values()) or launches_b["kway_merge_perm"] \
                or launches_b["bucket_window_partials"] \
                or not launches_b["bucket_round_accumulate"]:
            raise AssertionError(f"wal (b): launches {launches_b}, device "
                                 f"decode {dc}")
        res["b"] = {"rows": n, "acked_s": acked_s, "ingest_s": ingest_s,
                    "fused_ingest_s": fused_ingest_s,
                    "cold": cold_rec, "cached": cached,
                    "tail_ack_ms_p50": float(np.percentile(acks, 50)),
                    "tail_ack_ms_p99": float(np.percentile(acks, 99)),
                    "memtable_rows_before_flush": mem,
                    "after_tail": after_rec, "replay_after_tail": again_rec,
                    "after_overwrite": over_rec, "recover_s": recover_s,
                    "tier2_after_ingest": tier2_ingest,
                    "replayed_rows": replayed, "after_recovery": rec_rec,
                    "launches": launches_b}

        # ---- (c) the parts path over the same store ----------------------
        n_seg = -(-nb * bucket_ms // seg_ms)
        full = TimeRange.new(T0, T0 + n_seg * seg_ms)
        parts = {}
        for name, cfg in (("device", StorageConfig()),
                          ("host", from_dict(StorageConfig, {
                              "scan": {"decode": {"mode": "host"}}}))):
            e = await MetricEngine.open("bench", store, segment_ms=seg_ms,
                                        config=cfg, wal_config=wal_cfg)
            try:
                data = e.tables["data"]
                plan = await data.build_scan_plan(ScanRequest(range=full))
                if data.reader.fused_aggregate_ok(plan):
                    raise AssertionError("wal (c): the fused gate took the "
                                         "plan at the default budget")
                multi = [len(sg.ssts) for sg in plan.segments
                         if len(sg.ssts) > 1]
                ba.reset_launches()
                mg.reset_launches()
                c0 = decode_counts()
                t0 = time.perf_counter()
                out = await e.query_downsample("cpu", [], full,
                                               bucket_ms=bucket_ms,
                                               aggs=("avg",))
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                launches = dict(ba.LAUNCHES, **mg.LAUNCHES)
                dc = counts_delta(c0, decode_counts())
            finally:
                await e.close()
            check_grid(out, *rows_now(), T0, n_seg * seg_ms // bucket_ms,
                       bucket_ms, hosts, order, tsids, f"wal (c) {name}")
            falls = {k: v for k, v in dc.items()
                     if k.startswith("fallback:") and v}
            if name == "device":
                levels = sum(k.bit_length() for k in multi)
                if not (launches["kway_merge_perm"] == levels > 0
                        and dc["kway"] == len(multi)
                        and launches["bucket_window_partials"]
                        == len(plan.segments)
                        and dc["sorted"] == 0 and not falls):
                    raise AssertionError(f"wal (c): launches {launches}, "
                                         f"decode {dc}, multi-SST {multi}")
            elif launches["kway_merge_perm"] or dc["rows"] or falls:
                raise AssertionError(f"wal (c) host: launches {launches}, "
                                     f"decode {dc}")
            parts[name] = {"ms": ms, "launches": launches,
                           "multi_sst_segments": multi,
                           "decode": {k: v for k, v in dc.items() if v},
                           "out": out}
            log(f"wal (c) [{name} decode]: cold avg at 1 min {ms!r} ms over "
                f"{len(plan.segments)} segments ({len(multi)} with more "
                f"than one SST: {multi}); launches {launches}; grids match "
                f"numpy")
        same_bytes(parts["device"].pop("out"), parts["host"].pop("out"),
                   "wal (c) device vs host decode")
        log("wal (c): device-decode grids byte-equal to host decode")
        res["c"] = parts
        res["launches"] = {
            "bucket_round_accumulate": launches_b["bucket_round_accumulate"],
            "bucket_window_partials":
                parts["device"]["launches"]["bucket_window_partials"],
            "kway_merge_perm": parts["device"]["launches"]["kway_merge_perm"]}
        return res
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


async def profile_cached(query, want: dict, ba) -> dict:
    """One cached query under torch.profiler; its grids must equal the
    query's own byte for byte in every field."""
    before = sum(ba.LAUNCHES.values())
    prof = await profile_query(query)
    prof["wrapper_launches"] = sum(ba.LAUNCHES.values()) - before
    same_bytes(prof.pop("out"), want, "profile: the cached query")
    if prof["kernels"] == 0:
        log(f"profile: torch.profiler shows no device time; the wrapper "
            f"counted {prof['wrapper_launches']} kernel launches instead")
    log(f"profile: one cached query: {prof['kernels']} device kernels, "
        f"{prof['copies_and_sets']} copies/sets, "
        f"{prof['runtime_launch_calls']} cudaLaunchKernel calls, device "
        f"busy {prof['device_busy_us']!r} us; by name: "
        + json.dumps(prof["busy_us_by_name"]))
    return prof


def op_path(ba, ts_off, host_id, vals, hosts: int, num_buckets: int,
            counts, sums) -> dict:
    """ops.downsample.time_bucket_aggregate over all rows as one batch:
    launch count from 0, checked against the bincount, then timed."""
    import numpy as np
    import torch

    from horaedb_tpu_torch.ops import downsample

    ts32 = ts_off.astype(np.int32)
    v32 = vals.astype(np.float32)
    n = len(ts32)
    ba.reset_launches()
    out = downsample.time_bucket_aggregate(
        ts32, host_id, v32, n, BMS, hosts, num_buckets, which=("avg",),
        device="cuda")
    torch.cuda.synchronize()
    launches = ba.LAUNCHES["bucket_window_partials"]
    if launches != 1:
        raise AssertionError(f"op: {launches} launches for one call")
    if not np.array_equal(out["count"].cpu().numpy(),
                          counts.astype(np.float32)):
        raise AssertionError("op: count grid differs from bincount")
    occ = counts > 0
    np.testing.assert_allclose(out["avg"].cpu().numpy()[occ],
                               sums[occ] / counts[occ], rtol=1e-5)
    dev = torch.device("cuda")
    args = [torch.from_numpy(a[None, :]).to(dev) for a in (ts32, host_id,
                                                           v32)]
    run = lambda: ba.bucket_window_partials(  # noqa: E731
        *args, None, None, None, num_buckets, BMS, num_groups=hosts,
        width=num_buckets, which=("avg",), n_valid=n)
    ms = device_ms(run, reps=10)
    plain_ms = device_ms(lambda: ba.bucket_window_partials_plain(
        *args, None, None, None, num_buckets, BMS, num_groups=hosts,
        width=num_buckets, which=("avg",), n_valid=n), reps=3)
    nbytes = n * 12 + hosts * num_buckets * 2 * 4
    res = {"rows": n, "launches": launches, "ms": ms,
           "plain_ms": plain_ms,
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bytes": nbytes}
    log(f"op: time_bucket_aggregate over {n:,} time-major rows matches the "
        f"bincount; bucket_window_partials {ms!r} ms, plain {plain_ms!r} "
        f"ms, bound {res['bound_ms']!r} ms")
    return res


TOPK_QUERIES = (("max", True), ("avg", False), ("last", True))


async def topk_legs(e, path: str, rng_t, nb: int, want: dict,
                    tsids: list) -> dict:
    """Config 1's top-k legs on one engine (`path` "fused" or "parts"):
    query_topk(k=10) by max, by avg smallest first and by last, each run
    twice and held byte for byte against query_downsample + apply_top_k
    on the same engine and (parts) against the dense control, and
    against numpy (`want`: full grids in tsid order).  On the fused
    engine the second run must be a replay with 0 B host-to-device; on
    the parts engine the pushdown must materialize k x buckets cells a
    grid."""
    import numpy as np
    import torch

    from horaedb_tpu_torch.ops.downsample import ALL_AGGS
    from horaedb_tpu_torch.ops.encode import h2d_bytes
    from horaedb_tpu_torch.storage import combine as combine_mod
    from horaedb_tpu_torch.storage.plan import TopKSpec, apply_top_k

    data = e.tables["data"]
    reader = data.reader
    k = 10

    async def timed(fn):
        m0, g0 = combine_mod._MATERIALIZED.value, combine_mod._GRID.value
        h0 = h2d_bytes()
        r0 = (reader._replay_hits, reader._replay_misses)
        t0 = time.perf_counter()
        out = await fn()
        torch.cuda.synchronize()
        return out, {"ms": (time.perf_counter() - t0) * 1e3,
                     "h2d_bytes": h2d_bytes() - h0,
                     "materialized": combine_mod._MATERIALIZED.value - m0,
                     "grid_cells": combine_mod._GRID.value - g0,
                     "replay": [reader._replay_hits - r0[0],
                                reader._replay_misses - r0[1]]}

    res = {}
    for by, largest in TOPK_QUERIES:
        tag = f"topk [{path}] by={by} largest={largest}"
        which = tuple(sorted(set(ALL_AGGS) | {by}))

        def topk():
            return e.query_topk("cpu", [], rng_t, BMS, k=k, by=by,
                                largest=largest)

        got, first = await timed(topk)
        again, second = await timed(topk)
        same_bytes(again, got, f"{tag}: repeat")
        cells = k * nb * len(got["aggs"])
        if path == "fused" and (second["replay"] != [1, 0]
                                or second["h2d_bytes"]):
            raise AssertionError(f"{tag}: repeat replay {second['replay']}"
                                 f", {second['h2d_bytes']} B up")
        if path == "parts" and not (first["materialized"] ==
                                    second["materialized"] == cells):
            raise AssertionError(f"{tag}: materialized "
                                 f"{first['materialized']} / "
                                 f"{second['materialized']} cells, want "
                                 f"{k} x {nb} x {len(got['aggs'])}")
        full, down = await timed(lambda: e.query_downsample(
            "cpu", [], rng_t, BMS, aggs=which))
        values, grids = apply_top_k(np.asarray(full["tsids"],
                                               dtype=np.uint64),
                                    full["aggs"], TopKSpec(k, by, largest))
        same_bytes(got, {"tsids": [int(t) for t in values], "aggs": grids},
                   f"{tag}: vs query_downsample + apply_top_k")
        rec = {"first": first, "repeat": second, "downsample": down}
        if path == "parts":
            data.config.scan.combine.mode = "dense"
            try:
                dense, rec["dense"] = await timed(topk)
            finally:
                data.config.scan.combine.mode = "sparse"
            same_bytes(dense, got, f"{tag}: vs the dense control")
            if rec["dense"]["materialized"] <= cells:
                raise AssertionError(f"{tag}: the dense control "
                                     f"materialized only "
                                     f"{rec['dense']['materialized']}")
        # numpy: each winner's row, and the ranking (exact for max and
        # last; avg within rtol 1e-5 of numpy's f64 scores)
        rows = [tsids.index(t) for t in got["tsids"]]
        for name, g in got["aggs"].items():
            g = np.asarray(g)
            w = want[name][rows]
            if name in ("sum", "avg"):
                np.testing.assert_allclose(g, w, rtol=1e-5, err_msg=tag)
            elif not np.array_equal(g, w, equal_nan=True):
                raise AssertionError(f"{tag}: grid {name} differs from "
                                     f"numpy")
        has = want["count"] > 0
        if largest:
            score = np.where(has, want[by], -np.inf).max(axis=1)
            best = np.argsort(-score, kind="stable")[:k]
        else:
            score = np.where(has, want[by], np.inf).min(axis=1)
            best = np.argsort(score, kind="stable")[:k]
        if by == "avg":
            np.testing.assert_allclose(score[rows], score[best], rtol=1e-5,
                                       err_msg=tag)
        elif rows != best.tolist():
            raise AssertionError(f"{tag}: winners {rows} != numpy "
                                 f"{best.tolist()}")
        log(f"{tag}: {first['ms']!r} ms, repeat {second['ms']!r} ms "
            f"(replay {second['replay']}, {second['h2d_bytes']} B up); "
            f"query_downsample of the same range {down['ms']!r} ms; "
            f"materialized {first['materialized']} cells of a "
            f"{first['grid_cells']}-cell grid"
            + (f"; dense control {rec['dense']['ms']!r} ms, "
               f"{rec['dense']['materialized']} cells"
               if path == "parts" else "")
            + "; byte-equal to query_downsample + apply_top_k"
            + (" and the dense control" if path == "parts" else "")
            + ", rows and ranking match numpy")
        res[f"{by}_{'largest' if largest else 'smallest'}"] = rec
    return res


def topk_ops_phase() -> dict:
    """ops/topk.py on the card against its CPU run on the same inputs:
    top_k_groups (ties, NaN, +-inf, k > groups, largest and smallest, 100
    and 100,000 groups: values' bytes and indices equal) and the pair
    arithmetic on 10^6 seeded normal-range f32 triples (hi, lo, exact
    and the pair max byte-equal)."""
    import numpy as np
    import torch

    from horaedb_tpu_torch.ops import topk

    rng = np.random.default_rng(9)
    dev = torch.device("cuda")

    def same(a, b, what):
        a, b = a.cpu(), b.cpu()
        if a.dtype != b.dtype or a.numpy().tobytes() != b.numpy().tobytes():
            raise AssertionError(f"topk ops: {what} differs between the "
                                 f"card and the CPU")

    cases = {"ties": np.array([1, 3, 3, 2, 3], np.float32),
             "signed zeros": np.array([0.0, -0.0, 0.0, -0.0], np.float32),
             "nan and inf": np.array([np.nan, np.inf, 2.0, -np.inf, np.nan,
                                      2.0, np.inf], np.float32),
             "all nan": np.full(6, np.nan, np.float32)}
    for g in (100, 100_000):
        x = rng.integers(-50, 50, g).astype(np.float32)
        x[rng.random(g) < 0.05] = np.nan
        x[rng.random(g) < 0.01] = np.inf
        x[rng.random(g) < 0.01] = -np.inf
        cases[f"{g} groups"] = x
    checked = 0
    for name, x in cases.items():
        for k in (1, 3, 10, 2 * len(x) + 1):
            for largest in (True, False):
                cpu = topk.top_k_groups(torch.from_numpy(x), k, largest)
                gpu = topk.top_k_groups(torch.from_numpy(x).to(dev), k,
                                        largest)
                same(gpu[0], cpu[0], f"{name} k={k} values")
                same(gpu[1], cpu[1], f"{name} k={k} indices")
                checked += 1
    n = 1_000_000
    scale = np.float32(2.0) ** rng.integers(-20, 20, (3, n)).astype(
        np.float32)
    hi, lo, x = (rng.standard_normal((3, n)).astype(np.float32) * scale)
    lo = lo * np.float32(2.0 ** -30)
    cpu_in = [torch.from_numpy(a) for a in (hi, lo, x)]
    gpu_in = [a.to(dev) for a in cpu_in]
    for what, fn in (("two_sum", lambda h, l, v: topk.two_sum(h, v)),
                     ("pair_add", topk.pair_add)):
        for i, (c, gg) in enumerate(zip(fn(*cpu_in), fn(*gpu_in))):
            same(gg, c, f"{what} output {i}")
    mask = torch.from_numpy(rng.random((1000, 1000)) < 0.7)
    for largest in (True, False):
        c = topk.pair_max_normalized(cpu_in[0].view(1000, 1000),
                                     cpu_in[1].view(1000, 1000), mask, 1,
                                     largest)
        gg = topk.pair_max_normalized(gpu_in[0].view(1000, 1000),
                                      gpu_in[1].view(1000, 1000),
                                      mask.to(dev), 1, largest)
        for i in range(2):
            same(gg[i], c[i], f"pair_max_normalized largest={largest} {i}")
    exact = int(topk.pair_add(*gpu_in)[2].sum())
    big = torch.from_numpy(cases["100000 groups"]).to(dev)
    ms = cuda_ms(lambda: topk.top_k_groups(big, 10), reps=20)
    log(f"topk ops: top_k_groups equal on the card and the CPU in "
        f"{checked} cases (values' bytes and indices); two_sum, pair_add "
        f"(exact {exact:,} of {n:,}) and pair_max_normalized byte-equal "
        f"on {n:,} normal-range triples; top_k_groups at 100,000 groups, "
        f"k=10: {ms!r} ms on the card")
    return {"cases": checked, "triples": n, "exact": exact,
            "top_k_groups_100k_ms": ms}


async def config4_phase(rows: int, ba, mg) -> dict:
    """BASELINE config 4 (top-10 hosts by max(cpu) over 64 overlapping
    SSTs) through plan_query / execute_plan, as the JAX package's
    run_config4 drives it: 64 writes of rows / 64 (100 hosts drawn
    uniformly, ts = T0 + U[0, 3,000,000) in one 1 h segment, cpu =
    U[0, 1) x 100, seed 0), then legs true cold, tier-2-served, repeats
    (p50 of 5), the count check without the TopK stage, and the dense
    control; every leg with its launches counted from 0 and checked
    against numpy on the same rows."""
    import numpy as np
    import pyarrow as pa
    import torch

    from horaedb_tpu_torch.common.error import Error
    from horaedb_tpu_torch.ops.encode import h2d_bytes
    from horaedb_tpu_torch.storage import combine as combine_mod
    from horaedb_tpu_torch.storage.config import StorageConfig, from_dict
    from horaedb_tpu_torch.storage.plan import TopKSpec
    from horaedb_tpu_torch.storage.read import (AggregateSpec,
                                                ParquetReader, ScanRequest)
    from horaedb_tpu_torch.storage.storage import (CloudObjectStorage,
                                                   WriteRequest)
    from horaedb_tpu_torch.storage.types import TimeRange

    hosts, num_ssts, span, k = 100, 64, 3_000_000, 10
    per_sst = max(1, rows // num_ssts)
    n = per_sst * num_ssts
    log(f"config 4 cut: {n:,} rows instead of 1,000,000,000 (host ingest "
        f"time and host RAM of the check)")
    T0 = (1_700_000_000_000 // 3_600_000) * 3_600_000
    schema = pa.schema([("host", pa.string()), ("ts", pa.int64()),
                        ("cpu", pa.float64())])
    names = pa.array([f"host_{i}" for i in range(hosts)])
    rng = np.random.default_rng(0)
    all_h = np.empty(n, dtype=np.int8)
    all_off = np.empty(n, dtype=np.int32)
    all_v = np.empty(n, dtype=np.float32)
    cfg = from_dict(StorageConfig, {"scheduler": {"schedule_interval": "1h"}})
    store = counting_store()
    torch.cuda.reset_peak_memory_stats()
    s = await CloudObjectStorage.open("bench", 3_600_000, store, schema, 2,
                                      cfg)
    try:
        t0 = time.perf_counter()
        for i in range(num_ssts):
            h = rng.integers(0, hosts, per_sst)
            off = rng.integers(0, span, per_sst)
            v = rng.random(per_sst) * 100
            sl = slice(i * per_sst, (i + 1) * per_sst)
            all_h[sl], all_off[sl], all_v[sl] = h, off, v
            batch = pa.record_batch(
                [pa.DictionaryArray.from_arrays(
                    pa.array(h.astype(np.int32)), names).cast(pa.string()),
                 pa.array(T0 + off, type=pa.int64()),
                 pa.array(v, type=pa.float64())], schema=schema)
            for _attempt in range(5):
                try:
                    await s.write(WriteRequest(batch, TimeRange.new(
                        T0, T0 + span)))
                    break
                except Error:
                    await s.manifest.trigger_merge()
            else:
                raise Error("config 4: ingest failed after 5 retries")
        ingest_s = time.perf_counter() - t0
        reader = s.reader
        tier2_ingest = reader.encoded_cache.stats()
        log(f"config 4: ingest {n:,} rows in {num_ssts} writes in "
            f"{ingest_s!r} s; tier 2 after ingest "
            f"{json.dumps(tier2_ingest)}")

        # numpy on the same rows: keep the last write of each (host, ts),
        # then per host the count and the max (f32, as the device path)
        t0 = time.perf_counter()
        key = all_h.astype(np.int64) << 32 | all_off.astype(np.int64)
        order = np.argsort(key, kind="stable")
        sk = key[order]
        last = np.ones(n, dtype=bool)
        last[:-1] = sk[:-1] != sk[1:]
        kept_h = all_h[order][last]
        kept_v = all_v[order][last]
        want_count = np.bincount(kept_h, minlength=hosts)
        starts = np.flatnonzero(np.r_[True, kept_h[1:] != kept_h[:-1]])
        want_max = np.full(hosts, -np.inf, dtype=np.float32)
        want_max[kept_h[starts]] = np.maximum.reduceat(kept_v, starts)
        host_names = np.array(sorted(f"host_{i}" for i in range(hosts)))
        by_name = {nm: int(nm[5:]) for nm in host_names}
        best = np.argsort(-want_max[[by_name[h] for h in host_names]],
                          kind="stable")[:k]
        want_top = host_names[best].tolist()
        del key, order, sk, last, kept_h, kept_v
        log(f"config 4: numpy check built in {time.perf_counter() - t0!r} "
            f"s: {int(want_count.sum()):,} rows after dedup; top {k}: "
            f"{want_top}")

        spec = AggregateSpec(group_col="host", ts_col="ts", value_col="cpu",
                             range_start=T0, bucket_ms=span, num_buckets=1,
                             which=("max",))
        req = ScanRequest(range=TimeRange.new(T0, T0 + span))
        tk = TopKSpec(k=k, by="max")

        # the route, read from the gates before the first query
        plan = await s.build_scan_plan(req)
        est = sum(f.meta.num_rows for sg in plan.segments for f in sg.ssts)
        route = {"segments": len(plan.segments),
                 "ssts": [len(sg.ssts) for sg in plan.segments],
                 "est_rows": est,
                 "fused": reader.fused_aggregate_ok(plan),
                 "device_decode": reader._device_decode_plan_ok(
                     plan, count=False),
                 "decode_mode": reader.config.scan.decode.mode,
                 "streamed": [reader._stream_segment(sg)
                              for sg in plan.segments],
                 "stream_read_min_rows":
                     reader.config.scan.stream_read_min_rows,
                 "max_window_rows": reader.config.scan.max_window_rows}
        log(f"config 4 route: {json.dumps(route)} (budget "
            f"{reader.cache_budget_bytes:,} B)")
        if not all(route["streamed"]):
            log(f"config 4: the route changed: {est:,} rows do not reach "
                f"stream_read_min_rows {route['stream_read_min_rows']:,}, "
                f"so the segment is read whole")
        if (route["fused"] or not route["device_decode"]
                or route["decode_mode"] != "auto" or route["ssts"] !=
                [num_ssts] or not all(route["streamed"])):
            raise AssertionError(f"config 4: not the reference's route: "
                                 f"{route}")

        # streamed windows, counted where the reader returns them
        windows = [0]
        orig = ParquetReader._read_streamed_windows

        async def counted(self, seg, plan):
            got, secs = await orig(self, seg, plan)
            windows[0] += len(got)
            return got, secs

        reader._read_streamed_windows = counted.__get__(reader)

        async def leg(name: str, top_k=tk, prep=None, profile=False,
                      cold=True):
            # `cold`: the memo was emptied, so the segment is read and
            # aggregated again (its kernels checked); a repeat is served
            # by the PartsMemo
            if prep is not None:
                prep()
            memo0 = reader.parts_memo.stats()["hits"]
            ba.reset_launches()
            mg.reset_launches()
            c0 = decode_counts()
            t2 = dict(reader.encoded_cache.stats())
            m0, g0 = combine_mod._MATERIALIZED.value, combine_mod._GRID.value
            got0, h0, w0 = store.snap(), h2d_bytes(), windows[0]
            torch.cuda.reset_peak_memory_stats()

            async def run():
                qp = await s.plan_query(req, spec=spec, top_k=top_k)
                out = await s.execute_plan(qp)
                torch.cuda.synchronize()
                return out

            t0 = time.perf_counter()
            if profile:
                prof = await profile_query(run)
                out = prof.pop("out")
            else:
                out = await run()
            ms = (time.perf_counter() - t0) * 1e3
            dc = counts_delta(c0, decode_counts())
            t2_now = reader.encoded_cache.stats()
            rec = {"ms": ms, **store.since(got0),
                   "h2d_bytes": h2d_bytes() - h0,
                   "kway_merge_perm": mg.LAUNCHES["kway_merge_perm"],
                   "bucket_window_partials":
                       ba.LAUNCHES["bucket_window_partials"],
                   "bucket_round_accumulate":
                       ba.LAUNCHES["bucket_round_accumulate"],
                   "fallbacks": {kk: v for kk, v in dc.items()
                                 if kk.startswith("fallback:") and v},
                   "decode": {kk: v for kk, v in dc.items()
                              if not kk.startswith("fallback:")},
                   "windows": windows[0] - w0,
                   "materialized": combine_mod._MATERIALIZED.value - m0,
                   "grid_cells": combine_mod._GRID.value - g0,
                   "tier2": {kk: t2_now[kk] - t2[kk] for kk in
                             ("hits", "misses", "evictions", "admissions")},
                   "memo_hits": reader.parts_memo.stats()["hits"] - memo0,
                   "peak_device_memory": torch.cuda.max_memory_allocated()}
            if profile:
                rec["profile"] = prof
            values, grids = out
            if rec["fallbacks"]:
                raise AssertionError(f"config 4 {name}: decode fallbacks "
                                     f"{rec['fallbacks']}")
            if cold and not (rec["windows"] > 0 and rec["memo_hits"] == 0
                             and rec["bucket_window_partials"]
                             == rec["windows"] and rec["kway_merge_perm"]
                             >= rec["windows"]):
                raise AssertionError(
                    f"config 4 {name}: {rec['windows']} streamed windows, "
                    f"{rec['memo_hits']} memo hits, launches partials "
                    f"{rec['bucket_window_partials']}, kway_merge_perm "
                    f"{rec['kway_merge_perm']}")
            if top_k is not None:
                want_cells = k * spec.num_buckets * len(grids)
                if (reader.config.scan.combine.mode != "dense" and
                        rec["materialized"] != want_cells) \
                        or rec["grid_cells"] != hosts * spec.num_buckets:
                    raise AssertionError(
                        f"config 4 {name}: materialized "
                        f"{rec['materialized']} cells (want {want_cells}),"
                        f" grid {rec['grid_cells']} (want {hosts})")
                got_top = [str(v) for v in values]
                if got_top != want_top:
                    raise AssertionError(f"config 4 {name}: top {k} "
                                         f"{got_top} != numpy {want_top}")
                idx = [by_name[h] for h in got_top]
                if not (np.array_equal(np.asarray(grids["count"])[:, 0],
                                       want_count[idx])
                        and np.asarray(grids["max"], dtype=np.float32)[
                            :, 0].tobytes() == want_max[idx].tobytes()):
                    raise AssertionError(f"config 4 {name}: count or max "
                                         f"of the winners differs from "
                                         f"numpy")
            log(f"config 4 {name}: {ms!r} ms, {rec['gets']} store GETs of "
                f"{rec['get_bytes']} B, {rec['h2d_bytes']} B up; "
                f"{rec['windows']} streamed windows, {rec['memo_hits']} "
                f"memo hits; launches "
                f"kway_merge_perm {rec['kway_merge_perm']}, "
                f"bucket_window_partials {rec['bucket_window_partials']}; "
                f"decode fallbacks 0 ({json.dumps(rec['decode'])}); "
                f"materialized {rec['materialized']} of "
                f"{rec['grid_cells']} grid cells; tier 2 "
                f"{json.dumps(rec['tier2'])}; peak device memory "
                f"{rec['peak_device_memory']} B")
            return out, rec

        res = {"rows": n, "ssts": num_ssts, "ingest_s": ingest_s,
               "tier2_after_ingest": tier2_ingest, "route": route,
               "want_top": want_top,
               "dedup_rows": int(want_count.sum())}
        cold, res["true_cold"] = await leg("true cold",
                                           prep=lambda: true_cold(reader))
        _, res["tier2_served"] = await leg(
            "tier-2-served", prep=lambda: (reader.drop_hbm_state(),
                                           reader.scan_cache.clear(),
                                           reader.parts_memo.clear()))
        repeats = []
        for i in range(5):
            got, rec = await leg(f"repeat {i}", cold=False)
            same_bytes({"tsids": list(got[0]), "aggs": got[1]},
                       {"tsids": list(cold[0]), "aggs": cold[1]},
                       f"config 4 repeat {i}")
            repeats.append(rec)
        res["repeats"] = repeats
        res["repeat_p50_ms"] = statistics.median(r["ms"] for r in repeats)
        (values, grids), res["counts"] = await leg(
            "without the TopK stage", top_k=None,
            prep=lambda: true_cold(reader))
        got_counts = np.asarray(grids["count"])[:, 0]
        idx = [by_name[str(h)] for h in values]
        if not (len(values) == hosts and np.array_equal(
                got_counts, want_count[idx]) and int(got_counts.sum())
                == int(want_count.sum())):
            raise AssertionError("config 4: per-host counts differ from "
                                 "numpy")

        def dense():
            true_cold(reader)
            reader.config.scan.combine.mode = "dense"

        try:
            control, res["dense"] = await leg("dense control", prep=dense)
        finally:
            reader.config.scan.combine.mode = "sparse"
        same_bytes({"tsids": list(control[0]), "aggs": control[1]},
                   {"tsids": list(cold[0]), "aggs": cold[1]},
                   "config 4 dense control vs the pushdown")
        _, res["profiled"] = await leg("cold under torch.profiler",
                                       prep=lambda: true_cold(reader),
                                       profile=True)
        prof = res["profiled"]["profile"]
        merge_us = sum(v for name, v in prof["busy_us_by_name"].items()
                       if "kway_merge" in name)
        res["merge_share"] = merge_us / (res["profiled"]["ms"] * 1e3)
        log(f"config 4: one cold query under torch.profiler: "
            f"{prof['kernels']} kernels, device busy "
            f"{prof['device_busy_us']!r} us of {res['profiled']['ms']!r} "
            f"ms; kway_merge_perm {merge_us!r} us "
            f"({res['merge_share']!r} of the wall); by name: "
            + json.dumps(prof["busy_us_by_name"]))
        log(f"config 4: top {k} {want_top}, per-host counts and the "
            f"winners' max equal numpy; {int(got_counts.sum()):,} rows "
            f"after dedup; the dense control byte-equal to the pushdown; "
            f"repeats p50 {res['repeat_p50_ms']!r} ms")
        res["launches"] = {
            "kway_merge_perm": res["true_cold"]["kway_merge_perm"],
            "bucket_window_partials":
                res["true_cold"]["bucket_window_partials"],
            "bucket_round_accumulate":
                res["true_cold"]["bucket_round_accumulate"]}
        return res
    finally:
        await s.close()


async def ingest_rows(e, host_id, ts, vals, names, hosts: int) -> float:
    """write_arrow in 1M-row chunks (bench.py's), folding the manifest
    on backpressure; returns the seconds."""
    import pyarrow as pa

    from horaedb_tpu_torch.common.error import Error

    n = len(ts)
    t0 = time.perf_counter()
    chunk = max(1, 1_000_000 // hosts) * hosts
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk)
        batch = pa.record_batch({
            "host": pa.DictionaryArray.from_arrays(
                pa.array(host_id[lo:hi]), names),
            "timestamp": pa.array(ts[lo:hi], type=pa.int64()),
            "value": pa.array(vals[lo:hi], type=pa.float64())})
        for _attempt in range(5):
            try:
                await e.write_arrow("cpu", ["host"], batch)
                break
            except Error:
                await e.tables["data"].manifest.trigger_merge()
        else:
            raise Error("ingest failed after 5 backpressure retries")
    return time.perf_counter() - t0


def host_grids(out: dict) -> dict:
    import numpy as np

    return {k: (v.cpu().numpy() if hasattr(v, "cpu") else np.asarray(v))
            for k, v in out["aggs"].items()}


def same_result_bytes(a: dict, b: dict, what: str) -> None:
    """tsids, grid keys, dtypes and bytes equal."""
    if a["tsids"] != b["tsids"]:
        raise AssertionError(f"{what}: tsids differ")
    ga, gb = host_grids(a), host_grids(b)
    if sorted(ga) != sorted(gb):
        raise AssertionError(f"{what}: grids {sorted(ga)} != {sorted(gb)}")
    for k in gb:
        if ga[k].dtype != gb[k].dtype or ga[k].tobytes() != gb[k].tobytes():
            raise AssertionError(f"{what}: grid {k} differs in bytes")


def tolerance_match(a: dict, b: dict, what: str) -> None:
    """count/min/max/last/last_ts exact after a cast to f64, sum/avg
    within rtol 1e-5 (NaN where the other is NaN)."""
    import numpy as np

    if a["tsids"] != b["tsids"]:
        raise AssertionError(f"{what}: tsids differ")
    ga, gb = host_grids(a), host_grids(b)
    if sorted(ga) != sorted(gb):
        raise AssertionError(f"{what}: grids {sorted(ga)} != {sorted(gb)}")
    for k in gb:
        x, y = ga[k].astype(np.float64), gb[k].astype(np.float64)
        if k in ("sum", "avg"):
            np.testing.assert_allclose(x, y, rtol=1e-5, err_msg=f"{what} {k}")
        elif not np.array_equal(x, y, equal_nan=True):
            raise AssertionError(f"{what}: grid {k} differs")


def launches(ba, mg) -> dict:
    return {**ba.LAUNCHES, **mg.LAUNCHES}


def reset_all(ba, mg) -> None:
    ba.reset_launches()
    mg.reset_launches()


def pctl(xs, q) -> float:
    import numpy as np

    return float(np.percentile(np.asarray(xs) * 1e3, q))


async def rollup_phase(ba, mg, per_host: int = 100_000) -> dict:
    """The JAX package's bench config 11 (horaedb_tpu/bench/suite.py
    run_config11) at 10,000,000 rows: 100 hosts, 10 s scrape, 100,000
    samples a host (139 2 h segments), values U[0, 1) x 100 from seed
    11, a standing (cpu, value) rollup at tiers 1m and 1h.  Ingest, the
    roll_now() backfill, stats(), a cross-check per dashboard shape,
    the rollup-served mix (12 rotating 6 h @ 1 m zooms and the
    full-span @ 1 h overview, aggs avg, 12 repetitions, the tier
    tables' window caches dropped before each query) with its store
    GETs, the raw cold mix (3 repetitions, the data table's window
    cache and tier 2 emptied before each query), a rollup-served top-k
    and a late write that re-rolls one segment; launches counted from 0
    around the backfill and around each mix."""
    import numpy as np
    import pyarrow as pa
    import torch

    from horaedb_tpu_torch.common import ReadableDuration
    from horaedb_tpu_torch.metric_engine import Label, MetricEngine, Sample
    from horaedb_tpu_torch.metric_engine.types import tsid_of
    from horaedb_tpu_torch.rollup import RollupConfig
    from horaedb_tpu_torch.storage.config import StorageConfig, from_dict
    from horaedb_tpu_torch.storage.plan import TopKSpec, apply_top_k
    from horaedb_tpu_torch.storage.types import TimeRange

    hosts, interval, segment_ms, hour = 100, 10_000, 2 * 3600 * 1000, 3_600_000
    span = per_host * interval
    segments = (span - interval) // segment_ms + 1
    T0 = (1_700_000_000_000 // segment_ms) * segment_ms
    n = per_host * hosts
    rng = np.random.default_rng(11)
    ts = T0 + np.repeat(np.arange(per_host, dtype=np.int64) * interval,
                        hosts)
    host_id = np.tile(np.arange(hosts, dtype=np.int32), per_host)
    vals = (rng.random(n) * 100).astype(np.float64)
    names = pa.array([f"host_{i:03d}" for i in range(hosts)])
    tsid_of_host = np.array([tsid_of("cpu", [Label("host", f"host_{i:03d}")])
                             for i in range(hosts)], dtype=np.uint64)
    order = np.argsort(tsid_of_host)
    tsids = [int(t) for t in tsid_of_host[order]]
    zoom_ms = 6 * hour
    over_span = (span // hour) * hour
    zoom_starts = [T0 + k * ((span - zoom_ms) // 11 // hour * hour)
                   for k in range(12)]
    log("rollup: the JAX package's config 11 shape (suite.py:1477-1694) "
        f"at {n:,} rows; store: in-memory with data-plane GET counts, then "
        "the same objects behind the reference's seeded 25 ms latency "
        "store (objstore/middleware.FaultInjectingStore), in turns")

    cfg = from_dict(StorageConfig, {
        "scheduler": {"schedule_interval": "1h"},
        "scan": {"cache_max_rows": n * 4,
                 "cache": {"tier2_max_bytes": 2 << 30}}})
    # the standing query is registered after the ingest: a registered
    # spec's writes wake the maintenance loop, which would roll
    # segments while the ingest runs and leave the backfill a remainder
    rollup_cfg = RollupConfig(enabled=True, tiers=["1m", "1h"], specs=[],
                              roll_interval=ReadableDuration.parse("1h"))
    store = counting_store()
    res: dict = {"rows": n}
    e = await MetricEngine.open("cfg11", store, segment_ms=segment_ms,
                                config=cfg, rollup_config=rollup_cfg)
    try:
        res["ingest_s"] = await ingest_rows(e, host_id, ts, vals, names,
                                            hosts)
        log(f"rollup: ingest {n:,} rows in {res['ingest_s']!r} s")

        reset_all(ba, mg)
        t0 = time.perf_counter()
        await e.rollups.register("cpu")
        rolled = await e.rollups.roll_now()
        res["backfill_s"] = time.perf_counter() - t0
        res["backfill_launches"] = launches(ba, mg)
        res["backfill_segments"] = rolled["cpu:value"]
        log(f"rollup: backfill rolled {rolled['cpu:value']} segments in "
            f"{res['backfill_s']!r} s; launches "
            f"{json.dumps(res['backfill_launches'])}")
        if rolled["cpu:value"] != segments:
            raise AssertionError(f"rollup: backfill rolled "
                                 f"{rolled['cpu:value']} segments, not "
                                 f"{segments}")
        if res["backfill_launches"]["bucket_window_partials"] < segments:
            raise AssertionError("rollup: the backfill did not run the "
                                 "partials kernel on every segment")
        if not res["backfill_launches"]["kway_merge_perm"]:
            raise AssertionError("rollup: the backfill's multi-SST "
                                 "segments did not run kway_merge_perm")
        st = await e.stats()
        spec_st = st["rollups"]["specs"]["cpu:value"]
        res["tiers"] = st["rollups"]["tiers"]
        res["lag_seqs"] = spec_st["lag_seqs"]
        res["coverage"] = spec_st["coverage"]
        log(f"rollup: lag {spec_st['lag_seqs']}, coverage "
            f"{spec_st['coverage']}; tiers {json.dumps(res['tiers'])}")
        if spec_st["lag_seqs"] != 0 or spec_st["coverage"] != 1.0:
            raise AssertionError("rollup: lag or coverage after backfill")

        def zoom(k, use_rollup=True, eng=e):
            s = zoom_starts[k % len(zoom_starts)]
            return eng.query_downsample(
                "cpu", [], TimeRange.new(s, s + zoom_ms), bucket_ms=60_000,
                aggs=("avg",), use_rollup=use_rollup)

        def over(_k, use_rollup=True, eng=e):
            return eng.query_downsample(
                "cpu", [], TimeRange.new(T0, T0 + over_span),
                bucket_ms=hour, aggs=("avg",), use_rollup=use_rollup)

        shapes = {"zoom": zoom, "overview": over}

        def numpy_check(out, shape, k, what, rows=(ts, host_id, vals)):
            s = zoom_starts[k % 12] if shape == "zoom" else T0
            bms = 60_000 if shape == "zoom" else hour
            nb = (zoom_ms if shape == "zoom" else over_span) // bms
            check_grid(out, *rows, s, nb, bms, hosts, order, tsids, what)

        # the cross-check, one query per shape: byte for byte a
        # parts-route recompute; within tolerance of the default route
        # (fused at this budget)
        spec = e.rollups.specs[("cpu", "value")]
        for shape, q in shapes.items():
            served = await q(3)
            os.environ["HORAEDB_FUSED_AGG"] = "0"
            try:
                parts = await q(3, use_rollup=False)
            finally:
                del os.environ["HORAEDB_FUSED_AGG"]
            fused = await q(3, use_rollup=False)
            torch.cuda.synchronize()
            if not hasattr(fused["aggs"]["count"], "cpu"):
                raise AssertionError(f"rollup: the default route of the "
                                     f"{shape} did not take the fused path")
            same_result_bytes(served, parts, f"rollup {shape} vs parts")
            tolerance_match(served, fused, f"rollup {shape} vs fused")
            numpy_check(served, shape, 3, f"rollup {shape}")
            log(f"rollup: cross-check {shape}: served == parts recompute "
                f"byte for byte ({host_grids(served)['avg'].dtype}), "
                f"fused within tolerance, numpy checked")
        served0 = spec.served_queries

        def drop_tier_windows():
            for t in e.rollups.tiers.values():
                t.reader.drop_hbm_state()
                t.reader.scan_cache.clear()

        data_reader = e.tables["data"].reader

        async def timed_mix(use_rollup, reps, reset):
            times = {"zoom": [], "overview": []}
            for i in range(reps):
                for shape, q in shapes.items():
                    reset()
                    t0 = time.perf_counter()
                    out = await q(i, use_rollup)
                    torch.cuda.synchronize()
                    times[shape].append(time.perf_counter() - t0)
                    if i == 0 or shape == "zoom" and i < 12:
                        numpy_check(out, shape, i,
                                    f"rollup mix {shape} {i}")
            return times

        reset_all(ba, mg)
        snap = store.snap()
        roll_t = await timed_mix(True, 12, drop_tier_windows)
        res["rollup_leg_gets"] = store.since(snap)
        res["rollup_leg_launches"] = launches(ba, mg)
        if spec.served_queries - served0 != 24:
            raise AssertionError("rollup: not every mix query was "
                                 "rollup-served")
        if res["rollup_leg_gets"]["gets"] != 0:
            raise AssertionError(f"rollup: the rollup leg made "
                                 f"{res['rollup_leg_gets']} data-plane GETs")
        reset_all(ba, mg)
        snap = store.snap()
        raw_t = await timed_mix(False, 3, lambda: true_cold(data_reader))
        res["raw_cold_leg_gets"] = store.since(snap)
        res["raw_cold_leg_launches"] = launches(ba, mg)
        if not res["raw_cold_leg_launches"]["bucket_round_accumulate"]:
            raise AssertionError("rollup: the raw cold mix did not run "
                                 "the fused rounds")
        for shape in ("zoom", "overview"):
            res[f"rollup_{shape}_p50_ms"] = pctl(roll_t[shape], 50)
            res[f"rollup_{shape}_p99_ms"] = pctl(roll_t[shape], 99)
            res[f"raw_cold_{shape}_p50_ms"] = pctl(raw_t[shape], 50)
            res[f"raw_cold_{shape}_p99_ms"] = pctl(raw_t[shape], 99)
        mix_r = roll_t["zoom"] + roll_t["overview"]
        mix_c = raw_t["zoom"] + raw_t["overview"]
        res["rollup_mix_p50_ms"] = pctl(mix_r, 50)
        res["rollup_mix_p99_ms"] = pctl(mix_r, 99)
        res["raw_cold_mix_p50_ms"] = pctl(mix_c, 50)
        res["raw_cold_mix_p99_ms"] = pctl(mix_c, 99)
        res["mix_speedup_p50"] = (res["raw_cold_mix_p50_ms"]
                                  / res["rollup_mix_p50_ms"])
        log(f"rollup: rollup-served mix (24 queries) p50 "
            f"{res['rollup_mix_p50_ms']!r} ms p99 "
            f"{res['rollup_mix_p99_ms']!r} ms (zoom p50 "
            f"{res['rollup_zoom_p50_ms']!r} p99 {res['rollup_zoom_p99_ms']!r}"
            f", overview p50 {res['rollup_overview_p50_ms']!r} p99 "
            f"{res['rollup_overview_p99_ms']!r}); data-plane GETs "
            f"{json.dumps(res['rollup_leg_gets'])}; launches "
            f"{json.dumps(res['rollup_leg_launches'])}")
        log(f"rollup: raw cold mix (6 queries) p50 "
            f"{res['raw_cold_mix_p50_ms']!r} ms p99 "
            f"{res['raw_cold_mix_p99_ms']!r} ms (zoom p50 "
            f"{res['raw_cold_zoom_p50_ms']!r}, overview p50 "
            f"{res['raw_cold_overview_p50_ms']!r}); GETs "
            f"{json.dumps(res['raw_cold_leg_gets'])}; launches "
            f"{json.dumps(res['raw_cold_leg_launches'])}; mix p50 speedup "
            f"{res['mix_speedup_p50']!r}x")

        # where a served overview's time goes: the tier table's scan of
        # the cells (stage seconds from the registry) against the whole
        # query
        drop_tier_windows()
        before = {k: v for k, v in registry_snapshot().items()
                  if k.startswith("scan_stage_seconds{")
                  or (k.startswith("span_") and k.endswith("_seconds"))}
        t0 = time.perf_counter()
        await over(0)
        total_s = time.perf_counter() - t0
        after = registry_snapshot()
        res["overview_breakdown_s"] = {
            k: after[k] - v for k, v in before.items() if after[k] != v}
        res["overview_breakdown_s"]["query"] = total_s
        log(f"rollup: one served overview, seconds by span and stage "
            f"(summed over concurrent reads): "
            f"{json.dumps(res['overview_breakdown_s'])}")

        # a rollup-served top-k equals apply_top_k of the served grid
        rng_o = TimeRange.new(T0, T0 + over_span)
        t0 = time.perf_counter()
        tk = await e.query_topk("cpu", [], rng_o, hour, k=10, by="max")
        res["topk_ms"] = (time.perf_counter() - t0) * 1e3
        full = await e.query_downsample("cpu", [], rng_o, hour)
        values, grids = apply_top_k(np.asarray(full["tsids"], np.uint64),
                                    full["aggs"], TopKSpec(k=10, by="max"))
        if tk["tsids"] != [int(t) for t in values] or sorted(
                tk["aggs"]) != sorted(grids) or any(
                tk["aggs"][k].tobytes() != grids[k].tobytes()
                for k in grids):
            raise AssertionError("rollup: served top-k != apply_top_k of "
                                 "the served downsample")
        log(f"rollup: served top-10 by max over the overview in "
            f"{res['topk_ms']!r} ms, equal to apply_top_k of the served "
            f"grid")

        # a late write into one rolled segment: the next query serves
        # cells plus a one-segment raw tail, then one segment re-rolls.
        # write() wakes the maintenance loop; the manager's roll lock is
        # held over the write and the query so the loop's pass cannot
        # re-roll the segment before the query sees it dirty
        late_ts = zoom_starts[5] + 30 * 60_000 + 7
        ts2 = np.append(ts, late_ts)
        hid2 = np.append(host_id, np.int32(7))
        vals2 = np.append(vals, 123.25)
        rng_z = TimeRange.new(zoom_starts[5], zoom_starts[5] + zoom_ms)
        rolled0 = registry_value("rollup_segments_rolled_total")
        async with e.rollups._roll_lock:
            await e.write([Sample("cpu", [Label("host", "host_007")],
                                  late_ts, 123.25)])
            reset_all(ba, mg)
            served, counters = await traced(e.query_downsample(
                "cpu", [], rng_z, 60_000, aggs=("avg",)))
            res["late_tail_launches"] = launches(ba, mg)
        res["late_tail_segments"] = counters.get("rollup_tail_segments", 0)
        if res["late_tail_segments"] != 1:
            raise AssertionError(f"rollup: the query after the late write "
                                 f"recomputed {res['late_tail_segments']} "
                                 f"tail segments, not 1")
        os.environ["HORAEDB_FUSED_AGG"] = "0"
        try:
            parts = await e.query_downsample("cpu", [], rng_z, 60_000,
                                             aggs=("avg",), use_rollup=False)
        finally:
            del os.environ["HORAEDB_FUSED_AGG"]
        fused = await e.query_downsample("cpu", [], rng_z, 60_000,
                                         aggs=("avg",), use_rollup=False)
        same_result_bytes(served, parts, "rollup late tail vs parts")
        tolerance_match(served, fused, "rollup late tail vs fused")
        check_grid(served, ts2, hid2, vals2, zoom_starts[5],
                   zoom_ms // 60_000, 60_000, hosts, order, tsids,
                   "rollup late tail")
        # the loop's pass (woken by the write) or this one re-rolls the
        # dirty segment, and nothing else
        await e.rollups.roll_now()
        res["late_write_rerolled"] = (
            registry_value("rollup_segments_rolled_total") - rolled0)
        if res["late_write_rerolled"] != 1:
            raise AssertionError(f"rollup: the late write re-rolled "
                                 f"{res['late_write_rerolled']} segments, "
                                 f"not 1")
        again, counters = await traced(e.query_downsample(
            "cpu", [], rng_z, 60_000, aggs=("avg",)))
        if counters.get("rollup_tail_segments", 0) != 0:
            raise AssertionError("rollup: a tail after the re-roll")
        same_result_bytes(again, served, "rollup after the re-roll")
        log(f"rollup: late write served as cells + a 1-segment raw tail "
            f"(launches {json.dumps(res['late_tail_launches'])}), "
            f"byte-equal to the parts recompute; roll_now re-rolled 1 "
            f"segment")
        # the rows now hold the late write
        res["latency_store"] = await rollup_latency_turns(
            e, store, cfg, rollup_cfg, segment_ms, shapes,
            lambda out, shape, k, what: numpy_check(
                out, shape, k, what, rows=(ts2, hid2, vals2)))
    finally:
        await e.close()
    return res


async def rollup_latency_turns(e, store, cfg, rollup_cfg, segment_ms: int,
                               shapes: dict, numpy_check,
                               turns: int = 3) -> dict:
    """Config 11 over the reference's seeded 25 ms store
    (FaultInjectingStore(seed=11, latency_range=(0.025, 0.025)),
    suite.py:1521,1592): a second engine on the same objects behind the
    latency wrapper, its recovered rollup spec fully covering, and the
    in-memory engine beside it, in turns — each turn a rollup-served
    zoom and overview and a raw cold zoom and overview on each store.
    Both stores' grids byte-equal; the mix p50 speedup of each."""
    import torch

    from horaedb_tpu_torch.metric_engine import MetricEngine
    from horaedb_tpu_torch.objstore import FaultInjectingStore

    lat_s = 0.025
    slow = FaultInjectingStore(store, seed=11, latency_range=(lat_s, lat_s))
    t0 = time.perf_counter()
    e_lat = await MetricEngine.open("cfg11", slow, segment_ms=segment_ms,
                                    config=cfg, rollup_config=rollup_cfg)
    out = {"store_latency_ms": lat_s * 1e3, "turns": turns,
           "open_s": time.perf_counter() - t0}
    try:
        st = (await e_lat.stats())["rollups"]["specs"]["cpu:value"]
        if st["coverage"] != 1.0:
            raise AssertionError("rollup 25 ms: the recovered spec does not "
                                 "cover the data")
        engines = {"memory": e, "latency": e_lat}
        times = {(k, m): [] for k in engines for m in ("rollup", "raw")}
        for i in range(turns):
            for mode in ("rollup", "raw"):
                got = {}
                for k, eng in engines.items():
                    for shape, q in shapes.items():
                        if mode == "rollup":
                            for t in eng.rollups.tiers.values():
                                t.reader.drop_hbm_state()
                                t.reader.scan_cache.clear()
                        else:
                            true_cold(eng.tables["data"].reader)
                        t0 = time.perf_counter()
                        got[k, shape] = await q(i, mode == "rollup", eng)
                        torch.cuda.synchronize()
                        times[k, mode].append(time.perf_counter() - t0)
                for shape in shapes:
                    cmp = (same_result_bytes if mode == "rollup"
                           else tolerance_match)
                    cmp(got["latency", shape], got["memory", shape],
                        f"rollup 25 ms {mode} {shape} turn {i}")
                    if i == 0:
                        numpy_check(got["latency", shape], shape, i,
                                    f"rollup 25 ms {mode} {shape}")
        for k in engines:
            r = pctl(times[k, "rollup"], 50)
            c = pctl(times[k, "raw"], 50)
            out[k] = {"rollup_mix_p50_ms": r, "raw_cold_mix_p50_ms": c,
                      "mix_speedup_p50": c / r,
                      "rollup_ms": [t * 1e3 for t in times[k, "rollup"]],
                      "raw_cold_ms": [t * 1e3 for t in times[k, "raw"]]}
            log(f"rollup {k} store, in turns: served mix p50 {r!r} ms, raw "
                f"cold mix p50 {c!r} ms, speedup {c / r!r}x against the "
                f"reference's 5x bar: {'met' if c / r >= 5 else 'not met'} "
                f"({card_line()})")
    finally:
        await e_lat.close()
    return out


async def chunked_phase(ba, mg, per_host: int = 100_000) -> dict:
    """tools/chunked_vs_row.py's deployment at 10,000,000 rows: 100
    hosts, 10 s scrape, one-decimal gauges from seed 0, 30-minute chunk
    windows, scan cache at 4 x rows, ingested into a chunked engine and
    into a row-layout engine.  Cold avg at 1 min over the whole span
    (p50 of 3, in turns with the row layout's cold query), checked
    against numpy and the row layout; one bucket_window_partials launch
    per cold chunked query, held against its plain version on the card
    at the same shape, 5 launches byte-equal, timed beside its bound; a
    repeat served from the decode cache with nothing uploaded; two
    writes of one (series, ts); one Append compaction of a segment."""
    import numpy as np
    import pyarrow as pa
    import torch

    from horaedb_tpu_torch.metric_engine import Label, MetricEngine, Sample
    from horaedb_tpu_torch.metric_engine.types import tsid_of
    from horaedb_tpu_torch.ops.encode import h2d_bytes
    from horaedb_tpu_torch.storage.compaction import Task
    from horaedb_tpu_torch.storage.config import StorageConfig, from_dict
    from horaedb_tpu_torch.storage.sst import segment_of
    from horaedb_tpu_torch.storage.types import TimeRange

    hosts, interval, segment_ms = 100, 10_000, 2 * 3600 * 1000
    span = per_host * interval
    T0 = (1_700_000_000_000 // segment_ms) * segment_ms
    n = per_host * hosts
    rng = np.random.default_rng(0)
    ts = T0 + np.repeat(np.arange(per_host, dtype=np.int64) * interval,
                        hosts)
    host_id = np.tile(np.arange(hosts, dtype=np.int32), per_host)
    vals = np.round(rng.random(n) * 100, 1)
    names = pa.array([f"host_{i:03d}" for i in range(hosts)])
    tsid_of_host = np.array([tsid_of("cpu", [Label("host", f"host_{i:03d}")])
                             for i in range(hosts)], dtype=np.uint64)
    order = np.argsort(tsid_of_host)
    tsids = [int(t) for t in tsid_of_host[order]]
    nb = -(-span // BMS)
    rng_q = TimeRange.new(T0, T0 + span)
    cfg = from_dict(StorageConfig, {
        "scheduler": {"schedule_interval": "1h"},
        "scan": {"cache_max_rows": n * 4}})
    res: dict = {"rows": n, "buckets": nb}
    chunk_e = await MetricEngine.open("cvr_chunked", counting_store(),
                                      segment_ms=segment_ms, config=cfg,
                                      chunked_data=True)
    row_e = await MetricEngine.open("cvr_row", counting_store(),
                                    segment_ms=segment_ms, config=cfg)
    try:
        res["chunked_ingest_s"] = await ingest_rows(
            chunk_e, host_id, ts, vals, names, hosts)
        res["row_ingest_s"] = await ingest_rows(row_e, host_id, ts, vals,
                                                names, hosts)
        st_c, st_r = await chunk_e.stats(), await row_e.stats()
        res["chunked_data_bytes"] = st_c["tables"]["data"]["bytes"]
        res["row_data_bytes"] = st_r["tables"]["data"]["bytes"]
        res["chunked_data_rows"] = st_c["tables"]["data"]["rows"]
        log(f"chunked: ingest chunked {res['chunked_ingest_s']!r} s, row "
            f"{res['row_ingest_s']!r} s; data table chunked "
            f"{res['chunked_data_bytes']:,} B in "
            f"{res['chunked_data_rows']:,} rows, row layout "
            f"{res['row_data_bytes']:,} B")

        async def cold_chunked():
            chunk_e._chunk_cache.clear()
            reset_all(ba, mg)
            t0 = time.perf_counter()
            out = await chunk_e.query_downsample("cpu", [], rng_q, BMS,
                                                 aggs=("avg",))
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0, launches(ba, mg)

        async def cold_row():
            true_cold(row_e.tables["data"].reader)
            t0 = time.perf_counter()
            out = await row_e.query_downsample("cpu", [], rng_q, BMS,
                                               aggs=("avg",))
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0

        c_times, r_times, outs = [], [], []
        for _turn in range(3):
            out, secs, lc = await cold_chunked()
            c_times.append(secs)
            outs.append(out)
            if lc["bucket_window_partials"] != 1 or \
                    lc["bucket_round_accumulate"] or lc["kway_merge_perm"]:
                raise AssertionError(f"chunked: a cold query launched "
                                     f"{json.dumps(lc)}, not one partials")
            r_out, secs = await cold_row()
            r_times.append(secs)
        res["chunked_launches"] = lc
        res["chunked_cold_ms"] = [t * 1e3 for t in c_times]
        res["row_cold_ms"] = [t * 1e3 for t in r_times]
        res["chunked_cold_p50_ms"] = pctl(c_times, 50)
        res["row_cold_p50_ms"] = pctl(r_times, 50)
        res["chunked_vs_row"] = (res["chunked_cold_p50_ms"]
                                 / res["row_cold_p50_ms"])
        log(f"chunked: cold p50 {res['chunked_cold_p50_ms']!r} ms "
            f"({res['chunked_cold_ms']!r}) beside the row layout's "
            f"{res['row_cold_p50_ms']!r} ms ({res['row_cold_ms']!r}), in "
            f"turns: {res['chunked_vs_row']!r}x; one cold chunked query "
            f"launched {json.dumps(lc)}")
        got = outs[-1]
        check_grid(got, ts, host_id, vals, T0, nb, BMS, hosts, order, tsids,
                   "chunked cold")
        tolerance_match(got, r_out, "chunked vs row layout")
        for o in outs[:-1]:
            same_result_bytes(o, got, "chunked cold turns")

        # where a cold chunked query's time goes: the engine's steps
        # (_downsample_chunked) one by one — the Append scan with its
        # host merge, the payload decode, then the aggregate call
        # (padding, upload, one launch, the grids' download)
        from horaedb_tpu_torch.storage.read import ScanRequest

        pred = await chunk_e._resolve_data_predicate("cpu", [], rng_q,
                                                     "value")
        t0 = time.perf_counter()
        batches = [b async for b in chunk_e.tables["data"].scan(
            ScanRequest(range=rng_q, predicate=pred))]
        t1 = time.perf_counter()
        decoded = chunk_e._decode_chunk_arrays(batches, rng_q)
        t2 = time.perf_counter()
        split = chunk_e._downsample_arrays(*decoded, rng_q, BMS, nb,
                                           which=("avg",))
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        same_result_bytes(split, got, "chunked steps")
        res["cold_breakdown_s"] = {"scan_merge": t1 - t0,
                                   "decode": t2 - t1,
                                   "aggregate": t3 - t2}
        log(f"chunked: one cold query step by step (s): "
            f"{json.dumps(res['cold_breakdown_s'])}")
        del batches, decoded, split

        # a repeat: the decode cache serves it and nothing is uploaded
        hits, up = chunk_e._chunk_cache.hits, h2d_bytes()
        t0 = time.perf_counter()
        rep = await chunk_e.query_downsample("cpu", [], rng_q, BMS,
                                             aggs=("avg",))
        torch.cuda.synchronize()
        res["chunked_repeat_ms"] = (time.perf_counter() - t0) * 1e3
        res["chunked_repeat_h2d_bytes"] = h2d_bytes() - up
        if chunk_e._chunk_cache.hits != hits + 1 or \
                res["chunked_repeat_h2d_bytes"]:
            raise AssertionError("chunked: the repeat missed the decode "
                                 "cache or uploaded bytes")
        same_result_bytes(rep, got, "chunked repeat")
        log(f"chunked: repeat {res['chunked_repeat_ms']!r} ms from the "
            f"decode cache, 0 B up")

        # the cold query's one launch at its own shape: against the
        # plain version on the card, 5 launches byte-equal, timed
        entry = next(iter(chunk_e._chunk_cache._entries.values()))[0]
        dev = entry["memo"]["dev"]
        G = len(dev["uniq"])
        args = (dev["ts"][None, :], dev["gid"][None, :],
                dev["val"][None, :], None, None, None, nb, BMS)
        kw = dict(num_groups=G, width=nb, which=("avg",), n_valid=n)
        ref = ba.bucket_window_partials_plain(*args, **kw)
        runs = [ba.bucket_window_partials(*args, **kw) for _ in range(5)]
        torch.cuda.synchronize()
        res["kernel_max_abs_err"] = compare(runs[0], ref,
                                            "chunked partials vs plain")
        patterns = {f: len({r[f].cpu().numpy().tobytes() for r in runs})
                    for f in runs[0]}
        if any(v != 1 for v in patterns.values()):
            raise AssertionError(f"chunked: 5 launches gave byte patterns "
                                 f"{patterns}")
        res["kernel_patterns"] = patterns
        res["kernel_ms"] = device_ms(lambda: ba.bucket_window_partials(
            *args, **kw), reps=20)
        res["plain_ms"] = cuda_ms(lambda: ba.bucket_window_partials_plain(
            *args, **kw), reps=3, warmup=1)
        cell = (dev["gid"][:n].long() * nb
                + dev["ts"][:n].long() // BMS)
        acc = torch.zeros(G * nb, dtype=torch.float32, device=cell.device)
        res["library_ms"] = cuda_ms(
            lambda: acc.index_add_(0, cell, dev["val"][:n]), reps=10)
        # bytes: each input row read once (ts, gid, val: 12 B), each
        # output cell written once (count and sum, 4 B each)
        res["bound_bytes"] = 12 * n + 2 * 4 * G * nb
        res["bound_ms"] = res["bound_bytes"] / HBM_BYTES_PER_S * 1e3
        log(f"chunked: bucket_window_partials at W=1, cap "
            f"{int(dev['ts'].numel()):,}, n_valid {n:,}, grid {G} x {nb}: "
            f"{res['kernel_ms']!r} ms against a {res['bound_ms']!r} ms bound "
            f"({res['bound_bytes']:,} B / 3.35 TB/s); plain version "
            f"{res['plain_ms']!r} ms; index_add_ (sum alone) "
            f"{res['library_ms']!r} ms; max abs err vs plain "
            f"{res['kernel_max_abs_err']!r}; byte patterns in 5 launches "
            f"{json.dumps(patterns)}")

        # two writes of one (series, ts): the later value is kept
        dup_ts = T0 + span - interval
        for v in (1.5, 2.5):
            await chunk_e.write([Sample("cpu", [Label("host", "host_042")],
                                        dup_ts, v)])
        tbl = await chunk_e.query("cpu", [("host", "host_042")],
                                  TimeRange.new(dup_ts, dup_ts + 1))
        if tbl.column("value").to_pylist() != [2.5]:
            raise AssertionError(f"chunked: duplicate write kept "
                                 f"{tbl.column('value').to_pylist()}")
        # one Append compaction of that segment changes no result
        data = chunk_e.tables["data"]
        seg = int(dup_ts // segment_ms * segment_ms)
        before = await chunk_e.query_downsample("cpu", [], rng_q, BMS,
                                                aggs=("avg", "last"))
        inputs = [f for f in await data.manifest.all_ssts()
                  if segment_of(f, segment_ms) == seg]
        for f in inputs:
            f.mark_compaction()
        t0 = time.perf_counter()
        await data.compact_scheduler.executor.execute(Task(inputs=inputs))
        res["compaction_s"] = time.perf_counter() - t0
        left = [f for f in await data.manifest.all_ssts()
                if segment_of(f, segment_ms) == seg]
        after = await chunk_e.query_downsample("cpu", [], rng_q, BMS,
                                               aggs=("avg", "last"))
        same_result_bytes(after, before, "chunked compaction")
        if len(left) != 1:
            raise AssertionError("chunked: compaction left "
                                 f"{len(left)} SSTs in the segment")
        log(f"chunked: duplicate (series, ts) keeps the later value; "
            f"compaction of segment {seg} ({len(inputs)} SSTs -> 1) in "
            f"{res['compaction_s']!r} s changed no result")
    finally:
        await chunk_e.close()
        await row_e.close()
    return res


def ledger_report(what: str) -> dict:
    """The memory ledger on the card: attributed bytes per account kind
    against the process RSS, and the CUDA allocator's live bytes (per
    device) against torch.cuda.max_memory_allocated()."""
    import torch

    from horaedb_tpu_torch.common import memledger

    memledger.ledger.sample_once()  # now, not the sampler's last round
    summary = memledger.ledger.summary()
    devices = memledger.device_memory()
    peak = torch.cuda.max_memory_allocated()
    out = {"rss_bytes": summary["rss_bytes"],
           "attributed_bytes": summary["attributed_bytes"],
           "unattributed_bytes": summary["unattributed_bytes"],
           "accounts": summary["accounts"], "devices": devices,
           "max_memory_allocated": peak}
    log(f"ledger after {what}: rss {summary['rss_bytes']:,} B, attributed "
        f"{summary['attributed_bytes']:,} B, unattributed "
        f"{summary['unattributed_bytes']:,} B; per kind "
        f"{json.dumps(summary['accounts'])}; device "
        f"{json.dumps(devices)} against max_memory_allocated {peak:,} B "
        f"({card_line()})")
    if not devices or not all(
            0 < d["bytes_in_use"] <= d["peak_bytes_in_use"] for d in devices):
        raise AssertionError(f"ledger: no live CUDA device bytes reported "
                             f"({devices})")
    return out


def span_lines(node: dict, depth: int = 0, limit: int = 40) -> list:
    """A stitched trace's span tree as indented lines (name, ms)."""
    lines = [f"{'  ' * depth}{node.get('name')} "
             f"{node.get('duration_ms')!r} ms"]
    for child in node.get("children", []):
        if len(lines) >= limit:
            lines.append(f"{'  ' * (depth + 1)}...")
            break
        lines.extend(span_lines(child, depth + 1, limit - len(lines)))
    return lines


async def scanagent_phase(ba, mg, dd, per_host: int = 100_000) -> dict:
    """The JAX package's bench config 17 (suite.py run_config17): the
    cold dashboard mix over a seeded 25 ms-latency store at config 1's
    shape (100 hosts, 10 s scrape, 139 2 h segments, seed 17), the
    coordinator's data table read through a data-byte counter.  Legs:
    off (the default route: fused at a 4 x rows budget), off on the
    parts route (HORAEDB_FUSED_AGG=0), agent (an AgentService on this
    card, colocated with the raw inner store), agent_killed (the agent
    closed: the per-segment fallback reads direct), and disk (a
    LocalObjectStore: 0 coordinator segment reads on the agent route; a
    dead-agent fallback that streams its SSTs).  Every rep is true cold
    at the coordinator and at the agent."""
    import shutil

    import numpy as np
    import pyarrow as pa
    import torch

    from horaedb_tpu_torch.metric_engine import Label, MetricEngine
    from horaedb_tpu_torch.metric_engine.types import tsid_of
    from horaedb_tpu_torch.objstore import (FaultInjectingStore,
                                            LocalObjectStore,
                                            MemoryObjectStore,
                                            WrappedObjectStore)
    from horaedb_tpu_torch.scanagent import (AgentService, AgentSpec,
                                             ScanAgentConfig)
    from horaedb_tpu_torch.scanagent import client as sa_client
    from horaedb_tpu_torch.storage import parquet_io
    from horaedb_tpu_torch.storage.config import StorageConfig, from_dict
    from horaedb_tpu_torch.storage.types import TimeRange

    class DataByteCounter(WrappedObjectStore):
        """The coordinator's data-plane bytes: GETs and bytes of the
        data table's .sst/.enc reads, buffered and streamed (the
        reference's counter; it hides local_path, so the disk rung's
        fallback reads go through the countable surface)."""

        def __init__(self, inner, prefix: str):
            super().__init__(inner)
            self.prefix = prefix
            self.data_bytes = 0
            self.data_gets = 0
            self.stream_ops = 0

        def _is_data(self, path) -> bool:
            p = str(path)
            return p.startswith(self.prefix) and p.endswith((".sst", ".enc"))

        async def _call(self, op: str, *args):
            out = await super()._call(op, *args)
            if op in ("get", "get_range") and self._is_data(args[0]):
                self.data_gets += 1
                self.data_bytes += len(out)
            return out

        async def _stream(self, op: str, path: str, chunk_size: int):
            counted = self._is_data(path)
            if counted:
                self.data_gets += 1
                self.stream_ops += 1
            async for chunk in self.inner.get_stream(path, chunk_size):
                if counted:
                    self.data_bytes += len(chunk)
                yield chunk

    lat_s = 0.025
    hosts, interval, segment_ms, hour = 100, 10_000, 2 * 3600 * 1000, 3_600_000
    span = per_host * interval
    T0 = (1_700_000_000_000 // segment_ms) * segment_ms
    n = per_host * hosts
    rng = np.random.default_rng(17)
    ts = T0 + np.repeat(np.arange(per_host, dtype=np.int64) * interval,
                        hosts)
    host_id = np.tile(np.arange(hosts, dtype=np.int32), per_host)
    vals = (rng.random(n) * 100).astype(np.float64)
    names = pa.array([f"host_{i:03d}" for i in range(hosts)])
    tsid_of_host = np.array([tsid_of("cpu", [Label("host", f"host_{i:03d}")])
                             for i in range(hosts)], dtype=np.uint64)
    order = np.argsort(tsid_of_host)
    tsids = [int(t) for t in tsid_of_host[order]]
    vals32 = vals.astype(np.float32)
    zoom_ms = min(span, 6 * hour)
    reps = 2
    cfg = from_dict(StorageConfig, {
        "scheduler": {"schedule_interval": "1h"},
        "scan": {"cache_max_rows": n * 4}})
    res: dict = {"rows": n, "store_latency_ms": lat_s * 1e3,
                 "reps_per_leg": reps}
    log(f"scanagent: the JAX package's config 17 (suite.py:2995-3300) at "
        f"{n:,} rows, {span // segment_ms + 1} segments, store latency "
        f"{lat_s * 1e3} ms (FaultInjectingStore, seed 17), {reps} true-cold "
        f"reps a leg")

    def queries(rep: int) -> list:
        out = [(T0, span // hour, hour, ("avg",))]
        for z in range(2):
            lo = T0 + ((rep * 2 + z) * zoom_ms) % max(1, span - zoom_ms + 1)
            out.append((lo, zoom_ms // 60_000, 60_000, ("avg", "max")))
        return out

    def numpy_check(got, lo, nb, bms, aggs, what):
        check_grid(got, ts, host_id, vals, lo, nb, bms, hosts, order,
                   tsids, what)
        if "max" in aggs:
            off = ts - lo
            sel = (off >= 0) & (off < nb * bms)
            cell = host_id[sel].astype(np.int64) * nb + off[sel] // bms
            want = np.full(hosts * nb, -np.inf, dtype=np.float32)
            np.maximum.at(want, cell, vals32[sel])
            want = want.reshape(hosts, nb)[order].astype(np.float64)
            got_max = host_grids(got)["max"].astype(np.float64)
            occ = np.isfinite(want)
            if not np.array_equal(got_max[occ], want[occ]):
                raise AssertionError(f"{what}: max grid differs from numpy")

    async def mix(e, rep: int, check: bool = False) -> list:
        out = []
        for lo, nb, bms, aggs in queries(rep):
            got = await e.query_downsample(
                "cpu", [], TimeRange.new(lo, lo + nb * bms), bucket_ms=bms,
                aggs=aggs)
            if check:
                numpy_check(got, lo, nb, bms, aggs,
                            f"scanagent rep {rep} {bms} ms")
            out.append(got)
        torch.cuda.synchronize()
        return out

    def snap_counters(prefix: str) -> dict:
        return {k: v for k, v in registry_snapshot().items()
                if k.startswith(prefix)}

    async def timed_mix(e, counter, reset, label: str) -> dict:
        times, results = [], []
        partials0 = sa_client._PARTIAL_BYTES.value
        bytes0, gets0 = counter.data_bytes, counter.data_gets
        for rep in range(reps):
            reset()
            t0 = time.perf_counter()
            results.append(await mix(e, rep))
            times.append(time.perf_counter() - t0)
        leg = {"p50_ms": pctl(times, 50), "ms": [t * 1e3 for t in times],
               "store_data_bytes": counter.data_bytes - bytes0,
               "store_data_gets": counter.data_gets - gets0,
               "partial_bytes": int(sa_client._PARTIAL_BYTES.value
                                    - partials0)}
        leg["coordinator_bytes"] = (leg["store_data_bytes"]
                                    + leg["partial_bytes"])
        # every rep against numpy (outside the timed loop)
        for rep, got in enumerate(results):
            for (lo, nb, bms, aggs), out in zip(queries(rep), got):
                numpy_check(out, lo, nb, bms, aggs,
                            f"scanagent {label} rep {rep} {bms} ms")
        log(f"scanagent {label}: p50 {leg['p50_ms']!r} ms, store data "
            f"{leg['store_data_bytes']:,} B in {leg['store_data_gets']} GETs "
            f"+ partials {leg['partial_bytes']:,} B = coordinator "
            f"{leg['coordinator_bytes']:,} B ({card_line()})")
        return {"leg": leg, "results": results}

    def same_mix(a: list, b: list, what: str, exact: bool) -> None:
        for rep, (xa, xb) in enumerate(zip(a, b)):
            for q, (ra, rb) in enumerate(zip(xa, xb)):
                (same_result_bytes if exact else tolerance_match)(
                    ra, rb, f"{what} rep {rep} query {q}")

    def mix_bytes(results: list) -> bytes:
        # the reference's in-bench comparison: tsids, then every grid's
        # bytes in key order
        buf = bytearray()
        for got in results:
            for r in got:
                buf += np.asarray(r["tsids"], dtype=np.uint64).tobytes()
                g = host_grids(r)
                for k in sorted(g):
                    buf += g[k].tobytes()
        return bytes(buf)

    def cold_agent(agent):
        for t in agent._tables.values():
            true_cold(t.reader)

    # the rows go straight into the inner store (ingest is not what this
    # cell measures); every leg reads through the latency wrapper
    inner = MemoryObjectStore()
    e = await MetricEngine.open("cfg17", inner, segment_ms=segment_ms,
                                config=cfg)
    try:
        res["ingest_s"] = await ingest_rows(e, host_id, ts, vals, names,
                                            hosts)
    finally:
        await e.close()
    log(f"scanagent: ingest {n:,} rows into the inner store in "
        f"{res['ingest_s']!r} s ({card_line()})")
    coord = DataByteCounter(FaultInjectingStore(
        inner, seed=17, latency_range=(lat_s, lat_s)), prefix="cfg17/data/")
    e = await MetricEngine.open("cfg17", coord, segment_ms=segment_ms,
                                config=cfg)
    try:
        data = e.tables["data"]
        reset_all(ba, mg)
        off = await timed_mix(e, coord, lambda: true_cold(data.reader),
                              "off")
        res["off"] = off["leg"]
        res["off"]["launches"] = launches(ba, mg)
        res["off"]["route"] = ("fused" if res["off"]["launches"][
            "bucket_round_accumulate"] else "parts")
        os.environ["HORAEDB_FUSED_AGG"] = "0"
        try:
            reset_all(ba, mg)
            off_parts = await timed_mix(
                e, coord, lambda: true_cold(data.reader), "off_parts")
            res["off_parts"] = off_parts["leg"]
            res["off_parts"]["launches"] = launches(ba, mg)
        finally:
            del os.environ["HORAEDB_FUSED_AGG"]
        if res["off_parts"]["launches"]["bucket_round_accumulate"]:
            raise AssertionError("scanagent: the parts-route control ran "
                                 "fused rounds")
    finally:
        await e.close()

    # the agent serves aggregate partials only, so its reader decodes on
    # the card ([scan.decode] mode = "device"): under "auto" a
    # one-segment plan fits the fused budget and keeps host decode,
    # though the agent never runs the fused route
    agent_cfg = from_dict(StorageConfig, {"scan": {"decode": {
        "mode": "device"}}})
    agent = AgentService(inner, storage_config=agent_cfg)  # on this card
    url = await agent.start()
    sa_cfg = ScanAgentConfig(mode="on", num_slots=1,
                             agents=(AgentSpec("shard0", url, (0,)),))
    e = await MetricEngine.open("cfg17", coord, segment_ms=segment_ms,
                                config=cfg, scanagent_config=sa_cfg)
    try:
        data = e.tables["data"]

        def cold_both():
            true_cold(data.reader)
            cold_agent(agent)

        req0 = snap_counters("scanagent_requests_total{")
        fb0 = snap_counters("scanagent_fallback_total")
        dec0 = sum(dd.fallback_counts().values())
        reset_all(ba, mg)
        served = await timed_mix(e, coord, cold_both, "agent")
        res["agent"] = served["leg"]
        res["agent"]["launches"] = launches(ba, mg)
        res["agent"]["decode_fallbacks"] = (
            sum(dd.fallback_counts().values()) - dec0)
        res["agent"]["requests"] = {
            k: v - req0.get(k, 0.0)
            for k, v in snap_counters("scanagent_requests_total{").items()
            if v != req0.get(k, 0.0)}
        res["agent"]["fallbacks"] = {
            k: v - fb0.get(k, 0.0)
            for k, v in snap_counters("scanagent_fallback_total").items()
            if v != fb0.get(k, 0.0)}
        log(f"scanagent agent: launches {json.dumps(res['agent']['launches'])}"
            f", decode fallbacks {res['agent']['decode_fallbacks']}, "
            f"requests {json.dumps(res['agent']['requests'])}, fallbacks "
            f"{json.dumps(res['agent']['fallbacks'])} ({card_line()})")
        la = res["agent"]["launches"]
        if not la["bucket_window_partials"] or not la["kway_merge_perm"]:
            raise AssertionError("scanagent: the agent did not run "
                                 "bucket_window_partials and kway_merge_perm")
        if la["bucket_round_accumulate"]:
            raise AssertionError("scanagent: the agent route ran fused "
                                 "rounds")
        if res["agent"]["decode_fallbacks"]:
            raise AssertionError("scanagent: device decode fell back at the "
                                 "agent")
        if res["agent"]["fallbacks"] or res["agent"]["store_data_gets"]:
            raise AssertionError("scanagent: the agent leg fell back to "
                                 "direct reads")
        same_mix(served["results"], off_parts["results"],
                 "scanagent agent vs off_parts", exact=True)
        same_mix(off["results"], served["results"],
                 "scanagent off vs agent", exact=False)
        same_mix(off["results"], off_parts["results"],
                 "scanagent off vs off_parts", exact=False)
        res["agent_byte_identical_to_off_parts"] = True
        # the reference asserts agent == off byte for byte; here off
        # takes the fused route, whose float32 sums are its own contract
        res["agent_bytes_equal_fused_off"] = (
            mix_bytes(served["results"]) == mix_bytes(off["results"]))
        log(f"scanagent: agent grids byte-equal to the parts-route off leg; "
            f"the reference's in-bench check against the fused off leg "
            f"(byte equality) would "
            f"{'hold' if res['agent_bytes_equal_fused_off'] else 'fail'}: "
            f"the fused leg is within rtol 1e-5")
        ratio = (res["off"]["coordinator_bytes"]
                 / max(1, res["agent"]["coordinator_bytes"]))
        res["bytes_reduction_x"] = ratio
        res["bytes_reduction_x_parts"] = (
            res["off_parts"]["coordinator_bytes"]
            / max(1, res["agent"]["coordinator_bytes"]))
        res["bar_bytes_reduction_met"] = bool(ratio >= 5.0)
        log(f"scanagent: coordinator bytes off/agent {ratio!r}x (parts-route "
            f"off/agent {res['bytes_reduction_x_parts']!r}x) against the "
            f"reference's 5x bar: "
            f"{'met' if ratio >= 5.0 else 'not met'}; p50 off "
            f"{res['off']['p50_ms']!r} ms ({res['off']['route']}), off_parts "
            f"{res['off_parts']['p50_ms']!r} ms, agent "
            f"{res['agent']['p50_ms']!r} ms ({card_line()})")

        # one stitched trace of an agent-served query: the routing span
        # with the agent's spans under it
        from horaedb_tpu_torch.utils import tracing

        cold_both()
        lo, nb, bms, aggs = queries(0)[0]
        trace = tracing.recorder.start("/query", forced=True)
        with tracing.trace_scope(trace):
            await e.query_downsample("cpu", [],
                                     TimeRange.new(lo, lo + nb * bms),
                                     bucket_ms=bms, aggs=aggs)
        done = tracing.recorder.finish(trace)
        rpc = {s["span_id"] for s in done["spans"]
               if s["name"] == "scanagent_rpc"}
        under = [s for s in done["spans"] if s["name"] == "scanagent/scan"
                 and s["parent_id"] in rpc]
        res["trace"] = {"spans": len(done["spans"]), "rpc_spans": len(rpc),
                        "agent_roots_under_rpc": len(under),
                        "counters": done["counters"]}
        if not rpc or len(under) != len(rpc):
            raise AssertionError("scanagent: the agent's spans are not "
                                 "stitched under the routing spans")
        tree = tracing.span_tree(done)["tree"]
        shown = {k: v for k, v in done["counters"].items()
                 if k.startswith(("scanagent", "stage_device", "stage_fetch"))}
        log("scanagent: stitched trace of one agent-served overview "
            f"({len(done['spans'])} spans, {len(rpc)} routing spans, each "
            f"with the agent's scanagent/scan under it); counters "
            f"{json.dumps(shown)} ({card_line()})")
        for line in span_lines(tree, limit=24):
            log(f"scanagent trace: {line}")
        res["ledger"] = ledger_report("the agent leg (config 17)")

        fb0 = sa_client._FALLBACKS.total
        await agent.close()
        killed = await timed_mix(e, coord, lambda: true_cold(data.reader),
                                 "agent_killed")
        res["agent_killed"] = killed["leg"]
        res["agent_killed"]["fallback_segments"] = int(
            sa_client._FALLBACKS.total - fb0)
        if not res["agent_killed"]["fallback_segments"]:
            raise AssertionError("scanagent: no fallback with the agent dead")
        same_mix(killed["results"], off_parts["results"],
                 "scanagent agent_killed vs off_parts", exact=True)
    finally:
        await e.close()
        await agent.close()

    tmp = scratch_dir("cfg17")
    disk_agent = None
    try:
        local = LocalObjectStore(tmp)
        disk = DataByteCounter(local, prefix="cfg17d/data/")
        e = await MetricEngine.open("cfg17d", disk, segment_ms=segment_ms,
                                    config=cfg)
        try:
            res["disk_ingest_s"] = await ingest_rows(
                e, host_id, ts, vals, names, hosts)
        finally:
            await e.close()
        disk_agent = AgentService(local, storage_config=agent_cfg)
        url = await disk_agent.start()
        e = await MetricEngine.open(
            "cfg17d", disk, segment_ms=segment_ms, config=cfg,
            scanagent_config=ScanAgentConfig(
                mode="on", num_slots=1,
                agents=(AgentSpec("shard0", url, (0,)),)))
        try:
            data = e.tables["data"]

            def cold_disk():
                true_cold(data.reader)
                cold_agent(disk_agent)

            got = await timed_mix(e, disk, cold_disk, "disk")
            res["disk"] = got["leg"]
            same_mix(got["results"], off_parts["results"],
                     "scanagent disk vs off_parts", exact=True)
            if res["disk"]["store_data_gets"] != 0:
                raise AssertionError("scanagent: the coordinator read "
                                     "segments on the disk agent route")
            await disk_agent.close()
            old_min = parquet_io.STREAM_FETCH_MIN_BYTES
            parquet_io.STREAM_FETCH_MIN_BYTES = 1
            data.config.scan.use_sidecar = False
            try:
                true_cold(data.reader)
                t0 = time.perf_counter()
                fb = await mix(e, 0, check=True)
                fb_ms = (time.perf_counter() - t0) * 1e3
            finally:
                parquet_io.STREAM_FETCH_MIN_BYTES = old_min
                data.config.scan.use_sidecar = True
            same_mix([fb], off_parts["results"][:1],
                     "scanagent disk fallback vs off_parts", exact=True)
            res["disk_fallback"] = {"ms": fb_ms,
                                    "streamed_sst_reads": disk.stream_ops}
            log(f"scanagent disk: dead-agent fallback {fb_ms!r} ms, "
                f"{disk.stream_ops} streamed SST reads ({card_line()})")
            if not disk.stream_ops:
                raise AssertionError("scanagent: the dead-agent disk "
                                     "fallback did not stream SSTs")
        finally:
            await e.close()
    finally:
        if disk_agent is not None:
            await disk_agent.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return res


def load_merge_module(root: str):
    """ops/merge.py of another checkout at `root`, loaded under its own
    name and pointed at that checkout's csrc/merge_path.cu (it builds
    into this checkout's build directory, keyed by the source's
    content)."""
    import importlib.util

    path = os.path.join(root, "horaedb_tpu_torch", "ops", "merge.py")
    spec = importlib.util.spec_from_file_location("parent_merge", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.SOURCE = os.path.join(root, "horaedb_tpu_torch", "csrc",
                              "merge_path.cu")
    return mod


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=10_000_000,
                    help="rows of the end-to-end phase (a cut is printed)")
    ap.add_argument("--json", default=None,
                    help="also write every number of the run to this file")
    ap.add_argument("--config4-rows", type=int, default=64_000_000,
                    help="rows of the config 4 phase (64 SSTs; the cut "
                         "from 1B is printed; below 8,388,608 rows the "
                         "segment no longer streams and the phase fails "
                         "its route check)")
    ap.add_argument("--parent", default=None,
                    help="root of another checkout of this repo (e.g. a git "
                         "archive of the parent commit): its merge kernel is "
                         "timed beside this one, in turns")
    args = ap.parse_args()
    t_start = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    card = card_line()
    log(f"device: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    if args.rows != 10_000_000:
        log(f"scale cut: --rows {args.rows} instead of 10,000,000")

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from horaedb_tpu_torch import native
    from horaedb_tpu_torch.ops import bucket_agg as ba
    from horaedb_tpu_torch.ops import device_decode as dd
    from horaedb_tpu_torch.ops import merge as mg
    from horaedb_tpu_torch.storage import read as fused

    # one compiler per source (nvcc for the kernels, g++ for the host
    # library, which ingest would otherwise build at its first write),
    # all started together
    def timed_build(mod):
        t0 = time.perf_counter()
        mod.build()
        return time.perf_counter() - t0

    parent = load_merge_module(args.parent) if args.parent else None
    mods = (ba, mg, native) + ((parent,) if parent else ())
    with ThreadPoolExecutor(max_workers=len(mods)) as pool:
        built = {mod: pool.submit(timed_build, mod) for mod in mods}
        built = {mod: f.result() for mod, f in built.items()}
    for mod, secs in built.items():
        log(f"build: {os.path.relpath(mod.SOURCE)} in {secs!r} s")
        for line in ("" if mod is native else mod.build_log()).splitlines():
            if "registers" in line or "spill" in line:
                log(f"build: {line.strip()}")

    def phase(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        log(f"phase {name}: {time.perf_counter() - t0!r} s")
        return out

    kernels = phase("kernel", kernel_phase, ba, fused)
    merge_k = phase("merge kernel", merge_kernel_phase, mg, dd, parent)
    determinism = phase("determinism", determinism_phase, ba, fused)
    e2e = phase("end to end (fused, op, parts)", asyncio.run,
                end_to_end(args.rows, ba, mg))
    compaction = phase("compaction", asyncio.run, compaction_phase(ba, mg))
    wal = phase("wal", asyncio.run,
                wal_phase(args.rows, ba, mg, e2e["ingest_s"]))
    topk_ops = phase("topk ops", topk_ops_phase)
    config4 = phase("config4", asyncio.run,
                    config4_phase(args.config4_rows, ba, mg))
    rollup = phase("rollup", asyncio.run, rollup_phase(ba, mg))
    chunked = phase("chunked", asyncio.run, chunked_phase(ba, mg))
    scanagent = phase("scanagent", asyncio.run, scanagent_phase(ba, mg, dd))
    kernels.append({
        "name": "kway_merge_perm", "route": "cuda",
        "source": "horaedb_tpu_torch/csrc/merge_path.cu",
        "replaces": "horaedb_tpu/ops/merge.py:84",
        "launches": 0, "max_abs_err": merge_k["max_abs_err"],
        "ms": merge_k["ms"], "plain_ms": merge_k["plain_ms"],
        "bound_ms": merge_k["bound_ms"], "bound_by": "bytes",
        "library_ms": merge_k["library_ms"],
        "library_call": "multi-pass stable torch.sort (ops/merge.lex_sort)",
        "call_ms": merge_k["call_ms"], "host_ms": merge_k["host_ms"],
        "levels": merge_k["levels"],
        "level_ms": merge_k["level_ms"],
        "shapes": {name: {k: v for k, v in t.items() if k != "turns"}
                   for name, t in merge_k["shapes"].items()}})
    for k in kernels:
        # launches on each kernel's engine path, counted from 0 around
        # it: the device-decode leg's cold parts query (one partials
        # launch per segment, one merge launch per level of each k-way
        # segment), the fused path's six queries
        k["launches"] = {"bucket_window_partials": e2e["parts"]["launches"],
                         "kway_merge_perm": e2e["parts"]["kway_launches"],
                         "bucket_round_accumulate": e2e["launches"]}[k["name"]]
        # and on the wal cell's engine path, counted from 0 around it
        k["wal_launches"] = wal["launches"][k["name"]]
        # and on config 4's true-cold query (the round entry is not on
        # its path: 0)
        k["config4_launches"] = config4["launches"][k["name"]]
        # and on the rollup cell: the backfill (139 segments x 2 tiers
        # on the parts route), the rollup-served mix (no raw tail: 0)
        # and the raw cold mix; and on one cold chunked query
        k["rollup_backfill_launches"] = \
            rollup["backfill_launches"][k["name"]]
        k["rollup_mix_launches"] = rollup["rollup_leg_launches"][k["name"]]
        k["rollup_raw_cold_launches"] = \
            rollup["raw_cold_leg_launches"][k["name"]]
        k["chunked_launches"] = chunked["chunked_launches"][k["name"]]
        # and on config 17's agent leg (at the agent, on this card)
        k["scanagent_launches"] = scanagent["agent"]["launches"][k["name"]]
        if k["name"] == "bucket_window_partials":
            # the chunked path's shape: W = 1, 10M valid rows
            k["chunked_shape"] = {
                "ms": chunked["kernel_ms"], "bound_ms": chunked["bound_ms"],
                "plain_ms": chunked["plain_ms"],
                "library_ms": chunked["library_ms"],
                "max_abs_err": chunked["kernel_max_abs_err"]}
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump({"card": card, "kernels": kernels, "e2e": e2e,
                       "merge_kernel": merge_k, "determinism": determinism,
                       "compaction": compaction, "wal": wal,
                       "topk_ops": topk_ops, "config4": config4,
                       "rollup": rollup, "chunked": chunked,
                       "scanagent": scanagent}, f,
                      indent=1)
    log(f"total: {time.perf_counter() - t_start!r} s")
    log(json.dumps({"kernels": kernels}))
    log(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
