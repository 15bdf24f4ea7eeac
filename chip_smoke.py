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
   atomic sum, and a one-call `index_add_` yardstick; with --parent DIR,
   that checkout's two entries at the same round in turns (avg set and
   all aggregates).
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
   Then nan bits (Queue C 18): NAN_LEGS (+NaN, -NaN, both signs in one
   cell, both signs across two segments under a 1-day bucket) on the
   fused route and the parts route with device and with host decode;
   sum, min and max must read the JAX package's bits from the CPU run of
   tests/test_torch_nan_sign.py, and each leg must launch its route's
   kernel; then both entries byte for byte against their plain versions
   on a NaN-sign round, with the round's raw NaN images.
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
   overlapping SSTs of --config4-rows / 64 rows, 32M by default (64M
   until the bench suite's configs 11-23 joined the run) and the cut
   from 1B printed; 100 hosts as a string PK, one 1 h segment,
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
16. server: BASELINE config 1, unchanged, over HTTP: the port's server
   in process (ServerState + build_app on an AppRunner at 127.0.0.1:0)
   from docs/example.toml loaded by the port's load_config, its data_dir
   and WAL dir moved into a scratch directory beside this script (a
   LocalObjectStore, removed after).  Ingest through POST /write_arrow
   in 1M-row Arrow IPC bodies; then two nodes over the same store: the
   example's own scan budget (parts route: device decode,
   kway_merge_perm, bucket_window_partials) and the scan cache at 4 x
   rows (fused route, the replay).  Per node: POST /query at 1 min over
   the whole range true cold and 5 repeats (each repeat's body byte-equal
   to the cold one), beside the direct query_downsample in turns; the
   cold body byte for byte the direct call's after the JSON round trip
   and against numpy (count, min, max, last exact; sum, avg rtol 1e-5);
   each kernel entry on the node's route launched; /query_topk (top 10
   by max at 1 h), /query_multi and /query_arrow against their direct
   calls; /label_values, /stats (its deviceprof summary), /metrics and
   /admin/flush; GET /debug/device around each node's 12 calls, whose
   per-seam launches must equal the kernels' own counters.  Then
   deviceprof: the fused node's cached query (a replay) with the device
   profiler on and off in 10 turns each, alternating: both p50s, and the
   explicit syncs per query, which must not differ.  Then the CLI: `python -m horaedb_tpu_torch.server`
   from a copy of the config in a subprocess, GET / until it answers,
   one /write, a /query that returns it, SIGTERM: it must exit 0, its
   engine on the card.
17. cluster: config 1's shape at full rows over Cluster.open(
   num_regions=4) on one card, region 3's engine behind a second server
   in process reached through RemoteRegion: each region's share (by
   routing_key of each host) through its own engine (write_arrow, or
   /write_arrow for the remote one), a 10,000-sample tail through
   Cluster.write, query_downsample_gather at 1 min over the whole range
   against numpy with no partial answer, a repeat, then split_region
   and the same query, byte-equal.
18. failover: the JAX package's bench config 20 and config 21 drills
   (suite.py run_config20, run_config21) at their own parameters on the
   card: 200,000 fixture rows over 50 hosts, Poisson dashboards (/query,
   1 h at 5 min, 5/s) and single-sample /writes (10/s) over a 12 s leg,
   the primary killed at 6 s (listener gone, tables aborted with no
   final flush), a 2 s lease TTL, FaultInjectingStore(seed 20 or 21) at
   20 ms.  Config 20 promotes through promote() under the harness;
   config 21 lets a StandbyMonitor elect itself.  Per drill failover_ms,
   p99 and status codes per phase, and for 21 the election attempts,
   outcome and its failover bound; acked_write_loss must be 0 in both,
   21 must meet its bound, and the card's live bytes must be back
   within 16 MiB after each drill.
19. meshes (mesh_phases), BASELINE config 1 at 10M rows again on one
   store, HORAEDB_FUSED_AGG=0 (the control takes the parts route the
   meshes replace): mesh — [scan.mesh] at 1 x 1 and at 4 x 2 (eight
   logical slots on cuda:0), host decode, per bucket (1 min, 1 h) a
   true-cold query and 5 cached ones (the PartsMemo emptied before each,
   so the rounds run), in turns with the single-device control: grids
   byte-equal to it and to numpy (sum, avg rtol 1e-5), per query the
   rounds, slot fill, padding rows, fallbacks (mesh_error 0), launches
   (bucket_window_partials above 0), d2h bytes and walls; mesh_topk —
   top 10 by max and by sum on the 4 x 2 mesh, served device-scored,
   equal to the single-device query_topk; mesh_decode — the mesh legs
   with [scan.decode] mode = "device" against the single-device device
   decode (kway_merge_perm launches above 0, no decode fallback);
   segment_mesh — [scan] mesh_devices = 4 over four entries of cuda:0
   under the device_sort merge layout (sharded_merge_dedup, then
   sharded_remap_partials rounds), byte-equal to the control;
   multihost — a one-process NCCL group's global downsample over the
   first segment, byte-equal to the single-device answer.
20. bench: `python -m horaedb_tpu_torch.bench` (the bench.py twin) in
   a subprocess at bench.py's defaults, 10,000,000 rows and 20 iters:
   BENCH_CONFIG=0, the kernel microbench (time_bucket_aggregate over the
   rows as one batch, bucket_window_partials), and 1, the end-to-end
   headline (config 1 on the fused route: true-cold queries, 20 cached
   and 24 varied-range ones, a paired numpy baseline).  Each prints its
   JSON line after its own numpy checks; the line must say backend
   cuda, no fallback and this card's name and power limit; the
   headline's cold query no replay and > 0 B up, every cached query a
   replay with 0 B up; each line's kernel launches (counted in its
   process) must hold its route's kernel; the microbench's p50 must not
   fall below the device time of its call at the same inputs.
21. suite: the bench suite's configs 2-10 (horaedb_tpu_torch/bench/
   suite.py, the JAX package's suite.py:115-1475) at the CLI's defaults,
   2,000,000 rows and 10 iters, each
   checking itself against numpy, each result line printed with its
   kernel launches counted from 0 around it (every config but 6 and 8
   must launch one); configs 2, 8 and 9 write their disks under
   .wal_smoke_* directories beside this script (removed after).
22. s3: BASELINE config 1 at --rows through a MetricEngine over the
   port's S3ObjectStore against FakeS3, an in-process SigV4-verifying
   S3 endpoint on 127.0.0.1 (its own thread and loop): ingest, then a
   second engine with the default StorageConfig, one true-cold avg at
   1 min over the whole segments (device decode; bucket_window_partials
   and kway_merge_perm launched, counted from 0 around it; no replay,
   > 0 B up) and 5 repeats, every grid byte for byte the in-memory
   parts leg's device-decode grid of the same query and against numpy;
   GETs and bytes as the fake counts them.  Then `python -m
   horaedb_tpu_torch.server` on a kind = "S3Like" config pointed at the
   fake answers one /write and /query and exits 0 on SIGTERM.
23. merge_dedup: merge_dedup_last (torch code) at the segment mesh's
   shape, byte-equal to its CPU run, timed beside its bytes bound.
24. a JSON line of per-kernel numbers (with `wal_launches`,
   `config4_launches`, the rollup, chunked, scanagent, server, cluster,
   failover, mesh, bench, suite and s3 cells' launches beside
   `launches`, and the partials entry's time at the chunked shape),
   every phase's seconds, the total seconds, the card line again, and
   the last line {"ok": true, "device": {...}}.

Needs one CUDA card; a missing card is a failure, never a CPU run.
`--cards N` (N cards) runs only the build and the mesh phases, their
slots cycling over the N cards (cross-card copies in the combine and
the score state), and the multi-process tier as N NCCL processes of
tests/torch_multihost_worker.py, one card each.
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


def card_line(every: bool = False) -> str:
    """`nvidia-smi`'s name and power limit of the first card (of every
    card, one per line, with `every`)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    lines = out.stdout.strip().splitlines()
    return "\n".join(lines) if every else lines[0]


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


def kernel_phase(ba, fused, parent=None) -> list:
    """Both entries against their plain versions on the card, then their
    times at the main path's round shape; with `parent` (another
    checkout's bucket_agg module), that kernel's two entries and this
    one's at the same round in turns: parent, this, this, parent."""
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
    # with `parent`: each entry, avg set and all aggregates, in turns
    turns = {}
    if parent is not None:
        n_max = int(nv.max())
        acc_all = fused.fused_acc_init(num_groups=G, num_buckets=m_total,
                                       which=ALL_AGGS, device=dev)

        def entry_ms(mod, wh):
            a = acc if wh == which else acc_all
            return {
                "bucket_round_accumulate": device_ms([
                    lambda c=c: mod._launch_round(
                        a, *c, remap_d, shift_d, lo_d, m_total, BMS,
                        num_groups=G, width=width, which=wh,
                        n_valid=nv_d, lo_host=lo, n_valid_host=nv,
                        ordered=True) for c in copies]),
                "bucket_window_partials": device_ms([
                    lambda c=c: mod._launch_partials(
                        *c, remap_d, shift_d, lo_d, m_total, BMS,
                        num_groups=G, width=width, which=wh,
                        n_valid=n_max, ordered=True) for c in copies])}

        for who in ("parent", "this", "this", "parent"):
            for key, wh in (("avg", which), ("all_aggs", ALL_AGGS)):
                t = entry_ms(parent if who == "parent" else ba, wh)
                for name, ms in t.items():
                    turns.setdefault(name, {}).setdefault(
                        key, {"this": [], "parent": []})[who].append(ms)
        for name, t in turns.items():
            for key, v in t.items():
                log(f"kernel:   {name} ({key}) at the main-path round, in "
                    f"turns: this {v['this']!r} ms, parent {v['parent']!r} "
                    f"ms")

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
             random_input_call_ms=p_rand_call_ms,
             **({"turns_ms": turns["bucket_window_partials"]}
                if turns else {})),
        dict(common, name="bucket_round_accumulate", launches=0,
             also_replaces="horaedb_tpu/storage/read.py:4501",
             max_abs_err=worst["bucket_round_accumulate"], ms=r_ms,
             plain_ms=r_plain_ms, bound_ms=r_bound, library_ms=r_lib_ms,
             ms_all_aggs=r_all_ms, ms_atomic_sum=r_atomic_ms,
             call_ms=r_call_ms,
             slice_route_ms=slice_ms,
             **({"turns_ms": turns["bucket_round_accumulate"]}
                if turns else {})),
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


# Queue C 18 on the card: the legs of nan_phase and the bits the JAX
# package's engines give for them on the CPU (tests/test_torch_nan_sign.py
# holds the port to the same bits there).  Rows are (ms after T0, value),
# a value "+" / "-" the float64 NaN 0x7ff8000000000000 / its negative.
# Expected: per route kind, the float32 bits of the first cell's sum, min
# and max; the cell at 70 min (1 h legs) reads 2.0 in all three.
_P, _N = "0x7fc00000", "0xffc00000"
NAN_LEGS = (
    ("+NaN", ((0, 1.0), (1000, "+"), (2000, 3.0), (4_200_000, 2.0)), False,
     {"fused": (_P, _P, _P), "parts": (_P, _P, _P)}),
    ("-NaN", ((0, 1.0), (1000, "-"), (2000, 3.0), (4_200_000, 2.0)), False,
     {"fused": (_N, _N, _N), "parts": (_N, _N, _N)}),
    ("both signs in one cell",
     ((0, 1.0), (1000, "+"), (2000, "-"), (4_200_000, 2.0)), False,
     {"fused": (_N, _P, _N), "parts": (_N, _P, _N)}),
    # two 2 h segments under one 1-day bucket: the fused accumulator keeps
    # the earlier NaN's sum; the parts route's numpy folds (the
    # reference's own, 1 x 1 grids) make min and max the positive NaN
    ("both signs across two segments",
     ((0, 1.0), (1000, "+"), (7_201_000, "-"), (11_400_000, 2.0)), True,
     {"fused": (_P, _P, _N), "parts": (_N, _P, _P)}),
)


def nan_kernel_case(ba, fused) -> dict:
    """Both kernel entries against their plain versions on a NaN-sign
    round, byte for byte in every field: cells with one NaN of each sign,
    both signs in either order, payload NaNs (0x7fc00001, 0xffc00001 and
    two payloads of one sign), +inf with -inf, a NaN with an infinity,
    and one cell whose NaNs of both signs come from two windows (one
    round cell).  Small integer values keep every finite sum exact in
    any order.  Returns the round accumulator's raw NaN images of the
    single-sign cells beside the decoded grids' bits."""
    import numpy as np
    import torch

    dev = torch.device("cuda")
    W, cap, G, width = 2, 256, 12, 1
    ts = np.zeros((W, cap), np.int32)
    gid = np.full((W, cap), -1, np.int32)
    vals = np.zeros((W, cap), np.float32)
    nan = {"+": 0x7FC00000, "-": 0xFFC00000, "+q": 0x7FC00001,
           "-q": 0xFFC00001, "+q2": 0x7FC00002}
    cells = [  # (group, [(window, value)])
        (0, [(0, 1.0), (0, "+"), (0, 3.0)]),
        (1, [(0, 1.0), (0, "-"), (0, 3.0)]),
        (2, [(0, "+"), (0, 2.0), (0, "-")]),
        (3, [(0, "-"), (0, "+"), (0, 2.0)]),
        (4, [(0, "+q"), (0, 5.0)]),
        (5, [(0, "-q"), (0, 5.0)]),
        (6, [(0, "+q"), (0, "+q2"), (0, "+")]),
        (7, [(0, np.inf), (0, 2.0), (0, -np.inf)]),
        (8, [(0, np.inf), (0, "-"), (0, 1.0)]),
        (9, [(0, 4.0), (0, "+"), (1, "-"), (1, 6.0)]),
        (10, [(0, 7.0), (1, 8.0)]),
    ]
    fill = [0, 0]
    for g, rows in cells:
        for w, v in rows:
            r = fill[w]
            fill[w] += 1
            ts[w, r], gid[w, r] = r, g
            vals[w, r] = (_bits(nan[v]) if isinstance(v, str) else v)
    nv = np.array(fill, np.int32)

    def d(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    args = [d(ts), d(gid), d(vals), None, None, d(np.zeros(W, np.int32)),
            1, BMS]
    kw = dict(num_groups=G, width=width, which=ALL_AGGS)
    out = {}

    def same(got, ref, what):
        for f in ref:
            a, b = got[f].cpu(), ref[f].cpu()
            if a.dtype != b.dtype or a.shape != b.shape or \
                    a.numpy().tobytes() != b.numpy().tobytes():
                raise AssertionError(f"nan kernel case: {what} field {f} "
                                     f"not byte-equal to plain")

    n = int(nv.max())
    p_ref = ba.bucket_window_partials_plain(*args, n_valid=n, **kw)
    p_got = ba.bucket_window_partials(*args, n_valid=n, **kw)
    torch.cuda.synchronize()
    same(p_got, p_ref, "partials")
    acc_p = fused.fused_acc_init(num_groups=G, num_buckets=1,
                                 which=ALL_AGGS, device=dev)
    acc_k = fused.fused_acc_init(num_groups=G, num_buckets=1,
                                 which=ALL_AGGS, device=dev)
    ba.bucket_round_accumulate_plain(acc_p, *args, n_valid=d(nv),
                                     lo_host=np.zeros(W, np.int32), **kw)
    ba.bucket_round_accumulate(acc_k, *args, n_valid=d(nv),
                               lo_host=np.zeros(W, np.int32),
                               n_valid_host=nv, **kw)
    torch.cuda.synchronize()
    same(acc_k, acc_p, "round")

    def hexes(t):
        return [hex(int(x)) for x in t.cpu().numpy().reshape(-1)
                .view(np.uint32)]

    fin = fused.fused_finalize(acc_k, ALL_AGGS)
    out["round_raw_images"] = {f: hexes(acc_k[f][:6, 0]) for f in
                               ("min", "max")}
    out["round_final"] = {f: hexes(fin[f][:, 0]) for f in
                          ("sum", "min", "max")}
    out["partials"] = {f: hexes(p_got[f][0, :, 0]) for f in
                       ("sum", "min", "max")}
    want_images = {"min": ["0xffc00000", "0xff800001", "0xffc00000",
                           "0xffc00000", "0xffc00001", "0xff800002"],
                   "max": ["0x7f800001", "0x7fc00000", "0x7fc00000",
                           "0x7fc00000", "0x7f800002", "0x7fc00001"]}
    if out["round_raw_images"] != want_images:
        raise AssertionError(f"nan kernel case: raw images "
                             f"{out['round_raw_images']}, want {want_images}")
    want_final = {"min": [_P, _N, _P, _P, "0x7fc00001", "0xffc00001",
                          "0x7fc00002", "0xff800000", "0xffc00000", _P,
                          "0x40e00000", "0x7f800000"],
                  "max": [_P, _N, _N, _N, "0x7fc00001", "0xffc00001",
                          "0x7fc00002", "0x7f800000", "0xffc00000", _N,
                          "0x41000000", "0xff800000"],
                  "sum": [_P, _N, _N, _P, "0x7fc00001", "0xffc00001",
                          _P, _N, _N, _P, "0x41700000", "0x0"]}
    if out["round_final"] != want_final:
        raise AssertionError(f"nan kernel case: round grids "
                             f"{out['round_final']}, want {want_final}")
    log(f"nan: both entries byte-equal to plain on the NaN-sign case; the "
        f"round's raw images {out['round_raw_images']}; decoded "
        f"{out['round_final']}")
    return out


async def nan_phase(ba, mg, fused) -> dict:
    """Queue C 18 on the card: each leg of NAN_LEGS on the fused route,
    on the parts route with device decode and on the parts route with
    host decode, sum, min and max at 1 h over one 2 h segment (1 day over
    two for the cross-segment leg).  Each grid's first cell must hold the
    JAX package's bits (NAN_LEGS), the cell at 70 min 2.0; each leg must
    have launched its route's kernel.  Then nan_kernel_case: both
    entries byte-equal to their plain versions on a NaN-sign round, and
    the kernel's raw NaN images."""
    import numpy as np
    import pyarrow as pa
    import torch

    from horaedb_tpu_torch.metric_engine import MetricEngine
    from horaedb_tpu_torch.objstore import MemoryObjectStore
    from horaedb_tpu_torch.storage.config import StorageConfig, from_dict
    from horaedb_tpu_torch.storage.types import TimeRange

    seg, t0, hour = 2 * 3_600_000, 1_699_999_200_000, 3_600_000
    sample = {"+": float(np.array([0x7FF8000000000000], np.uint64)
                         .view(np.float64)[0]),
              "-": float(np.array([0xFFF8000000000000], np.uint64)
                         .view(np.float64)[0])}
    routes = (("fused", "1", "auto", "bucket_round_accumulate", "fused"),
              ("parts, device decode", "0", "auto",
               "bucket_window_partials", "parts"),
              ("parts, host decode", "0", "host", "bucket_window_partials",
               "parts"))
    out: dict = {}
    old = os.environ.get("HORAEDB_FUSED_AGG")
    try:
        for (leg, rows, two_segs, want), (route, fused_env, mode, kernel,
                                          kind) in (
                (lg, r) for lg in NAN_LEGS for r in routes):
            name = f"{leg} [{route}]"
            batch = pa.record_batch({
                "host": pa.array(["a"] * len(rows)),
                "timestamp": pa.array([t0 + t for t, _ in rows]),
                "value": pa.array([sample.get(v, v) if isinstance(v, str)
                                   else v for _, v in rows])})
            span, bucket = (2 * seg, 24 * hour) if two_segs else (seg, hour)
            os.environ["HORAEDB_FUSED_AGG"] = fused_env
            e = await MetricEngine.open(
                "nan", MemoryObjectStore(), segment_ms=seg,
                config=from_dict(StorageConfig, {
                    "scheduler": {"schedule_interval": "1h"},
                    "scan": {"decode": {"mode": mode}}}))
            try:
                await e.write_arrow("cpu", ["host"], batch)
                reset_all(ba, mg)
                res = await e.query_downsample(
                    "cpu", [], TimeRange.new(t0, t0 + span), bucket,
                    aggs=("sum", "min", "max"))
                torch.cuda.synchronize()
                n = launches(ba, mg)
            finally:
                await e.close()
            grids = host_grids(res)
            bits = {k: [hex(int(b)) for b in grids[k].astype(np.float32)
                        .view(np.uint32).reshape(-1)]
                    for k in ("sum", "min", "max")}
            if not n[kernel]:
                raise AssertionError(f"nan [{name}]: {kernel} not launched: "
                                     f"{n}")
            for k, w in zip(("sum", "min", "max"), want[kind]):
                expect = [w] if two_segs else [w, "0x40000000"]
                if bits[k] != expect:
                    raise AssertionError(f"nan [{name}]: {k} bits {bits[k]}, "
                                         f"want {expect}")
            out[name] = {"bits": bits, "dtype": str(grids["min"].dtype),
                         "launches": n}
            log(f"nan [{name}]: sum {bits['sum']}, min {bits['min']}, max "
                f"{bits['max']} ({grids['min'].dtype}); launches {n}")
    finally:
        if old is None:
            os.environ.pop("HORAEDB_FUSED_AGG", None)
        else:
            os.environ["HORAEDB_FUSED_AGG"] = old
    out["numpy"] = np.__version__
    out["kernel_case"] = nan_kernel_case(ba, fused)
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
        cold = turns["device"][0]["cold"]
        return {"cold_1min": {"tsids": cold["tsids"],
                              "aggs": host_grids(cold)},
                "launches": first["bucket_window_partials"],
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


STAGE_SECONDS = 'scan_stage_seconds{stage="%s"}'


def series_label(key: str) -> str:
    """The label value of a one-label series key (`name{k="v"}`), or the
    bare name of an unlabelled one."""
    return key.split('"')[1] if "{" in key else key


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
        f"time and host RAM of the check; the run's time limit)")
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


def suite_config(ba, mg, config: int, rows: int, iters: int,
                 what: str) -> tuple:
    """One bench suite runner on the card, its launches counted from 0
    around it: (its result line, its `detail`; configs 2-10 have none).
    Every config that queries the engine or aggregates on the card (all
    but 6, the manifest codec, and 8, durable ingest) must launch a hand
    kernel, and each reads as a card number (config 6 labels itself
    host work)."""
    from horaedb_tpu_torch.bench import suite

    here = os.path.dirname(os.path.abspath(__file__))
    kw = {"scratch_dir": here} if config in suite.ON_DISK else {}
    detail: dict = {}
    if config >= 11:
        kw["detail"] = detail
    reset_all(ba, mg)
    t0 = time.perf_counter()
    result = suite.RUNNERS[config](rows, iters, **kw)
    result["wall_s"] = time.perf_counter() - t0
    result["launches"] = launches(ba, mg)
    for k, v in suite.provenance("cuda").items():
        result.setdefault(k, v)
    log(f"{what}: config {config} in {result['wall_s']!r} s: "
        f"{json.dumps(result)}")
    if detail:
        log(f"{what}: config {config} detail: "
            f"{json.dumps(detail, default=str)}")
    if result["backend"] != ("host" if config == 6 else "cuda") \
            or result["fallback"]:
        raise AssertionError(f"{what}: config {config} provenance "
                             f"{result['backend']}/{result['fallback']}")
    if config not in (6, 8) and not any(result["launches"].values()):
        raise AssertionError(f"{what}: config {config} launched no kernel")
    return result, detail


def suite_own_process(config: int, rows: int, iters: int) -> tuple:
    """One bench suite config through `python -m horaedb_tpu_torch.bench`
    in a subprocess: its result line, with the kernels' launches counted
    in its process from 0 (no `detail`)."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, BENCH_CONFIG=str(config), BENCH_ROWS=str(rows),
               BENCH_ITERS=str(iters))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "horaedb_tpu_torch.bench"],
                          cwd=here, env=env, capture_output=True, text=True,
                          timeout=900)
    if proc.returncode != 0:
        raise AssertionError(f"suite: config {config} exited "
                             f"{proc.returncode}: {proc.stderr[-3000:]}")
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    result["wall_s"] = time.perf_counter() - t0
    log(f"suite: config {config} in its own process in "
        f"{result['wall_s']!r} s: {json.dumps(result)}")
    if result["backend"] != "cuda" or result["fallback"] \
            or result["card"] != card_line():
        raise AssertionError(f"suite: config {config} did not run on the "
                             f"card: {result}")
    if not any(result["launches"].values()):
        raise AssertionError(f"suite: config {config} launched no kernel")
    return result, {}


def rollup_phase(ba, mg, rows: int = 10_000_000, iters: int = 10) -> dict:
    """The bench suite's config 11 (suite.run_config11) at 10,000,000
    rows: 100 hosts, 10 s scrape, 139 2 h segments, values from seed 11,
    a standing (cpu, value) rollup at tiers 1m and 1h over the seeded
    25 ms store.  The runner holds its own checks (the backfill rolls
    every segment, 0 data-plane GETs on the served mix, served == a
    parts-route recompute byte for byte and the default raw route within
    rtol 1e-5, numpy, the served top-k, the late write's one-segment
    tail and re-roll) and, on the card, its launch gates; here the raw
    legs must take the fused route and the backfill's multi-SST
    segments must run kway_merge_perm."""
    result, detail = suite_config(ba, mg, 11, rows, iters, "rollup")
    if set(detail["raw_routes"].values()) != {"fused"}:
        raise AssertionError(f"rollup: the raw queries took "
                             f"{detail['raw_routes']}, not the fused route")
    if not detail["backfill_launches"]["kway_merge_perm"]:
        raise AssertionError("rollup: the backfill's multi-SST segments "
                             "did not run kway_merge_perm")
    if any(detail["rollup_leg_launches"].values()):
        raise AssertionError(f"rollup: the served mix launched "
                             f"{detail['rollup_leg_launches']}")
    log(f"rollup: served mix p50 {result['rollup_mix_p50_ms']!r} ms against "
        f"raw cold {result['raw_cold_mix_p50_ms']!r} ms: "
        f"{result['mix_speedup_p50']!r}x against the reference's 5x bar "
        f"({'met' if result['mix_speedup_p50'] >= 5 else 'not met'}); the "
        f"reference's byte check of served against raw would "
        f"{'hold' if detail['reference_cross_check_holds'] else 'fail'} "
        f"(raw routes {detail['raw_routes']}) ({card_line()})")
    return {"result": result, **detail}


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


def scanagent_phase(ba, mg, rows: int = 10_000_000, iters: int = 5) -> dict:
    """The bench suite's config 17 (suite.run_config17) at 10,000,000
    rows over the seeded 25 ms store, 2 true-cold reps a leg: off (the
    default route, fused at 4 x rows), off on the parts route (the
    byte-for-byte control), agent (an AgentService on this card with
    device decode), agent_killed and the disk rung.  The runner holds
    the byte and rtol checks, numpy, the stitched trace and, on the
    card, the agent's launch gates; here the memory ledger taken with
    the agent's state resident must report live CUDA bytes."""
    result, detail = suite_config(ba, mg, 17, rows, iters, "scanagent")
    led = detail["ledger_after_agent_leg"]
    devices = led["devices"]
    log(f"ledger after the agent leg (config 17): rss {led['rss_bytes']:,} "
        f"B, attributed {led['attributed_bytes']:,} B, unattributed "
        f"{led['unattributed_bytes']:,} B; per kind "
        f"{json.dumps(led['accounts'])}; device {json.dumps(devices)} "
        f"({card_line()})")
    if not devices or not all(
            0 < d["bytes_in_use"] <= d["peak_bytes_in_use"] for d in devices):
        raise AssertionError(f"ledger: no live CUDA device bytes reported "
                             f"({devices})")
    log(f"scanagent: coordinator bytes off/agent "
        f"{result['bytes_reduction_x']!r}x against the reference's 5x bar "
        f"({'met' if result['bar_bytes_reduction_met'] else 'not met'}); "
        f"p50 off {result['off']['p50_ms']!r} ms ({detail['off_route']}), "
        f"off_parts {detail['off_parts']['p50_ms']!r} ms, agent "
        f"{result['agent']['p50_ms']!r} ms; the reference's byte check "
        f"against the off leg would "
        f"{'hold' if detail['reference_check_holds'] else 'fail'}")
    return {"result": result, **detail}


# ---- the server, the cluster and the failover drills -----------------------


def free_port() -> int:
    """A port on 127.0.0.1 that nothing listens on right now."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


async def start_site(state):
    """The port's server in process: build_app on an AppRunner at
    127.0.0.1:0.  Returns (runner, base url)."""
    from aiohttp import web

    from horaedb_tpu_torch.server.main import build_app

    runner = web.AppRunner(build_app(state))
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    return runner, f"http://127.0.0.1:{runner.addresses[0][1]}"


def json_grids(body: dict) -> dict:
    """A downsample body's grids as float64 arrays (null -> NaN)."""
    import numpy as np

    return {k: np.array(v, dtype=np.float64).reshape(
        len(body["tsids"]), body["num_buckets"])
        for k, v in body["aggs"].items()}


def wire_equals_direct(body: dict, direct: dict, what: str) -> None:
    """A grid that came back over HTTP equals the same engine's direct
    call byte for byte after the JSON round trip: tsids as strings,
    NaN as null, every other cell's float64 bytes equal."""
    import numpy as np

    if body["tsids"] != [str(t) for t in direct["tsids"]]:
        raise AssertionError(f"{what}: tsids differ from the direct call")
    if body["num_buckets"] != direct["num_buckets"]:
        raise AssertionError(f"{what}: num_buckets differs")
    got, want = json_grids(body), host_grids(direct)
    if sorted(got) != sorted(want):
        raise AssertionError(f"{what}: grids {sorted(got)} != "
                             f"{sorted(want)}")
    for k, w in want.items():
        w = w.astype(np.float64)
        nan = np.isnan(w)
        if not np.array_equal(np.isnan(got[k]), nan) or \
                got[k][~nan].tobytes() != w[~nan].tobytes():
            raise AssertionError(f"{what}: grid {k} differs in its bytes "
                                 f"after the JSON round trip")


def seam_launches(body: dict) -> dict:
    """{seam: launches} of a GET /debug/device body."""
    return {f["fn"]: f["launches"] for f in body["fns"]}


async def profiler_turns(e, rng, turns: int = 10) -> dict:
    """The cached fused query (a replay) with the device profiler on
    and off, in turns: the p50 of each, the explicit device syncs each
    made (torch.cuda.synchronize and Event/Stream synchronize, counted
    by wrappers; the profiler must add none), and the profiler's own
    device time of the seams it wrapped."""
    import torch

    from horaedb_tpu_torch.common import deviceprof as dp

    syncs = {"n": 0}
    originals = (torch.cuda.synchronize, torch.cuda.Event.synchronize,
                 torch.cuda.Stream.synchronize)

    def counting(fn):
        def wrapper(*a, **kw):
            syncs["n"] += 1
            return fn(*a, **kw)
        return wrapper

    was = dp.profiler.enabled
    ms = {True: [], False: []}
    sync_n = {True: [], False: []}
    await e.query_downsample("cpu", [], rng, BMS)  # warm: a replay next
    torch.cuda.synchronize()
    try:
        torch.cuda.synchronize = counting(originals[0])
        torch.cuda.Event.synchronize = counting(originals[1])
        torch.cuda.Stream.synchronize = counting(originals[2])
        for i in range(2 * turns):
            on = i % 2 == 0
            dp.profiler.configure(enabled=on)
            syncs["n"] = 0
            t0 = time.perf_counter()
            await e.query_downsample("cpu", [], rng, BMS)
            ms[on].append((time.perf_counter() - t0) * 1e3)
            sync_n[on].append(syncs["n"])
    finally:
        (torch.cuda.synchronize, torch.cuda.Event.synchronize,
         torch.cuda.Stream.synchronize) = originals
        dp.profiler.configure(enabled=was)
    if sorted(set(sync_n[True])) != sorted(set(sync_n[False])):
        raise AssertionError(f"deviceprof: the profiler changed the "
                             f"cached query's syncs: on {sync_n[True]}, "
                             f"off {sync_n[False]}")
    snap = dp.profiler.snapshot()
    exec_ms = {f["fn"]: f["exec_ms"] for f in snap["fns"] if f["exec_ms"]}
    out = {"on_p50_ms": statistics.median(ms[True]),
           "off_p50_ms": statistics.median(ms[False]),
           "on_ms": ms[True], "off_ms": ms[False],
           "syncs_per_query": sync_n[True][0], "exec_ms": exec_ms,
           "events": snap["events"]}
    log(f"deviceprof: cached fused query p50 {out['on_p50_ms']!r} ms with "
        f"the profiler on, {out['off_p50_ms']!r} ms off ({turns} turns "
        f"each, alternating); explicit syncs per query "
        f"{out['syncs_per_query']} both ways; seam device ms so far "
        f"{exec_ms}; events {snap['events']}")
    return out


def check_config1(grids: dict, want: dict, order, what: str) -> None:
    """count, min, max and last equal numpy; sum and avg within rtol
    1e-5 (rows in tsid order)."""
    import numpy as np

    for k in ("count", "min", "max", "last"):
        if not np.array_equal(np.asarray(grids[k], dtype=np.float64),
                              want[k][order], equal_nan=True):
            raise AssertionError(f"{what}: {k} differs from numpy")
    for k in ("sum", "avg"):
        np.testing.assert_allclose(np.asarray(grids[k], dtype=np.float64),
                                   want[k][order], rtol=1e-5,
                                   err_msg=f"{what}: {k}")


async def server_cli_leg(text: str, port: int, root: str, T0: int,
                         tag: str) -> dict:
    """`python -m horaedb_tpu_torch.server` in a subprocess from the
    config `text` (written under `root`), listening on `port`: GET /
    until it answers, one /write, a /query that returns the sample, and
    SIGTERM, after which it must exit 0 with its engine on the card."""
    import signal

    import aiohttp

    here = os.path.dirname(os.path.abspath(__file__))
    out: dict = {}
    toml = os.path.join(root, "server.toml")
    with open(toml, "w") as f:
        f.write(text)
    session = aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=600))

    async def call(method, base, path, **kw):
        async with session.request(method, base + path, **kw) as r:
            body = await r.read()
            if r.status != 200:
                raise AssertionError(f"{path}: {r.status} {body[:300]!r}")
            return body

    t0 = time.perf_counter()
    cli_log = open(os.path.join(root, "cli.log"), "w+")
    proc = subprocess.Popen(
        [sys.executable, "-m", "horaedb_tpu_torch.server", "--config",
         toml], cwd=here, stdout=cli_log, stderr=subprocess.STDOUT)
    base = f"http://127.0.0.1:{port}"
    try:
        for _ in range(600):
            if proc.poll() is not None:
                cli_log.seek(0)
                raise AssertionError(
                    f"{tag}: server CLI exited {proc.returncode}: "
                    f"{cli_log.read()[-2000:]}")
            try:
                await call("GET", base, "/")
                break
            except (aiohttp.ClientError, AssertionError):
                await asyncio.sleep(0.2)
        else:
            raise AssertionError(f"{tag}: server CLI never answered GET /")
        out["cli_start_s"] = time.perf_counter() - t0
        await call("POST", base, "/write", json={"samples": [
            {"name": "cli", "labels": {"host": "a"},
             "timestamp": T0, "value": 42.5}]})
        body = json.loads(await call("POST", base, "/query", json={
            "metric": "cli", "filters": {"host": "a"}, "start": T0,
            "end": T0 + 1000}))
        if body["values"] != [42.5]:
            raise AssertionError(f"{tag}: server CLI: /query returned {body}")
    finally:
        await session.close()
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            raise AssertionError(f"{tag}: server CLI ignored SIGTERM")
    cli_log.seek(0)
    log_tail = cli_log.read()
    cli_log.close()
    if rc != 0:
        raise AssertionError(f"{tag}: server CLI exited {rc}: "
                             f"{log_tail[-2000:]}")
    if "device cuda" not in log_tail:
        raise AssertionError(f"{tag}: server CLI: the engine did not open "
                             "on the card")
    out["cli_rc"] = rc
    log(f"{tag}: CLI started in {out['cli_start_s']!r} s, wrote and read "
        f"back one sample, exited {rc} on SIGTERM")
    return out


# the server phase's /query calls a node: one true cold and repeats.  Cut
# from 6: each call returns ~196 MB of JSON at 10M rows, and the run's
# time goes to the bench suite's configs 11-23
SERVER_REPS = 2


async def server_phase(ba, mg, rows: int) -> dict:
    """BASELINE config 1, unchanged, over HTTP: the port's server in
    process (ServerState + build_app on an AppRunner) from
    docs/example.toml loaded by the port's load_config, its data_dir and
    WAL dir moved into a scratch directory beside this script.  Ingest
    through POST /write_arrow in 1M-row batches; then two nodes over the
    same store, in turns: the example's own scan budget (parts route:
    device decode, kway_merge_perm, bucket_window_partials) and the scan
    cache at 4 x rows (fused route and the replay).  Per node: POST
    /query at 1 min over the whole range true cold and SERVER_REPS - 1
    repeats, each beside the direct query_downsample in turns; /query_topk,
    /query_multi, /query_arrow, /label_values, /stats, /metrics and
    /admin/flush.  Then the CLI: `python -m horaedb_tpu_torch.server`
    from a copy of the config, one /write, a /query that returns it, and
    SIGTERM, after which it must exit 0."""
    import copy
    import shutil

    import aiohttp
    import numpy as np
    import pyarrow as pa
    import torch

    from horaedb_tpu_torch.common.ipc import (downsample_from_arrow,
                                              serialize_stream)
    from horaedb_tpu_torch.metric_engine import Label, MetricEngine
    from horaedb_tpu_torch.metric_engine.types import tsid_of
    from horaedb_tpu_torch.server.config import load_config
    from horaedb_tpu_torch.server.main import ServerState, _build_store
    from horaedb_tpu_torch.storage.types import TimeRange

    here = os.path.dirname(os.path.abspath(__file__))
    log(f"server: {SERVER_REPS} /query calls a node, one true cold and "
        f"{SERVER_REPS - 1} repeats (cut from 6)")
    d = config1_rows(rows)
    hosts, interval, segment_ms = d["hosts"], d["interval"], d["segment_ms"]
    per_host, T0, n, names = d["per_host"], d["T0"], d["n"], d["names"]
    ts, host_id, vals = d["ts"], d["host_id"], d["vals"]
    nb = -(-per_host * interval // BMS)
    full = (T0, T0 + nb * BMS)
    root = scratch_dir("server")
    out: dict = {"rows": n, "buckets": nb}
    runners = []
    engines = []
    session = aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=600))
    try:
        cfg = load_config(os.path.join(here, "docs", "example.toml"))
        cfg.metric_engine.object_store.data_dir = os.path.join(root, "data")
        cfg.wal.dir = os.path.join(root, "wal")
        store = _build_store(cfg)

        async def node(scan_overrides: dict):
            ncfg = copy.deepcopy(cfg)
            for k, v in scan_overrides.items():
                setattr(ncfg.metric_engine.time_merge_storage.scan, k, v)
            e = await MetricEngine.open(
                "metrics", store,
                segment_ms=ncfg.metric_engine.segment_duration.millis,
                config=ncfg.metric_engine.time_merge_storage,
                wal_config=ncfg.wal, rollup_config=ncfg.rollup,
                meta_config=ncfg.meta, scanagent_config=ncfg.scanagent)
            engines.append(e)
            state = ServerState(e, ncfg)
            runner, base = await start_site(state)
            runners.append(runner)
            return e, base

        async def post(base, path, **kw):
            async with session.post(base + path, **kw) as r:
                body = await r.read()
                if r.status != 200:
                    raise AssertionError(f"{path}: {r.status} "
                                         f"{body[:300]!r}")
                return body

        async def get(base, path, **kw):
            async with session.get(base + path, **kw) as r:
                body = await r.read()
                if r.status != 200:
                    raise AssertionError(f"{path}: {r.status} "
                                         f"{body[:300]!r}")
                return body

        e_parts, base_parts = await node({})
        # ingest over HTTP: Arrow IPC bodies of 1M rows
        t0 = time.perf_counter()
        chunk = max(1, 1_000_000 // hosts) * hosts
        posted = 0
        for lo in range(0, n, chunk):
            hi = min(n, lo + chunk)
            body = serialize_stream(host_batch(names, host_id[lo:hi],
                                               ts[lo:hi], vals[lo:hi]))
            got = json.loads(await post(
                base_parts, "/write_arrow", params={"metric": "cpu",
                                                    "tags": "host"},
                data=body))
            posted += got["written"]
        out["ingest_s"] = time.perf_counter() - t0
        if posted != n:
            raise AssertionError(f"server: /write_arrow wrote {posted} "
                                 f"of {n} rows")
        for t in e_parts.tables.values():
            await t.manifest.trigger_merge()
        log(f"server: ingest of {n:,} rows through POST /write_arrow in "
            f"{out['ingest_s']!r} s")
        e_fused, base_fused = await node({"cache_max_rows": 4 * n})

        tsid_of_host = np.array([tsid_of("cpu", [Label("host",
                                                       f"host_{i:03d}")])
                                 for i in range(hosts)], dtype=np.uint64)
        order = np.argsort(tsid_of_host)
        want = host_major_reference(vals.astype(np.float32), hosts,
                                    per_host, T0, interval, BMS, nb)
        q = {"metric": "cpu", "filters": {}, "start": full[0],
             "end": full[1], "bucket_ms": BMS}
        rng = TimeRange.new(*full)
        legs = {"parts": (e_parts, base_parts,
                          ("bucket_window_partials", "kway_merge_perm")),
                "fused": (e_fused, base_fused,
                          ("bucket_round_accumulate",))}
        out["legs"] = {}
        for name, (e, base, route) in legs.items():
            reader = e.tables["data"].reader
            rec: dict = {"http_ms": [], "direct_ms": [],
                         "http_launches": [], "direct_launches": []}
            cold_body = None
            # the device profiler's per-seam launches around the leg's
            # queries, from GET /debug/device
            dev0 = seam_launches(json.loads(await get(base,
                                                      "/debug/device")))
            for rep in range(SERVER_REPS):
                # each call's launches are counted from 0 around it
                # alone, so the HTTP route's count owes nothing to the
                # direct control that follows it
                if rep == 0:
                    true_cold(reader)
                reset_all(ba, mg)
                t0 = time.perf_counter()
                raw = await post(base, "/query", json=q)
                rec["http_ms"].append((time.perf_counter() - t0) * 1e3)
                rec["http_launches"].append(launches(ba, mg))
                if rep == 0:
                    cold_body = raw
                elif raw != cold_body:
                    raise AssertionError(f"server {name}: repeat {rep}'s "
                                         f"body differs from the cold one")
                if rep == 0:
                    true_cold(reader)
                reset_all(ba, mg)
                t0 = time.perf_counter()
                direct = await e.query_downsample("cpu", [], rng, BMS)
                torch.cuda.synchronize()
                rec["direct_ms"].append((time.perf_counter() - t0) * 1e3)
                rec["direct_launches"].append(launches(ba, mg))
                if rep == 0:
                    body = json.loads(cold_body)
                    wire_equals_direct(body, direct, f"server {name} /query")
                    check_config1(json_grids(body), want, order,
                                  f"server {name} /query")
                    rec["body_bytes"] = len(cold_body)
            dev1 = seam_launches(json.loads(await get(base,
                                                      "/debug/device")))
            counted = {k: sum(c[k] for c in rec["http_launches"]
                              + rec["direct_launches"])
                       for k in rec["http_launches"][0]}
            seen = {k: dev1.get(k, 0) - dev0.get(k, 0) for k in counted}
            if seen != counted:
                raise AssertionError(f"server {name}: /debug/device "
                                     f"launches {seen} differ from the "
                                     f"kernels' counters {counted}")
            rec["debug_device_launches"] = seen
            # the gate reads the true-cold HTTP /query alone
            rec["launches"] = rec["http_launches"][0]
            for k in route:
                if rec["launches"][k] < 1:
                    raise AssertionError(f"server {name}: {k} never "
                                         f"launched by the cold HTTP "
                                         f"/query on the leg's route")
            # the other query routes, each against its direct call
            topk_q = {**q, "bucket_ms": 3_600_000, "k": 10, "by": "max"}
            body = json.loads(await post(base, "/query_topk", json=topk_q))
            wire_equals_direct(body, await e.query_topk(
                "cpu", [], rng, 3_600_000, k=10, by="max"),
                f"server {name} /query_topk")
            if len(body["tsids"]) != 10:
                raise AssertionError("server: /query_topk k=10")
            body = json.loads(await post(base, "/query_multi", json={
                **q, "bucket_ms": 3_600_000, "fields": ["value"]}))
            multi = await e.query_downsample_multi(
                "cpu", [], rng, 3_600_000, fields=["value"])
            wire_equals_direct(body["value"], multi["value"],
                               f"server {name} /query_multi")
            raw = await post(base, "/query_arrow",
                             json={**q, "compression": "zstd"})
            arrow = downsample_from_arrow(pa.ipc.open_stream(raw).read_all())
            same_result_bytes(
                arrow, {**direct, "aggs": {k: v.astype(np.float64) for k, v
                                           in host_grids(direct).items()}},
                f"server {name} /query_arrow")
            vals_body = json.loads(await get(base, "/label_values", params={
                "metric": "cpu", "key": "host", "start": str(full[0]),
                "end": str(full[1])}))
            if vals_body["values"] != [f"host_{i:03d}" for i in range(hosts)]:
                raise AssertionError("server: /label_values")
            stats = json.loads(await get(base, "/stats"))
            if stats["tables"]["data"]["rows"] < n \
                    or stats["deviceprof"]["launches"] < 1:
                raise AssertionError("server: /stats")
            metrics = (await get(base, "/metrics")).decode()
            if "scan_stage_seconds" not in metrics:
                raise AssertionError("server: /metrics")
            flushed = json.loads(await post(base, "/admin/flush"))
            rec["admin_flush"] = flushed
            for k in ("http_ms", "direct_ms"):
                rec[k.replace("_ms", "_cold_ms")] = rec[k][0]
                rec[k.replace("_ms", "_cached_p50_ms")] = \
                    statistics.median(rec[k][1:])
            out["legs"][name] = rec
            log(f"server [{name}]: /query cold {rec['http_cold_ms']!r} ms, "
                f"cached p50 {rec['http_cached_p50_ms']!r} ms (body "
                f"{rec['body_bytes']:,} B); direct cold "
                f"{rec['direct_cold_ms']!r} ms, cached p50 "
                f"{rec['direct_cached_p50_ms']!r} ms; cold HTTP /query "
                f"launches {rec['launches']}, cold direct call "
                f"{rec['direct_launches'][0]}; HTTP grids byte-equal to "
                f"the direct call and to numpy; GET /debug/device launches "
                f"over the 12 calls {rec['debug_device_launches']}, equal "
                f"to the kernels' counters")
        t0 = time.perf_counter()
        out["deviceprof"] = await profiler_turns(e_fused, rng)
        log(f"phase deviceprof: {time.perf_counter() - t0!r} s")
        for r in runners:
            await r.cleanup()
        runners.clear()
        for e in engines:
            await e.close()
        engines.clear()

        # the CLI: a subprocess from a copy of the config
        port = free_port()
        with open(os.path.join(here, "docs", "example.toml")) as f:
            text = f.read()
        text = text.replace("port = 5000", f"port = {port}", 1)
        text = text.replace('data_dir = "/tmp/horaedb-tpu-data"',
                            f'data_dir = "{os.path.join(root, "cli")}"', 1)
        out.update(await server_cli_leg(text, port, root, T0, "server"))
        return out
    finally:
        await session.close()
        for r in runners:
            await r.cleanup()
        for e in engines:
            await e.close()
        shutil.rmtree(root, ignore_errors=True)


async def cluster_phase(ba, mg, rows: int) -> dict:
    """Config 1's shape at full rows over a 4-region Cluster on one
    card: regions 0-2 local, region 3's engine behind a second port
    server in process, reached through RemoteRegion.  Each region's
    share (routing_key of each host) is ingested through its own engine
    (write_arrow, or /write_arrow for the remote one), then a 10,000-
    sample tail through Cluster.write; query_downsample_gather at 1 min
    over the whole range against numpy; then split_region and the same
    query again, byte-equal."""
    import numpy as np
    import torch

    from horaedb_tpu_torch.cluster import Cluster, RemoteRegion, routing_key
    from horaedb_tpu_torch.common.time_ext import now_ms
    from horaedb_tpu_torch.metric_engine import (Label, MetricEngine,
                                                 Sample)
    from horaedb_tpu_torch.metric_engine.types import tsid_of
    from horaedb_tpu_torch.objstore import MemoryObjectStore
    from horaedb_tpu_torch.server.config import ServerConfig
    from horaedb_tpu_torch.server.main import ServerState
    from horaedb_tpu_torch.storage.types import TimeRange

    d = config1_rows(rows)
    hosts, interval, segment_ms = d["hosts"], d["interval"], d["segment_ms"]
    per_host, T0, n, names = d["per_host"], d["T0"], d["n"], d["names"]
    ts, host_id, vals = d["ts"], d["host_id"], d["vals"]
    tail_ticks = 10_000 // hosts
    tail_vals = np.random.default_rng(1).random(tail_ticks * hosts) * 100
    all_ticks = per_host + tail_ticks
    nb = -(-all_ticks * interval // BMS)
    rng = TimeRange.new(T0, T0 + nb * BMS)
    store = MemoryObjectStore()
    out: dict = {"rows": n + tail_ticks * hosts, "regions": 4}
    c = await Cluster.open("cluster", store, num_regions=4,
                           segment_ms=segment_ms, serve={0, 1, 2})
    remote_engine = await MetricEngine.open("cluster/region_3", store,
                                            segment_ms=segment_ms)
    runner = None
    try:
        runner, base = await start_site(ServerState(remote_engine,
                                                    ServerConfig()))
        c.add_remote_region(3, RemoteRegion(base, timeout_s=600.0))
        now = now_ms()
        host_region = np.array([c.routing.route_write(
            routing_key("cpu", [Label("host", f"host_{i:03d}")]), now)
            for i in range(hosts)])
        out["hosts_per_region"] = {int(r): int((host_region == r).sum())
                                   for r in range(4)}
        t0 = time.perf_counter()
        for rid in range(4):
            sel = host_region[host_id] == rid
            idx = np.flatnonzero(sel)
            chunk = 1_000_000
            for lo in range(0, len(idx), chunk):
                part = idx[lo:lo + chunk]
                await c.regions[rid].write_arrow(
                    "cpu", ["host"], host_batch(names, host_id[part],
                                                ts[part], vals[part]))
        tail = [Sample("cpu", [Label("host", f"host_{h:03d}")],
                       int(T0 + (per_host + j) * interval),
                       float(tail_vals[j * hosts + h]))
                for j in range(tail_ticks) for h in range(hosts)]
        await c.write(tail)
        out["ingest_s"] = time.perf_counter() - t0
        remote_rows = (await remote_engine.stats())["tables"]["data"]["rows"]
        log(f"cluster: {out['rows']:,} rows over regions "
            f"{out['hosts_per_region']} (hosts each), region 3 remote "
            f"({remote_rows:,} rows through /write_arrow and /write), in "
            f"{out['ingest_s']!r} s")
        if remote_rows <= 0:
            raise AssertionError("cluster: the remote region took no rows")

        tsid_of_host = np.array([tsid_of("cpu", [Label("host",
                                                       f"host_{i:03d}")])
                                 for i in range(hosts)], dtype=np.uint64)
        order = np.argsort(tsid_of_host)
        all_vals = np.concatenate([vals, tail_vals]).astype(np.float32)
        want = host_major_reference(all_vals, hosts, all_ticks, T0,
                                    interval, BMS, nb)

        async def gather(what):
            reset_all(ba, mg)
            t0 = time.perf_counter()
            res, meta = await c.query_downsample_gather("cpu", [], rng, BMS)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            if meta.partial or meta.missing_regions:
                raise AssertionError(f"cluster {what}: partial answer "
                                     f"{meta.errors}")
            if res["tsids"] != [int(t) for t in tsid_of_host[order]]:
                raise AssertionError(f"cluster {what}: tsids differ")
            check_config1(res["aggs"], want, order, f"cluster {what}")
            return res, ms, launches(ba, mg)

        first, out["gather_cold_ms"], out["launches"] = await gather("cold")
        _again, out["gather_repeat_ms"], _ = await gather("repeat")
        if sum(out["launches"].values()) < 1:
            raise AssertionError("cluster: no kernel launched")
        pivot = c.split_pivot(0)
        await c.split_region(0, pivot, 4, table_ttl_ms=30 * 24 * 3600_000)
        after, out["split_gather_ms"], out["split_launches"] = \
            await gather("after split")
        same_result_bytes(after, first, "cluster split")
        out["regions_after_split"] = sorted(c.regions)
        log(f"cluster: gather cold {out['gather_cold_ms']!r} ms, repeat "
            f"{out['gather_repeat_ms']!r} ms, launches {out['launches']}; "
            f"split region 0 at {pivot} into 4: gather "
            f"{out['split_gather_ms']!r} ms, byte-equal; no partial answer")
        return out
    finally:
        await c.close()
        if runner is not None:
            await runner.cleanup()
        await remote_engine.close()


def failover_phase(ba, mg, iters: int = 12) -> dict:
    """The bench suite's configs 20 and 21 (suite.run_config20, 21) at
    their own fixture (200,000 rows over 50 hosts) with `iters` s legs:
    the kill at mid-leg, a 2 s lease TTL, a 20 ms store.  Every acked
    write must be read back from the promoted node, config 21 must
    promote inside its bound, and after each drill every engine is
    closed or aborted and the card's live bytes are back where they
    were."""
    import gc

    import torch

    out = {}
    log(f"failover: {max(4.0, min(30.0, float(iters)))!r} s legs "
        f"(iters {iters})")
    for config in (20, 21):
        gc.collect()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        r, detail = suite_config(ba, mg, config, 200_000, iters, "failover")
        gc.collect()
        torch.cuda.synchronize()
        r["leg_launches"] = detail["launches"]
        r["cuda_allocated_before"] = before
        r["cuda_allocated_after"] = torch.cuda.memory_allocated()
        if r["acked_write_loss"] != 0:
            raise AssertionError(f"failover {config}: "
                                 f"{r['acked_write_loss']} acked writes lost")
        if r["cuda_allocated_after"] > before + (16 << 20):
            raise AssertionError(
                f"failover {config}: {r['cuda_allocated_after'] - before:,} "
                f"B of CUDA memory outlive the drill")
        if config == 21 and not r["bar_failover_bound"]:
            raise AssertionError(
                f"failover 21: {r['failover_ms']!r} ms over the bound "
                f"{r['failover_bound_ms']!r} ms")
        p99 = {k: r[k]["p99_ms"] for k in ("query_pre_kill",
                                           "query_post_kill",
                                           "write_pre_kill",
                                           "write_post_kill") if k in r}
        extra = (f"; election attempts {r['election_attempts']}, outcome "
                 f"{r['election_outcome']}, bound "
                 f"{r['failover_bound_ms']!r} ms" if config == 21 else
                 f"; lease attempts {r['lease_acquire_attempts']}")
        log(f"failover {config}: failover_ms {r['failover_ms']!r} (drain "
            f"{r['drain_ms']!r} ms){extra}; acked {r['acked_writes']}, "
            f"lost {r['acked_write_loss']}; p99 ms {p99}; codes "
            f"{ {k: r[k]['codes'] for k in p99} }; CUDA live bytes "
            f"{before:,} -> {r['cuda_allocated_after']:,}; leg launches "
            f"{r['leg_launches']}")
        out[config] = r
    return out


def chip_device():
    """The card every mesh slot of the mesh phases names."""
    import torch

    return torch.device("cuda", 0)


def mesh_query_stats(ba, mg, dp, read_mod, before: dict) -> dict:
    """What one mesh query did, from the counters snapshotted in
    `before` (mesh_query_snap): rounds and their slot fill and padding
    waste (the profiler's round timeline), fallbacks by reason, kernel
    launches, device-to-host bytes."""
    rounds = dp.profiler.rounds()[before["rounds"]:]
    fb = read_mod.mesh_fallback_counts()
    return {
        "rounds": len(rounds),
        "fill": (statistics.fmean(r["fill_ratio"] for r in rounds)
                 if rounds else None),
        "padding_rows": sum(r["padding_rows"] for r in rounds),
        "fallbacks": {r: v - before["fallbacks"].get(r, 0)
                      for r, v in fb.items()
                      if v - before["fallbacks"].get(r, 0)},
        "launches": launches(ba, mg),
        "d2h_bytes": dp.profiler.transfer["d2h"]["bytes"] - before["d2h"],
    }


def mesh_query_snap(ba, mg, dp, read_mod) -> dict:
    reset_all(ba, mg)
    return {"rounds": len(dp.profiler.rounds()),
            "fallbacks": read_mod.mesh_fallback_counts(),
            "d2h": dp.profiler.transfer["d2h"]["bytes"]}


async def mesh_phases(ba, mg, rows: int, cards=None) -> dict:
    """BASELINE config 1 (10M rows, 100 hosts, 139 2 h segments, not
    cut) on the port's meshes, one card:

    - mesh: [scan.mesh] at 1 x 1 (cuda:0) and at 4 x 2 (eight logical
      slots, all cuda:0), host decode: per bucket (1 min, 1 h) a
      true-cold query and 5 cached ones (windows cached, the PartsMemo
      emptied before each so the rounds run), each in turns with the
      single-device control (parts route, host decode): grids
      byte-equal to the control's and checked against numpy (sum, avg
      rtol 1e-5, the rest exact); per query the rounds, slot fill and
      padding waste from the profiler's round timeline, the fallbacks by
      reason (mesh_error must be 0), the launches
      (bucket_window_partials must be above 0), the device-to-host
      bytes (run tails only) and the walls;
    - mesh_decode: the same with [scan.decode] mode = "device" (mesh
      decode rounds; the control the single-device device decode):
      kway_merge_perm launches above 0, no decode fallback;
    - mesh_topk: top 10 by max and by sum at 1 min on the 4 x 2 mesh,
      device-scored, equal to the single-device query_topk;
    - segment_mesh: [scan] mesh_devices = 4 over four entries of
      cuda:0 under the device_sort merge layout (sharded_merge_dedup
      rounds, then sharded_remap_partials rounds), byte-equal to the
      control;
    - multihost: a one-process NCCL group: the global downsample over
      config 1's first segment, equal to the single-device answer.

    `cards` (default: the one card) lists the cards the mesh slots
    cycle over: with four, the 4 x 2 mesh's slots name cuda:0-3 twice
    and the segment mesh's four slots one card each, so the combine and
    the score state copy between cards.  The control stays on the
    first.  Each sub-phase prints its own `phase <name>: <s> s` line."""
    import numpy as np
    import torch

    from horaedb_tpu_torch.common import deviceprof as dp
    from horaedb_tpu_torch.metric_engine import MetricEngine
    from horaedb_tpu_torch.metric_engine.types import Label, tsid_of
    from horaedb_tpu_torch.objstore import MemoryObjectStore
    from horaedb_tpu_torch.ops import device_decode as dd
    from horaedb_tpu_torch.parallel import mesh as mesh_mod
    from horaedb_tpu_torch.storage import read as read_mod
    from horaedb_tpu_torch.storage.config import StorageConfig, from_dict
    from horaedb_tpu_torch.storage.types import TimeRange

    d = config1_rows(rows)
    hosts, interval, segment_ms = d["hosts"], d["interval"], d["segment_ms"]
    per_host, T0, n, names = d["per_host"], d["T0"], d["n"], d["names"]
    ts, host_id, vals = d["ts"], d["host_id"], d["vals"]
    vals32 = vals.astype(np.float32)
    cards = list(cards or [chip_device()])
    card = cards[0]
    slots8 = (cards * 8)[:8]
    out: dict = {"rows": n, "cards": [str(c) for c in cards]}
    store = MemoryObjectStore()
    engines: list = []
    saved_env = os.environ.get("HORAEDB_FUSED_AGG")
    # the control takes the parts route the meshes replace (the JAX
    # package's mesh tests force the same: its fused accumulator off)
    os.environ["HORAEDB_FUSED_AGG"] = "0"
    saved_rounds = dp.profiler.rounds_kept
    dp.profiler.configure(rounds_kept=8192)

    async def open_leg(devices, **scan):
        cfg = from_dict(StorageConfig, {
            "scheduler": {"schedule_interval": "1h"},
            "scan": {"cache_max_rows": 4 * rows, **scan}})
        with mesh_mod.local_devices_scope(devices):
            e = await MetricEngine.open("mesh", store,
                                        segment_ms=segment_ms, config=cfg)
        engines.append(e)
        return e

    def sub(name: str, t0: float) -> None:
        log(f"phase {name}: {time.perf_counter() - t0!r} s")

    tsids = np.array([tsid_of("cpu", [Label("host", f"host_{i:03d}")])
                      for i in range(hosts)], dtype=np.uint64)
    order = np.argsort(tsids)

    async def timed_query(e, rng_t, bucket_ms):
        t0 = time.perf_counter()
        got = await e.query_downsample("cpu", [], rng_t, bucket_ms)
        torch.cuda.synchronize()
        return got, (time.perf_counter() - t0) * 1e3

    async def turns(legs: dict, control, tag: str, route_kernels: tuple,
                    decode: bool) -> dict:
        """Per bucket: a true-cold query and 5 cached ones on every leg,
        in turns with the control; all the gates."""
        rec: dict = {}
        for bucket_ms in (60_000, 3_600_000):
            nb = -(-per_host * interval // bucket_ms)
            rng_t = TimeRange.new(T0, T0 + nb * bucket_ms)
            want = host_major_reference(vals32, hosts, per_host, T0,
                                        interval, bucket_ms, nb)
            per = {name: {"ms": [], "queries": []} for name in legs}
            per["control"] = {"ms": []}
            for rep in range(6):
                for e in [control] + list(legs.values()):
                    r = e.tables["data"].reader
                    if rep == 0:
                        true_cold(r)
                    else:
                        r.parts_memo.clear()
                ctl, ctl_ms = await timed_query(control, rng_t, bucket_ms)
                per["control"]["ms"].append(ctl_ms)
                for name, e in legs.items():
                    dec0 = dd.fallback_counts()
                    snap = mesh_query_snap(ba, mg, dp, read_mod)
                    got, ms = await timed_query(e, rng_t, bucket_ms)
                    st = mesh_query_stats(ba, mg, dp, read_mod, snap)
                    st["ms"] = ms
                    st["decode_fallbacks"] = {
                        k: v - dec0[k] for k, v in dd.fallback_counts().items()
                        if v - dec0[k]}
                    what = f"{tag} {name} {bucket_ms} ms rep {rep}"
                    same_bytes(got, ctl, f"{what} vs the control")
                    if rep in (0, 5):
                        check_config1(host_grids(got), want, order, what)
                    if st["fallbacks"].get("mesh_error"):
                        raise AssertionError(f"{what}: mesh_error fallbacks "
                                             f"{st['fallbacks']}")
                    if not st["rounds"]:
                        raise AssertionError(f"{what}: no mesh round ran")
                    for k in route_kernels:
                        if st["launches"][k] < 1:
                            raise AssertionError(f"{what}: {k} never "
                                                 "launched")
                    if decode and st["decode_fallbacks"]:
                        raise AssertionError(f"{what}: decode fallbacks "
                                             f"{st['decode_fallbacks']}")
                    per[name]["ms"].append(ms)
                    per[name]["queries"].append(st)
                    log(f"{tag} [{name}, {bucket_ms // 1000} s buckets, "
                        f"{'cold' if rep == 0 else f'cached {rep}'}]: "
                        f"{ms!r} ms (control {ctl_ms!r} ms); "
                        f"{st['rounds']} rounds, fill {st['fill']!r}, "
                        f"padding {st['padding_rows']:,} rows; fallbacks "
                        f"{st['fallbacks']}; launches {st['launches']}; "
                        f"d2h {st['d2h_bytes']:,} B; byte-equal to the "
                        f"control" + ("; numpy ok" if rep in (0, 5) else ""))
            for name, r in per.items():
                r["cold_ms"] = r["ms"][0]
                r["cached_p50_ms"] = statistics.median(r["ms"][1:])
            rec[str(bucket_ms)] = per
        return rec

    try:
        t0 = time.perf_counter()
        e_in = await open_leg([card])
        out["ingest_s"] = await ingest_rows(e_in, host_id, ts, vals, names,
                                            hosts)
        for t in e_in.tables.values():
            await t.manifest.trigger_merge()
        await e_in.close()
        engines.remove(e_in)
        log(f"mesh: ingest of {n:,} rows in {out['ingest_s']!r} s")

        # ---- mesh: [scan.mesh] on host-decoded windows
        control = await open_leg([card], decode={"mode": "host"})
        m11 = await open_leg([card], decode={"mode": "host"},
                             mesh={"enabled": True, "time": 1, "series": 1})
        m42 = await open_leg(slots8, decode={"mode": "host"},
                             mesh={"enabled": True, "time": 4, "series": 2})
        if m42.tables["data"].reader.scan_mesh.shape != {"time": 4,
                                                         "series": 2}:
            raise AssertionError("mesh: the 4 x 2 mesh was not built")
        out["mesh"] = await turns({"1x1": m11, "4x2": m42}, control, "mesh",
                                  ("bucket_window_partials",), False)
        sub("mesh", t0)

        # ---- mesh_topk: device-scored top-k on the 4 x 2 mesh
        t0 = time.perf_counter()
        nb = -(-per_host * interval // 60_000)
        rng_t = TimeRange.new(T0, T0 + nb * 60_000)
        out["mesh_topk"] = {}
        for by in ("max", "sum"):
            served0 = read_mod._MESH_TOPK.value
            snap = mesh_query_snap(ba, mg, dp, read_mod)
            t1 = time.perf_counter()
            got = await m42.query_topk("cpu", [], rng_t, 60_000, k=10, by=by)
            ms = (time.perf_counter() - t1) * 1e3
            st = mesh_query_stats(ba, mg, dp, read_mod, snap)
            t1 = time.perf_counter()
            ctl = await control.query_topk("cpu", [], rng_t, 60_000, k=10,
                                           by=by)
            ctl_ms = (time.perf_counter() - t1) * 1e3
            if read_mod._MESH_TOPK.value != served0 + 1:
                raise AssertionError(f"mesh_topk by {by}: not served by the "
                                     f"device-scored route ({st})")
            if len(got["tsids"]) != 10:
                raise AssertionError(f"mesh_topk by {by}: k=10")
            same_result_bytes(got, ctl, f"mesh_topk by {by}")
            st.update(ms=ms, control_ms=ctl_ms)
            out["mesh_topk"][by] = st
            log(f"mesh_topk [by {by}]: {ms!r} ms (control {ctl_ms!r} ms); "
                f"{st['rounds']} rounds; launches {st['launches']}; d2h "
                f"{st['d2h_bytes']:,} B; answer and rows equal the "
                "single-device query_topk")
        sub("mesh_topk", t0)
        for e in (m11, m42):
            await e.close()
            engines.remove(e)

        # ---- mesh_decode: [scan.decode] mode = "device" on the mesh
        t0 = time.perf_counter()
        dcontrol = await open_leg([card], decode={"mode": "device"})
        d11 = await open_leg([card], decode={"mode": "device"},
                             mesh={"enabled": True, "time": 1, "series": 1})
        d42 = await open_leg(slots8, decode={"mode": "device"},
                             mesh={"enabled": True, "time": 4, "series": 2})
        out["mesh_decode"] = await turns(
            {"1x1": d11, "4x2": d42}, dcontrol, "mesh_decode",
            ("bucket_window_partials", "kway_merge_perm"), True)
        sub("mesh_decode", t0)
        for e in (dcontrol, d11, d42):
            await e.close()
            engines.remove(e)

        # ---- segment_mesh: [scan] mesh_devices = 4, device_sort merges
        t0 = time.perf_counter()
        seg = await open_leg((cards * 4)[:4], decode={"mode": "host"},
                             mesh_devices=4)
        rec = {}
        for rep in range(3):
            for e in (control, seg):
                r = e.tables["data"].reader
                if rep == 0:
                    true_cold(r)
                else:
                    r.parts_memo.clear()
            ctl, ctl_ms = await timed_query(control, rng_t, 60_000)
            merges0 = dp.profiler._record(
                "sharded_merge[merge_dedup_last]").dispatches
            remaps0 = dp.profiler._record("sharded_remap_partials").dispatches
            snap = mesh_query_snap(ba, mg, dp, read_mod)
            mg.set_merge_impl("device_sort")
            try:
                got, ms = await timed_query(seg, rng_t, 60_000)
            finally:
                mg.set_merge_impl("host_perm")
            st = mesh_query_stats(ba, mg, dp, read_mod, snap)
            st["merge_rounds"] = dp.profiler._record(
                "sharded_merge[merge_dedup_last]").dispatches - merges0
            st["remap_rounds"] = dp.profiler._record(
                "sharded_remap_partials").dispatches - remaps0
            st.update(ms=ms, control_ms=ctl_ms)
            same_bytes(got, ctl, f"segment_mesh rep {rep} vs the control")
            if rep == 0 and (st["merge_rounds"] < 1
                             or st["launches"]["bucket_window_partials"] < 1):
                raise AssertionError(f"segment_mesh: rounds did not run "
                                     f"({st})")
            if st["remap_rounds"] < 1:
                raise AssertionError(f"segment_mesh: no remap round ({st})")
            rec[f"rep{rep}"] = st
            log(f"segment_mesh [{'cold' if rep == 0 else f'cached {rep}'}]"
                f": {ms!r} ms (control {ctl_ms!r} ms); "
                f"{st['merge_rounds']} sharded_merge_dedup rounds, "
                f"{st['remap_rounds']} sharded_remap_partials rounds; "
                f"launches {st['launches']}; byte-equal to the control")
        out["segment_mesh"] = rec
        sub("segment_mesh", t0)

        # ---- multihost: a one-process NCCL group
        t0 = time.perf_counter()
        out["multihost"] = multihost_leg(ba, mg, d)
        sub("multihost", t0)
        return out
    finally:
        for e in engines:
            await e.close()
        dp.profiler.configure(rounds_kept=saved_rounds)
        if saved_env is None:
            os.environ.pop("HORAEDB_FUSED_AGG", None)
        else:
            os.environ["HORAEDB_FUSED_AGG"] = saved_env


def multihost_procs_leg(nprocs: int) -> dict:
    """parallel/multihost.py across processes on the cards: the test
    suite's worker (tests/torch_multihost_worker.py) as `nprocs` NCCL
    processes, one card each with 4 slots, each contributing its own 4
    windows; every process must observe the same replicated grids, equal
    to numpy over all windows (count, min, max, last exact; sum rtol
    1e-5) and to the top 3 by max."""
    import numpy as np

    here = os.path.dirname(os.path.abspath(__file__))
    worker = os.path.join(here, "tests", "torch_multihost_worker.py")
    root = scratch_dir("multihost")
    coordinator = f"127.0.0.1:{free_port()}"
    outs = [os.path.join(root, f"out{r}.npz") for r in range(nprocs)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, worker, coordinator,
                               str(nprocs), str(r), outs[r], "cuda"],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for r in range(nprocs)]
    try:
        logs = [p.communicate(timeout=300)[0].decode(errors="replace")
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    if any(p.returncode != 0 for p in procs):
        raise AssertionError("multihost workers failed:\n"
                             + "\n---\n".join(logs))
    got = [np.load(o) for o in outs]
    for g in got[1:]:
        for k in got[0].files:
            if g[k].tobytes() != got[0][k].tobytes():
                raise AssertionError(f"multihost: processes disagree on {k}")
    # the worker's dataset, over all nprocs x 4 windows
    G, B, CAP, BMS_ = 8, 4, 128, 60_000
    rng = np.random.default_rng(99)
    n_global = 4 * nprocs
    ts = rng.integers(0, B * BMS_, (n_global, CAP)).astype(np.int32)
    gid = rng.integers(0, G, (n_global, CAP)).astype(np.int32)
    vals = (rng.random((n_global, CAP)) * 100).astype(np.float32)
    nv = CAP - 8
    t = np.concatenate([ts[i, :nv] for i in range(n_global)])
    g_ = np.concatenate([gid[i, :nv] for i in range(n_global)])
    v = np.concatenate([vals[i, :nv] for i in range(n_global)])
    cell = g_.astype(np.int64) * B + t // BMS_
    count = np.bincount(cell, minlength=G * B).reshape(G, B)
    total = np.bincount(cell, weights=v.astype(np.float64),
                        minlength=G * B).reshape(G, B)
    mx = np.full((G, B), -np.inf)
    np.maximum.at(mx, (g_, t // BMS_), v.astype(np.float64))
    a = got[0]
    occ = count > 0
    if not np.array_equal(a["count"], count) or not np.array_equal(
            a["max"][occ], mx[occ].astype(np.float32)):
        raise AssertionError("multihost: count or max differs from numpy")
    np.testing.assert_allclose(a["sum"], total, rtol=1e-5)
    scores = np.where(occ, a["max"], -np.inf).max(axis=1)
    if not np.array_equal(a["top_idx"],
                          np.argsort(-scores, kind="stable")[:3]):
        raise AssertionError("multihost: top 3 differs from numpy")
    import shutil

    shutil.rmtree(root, ignore_errors=True)
    log(f"multihost: {nprocs} NCCL processes (one card each, 4 slots) in "
        f"{wall!r} s including their start; the replicated grids equal "
        "on every process and to numpy over all windows")
    return {"procs": nprocs, "wall_s": wall}


def multihost_leg(ba, mg, d: dict) -> dict:
    """parallel/multihost.py on one card: an NCCL group of one process
    (tcp rendezvous on a free local port), the global downsample over
    config 1's first 2 h segment (100 hosts, 72,000 rows in one slot),
    against the single-device time_bucket_aggregate on the same rows."""
    import numpy as np
    import torch

    from horaedb_tpu_torch.ops import downsample
    from horaedb_tpu_torch.ops.encode import pad_capacity
    from horaedb_tpu_torch.parallel import mesh as mesh_mod
    from horaedb_tpu_torch.parallel import multihost

    seg = d["ts"] < d["T0"] + d["segment_ms"]
    n = int(seg.sum())
    cap = pad_capacity(n)
    nb = d["segment_ms"] // BMS
    ts = np.zeros((1, cap), dtype=np.int32)
    gid = np.zeros((1, cap), dtype=np.int32)
    vals = np.zeros((1, cap), dtype=np.float32)
    ts[0, :n] = d["ts"][seg] - d["T0"]
    gid[0, :n] = d["host_id"][seg]
    vals[0, :n] = d["vals"][seg].astype(np.float32)
    card = chip_device()
    reset_all(ba, mg)
    t0 = time.perf_counter()
    multihost.initialize(f"127.0.0.1:{free_port()}", 1, 0,
                         device=card.type)
    try:
        init_s = time.perf_counter() - t0
        mesh = multihost.global_segment_mesh()
        fn = multihost.downsample_query_global(
            mesh, num_groups=d["hosts"], num_buckets=nb, k=10)
        t1 = time.perf_counter()
        final, top_vals, top_idx = fn(
            multihost.host_local_rows_to_global(mesh, ts),
            multihost.host_local_rows_to_global(mesh, gid),
            multihost.host_local_rows_to_global(mesh, vals),
            np.array([n], dtype=np.int32), BMS)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) * 1e3
        got_launches = launches(ba, mg)
    finally:
        multihost.shutdown()
        mesh_mod.set_local_devices(None)
    ref = downsample.time_bucket_aggregate(
        torch.from_numpy(ts[0]).to(card), torch.from_numpy(gid[0]).to(card),
        torch.from_numpy(vals[0]).to(card), n, BMS, d["hosts"], nb)
    for k, v in ref.items():
        a, b = final[k].cpu().numpy(), v.cpu().numpy()
        if a.tobytes() != b.tobytes():
            raise AssertionError(f"multihost: {k} differs from the "
                                 "single-device answer")
    if got_launches["bucket_window_partials"] < 1:
        raise AssertionError("multihost: bucket_window_partials never "
                             "launched")
    log(f"multihost: NCCL group of 1 up in {init_s!r} s; global downsample "
        f"of {n:,} rows in {ms!r} ms, launches {got_launches}; every grid "
        "byte-equal to the single-device answer; top 10 "
        f"{top_idx.cpu().tolist()}")
    return {"rows": n, "init_s": init_s, "ms": ms, "launches": got_launches}


def bench_phase(rows: int = 10_000_000, iters: int = 20) -> dict:
    """`python -m horaedb_tpu_torch.bench` in a subprocess at bench.py's
    defaults (10,000,000 rows, 20 iters): BENCH_CONFIG=0 (the kernel
    microbench) and 1 (the end-to-end headline).  Each prints one JSON
    line on the card (backend cuda, no fallback, this card's name and
    power limit) after its own numpy checks; the headline's cached
    queries must be replay hits with 0 B up and its cold query none;
    each line's kernel launches, counted in its process from 0, must
    include its path's kernel.  The microbench's p50 must not fall below
    the device time of its call at the same inputs."""
    import numpy as np

    from horaedb_tpu_torch.bench.tsbs import TsbsConfig, generate_cpu_arrays
    from horaedb_tpu_torch.ops.downsample import time_bucket_aggregate
    from horaedb_tpu_torch.ops.encode import to_device

    here = os.path.dirname(os.path.abspath(__file__))
    card = card_line()
    out: dict = {}
    for config in (0, 1):
        env = dict(os.environ, BENCH_CONFIG=str(config),
                   BENCH_ROWS=str(rows), BENCH_ITERS=str(iters))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "horaedb_tpu_torch.bench"], cwd=here,
            env=env, capture_output=True, text=True, timeout=900)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"bench: BENCH_CONFIG={config} exited "
                                 f"{proc.returncode}: {proc.stderr[-3000:]}")
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        log(f"bench: BENCH_CONFIG={config} in {wall!r} s: {json.dumps(line)}")
        if not (line["backend"] == "cuda" and line["fallback"] is False
                and line["card"] == card):
            raise AssertionError(f"bench: config {config} did not run on "
                                 f"the card: {line}")
        line["wall_s"] = wall
        out[config] = line
    micro, head = out[0], out[1]
    if micro["launches"]["bucket_window_partials"] < iters + 1:
        raise AssertionError(f"bench: the microbench launched "
                             f"{micro['launches']}")
    if head["launches"]["bucket_round_accumulate"] == 0:
        raise AssertionError(f"bench: the headline's fused route launched "
                             f"{head['launches']}")
    if not (head["cached_replay_hits"] == head["cached_queries"] == iters
            and head["cached_h2d_bytes"] == 0
            and head["cold_replay_hits"] == 0
            and head["cold_h2d_bytes"] > 0):
        raise AssertionError(f"bench: the headline's cached queries were "
                             f"not all replays or its cold query not cold: "
                             f"{head}")
    # the microbench's inputs again: its p50 (a synced wall time) must not
    # fall below the call's device time
    interval, hosts = 10_000, 100
    span = (rows // hosts) * interval
    cols = generate_cpu_arrays(TsbsConfig(
        num_hosts=hosts, num_fields=1, interval_ms=interval, span_ms=span))
    n = len(cols["ts"])
    cap = 1 << (n - 1).bit_length()
    dev = chip_device()
    pad = lambda a, dt: to_device(np.pad(a.astype(dt), (0, cap - n)), dev)
    args = (pad(cols["ts"] - 1_700_000_000_000, np.int32),
            pad(cols["host_id"], np.int32), pad(cols["usage_user"],
                                                np.float32))
    kernel_ms = device_ms(lambda: time_bucket_aggregate(
        *args, n, 60_000, num_groups=hosts, num_buckets=-(-span // 60_000),
        which=("avg", "count"), device=dev), reps=20)
    if micro["value"] < kernel_ms:
        raise AssertionError(f"bench: the microbench's p50 "
                             f"{micro['value']} ms is below its call's "
                             f"device time {kernel_ms} ms: it timed the "
                             f"launch only")
    out["micro_device_ms"] = kernel_ms
    log(f"bench: microbench p50 {micro['value']} ms >= the call's device "
        f"time {kernel_ms!r} ms; headline cached p50 {head['value']} ms, "
        f"cold p50 {head['cold_p50_ms']} ms, varied p50 "
        f"{head['varied_p50_ms']} ms ({card})")
    return {str(k): v for k, v in out.items()}


# the suite configs the suite phase runs; 11, 17, 20 and 21 run in the
# rollup, scanagent and failover phases
SUITE_PHASE_CONFIGS = (2, 3, 4, 5, 6, 7, 8, 9, 10, 12, 13, 14, 15, 16, 18,
                       19, 22, 23)
# the mesh configs, run on eight logical slots of this card
SUITE_MESH_CONFIGS = (19, 22, 23)
# config 18 measures the process's RSS against the memory ledger: it
# runs where the CLI runs it, in a fresh process (`python -m
# horaedb_tpu_torch.bench`), not after the allocator history of the
# phases before it
SUITE_OWN_PROCESS = (18,)
# config 15's iters are its legs' seconds (three legs, clamped to 4-30):
# at the CLI's 10 it takes ~70 s on an H100, at 4 ~35 s
SUITE_ITERS = {15: 4}


def suite_phase(ba, mg, rows: int = 2_000_000, iters: int = 10) -> dict:
    """The port's bench suite at the suite CLI's defaults (2,000,000
    rows, 10 iters), on the card: SUITE_PHASE_CONFIGS, each checking
    itself in-bench (numpy, byte and rtol checks, its bars) and, on the
    card, its launch gates.  The on-disk configs' stores and WALs go to
    .wal_smoke_* directories beside this script (removed after).  Each
    config's kernel launches are counted from 0 around it; the mesh
    configs run on eight logical slots of this card, as the mesh phases
    do."""
    from horaedb_tpu_torch.parallel import mesh

    out: dict = {}
    for config in SUITE_PHASE_CONFIGS:
        slots = ([chip_device()] * 8 if config in SUITE_MESH_CONFIGS
                 else None)
        k = SUITE_ITERS.get(config, iters)
        if k != iters:
            log(f"suite: config {config} at iters {k} (cut from {iters})")
        if config in SUITE_OWN_PROCESS:
            result, detail = suite_own_process(config, rows, k)
        else:
            with mesh.local_devices_scope(slots):
                result, detail = suite_config(ba, mg, config, rows, k,
                                              "suite")
        if detail:
            result["detail"] = detail
        out[str(config)] = result
        if config == 18:
            # the ledger's cost on the cached traced query: the sampler
            # and each trace's mem_account_delta attribution (recorded,
            # as the reference records it)
            pct = result["overhead"]["on_overhead_pct"]
            log(f"suite: config 18 on_overhead_pct {pct!r} (sampler + "
                f"per-trace attribution; reference bar < 2: "
                f"{'met' if pct < 2 else 'missed'})")
    if iters != 10 or rows != 2_000_000:
        log(f"suite: cut to --rows {rows:,}, --iters {iters} (the CLI's "
            "defaults are 2,000,000 and 10)")
    return out


class FakeS3:
    """An S3-compatible endpoint on 127.0.0.1, in a thread and event
    loop of its own, holding its objects in memory.  Every request's
    SigV4 signature is recomputed from the raw request bytes and its
    payload hash from the body; either mismatch answers 403.  It serves
    PUT, GET (ranged too), HEAD, DELETE, ListObjectsV2 and multipart
    uploads, and counts object GETs and the bytes they return."""

    SECRET = "chip-smoke-secret"
    REGION = "us-east-1"
    BUCKET = "tsdb"
    KEY_ID = "AKIACHIPSMOKE"

    def __init__(self):
        self.objects: dict = {}
        self.uploads: dict = {}
        self.requests = 0
        self.gets = 0
        self.get_bytes = 0
        self.puts = 0
        self.put_bytes = 0
        self.bad = 0

    def start(self) -> str:
        import threading

        from aiohttp import web

        ready = threading.Event()

        def serve():
            self.loop = asyncio.new_event_loop()
            asyncio.set_event_loop(self.loop)
            app = web.Application(client_max_size=1 << 30)
            app.router.add_route("*", "/{tail:.*}", self.handle)
            self.runner = web.AppRunner(app, access_log=None)
            self.loop.run_until_complete(self.runner.setup())
            site = web.TCPSite(self.runner, "127.0.0.1", 0)
            self.loop.run_until_complete(site.start())
            self.port = self.runner.addresses[0][1]
            ready.set()
            self.loop.run_forever()

        self.thread = threading.Thread(target=serve, daemon=True)
        self.thread.start()
        if not ready.wait(60):
            raise AssertionError("fake S3 did not start")
        return f"http://127.0.0.1:{self.port}"

    def stop(self) -> None:
        asyncio.run_coroutine_threadsafe(self.runner.cleanup(),
                                         self.loop).result(60)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(60)

    def snap(self) -> tuple:
        return self.gets, self.get_bytes

    def since(self, snap: tuple) -> dict:
        return {"gets": self.gets - snap[0],
                "get_bytes": self.get_bytes - snap[1]}

    def signature_ok(self, request) -> bool:
        import hashlib
        import hmac

        def mac(key: bytes, msg: str) -> bytes:
            return hmac.new(key, msg.encode(), hashlib.sha256).digest()

        auth = request.headers.get("Authorization", "")
        if not auth.startswith("AWS4-HMAC-SHA256 "):
            return False
        parts = dict(p.strip().split("=", 1) for p in
                     auth.removeprefix("AWS4-HMAC-SHA256 ").split(","))
        scope = parts["Credential"].split("/", 1)[1]
        signed = parts["SignedHeaders"]
        path, _, query = request.raw_path.partition("?")
        canonical = "\n".join([
            request.method, path, query,
            "".join(f"{h}:{request.headers[h].strip()}\n"
                    for h in signed.split(";")),
            signed, request.headers["x-amz-content-sha256"]])
        to_sign = "\n".join([
            "AWS4-HMAC-SHA256", request.headers["x-amz-date"], scope,
            hashlib.sha256(canonical.encode()).hexdigest()])
        k = mac(("AWS4" + self.SECRET).encode(), scope.split("/")[0])
        for part in (self.REGION, "s3", "aws4_request"):
            k = mac(k, part)
        want = hmac.new(k, to_sign.encode(), hashlib.sha256).hexdigest()
        return hmac.compare_digest(want, parts["Signature"])

    async def handle(self, request):
        import hashlib
        from xml.sax.saxutils import escape

        from aiohttp import web

        self.requests += 1
        body = await request.read()
        if not self.signature_ok(request) or request.headers[
                "x-amz-content-sha256"] != hashlib.sha256(body).hexdigest():
            self.bad += 1
            return web.Response(status=403)
        bucket = f"/{self.BUCKET}"
        if request.path == bucket:  # ListObjectsV2, 1,000 keys a page
            prefix = request.query.get("prefix", "")
            after = request.query.get("continuation-token", "")
            keys = sorted(k for k in self.objects
                          if k.startswith(prefix) and k > after)
            page, rest = keys[:1000], keys[1000:]
            token = (f"<NextContinuationToken>{escape(page[-1])}"
                     f"</NextContinuationToken>" if rest else "")
            contents = "".join(
                f"<Contents><Key>{escape(k)}</Key><Size>"
                f"{len(self.objects[k])}</Size></Contents>" for k in page)
            xml = (f"<ListBucketResult><IsTruncated>"
                   f"{'true' if rest else 'false'}</IsTruncated>{token}"
                   f"{contents}</ListBucketResult>")
            return web.Response(body=xml.encode(),
                                content_type="application/xml")
        key = request.path.removeprefix(bucket + "/")
        q = request.query
        if request.method == "POST" and "uploads" in q:
            uid = f"up-{len(self.uploads)}-{self.requests}"
            self.uploads[uid] = {}
            return web.Response(body=(
                f"<InitiateMultipartUploadResult><UploadId>{uid}</UploadId>"
                f"</InitiateMultipartUploadResult>").encode())
        if request.method == "PUT" and "uploadId" in q:
            self.uploads[q["uploadId"]][int(q["partNumber"])] = body
            return web.Response(headers={
                "ETag": f'"{hashlib.md5(body).hexdigest()}"'})
        if request.method == "POST" and "uploadId" in q:
            parts = self.uploads.pop(q["uploadId"])
            self.objects[key] = b"".join(parts[i] for i in sorted(parts))
            return web.Response(body=b"<CompleteMultipartUploadResult/>")
        if request.method == "DELETE" and "uploadId" in q:
            self.uploads.pop(q["uploadId"], None)
            return web.Response(status=204)
        if request.method == "PUT":
            self.puts += 1
            self.put_bytes += len(body)
            self.objects[key] = body
            return web.Response()
        if request.method in ("GET", "HEAD"):
            data = self.objects.get(key)
            if data is None:
                return web.Response(status=404)
            if request.method == "HEAD":
                return web.Response(headers={
                    "Content-Length": str(len(data))})
            rng = request.headers.get("Range")
            self.gets += 1
            if rng:
                lo, hi = rng.removeprefix("bytes=").split("-")
                data = data[int(lo): int(hi) + 1]
                self.get_bytes += len(data)
                return web.Response(status=206, body=data)
            self.get_bytes += len(data)
            return web.Response(body=data)
        if request.method == "DELETE":
            self.objects.pop(key, None)
            return web.Response(status=204)
        return web.Response(status=405)


async def s3_phase(ba, mg, rows: int, parts_cold: dict) -> dict:
    """BASELINE config 1 over S3: the rows written through a MetricEngine
    with the default StorageConfig over the port's S3ObjectStore, whose
    endpoint is FakeS3 on 127.0.0.1 (SigV4 checked on every request).
    One true-cold avg at 1 min over the whole segments (device decode,
    launches counted from 0 around it) and 5 repeats; every grid byte
    for byte the in-memory parts leg's device-decode grid of the same
    query, and against numpy.  Then the server CLI on a kind = "S3Like"
    config pointed at the same endpoint answers one /write and /query."""
    import shutil

    import numpy as np
    import torch

    from horaedb_tpu_torch.metric_engine import MetricEngine
    from horaedb_tpu_torch.metric_engine.types import Label, tsid_of
    from horaedb_tpu_torch.objstore import S3ObjectStore, S3Options
    from horaedb_tpu_torch.ops.encode import h2d_bytes
    from horaedb_tpu_torch.storage.config import StorageConfig, from_dict
    from horaedb_tpu_torch.storage.read import _REPLAY_HITS
    from horaedb_tpu_torch.storage.types import TimeRange

    d = config1_rows(rows)
    hosts, interval, segment_ms = d["hosts"], d["interval"], d["segment_ms"]
    per_host, T0, n, names = d["per_host"], d["T0"], d["n"], d["names"]
    ts, host_id, vals = d["ts"], d["host_id"], d["vals"]
    n_seg = -(-per_host * interval // segment_ms)
    full = (T0, T0 + n_seg * segment_ms)
    nb = n_seg * segment_ms // BMS
    tsid_of_host = np.array([tsid_of("cpu", [Label("host", f"host_{i:03d}")])
                             for i in range(hosts)], dtype=np.uint64)
    order = np.argsort(tsid_of_host)
    tsids = [int(t) for t in tsid_of_host[order]]
    fake = FakeS3()
    endpoint = fake.start()
    root = scratch_dir("s3")
    out: dict = {"rows": n, "endpoint": endpoint}
    try:
        store = S3ObjectStore(S3Options(
            endpoint=endpoint, region=fake.REGION, bucket=fake.BUCKET,
            access_key_id=fake.KEY_ID, secret_access_key=fake.SECRET,
            prefix="bench"))
        # ingest as the in-memory cell does (compaction held off), then
        # query through a second engine with the default StorageConfig,
        # as its parts leg does
        e = await MetricEngine.open(
            "bench", store, segment_ms=segment_ms,
            config=from_dict(StorageConfig, {
                "scheduler": {"schedule_interval": "1h"}}))
        try:
            out["ingest_s"] = await ingest_rows(e, host_id, ts, vals, names,
                                                hosts)
        finally:
            await e.close()
        e = await MetricEngine.open("bench", store, segment_ms=segment_ms,
                                    config=StorageConfig())
        try:
            out["objects"] = len(fake.objects)
            out["stored_bytes"] = sum(len(v) for v in fake.objects.values())
            out["puts"], out["put_bytes"] = fake.puts, fake.put_bytes
            log(f"s3: ingest {n:,} rows in {out['ingest_s']!r} s: "
                f"{out['puts']} PUTs, {out['put_bytes']:,} B; "
                f"{out['objects']} objects, {out['stored_bytes']:,} B")
            reader = e.tables["data"].reader

            async def query():
                snap = fake.snap()
                t0 = time.perf_counter()
                res = await e.query_downsample(
                    "cpu", [], TimeRange.new(*full), bucket_ms=BMS,
                    aggs=("avg",))
                torch.cuda.synchronize()
                return res, (time.perf_counter() - t0) * 1e3, fake.since(snap)

            true_cold(reader)
            replays0, h2d0 = _REPLAY_HITS.value, h2d_bytes()
            reset_all(ba, mg)
            cold, cold_ms, cold_io = await query()
            out["launches"] = launches(ba, mg)
            out["cold"] = {"ms": cold_ms, **cold_io,
                           "h2d_bytes": h2d_bytes() - h2d0,
                           "replay_hits": int(_REPLAY_HITS.value - replays0)}
            if not (out["launches"]["bucket_window_partials"] > 0
                    and out["launches"]["kway_merge_perm"] > 0):
                raise AssertionError(f"s3: the cold query's launches "
                                     f"{out['launches']}")
            if not (cold_io["gets"] > 0 and out["cold"]["h2d_bytes"] > 0
                    and out["cold"]["replay_hits"] == 0):
                raise AssertionError(f"s3: the cold query was not cold: "
                                     f"{out['cold']}")
            check_grid(cold, ts, host_id, vals, T0, nb, BMS, hosts, order,
                       tsids, "s3: cold 1 min avg")
            same_bytes(cold, parts_cold,
                       "s3: cold 1 min avg vs the in-memory parts leg")
            out["cached"] = []
            for i in range(5):
                res, ms, io = await query()
                same_bytes(res, cold, f"s3: repeat {i}")
                out["cached"].append({"ms": ms, **io})
            log(f"s3: true-cold avg at 1 min {cold_ms!r} ms: "
                f"{cold_io['gets']} GETs, {cold_io['get_bytes']:,} B from "
                f"the fake, {out['cold']['h2d_bytes']:,} B up; launches "
                f"{out['launches']}; grids byte-equal to the in-memory "
                f"parts leg's device decode and matching numpy; 5 repeats "
                f"{[c['ms'] for c in out['cached']]!r} ms, GETs "
                f"{[c['gets'] for c in out['cached']]}, byte-equal")
        finally:
            await e.close()
            await store.close()
        port = free_port()
        text = (f'port = {port}\n\n[metric_engine.object_store]\n'
                f'kind = "S3Like"\n\n[metric_engine.object_store.s3]\n'
                f'endpoint = "{endpoint}"\nregion = "{fake.REGION}"\n'
                f'bucket = "{fake.BUCKET}"\nkey_id = "{fake.KEY_ID}"\n'
                f'key_secret = "{fake.SECRET}"\nprefix = "cli"\n')
        out.update(await server_cli_leg(text, port, root, T0, "s3"))
        if fake.bad or not any(k.startswith("cli/") for k in fake.objects):
            raise AssertionError(f"s3: {fake.bad} requests failed their "
                                 "signature check, or the CLI stored "
                                 "nothing")
        out["requests"] = fake.requests
    finally:
        fake.stop()
        shutil.rmtree(root, ignore_errors=True)
    return out


def merge_dedup_phase(mg) -> dict:
    """merge_dedup_last (ops/merge.py: torch code, the JAX package's
    _merge_dedup_impl; no kernel of its own) on the card at the segment
    mesh's shape: one config 1 segment window, 72,000 rows in 131,072
    slots (main_path_segment's keys: the data table's 4 PK columns and
    __seq__) and one float32 value column.  Every output byte-equal to
    its CPU run; the device time of back-to-back calls (CUDA events),
    one call's time with its host work, and the bytes bound (each input
    read once, each output written once)."""
    import numpy as np
    import torch

    keys, _offs, _num_runs, n = main_path_segment()
    cap = keys.shape[1]
    vals = np.random.default_rng(13).random(cap).astype(np.float32)

    def args(dev):
        k = [torch.from_numpy(np.ascontiguousarray(c)).to(dev) for c in keys]
        return tuple(k[:4]), k[4], (torch.from_numpy(vals).to(dev),)

    def flat(out) -> list:
        pk, seq, vs, valid, runs = out
        return [t.cpu().numpy().tobytes()
                for t in (*pk, seq, *vs, valid, runs.reshape(1))]

    dev = torch.device("cuda")
    per = keys.nbytes + vals.nbytes
    copies = [args(dev) for _ in range(max(4, math.ceil(60e6 / per)))]
    if flat(mg.merge_dedup_last(*copies[0], n)) != \
            flat(mg.merge_dedup_last(*args("cpu"), n)):
        raise AssertionError("merge_dedup_last: the card's run differs "
                             "from the CPU's")
    ms = device_ms([lambda c=c: mg.merge_dedup_last(*c, n)
                    for c in copies], reps=20)
    call_ms = cuda_ms(lambda: mg.merge_dedup_last(*copies[0], n), reps=20)
    # in: 5 int32 key columns and the value column; out: the same six
    # columns, the valid mask (1 B a slot) and the run count
    nbytes = 2 * per + cap + 4
    out = {"cap": cap, "n": n, "ms": ms, "call_ms": call_ms,
           "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
           "bound_by": "bytes"}
    log(f"merge_dedup: merge_dedup_last at the segment mesh's shape "
        f"({n:,} rows of {cap:,}): {ms!r} ms on the card ({call_ms!r} ms a "
        f"call with its host work), bound {out['bound_ms']!r} ms "
        f"({nbytes:,} B); byte-equal to its CPU run")
    return out


def load_parent_module(root: str, module: str, source: str):
    """ops/<module>.py of another checkout at `root`, loaded under its
    own name and pointed at that checkout's csrc/<source> (it builds into
    this checkout's build directory, keyed by the source's content)."""
    import importlib.util

    path = os.path.join(root, "horaedb_tpu_torch", "ops", f"{module}.py")
    spec = importlib.util.spec_from_file_location(f"parent_{module}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.SOURCE = os.path.join(root, "horaedb_tpu_torch", "csrc", source)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=10_000_000,
                    help="rows of the end-to-end phase (a cut is printed)")
    ap.add_argument("--json", default=None,
                    help="also write every number of the run to this file")
    ap.add_argument("--config4-rows", type=int, default=32_000_000,
                    help="rows of the config 4 phase (64 SSTs; the cut "
                         "from 1B is printed; below 8,388,608 rows the "
                         "segment no longer streams and the phase fails "
                         "its route check)")
    ap.add_argument("--cards", type=int, default=1,
                    help="with N > 1, run only the mesh phases with the "
                         "mesh slots cycling over N cards, and the "
                         "multi-process tier as N NCCL processes")
    ap.add_argument("--parent", default=None,
                    help="root of another checkout of this repo (e.g. a git "
                         "archive of the parent commit): its merge and "
                         "bucket-aggregate kernels are timed beside this "
                         "checkout's, in turns")
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

    parent = parent_ba = None
    if args.parent:
        parent = load_parent_module(args.parent, "merge", "merge_path.cu")
        parent_ba = load_parent_module(args.parent, "bucket_agg",
                                       "bucket_agg.cu")
    mods = (ba, mg, native) + ((parent, parent_ba) if parent else ())
    with ThreadPoolExecutor(max_workers=len(mods)) as pool:
        built = {mod: pool.submit(timed_build, mod) for mod in mods}
        built = {mod: f.result() for mod, f in built.items()}
    for mod, secs in built.items():
        log(f"build: {os.path.relpath(mod.SOURCE)} in {secs!r} s")
        for line in ("" if mod is native else mod.build_log()).splitlines():
            if "registers" in line or "spill" in line:
                log(f"build: {line.strip()}")

    phase_s: dict = {}

    def phase(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        phase_s[name] = time.perf_counter() - t0
        log(f"phase {name}: {phase_s[name]!r} s")
        if args.json:
            # every phase's seconds so far, kept where a failed run
            # still leaves them
            os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                        exist_ok=True)
            with open(args.json + ".phases", "w") as f:
                json.dump(phase_s, f)
        return out

    if args.cards > 1:
        if torch.cuda.device_count() < args.cards:
            print(f"chip_smoke: --cards {args.cards} needs {args.cards} "
                  "cards", file=sys.stderr)
            return 2
        cards = [torch.device("cuda", i) for i in range(args.cards)]
        log(f"cards:\n{card_line(every=True)}")
        mesh = phase("meshes over the cards", asyncio.run,
                     mesh_phases(ba, mg, args.rows, cards))
        procs = phase("multihost processes", multihost_procs_leg,
                      args.cards)
        if args.json:
            os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                        exist_ok=True)
            with open(args.json, "w") as f:
                json.dump({"card": card, "mesh": mesh, "procs": procs}, f,
                          indent=1)
        log(f"total: {time.perf_counter() - t_start!r} s")
        log(card_line())
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    kernels = phase("kernel", kernel_phase, ba, fused, parent_ba)
    merge_k = phase("merge kernel", merge_kernel_phase, mg, dd, parent)
    determinism = phase("determinism", determinism_phase, ba, fused)
    nan = phase("nan bits (C 18)", asyncio.run, nan_phase(ba, mg, fused))
    e2e = phase("end to end (fused, op, parts)", asyncio.run,
                end_to_end(args.rows, ba, mg))
    compaction = phase("compaction", asyncio.run, compaction_phase(ba, mg))
    wal = phase("wal", asyncio.run,
                wal_phase(args.rows, ba, mg, e2e["ingest_s"]))
    topk_ops = phase("topk ops", topk_ops_phase)
    config4 = phase("config4", asyncio.run,
                    config4_phase(args.config4_rows, ba, mg))
    rollup = phase("rollup (config 11)", rollup_phase, ba, mg)
    chunked = phase("chunked", asyncio.run, chunked_phase(ba, mg))
    scanagent = phase("scanagent (config 17)", scanagent_phase, ba, mg)
    server = phase("server", asyncio.run, server_phase(ba, mg, args.rows))
    cluster = phase("cluster", asyncio.run, cluster_phase(ba, mg, args.rows))
    failover = phase("failover (configs 20, 21)", failover_phase, ba, mg)
    mesh = phase("meshes (mesh, mesh_topk, mesh_decode, segment_mesh, "
                 "multihost)", asyncio.run, mesh_phases(ba, mg, args.rows))
    bench = phase("bench", bench_phase)
    suite = phase("suite", suite_phase, ba, mg)
    s3 = phase("s3", asyncio.run,
               s3_phase(ba, mg, args.rows, e2e["parts"].pop("cold_1min")))
    dedup = phase("merge_dedup", merge_dedup_phase, mg)
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
        # and on the rollup cell (config 11): the backfill (139 segments
        # x 2 tiers on the parts route), the rollup-served mix (no raw
        # tail: 0) and the raw cold mix; and on one cold chunked query
        k["rollup_backfill_launches"] = \
            rollup["backfill_launches"][k["name"]]
        k["rollup_mix_launches"] = rollup["rollup_leg_launches"][k["name"]]
        k["rollup_raw_cold_launches"] = \
            rollup["raw_cold_leg_launches"][k["name"]]
        k["chunked_launches"] = chunked["chunked_launches"][k["name"]]
        # and on config 17's agent leg (at the agent, on this card)
        k["scanagent_launches"] = scanagent["agent_launches"][k["name"]]
        # and on the server's two nodes (the true-cold HTTP /query
        # alone; the direct control's cold call beside it), the
        # cluster's first gather and both failover drills' traffic
        k["server_launches"] = {leg: r["launches"][k["name"]]
                                for leg, r in server["legs"].items()}
        k["server_direct_launches"] = {
            leg: r["direct_launches"][0][k["name"]]
            for leg, r in server["legs"].items()}
        k["cluster_launches"] = cluster["launches"][k["name"]]
        # and on the mesh phases' true-cold 1 min queries (each counted
        # from 0 around it alone), the segment mesh's cold query and the
        # multi-process global downsample
        k["mesh_launches"] = {
            f"{tag}_{leg}":
                mesh[tag]["60000"][leg]["queries"][0]["launches"][k["name"]]
            for tag in ("mesh", "mesh_decode") for leg in ("1x1", "4x2")}
        k["mesh_topk_launches"] = {
            by: r["launches"][k["name"]]
            for by, r in mesh["mesh_topk"].items()}
        k["segment_mesh_launches"] = \
            mesh["segment_mesh"]["rep0"]["launches"][k["name"]]
        k["multihost_launches"] = mesh["multihost"]["launches"][k["name"]]
        k["failover_launches"] = {f"config{c}": r["leg_launches"][k["name"]]
                                  for c, r in failover.items()}
        # and in the bench subprocesses (each counted in its process from
        # 0), per suite config (counted from 0 around it) and on the S3
        # cell's true-cold query
        k["bench_launches"] = {f"config{c}": bench[c]["launches"][k["name"]]
                               for c in ("0", "1")}
        k["suite_launches"] = {
            f"config{c}": r["launches"][k["name"]]
            for c, r in sorted({**suite, "11": rollup["result"],
                                "17": scanagent["result"],
                                **{str(c): r for c, r in failover.items()}
                                }.items(), key=lambda kv: int(kv[0]))}
        k["s3_launches"] = s3["launches"][k["name"]]
        if k["name"] == "bucket_window_partials":
            # the chunked path's shape: W = 1, 10M valid rows
            k["chunked_shape"] = {
                "ms": chunked["kernel_ms"], "bound_ms": chunked["bound_ms"],
                "plain_ms": chunked["plain_ms"],
                "library_ms": chunked["library_ms"],
                "max_abs_err": chunked["kernel_max_abs_err"]}
    phase_s["total"] = time.perf_counter() - t_start
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump({"card": card, "phase_s": phase_s,
                       "kernels": kernels, "e2e": e2e,
                       "merge_kernel": merge_k, "determinism": determinism,
                       "compaction": compaction, "wal": wal,
                       "topk_ops": topk_ops, "config4": config4,
                       "nan": nan,
                       "rollup": rollup, "chunked": chunked,
                       "scanagent": scanagent, "server": server,
                       "cluster": cluster, "mesh": mesh,
                       "bench": bench, "suite": suite, "s3": s3,
                       "merge_dedup": dedup,
                       "failover": {str(k): v for k, v in failover.items()}},
                      f,
                      indent=1)
    # every phase's seconds again, near the end where a cut log keeps them
    log(f"phase seconds: {json.dumps(phase_s)}")
    log(f"total: {time.perf_counter() - t_start!r} s")
    log(json.dumps({"kernels": kernels}))
    log(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
