#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (horaedb_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py [--rows N] [--json PATH]

Phases, each printed as it runs; any failure exits non-zero and prints
no result line:

1. device: find the card, print `nvidia-smi` name and power limit.
2. build: compile every kernel of the main path with nvcc (sm_90a).
3. kernel: each kernel against its plain PyTorch version on the card,
   at the main path's shapes plus edge cases, with times (CUDA events),
   the bound, and a one-call PyTorch yardstick.
4. end to end: the north-star workload (BASELINE config 1 of bench.py:
   10M rows, 100 hosts, 10 s scrape, 1 m buckets, 2 h segments, an
   in-memory object store, 1M-row write chunks) through
   MetricEngine.write_arrow and query_downsample(aggs=("avg",)), once
   cold and 5 times cached, checked against a numpy bincount of the
   same rows; the kernel's launch count over that run must equal the
   fused rounds it ran.
5. a JSON line of per-kernel numbers, the card line again, and the last
   line {"ok": true, "device": {...}}.

Needs one CUDA card; a missing card is a failure, never a CPU run.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import math
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM published memory rate

ALL_AGGS = ("count", "sum", "min", "max", "avg", "last")


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
    """Median per-call time of `fn` on the card, one event pair per call."""
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


def compare(got: dict, ref: dict, what: str) -> float:
    """count/min/max/last/last_ts exact, sum within rtol 1e-5; returns
    the largest absolute difference (inf == inf counts as 0)."""
    import torch

    if set(got) != set(ref):
        raise AssertionError(f"{what}: fields {sorted(got)} != {sorted(ref)}")
    worst = 0.0
    for f in ref:
        a, b = got[f].cpu(), ref[f].cpu()
        if f == "sum":
            ok = torch.allclose(a, b, rtol=1e-5, atol=0.0)
        else:
            ok = torch.equal(a, b)
        if not ok:
            raise AssertionError(f"{what}: field {f} disagrees with plain")
        d = (a.double() - b.double()).abs()
        d = torch.where(torch.isnan(d), torch.zeros_like(d), d)
        worst = max(worst, float(d.max()) if d.numel() else 0.0)
    return worst


def kernel_phase(ba) -> dict:
    """bucket_window_partials against its plain version on the card."""
    import numpy as np
    import torch

    W, cap, G, width = 16, 131072, 128, 128
    bms, total = 60_000, 150
    rng = np.random.default_rng(0)
    ts = rng.integers(-2 * bms, 140 * bms, (W, cap)).astype(np.int32)
    gid = rng.integers(-1, 110, (W, cap)).astype(np.int32)
    vals = (rng.random((W, cap)) * 100).astype(np.float32)
    # duplicate max-ts rows across the kernel's 2048-row block boundary
    # (and a plain cell-internal run): the later row must win
    ts[:, 2040:2060] = 7 * bms + 5
    gid[:, 2040:2060] = 3
    remap = np.stack([rng.permutation(G).astype(np.int32)
                      for _ in range(W)])
    shift = rng.integers(-bms, bms, W).astype(np.int32)
    lo = rng.integers(0, 30, W).astype(np.int32)
    dev = torch.device("cuda")
    d = lambda a: torch.from_numpy(a).to(dev)
    args = [d(ts), d(gid), d(vals), d(remap), d(shift), d(lo), total, bms]
    worst = 0.0
    for which in (ALL_AGGS, ("avg",)):
        got = ba.bucket_window_partials(*args, num_groups=G, width=width,
                                        which=which)
        torch.cuda.synchronize()
        ref = ba.bucket_window_partials_plain(*args, num_groups=G,
                                              width=width, which=which)
        worst = max(worst, compare(got, ref, f"main shape {which}"))
    # edge cases: identity remap with gids past the grid (and -1 and a
    # huge one that would overflow gid*width), rows past n_valid, rows
    # past the total bucket count, negative local offsets
    e_ts = rng.integers(-3 * bms, 40 * bms, (2, 4096)).astype(np.int32)
    e_gid = rng.integers(-1, G + 6, (2, 4096)).astype(np.int32)
    e_gid[0, 7] = 2**30
    e_vals = (rng.random((2, 4096)) * 10).astype(np.float32)
    for n_valid in (4096, 3000):
        e_args = [d(e_ts), d(e_gid), d(e_vals), None,
                  d(np.array([5, -bms], np.int32)),
                  d(np.array([0, 3], np.int32)), 30, bms]
        got = ba.bucket_window_partials(*e_args, num_groups=G, width=32,
                                        which=ALL_AGGS, n_valid=n_valid)
        ref = ba.bucket_window_partials_plain(*e_args, num_groups=G,
                                              width=32, which=ALL_AGGS,
                                              n_valid=n_valid)
        worst = max(worst, compare(got, ref, f"edge n_valid={n_valid}"))
    log(f"kernel: bucket_window_partials matches plain "
        f"(max_abs_err {worst!r})")

    # times at the main path's round shape and aggregate set (avg)
    which = ("avg",)
    ms = cuda_ms(lambda: ba.bucket_window_partials(
        *args, num_groups=G, width=width, which=which), reps=30)
    ms_all = cuda_ms(lambda: ba.bucket_window_partials(
        *args, num_groups=G, width=width, which=ALL_AGGS), reps=30)
    plain_ms = cuda_ms(lambda: ba.bucket_window_partials_plain(
        *args, num_groups=G, width=width, which=which), reps=10, warmup=2)
    # yardstick: one index_add_ folding (count, value) pairs into
    # precomputed flat cells (the prologue is not part of the call)
    g_t = torch.where(args[1] >= 0, torch.gather(
        args[3], 1, args[1].clamp(0, G - 1).long()),
        torch.full_like(args[1], -1))
    tg = args[0] + args[4][:, None]
    g_t = torch.where(torch.div(tg, bms, rounding_mode="floor") < total,
                      g_t, torch.full_like(g_t, -1))
    b_t = torch.div(tg - args[5][:, None] * bms, bms, rounding_mode="floor")
    ok = (g_t >= 0) & (g_t < G) & (b_t >= 0) & (b_t < width)
    ncell = G * width
    flat = (torch.arange(W, device=dev)[:, None] * (ncell + 1)
            + torch.where(ok, g_t.long() * width + b_t.long(),
                          torch.full_like(b_t, ncell, dtype=torch.int64))
            ).reshape(-1)
    pairs = torch.stack([torch.ones_like(args[2]).reshape(-1),
                         args[2].reshape(-1)], dim=1)
    library_ms = cuda_ms(lambda: torch.zeros(
        W * (ncell + 1), 2, device=dev).index_add_(0, flat, pairs), reps=30)
    nfields = len(ba.fields_for(which))
    in_bytes = W * cap * 12 + W * G * 4 + W * 8
    out_bytes = W * G * width * 4 * nfields
    bound_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    log(f"kernel: W={W} cap={cap} G={G} width={width} which={which}: "
        f"{ms:.4f} ms (all aggs {ms_all:.4f} ms), plain {plain_ms:.4f} ms, "
        f"index_add_ yardstick {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({in_bytes + out_bytes} bytes)")
    return {"name": "bucket_window_partials", "route": "cuda",
            "source": "horaedb_tpu_torch/csrc/bucket_agg.cu",
            "replaces": "horaedb_tpu/ops/pallas_kernels.py:48",
            "launches": 0, "max_abs_err": worst, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes", "library_ms": library_ms,
            "ms_all_aggs": ms_all}


async def end_to_end(rows: int, ba) -> dict:
    """BASELINE config 1 through the port's public entry points."""
    import numpy as np
    import pyarrow as pa
    import torch

    from horaedb_tpu_torch.common.error import Error
    from horaedb_tpu_torch.metric_engine import MetricEngine
    from horaedb_tpu_torch.metric_engine.types import Label, tsid_of
    from horaedb_tpu_torch.objstore import MemoryObjectStore
    from horaedb_tpu_torch.storage.config import StorageConfig, from_dict
    from horaedb_tpu_torch.storage.types import TimeRange

    hosts, interval, bucket_ms = 100, 10_000, 60_000
    per_host = max(1, rows // hosts)
    span = per_host * interval
    assert span < 2**31, "query window must fit int32 offsets"
    num_buckets = -(-span // bucket_ms)
    segment_ms = 2 * 3600 * 1000
    T0 = (1_700_000_000_000 // segment_ms) * segment_ms
    rng = np.random.default_rng(0)
    n = per_host * hosts
    ts = T0 + np.repeat(np.arange(per_host, dtype=np.int64) * interval,
                        hosts)
    host_id = np.tile(np.arange(hosts, dtype=np.int32), per_host)
    vals = (rng.random(n) * 100).astype(np.float64)
    names = pa.array([f"host_{i:03d}" for i in range(hosts)])
    log(f"e2e: {n:,} rows, {hosts} hosts x {num_buckets} buckets, "
        f"{span // segment_ms + 1} segments")

    cfg = from_dict(StorageConfig, {
        "scheduler": {"schedule_interval": "1h"},
        "scan": {"cache_max_rows": rows * 4}})
    torch.cuda.reset_peak_memory_stats()
    e = await MetricEngine.open("bench", MemoryObjectStore(),
                                segment_ms=segment_ms, config=cfg)
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

        rng_q = TimeRange.new(T0, T0 + span)

        async def query():
            out = await e.query_downsample("cpu", [], rng_q,
                                           bucket_ms=bucket_ms,
                                           aggs=("avg",))
            torch.cuda.synchronize()
            return out

        reader = e.tables["data"].reader
        reader.scan_cache.clear()
        from horaedb_tpu_torch.ops.encode import h2d_bytes
        from horaedb_tpu_torch.utils import registry

        def stages(before: dict) -> dict:
            # per-stage wall seconds (and host-to-device bytes) of a
            # query, from the registry's cumulative histograms
            now = registry.snapshot()
            return {k.split(":", 1)[1]: now[k] - before.get(k, 0.0)
                    for k in now if k.startswith("scan_stage_seconds:")}

        # the main path's run: launch counts from 0, read right after
        ba.reset_launches()
        snap, h2d0 = registry.snapshot(), h2d_bytes()
        t0 = time.perf_counter()
        out = await query()
        cold_s = time.perf_counter() - t0
        cold_stages = stages(snap)
        cold_h2d = h2d_bytes() - h2d0
        cached = []
        for _ in range(5):
            snap, h2d0 = registry.snapshot(), h2d_bytes()
            t0 = time.perf_counter()
            out = await query()
            cached.append(time.perf_counter() - t0)
        cached_stages = stages(snap)
        cached_h2d = h2d_bytes() - h2d0
        launches = ba.LAUNCHES["bucket_window_partials"]
        windows = sum(len(ws) for ws in reader.scan_cache.values())
        per_query = math.ceil(windows / cfg.scan.agg_batch_windows)
        if launches == 0 or launches != 6 * per_query:
            raise AssertionError(
                f"kernel launches {launches} != 6 queries x {per_query} "
                f"rounds ({windows} windows)")

        # correctness: numpy bincount of the same rows
        cell = host_id.astype(np.int64) * num_buckets + (ts - T0) // bucket_ms
        counts = np.bincount(cell, minlength=hosts * num_buckets).reshape(
            hosts, num_buckets)
        sums = np.bincount(cell, weights=vals,
                           minlength=hosts * num_buckets).reshape(
            hosts, num_buckets)
        tsid_of_host = np.array([tsid_of("cpu", [Label("host", f"host_{i:03d}")])
                                 for i in range(hosts)], dtype=np.uint64)
        order = np.argsort(tsid_of_host)
        if out["tsids"] != [int(t) for t in tsid_of_host[order]]:
            raise AssertionError("e2e: tsids differ from the written series")
        got_count = out["aggs"]["count"].cpu().numpy()
        got_avg = out["aggs"]["avg"].cpu().numpy()
        if got_count.shape != (hosts, num_buckets):
            raise AssertionError(f"e2e: grid shape {got_count.shape}")
        if not np.array_equal(got_count, counts[order].astype(np.float32)):
            raise AssertionError("e2e: count grid differs from bincount")
        occ = counts[order] > 0
        with np.errstate(invalid="ignore"):
            want_avg = sums[order] / counts[order]
        if not np.isfinite(got_avg[occ]).all() \
                or not np.isnan(got_avg[~occ]).all():
            raise AssertionError("e2e: avg has non-finite occupied cells "
                                 "or non-NaN empty cells")
        np.testing.assert_allclose(got_avg[occ], want_avg[occ], rtol=1e-5)
        cached_p50 = statistics.median(cached)
        res = {"rows": n, "ingest_s": ingest_s, "cold_ms": cold_s * 1e3,
               "cached_p50_ms": cached_p50 * 1e3,
               "cached_ms": [c * 1e3 for c in cached],
               "cold_rows_per_s": n / cold_s,
               "cached_rows_per_s": n / cached_p50,
               "windows": windows, "rounds_per_query": per_query,
               "cold_stage_s": cold_stages, "cold_h2d_bytes": cold_h2d,
               "last_cached_stage_s": cached_stages,
               "last_cached_h2d_bytes": cached_h2d,
               "launches": launches,
               "max_memory_allocated": torch.cuda.max_memory_allocated()}
        log("e2e: grids match the numpy bincount (count exact, avg rtol "
            "1e-5); " + json.dumps(res))
        return res
    finally:
        await e.close()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=10_000_000,
                    help="rows of the end-to-end phase (a cut is printed)")
    ap.add_argument("--json", default=None,
                    help="also write every number of the run to this file")
    args = ap.parse_args()

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
    from horaedb_tpu_torch.ops import bucket_agg as ba

    t0 = time.perf_counter()
    ba.build()
    log(f"build: bucket_agg.cu in {time.perf_counter() - t0!r} s")
    for line in ba.build_log().splitlines():
        if "registers" in line or "spill" in line:
            log(f"build: {line.strip()}")

    kern = kernel_phase(ba)
    e2e = asyncio.run(end_to_end(args.rows, ba))
    kern["launches"] = e2e["launches"]
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump({"card": card, "kernels": [kern], "e2e": e2e}, f,
                      indent=1)
    log(json.dumps({"kernels": [kern]}))
    log(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
