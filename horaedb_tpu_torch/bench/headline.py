"""The bench.py twin's own configs on the PyTorch port.

config 1 (the default): BASELINE config #1 — single-table
`avg(value) GROUP BY time(1m)` over 10M rows, 1 tag — measured
END-TO-END through the real engine: `MetricEngine.query_downsample`
(object-store sidecar read -> merge-dedup -> downsample on the card),
cold (every cache tier cleared) and cached (device-resident windows and
the fused replay, the north-star serving mode).

config 0: the device kernel microbench — ops.downsample's
time_bucket_aggregate (the hand kernel bucket_window_partials) over the
same rows as one batch.

The CPU baseline of both is a numpy bincount aggregation of the same
rows fully in memory — conservative in the device's disfavor: it skips
the object-store read and merge the engine pays for.

Counterpart of bench.py's run_engine_headline, cpu_baseline and
run_kernel_microbench: the same rows from the same seeds, the same legs
and result keys.  Every timed query ends in a device sync; grids come
to the host after the timed window.
"""

from __future__ import annotations

import asyncio
import os
import time

import numpy as np

from horaedb_tpu_torch.bench.suite import (
    _clear_scan_tiers,
    _host,
    _log,
    _sync,
    resolve_device,
)


# ---------------------------------------------------------------------------
# config 1 (default): end-to-end MetricEngine.query_downsample
# ---------------------------------------------------------------------------


def run_engine_headline(rows: int, iters: int, device="cuda") -> dict:
    import pyarrow as pa

    from horaedb_tpu_torch.common.error import Error, ensure
    from horaedb_tpu_torch.metric_engine import MetricEngine
    from horaedb_tpu_torch.metric_engine.types import Label, tsid_of
    from horaedb_tpu_torch.objstore import MemoryObjectStore
    from horaedb_tpu_torch.ops.encode import h2d_bytes
    from horaedb_tpu_torch.storage.config import StorageConfig, from_dict
    from horaedb_tpu_torch.storage.read import (
        _REPLAY_HITS,
        _REPLAY_SLOTS,
        plan_stage_snapshot,
    )
    from horaedb_tpu_torch.storage.types import TimeRange

    dev = resolve_device(device)
    # BENCH_HOSTS scales CARDINALITY: the query window must fit int32
    # ms offsets (~24.8 days), so beyond ~20M rows the ladder grows
    # hosts at a fixed tick count instead of growing the time span
    hosts = int(os.environ.get("BENCH_HOSTS", 100))
    interval = 10_000  # 10s scrape
    bucket_ms = 60_000
    per_host = max(1, rows // hosts)
    span = per_host * interval
    ensure(span < 2**31, "query window must fit int32 offsets — raise "
                         "BENCH_HOSTS to scale by cardinality instead")
    num_buckets = -(-span // bucket_ms)
    segment_ms = 2 * 3600 * 1000  # reference default segment duration
    T0 = (1_700_000_000_000 // segment_ms) * segment_ms

    # time-major TSBS-like layout: every 10s tick reports all hosts
    rng = np.random.default_rng(0)
    n = per_host * hosts
    ts = T0 + np.repeat(np.arange(per_host, dtype=np.int64) * interval, hosts)
    host_id = np.tile(np.arange(hosts, dtype=np.int32), per_host)
    vals = (rng.random(n) * 100).astype(np.float64)
    names = pa.array([f"host_{i:03d}" for i in range(hosts)])
    _log(f"engine headline: {n:,} rows, {hosts} hosts x {num_buckets} "
         f"buckets, {span // segment_ms + 1} segments, on {dev}")

    # ---- CPU baseline: numpy aggregate of the same rows, in memory ----
    # its trials INTERLEAVE with the engine's cached queries so both legs
    # see the same scheduler conditions (paired trials)
    ts_off = ts - T0
    cell = host_id.astype(np.int64) * num_buckets + ts_off // bucket_ms
    ncells = hosts * num_buckets

    def cpu_run():
        counts = np.bincount(cell, minlength=ncells)
        sums = np.bincount(cell, weights=vals, minlength=ncells)
        with np.errstate(invalid="ignore"):
            return sums / counts, counts

    ingest_box: dict = {}

    async def setup() -> MetricEngine:
        scan_cfg = {"cache_max_rows": rows * 4}
        # A/B knob: windows per aggregation round (default 16)
        if os.environ.get("BENCH_AGG_WINDOWS"):
            scan_cfg["agg_batch_windows"] = int(
                os.environ["BENCH_AGG_WINDOWS"])
        cfg = from_dict(StorageConfig, {
            "scheduler": {"schedule_interval": "1h"},
            # cache must hold every segment's windows for the cached
            # (device-resident) number to mean anything at this row count
            "scan": scan_cfg,
        })
        e = await MetricEngine.open("bench", MemoryObjectStore(),
                                    segment_ms=segment_ms, config=cfg,
                                    device=dev)
        t0 = time.perf_counter()
        # chunked, time-contiguous ingest: each chunk touches few segments
        chunk = max(1, 1_000_000 // hosts) * hosts
        for lo in range(0, n, chunk):
            hi = min(n, lo + chunk)
            batch = pa.record_batch({
                "host": pa.DictionaryArray.from_arrays(
                    pa.array(host_id[lo:hi]), names),
                "timestamp": pa.array(ts[lo:hi], type=pa.int64()),
                "value": pa.array(vals[lo:hi], type=pa.float64()),
            })
            for attempt in range(5):
                try:
                    await e.write_arrow("cpu", ["host"], batch)
                    break
                except Error:
                    # manifest delta backpressure (hard threshold): what a
                    # real writer does — force the fold, retry the chunk.
                    # Duplicate rows from the partial write are deduped by
                    # (tsid, ts) last-wins, so the retry is idempotent.
                    _log(f"write backpressure (attempt {attempt}); "
                         "folding manifest deltas")
                    await e.tables["data"].manifest.trigger_merge()
            else:
                raise Error("ingest failed after 5 backpressure retries")
        ingest_box["s"] = time.perf_counter() - t0
        _log(f"ingest: {n:,} rows in {ingest_box['s']:.1f}s")
        return e

    async def query(e: MetricEngine, lo: int = T0, hi: int = T0 + span):
        out = await e.query_downsample(
            "cpu", [], TimeRange.new(lo, hi), bucket_ms=bucket_ms,
            aggs=("avg",))  # the workload is avg GROUP BY time
        _sync(dev)
        return out

    async def bench(e: MetricEngine):
        t0 = time.perf_counter()
        out = await query(e)  # first full read (kernel load)
        compile_s = time.perf_counter() - t0

        cold_times = []
        stage_profile = {}
        cold = {}
        for i in range(max(2, iters // 5)):
            _clear_scan_tiers(e.tables["data"])
            before = plan_stage_snapshot()
            replays0, h2d0 = _REPLAY_HITS.value, h2d_bytes()
            t0 = time.perf_counter()
            out = await query(e)
            cold_times.append(time.perf_counter() - t0)
            if i == 0:
                after = plan_stage_snapshot()
                stage_profile = {
                    k: round(after[k] - before[k], 3)
                    for k in after if after[k] != before[k]}
                cold = {"replay_hits": int(_REPLAY_HITS.value - replays0),
                        "h2d_bytes": h2d_bytes() - h2d0}
        # true cold means cold: nothing replayed, the columns uploaded
        ensure(cold["replay_hits"] == 0,
               "engine headline: the cold query was a replay hit")
        ensure(cold["h2d_bytes"] > 0,
               "engine headline: the cold query uploaded nothing")

        cached_times = []
        base_times = []
        replays0, h2d0 = _REPLAY_HITS.value, h2d_bytes()
        for _ in range(iters):
            t0 = time.perf_counter()
            out = await query(e)
            cached_times.append(time.perf_counter() - t0)
            # paired baseline trial under the same scheduler conditions
            t0 = time.perf_counter()
            cpu_run()
            base_times.append(time.perf_counter() - t0)
        cached = {"replay_hits": int(_REPLAY_HITS.value - replays0),
                  "h2d_bytes": h2d_bytes() - h2d0}

        # varied-load leg: rotating half-span windows (bucket-aligned,
        # TSBS-style "random range" shape).  12 distinct ranges exceed
        # the 8-slot fused-replay LRU, so plan-level replay cannot serve
        # ANY of these — they measure the steady-state engine under
        # realistic non-identical queries (the scan cache still holds
        # the windows; stacks re-stack from per-window device columns)
        half = (span // 2 // bucket_ms) * bucket_ms
        step = max(bucket_ms, (span - half) // 11 // bucket_ms * bucket_ms)
        starts = [T0 + i * step for i in range(12)
                  if T0 + i * step + half <= T0 + span]

        varied_p50 = None
        if half == 0:
            # tiny --rows: a zero-length range would time empty scans
            _log("varied leg skipped: span too small for a half-span "
                 "bucket-aligned window")
        else:
            if len(starts) <= _REPLAY_SLOTS:
                # the ranges would fit the replay LRU and the "no
                # replay" label would lie — flag it
                _log(f"varied leg: only {len(starts)} distinct ranges "
                     f"(<= {_REPLAY_SLOTS} replay slots); number may "
                     "include replay hits")
            varied_times = []
            for i in range(max(iters, 2 * len(starts))):
                s = starts[i % len(starts)]
                t0 = time.perf_counter()
                await query(e, s, s + half)
                varied_times.append(time.perf_counter() - t0)
            # steady state: every range visited once before timing
            steady = varied_times[len(starts):] or varied_times
            varied_p50 = float(np.percentile(steady, 50))
        return (out, compile_s, float(np.percentile(cold_times, 50)),
                float(np.percentile(cached_times, 50)), varied_p50,
                stage_profile, cached_times, base_times, cold, cached)

    async def main_async():
        e = await setup()
        try:
            return await bench(e)
        finally:
            await e.close()

    (out, compile_s, cold_p50, cached_p50, varied_p50, stage_profile,
     cached_times, base_times, cold, cached) = asyncio.run(main_async())
    _log(f"first query: {compile_s:.1f}s")
    _log(f"cold stage profile: {stage_profile}")
    _log(f"cold p50 (sidecar read -> merge -> downsample): "
         f"{cold_p50 * 1e3:.1f} ms ({n / cold_p50 / 1e6:.0f}M rows/s)")
    _log(f"cached p50 (device-resident windows): {cached_p50 * 1e3:.1f} ms "
         f"({n / cached_p50 / 1e6:.0f}M rows/s/card)")
    if varied_p50 is not None:
        _log(f"varied p50 (rotating half-span ranges, no replay): "
             f"{varied_p50 * 1e3:.1f} ms")

    # paired per-trial ratios: engine trial i over the baseline trial
    # run right after it
    ratios = np.array(cached_times) / np.array(base_times)
    vs_baseline = float(np.percentile(ratios, 50))
    iqr = (float(np.percentile(ratios, 25)),
           float(np.percentile(ratios, 75)))
    cpu_p50 = float(np.percentile(base_times, 50))
    ref_avg, ref_counts = cpu_run()
    _log(f"cpu baseline p50 (in-memory, interleaved): "
         f"{cpu_p50 * 1e3:.2f} ms ({n / cpu_p50 / 1e6:.0f}M rows/s)")
    _log(f"paired vs_baseline: p50 {vs_baseline:.3f}, "
         f"IQR [{iqr[0]:.3f}, {iqr[1]:.3f}]")

    # ---- cross-check the engine's grids against numpy -----------------
    tsid_by_host = np.array(
        [tsid_of("cpu", [Label("host", f"host_{i:03d}")])
         for i in range(hosts)], dtype=np.uint64)
    order = {int(t): i for i, t in enumerate(out["tsids"])}
    assert len(order) == hosts, f"expected {hosts} series, got {len(order)}"
    perm = np.array([order[int(t)] for t in tsid_by_host])
    got_counts = _host(out["aggs"]["count"])[perm]
    np.testing.assert_array_equal(got_counts.reshape(-1),
                                  ref_counts.astype(got_counts.dtype))
    occ = ref_counts.reshape(hosts, num_buckets) > 0
    got_avg = _host(out["aggs"]["avg"]).astype(np.float64)[perm]
    np.testing.assert_allclose(got_avg[occ],
                               ref_avg.reshape(hosts, num_buckets)[occ],
                               rtol=2e-4)

    return {
        "metric": (f"end-to-end avg GROUP BY time(1m) via "
                   f"MetricEngine.query_downsample, {n / 1e6:.1f}M rows, "
                   f"p50 (cached)"),
        "value": round(cached_p50 * 1e3, 3),
        "unit": "ms",
        # median of PAIRED per-trial ratios (engine/baseline interleaved)
        "vs_baseline": round(vs_baseline, 4),
        "vs_baseline_iqr": [round(iqr[0], 4), round(iqr[1], 4)],
        "cold_p50_ms": round(cold_p50 * 1e3, 3),
        "cold_vs_baseline": round(cold_p50 / cpu_p50, 4),
        # rotating half-span ranges (12 distinct specs > the 8-slot
        # replay LRU): the realistic varied-load number; ~half the rows
        # per query.  None when the span is too small.
        "varied_p50_ms": (None if varied_p50 is None
                          else round(varied_p50 * 1e3, 3)),
        "cpu_baseline_p50_ms": round(cpu_p50 * 1e3, 3),
        "compile_first_s": round(compile_s, 2),
        "rows": n,
        # the BASELINE metric is "rows scanned/sec/chip"
        "rows_per_s_cached": round(n / cached_p50),
        "rows_per_s_cold": round(n / cold_p50),
        "ingest_s": round(ingest_box.get("s", 0.0), 1),
        # per-plan-stage attribution of one cold query (seconds/rows/
        # bytes deltas from the scan_stage_* registry metrics)
        "stage_profile": stage_profile,
        # the first cold query's replay hits (0) and upload, and the
        # cached loop's (one replay hit a query on the fused route)
        "cold_replay_hits": cold["replay_hits"],
        "cold_h2d_bytes": cold["h2d_bytes"],
        "cached_queries": len(cached_times),
        "cached_replay_hits": cached["replay_hits"],
        "cached_h2d_bytes": cached["h2d_bytes"],
    }


# ---------------------------------------------------------------------------
# config 0: device kernel microbench (kernel-level regression tracking;
# NOT the headline number)
# ---------------------------------------------------------------------------


def cpu_baseline(ts_off, gid, vals, bucket_ms, num_groups, num_buckets, iters):
    """numpy: avg per (group, minute-bucket) via bincount."""
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        bucket = ts_off // bucket_ms
        cell = gid.astype(np.int64) * num_buckets + bucket
        sums = np.bincount(cell, weights=vals, minlength=num_groups * num_buckets)
        counts = np.bincount(cell, minlength=num_groups * num_buckets)
        with np.errstate(invalid="ignore"):
            avg = sums / counts
        avg.sum()  # force materialization
        times.append(time.perf_counter() - t0)
    return float(np.percentile(times, 50))


def run_kernel_microbench(rows: int, iters: int, device="cuda") -> dict:
    from horaedb_tpu_torch.bench.tsbs import TsbsConfig, generate_cpu_arrays
    from horaedb_tpu_torch.common.error import ensure
    from horaedb_tpu_torch.ops.downsample import time_bucket_aggregate
    from horaedb_tpu_torch.ops.encode import to_device

    dev = resolve_device(device)
    # 100 hosts, 1 field, span sized to produce `rows` points
    interval = 10_000
    num_hosts = 100
    span = (rows // num_hosts) * interval
    cfg = TsbsConfig(num_hosts=num_hosts, num_fields=1, interval_ms=interval,
                     span_ms=span)
    t0 = time.perf_counter()
    cols = generate_cpu_arrays(cfg)
    n = len(cols["ts"])
    bucket_ms = 60_000
    num_buckets = -(-span // bucket_ms)
    ts_off = (cols["ts"] - cfg.start_ms).astype(np.int64)
    gid = cols["host_id"]
    vals = cols["usage_user"].astype(np.float32)
    _log(f"generated {n:,} rows in {time.perf_counter()-t0:.1f}s; "
         f"{num_hosts} hosts x {num_buckets} buckets")

    cpu_p50 = cpu_baseline(ts_off, gid, vals.astype(np.float64), bucket_ms,
                           num_hosts, num_buckets, max(3, iters // 4))
    _log(f"cpu baseline p50: {cpu_p50*1e3:.2f} ms "
         f"({n/cpu_p50/1e6:.0f}M rows/s)")
    _log(f"device: {dev}")

    ensure(ts_off.max() < 2**31, "ts offsets must fit int32")
    cap = 1 << (n - 1).bit_length()
    pad = lambda a, d: np.pad(a.astype(d), (0, cap - n))
    d_ts = to_device(pad(ts_off, np.int32), dev)
    d_gid = to_device(pad(gid, np.int32), dev)
    d_vals = to_device(pad(vals, np.float32), dev)

    # the workload is avg GROUP BY time: compute only what it needs
    # (count rides along for the cross-check)
    which = ("avg", "count")

    def run():
        out = time_bucket_aggregate(d_ts, d_gid, d_vals, n, bucket_ms,
                                    num_groups=num_hosts,
                                    num_buckets=num_buckets, which=which,
                                    device=dev)
        _sync(dev)
        return out

    t0 = time.perf_counter()
    out = run()
    _log(f"first run (kernel load): {time.perf_counter()-t0:.1f}s")

    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = run()
        times.append(time.perf_counter() - t0)
    dev_p50 = float(np.percentile(times, 50))
    _log(f"device p50: {dev_p50*1e3:.2f} ms ({n/dev_p50/1e6:.0f}M rows/s/card)")

    # sanity: the timed kernel's counts AND averages must match numpy
    bucket = ts_off // bucket_ms
    cell = gid.astype(np.int64) * num_buckets + bucket
    counts = np.bincount(cell, minlength=num_hosts * num_buckets)
    sums = np.bincount(cell, weights=vals.astype(np.float64),
                       minlength=num_hosts * num_buckets)
    got_count = _host(out["count"])
    assert int(got_count.sum()) == n
    np.testing.assert_array_equal(got_count.reshape(-1), counts)
    occupied = counts > 0
    np.testing.assert_allclose(
        _host(out["avg"]).astype(np.float64).reshape(-1)[occupied],
        (sums / np.maximum(counts, 1))[occupied], rtol=2e-4)

    return {
        "metric": (f"device kernel: avg GROUP BY time(1m), "
                   f"{n/1e6:.1f}M rows, p50"),
        "value": round(dev_p50 * 1e3, 3),
        "unit": "ms",
        "vs_baseline": round(dev_p50 / cpu_p50, 4),
    }
