"""The BASELINE benchmark configs (BASELINE.md) on the PyTorch port:

  1. single-table avg GROUP BY time(1m)   -> python -m horaedb_tpu_torch.bench
  2. TSBS cpu-only, WHERE host=? + range, min/max/avg downsample
  3. TSBS devops-100, 10 fields, tag filter + GROUP BY host, time(5m)
  4. multi-SST merge-scan: top-k hosts by max(cpu) across 64 SSTs
  5. compaction rollup: 1s -> 1h over 30d, all aggregators, write-back
  6. manifest snapshot codec (the reference's own criterion benchmark)
  7. mixed read/write: varied downsample queries under sustained write
     load + compaction churn (vs_baseline here is mixed_p50/quiet_p50 —
     query latency degradation under churn, 1.0 = churn-proof)
  8. durable ingest: acked writes/s + p99 ack, WAL on/off sweep
  9. tiered scan-cache cold ladder (cached/post-flush/hbm-evicted/
     tier2-cold/true-cold/tier2-off)
 10. query-tracing overhead A/B: off vs unsampled vs fully-traced on
     the cached path (vs_baseline = on_p50/off_p50, bar < 1.02)
 11. the dashboard mix served from standing rollups vs raw cold
 12. the background plane's overhead (watchdog, op traces, meta-ingest)
 13. the cold-scan pipeline ladder over a 25 ms store
 14. the sparse combine, the top-k cell bound, the range-refine memo
 15. tenant isolation under an open-loop overload, over HTTP
 16. device decode against host decode
 17. near-data scan agents
 18. the memory ledger's accuracy and overhead
 19. the 2-D mesh scan against the single-device control
 20. failover: the harness promotes the follower
 21. failover: a standby monitor elects and promotes itself
 22. the mesh-placed device decode, the additive top-k bound
 23. the device profiler's cost and attribution

Counterpart of horaedb_tpu/bench/suite.py, configs 2-23: the same data
from the same seeds, the same legs and the same result keys.  Each
run_configN(rows, iters, device="cuda") returns {metric, value, unit,
vs_baseline, ...} (vs_baseline is device_p50 / cpu_p50 for configs 2-6,
lower is better; from config 7 on each config says what its ratio is);
it runs on the card and raises without one unless the caller passes
device="cpu".  Every timed call ends in a device sync, so a number
times the work, not its launch; grids come to the host after the timed
window, except where the window times the download itself (config 5's
write-back).  Configs 11-23 also take `detail=`, a dict they fill with
what the port adds to the reference's result (each leg's kernel
launches, the route each leg took, the control legs of the route-aware
checks), so the result keeps the reference's keys.

CLI: python -m horaedb_tpu_torch.bench.suite --config N (2-23)
     [--rows N] [--iters K] [--device cuda|cpu] [--scratch-dir DIR]
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Optional

import numpy as np

def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def resolve_device(device):
    """The bench's torch device: the card unless the caller asks for the
    CPU; asking for the card without one raises."""
    import torch

    from horaedb_tpu_torch.common.error import Error

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise Error("the bench needs a CUDA device and none is available; "
                    "pass --device cpu (device='cpu') to run on the CPU")
    return dev


def card_line() -> str:
    """`nvidia-smi`'s name and power limit of the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def provenance(device="cuda") -> dict:
    """Backend identity for result lines — a CPU number must never
    masquerade as a device number.  `fallback` is true whenever the run
    did NOT execute on the card, deliberate CPU runs included."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return {"backend": "cuda", "card": card_line(), "fallback": False}
    return {"backend": dev.type, "fallback": True}


def _sync(dev) -> None:
    """Wait for the card: a timed call ends here."""
    if dev.type == "cuda":
        import torch

        torch.cuda.synchronize(dev)


def _host(v) -> np.ndarray:
    """A grid (tensor on any device, or numpy) as a host numpy array."""
    if isinstance(v, np.ndarray):
        return v
    from horaedb_tpu_torch.common import deviceprof

    return deviceprof.download(v)


def _clear_scan_tiers(table) -> None:
    """TRUE-cold reset for engine legs: drop the device state derived
    from cached windows (stacks, fused replays, per-window device
    memos), tier-1 windows AND tier-2 host-RAM encoded parts —
    write-through admission would otherwise serve a 'cold' query from
    RAM and the leg would silently measure the tier-2 path instead
    (config 9 measures the tiers explicitly).  The parts memo is a
    further serving tier with the same hazard."""
    table.reader.drop_hbm_state()
    table.reader.scan_cache.clear()
    table.reader.encoded_cache.clear()
    table.reader.parts_memo.clear()


def _p50(fn, iters: int) -> float:
    """Median wall seconds of `fn`; a device leg's `fn` ends in _sync."""
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return float(np.percentile(times, 50))


def _pad_pow2(a: np.ndarray, dtype) -> np.ndarray:
    # same capacity rule as the engine's encode path — benches launch the
    # kernels at the shapes the engine uses
    from horaedb_tpu_torch.ops.encode import pad_capacity

    n = len(a)
    return np.pad(a.astype(dtype), (0, pad_capacity(n) - n))


def _check_i32_span(ts_off: np.ndarray, what: str) -> None:
    from horaedb_tpu_torch.common.error import ensure

    ensure(int(ts_off.max(initial=0)) < 2**31,
           f"{what}: ts offsets exceed int32 — lower --rows (the device "
           "path buckets int32 offsets; larger spans must be segmented)")


def _host_record_batch(names, host_id: np.ndarray, ts: np.ndarray,
                       values: np.ndarray):
    """The engine-leg ingest batch shape shared by configs 3 and 7:
    dictionary-encoded host tag + int64 timestamps + float64 values."""
    import pyarrow as pa

    return pa.record_batch({
        "host": pa.DictionaryArray.from_arrays(
            pa.array(host_id.astype(np.int32)), names),
        "timestamp": pa.array(ts, type=pa.int64()),
        "value": pa.array(values.astype(np.float64)),
    })


def _scratch(tag: str, scratch_dir: Optional[str]) -> str:
    """A fresh directory for an on-disk store or WAL (removed by the
    caller), under `scratch_dir` (None: the system's temporary
    directory)."""
    return tempfile.mkdtemp(prefix=f".wal_smoke_{tag}_", dir=scratch_dir)


# ---------------------------------------------------------------------------
# config 2: single-host filter + min/max/avg downsample
# ---------------------------------------------------------------------------


def run_config2(rows: int, iters: int, device="cuda",
                scratch_dir: Optional[str] = None) -> dict:
    import torch

    from horaedb_tpu_torch.bench.tsbs import TsbsConfig, generate_cpu_arrays
    from horaedb_tpu_torch.ops.downsample import time_bucket_aggregate
    from horaedb_tpu_torch.ops.encode import to_device

    dev = resolve_device(device)
    hosts = 100
    interval = 10_000
    cfg = TsbsConfig(num_hosts=hosts, num_fields=3, interval_ms=interval,
                     span_ms=(rows // hosts) * interval)
    cols = generate_cpu_arrays(cfg, shuffle=True)
    n = len(cols["ts"])
    target_host = 42
    # query window: middle half of the span
    q_start = cfg.start_ms + cfg.span_ms // 4
    q_end = q_start + cfg.span_ms // 2
    bucket = 60_000
    num_buckets = -(-(q_end - q_start) // bucket)

    ts_off = cols["ts"] - q_start
    _check_i32_span(ts_off, "config2")
    in_range = (ts_off >= 0) & (ts_off < (q_end - q_start))
    is_host = cols["host_id"] == target_host
    vals = cols["usage_user"].astype(np.float32)

    # WHERE host=? is a PK predicate: the engine pushes it into the
    # Parquet read, so the device only ever sees matching rows.  The
    # timed step models that: host-side selection (the pushdown's role)
    # + ONE coalesced upload (ts + the f32 values' bits in a (2, cap)
    # int32 tensor: per-transfer latency, not bytes, dominates small
    # uploads) + downsample of the selected rows on the card.
    def device_run():
        m = is_host & in_range
        sel_ts = ts_off[m].astype(np.int32)
        sel_vals = vals[m]
        k = len(sel_ts)
        packed = to_device(np.stack([
            _pad_pow2(sel_ts, np.int32),
            _pad_pow2(sel_vals, np.float32).view(np.int32)]), dev)
        d_ts = packed[0]
        out = time_bucket_aggregate(
            d_ts, torch.zeros_like(d_ts), packed[1].view(torch.float32), k,
            bucket, num_groups=1, num_buckets=num_buckets, device=dev)
        _sync(dev)
        return out

    out = device_run()  # first launch (kernel build and load)
    dev_p50 = _p50(device_run, iters)

    def cpu_run():
        m = is_host & in_range
        b = ts_off[m] // bucket
        v = vals[m].astype(np.float64)
        sums = np.bincount(b, weights=v, minlength=num_buckets)
        counts = np.bincount(b, minlength=num_buckets)
        mins = np.full(num_buckets, np.inf)
        np.minimum.at(mins, b, v)
        maxs = np.full(num_buckets, -np.inf)
        np.maximum.at(maxs, b, v)
        return sums, counts, mins, maxs

    cpu_p50 = _p50(cpu_run, max(3, iters // 4))

    sums, counts, mins, maxs = cpu_run()
    occ = counts > 0
    np.testing.assert_allclose(_host(out["min"])[0][occ], mins[occ],
                               rtol=1e-5)
    np.testing.assert_allclose(_host(out["max"])[0][occ], maxs[occ],
                               rtol=1e-5)
    _log(f"config2: n={n:,} dev={dev_p50*1e3:.2f}ms cpu={cpu_p50*1e3:.2f}ms")
    point = _config2_engine_point(rows, dev, scratch_dir)
    return {"metric": f"TSBS cpu-only WHERE host + min/max/avg, {n/1e6:.1f}M rows, p50",
            "value": round(dev_p50 * 1e3, 3), "unit": "ms",
            "vs_baseline": round(dev_p50 / cpu_p50, 4),
            **point}


def _config2_engine_point(rows: int, dev, scratch_dir) -> dict:
    """ENGINE leg of config 2: the WHERE host=? point query COLD through
    MetricEngine on a filesystem store — the shape sidecar block pruning
    exists for.  Reports the cold p50 and the fraction of sidecar BYTES
    the scan actually fetched (1.0 = whole objects, i.e. no pruning —
    measured at the store, so a broken pruner cannot fake it)."""
    import glob
    import shutil

    import pyarrow as pa

    from horaedb_tpu_torch.metric_engine import MetricEngine
    from horaedb_tpu_torch.objstore import LocalObjectStore
    from horaedb_tpu_torch.storage.config import StorageConfig, from_dict
    from horaedb_tpu_torch.storage.types import TimeRange

    class MeteredStore(LocalObjectStore):
        """Counts bytes served for .enc objects (get + get_range)."""

        enc_bytes = 0

        async def get(self, path):
            b = await super().get(path)
            if path.endswith(".enc"):
                MeteredStore.enc_bytes += len(b)
            return b

        async def get_range(self, path, start, end):
            b = await super().get_range(path, start, end)
            if path.endswith(".enc"):
                MeteredStore.enc_bytes += len(b)
            return b

    hosts = 100
    n = min(rows, 2_000_000)
    segment_ms = 2 * 3600 * 1000
    T0 = (1_700_000_000_000 // segment_ms) * segment_ms
    span = segment_ms  # one big single-segment SST: the pruning shape
    rng = np.random.default_rng(2)
    names = pa.array([f"host_{i:03d}" for i in range(hosts)])

    async def go():
        root = _scratch("cfg2", scratch_dir)
        try:
            # tier-2 off: this leg meters how many sidecar BYTES cross
            # the store boundary (block pruning) — the encoded cache
            # would serve them from RAM and zero the metric (config 9
            # measures the cache tiers themselves)
            cfg = from_dict(StorageConfig, {
                "scan": {"cache": {"tier2_max_bytes": 0}}})
            e = await MetricEngine.open("cfg2", MeteredStore(root),
                                        segment_ms=segment_ms, config=cfg,
                                        device=dev)
            try:
                await e.write_arrow("cpu", ["host"], pa.record_batch({
                    "host": pa.DictionaryArray.from_arrays(
                        pa.array(rng.integers(0, hosts, n).astype(np.int32)),
                        names),
                    "timestamp": pa.array(
                        T0 + rng.integers(0, span, n), type=pa.int64()),
                    "value": pa.array(rng.random(n), type=pa.float64()),
                }))
                enc_total = sum(
                    os.path.getsize(p) for p in glob.glob(
                        os.path.join(root, "cfg2", "data", "data",
                                     "*.enc")))

                async def q():
                    out = await e.query_downsample(
                        "cpu", [("host", "host_042")],
                        TimeRange.new(T0, T0 + span), bucket_ms=60_000,
                        aggs=("min", "max", "avg"))
                    _sync(dev)
                    return out

                out = await q()  # warm
                assert len(out["tsids"]) == 1
                times = []
                bytes0 = MeteredStore.enc_bytes
                for _ in range(5):
                    e.tables["data"].reader.scan_cache.clear()
                    t0 = time.perf_counter()
                    out = await q()
                    times.append(time.perf_counter() - t0)
                fetched = (MeteredStore.enc_bytes - bytes0) / 5
                return (float(np.percentile(times, 50)), fetched,
                        max(1, enc_total))
            finally:
                await e.close()
        finally:
            shutil.rmtree(root, ignore_errors=True)

    p50, fetched, enc_total = asyncio.run(go())
    frac = fetched / enc_total
    _log(f"config2 engine point query: cold p50 {p50 * 1e3:.1f} ms, "
         f"fetched {frac:.2f} of sidecar bytes (block pruning)")
    return {"engine_point_cold_ms": round(p50 * 1e3, 3),
            "engine_point_bytes_fetched_frac": round(frac, 4)}


# ---------------------------------------------------------------------------
# config 3: devops-100, 10 fields, region filter + GROUP BY host, time(5m)
# ---------------------------------------------------------------------------


def multi_field_avg(ts, g, fm, n_valid: int, bucket_ms: int,
                    num_groups: int, num_buckets: int):
    """The JAX bench's multi-field average (an XLA segment_sum there, no
    Pallas kernel): a plain torch yardstick of float32 index_add_ sums
    over (group, bucket) cells; rows past n_valid, with a negative
    group or outside the grid fall in one spill cell."""
    import torch

    iota = torch.arange(ts.shape[0], dtype=torch.int32, device=ts.device)
    valid = iota < n_valid
    b = torch.div(ts, bucket_ms, rounding_mode="floor")
    in_grid = valid & (g >= 0) & (b >= 0) & (b < num_buckets)
    cells = num_groups * num_buckets
    seg = torch.where(in_grid, g.long() * num_buckets + b.long(),
                      torch.full_like(b, cells, dtype=torch.int64))
    counts = torch.zeros(cells + 1, dtype=torch.float32, device=ts.device)
    counts.index_add_(0, seg, in_grid.to(torch.float32))
    sums = torch.zeros((cells + 1, fm.shape[1]), dtype=torch.float32,
                       device=ts.device)
    sums.index_add_(0, seg, torch.where(in_grid[:, None], fm,
                                        torch.zeros_like(fm)))
    avg = sums[:-1] / torch.clamp(counts[:-1, None], min=1.0)
    return avg, counts[:-1]


def run_config3(rows: int, iters: int, device="cuda") -> dict:
    from horaedb_tpu_torch.bench.tsbs import (
        CPU_FIELDS,
        REGIONS,
        TsbsConfig,
        generate_cpu_arrays,
    )
    from horaedb_tpu_torch.ops.encode import pad_capacity, to_device

    dev = resolve_device(device)
    hosts = 100
    fields = 10
    interval = 10_000
    cfg = TsbsConfig(num_hosts=hosts, num_fields=fields, interval_ms=interval,
                     span_ms=(rows // hosts) * interval)
    cols = generate_cpu_arrays(cfg, shuffle=True)
    n = len(cols["ts"])
    bucket = 300_000  # 5m
    num_buckets = -(-cfg.span_ms // bucket)
    ts_off = (cols["ts"] - cfg.start_ms).astype(np.int64)
    _check_i32_span(ts_off, "config3")
    # region tag filter: hosts are round-robin across 9 regions
    host_region = np.arange(hosts) % len(REGIONS)
    target_region = 0
    host_in_region = host_region[cols["host_id"]] == target_region
    gid = np.where(host_in_region, cols["host_id"], -1).astype(np.int32)
    field_mat = np.stack([cols[CPU_FIELDS[f]] for f in range(fields)],
                         axis=1).astype(np.float32)  # (n, 10)

    cap = pad_capacity(n)
    d_ts = to_device(_pad_pow2(ts_off, np.int32), dev)
    d_gid = to_device(_pad_pow2(gid, np.int32), dev)
    d_fields = to_device(np.pad(field_mat, ((0, cap - n), (0, 0))), dev)

    num_cells = hosts * num_buckets

    def device_run():
        avg, counts = multi_field_avg(d_ts, d_gid, d_fields, n, bucket,
                                      num_groups=hosts,
                                      num_buckets=num_buckets)
        _sync(dev)
        return avg, counts

    avg, counts = device_run()
    dev_p50 = _p50(device_run, iters)

    def cpu_run():
        m = host_in_region
        cell = cols["host_id"][m].astype(np.int64) * num_buckets + ts_off[m] // bucket
        counts = np.bincount(cell, minlength=num_cells)
        sums = np.stack([
            np.bincount(cell, weights=field_mat[m, f].astype(np.float64),
                        minlength=num_cells)
            for f in range(fields)
        ], axis=1)
        return sums / np.maximum(counts[:, None], 1)

    cpu_p50 = _p50(cpu_run, max(3, iters // 4))
    ref = cpu_run()
    got = _host(avg).astype(np.float64)
    occ = _host(counts) > 0
    np.testing.assert_allclose(got[occ], ref[occ], rtol=2e-4)
    _log(f"config3: n={n:,}x{fields}f dev={dev_p50*1e3:.2f}ms cpu={cpu_p50*1e3:.2f}ms")
    multi = _config3_engine_multifield(rows, cfg, bucket, dev)
    return {"metric": f"TSBS devops-100 10-field GROUP BY host,time(5m), {n/1e6:.1f}M rows, p50",
            "value": round(dev_p50 * 1e3, 3), "unit": "ms",
            "vs_baseline": round(dev_p50 / cpu_p50, 4),
            **multi}


def _config3_engine_multifield(rows: int, cfg, bucket: int, dev) -> dict:
    """ENGINE leg of config 3: the 10-field devops query through
    MetricEngine.query_downsample_multi, COLD, against the yardstick
    that actually matters — one single-field query over the SAME total
    row count.  Fields partition the data-table rows, so a well-built
    engine pays ~1x that yardstick for all 10 fields, not 10x (the
    redundancy factor reported below)."""
    import pyarrow as pa

    from horaedb_tpu_torch.bench.tsbs import (
        CPU_FIELDS,
        TsbsConfig,
        generate_cpu_arrays,
    )
    from horaedb_tpu_torch.metric_engine import MetricEngine
    from horaedb_tpu_torch.objstore import MemoryObjectStore
    from horaedb_tpu_torch.storage.types import TimeRange

    fields = cfg.num_fields
    hosts = cfg.num_hosts
    ticks = max(1, rows // hosts // fields)
    ecfg = TsbsConfig(num_hosts=hosts, num_fields=fields,
                      interval_ms=cfg.interval_ms,
                      span_ms=ticks * cfg.interval_ms)
    cols = generate_cpu_arrays(ecfg, shuffle=False)
    n = len(cols["ts"])
    names = pa.array([f"host_{i:03d}" for i in range(hosts)])

    async def go():
        e = await MetricEngine.open("cfg3", MemoryObjectStore(),
                                    segment_ms=2 * 3600 * 1000, device=dev)
        try:
            for f in range(fields):
                await e.write_arrow(
                    "cpu", ["host"],
                    _host_record_batch(names, cols["host_id"], cols["ts"],
                                       cols[CPU_FIELDS[f]]),
                    field=CPU_FIELDS[f])
            rng_q = TimeRange.new(ecfg.start_ms,
                                  ecfg.start_ms + ecfg.span_ms)
            _clear_scan_tiers(e.tables["data"])
            t0 = time.perf_counter()
            multi = await e.query_downsample_multi(
                "cpu", [], rng_q, bucket_ms=bucket,
                fields=list(CPU_FIELDS[:fields]), aggs=("avg",))
            _sync(dev)
            multi_s = time.perf_counter() - t0
            assert all(len(multi[f]["tsids"]) == hosts
                       for f in CPU_FIELDS[:fields])
            return multi_s
        finally:
            await e.close()

    async def go_single():
        # yardstick: ONE field holding the same TOTAL rows (ticks x
        # fields), queried once — the no-redundancy floor
        scfg = TsbsConfig(num_hosts=hosts, num_fields=1,
                          interval_ms=max(1, cfg.interval_ms // fields),
                          span_ms=ticks * cfg.interval_ms)
        scols = generate_cpu_arrays(scfg, shuffle=False)
        e = await MetricEngine.open("cfg3s", MemoryObjectStore(),
                                    segment_ms=2 * 3600 * 1000, device=dev)
        try:
            await e.write_arrow(
                "cpu", ["host"],
                _host_record_batch(names, scols["host_id"], scols["ts"],
                                   scols[CPU_FIELDS[0]]))
            rng_q = TimeRange.new(scfg.start_ms,
                                  scfg.start_ms + scfg.span_ms)
            _clear_scan_tiers(e.tables["data"])
            t0 = time.perf_counter()
            out = await e.query_downsample("cpu", [], rng_q,
                                           bucket_ms=bucket, aggs=("avg",))
            _sync(dev)
            single_s = time.perf_counter() - t0
            assert len(out["tsids"]) == hosts
            return single_s, len(scols["ts"])
        finally:
            await e.close()

    multi_s = asyncio.run(go())
    single_s, single_rows = asyncio.run(go_single())
    redundancy = (multi_s / single_s) if single_s else float("inf")
    _log(f"config3 engine: {fields} fields x {n:,} rows cold in "
         f"{multi_s * 1e3:.1f} ms vs one-field/{single_rows:,}-row "
         f"yardstick {single_s * 1e3:.1f} ms — redundancy factor "
         f"{redundancy:.2f}x (1.0 = no per-field re-read)")
    return {
        "engine_multi_field_cold_ms": round(multi_s * 1e3, 3),
        "engine_single_pass_equiv_ms": round(single_s * 1e3, 3),
        "engine_multi_field_redundancy": round(redundancy, 2),
        "engine_rows": n * fields,
    }


# ---------------------------------------------------------------------------
# config 4: multi-SST merge-scan through the real engine, top-k by max(cpu)
# ---------------------------------------------------------------------------


def run_config4(rows: int, iters: int, device="cuda",
                num_ssts: int = 64) -> dict:
    import pyarrow as pa

    from horaedb_tpu_torch.objstore import MemoryObjectStore
    from horaedb_tpu_torch.storage.config import StorageConfig, from_dict
    from horaedb_tpu_torch.storage.plan import TopKSpec
    from horaedb_tpu_torch.storage.read import AggregateSpec, ScanRequest
    from horaedb_tpu_torch.storage.storage import (
        CloudObjectStorage,
        WriteRequest,
    )
    from horaedb_tpu_torch.storage.types import TimeRange

    dev = resolve_device(device)
    hosts = 100
    rng = np.random.default_rng(0)
    per_sst = max(1, rows // num_ssts)
    span = 3_000_000
    T0 = (1_700_000_000_000 // 3_600_000) * 3_600_000  # segment-aligned
    schema = pa.schema([("host", pa.string()), ("ts", pa.int64()),
                       ("cpu", pa.float64())])

    # keep the exact written rows for the CPU baseline + cross-check
    all_h = np.empty(per_sst * num_ssts, dtype=np.int64)
    all_ts = np.empty(per_sst * num_ssts, dtype=np.int64)
    all_v = np.empty(per_sst * num_ssts, dtype=np.float64)

    async def setup():
        cfg = from_dict(StorageConfig, {"scheduler": {"schedule_interval": "1h"}})
        s = await CloudObjectStorage.open("bench", 3_600_000,
                                         MemoryObjectStore(), schema, 2, cfg,
                                         device=dev)
        names = np.array([f"host_{i}" for i in range(hosts)], dtype=object)
        for i in range(num_ssts):
            h = rng.integers(0, hosts, per_sst)
            ts = T0 + rng.integers(0, span, per_sst)
            v = rng.random(per_sst) * 100
            sl = slice(i * per_sst, (i + 1) * per_sst)
            all_h[sl], all_ts[sl], all_v[sl] = h, ts, v
            batch = pa.record_batch(
                [pa.array(names[h]), pa.array(ts, type=pa.int64()),
                 pa.array(v, type=pa.float64())],
                schema=schema)
            await s.write(WriteRequest(batch, TimeRange.new(T0, T0 + span)))
        return s

    spec = AggregateSpec(group_col="host", ts_col="ts", value_col="cpu",
                         range_start=T0, bucket_ms=span, num_buckets=1,
                         which=("max",))

    async def query_once(s):
        """Full pipeline via the composed QueryPlan: scan (sidecar
        decode + merge-dedup) -> downsample grids -> TopK stage.  This
        is what the metric times."""
        qp = await s.plan_query(
            ScanRequest(range=TimeRange.new(T0, T0 + span)), spec=spec,
            top_k=TopKSpec(k=10, by="max"))
        values, grids = await s.execute_plan(qp)
        _sync(dev)
        return values, grids

    async def check_counts(s):
        """Dedup-count cross-check needs the UN-sliced grids: one
        aggregate without the TopK stage, outside the timed loop."""
        _values, grids = await s.scan_aggregate(
            ScanRequest(range=TimeRange.new(T0, T0 + span)), spec)
        return int(_host(grids["count"]).sum())

    async def bench():
        s = await setup()
        try:
            top_hosts, _ = await query_once(s)  # warm
            n_out = await check_counts(s)
            times = []
            for _ in range(iters):
                t0 = time.perf_counter()
                top_hosts, _grids = await query_once(s)
                times.append(time.perf_counter() - t0)
            return float(np.percentile(times, 50)), n_out, top_hosts
        finally:
            await s.close()

    dev_p50, n_out, top_hosts = asyncio.run(bench())

    # CPU baseline on THE SAME rows: in-memory lexsort+dedup+top-k.  Note
    # this is conservative in the device's disfavor: the CPU side skips
    # the object-store read the engine pays for.
    def cpu_run():
        order = np.lexsort((all_ts, all_h))
        hs, tss = all_h[order], all_ts[order]
        keep = np.ones(len(hs), dtype=bool)
        keep[1:] = (hs[1:] != hs[:-1]) | (tss[1:] != tss[:-1])
        # last-by-write-order wins: within equal keys keep the LAST original
        # row; lexsort is stable so take the final row of each dup run
        last_keep = np.ones(len(hs), dtype=bool)
        last_keep[:-1] = (hs[:-1] != hs[1:]) | (tss[:-1] != tss[1:])
        vs = all_v[order][last_keep]
        maxs = np.full(hosts, -np.inf)
        np.maximum.at(maxs, hs[last_keep], vs)
        return int(keep.sum()), set(np.argsort(maxs)[-10:].tolist())

    cpu_p50 = _p50(cpu_run, max(2, iters // 4))
    ref_n, ref_top = cpu_run()

    # cross-check: dedup count and top-k set must match numpy on same data
    assert n_out == ref_n, (n_out, ref_n)
    got_hosts = {str(h) for h in top_hosts}
    assert got_hosts == {f"host_{g}" for g in ref_top}, (got_hosts, ref_top)

    _log(f"config4: {num_ssts} SSTs, {len(all_h):,} rows in, {n_out:,} out; "
         f"full-pipeline dev={dev_p50*1e3:.1f}ms cpu-in-mem={cpu_p50*1e3:.1f}ms")
    return {"metric": f"multi-SST merge-scan top-k (max-only agg), {num_ssts} SSTs {len(all_h)/1e6:.1f}M rows, p50",
            "value": round(dev_p50 * 1e3, 3), "unit": "ms",
            "vs_baseline": round(dev_p50 / cpu_p50, 4)}


# ---------------------------------------------------------------------------
# config 5: compaction-path rollup 1s -> 1h over 30d, write-back
# ---------------------------------------------------------------------------


def run_config5(rows: int, iters: int, device="cuda") -> dict:
    import pyarrow as pa

    from horaedb_tpu_torch.objstore import MemoryObjectStore
    from horaedb_tpu_torch.ops.downsample import time_bucket_aggregate
    from horaedb_tpu_torch.ops.encode import to_device
    from horaedb_tpu_torch.storage.config import StorageConfig, from_dict
    from horaedb_tpu_torch.storage.storage import (
        CloudObjectStorage,
        WriteRequest,
    )
    from horaedb_tpu_torch.storage.types import TimeRange

    dev = resolve_device(device)
    # 30d of 1s data, in SECONDS to fit int32 offsets; series count scales
    # with the requested row budget
    span_s = 30 * 24 * 3600
    num_series = max(1, rows // span_s)
    n = num_series * span_s if num_series * span_s <= rows * 2 else rows
    rng = np.random.default_rng(1)
    sid = np.repeat(np.arange(num_series, dtype=np.int32), span_s)[:n]
    ts_s = np.tile(np.arange(span_s, dtype=np.int64), num_series)[:n]
    vals = rng.random(n).astype(np.float32) * 100
    bucket_s = 3600
    num_buckets = span_s // bucket_s

    d_ts = to_device(_pad_pow2(ts_s, np.int32), dev)
    d_sid = to_device(_pad_pow2(sid, np.int32), dev)
    d_vals = to_device(_pad_pow2(vals, np.float32), dev)

    rollup_schema = pa.schema([
        ("series", pa.int64()), ("bucket_ts", pa.int64()),
        ("min", pa.float64()), ("max", pa.float64()), ("sum", pa.float64()),
        ("count", pa.float64()), ("avg", pa.float64()), ("last", pa.float64()),
    ])

    async def open_rollup_store():
        cfg = from_dict(StorageConfig,
                        {"scheduler": {"schedule_interval": "1h"}})
        return await CloudObjectStorage.open(
            "rollup", 10**9, MemoryObjectStore(), rollup_schema, 2, cfg,
            device=dev)

    series_col = np.repeat(np.arange(num_series, dtype=np.int64),
                           num_buckets)
    bucket_col = np.tile(
        np.arange(num_buckets, dtype=np.int64) * bucket_s * 1000,
        num_series)

    async def write_back(s, aggs):
        # the grids come to the host (inside the timed window) before
        # nan_to_num and the write
        arrays = [pa.array(series_col), pa.array(bucket_col)]
        for key in ("min", "max", "sum", "count", "avg", "last"):
            arrays.append(pa.array(
                np.nan_to_num(_host(aggs[key]).astype(np.float64)
                              ).reshape(-1)))
        batch = pa.record_batch(arrays, schema=rollup_schema)
        await s.write(WriteRequest(
            batch, TimeRange.new(0, span_s * 1000), enable_check=False))
        return batch.num_rows

    def rollup():
        aggs = time_bucket_aggregate(d_ts, d_sid, d_vals, n, bucket_s,
                                     num_groups=num_series,
                                     num_buckets=num_buckets, device=dev)
        _sync(dev)
        return aggs

    # production rollups write into an EXISTING table: the store opens
    # once (one event loop — its background tasks stay loop-affine);
    # each timed iteration is aggregate + grid download + write (the
    # engine dedups the repeated keys last-wins, like re-rollups)
    async def bench():
        s = await open_rollup_store()
        try:
            out = rollup()  # first launch
            wrote = await write_back(s, out)  # warm write path
            times = []
            for _ in range(iters):
                t0 = time.perf_counter()
                out = rollup()
                await write_back(s, out)
                times.append(time.perf_counter() - t0)
            return wrote, float(np.percentile(times, 50)), out
        finally:
            await s.close()

    written, dev_p50, aggs = asyncio.run(bench())

    def cpu_run():
        cell = sid.astype(np.int64) * num_buckets + ts_s // bucket_s
        ncells = num_series * num_buckets
        counts = np.bincount(cell, minlength=ncells)
        sums = np.bincount(cell, weights=vals.astype(np.float64),
                           minlength=ncells)
        mins = np.full(ncells, np.inf)
        np.minimum.at(mins, cell, vals)
        maxs = np.full(ncells, -np.inf)
        np.maximum.at(maxs, cell, vals)
        return sums, counts, mins, maxs

    cpu_p50 = _p50(cpu_run, max(2, iters // 4))
    sums, counts, mins, maxs = cpu_run()
    np.testing.assert_allclose(
        _host(aggs["sum"]).astype(np.float64).reshape(-1), sums, rtol=2e-4)
    _log(f"config5: {n:,} rows -> {written:,} rollup rows "
         f"(agg+writeback dev={dev_p50*1e3:.1f}ms, cpu agg-only={cpu_p50*1e3:.1f}ms)")
    return {"metric": f"compaction rollup 1s->1h 30d all aggs + write-back, {n/1e6:.1f}M rows, p50",
            "value": round(dev_p50 * 1e3, 3), "unit": "ms",
            "vs_baseline": round(dev_p50 / cpu_p50, 4)}


# ---------------------------------------------------------------------------
# config 6: manifest snapshot codec — the reference's OWN criterion
# benchmark (src/benchmarks/benches/bench.rs: 1000-record snapshot,
# 100 appends, encode+append+decode per iteration)
# ---------------------------------------------------------------------------


def run_config6(rows: int, iters: int, device="cuda") -> dict:
    from horaedb_tpu_torch.native import RECORD_DTYPE
    from horaedb_tpu_torch.storage.manifest.encoding import (
        HEADER_LENGTH,
        RECORD_LENGTH,
        Snapshot,
        SnapshotHeader,
        SnapshotRecord,
    )
    from horaedb_tpu_torch.storage.sst import FileMeta, SstFile
    from horaedb_tpu_torch.storage.types import TimeRange

    del rows, device  # host work: the codec never touches the card
    record_count = 1000  # the reference's BENCH config values
    append_count = 100
    base = np.zeros(record_count, dtype=RECORD_DTYPE)
    base["id"] = np.arange(record_count, dtype=np.uint64) + 1
    base["start"] = np.arange(record_count, dtype=np.int64) * 1000
    base["end"] = base["start"] + 1000
    base["size"] = 4096
    base["num_rows"] = 8192
    appends = [
        SstFile(record_count + i + 1,
                FileMeta(max_sequence=record_count + i + 1, num_rows=8192,
                         size=4096,
                         time_range=TimeRange.new(i * 1000, i * 1000 + 1000)))
        for i in range(append_count)
    ]

    def one_round() -> int:
        snap = Snapshot(base.copy())
        snap.add_records(appends)
        buf = snap.into_bytes()
        back = Snapshot.from_bytes(buf)
        return len(back)

    assert one_round() == record_count + append_count
    dev_p50 = _p50(one_round, iters)

    # baseline: the SAME encode+append(+dedup)+decode round through the
    # per-record spec-twin classes (the wire format's independent Python
    # statement) — what a non-vectorized host codec costs
    base_records = [
        SnapshotRecord(id=int(i + 1),
                       time_range=TimeRange.new(i * 1000, i * 1000 + 1000),
                       size=4096, num_rows=8192)
        for i in range(record_count)
    ]

    def py_round() -> int:
        by_id = {r.id: r for r in base_records}  # append = replace-by-id
        for f in appends:
            by_id[f.id] = SnapshotRecord(
                id=f.id, time_range=f.meta.time_range, size=f.meta.size,
                num_rows=f.meta.num_rows)
        records = list(by_id.values())
        body = b"".join(r.to_bytes() for r in records)
        buf = SnapshotHeader(length=len(body)).to_bytes() + body
        header = SnapshotHeader.from_bytes(buf)
        count = header.length // RECORD_LENGTH
        back = [SnapshotRecord.from_bytes(buf, HEADER_LENGTH + k * RECORD_LENGTH)
                for k in range(count)]
        return len(back)

    assert py_round() == record_count + append_count
    cpu_p50 = _p50(py_round, max(3, iters // 4))
    _log(f"config6: snapshot {record_count}+{append_count} records "
         f"codec={dev_p50*1e3:.3f}ms per-record-python={cpu_p50*1e3:.3f}ms")
    # pure host work: label it so it can never read as a device number
    return {"metric": ("manifest snapshot encode+append+decode, "
                       f"{record_count}+{append_count} records, p50"),
            "value": round(dev_p50 * 1e3, 3), "unit": "ms",
            "vs_baseline": round(dev_p50 / cpu_p50, 4),
            "backend": "host", "fallback": False}


# ---------------------------------------------------------------------------
# config 7: mixed read/write — sustained write load + compaction churn
# while serving varied-range downsample queries
# ---------------------------------------------------------------------------


def run_config7(rows: int, iters: int, device="cuda") -> dict:
    """Queries under churn: the reference's self-test write generator
    shape (1000-row random batches per interval) runs CONCURRENTLY with
    rotating varied-range downsample queries and a 1s-interval
    compaction scheduler.  Reports query p50/p99 quiet vs mixed, cache
    hit rates and compaction count during the mixed phase.
    `vs_baseline` is mixed_p50/quiet_p50 — 1.0 means churn-proof."""
    import pyarrow as pa

    from horaedb_tpu_torch.common.error import ensure
    from horaedb_tpu_torch.metric_engine import MetricEngine
    from horaedb_tpu_torch.objstore import MemoryObjectStore
    from horaedb_tpu_torch.storage import compaction as compaction_mod
    from horaedb_tpu_torch.storage import scan_cache as scan_cache_mod
    from horaedb_tpu_torch.storage.config import StorageConfig, from_dict
    from horaedb_tpu_torch.storage.read import _REPLAY_HITS
    from horaedb_tpu_torch.storage.types import TimeRange

    dev = resolve_device(device)
    hosts = 100
    interval = 10_000
    bucket = 60_000
    per_host = max(1, rows // hosts)
    span = per_host * interval
    segment_ms = 2 * 3600 * 1000
    T0 = (1_700_000_000_000 // segment_ms) * segment_ms
    rng = np.random.default_rng(7)
    n = per_host * hosts
    names = pa.array([f"host_{i:03d}" for i in range(hosts)])

    def batch_of(ts: np.ndarray, host_id: np.ndarray) -> pa.RecordBatch:
        return _host_record_batch(names, host_id, ts,
                                  rng.random(len(ts)) * 100)

    half = (span // 2 // bucket) * bucket
    ensure(half > 0, "config7 needs rows >= ~1200 for a non-empty "
                     "half-span query window")
    _check_i32_span(np.asarray([span]), "config7")
    step = max(bucket, (span - half) // 11 // bucket * bucket)
    starts = [T0 + i * step for i in range(12)
              if T0 + i * step + half <= T0 + span]
    # wall-clock floors scale with iters so smoke tests stay fast while
    # long runs hold the churn phase open long enough for the 1s
    # compaction scheduler to fire repeatedly
    quiet_floor_s = min(2.0, 0.1 * iters)
    mixed_floor_s = min(5.0, 0.25 * iters)

    async def go():
        cfg = from_dict(StorageConfig, {
            "scheduler": {"schedule_interval": "1s"},
            "scan": {"cache_max_rows": rows * 4},
        })
        e = await MetricEngine.open("cfg7", MemoryObjectStore(),
                                    segment_ms=segment_ms, config=cfg,
                                    device=dev)
        try:
            ts_all = T0 + np.repeat(
                np.arange(per_host, dtype=np.int64) * interval, hosts)
            hid_all = np.tile(np.arange(hosts, dtype=np.int32), per_host)
            chunk = max(1, 1_000_000 // hosts) * hosts
            for lo in range(0, n, chunk):
                hi = min(n, lo + chunk)
                await e.write_arrow("cpu", ["host"],
                                    batch_of(ts_all[lo:hi],
                                             hid_all[lo:hi]))

            async def q_phase(min_queries: int, min_seconds: float):
                lats = []
                t_phase = time.perf_counter()
                i = 0
                while (len(lats) < min_queries
                       or time.perf_counter() - t_phase < min_seconds):
                    s = starts[i % len(starts)]
                    i += 1
                    t0 = time.perf_counter()
                    await e.query_downsample(
                        "cpu", [], TimeRange.new(s, s + half),
                        bucket_ms=bucket, aggs=("avg",))
                    _sync(dev)
                    lats.append(time.perf_counter() - t0)
                return lats

            # warm + self-check + quiet phase
            first = await e.query_downsample(
                "cpu", [], TimeRange.new(starts[0], starts[0] + half),
                bucket_ms=bucket, aggs=("avg",))
            ensure(len(first["tsids"]) == hosts,
                   f"config7 self-check: expected {hosts} series, got "
                   f"{len(first['tsids'])}")
            await q_phase(len(starts), 0.0)
            quiet = await q_phase(max(iters, 2 * len(starts)),
                                  quiet_floor_s)

            # mixed phase: writer fires 1000-row batches every 100 ms
            # into a narrow 2-segment window (concentrates SST buildup
            # so the 1s compaction scheduler actually churns), while
            # the same varied queries keep running
            stop = asyncio.Event()
            writes = 0

            async def writer():
                nonlocal writes
                lo_seg = T0 + (span // 2 // segment_ms) * segment_ms
                while not stop.is_set():
                    ts_w = lo_seg + rng.integers(
                        0, min(2 * segment_ms, span), 1000).astype(np.int64)
                    await e.write_arrow(
                        "cpu", ["host"],
                        batch_of(np.sort(ts_w),
                                 rng.integers(0, hosts, 1000)))
                    writes += 1
                    await asyncio.sleep(0.1)

            h0 = scan_cache_mod._HITS.value
            m0 = scan_cache_mod._MISSES.value
            c0 = compaction_mod._COMPACTIONS.value
            r0 = _REPLAY_HITS.value
            w_task = asyncio.create_task(writer())
            try:
                mixed = await q_phase(max(iters, 2 * len(starts)),
                                      mixed_floor_s)
            finally:
                stop.set()
                await w_task
            hits = scan_cache_mod._HITS.value - h0
            misses = scan_cache_mod._MISSES.value - m0
            compactions = compaction_mod._COMPACTIONS.value - c0
            replays = _REPLAY_HITS.value - r0
            return quiet, mixed, writes, hits, misses, compactions, replays
        finally:
            await e.close()

    quiet, mixed, writes, hits, misses, compactions, replays = \
        asyncio.run(go())
    q50, q99 = np.percentile(quiet, [50, 99])
    m50, m99 = np.percentile(mixed, [50, 99])
    hit_rate = hits / max(1, hits + misses)
    _log(f"config7: quiet p50 {q50*1e3:.1f}/p99 {q99*1e3:.1f} ms; "
         f"under churn p50 {m50*1e3:.1f}/p99 {m99*1e3:.1f} ms "
         f"({len(mixed)} queries, {writes} writes, {compactions} "
         f"compactions, scan-cache hit rate {hit_rate:.2f})")
    return {
        "metric": (f"varied downsample p50 under write+compaction churn, "
                   f"{rows / 1e6:.1f}M rows preloaded"),
        "value": round(float(m50) * 1e3, 3), "unit": "ms",
        "vs_baseline": round(float(m50 / q50), 4),
        "quiet_p50_ms": round(float(q50) * 1e3, 3),
        "quiet_p99_ms": round(float(q99) * 1e3, 3),
        "churn_p99_ms": round(float(m99) * 1e3, 3),
        "mixed_queries": len(mixed),
        "writes_1k_batches": writes,
        "compactions": int(compactions),
        "scan_cache_hit_rate": round(hit_rate, 4),
        "replay_hits": int(replays),
    }


# ---------------------------------------------------------------------------
# config 8: durable ingest — WAL group commit vs one-SST-per-write
# ---------------------------------------------------------------------------


def run_config8(rows: int, iters: int, device="cuda",
                scratch_dir: Optional[str] = None) -> dict:
    """Acked-writes/s and p99 ack latency at batch size 1 under 32
    concurrent writers, on a REAL local filesystem (fsyncs included;
    under `scratch_dir` when given): the one-SST-per-write baseline (every
    ack pays parquet + object put + manifest delta) vs the WAL+memtable
    front end across group-commit coalescing windows.  vs_baseline here
    is wal_rate / baseline_rate — HIGHER is better.  `iters` is unused:
    each variant is one sustained run (`rows` scales the write
    count)."""
    import shutil

    import pyarrow as pa

    from horaedb_tpu_torch.common import ReadableDuration
    from horaedb_tpu_torch.objstore import LocalObjectStore
    from horaedb_tpu_torch.storage.config import StorageConfig, from_dict
    from horaedb_tpu_torch.storage.storage import (
        CloudObjectStorage,
        WriteRequest,
    )
    from horaedb_tpu_torch.storage.types import TimeRange
    from horaedb_tpu_torch.wal import IngestStorage, WalConfig

    del iters
    dev = resolve_device(device)
    seg_ms = 3_600_000
    schema = pa.schema([("k", pa.string()), ("ts", pa.int64()),
                        ("v", pa.float64())])
    n_writes = max(64, min(rows // 5000, 2000))
    concurrency = 32

    def storage_cfg():
        c = from_dict(StorageConfig, {
            "scheduler": {"schedule_interval": "1h"}})
        c.manifest.merge_interval = ReadableDuration.parse("1h")
        c.scrub.interval = ReadableDuration.parse("1h")
        return c

    async def drive(s, n):
        lat = []

        async def worker(w):
            for i in range(w, n, concurrency):
                ts = 10 + i
                b = pa.record_batch(
                    [pa.array([f"k{i % 97}"]),
                     pa.array([ts], type=pa.int64()),
                     pa.array([float(i)], type=pa.float64())],
                    schema=schema)
                t0 = time.perf_counter()
                await s.write(WriteRequest(b, TimeRange.new(ts, ts + 1)))
                lat.append(time.perf_counter() - t0)

        t_start = time.perf_counter()
        await asyncio.gather(*[worker(w) for w in range(concurrency)])
        elapsed = time.perf_counter() - t_start
        return n / elapsed, float(np.percentile(lat, 99) * 1e3)

    async def bench():
        out = {}
        tmp = _scratch("cfg8_base", scratch_dir)
        try:
            s = await CloudObjectStorage.open(
                "db", seg_ms, LocalObjectStore(tmp), schema, 2,
                storage_cfg(), device=dev)
            # the baseline pays a full object-store round trip per ack;
            # a shorter sustained run measures the same steady state
            base_n = min(n_writes, 256)
            base_rate, base_p99 = await drive(s, base_n)
            await s.close()
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        _log(f"config8 baseline: {base_rate:.0f} acked writes/s "
             f"(p99 ack {base_p99:.2f} ms, {base_n} writes)")
        out["baseline_writes_per_s"] = round(base_rate, 1)
        out["baseline_p99_ack_ms"] = round(base_p99, 3)

        best = None
        variants = {}
        for wait_ms in (0, 1, 4):
            tmp = _scratch("cfg8_wal", scratch_dir)
            try:
                inner = await CloudObjectStorage.open(
                    "db", seg_ms,
                    LocalObjectStore(tmp + "/data"), schema, 2,
                    storage_cfg(), device=dev)
                wc = WalConfig(
                    enabled=True, dir=tmp + "/wal",
                    max_group_wait=ReadableDuration.from_millis(wait_ms),
                    flush_rows=1 << 30, flush_bytes=1 << 40,
                    flush_age=ReadableDuration.parse("1h"),
                    flush_interval=ReadableDuration.parse("1h"))
                s = await IngestStorage.open(inner, wc.dir, wc)
                rate, p99 = await drive(s, n_writes)
                # the final flush drains outside the timed region
                await s.close()
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
            _log(f"config8 wal group_wait={wait_ms}ms: {rate:.0f} acked "
                 f"writes/s (p99 ack {p99:.2f} ms, {n_writes} writes)")
            variants[f"group_wait_{wait_ms}ms"] = {
                "writes_per_s": round(rate, 1),
                "p99_ack_ms": round(p99, 3)}
            if best is None or rate > best[0]:
                best = (rate, p99, wait_ms)
        out["variants"] = variants
        out["best_group_wait_ms"] = best[2]
        out["p99_ack_ms"] = round(best[1], 3)
        out["writes"] = n_writes
        out["concurrency"] = concurrency
        return out, best[0]

    out, wal_rate = asyncio.run(bench())
    return {
        "metric": (f"durable ingest: acked writes/s at batch size 1, "
                   f"WAL group commit vs one-SST-per-write, "
                   f"{concurrency} writers"),
        "value": round(wal_rate, 1),
        "unit": "writes/s",
        # higher is better for THIS config (throughput multiple)
        "vs_baseline": round(wal_rate / out["baseline_writes_per_s"], 2),
        **out,
    }


# ---------------------------------------------------------------------------
# config 9: tiered scan cache — post-flush / HBM-evicted / true-cold
# ---------------------------------------------------------------------------


def run_config9(rows: int, iters: int, device="cuda",
                scratch_dir: Optional[str] = None) -> dict:
    """The cold-scan tier ladder: ONE downsample workload measured at
    every cache tier of the read path.

      cached      tier-1 hit (device-resident post-merge windows)
      post_flush  a WAL flush just changed one segment's SST set —
                  tier-1 misses that segment, tier-2 + write-through
                  admission rebuild it without any object-store read
      hbm_evicted device state dropped (stacks, replays, memos), the
                  host windows kept
      tier2_cold  tier-1 fully evicted, tier-2 (host-RAM encoded
                  parts) warm — the restart-adjacent / cache-pressure
                  shape
      true_cold   every tier cleared — the full object-store read; it
                  must replay nothing and upload its columns
      true_cold_tier2_off  same, on an engine with [scan.cache]
                  tier2_max_bytes = 0 — disabling the tier reproduces
                  the pre-tiering behavior"""
    import shutil

    import pyarrow as pa

    from horaedb_tpu_torch.common import ReadableDuration
    from horaedb_tpu_torch.common.error import ensure
    from horaedb_tpu_torch.metric_engine import MetricEngine
    from horaedb_tpu_torch.objstore import (
        FaultInjectingStore,
        MemoryObjectStore,
        WrappedObjectStore,
    )
    from horaedb_tpu_torch.ops.encode import h2d_bytes
    from horaedb_tpu_torch.storage.config import StorageConfig, from_dict
    from horaedb_tpu_torch.storage.read import (
        _REPLAY_HITS,
        plan_stage_snapshot,
    )
    from horaedb_tpu_torch.storage.types import TimeRange
    from horaedb_tpu_torch.wal import WalConfig

    dev = resolve_device(device)

    class DataGetCounter(WrappedObjectStore):
        """Counts data-plane reads (.sst/.enc get + get_range) — the
        hard per-leg evidence that a tier served without store IO."""

        def __init__(self, inner):
            super().__init__(inner)
            self.data_gets = 0

        async def _call(self, op: str, *args):
            if op in ("get", "get_range") and str(args[0]).endswith(
                    (".sst", ".enc")):
                self.data_gets += 1
            return await super()._call(op, *args)

    # seeded per-op store latency models a REAL object store (an
    # in-memory GET is a memcpy, which no cache can beat); 25 ms is an
    # S3-class GET time-to-first-byte, 0 disables
    lat_s = float(os.environ.get("BENCH_STORE_LATENCY_MS", "25")) / 1e3

    hosts = 100
    interval = 10_000
    bucket_ms = 60_000
    per_host = max(60, rows // hosts)
    span = per_host * interval
    segment_ms = 2 * 3600 * 1000
    T0 = (1_700_000_000_000 // segment_ms) * segment_ms
    rng = np.random.default_rng(9)
    n = per_host * hosts
    ts = T0 + np.repeat(
        np.arange(per_host, dtype=np.int64) * interval, hosts)
    host_id = np.tile(np.arange(hosts, dtype=np.int32), per_host)
    vals = (rng.random(n) * 100).astype(np.float64)
    names = pa.array([f"host_{i:03d}" for i in range(hosts)])
    _check_i32_span(np.asarray([span]), "config9")
    k_cold = max(3, iters // 3)

    def cfg_of(tier2: bool):
        return from_dict(StorageConfig, {
            "scheduler": {"schedule_interval": "1h"},
            "scan": {"cache_max_rows": n * 4,
                     "cache": {"tier2_max_bytes":
                               (1 << 30) if tier2 else 0}},
        })

    async def ingest(e):
        chunk = max(1, 1_000_000 // hosts) * hosts
        for lo in range(0, n, chunk):
            hi = min(n, lo + chunk)
            await e.write_arrow("cpu", ["host"], pa.record_batch({
                "host": pa.DictionaryArray.from_arrays(
                    pa.array(host_id[lo:hi]), names),
                "timestamp": pa.array(ts[lo:hi], type=pa.int64()),
                "value": pa.array(vals[lo:hi], type=pa.float64()),
            }))

    async def query(e):
        out = await e.query_downsample(
            "cpu", [], TimeRange.new(T0, T0 + span),
            bucket_ms=bucket_ms, aggs=("avg",))
        _sync(dev)
        return out

    async def timed(e, reps: int, reset=None, profile: bool = False):
        times, prof = [], {}
        for i in range(reps):
            if reset is not None:
                reset()
            before = plan_stage_snapshot() if profile and i == 0 else None
            t0 = time.perf_counter()
            await query(e)
            times.append(time.perf_counter() - t0)
            if before is not None:
                after = plan_stage_snapshot()
                prof = {kk: round(after[kk] - before[kk], 4)
                        for kk in after if after[kk] != before[kk]}
        return float(np.percentile(times, 50)), prof

    async def go():
        out = {}
        store = DataGetCounter(FaultInjectingStore(
            MemoryObjectStore(), seed=9,
            latency_range=(lat_s, lat_s)))
        out["store_latency_ms"] = lat_s * 1e3
        # ingest once, tier-2 on, no WAL (bulk load path)
        e = await MetricEngine.open("cfg9", store,
                                    segment_ms=segment_ms,
                                    config=cfg_of(True), device=dev)
        try:
            await ingest(e)
        finally:
            await e.close()

        gets_mark = store.data_gets

        def leg_gets() -> int:
            nonlocal gets_mark
            prev, gets_mark = gets_mark, store.data_gets
            return gets_mark - prev

        wal_dir = _scratch("cfg9_wal", scratch_dir)
        try:
            wc = WalConfig(
                enabled=True, dir=wal_dir,
                flush_rows=1 << 30, flush_bytes=1 << 40,
                flush_age=ReadableDuration.parse("1h"),
                flush_interval=ReadableDuration.parse("1h"))
            e = await MetricEngine.open("cfg9", store,
                                        segment_ms=segment_ms,
                                        config=cfg_of(True),
                                        wal_config=wc, device=dev)
            try:
                table = e.tables["data"]
                await query(e)  # first read (warms both tiers)
                leg_gets()  # flush the warmup's reads from the mark
                cached, _ = await timed(e, iters)
                out["cached_p50_ms"] = round(cached * 1e3, 3)
                out["data_gets_cached"] = leg_gets()

                # device state evicted, host windows retained: the scan
                # cache's windows live in host RAM while the stacks,
                # replays and memos are the device-resident state —
                # drop exactly those and re-derive from the kept windows
                # (no re-read, no re-merge)
                hbm, _ = await timed(e, k_cold,
                                     reset=table.reader.drop_hbm_state)
                out["hbm_evicted_p50_ms"] = round(hbm * 1e3, 3)
                out["data_gets_hbm_evicted"] = leg_gets()

                # post-flush: a tiny write lands in segment 0's range,
                # the WAL flusher drains it to an SST (write-through
                # admission), and the very next query re-merges that
                # segment from tier-2 — no object-store read
                flush_times = []
                for i in range(iters):
                    await e.write_arrow("cpu", ["host"], pa.record_batch({
                        "host": pa.DictionaryArray.from_arrays(
                            pa.array(np.arange(hosts, dtype=np.int32)),
                            names),
                        "timestamp": pa.array(
                            np.full(hosts, T0 + 1 + i, dtype=np.int64),
                            type=pa.int64()),
                        "value": pa.array(np.full(hosts, float(i)),
                                          type=pa.float64()),
                    }))
                    await e.flush()
                    t0 = time.perf_counter()
                    await query(e)
                    flush_times.append(time.perf_counter() - t0)
                post_flush = float(np.percentile(flush_times, 50))
                out["post_flush_p50_ms"] = round(post_flush * 1e3, 3)
                # the headline guarantee: a flush just changed the SST
                # set every iteration, yet the queries read NOTHING
                # from the store (write-through + tier-2 re-merge)
                out["data_gets_post_flush"] = leg_gets()

                tier2, prof2 = await timed(
                    e, k_cold, reset=table.reader.scan_cache.clear,
                    profile=True)
                out["tier2_cold_p50_ms"] = round(tier2 * 1e3, 3)
                out["stage_profile_tier2"] = prof2
                out["data_gets_tier2"] = leg_gets()

                # true cold replays nothing and uploads its columns
                replays0, h2d0 = _REPLAY_HITS.value, h2d_bytes()
                true_cold, prof0 = await timed(
                    e, k_cold,
                    reset=lambda: _clear_scan_tiers(table),
                    profile=True)
                ensure(_REPLAY_HITS.value == replays0,
                       "config9: a true-cold query was a replay hit")
                ensure(h2d_bytes() > h2d0,
                       "config9: the true-cold queries uploaded nothing")
                out["true_cold_p50_ms"] = round(true_cold * 1e3, 3)
                out["stage_profile_true_cold"] = prof0
                out["data_gets_true_cold"] = leg_gets()
                out["encoded_cache"] = table.reader.encoded_cache.stats()
            finally:
                await e.close()
        finally:
            shutil.rmtree(wal_dir, ignore_errors=True)

        # the disabled-tier control: [scan.cache] tier2_max_bytes = 0
        # reproduces the pre-tiering cold path on the same data
        e = await MetricEngine.open("cfg9", store,
                                    segment_ms=segment_ms,
                                    config=cfg_of(False), device=dev)
        try:
            table = e.tables["data"]
            await query(e)
            off, _ = await timed(e, k_cold,
                                 reset=table.reader.scan_cache.clear)
            out["true_cold_tier2_off_p50_ms"] = round(off * 1e3, 3)
        finally:
            await e.close()
        return out

    out = asyncio.run(go())
    cached = out["cached_p50_ms"]
    post_flush = out["post_flush_p50_ms"]
    hbm = out["hbm_evicted_p50_ms"]
    tier2 = out["tier2_cold_p50_ms"]
    true_cold = out["true_cold_p50_ms"]
    out["post_flush_vs_cached"] = round(post_flush / cached, 3)
    out["hbm_evicted_speedup_vs_true_cold"] = round(true_cold / hbm, 2)
    out["tier2_speedup_vs_true_cold"] = round(true_cold / tier2, 2)
    _log(f"config9: cached {cached:.1f} ms | post-flush {post_flush:.1f}"
         f" ms ({out['post_flush_vs_cached']}x cached) | hbm-evicted "
         f"{hbm:.1f} ms ({out['hbm_evicted_speedup_vs_true_cold']}x "
         f"faster than true-cold) | tier2-cold {tier2:.1f} ms "
         f"({out['tier2_speedup_vs_true_cold']}x) | true-cold "
         f"{true_cold:.1f} ms | tier2-off "
         f"{out['true_cold_tier2_off_p50_ms']:.1f} ms")
    return {
        "metric": (f"tiered scan cache ladder: post-flush query p50, "
                   f"{n / 1e6:.1f}M rows, WAL flush changing one "
                   f"segment's SST set per query"),
        "value": post_flush,
        "unit": "ms",
        # done-bar: post-flush within 2x of cached (lower is better)
        "vs_baseline": out["post_flush_vs_cached"],
        "rows": n,
        **out,
    }


# ---------------------------------------------------------------------------
# config 10: query-tracing overhead A/B on the cached path
# ---------------------------------------------------------------------------


def run_config10(rows: int, iters: int, device="cuda") -> dict:
    """Tracing overhead: ONE cached downsample workload measured with

      off        [trace] enabled = false — the baseline
      unsampled  tracing on, sample_rate = 0 (id minting only — every
                 request pays the sampling draw and header, no spans)
      on         sample_rate = 1.0: full span recording, per-trace
                 stage/cache/objstore attribution, ring insert

    The done-bar: `on` throughput within 2% of `off`, so production
    keeps tracing on.  The CACHED path is measured because it is the
    worst case for relative overhead — a cold scan's store I/O would
    hide any instrumentation cost."""
    import pyarrow as pa

    from horaedb_tpu_torch.metric_engine import MetricEngine
    from horaedb_tpu_torch.objstore import MemoryObjectStore
    from horaedb_tpu_torch.storage.types import TimeRange
    from horaedb_tpu_torch.utils import tracing

    dev = resolve_device(device)
    hosts = 100
    interval = 10_000
    bucket_ms = 60_000
    per_host = max(60, rows // hosts)
    span = per_host * interval
    segment_ms = 2 * 3600 * 1000
    T0 = (1_700_000_000_000 // segment_ms) * segment_ms
    rng = np.random.default_rng(10)
    n = per_host * hosts
    ts = T0 + np.repeat(
        np.arange(per_host, dtype=np.int64) * interval, hosts)
    host_id = np.tile(np.arange(hosts, dtype=np.int32), per_host)
    vals = (rng.random(n) * 100).astype(np.float64)
    names = pa.array([f"host_{i:03d}" for i in range(hosts)])
    _check_i32_span(np.asarray([span]), "config10")

    async def go():
        e = await MetricEngine.open("cfg10", MemoryObjectStore(),
                                    segment_ms=segment_ms, device=dev)
        try:
            chunk = max(1, 1_000_000 // hosts) * hosts
            for lo in range(0, n, chunk):
                hi = min(n, lo + chunk)
                await e.write_arrow("cpu", ["host"], pa.record_batch({
                    "host": pa.DictionaryArray.from_arrays(
                        pa.array(host_id[lo:hi]), names),
                    "timestamp": pa.array(ts[lo:hi], type=pa.int64()),
                    "value": pa.array(vals[lo:hi], type=pa.float64()),
                }))

            async def query():
                out = await e.query_downsample(
                    "cpu", [], TimeRange.new(T0, T0 + span),
                    bucket_ms=bucket_ms, aggs=("avg",))
                _sync(dev)
                return out

            async def one(enabled: bool, sample_rate: float) -> float:
                """One query exactly as the server middleware drives
                it: recorder.start / trace_scope / finish into the
                ring."""
                tracing.recorder.configure(enabled=enabled,
                                           sample_rate=sample_rate)
                t0 = time.perf_counter()
                trace = tracing.recorder.start("/query")
                if trace is not None:
                    with tracing.trace_scope(trace):
                        await query()
                    tracing.recorder.finish(trace)
                else:
                    await query()
                return time.perf_counter() - t0

            legs = {"off": (False, 1.0), "unsampled": (True, 0.0),
                    "on": (True, 1.0)}
            reps = max(30, iters * 3)
            for _ in range(5):  # warm the scan caches
                await one(False, 1.0)
            # interleave at the single-query level AND compare via
            # per-rep PAIRED deltas (each rep runs off/unsampled/on
            # back to back): machine drift over the run moves whole
            # triples together and cancels in the difference
            acc = {k: [] for k in legs}
            order_rng = np.random.default_rng(0xC10)
            names_ = list(legs)
            for _ in range(reps):
                # randomized within-triple order: a fixed order biases
                # whichever leg always runs first
                for k in order_rng.permutation(names_):
                    en, sr = legs[k]
                    acc[k].append(await one(en, sr))
            out = {}
            for k, v in acc.items():
                out[f"{k}_p50_ms"] = round(
                    float(np.percentile(v, 50)) * 1e3, 4)
            off = np.asarray(acc["off"])
            for k in ("unsampled", "on"):
                delta = float(np.median(np.asarray(acc[k]) - off))
                out[f"{k}_overhead_us"] = round(delta * 1e6, 1)
                out[f"{k}_overhead_pct"] = round(
                    delta / float(np.median(off)) * 100, 3)
            return out
        finally:
            tracing.recorder.configure(enabled=True, sample_rate=1.0)
            await e.close()

    out = asyncio.run(go())
    _log(f"config10 tracing overhead: {out}")
    return {
        "metric": (f"config 10: traced downsample p50, cached path, "
                   f"{n / 1e6:.1f}M rows (tracing on, sample 1.0)"),
        "value": out["on_p50_ms"],
        "unit": "ms",
        # done-bar: tracing-on within 2% of tracing-off (1.0 = free)
        "vs_baseline": round(out["on_p50_ms"] / out["off_p50_ms"], 4),
        "rows": n,
        **out,
    }


# ---------------------------------------------------------------------------
# configs 11-23: shared pieces
# ---------------------------------------------------------------------------
#
# Each runner below has a `detail=` keyword: a dict the runner fills with
# what the port adds to the reference's result (each leg's kernel
# launches, which route a leg took, the control legs behind a
# route-aware check), so the result line keeps the reference's keys.
# The launch gates read LAUNCHES, which only a launch on the card
# moves: they hold where the runner runs on the card.


def _launches() -> dict:
    """The hand kernels' launch counters now (0 on the CPU, where the
    wrappers take their plain versions)."""
    from horaedb_tpu_torch.ops import bucket_agg, merge

    return {**bucket_agg.LAUNCHES, **merge.LAUNCHES}


def _launches_since(before: dict) -> dict:
    now = _launches()
    return {k: now[k] - before.get(k, 0) for k in now}


def _route(out: dict) -> str:
    """Which aggregate route served a downsample result: the fused
    route leaves its grids on the device (tensors), the parts route
    hands back host arrays."""
    return ("fused" if any(hasattr(v, "cpu") for v in out["aggs"].values())
            else "parts")


def _host_grids(out: dict) -> dict:
    return {k: _host(v) for k, v in out["aggs"].items()}


def _same_bytes(a: dict, b: dict, what: str) -> None:
    """tsids, grid keys, dtypes and bytes equal."""
    assert list(a["tsids"]) == list(b["tsids"]), f"{what}: tsids differ"
    ga, gb = _host_grids(a), _host_grids(b)
    assert sorted(ga) == sorted(gb), f"{what}: grids {sorted(ga)} != " \
        f"{sorted(gb)}"
    for k in gb:
        assert (ga[k].dtype == gb[k].dtype
                and ga[k].tobytes() == gb[k].tobytes()), \
            f"{what}: grid {k} differs in bytes"


def _within_rtol(a: dict, b: dict, what: str) -> None:
    """The fused route's contract against the parts route: count, min,
    max and last exact after a cast to float64, sum and avg within rtol
    1e-5 (NaN where the other is NaN)."""
    assert list(a["tsids"]) == list(b["tsids"]), f"{what}: tsids differ"
    ga, gb = _host_grids(a), _host_grids(b)
    assert sorted(ga) == sorted(gb), f"{what}: grids differ in keys"
    for k in gb:
        x, y = ga[k].astype(np.float64), gb[k].astype(np.float64)
        if k in ("sum", "avg"):
            np.testing.assert_allclose(x, y, rtol=1e-5,
                                       err_msg=f"{what} {k}")
        else:
            assert np.array_equal(x, y, equal_nan=True), \
                f"{what}: grid {k} differs"


def _hold_to_parts(got: dict, parts: dict, what: str) -> None:
    """The route-aware form of the reference's byte-equality check: a
    parts-route result equals the parts-route control byte for byte; a
    fused-route result (float32 sums in its own order) agrees within
    rtol 1e-5."""
    assert _route(parts) == "parts", f"{what}: the control is not parts"
    if _route(got) == "parts":
        _same_bytes(got, parts, what)
    else:
        _within_rtol(got, parts, what)


class _EnvScope:
    """Set environment variables for a block, then restore them."""

    def __init__(self, **env):
        self.env = env
        self.old: dict = {}

    def __enter__(self):
        for k, v in self.env.items():
            self.old[k] = os.environ.get(k)
            os.environ[k] = v
        return self

    def __exit__(self, *exc):
        for k, v in self.old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _parts_route():
    """The parts route forced (the fused gate declines)."""
    return _EnvScope(HORAEDB_FUSED_AGG="0")


def _drop_tier1(reader) -> None:
    """Tier 1 evicted (the window cache and the device state derived
    from it), tier 2 and the parts memo kept: the reference's
    `scan_cache.clear()`, whose windows live on the device there."""
    reader.drop_hbm_state()
    reader.scan_cache.clear()


def _data_get_counter(inner):
    """The reference's DataGetCounter: GETs of .sst/.enc objects."""
    from horaedb_tpu_torch.objstore import WrappedObjectStore

    class DataGetCounter(WrappedObjectStore):
        def __init__(self, inner):
            super().__init__(inner)
            self.data_gets = 0

        async def _call(self, op: str, *args):
            if op in ("get", "get_range") and str(args[0]).endswith(
                    (".sst", ".enc")):
                self.data_gets += 1
            return await super()._call(op, *args)

    return DataGetCounter(inner)


def _host_rows(seed: int, rows: int, min_per_host: int = 60,
               hosts: int = 100, interval: int = 10_000):
    """The engine-leg data of configs 11-18: `hosts` series at a
    10 s scrape from the segment-aligned T0, values U[0, 1) x 100 from
    `seed`, row i at tick i // hosts of host i % hosts."""
    import pyarrow as pa

    segment_ms = 2 * 3600 * 1000
    per_host = max(min_per_host, rows // hosts)
    T0 = (1_700_000_000_000 // segment_ms) * segment_ms
    rng = np.random.default_rng(seed)
    n = per_host * hosts
    return {
        "hosts": hosts, "interval": interval, "segment_ms": segment_ms,
        "per_host": per_host, "span": per_host * interval, "T0": T0,
        "n": n,
        "ts": T0 + np.repeat(np.arange(per_host, dtype=np.int64)
                             * interval, hosts),
        "host_id": np.tile(np.arange(hosts, dtype=np.int32), per_host),
        "vals": (rng.random(n) * 100).astype(np.float64),
        "names": pa.array([f"host_{i:03d}" for i in range(hosts)])}


async def _ingest(e, d: dict) -> None:
    """write_arrow in 1M-row chunks (the reference's ingest)."""
    hosts, n = d["hosts"], d["n"]
    chunk = max(1, 1_000_000 // hosts) * hosts
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk)
        await e.write_arrow("cpu", ["host"], _host_record_batch(
            d["names"], d["host_id"][lo:hi], d["ts"][lo:hi],
            d["vals"][lo:hi]))


def _series_order(d: dict):
    """(the row order of the hosts in a result, the result's tsids)."""
    from horaedb_tpu_torch.metric_engine import Label
    from horaedb_tpu_torch.metric_engine.types import tsid_of

    if "_order" in d:
        return d["_order"]
    names = d["names"].to_pylist()
    tsid_of_host = np.array([tsid_of("cpu", [Label("host", h)])
                             for h in names], dtype=np.uint64)
    order = np.argsort(tsid_of_host)
    d["_order"] = order, [int(t) for t in tsid_of_host[order]]
    return d["_order"]


def _check_grid(got: dict, d: dict, lo: int, nb: int, bucket_ms: int,
                what: str, rows=None) -> None:
    """count exact and avg within rtol 1e-5 of a numpy bincount of the
    rows over [lo, lo + nb buckets); max exact where the grid has it."""
    ts, host_id, vals = rows or (d["ts"], d["host_id"], d["vals"])
    hosts = d["hosts"]
    order, tsids = _series_order(d)
    off = ts - lo
    sel = (off >= 0) & (off < nb * bucket_ms)
    cell = host_id[sel].astype(np.int64) * nb + off[sel] // bucket_ms
    counts = np.bincount(cell, minlength=hosts * nb).reshape(hosts, nb)
    sums = np.bincount(cell, weights=vals[sel],
                       minlength=hosts * nb).reshape(hosts, nb)
    assert list(got["tsids"]) == tsids, f"{what}: tsids differ"
    grid = _host_grids(got)
    assert grid["count"].shape == (hosts, nb) and np.array_equal(
        grid["count"], counts[order].astype(grid["count"].dtype)), \
        f"{what}: count grid differs from numpy"
    occ = counts[order] > 0
    with np.errstate(invalid="ignore"):
        want = sums[order] / counts[order]
    assert np.isfinite(grid["avg"][occ]).all() \
        and np.isnan(grid["avg"][~occ]).all(), \
        f"{what}: avg has non-finite occupied or non-NaN empty cells"
    np.testing.assert_allclose(grid["avg"][occ], want[occ], rtol=1e-5,
                               err_msg=what)
    if "max" in grid:
        mx = np.full(hosts * nb, -np.inf, dtype=np.float32)
        np.maximum.at(mx, cell, vals[sel].astype(np.float32))
        mx = mx.reshape(hosts, nb)[order].astype(np.float64)
        ok = np.isfinite(mx)
        assert np.array_equal(grid["max"].astype(np.float64)[ok], mx[ok]), \
            f"{what}: max grid differs from numpy"


def _pctl_ms(xs, q) -> float:
    return round(float(np.percentile(xs, q)) * 1e3, 3)


# ---------------------------------------------------------------------------
# config 11: the dashboard mix over standing rollups
# ---------------------------------------------------------------------------


def run_config11(rows: int, iters: int, device="cuda",
                 detail: Optional[dict] = None) -> dict:
    """Dashboard-mix workload: standing rollups vs the raw scan path.
    One engine holds `rows` of TSBS-shaped data behind a seeded 25 ms
    latency object store; a standing (cpu, value) rollup at tiers 1m
    and 1h is registered and backfilled, then a dashboard mix —
    rotating 6h @ 1m zoom windows plus full-span @ 1h overviews — is
    measured twice:

      rollup leg  served from the rollup tiers (the tier tables' window
                  caches dropped before every query)
      raw leg     the same queries forced down the raw path with the
                  data table's window cache and tier 2 cleared per query

    Done-bars: rollup-served mix p50 at least 5x faster than the raw
    cold leg (recorded), ZERO data-plane reads on the rollup leg, and
    a cross-check of one query per shape.  The reference checks a
    served result against the raw one byte for byte; at this scan
    budget the raw query takes the fused route, whose float32 sums are
    a tolerance contract, so here the served result equals a
    parts-route recompute byte for byte and agrees with the default
    route within rtol 1e-5.  Beyond the reference: numpy checks of the
    mix, a served top-k against apply_top_k of the served grid, and a
    late write into one rolled segment (served as cells plus a one-
    segment raw tail, then one segment re-rolled).  The standing query
    is registered after the ingest: a registered spec's writes wake the
    maintenance loop, which would roll segments while the ingest runs
    and leave the backfill a remainder."""
    from horaedb_tpu_torch.common import ReadableDuration
    from horaedb_tpu_torch.metric_engine import Label, MetricEngine, Sample
    from horaedb_tpu_torch.objstore import (
        FaultInjectingStore,
        MemoryObjectStore,
    )
    from horaedb_tpu_torch.rollup import RollupConfig
    from horaedb_tpu_torch.storage.config import StorageConfig, from_dict
    from horaedb_tpu_torch.storage.plan import TopKSpec, apply_top_k
    from horaedb_tpu_torch.storage.types import TimeRange
    from horaedb_tpu_torch.utils import registry, tracing

    dev = resolve_device(device)
    detail = {} if detail is None else detail
    lat_s = float(os.environ.get("BENCH_STORE_LATENCY_MS", "25")) / 1e3
    d = _host_rows(11, rows, min_per_host=2160)  # >= one 6h zoom window
    hosts, interval, n = d["hosts"], d["interval"], d["n"]
    span, segment_ms, T0 = d["span"], d["segment_ms"], d["T0"]
    _check_i32_span(np.asarray([span]), "config11")
    segments = (span - interval) // segment_ms + 1

    zoom_ms = 6 * 3600 * 1000
    hour = 3600 * 1000
    over_span = (span // hour) * hour
    zoom_starts = [T0 + k * ((span - zoom_ms) // 11 // hour * hour)
                   for k in range(12)] if span > zoom_ms else [T0]

    cfg = from_dict(StorageConfig, {
        "scheduler": {"schedule_interval": "1h"},
        "scan": {"cache_max_rows": n * 4,
                 "cache": {"tier2_max_bytes": 2 << 30}},
    })
    rollup_cfg = RollupConfig(enabled=True, tiers=["1m", "1h"], specs=[],
                              roll_interval=ReadableDuration.parse("1h"))

    def shapes_of(e):
        def zoom(k, use_rollup=True):
            s = zoom_starts[k % len(zoom_starts)]
            return e.query_downsample(
                "cpu", [], TimeRange.new(s, s + min(zoom_ms, over_span)),
                bucket_ms=60_000, aggs=("avg",), use_rollup=use_rollup)

        def over(_k, use_rollup=True):
            return e.query_downsample(
                "cpu", [], TimeRange.new(T0, T0 + over_span),
                bucket_ms=hour, aggs=("avg",), use_rollup=use_rollup)

        return {"zoom": zoom, "overview": over}

    def numpy_check(out, shape, k, what, rows_=None):
        if shape == "zoom":
            s = zoom_starts[k % len(zoom_starts)]
            _check_grid(out, d, s, min(zoom_ms, over_span) // 60_000,
                        60_000, what, rows_)
        else:
            _check_grid(out, d, T0, over_span // hour, hour, what, rows_)

    async def timed_mix(e, use_rollup: bool, reps: int, reset):
        times: dict = {"zoom": [], "overview": []}
        shapes = shapes_of(e)
        for i in range(reps):
            for shape, q in shapes.items():
                reset()
                t0 = time.perf_counter()
                got = await q(i, use_rollup)
                _sync(dev)
                times[shape].append(time.perf_counter() - t0)
                if i == 0 or (shape == "zoom" and i < len(zoom_starts)):
                    numpy_check(got, shape, i, f"config11 mix {shape} {i}")
        return times

    async def traced(coro):
        trace = tracing.recorder.start("config11", forced=True)
        try:
            with tracing.trace_scope(trace):
                out = await coro
        finally:
            done = tracing.recorder.finish(trace)
        return out, done["counters"]

    def rolled_total() -> float:
        return registry.snapshot().get("rollup_segments_rolled_total", 0.0)

    async def go():
        out: dict = {"store_latency_ms": lat_s * 1e3}
        store = _data_get_counter(FaultInjectingStore(
            MemoryObjectStore(), seed=11, latency_range=(lat_s, lat_s)))
        e = await MetricEngine.open("cfg11", store, segment_ms=segment_ms,
                                    config=cfg, rollup_config=rollup_cfg,
                                    device=dev)
        try:
            t0 = time.perf_counter()
            await _ingest(e, d)
            out["ingest_s"] = round(time.perf_counter() - t0, 1)
            l0 = _launches()
            t0 = time.perf_counter()
            await e.rollups.register("cpu")
            rolled = await e.rollups.roll_now()
            out["backfill_roll_s"] = round(time.perf_counter() - t0, 1)
            detail["backfill_launches"] = _launches_since(l0)
            out["backfill_segments"] = rolled["cpu:value"]
            assert rolled["cpu:value"] == segments, \
                f"config11: the backfill rolled {rolled['cpu:value']} " \
                f"segments, not {segments}"
            st = (await e.rollups.stats())["specs"]["cpu:value"]
            out["lag_seqs_after_roll"] = st["lag_seqs"]
            out["coverage_after_roll"] = st["coverage"]
            assert st["lag_seqs"] == 0 and st["coverage"] == 1.0, \
                "config11: lag or coverage after the backfill"

            # the cross-check, one query per dashboard shape
            shapes = shapes_of(e)
            routes = {}
            for shape, q in shapes.items():
                served = await q(0)
                with _parts_route():
                    parts = await q(0, False)
                raw = await q(0, False)
                _sync(dev)
                routes[shape] = _route(raw)
                _same_bytes(served, parts, f"config11 {shape}: served "
                            "vs the parts recompute")
                _hold_to_parts(raw, parts, f"config11 {shape}: the "
                               "default raw route vs the parts recompute")
                _within_rtol(served, raw, f"config11 {shape}: served vs "
                             "the default raw route")
                numpy_check(served, shape, 0, f"config11 {shape} served")
            detail["raw_routes"] = routes
            # the reference's byte check holds only where the raw query
            # takes the parts route
            detail["reference_cross_check_holds"] = all(
                r == "parts" for r in routes.values())

            gets_mark = store.data_gets

            def leg_gets() -> int:
                nonlocal gets_mark
                prev, gets_mark = gets_mark, store.data_gets
                return gets_mark - prev

            data_reader = e.tables["data"].reader

            def drop_tier_hbm():
                for t in e.rollups.tiers.values():
                    _drop_tier1(t.reader)

            def drop_data_tiers():
                _drop_tier1(data_reader)
                data_reader.encoded_cache.clear()

            spec = e.rollups.specs[("cpu", "value")]
            served0 = spec.served_queries
            reps = max(iters, 10)
            l0 = _launches()
            roll_times = await timed_mix(e, True, reps, drop_tier_hbm)
            detail["rollup_leg_launches"] = _launches_since(l0)
            out["data_gets_rollup_leg"] = leg_gets()
            assert spec.served_queries - served0 == 2 * reps, \
                "config11: not every mix query was rollup-served"
            assert out["data_gets_rollup_leg"] == 0, \
                "config11: the rollup leg read the data plane"
            k_cold = max(3, iters // 3)
            l0 = _launches()
            raw_times = await timed_mix(e, False, k_cold, drop_data_tiers)
            detail["raw_cold_leg_launches"] = _launches_since(l0)
            out["data_gets_raw_cold_leg"] = leg_gets()
            out["rollup_served_queries"] = spec.served_queries
            for shape in ("zoom", "overview"):
                rt, ct = roll_times[shape], raw_times[shape]
                out[f"rollup_{shape}_p50_ms"] = _pctl_ms(rt, 50)
                out[f"rollup_{shape}_p99_ms"] = _pctl_ms(rt, 99)
                out[f"raw_cold_{shape}_p50_ms"] = _pctl_ms(ct, 50)
                out[f"raw_cold_{shape}_p99_ms"] = _pctl_ms(ct, 99)
                out[f"{shape}_speedup_p50"] = round(
                    np.percentile(ct, 50) / np.percentile(rt, 50), 2)
            mix_roll = roll_times["zoom"] + roll_times["overview"]
            mix_raw = raw_times["zoom"] + raw_times["overview"]
            out["rollup_mix_p50_ms"] = _pctl_ms(mix_roll, 50)
            out["rollup_mix_p99_ms"] = _pctl_ms(mix_roll, 99)
            out["raw_cold_mix_p50_ms"] = _pctl_ms(mix_raw, 50)
            out["raw_cold_mix_p99_ms"] = _pctl_ms(mix_raw, 99)
            out["mix_speedup_p50"] = round(
                out["raw_cold_mix_p50_ms"] / out["rollup_mix_p50_ms"], 2)

            # a rollup-served top-k equals apply_top_k of the served grid
            rng_o = TimeRange.new(T0, T0 + over_span)
            tk = await e.query_topk("cpu", [], rng_o, hour, k=10, by="max")
            full = await e.query_downsample("cpu", [], rng_o, hour)
            values, grids = apply_top_k(
                np.asarray(full["tsids"], np.uint64),
                _host_grids(full), TopKSpec(k=10, by="max"))
            tk_grids = _host_grids(tk)
            assert list(tk["tsids"]) == [int(t) for t in values] \
                and sorted(tk_grids) == sorted(grids) and all(
                    tk_grids[k].tobytes() == grids[k].tobytes()
                    for k in grids), \
                "config11: served top-k != apply_top_k of the served grid"

            # a late write into one rolled segment: served as cells plus
            # a one-segment raw tail, then that segment re-rolls.  The
            # manager's roll lock is held over the write and its query
            # so the maintenance loop (woken by the write) cannot
            # re-roll the segment before the query sees it dirty
            zs = zoom_starts[min(5, len(zoom_starts) - 1)]
            zspan = min(zoom_ms, over_span)
            late_ts = zs + 30 * 60_000 + 7
            rows2 = (np.append(d["ts"], late_ts),
                     np.append(d["host_id"], np.int32(7)),
                     np.append(d["vals"], 123.25))
            rng_z = TimeRange.new(zs, zs + zspan)
            rolled0 = rolled_total()
            async with e.rollups._roll_lock:
                await e.write([Sample("cpu", [Label("host", "host_007")],
                                      late_ts, 123.25)])
                l0 = _launches()
                served, counters = await traced(e.query_downsample(
                    "cpu", [], rng_z, 60_000, aggs=("avg",)))
                detail["late_tail_launches"] = _launches_since(l0)
            detail["late_tail_segments"] = counters.get(
                "rollup_tail_segments", 0)
            assert detail["late_tail_segments"] == 1, \
                f"config11: the query after the late write recomputed " \
                f"{detail['late_tail_segments']} tail segments, not 1"
            with _parts_route():
                parts = await e.query_downsample(
                    "cpu", [], rng_z, 60_000, aggs=("avg",),
                    use_rollup=False)
            _same_bytes(served, parts, "config11 late tail vs parts")
            _check_grid(served, d, zs, zspan // 60_000, 60_000,
                        "config11 late tail", rows2)
            await e.rollups.roll_now()
            detail["late_write_rerolled"] = rolled_total() - rolled0
            assert detail["late_write_rerolled"] == 1, \
                f"config11: the late write re-rolled " \
                f"{detail['late_write_rerolled']} segments, not 1"
            again, counters = await traced(e.query_downsample(
                "cpu", [], rng_z, 60_000, aggs=("avg",)))
            assert counters.get("rollup_tail_segments", 0) == 0, \
                "config11: a raw tail after the re-roll"
            _same_bytes(again, served, "config11 after the re-roll")
        finally:
            await e.close()
        return out

    out = asyncio.run(go())
    if dev.type == "cuda":
        bl = detail["backfill_launches"]
        assert bl["bucket_window_partials"] >= segments, \
            "config11: the backfill did not run the partials kernel on " \
            "every segment"
        assert detail["raw_cold_leg_launches"][
            "bucket_round_accumulate" if detail["raw_routes"]["overview"]
            == "fused" else "bucket_window_partials"], \
            "config11: the raw cold mix launched no kernel of its route"
    _log(f"config11: rollup mix p50 {out['rollup_mix_p50_ms']:.1f} ms "
         f"(p99 {out['rollup_mix_p99_ms']:.1f}) vs raw cold "
         f"{out['raw_cold_mix_p50_ms']:.1f} ms "
         f"({out['mix_speedup_p50']}x) | rollup-leg data GETs "
         f"{out['data_gets_rollup_leg']} | backfill "
         f"{out['backfill_segments']} segs in {out['backfill_roll_s']}s | "
         f"raw routes {detail['raw_routes']} | launches: backfill "
         f"{detail['backfill_launches']}, rollup mix "
         f"{detail['rollup_leg_launches']}, raw cold mix "
         f"{detail['raw_cold_leg_launches']}")
    return {
        "metric": (f"dashboard mix (6h@1m zooms + full-span@1h "
                   f"overview) served from standing rollups, "
                   f"{n / 1e6:.1f}M rows, p50"),
        "value": out["rollup_mix_p50_ms"],
        "unit": "ms",
        # done-bar: raw cold p50 / rollup p50 >= 5 (higher is better)
        "vs_baseline": out["mix_speedup_p50"],
        "rows": n,
        **out,
    }


# ---------------------------------------------------------------------------
# config 12: the background plane's overhead on the cached path
# ---------------------------------------------------------------------------


def run_config12(rows: int, iters: int, device="cuda",
                 scratch_dir: Optional[str] = None,
                 detail: Optional[dict] = None) -> dict:
    """Background-plane observability overhead: ONE cached downsample
    workload measured with the whole plane

      off   watchdog sweeps disabled, meta-ingest paused (its loop
            still wakes and checks the flag — the parked tick is paid
            by BOTH legs, so the paired delta isolates the real work)
      on    watchdog sweeping at 100 ms, meta-ingest scraping the full
            registry + writing through the WAL/memtable path every
            100 ms (flush_age 1 s keeps flushes firing), op traces
            recording for every wal_commit / flush round

    Intervals are 10-100x more aggressive than the production defaults
    — a deliberate worst case.  Config 10's paired-delta method:
    randomized within-pair order, median of per-rep deltas.  Done-bar
    (recorded): `on` within 2% of `off` on the cached query path."""
    import shutil

    from horaedb_tpu_torch.common import ReadableDuration
    from horaedb_tpu_torch.common.loops import loops
    from horaedb_tpu_torch.metric_engine import MetricEngine
    from horaedb_tpu_torch.metric_engine.meta import MetaConfig, MetaIngest
    from horaedb_tpu_torch.objstore import MemoryObjectStore
    from horaedb_tpu_torch.storage.types import TimeRange
    from horaedb_tpu_torch.utils import recorder, registry
    from horaedb_tpu_torch.wal.config import WalConfig

    dev = resolve_device(device)
    detail = {} if detail is None else detail
    d = _host_rows(12, rows)
    n, span, T0 = d["n"], d["span"], d["T0"]
    bucket_ms = 60_000
    _check_i32_span(np.asarray([span]), "config12")

    async def go():
        waldir = _scratch("cfg12", scratch_dir)
        try:
            e = await MetricEngine.open(
                "cfg12", MemoryObjectStore(), segment_ms=d["segment_ms"],
                wal_config=WalConfig(
                    enabled=True, dir=waldir,
                    flush_age=ReadableDuration.parse("1s"),
                    flush_interval=ReadableDuration.parse("200ms")),
                device=dev)
            meta = MetaIngest(e, MetaConfig(
                enabled=True, interval=ReadableDuration.parse("100ms"),
                rollup=False))
            await meta.start()
            try:
                await _ingest(e, d)
                await e.flush()

                async def query():
                    out = await e.query_downsample(
                        "cpu", [], TimeRange.new(T0, T0 + span),
                        bucket_ms=bucket_ms, aggs=("avg",))
                    _sync(dev)
                    return out

                def set_leg(on: bool) -> None:
                    loops.configure(enabled=on, interval_s=0.1)
                    meta.paused = not on

                async def one(on: bool) -> float:
                    set_leg(on)
                    t0 = time.perf_counter()
                    await query()
                    return time.perf_counter() - t0

                set_leg(False)
                for _ in range(5):  # warm the scan caches
                    await one(False)
                _check_grid(await query(), d, T0, -(-span // bucket_ms),
                            bucket_ms, "config12 cached query")
                reps = max(30, iters * 3)
                acc = {"off": [], "on": []}
                order_rng = np.random.default_rng(0xC12)
                l0 = _launches()
                for _ in range(reps):
                    # randomized within-pair order (config 10's lesson)
                    for k in order_rng.permutation(["off", "on"]):
                        acc[k].append(await one(k == "on"))
                        # let the background plane fire between queries
                        # on BOTH legs (the same wall-time shape)
                        await asyncio.sleep(0.005)
                detail["launches"] = _launches_since(l0)
                out = {}
                for k, v in acc.items():
                    out[f"{k}_p50_ms"] = round(
                        float(np.percentile(v, 50)) * 1e3, 4)
                off = np.asarray(acc["off"])
                delta = float(np.median(np.asarray(acc["on"]) - off))
                out["on_overhead_us"] = round(delta * 1e6, 1)
                out["on_overhead_pct"] = round(
                    delta / float(np.median(off)) * 100, 3)
                # evidence the on-leg plane actually ran
                out["meta_scrapes"] = int(registry.counter(
                    "meta_scrapes_total",
                    "meta-ingest scrape passes written").value)
                out["op_traces_sample"] = sorted(
                    {t["op"] for t in recorder.list(50, kind="op")})
                out["loops_registered"] = len(loops.handles())
                return out
            finally:
                loops.configure(enabled=True, interval_s=1.0)
                meta.paused = False
                await meta.stop()
                await e.close()
        finally:
            shutil.rmtree(waldir, ignore_errors=True)

    out = asyncio.run(go())
    _log(f"config12 background-plane overhead: {out}; launches "
         f"{detail['launches']}")
    return {
        "metric": (f"config 12: cached downsample p50 with watchdog + "
                   f"op tracing + meta-ingest ON, {n / 1e6:.1f}M rows"),
        "value": out["on_p50_ms"],
        "unit": "ms",
        # done-bar: the full background plane within 2% of off
        "vs_baseline": round(out["on_p50_ms"] / out["off_p50_ms"], 4),
        "rows": n,
        **out,
    }


# ---------------------------------------------------------------------------
# config 13: the cold-scan pipeline ladder
# ---------------------------------------------------------------------------


def run_config13(rows: int, iters: int, device="cuda",
                 detail: Optional[dict] = None) -> dict:
    """Cold-scan pipeline ladder: the config-9 workload over a seeded
    25 ms-latency fault store, with the pipelined cold path against
    the `[scan.pipeline] enabled = false` control — everything else
    identical.

      cached          tier-1 hit (the denominator for cold_vs_cached)
      tier2_cold      tier 1 evicted, tier-2 encoded parts warm
      true_cold       every tier cleared: the full-latency store read,
                      pipelined
      true_cold_pipeline_off / tier2_cold_pipeline_off  the controls

    Done-bars (recorded): true_cold >= 2.5x faster than the
    pipeline-off control; cold within 3x of cached.  Data-plane GETs
    per leg show which tier served; every leg's grid is checked
    against numpy, and the pipelined and sequential results are
    byte-equal."""
    from horaedb_tpu_torch.metric_engine import MetricEngine
    from horaedb_tpu_torch.objstore import (
        FaultInjectingStore,
        MemoryObjectStore,
    )
    from horaedb_tpu_torch.storage.config import StorageConfig, from_dict
    from horaedb_tpu_torch.storage.read import plan_stage_snapshot
    from horaedb_tpu_torch.storage.types import TimeRange

    dev = resolve_device(device)
    detail = {} if detail is None else detail
    lat_s = float(os.environ.get("BENCH_STORE_LATENCY_MS", "25")) / 1e3
    d = _host_rows(13, rows)
    n, span, T0, segment_ms = d["n"], d["span"], d["T0"], d["segment_ms"]
    bucket_ms = 60_000
    nb = -(-span // bucket_ms)
    _check_i32_span(np.asarray([span]), "config13")
    k_cold = max(3, iters // 3)

    def cfg_of(pipelined: bool):
        return from_dict(StorageConfig, {
            "scheduler": {"schedule_interval": "1h"},
            "scan": {"cache_max_rows": n * 4,
                     "cache": {"tier2_max_bytes": 1 << 30},
                     "pipeline": {"enabled": pipelined}},
        })

    last: dict = {}

    async def query(e):
        out = await e.query_downsample(
            "cpu", [], TimeRange.new(T0, T0 + span),
            bucket_ms=bucket_ms, aggs=("avg",))
        _sync(dev)
        last["out"] = out
        return out

    async def timed(e, reps: int, reset=None, profile: bool = False):
        times, prof = [], {}
        for i in range(reps):
            if reset is not None:
                reset()
            before = plan_stage_snapshot() if profile and i == 0 else None
            t0 = time.perf_counter()
            await query(e)
            times.append(time.perf_counter() - t0)
            if before is not None:
                after = plan_stage_snapshot()
                prof = {kk: round(after[kk] - before[kk], 4)
                        for kk in after if after[kk] != before[kk]}
        return float(np.percentile(times, 50)), prof

    async def go():
        out = {"store_latency_ms": lat_s * 1e3}
        store = _data_get_counter(FaultInjectingStore(
            MemoryObjectStore(), seed=13, latency_range=(lat_s, lat_s)))
        e = await MetricEngine.open("cfg13", store, segment_ms=segment_ms,
                                    config=cfg_of(True), device=dev)
        try:
            await _ingest(e, d)
        finally:
            await e.close()

        gets_mark = store.data_gets

        def leg_gets() -> int:
            nonlocal gets_mark
            prev, gets_mark = gets_mark, store.data_gets
            return gets_mark - prev

        results = {}
        for label, pipelined in (("", True), ("_pipeline_off", False)):
            e = await MetricEngine.open("cfg13", store,
                                        segment_ms=segment_ms,
                                        config=cfg_of(pipelined),
                                        device=dev)
            try:
                table = e.tables["data"]
                await query(e)  # warm both tiers
                leg_gets()
                l0 = _launches()
                if pipelined:
                    cached, _ = await timed(e, iters)
                    out["cached_p50_ms"] = round(cached * 1e3, 3)
                    out["data_gets_cached"] = leg_gets()
                tier2, prof2 = await timed(
                    e, k_cold, reset=lambda t=table: _drop_tier1(t.reader),
                    profile=pipelined)
                out[f"tier2_cold{label}_p50_ms"] = round(tier2 * 1e3, 3)
                out[f"data_gets_tier2{label}"] = leg_gets()
                if pipelined:
                    out["stage_profile_tier2"] = prof2
                cold, prof0 = await timed(
                    e, k_cold,
                    reset=lambda t=table: _clear_scan_tiers(t),
                    profile=pipelined)
                out[f"true_cold{label}_p50_ms"] = round(cold * 1e3, 3)
                out[f"data_gets_true_cold{label}"] = leg_gets()
                detail[f"launches{label or '_pipelined'}"] = \
                    _launches_since(l0)
                results[label] = last["out"]
                _check_grid(last["out"], d, T0, nb, bucket_ms,
                            f"config13 true cold{label}")
                if pipelined:
                    out["stage_profile_true_cold"] = prof0
                    out["pipeline_high_water_mb"] = round(
                        table.reader._pipeline_high_water / 2**20, 1)
            finally:
                await e.close()
        _same_bytes(results[""], results["_pipeline_off"],
                    "config13 pipelined vs sequential true cold")
        detail["route"] = _route(results[""])
        return out

    out = asyncio.run(go())
    if dev.type == "cuda":
        assert any(detail["launches_pipelined"].values()), \
            "config13: the pipelined legs launched no kernel"
    cached = out["cached_p50_ms"]
    cold = out["true_cold_p50_ms"]
    off = out["true_cold_pipeline_off_p50_ms"]
    out["pipeline_speedup_true_cold"] = round(off / cold, 2)
    out["pipeline_speedup_tier2"] = round(
        out["tier2_cold_pipeline_off_p50_ms"]
        / out["tier2_cold_p50_ms"], 2)
    out["cold_vs_cached"] = round(cold / cached, 2)
    _log(f"config13: cached {cached:.1f} ms | tier2-cold "
         f"{out['tier2_cold_p50_ms']:.1f} ms "
         f"({out['pipeline_speedup_tier2']}x vs off) | true-cold "
         f"{cold:.1f} ms ({out['pipeline_speedup_true_cold']}x vs "
         f"off {off:.1f} ms) | cold/cached {out['cold_vs_cached']}x | "
         f"route {detail['route']}, launches {detail['launches_pipelined']}")
    return {
        "metric": (f"pipelined cold scan: true-cold downsample p50 over "
                   f"a seeded {out['store_latency_ms']:.0f}ms-latency "
                   f"store, {n / 1e6:.1f}M rows"),
        "value": out["true_cold_p50_ms"],
        "unit": "ms",
        # done-bar: pipelined true-cold >= 2.5x the disabled control
        "vs_baseline": out["pipeline_speedup_true_cold"],
        "rows": n,
        **out,
    }


# ---------------------------------------------------------------------------
# config 14: the sparse combine, the top-k cell bound, the range memo
# ---------------------------------------------------------------------------


def run_config14(rows: int, iters: int, device="cuda",
                 detail: Optional[dict] = None) -> dict:
    """Output-grid cliff ladder: the high-cardinality full-span
    downsample measured with the sparse combine against the
    `[scan.combine] mode = "dense"` control, plus two pushdown legs:

      cold_full_span  hosts x buckets grid, every tier + the parts memo
                      cleared per rep; sparse vs dense p50
      topk            query_topk k=5 through the pushdown: materialized
                      output cells must equal k x buckets x aggs
      range_refine    a full-span query records per-segment partials;
                      narrowed ranges re-serve them — memo-served
                      segment fraction and refine p50 vs a memo-off
                      control

    Done-bars: dense/sparse (vs_baseline), the top-k bound exactly, the
    refine leg's memo fraction — and every leg's grids byte-equal to
    the dense control.  The legs measure the parts route's combine:
    the fused route would serve every query without entering it, so
    the whole run forces the parts route (HORAEDB_FUSED_AGG=0), as the
    reference does, and its byte checks compare parts-route legs."""
    import pyarrow as pa

    from horaedb_tpu_torch.metric_engine import MetricEngine
    from horaedb_tpu_torch.objstore import MemoryObjectStore
    from horaedb_tpu_torch.storage import combine as combine_mod
    from horaedb_tpu_torch.storage.config import StorageConfig, from_dict
    from horaedb_tpu_torch.storage.types import TimeRange

    dev = resolve_device(device)
    detail = {} if detail is None else detail
    # the r5 scale-ladder shape (hosts x a LONG bucket axis, every
    # window carrying all hosts); hosts = rows/200k
    hosts = int(os.environ.get("BENCH_HOSTS", max(100, rows // 200_000)))
    interval = 10_000
    bucket_ms = 60_000
    # bucket-aligned spans (ticks a multiple of 6), >= 4 segments
    per_host = -(-max(2880, rows // hosts) // 6) * 6
    span = per_host * interval
    segment_ms = 2 * 3600 * 1000
    T0 = (1_700_000_000_000 // segment_ms) * segment_ms
    rng = np.random.default_rng(14)
    n = per_host * hosts
    ts = T0 + np.repeat(
        np.arange(per_host, dtype=np.int64) * interval, hosts)
    host_id = np.tile(np.arange(hosts, dtype=np.int32), per_host)
    vals = (rng.random(n) * 100).astype(np.float64)
    names = pa.array([f"host_{i:05d}" for i in range(hosts)])
    _check_i32_span(np.asarray([span]), "config14")
    aggs = ("avg", "max")
    k_cold = max(3, iters // 3)
    num_buckets = -(-span // bucket_ms)
    d = {"hosts": hosts, "ts": ts, "host_id": host_id, "vals": vals,
         "names": names}

    def cfg():
        return from_dict(StorageConfig, {
            "scheduler": {"schedule_interval": "1h"},
            "scan": {"cache_max_rows": n * 4,
                     "cache": {"tier2_max_bytes": 1 << 30},
                     "combine": {"memo_max_bytes": 1 << 29}},
        })

    def grid_bytes(out: dict) -> bytes:
        g = _host_grids(out)
        return b"".join(g[a].tobytes() for a in sorted(g)) + \
            np.asarray(out["tsids"]).tobytes()

    async def go():
        out = {"hosts": hosts, "num_buckets": num_buckets,
               "grid_cells": hosts * num_buckets}
        e = await MetricEngine.open("cfg14", MemoryObjectStore(),
                                    segment_ms=segment_ms, config=cfg(),
                                    device=dev)
        try:
            chunk = max(1, 1_000_000 // hosts) * hosts
            for lo in range(0, n, chunk):
                hi = min(n, lo + chunk)
                await e.write_arrow("cpu", ["host"], _host_record_batch(
                    names, host_id[lo:hi], ts[lo:hi], vals[lo:hi]))
            table = e.tables["data"]
            reader = table.reader
            full = TimeRange.new(T0, T0 + span)

            async def full_span():
                got = await e.query_downsample(
                    "cpu", [], full, bucket_ms=bucket_ms, aggs=aggs,
                    use_rollup=False)
                _sync(dev)
                return got

            def true_cold():
                _clear_scan_tiers(table)

            _check_grid(await full_span(), d, T0, num_buckets, bucket_ms,
                        "config14 full span")
            # --- leg 1: cold full-span, sparse vs dense control ---
            legs, times = {}, {"sparse": [], "dense": []}
            l0 = _launches()
            for _ in range(k_cold):
                for mode in ("sparse", "dense"):
                    reader.config.scan.combine.mode = mode
                    true_cold()
                    t0 = time.perf_counter()
                    legs[mode] = await full_span()
                    times[mode].append(time.perf_counter() - t0)
            detail["cold_full_span_launches"] = _launches_since(l0)
            for mode, ts_ in times.items():
                out[f"cold_full_span_{mode}_p50_ms"] = round(
                    float(np.percentile(ts_, 50)) * 1e3, 3)
            reader.config.scan.combine.mode = "sparse"
            assert grid_bytes(legs["sparse"]) == grid_bytes(
                legs["dense"]), "sparse vs dense grids diverged"
            out["bit_identical_full_span"] = True

            # --- leg 2: top-k pushdown output bound ---
            true_cold()
            k = 5
            m0 = combine_mod._MATERIALIZED.value
            g0 = combine_mod._GRID.value
            t0 = time.perf_counter()
            top = await e.query_topk("cpu", [], full, bucket_ms, k=k,
                                     by="max", aggs=aggs, use_rollup=False)
            _sync(dev)
            out["topk_p50_ms"] = round((time.perf_counter() - t0) * 1e3, 3)
            out["topk_materialized_cells"] = int(
                combine_mod._MATERIALIZED.value - m0)
            out["topk_grid_cells"] = int(combine_mod._GRID.value - g0)
            want_cells = k * num_buckets * 3  # count, avg, max
            assert out["topk_materialized_cells"] == want_cells, \
                (out["topk_materialized_cells"], want_cells)
            out["topk_bound_ok"] = True
            # byte identity against the host-side dense rank
            reader.config.scan.combine.mode = "dense"
            true_cold()
            top_dense = await e.query_topk("cpu", [], full, bucket_ms,
                                           k=k, by="max", aggs=aggs,
                                           use_rollup=False)
            reader.config.scan.combine.mode = "sparse"
            assert list(top["tsids"]) == list(top_dense["tsids"])
            assert grid_bytes(top) == grid_bytes(top_dense)

            # --- leg 3: range refine (the delta-summation memo) ---
            def refine_ranges():
                qspan = max(segment_ms,
                            (span // 2 // bucket_ms) * bucket_ms)
                for frac in (1 / 4, 1 / 3, 1 / 2, 2 / 5):
                    lo = T0 + (int(span * frac) // bucket_ms) * bucket_ms
                    hi = min(T0 + span, lo + qspan)
                    yield TimeRange.new(lo, hi)

            async def refine_leg(memo_on: bool):
                true_cold()
                await full_span()  # records per-segment partials
                h0 = reader.parts_memo.stats()["hits"]
                mm0 = reader.parts_memo.stats()["misses"]
                times = []
                for r in refine_ranges():
                    # scan tiers cold, the memo per the leg
                    _drop_tier1(reader)
                    reader.encoded_cache.clear()
                    if not memo_on:
                        reader.parts_memo.clear()
                    t0 = time.perf_counter()
                    res = await e.query_downsample(
                        "cpu", [], r, bucket_ms=bucket_ms, aggs=aggs,
                        use_rollup=False)
                    _sync(dev)
                    times.append(time.perf_counter() - t0)
                st = reader.parts_memo.stats()
                return (float(np.percentile(times, 50)),
                        st["hits"] - h0,
                        (st["hits"] - h0) + (st["misses"] - mm0), res)

            p50_on, hits, probes, last_on = await refine_leg(True)
            p50_off, _h, _p, last_off = await refine_leg(False)
            out["refine_p50_ms"] = round(p50_on * 1e3, 3)
            out["refine_memo_off_p50_ms"] = round(p50_off * 1e3, 3)
            out["refine_memo_hit_segments"] = hits
            out["refine_probe_segments"] = probes
            out["refine_memo_fraction"] = round(hits / max(1, probes), 3)
            assert grid_bytes(last_on) == grid_bytes(last_off), \
                "memo-served refine diverged from recompute"
            out["bit_identical_refine"] = True
        finally:
            await e.close()
        return out

    # the legs measure storage/combine.py: force the parts route so the
    # counters and the A/B measure what they claim
    with _parts_route():
        out = asyncio.run(go())
    if dev.type == "cuda":
        assert detail["cold_full_span_launches"][
            "bucket_window_partials"], \
            "config14: the cold full-span legs launched no partials kernel"
    sparse = out["cold_full_span_sparse_p50_ms"]
    dense = out["cold_full_span_dense_p50_ms"]
    out["combine_speedup_full_span"] = round(dense / sparse, 3)
    out["refine_speedup"] = round(
        out["refine_memo_off_p50_ms"] / out["refine_p50_ms"], 2)
    _log(f"config14: cold full-span sparse {sparse:.1f} ms vs dense "
         f"{dense:.1f} ms ({out['combine_speedup_full_span']}x) | "
         f"top-k materialized {out['topk_materialized_cells']} cells "
         f"vs grid {out['topk_grid_cells']} | refine memo fraction "
         f"{out['refine_memo_fraction']} "
         f"({out['refine_speedup']}x vs memo off) | launches "
         f"{detail['cold_full_span_launches']}")
    return {
        "metric": (f"sparse combine: cold full-span downsample p50, "
                   f"{out['hosts']} hosts x {out['num_buckets']} "
                   f"buckets, {n / 1e6:.1f}M rows"),
        "value": sparse,
        "unit": "ms",
        # done-bar: dense-control / sparse on the cold full-span leg
        "vs_baseline": out["combine_speedup_full_span"],
        "rows": n,
        **out,
    }


# ---------------------------------------------------------------------------
# config 15: tenant isolation under overload, open loop, over HTTP
# ---------------------------------------------------------------------------


def run_config15(rows: int, iters: int, device="cuda",
                 scratch_dir: Optional[str] = None,
                 detail: Optional[dict] = None) -> dict:
    """Multi-tenant isolation under overload: an OPEN-LOOP load
    harness — arrivals fire on a precomputed Poisson schedule
    regardless of completions — over the port's HTTP server, simulated
    tenants mixing writes, cached dashboards and heavy scans:

      dash1/dash2   compliant: steady cached downsample dashboards on
                    a small table
      writer        compliant: steady small write batches (WAL path)
      abuser        floods heavy full-span scans of a long-tail table
                    plus oversized write batches

    Three legs on the SAME engine (caches warm, only policy changes):
      baseline      [tenants] on, no abuser  -> per-tenant p99 floor
      protected     [tenants] on, abuser on  -> weighted-fair admission
                    + WAL rate quota confine the damage
      unprotected   [tenants] off (global FIFO admission), abuser on

    Done-bars (recorded): worst compliant p99 in `protected` < 1.25x
    its `baseline` and the absolute SLO (dashboards < 500 ms p99,
    writes < 1 s p99, every compliant request served).  iters scales
    the per-leg duration, clamped to 4-30 s."""
    import random as random_mod
    import shutil

    import aiohttp
    import pyarrow as pa
    from aiohttp import web

    from horaedb_tpu_torch.common.tenant import tenants_from_dict
    from horaedb_tpu_torch.metric_engine import MetricEngine
    from horaedb_tpu_torch.objstore import (
        FaultInjectingStore,
        MemoryObjectStore,
    )
    from horaedb_tpu_torch.server.config import (
        AdmissionConfig,
        ReadableDuration,
        ServerConfig,
    )
    from horaedb_tpu_torch.server.main import ServerState, build_app
    from horaedb_tpu_torch.storage.config import StorageConfig, from_dict
    from horaedb_tpu_torch.storage.types import TimeRange
    from horaedb_tpu_torch.wal.config import WalConfig

    dev = resolve_device(device)
    detail = {} if detail is None else detail
    lat_s = float(os.environ.get("BENCH_STORE_LATENCY_MS", "20")) / 1e3
    hosts = 100
    interval = 10_000
    per_host = max(60, rows // hosts)
    span = per_host * interval
    segment_ms = 2 * 3600 * 1000
    T0 = (1_700_000_000_000 // segment_ms) * segment_ms
    n = per_host * hosts
    _check_i32_span(np.asarray([span]), "config15")
    leg_seconds = max(4.0, min(30.0, float(iters)))
    seed = int(os.environ.get("TENANT_BENCH_SEED", "15"))

    # the abuser's ad-hoc target: a long-tail historical slice spread
    # thin across many segments, so a cold scan is store-round-trip
    # bound
    seg_ad = 60
    n_ad = min(100_000, max(20_000, rows))
    T_AD0 = T0 - 90 * segment_ms
    span_ad = seg_ad * segment_ms

    heavy_q = {"metric": "adhoc", "filters": {}, "start": T_AD0,
               "end": T_AD0 + span_ad, "bucket_ms": 3_600_000}
    dash_q = {"metric": "app", "filters": {}, "start": T0,
              "end": T0 + min(span, 3_600_000), "bucket_ms": 300_000}

    def small_write(i: int) -> dict:
        # into the OPEN segment ahead of the dashboards' window: a
        # dashboard aggregate never pre-flushes the writer's rows
        return {"samples": [
            {"name": "app_ingest", "labels": {"host": f"w{j:02d}"},
             "timestamp": T0 + 3 * segment_ms + i * 1000 + j,
             "value": float(j)}
            for j in range(50)]}

    def big_write(i: int) -> dict:
        # a DAY behind the dashboards' range: flushed on the abuser's
        # dime
        return {"samples": [
            {"name": "junk", "labels": {"host": f"x{j:03d}"},
             "timestamp": T0 - 86_400_000 + i * 1000 + j,
             "value": float(j)}
            for j in range(400)]}

    def admission() -> AdmissionConfig:
        return AdmissionConfig(
            max_concurrent_queries=4, max_queued=128,
            queue_timeout=ReadableDuration.parse("6s"),
            query_timeout=ReadableDuration.parse("10s"))

    def tenants_cfg(enabled: bool):
        # the abuser is a low-priority ad-hoc class: one query slot, a
        # short queue, and a WAL rate cap
        return tenants_from_dict({
            "enabled": enabled,
            "tenant": {
                "dash1": {"weight": 4.0},
                "dash2": {"weight": 4.0},
                "writer": {"weight": 2.0},
                "abuser": {"weight": 1.0, "max_in_flight": 1,
                           "max_queued": 3,
                           "max_query_time": "1s",
                           "scan_bytes_per_s": "512kb",
                           "scan_burst_bytes": "2MiB",
                           "wal_bytes_per_s": "256kb",
                           "wal_burst_bytes": "1mb"},
            }})

    def schedule(rng, include_abuser: bool):
        """(at_s, tenant, path, payload) arrivals, time-sorted."""
        events = []

        def poisson(tenant, rate, make):
            t = 0.0
            for i in range(int(leg_seconds * rate)):
                t += rng.expovariate(rate)
                events.append((t, tenant) + make(i))

        for dash in ("dash1", "dash2"):
            poisson(dash, 5.0, lambda i: ("/query", dash_q))
        poisson("writer", 3.0, lambda i: ("/write", small_write(i)))
        if include_abuser:
            # each scan starts at a different segment so nothing
            # upstream can memoize the flood away
            poisson("abuser", 6.0, lambda i: (
                "/query", dict(heavy_q,
                               start=T_AD0 + (i % 12) * segment_ms)))
            if not os.environ.get("TENANT_BENCH_NO_ABUSE_WRITES"):
                poisson("abuser", 4.0, lambda i: ("/write", big_write(i)))
        events.sort(key=lambda e: e[0])
        return events

    async def run_leg(engine, enabled: bool, include_abuser: bool,
                      rng) -> dict:
        cfg = ServerConfig()
        cfg.admission = admission()
        cfg.tenants = tenants_cfg(enabled)
        state = ServerState(engine, cfg)
        app = build_app(state)
        runner = web.AppRunner(app)
        await runner.setup()
        site = web.TCPSite(runner, "127.0.0.1", 0)
        await site.start()
        port = runner.addresses[0][1]
        base = f"http://127.0.0.1:{port}"
        lat: dict = {}
        codes: dict = {}
        # unbounded connector: a pooled client would queue arrivals
        # client-side in the collapsing leg and re-close the open loop
        session = aiohttp.ClientSession(
            connector=aiohttp.TCPConnector(limit=0),
            timeout=aiohttp.ClientTimeout(total=30))

        async def fire(tenant, path, payload):
            t0 = time.perf_counter()
            try:
                r = await session.post(base + path, json=payload,
                                       headers={"X-Tenant": tenant})
                status = r.status
                await r.release()
            except asyncio.TimeoutError:
                status = -1
            except aiohttp.ClientError:
                # a collapsing leg can drop keep-alive connections
                # mid-request: a data point (failure code)
                status = -2
            dt = time.perf_counter() - t0
            lat.setdefault((tenant, path), []).append(dt)
            k = (tenant, path)
            codes.setdefault(k, {})
            codes[k][status] = codes[k].get(status, 0) + 1

        try:
            # unmeasured preamble: one of each request shape
            for tenant, path, payload in (
                    ("dash1", "/query", dash_q),
                    ("dash2", "/query", dash_q),
                    ("writer", "/write", small_write(0)),
                    ("abuser", "/write", big_write(0)),
                    ("abuser", "/query", heavy_q)):
                r = await session.post(base + path, json=payload,
                                       headers={"X-Tenant": tenant})
                await r.release()
            lat.clear()
            codes.clear()
            tasks = []
            start = time.perf_counter()
            for at, tenant, path, payload in schedule(
                    rng, include_abuser):
                delay = start + at - time.perf_counter()
                if delay > 0:
                    await asyncio.sleep(delay)
                tasks.append(asyncio.create_task(
                    fire(tenant, path, payload)))
            await asyncio.gather(*tasks)
        finally:
            await session.close()
            await runner.cleanup()
        out = {}
        for (tenant, path), ls in sorted(lat.items()):
            ok = codes[(tenant, path)].get(200, 0)
            kind = "query" if path == "/query" else "write"
            arr = np.asarray(ls) * 1e3
            out[f"{tenant}_{kind}"] = {
                "n": len(ls),
                "p50_ms": round(float(np.percentile(arr, 50)), 1),
                "p99_ms": round(float(np.percentile(arr, 99)), 1),
                "ok": ok,
                "codes": {str(k): v for k, v in sorted(
                    codes[(tenant, path)].items())},
            }
        return out

    async def go():
        store = FaultInjectingStore(MemoryObjectStore(), seed=seed,
                                    latency_range=(lat_s, lat_s))
        wal_dir = _scratch("cfg15", scratch_dir)
        rng_np = np.random.default_rng(seed)
        try:
            # bulk ingest WAL-free, then reopen with the WAL front end
            engine = await MetricEngine.open("cfg15", store,
                                             segment_ms=segment_ms,
                                             device=dev)
            ts = T0 + np.repeat(
                np.arange(per_host, dtype=np.int64) * interval, hosts)
            host_id = np.tile(np.arange(hosts, dtype=np.int32), per_host)
            vals = (rng_np.random(n) * 100).astype(np.float64)
            names = pa.array([f"host_{i:03d}" for i in range(hosts)])
            chunk = max(1, 1_000_000 // hosts) * hosts
            for lo in range(0, n, chunk):
                hi = min(n, lo + chunk)
                await engine.write_arrow("cpu", ["host"], _host_record_batch(
                    names, host_id[lo:hi], ts[lo:hi], vals[lo:hi]))
            # ...the small table the dashboards watch
            m = 20 * 360
            await engine.write_arrow("app", ["host"], pa.record_batch({
                "host": pa.array([f"app_{i % 20:02d}" for i in range(m)]),
                "timestamp": pa.array(
                    T0 + np.arange(m, dtype=np.int64) * 10_000 % span,
                    type=pa.int64()),
                "value": pa.array(rng_np.random(m), type=pa.float64()),
            }))
            # ...and the long-tail slice the abuser hammers: n_ad rows
            # spread evenly across seg_ad two-hour segments
            ad_hosts = 50
            ad_per_host = n_ad // ad_hosts
            ad_ts = T_AD0 + np.repeat(
                np.arange(ad_per_host, dtype=np.int64)
                * (span_ad // ad_per_host), ad_hosts)
            ad_ids = np.tile(np.arange(ad_hosts, dtype=np.int32),
                             ad_per_host)
            ad_names = pa.array([f"svc_{i:02d}" for i in range(ad_hosts)])
            await engine.write_arrow("adhoc", ["host"], pa.record_batch({
                "host": pa.DictionaryArray.from_arrays(
                    pa.array(ad_ids), ad_names),
                "timestamp": pa.array(ad_ts, type=pa.int64()),
                "value": pa.array(rng_np.random(len(ad_ts)),
                                  type=pa.float64()),
            }))
            await engine.close()
            # serving config: the historical slice overwhelms the
            # window budget, tier 2, the parts memo and the pipeline are
            # off — the abuser's scans pay the store latency segment by
            # segment, every time; the dashboard table stays resident
            serving_cfg = from_dict(StorageConfig, {
                "scan": {"cache_max_rows": 20_000,
                         "cache": {"tier2_max_bytes": 0},
                         "combine": {"memo_max_bytes": 0},
                         "pipeline": {"enabled": False}},
            })
            engine = await MetricEngine.open(
                "cfg15", store, segment_ms=segment_ms, config=serving_cfg,
                wal_config=WalConfig(enabled=True, dir=wal_dir),
                device=dev)
            try:
                # warm both query shapes
                await engine.query_downsample(
                    "adhoc", [], TimeRange.new(T_AD0, T_AD0 + span_ad),
                    bucket_ms=3_600_000, aggs=("avg",))
                await engine.query_downsample(
                    "app", [], TimeRange.new(T0, T0 + min(span,
                                                          3_600_000)),
                    bucket_ms=300_000, aggs=("avg",))
                _sync(dev)
                out = {"rows": n, "leg_seconds": leg_seconds,
                       "store_latency_ms": lat_s * 1e3}
                # a FRESH rng per leg: protected and unprotected replay
                # the IDENTICAL Poisson arrival realization
                for leg, on, abuse in (("baseline", True, False),
                                       ("protected", True, True),
                                       ("unprotected", False, True)):
                    _log(f"config15: leg {leg} (tenants "
                         f"{'on' if on else 'off'}, "
                         f"{'abuse' if abuse else 'no abuse'})")
                    l0 = _launches()
                    out[leg] = await run_leg(engine, on, abuse,
                                             random_mod.Random(seed))
                    detail[f"{leg}_launches"] = _launches_since(l0)
                return out
            finally:
                await engine.close()
        finally:
            shutil.rmtree(wal_dir, ignore_errors=True)

    out = asyncio.run(go())
    if dev.type == "cuda":
        assert any(detail["protected_launches"].values()), \
            "config15: the protected leg launched no kernel"

    compliant = ("dash1_query", "dash2_query", "writer_write")
    degr = {}
    for leg in ("protected", "unprotected"):
        worst = 0.0
        for k in compliant:
            base = out["baseline"][k]["p99_ms"]
            now = out[leg][k]["p99_ms"]
            if base > 0:
                worst = max(worst, now / base)
        degr[leg] = round(worst, 3)
    out["protected_p99_degradation"] = degr["protected"]
    out["unprotected_p99_degradation"] = degr["unprotected"]
    out["bar_relative_ok"] = degr["protected"] < 1.25
    # the stated SLO bar, absolute: compliant dashboards answer < 500 ms
    # p99 and compliant writes ack < 1 s p99 WITH the abuser flooding,
    # every request served
    out["slo_query_p99_ms"] = 500.0
    out["slo_write_p99_ms"] = 1000.0
    out["bar_slo_ok"] = all(
        out["protected"][k]["p99_ms"]
        < (out["slo_write_p99_ms"] if k.endswith("_write")
           else out["slo_query_p99_ms"])
        and out["protected"][k]["codes"].get("200", 0)
        == out["protected"][k]["n"]
        for k in compliant)
    out["slo_unprotected_ok"] = all(
        out["unprotected"][k]["p99_ms"]
        < (out["slo_write_p99_ms"] if k.endswith("_write")
           else out["slo_query_p99_ms"])
        for k in compliant)
    out["control_shows_damage"] = (degr["unprotected"]
                                   > degr["protected"])
    abuser = out["protected"].get("abuser_query", {})
    out["abuser_sheds_protected"] = (abuser.get("codes", {})
                                     .get("429", 0))
    worst_ms = max(out["protected"][k]["p99_ms"] for k in compliant)
    _log(f"config15: compliant SLO under abuse "
         f"{'MET' if out['bar_slo_ok'] else 'MISSED'} (worst p99 "
         f"{worst_ms:.0f} ms) vs unprotected SLO "
         f"{'met' if out['slo_unprotected_ok'] else 'blown'} | "
         f"p99 degradation protected {degr['protected']}x vs "
         f"unprotected {degr['unprotected']}x | abuser 429s "
         f"{out['abuser_sheds_protected']} | launches "
         f"{detail['protected_launches']}")
    return {
        "metric": (f"multi-tenant isolation: worst compliant p99 under "
                   f"abuse with weighted-fair admission + quotas, "
                   f"{n / 1e6:.1f}M rows, open-loop"),
        "value": worst_ms,
        "unit": "ms",
        # how much worse the unprotected control degrades compliant
        # tenants than the protected plane does
        "vs_baseline": round(
            degr["unprotected"] / max(degr["protected"], 1e-9), 2),
        **out,
    }


# ---------------------------------------------------------------------------
# config 16: device decode A/B
# ---------------------------------------------------------------------------


def run_config16(rows: int, iters: int, device="cuda",
                 detail: Optional[dict] = None) -> dict:
    """Device-native decode A/B: the config-13 cold-scan workload over
    the seeded 25 ms-latency fault store, `[scan.decode] mode =
    "device"` against host decode — everything else identical:

      host      host decode, the default aggregate route
      xla_host  the reference's accelerator-shaped control (host decode
                feeding the device window kernel, HORAEDB_HOST_AGG=0).
                The port has no host-aggregate route, so on the port
                `host` and `xla_host` are one route, run twice; both
                sets of keys are reported and `note` says so
      device    [scan.decode] mode = "device"

    Legs per control: cached, tier2_cold (tier 1 and the parts memo
    evicted, tier 2 warm: decode cost, zero store I/O), true_cold (all
    tiers cleared, pipelined), plus device-leg pipeline-off twins and
    zero-latency-store legs.  Each pipelined leg diffs
    plan_stage_snapshot for per-stage seconds and stall counts.

    The byte-identity gate runs one cold query per mode before any
    timing.  An explicit mode = "device" outranks the fused gate;
    mode = "host" does not, so at this budget the host legs take the
    fused route, whose float32 sums are a tolerance contract: device
    decode is held against host decode byte for byte with both on the
    parts route, and the default host route within rtol 1e-5 of them.
    The route each leg took is recorded from its kernel launches (on
    the card) and its result."""
    from horaedb_tpu_torch.metric_engine import MetricEngine
    from horaedb_tpu_torch.objstore import (
        FaultInjectingStore,
        MemoryObjectStore,
    )
    from horaedb_tpu_torch.ops import device_decode as dd_mod
    from horaedb_tpu_torch.storage.config import StorageConfig, from_dict
    from horaedb_tpu_torch.storage.read import plan_stage_snapshot
    from horaedb_tpu_torch.storage.types import TimeRange

    dev = resolve_device(device)
    detail = {} if detail is None else detail
    lat_s = float(os.environ.get("BENCH_STORE_LATENCY_MS", "25")) / 1e3
    d = _host_rows(16, rows)
    n, span, T0, segment_ms = d["n"], d["span"], d["T0"], d["segment_ms"]
    bucket_ms = 60_000
    nb = -(-span // bucket_ms)
    _check_i32_span(np.asarray([span]), "config16")
    k_cold = max(3, iters // 3)

    def cfg_of(mode: str, pipelined: bool = True):
        return from_dict(StorageConfig, {
            "scheduler": {"schedule_interval": "1h"},
            "scan": {"cache_max_rows": n * 4,
                     "cache": {"tier2_max_bytes": 1 << 30},
                     "pipeline": {"enabled": pipelined},
                     "decode": {"mode": mode}},
        })

    last: dict = {}

    async def query(e):
        out = await e.query_downsample(
            "cpu", [], TimeRange.new(T0, T0 + span),
            bucket_ms=bucket_ms, aggs=("avg",))
        _sync(dev)
        last["out"] = out
        return out

    def fallbacks() -> dict:
        return {k: int(v) for k, v in dd_mod.fallback_counts().items()
                if v}

    async def timed(e, reps: int, reset=None, profile: bool = False):
        times, prof = [], {}
        for i in range(reps):
            if reset is not None:
                reset()
            before = plan_stage_snapshot() if profile and i == 0 else None
            t0 = time.perf_counter()
            await query(e)
            times.append(time.perf_counter() - t0)
            if before is not None:
                after = plan_stage_snapshot()
                prof = {kk: round(after[kk] - before[kk], 4)
                        for kk in after if after[kk] != before[kk]}
        return float(np.percentile(times, 50)), prof

    def stall_ratio(prof: dict) -> float:
        # device-starved-on-decode: consumer stalls per decode stall
        return round(prof.get("pipeline_stalls_device", 0)
                     / max(1, prof.get("pipeline_stalls_decode", 0)), 2)

    async def go():
        out = {"store_latency_ms": lat_s * 1e3}
        raw = MemoryObjectStore()
        store = _data_get_counter(FaultInjectingStore(
            raw, seed=16, latency_range=(lat_s, lat_s)))
        e = await MetricEngine.open("cfg16", store, segment_ms=segment_ms,
                                    config=cfg_of("host"), device=dev)
        try:
            await _ingest(e, d)
        finally:
            await e.close()

        gets_mark = store.data_gets

        def leg_gets() -> int:
            nonlocal gets_mark
            prev, gets_mark = gets_mark, store.data_gets
            return gets_mark - prev

        # byte-identity gate before any timing: one cold query per
        # mode, both on the parts route; then the host mode's default
        # route against them
        grids = {}
        for mode, forced in (("device", True), ("host", True),
                             ("host", False)):
            e = await MetricEngine.open("cfg16", store,
                                        segment_ms=segment_ms,
                                        config=cfg_of(mode), device=dev)
            try:
                _clear_scan_tiers(e.tables["data"])
                if forced:
                    with _parts_route():
                        grids[mode, forced] = await query(e)
                else:
                    grids[mode, forced] = await query(e)
            finally:
                await e.close()
        _same_bytes(grids["device", True], grids["host", True],
                    "config16 device vs host decode (parts route)")
        _hold_to_parts(grids["host", False], grids["host", True],
                       "config16 host decode, default route")
        _check_grid(grids["device", True], d, T0, nb, bucket_ms,
                    "config16 device decode")
        out["bit_identity"] = (
            "byte-equal on the parts route (HORAEDB_FUSED_AGG=0); the "
            f"default host route ({_route(grids['host', False])}) "
            + ("byte-equal" if _route(grids["host", False]) == "parts"
               else "within rtol 1e-5"))

        # the three legs: host decode on the default route, the
        # reference's accelerator-shaped control (the same route here)
        # and device decode
        routes = {}
        for mode, leg in (("host", "host"), ("host", "xla_host"),
                          ("device", "device")):
            fb0 = fallbacks()
            e = await MetricEngine.open("cfg16", store,
                                        segment_ms=segment_ms,
                                        config=cfg_of(mode), device=dev)
            try:
                table = e.tables["data"]
                await query(e)  # warm both tiers
                leg_gets()
                l0 = _launches()
                r0 = int(dd_mod._STAGE_ROWS.value)
                cached, _ = await timed(e, iters)
                out[f"{leg}_cached_p50_ms"] = round(cached * 1e3, 3)

                def tier2_reset(t=table):
                    # tier 1 AND the parts memo dropped, tier 2 kept:
                    # pure decode cost, zero store I/O
                    _drop_tier1(t.reader)
                    t.reader.parts_memo.clear()

                tier2, prof2 = await timed(e, k_cold, reset=tier2_reset,
                                           profile=True)
                out[f"{leg}_tier2_cold_p50_ms"] = round(tier2 * 1e3, 3)
                out[f"{leg}_stage_profile_tier2"] = prof2
                cold, prof0 = await timed(
                    e, k_cold,
                    reset=lambda t=table: _clear_scan_tiers(t),
                    profile=True)
                out[f"{leg}_true_cold_p50_ms"] = round(cold * 1e3, 3)
                out[f"{leg}_data_gets_true_cold"] = leg_gets()
                out[f"{leg}_stage_profile_true_cold"] = prof0
                out[f"{leg}_stall_ratio_true_cold"] = stall_ratio(prof0)
                out[f"{leg}_host_decode_s_per_cold_query"] = round(
                    prof0.get("encode_merge_s", 0.0), 4)
                detail[f"{leg}_launches"] = _launches_since(l0)
                dec_rows = int(dd_mod._STAGE_ROWS.value) - r0
                routes[leg] = ("fused" if _route(last["out"]) == "fused"
                               else "parts, device decode" if dec_rows
                               else "parts, host decode")
                _hold_to_parts(last["out"], grids["host", True],
                               f"config16 {leg} true cold")
            finally:
                await e.close()
            if leg == "device":
                fb1 = fallbacks()
                out["decode_fallbacks"] = {
                    k: v - fb0.get(k, 0) for k, v in fb1.items()
                    if v != fb0.get(k, 0)}
        detail["routes"] = routes

        # pipeline-off device legs
        e = await MetricEngine.open("cfg16", store, segment_ms=segment_ms,
                                    config=cfg_of("device",
                                                  pipelined=False),
                                    device=dev)
        try:
            table = e.tables["data"]
            await query(e)

            def tier2_reset_off(t=table):
                _drop_tier1(t.reader)
                t.reader.parts_memo.clear()

            tier2_off, _ = await timed(e, k_cold, reset=tier2_reset_off)
            out["device_tier2_cold_pipeline_off_p50_ms"] = round(
                tier2_off * 1e3, 3)
            cold_off, _ = await timed(
                e, k_cold, reset=lambda t=table: _clear_scan_tiers(t))
            out["device_true_cold_pipeline_off_p50_ms"] = round(
                cold_off * 1e3, 3)
        finally:
            await e.close()

        # zero-latency-store legs (the same objects, the raw memory
        # store under the fault wrapper)
        for mode in ("host", "device"):
            for pipelined in (True, False):
                e = await MetricEngine.open(
                    "cfg16", raw, segment_ms=segment_ms,
                    config=cfg_of(mode, pipelined=pipelined), device=dev)
                try:
                    table = e.tables["data"]
                    await query(e)
                    cold0, _ = await timed(
                        e, k_cold,
                        reset=lambda t=table: _clear_scan_tiers(t))
                    key = (f"{mode}_true_cold_zero_latency"
                           f"{'' if pipelined else '_pipeline_off'}"
                           "_p50_ms")
                    out[key] = round(cold0 * 1e3, 3)
                finally:
                    await e.close()
        return out

    out = asyncio.run(go())
    routes = detail["routes"]
    if dev.type == "cuda":
        dl = detail["device_launches"]
        assert dl["bucket_window_partials"] and not dl[
            "bucket_round_accumulate"], \
            f"config16: the device leg's launches {dl}"
        assert not out["decode_fallbacks"], \
            f"config16: device decode fell back {out['decode_fallbacks']}"
    dev_cold = out["device_true_cold_p50_ms"]
    host_cold = out["host_true_cold_p50_ms"]
    xla_cold = out["xla_host_true_cold_p50_ms"]
    out["decode_speedup_true_cold_vs_cpu_default"] = round(
        host_cold / dev_cold, 2)
    out["decode_speedup_true_cold_vs_xla_control"] = round(
        xla_cold / dev_cold, 2)
    out["decode_speedup_tier2_vs_xla_control"] = round(
        out["xla_host_tier2_cold_p50_ms"]
        / out["device_tier2_cold_p50_ms"], 2)
    out["regrade_pipeline_speedup_device"] = round(
        out["device_true_cold_pipeline_off_p50_ms"] / dev_cold, 2)
    out["regrade_tier2_pipeline_overhead_device"] = round(
        out["device_tier2_cold_p50_ms"]
        / out["device_tier2_cold_pipeline_off_p50_ms"], 2)
    out["regrade_r6_zero_latency_pipeline_overhead_host"] = round(
        out["host_true_cold_zero_latency_p50_ms"]
        / out["host_true_cold_zero_latency_pipeline_off_p50_ms"], 2)
    out["regrade_r6_zero_latency_pipeline_overhead_device"] = round(
        out["device_true_cold_zero_latency_p50_ms"]
        / out["device_true_cold_zero_latency_pipeline_off_p50_ms"], 2)
    prof_d = out["device_stage_profile_true_cold"]
    prof_h = out["host_stage_profile_true_cold"]
    out["encoded_bytes_uploaded_per_cold_query"] = int(
        prof_d.get("device_decode_bytes", 0))
    out["host_decoded_window_bytes_per_cold_query"] = int(
        prof_h.get("pipeline_decode_bytes", 0))
    out["host_decode_removed"] = (
        f"{out['host_host_decode_s_per_cold_query']}s encode/merge per "
        f"cold query on the host legs -> "
        f"{out['device_host_decode_s_per_cold_query']}s on the device "
        f"leg (pad+upload only)")
    out["note"] = (
        "the port has no host-aggregate route (HORAEDB_HOST_AGG): the "
        "host and xla_host legs run one route twice. Routes taken: "
        + ", ".join(f"{k} {v}" for k, v in routes.items())
        + ". Device decode is held byte for byte against host decode "
        "on the parts route; a fused leg within rtol 1e-5.")
    _log(f"config16: true-cold device {dev_cold:.1f} ms vs host "
         f"{host_cold:.1f} ms "
         f"({out['decode_speedup_true_cold_vs_cpu_default']}x) | stall "
         f"ratio device {out['device_stall_ratio_true_cold']} vs host "
         f"{out['host_stall_ratio_true_cold']} | pipeline re-grade "
         f"{out['regrade_pipeline_speedup_device']}x | routes {routes}, "
         f"launches {[detail[f'{k}_launches'] for k in routes]}")
    return {
        "metric": (f"device-native decode: true-cold downsample p50 "
                   f"over a seeded {out['store_latency_ms']:.0f}ms"
                   f"-latency store, {n / 1e6:.1f}M rows, device vs "
                   f"host decode"),
        "value": out["device_true_cold_p50_ms"],
        "unit": "ms",
        "vs_baseline": out["decode_speedup_true_cold_vs_xla_control"],
        "rows": n,
        **out,
    }


# ---------------------------------------------------------------------------
# config 17: near-data scan agents
# ---------------------------------------------------------------------------


def _data_byte_counter(inner, prefix: str):
    """The coordinator's data-plane accounting: bytes and ops of the
    data table's .sst/.enc reads, buffered and streamed.  It hides
    local_path, so a disk store's fallback reads go through the
    countable get/get_stream surface."""
    from horaedb_tpu_torch.objstore import WrappedObjectStore

    class DataByteCounter(WrappedObjectStore):
        def __init__(self, inner, prefix: str):
            super().__init__(inner)
            self.prefix = prefix
            self.data_bytes = 0
            self.data_gets = 0
            self.stream_ops = 0

        def _is_data(self, path) -> bool:
            p = str(path)
            return p.startswith(self.prefix) \
                and p.endswith((".sst", ".enc"))

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

    return DataByteCounter(inner, prefix)


def run_config17(rows: int, iters: int, device="cuda",
                 scratch_dir: Optional[str] = None,
                 detail: Optional[dict] = None) -> dict:
    """Near-data scan agents: the cold dashboard mix over a seeded
    25 ms-latency object store, agent-served partials vs the direct
    scan.

    Legs:
      off          no router: every covered segment's bytes ship to
                   the coordinator (the control)
      agent        [scanagent] routes every segment to an agent on the
                   raw inner store: the coordinator's data-plane bytes
                   become O(groups x buckets x aggs) partials
      agent_killed the agent dies: queries complete through the
                   per-segment fallback (direct reads), accounted
      disk         a LocalObjectStore rung: ZERO coordinator segment
                   reads on the agent path, and the dead-agent
                   fallback STREAMS whole SSTs

    Done-bar: coordinator data-plane bytes (store bytes + received
    partial bytes) reduced >= 5x on the agent leg (recorded), grids
    checked in-bench.  The agent serves aggregate partials on the parts
    route, with `[scan.decode] mode = "device"` (under "auto" a
    one-segment plan keeps host decode).  The reference holds the
    agent's grids to the off leg's byte for byte; at this budget the
    off leg takes the fused route, whose float32 sums are a tolerance
    contract, so here an `off` leg on the parts route
    (HORAEDB_FUSED_AGG=0, in `detail`) is the byte-for-byte control of
    the agent, killed-agent and disk legs, and the fused off leg agrees
    with it within rtol 1e-5; `detail` records whether the reference's
    check would hold.  Every leg's grids are checked against numpy."""
    import shutil

    from horaedb_tpu_torch.common import memledger
    from horaedb_tpu_torch.metric_engine import MetricEngine
    from horaedb_tpu_torch.objstore import (
        FaultInjectingStore,
        LocalObjectStore,
        MemoryObjectStore,
    )
    from horaedb_tpu_torch.ops import device_decode as dd_mod
    from horaedb_tpu_torch.scanagent import (
        AgentService,
        AgentSpec,
        ScanAgentConfig,
    )
    from horaedb_tpu_torch.scanagent import client as sa_client
    from horaedb_tpu_torch.storage import parquet_io
    from horaedb_tpu_torch.storage.config import StorageConfig, from_dict
    from horaedb_tpu_torch.storage.types import TimeRange
    from horaedb_tpu_torch.utils import registry, tracing

    dev = resolve_device(device)
    detail = {} if detail is None else detail
    lat_s = float(os.environ.get("BENCH_STORE_LATENCY_MS", "25")) / 1e3
    d = _host_rows(17, rows)
    n, span, T0, segment_ms = d["n"], d["span"], d["T0"], d["segment_ms"]
    _check_i32_span(np.asarray([span]), "config17")
    reps = max(2, iters // 3)

    cfg = from_dict(StorageConfig, {
        "scheduler": {"schedule_interval": "1h"},
        "scan": {"cache_max_rows": n * 4},
    })
    agent_cfg = from_dict(StorageConfig, {"scan": {"decode": {
        "mode": "device"}}})

    zoom_ms = min(span, 6 * 3600 * 1000)

    def queries(rep: int) -> list:
        """The cold dashboard mix: one full-span 1h overview + two
        rotating zooms at 1m resolution, as (lo, hi, bucket, aggs)."""
        out = [(T0, T0 + span, 3_600_000, ("avg",))]
        for z in range(2):
            lo = T0 + ((rep * 2 + z) * zoom_ms) % max(1, span - zoom_ms + 1)
            out.append((lo, lo + zoom_ms, 60_000, ("avg", "max")))
        return out

    async def mix(e, rep: int) -> list:
        out = []
        for lo, hi, bms, aggs in queries(rep):
            out.append(await e.query_downsample(
                "cpu", [], TimeRange.new(lo, hi), bucket_ms=bms,
                aggs=aggs))
        _sync(dev)
        return out

    def grids_bytes(results: list) -> bytes:
        buf = bytearray()
        for r in results:
            buf += np.asarray(r["tsids"], dtype=np.uint64).tobytes()
            g = _host_grids(r)
            for k in sorted(g):
                buf += g[k].tobytes()
        return bytes(buf)

    def numpy_checks(results: list, label: str) -> None:
        for rep, got in enumerate(results):
            for (lo, hi, bms, _aggs), r in zip(queries(rep), got):
                _check_grid(r, d, lo, -(-(hi - lo) // bms), bms,
                            f"config17 {label} rep {rep} {bms} ms")

    def hold(results: list, control: list, label: str) -> None:
        for rep, (xa, xb) in enumerate(zip(results, control)):
            for q, (ra, rb) in enumerate(zip(xa, xb)):
                _hold_to_parts(ra, rb, f"config17 {label} rep {rep} "
                               f"query {q}")

    async def timed_mix(e, counter, reset, label: str) -> dict:
        times, results = [], []
        partials0 = sa_client._PARTIAL_BYTES.value
        bytes0, gets0 = counter.data_bytes, counter.data_gets
        l0 = _launches()
        for rep in range(reps):
            reset()
            t0 = time.perf_counter()
            results.append(await mix(e, rep))
            times.append(time.perf_counter() - t0)
        detail[f"{label}_launches"] = _launches_since(l0)
        leg = {
            "p50_ms": round(float(np.percentile(times, 50)) * 1e3, 3),
            "store_data_bytes": counter.data_bytes - bytes0,
            "store_data_gets": counter.data_gets - gets0,
            "partial_bytes":
                int(sa_client._PARTIAL_BYTES.value - partials0),
        }
        leg["coordinator_bytes"] = (leg["store_data_bytes"]
                                    + leg["partial_bytes"])
        numpy_checks(results, label)
        _log(f"config17 {label}: p50 {leg['p50_ms']}ms, "
             f"store {leg['store_data_bytes']}B "
             f"({leg['store_data_gets']} gets) + partials "
             f"{leg['partial_bytes']}B; launches "
             f"{detail[f'{label}_launches']}")
        return {"leg": leg, "results": results}

    def cold_agent(agent) -> None:
        for t in agent._tables.values():
            _clear_scan_tiers(t)

    def snap(prefix: str) -> dict:
        return {k: v for k, v in registry.snapshot().items()
                if k.startswith(prefix)}

    def since(before: dict, prefix: str) -> dict:
        return {k: v - before.get(k, 0.0) for k, v in snap(prefix).items()
                if v != before.get(k, 0.0)}

    async def go():
        out: dict = {"store_latency_ms": lat_s * 1e3, "rows": n,
                     "reps_per_leg": reps}
        inner = MemoryObjectStore()
        coord_store = _data_byte_counter(FaultInjectingStore(
            inner, seed=17, latency_range=(lat_s, lat_s)),
            prefix="cfg17/data/")
        # ingest once (direct engine, no router)
        e = await MetricEngine.open("cfg17", coord_store,
                                    segment_ms=segment_ms, config=cfg,
                                    device=dev)
        try:
            await _ingest(e, d)
            data = e.tables["data"]
            # ---- off: the direct-scan control, default route --------
            off = await timed_mix(
                e, coord_store, lambda: _clear_scan_tiers(data), "off")
            out["off"] = off["leg"]
            # ---- off on the parts route: the byte-for-byte control --
            with _parts_route():
                off_parts = await timed_mix(
                    e, coord_store, lambda: _clear_scan_tiers(data),
                    "off_parts")
            detail["off_parts"] = off_parts["leg"]
            detail["off_route"] = _route(off["results"][0][0])
            hold(off["results"], off_parts["results"], "off vs off_parts")
        finally:
            await e.close()

        # ---- agent: near-data routing via [scanagent] ----------------
        agent = AgentService(inner, storage_config=agent_cfg, device=dev)
        url = await agent.start()
        sa_cfg = ScanAgentConfig(
            mode="on", num_slots=1,
            agents=(AgentSpec("shard0", url, (0,)),))
        e = await MetricEngine.open("cfg17", coord_store,
                                    segment_ms=segment_ms, config=cfg,
                                    scanagent_config=sa_cfg, device=dev)
        try:
            data = e.tables["data"]

            def cold_both():
                _clear_scan_tiers(data)
                cold_agent(agent)

            req0 = snap("scanagent_requests_total{")
            fb0 = snap("scanagent_fallback_total")
            dec0 = sum(dd_mod.fallback_counts().values())
            served = await timed_mix(e, coord_store, cold_both, "agent")
            out["agent"] = served["leg"]
            detail["agent_decode_fallbacks"] = int(
                sum(dd_mod.fallback_counts().values()) - dec0)
            detail["agent_requests"] = since(req0,
                                             "scanagent_requests_total{")
            detail["agent_fallbacks"] = since(fb0,
                                              "scanagent_fallback_total")
            assert not detail["agent_decode_fallbacks"], \
                "config17: device decode fell back at the agent"
            assert not detail["agent_fallbacks"] \
                and not out["agent"]["store_data_gets"], \
                "config17: the agent leg fell back to direct reads"
            # route-aware: the agent's parts-route grids byte for byte
            # the parts-route control's
            assert grids_bytes(sum(served["results"], [])) == grids_bytes(
                sum(off_parts["results"], [])), \
                "agent-served grids differ from the direct scan"
            out["bit_identical"] = True
            detail["reference_check_holds"] = (
                grids_bytes(sum(served["results"], []))
                == grids_bytes(sum(off["results"], [])))
            reduction = (off["leg"]["coordinator_bytes"]
                         / max(1, served["leg"]["coordinator_bytes"]))
            out["bytes_reduction_x"] = round(reduction, 2)
            out["bar_bytes_reduction"] = ">=5x"
            out["bar_bytes_reduction_met"] = bool(reduction >= 5.0)

            # one stitched trace of an agent-served query: the routing
            # span with the agent's spans under it
            cold_both()
            lo, hi, bms, aggs = queries(0)[0]
            trace = tracing.recorder.start("/query", forced=True)
            with tracing.trace_scope(trace):
                await e.query_downsample("cpu", [], TimeRange.new(lo, hi),
                                         bucket_ms=bms, aggs=aggs)
            done = tracing.recorder.finish(trace)
            rpc = {s["span_id"] for s in done["spans"]
                   if s["name"] == "scanagent_rpc"}
            under = [s for s in done["spans"]
                     if s["name"] == "scanagent/scan"
                     and s["parent_id"] in rpc]
            detail["trace"] = {"spans": len(done["spans"]),
                               "rpc_spans": len(rpc),
                               "agent_roots_under_rpc": len(under),
                               "counters": done["counters"]}
            assert rpc and len(under) == len(rpc), \
                "config17: the agent's spans are not stitched under the " \
                "routing spans"
            # the memory ledger with the agent's state resident
            memledger.ledger.sample_once()
            detail["ledger_after_agent_leg"] = {
                **memledger.ledger.summary(),
                "devices": memledger.device_memory()}

            # ---- agent_killed: fallback correctness + accounting -----
            fb0 = sa_client._FALLBACKS.total
            await agent.close()
            killed = await timed_mix(
                e, coord_store, lambda: _clear_scan_tiers(data),
                "agent_killed")
            out["agent_killed"] = killed["leg"]
            out["agent_killed"]["fallback_segments"] = \
                int(sa_client._FALLBACKS.total - fb0)
            assert out["agent_killed"]["fallback_segments"], \
                "config17: no fallback with the agent dead"
            hold(killed["results"], off_parts["results"],
                 "agent_killed vs off_parts")
        finally:
            await e.close()
            await agent.close()

        # ---- disk rung: nothing resident on the coordinator ----------
        tmp = _scratch("cfg17", scratch_dir)
        disk_agent = None
        try:
            local = LocalObjectStore(tmp)
            disk_store = _data_byte_counter(local, prefix="cfg17d/data/")
            e = await MetricEngine.open("cfg17d", disk_store,
                                        segment_ms=segment_ms, config=cfg,
                                        device=dev)
            try:
                await _ingest(e, d)
            finally:
                await e.close()
            disk_agent = AgentService(local, storage_config=agent_cfg,
                                      device=dev)
            url = await disk_agent.start()
            sa_cfg = ScanAgentConfig(
                mode="on", num_slots=1,
                agents=(AgentSpec("shard0", url, (0,)),))
            e = await MetricEngine.open("cfg17d", disk_store,
                                        segment_ms=segment_ms, config=cfg,
                                        scanagent_config=sa_cfg,
                                        device=dev)
            try:
                data = e.tables["data"]

                def cold_disk():
                    _clear_scan_tiers(data)
                    cold_agent(disk_agent)

                disk = await timed_mix(e, disk_store, cold_disk, "disk")
                out["disk"] = disk["leg"]
                hold(disk["results"], off_parts["results"],
                     "disk vs off_parts")
                # the near-data claim: the coordinator read zero segment
                # objects
                assert disk["leg"]["store_data_gets"] == 0, \
                    "coordinator read segments on the disk agent rung"
                out["disk"]["segments_resident_coordinator"] = 0

                # dead-agent fallback on disk STREAMS whole SSTs
                await disk_agent.close()
                old_min = parquet_io.STREAM_FETCH_MIN_BYTES
                parquet_io.STREAM_FETCH_MIN_BYTES = 1
                try:
                    _clear_scan_tiers(data)
                    # sidecar fetches buffer: force the parquet path
                    data.config.scan.use_sidecar = False
                    t0 = time.perf_counter()
                    fb = await mix(e, 0)
                    fb_ms = (time.perf_counter() - t0) * 1e3
                finally:
                    parquet_io.STREAM_FETCH_MIN_BYTES = old_min
                    data.config.scan.use_sidecar = True
                hold([fb], off_parts["results"][:1],
                     "disk fallback vs off_parts")
                out["disk_fallback"] = {
                    "p50_ms": round(fb_ms, 3),
                    "streamed_sst_reads": disk_store.stream_ops,
                }
                assert disk_store.stream_ops > 0, \
                    "dead-agent disk fallback did not stream SSTs"
            finally:
                await e.close()
        finally:
            if disk_agent is not None:
                await disk_agent.close()
            shutil.rmtree(tmp, ignore_errors=True)
        return out

    out = asyncio.run(go())
    if dev.type == "cuda":
        la = detail["agent_launches"]
        assert la["bucket_window_partials"] and not la[
            "bucket_round_accumulate"], \
            f"config17: the agent leg's launches {la}"
        if n > 1_000_000:
            # past one ingest chunk, a segment spans two SSTs: the
            # agent's device decode merges them
            assert la["kway_merge_perm"], \
                "config17: the agent's multi-SST segments did not run " \
                "kway_merge_perm"
        assert not detail["off_parts_launches"][
            "bucket_round_accumulate"], \
            "config17: the parts-route control ran fused rounds"
    _log(f"config17: coordinator bytes off/agent "
         f"{out['bytes_reduction_x']}x (bar 5x); off route "
         f"{detail['off_route']}; the reference's byte check against the "
         f"off leg would "
         f"{'hold' if detail['reference_check_holds'] else 'fail'}")
    return {
        "metric": (f"near-data scan agents: cold dashboard mix over a "
                   f"seeded {out['store_latency_ms']:.0f}ms-latency "
                   f"store, {n / 1e6:.1f}M rows, agent partials vs "
                   f"shipped segments"),
        "value": out["agent"]["p50_ms"],
        "unit": "ms",
        # done-bar: coordinator data-plane bytes, off / agent
        "vs_baseline": out["bytes_reduction_x"],
        **out,
    }


# ---------------------------------------------------------------------------
# config 18: the memory ledger's accuracy and overhead
# ---------------------------------------------------------------------------


def _rss_split() -> dict:
    """VmRSS and its anonymous, file-backed and shared-memory parts
    from /proc/self/status, in bytes (empty off Linux)."""
    keys = (b"VmRSS:", b"RssAnon:", b"RssFile:", b"RssShmem:")
    out = {}
    try:
        with open("/proc/self/status", "rb") as f:
            for line in f:
                if line.startswith(keys):
                    out[line.split(b":")[0].decode().lower()] = (
                        int(line.split()[1]) * 1024)
    except OSError:
        return {}
    return out


def _fixed_mmap_threshold() -> None:
    """Pin glibc's mmap threshold at its 128 KiB default for the rest
    of the process: every large buffer is then its own mapping, and a
    freed one leaves RSS at once.  glibc otherwise raises the threshold
    to the largest buffer freed so far (up to 32 MiB), and large
    buffers come from heaps whose freed pages stay resident."""
    import ctypes
    import ctypes.util

    name = ctypes.util.find_library("c")
    if name:
        libc = ctypes.CDLL(name)
        if hasattr(libc, "mallopt"):
            libc.mallopt(-3, 128 * 1024)  # M_MMAP_THRESHOLD


def _trim_heap() -> None:
    """Collect garbage and hand the heaps' free pages back to the
    system: Arrow's memory pool (release_unused) and the C heap
    (glibc's malloc_trim).  Freed-but-retained pages are nobody's
    bytes: a cache filled into them would not grow RSS, and a pool
    that purges them later would shrink RSS under a measurement."""
    import ctypes
    import ctypes.util
    import gc

    import pyarrow as pa

    gc.collect()
    pa.default_memory_pool().release_unused()
    name = ctypes.util.find_library("c")
    if name:
        libc = ctypes.CDLL(name)
        if hasattr(libc, "malloc_trim"):
            libc.malloc_trim(0)


def run_config18(rows: int, iters: int, device="cuda",
                 detail: Optional[dict] = None) -> dict:
    """Memory plane (common/memledger.py): two legs.

    ACCURACY — the config-9 cold-scan ladder shape (cached /
    hbm-evicted / tier2-cold / true-cold) with the memory ledger
    sampling around it: the accounts must TRACK the process RSS delta.
    Baseline RSS is sampled after ingest with every cache tier still
    EMPTY (write-through admission off), so the ladder's cache fill is
    new RSS.  Both samples follow a heap trim (_trim_heap): the ingest
    frees far more than the ladder keeps, and pages the heaps retained
    would take the cache fill without growing RSS; and the leg pins
    glibc's mmap threshold (_fixed_mmap_threshold, for the rest of the
    process), so the windows the ladder rebuilds leave RSS when freed.
    Before the baseline the ladder runs once, at full scale, on a
    throwaway engine, so what the process makes resident on a path's
    first run (on the card: the CUDA context, the kernel libraries,
    lazily loaded device modules, the CUDA runtime's pinned transfer
    staging) falls outside the measured ladder; the ledger keeps
    device bytes out of the host total.
    Bar: |unattributed_delta| < 20% of the RSS delta at peak (asserted
    at >= 1M rows).

    OVERHEAD — config 10's paired-delta method on the CACHED query
    path: the ledger disabled vs enabled with the sampler racing at
    100 ms and per-trace attribution.  Bar (recorded): < 2%."""
    from horaedb_tpu_torch.common.memledger import ledger
    from horaedb_tpu_torch.metric_engine import MetricEngine
    from horaedb_tpu_torch.objstore import (
        MemoryObjectStore,
        WrappedObjectStore,
    )
    from horaedb_tpu_torch.storage.config import StorageConfig, from_dict
    from horaedb_tpu_torch.storage.types import TimeRange
    from horaedb_tpu_torch.utils import tracing

    dev = resolve_device(device)
    detail = {} if detail is None else detail
    d = _host_rows(18, rows)
    n, span, T0, segment_ms = d["n"], d["span"], d["T0"], d["segment_ms"]
    bucket_ms = 60_000
    _check_i32_span(np.asarray([span]), "config18")
    k_cold = max(2, iters // 3)

    async def query(e):
        out = await e.query_downsample(
            "cpu", [], TimeRange.new(T0, T0 + span),
            bucket_ms=bucket_ms, aggs=("avg",))
        _sync(dev)
        return out

    async def timed(e, reps, reset=None):
        times = []
        for _ in range(reps):
            if reset is not None:
                reset()
            t0 = time.perf_counter()
            await query(e)
            times.append(time.perf_counter() - t0)
        return float(np.percentile(times, 50))

    class CopyOnGetStore(WrappedObjectStore):
        """A real object store's memory behavior: a GET materializes a
        FRESH buffer, so tier 2's pinned blobs are their own RSS."""

        async def _call(self, op: str, *args):
            r = await super()._call(op, *args)
            if op in ("get", "get_range"):
                return bytes(bytearray(r))
            return r

    async def warm_process(cfg) -> None:
        """The ladder once, at full scale, on a throwaway engine over
        the same rows, before the baseline: what the process makes
        resident the first time it runs a path at this size (on the
        card: the CUDA context, the kernel libraries and lazily loaded
        device modules, the CUDA runtime's pinned transfer staging; the
        allocators' first arenas) is the process's, not the ladder's."""
        e = await MetricEngine.open("cfg18w", CopyOnGetStore(
            MemoryObjectStore()), segment_ms=segment_ms, config=cfg,
            device=dev)
        try:
            table = e.tables["data"]
            await _ingest(e, d)
            for reset in (None, table.reader.drop_hbm_state,
                          lambda: _drop_tier1(table.reader),
                          lambda: _clear_scan_tiers(table), None):
                await timed(e, 1, reset=reset)
        finally:
            await e.close()

    async def accuracy() -> dict:
        out = {}
        _fixed_mmap_threshold()
        store = CopyOnGetStore(MemoryObjectStore())
        # write-through OFF: ingest must not touch tier 2
        cfg = from_dict(StorageConfig, {
            "scan": {"cache_max_rows": n * 4,
                     "cache": {"write_through": False}}})
        await warm_process(cfg)
        e = await MetricEngine.open("cfg18", store,
                                    segment_ms=segment_ms, config=cfg,
                                    device=dev)
        try:
            table = e.tables["data"]
            await _ingest(e, d)
            _trim_heap()
            base = ledger.sample_once()
            steps = [("baseline", _rss_split(), base["attributed_bytes"])]

            def step(name):
                steps.append((name, _rss_split(),
                              ledger.attributed()[0]))

            out["baseline_rss_bytes"] = base["rss_bytes"]
            out["baseline_attributed_bytes"] = base["attributed_bytes"]
            l0 = _launches()
            await query(e)  # warm both tiers
            out["cached_p50_ms"] = round(await timed(e, iters) * 1e3, 3)
            step("cached")
            out["hbm_evicted_p50_ms"] = round(await timed(
                e, k_cold, reset=table.reader.drop_hbm_state) * 1e3, 3)
            step("hbm_evicted")
            out["tier2_cold_p50_ms"] = round(await timed(
                e, k_cold,
                reset=lambda: _drop_tier1(table.reader)) * 1e3, 3)
            step("tier2_cold")
            out["true_cold_p50_ms"] = round(await timed(
                e, k_cold,
                reset=lambda: _clear_scan_tiers(table)) * 1e3, 3)
            step("true_cold")
            got = await query(e)  # peak: every tier re-warmed
            detail["ladder_launches"] = _launches_since(l0)
            _check_grid(got, d, T0, -(-span // bucket_ms), bucket_ms,
                        "config18 ladder")
            step("peak, untrimmed")
            _trim_heap()
            peak = ledger.sample_once()
            step("peak")
            # where the RSS went, leg by leg: the /proc split of RSS
            # and the attributed host bytes, each against the baseline
            detail["rss_steps"] = [
                {"step": nm,
                 **{k: v - steps[0][1].get(k, 0) for k, v in sp.items()},
                 "attributed": a - steps[0][2]} for nm, sp, a in steps]
            detail["account_deltas"] = {
                k: v - base["accounts"].get(k, 0)
                for k, v in peak["accounts"].items()
                if v != base["accounts"].get(k, 0)}
            detail["peak_devices"] = peak.get("devices")
            out["peak_rss_bytes"] = peak["rss_bytes"]
            out["peak_attributed_bytes"] = peak["attributed_bytes"]
            out["peak_accounts"] = {
                k: v for k, v in sorted(peak["accounts"].items()) if v}
            out["peak_unattributed_bytes"] = peak["unattributed_bytes"]
            rss_delta = peak["rss_bytes"] - base["rss_bytes"]
            attr_delta = (peak["attributed_bytes"]
                          - base["attributed_bytes"])
            out["rss_delta_bytes"] = rss_delta
            out["attributed_delta_bytes"] = attr_delta
            out["unattributed_delta_fraction"] = (
                round(1.0 - attr_delta / rss_delta, 4)
                if rss_delta > 0 else None)
            out["unattributed_fraction_absolute"] = (
                round(peak["unattributed_bytes"] / peak["rss_bytes"], 4)
                if peak["rss_bytes"] else None)
        finally:
            await e.close()
        return out

    async def overhead() -> dict:
        e = await MetricEngine.open("cfg18b", MemoryObjectStore(),
                                    segment_ms=segment_ms, device=dev)
        try:
            await _ingest(e, d)

            async def one(enabled: bool) -> float:
                """One traced query as the server drives it — tracing
                ON in both legs, so the paired delta isolates the
                ledger's marginal cost."""
                ledger.configure(enabled=enabled)
                t0 = time.perf_counter()
                trace = tracing.recorder.start("/query")
                if trace is not None:
                    with tracing.trace_scope(trace):
                        await query(e)
                    tracing.recorder.finish(trace)
                else:
                    await query(e)
                return time.perf_counter() - t0

            # the sampler racing at 100 ms during BOTH legs
            ledger.configure(interval_s=0.1)
            ledger.ensure_sampler()
            tracing.recorder.configure(enabled=True, sample_rate=1.0)
            reps = max(30, iters * 3)
            for _ in range(5):
                await one(True)
            acc = {"off": [], "on": []}
            order_rng = np.random.default_rng(0x18)
            for _ in range(reps):
                for k in order_rng.permutation(["off", "on"]):
                    acc[k].append(await one(k == "on"))
            out = {}
            for k, v in acc.items():
                out[f"{k}_p50_ms"] = round(
                    float(np.percentile(v, 50)) * 1e3, 4)
            off = np.asarray(acc["off"])
            delta = float(np.median(np.asarray(acc["on"]) - off))
            out["on_overhead_us"] = round(delta * 1e6, 1)
            out["on_overhead_pct"] = round(
                delta / float(np.median(off)) * 100, 3)
            return out
        finally:
            ledger.configure(enabled=True, interval_s=5.0)
            await e.close()

    async def go():
        return {"accuracy": await accuracy(), "overhead": await overhead()}

    out = asyncio.run(go())
    acc, ov = out["accuracy"], out["overhead"]
    frac = acc["unattributed_delta_fraction"]
    if dev.type == "cuda":
        assert any(detail["ladder_launches"].values()), \
            "config18: the ladder launched no kernel"
    _log(f"config18: ladder rss delta "
         f"{acc['rss_delta_bytes'] / 1e6:.1f} MB, attributed "
         f"{acc['attributed_delta_bytes'] / 1e6:.1f} MB, unattributed "
         f"fraction {frac} [bar < 0.2]; accounts {acc['peak_accounts']} "
         f"| cached overhead {ov['on_overhead_pct']}% "
         f"({ov['on_overhead_us']}us) [bar < 2%] | launches "
         f"{detail['ladder_launches']}")
    if n >= 1_000_000 and frac is not None:
        # the accuracy bar at real scale (a few-MB delta is allocator
        # noise); two-sided: a large positive residue is untracked
        # growth, a large negative one is over-charge
        assert abs(frac) < 0.2, (
            f"memory ledger lost track of the ladder: unattributed "
            f"delta fraction {frac}, |bar| 0.2 (accounts "
            f"{acc['peak_accounts']})")
    return {
        "metric": ("memory ledger: unattributed fraction of the "
                   "cold-scan ladder's RSS delta + cached-path "
                   "overhead of the ledger (paired)"),
        "value": ov["on_p50_ms"],
        "unit": "ms",
        # the paired ratio: the memory plane on vs off (bar < 1.02)
        "vs_baseline": round(ov["on_p50_ms"] / ov["off_p50_ms"], 4),
        "rows": n,
        **out,
    }


# ---------------------------------------------------------------------------
# configs 19 and 22: the mesh scans
# ---------------------------------------------------------------------------


def _mesh_slots(dev, what: str):
    """A scope over the local device list a mesh config runs on: the
    visible devices of `dev`'s type as installed, or, where
    MESH_BENCH_DEVICES asks for more, that many logical slots cycling
    over them."""
    import contextlib

    from horaedb_tpu_torch.parallel import mesh

    have = mesh.local_devices(dev)
    want = int(os.environ.get("MESH_BENCH_DEVICES", "0") or 0)
    if want and len(have) < want:
        _log(f"{what}: {len(have)} devices visible, MESH_BENCH_DEVICES="
             f"{want}: {want} logical slots over them")
        return mesh.local_devices_scope(
            [have[i % len(have)] for i in range(want)])
    return contextlib.nullcontext()


def _clear_storage(s) -> None:
    """Every scan tier of a CloudObjectStorage's reader emptied, the
    device state and the stack cache included."""
    s.reader.drop_hbm_state()
    s.reader.scan_cache.clear()
    s.reader.encoded_cache.clear()
    s.reader.parts_memo.clear()


def _same_scan(a, b, ctx: str) -> None:
    """Two scan_aggregate results (tsids, grids) equal byte for byte."""
    assert np.array_equal(np.asarray(a[0]), np.asarray(b[0])), ctx
    for k in a[1]:
        assert _host(a[1][k]).tobytes() == _host(b[1][k]).tobytes(), \
            (ctx, k)


def _seams() -> dict:
    """The device profiler's seams now: fn -> (dispatches, device
    seconds), the finished CUDA event pairs resolved first."""
    from horaedb_tpu_torch.common.deviceprof import profiler as dp

    return {r["fn"]: (r["dispatches"], r["exec_seconds"])
            for r in dp.snapshot()["fns"]}


def _seam_rounds(before: dict, after: dict, fn: str,
                 input_bytes: int) -> dict:
    """One mesh program's dispatches between two _seams() snapshots:
    device ms per dispatch, and the least time the card could take for
    the dispatch's input bytes (each read once) at the H100's 3.35 TB/s
    (a bytes bound: the rows' ts, group and value columns)."""
    d0, e0 = before.get(fn, (0, 0.0))
    d1, e1 = after.get(fn, (0, 0.0))
    n = d1 - d0
    per = input_bytes / max(1, n)
    return {"fn": fn, "dispatches": n,
            "device_ms_per_dispatch": (e1 - e0) * 1e3 / max(1, n),
            "input_bytes_per_dispatch": per,
            "bound_ms_per_dispatch": per / 3.35e12 * 1e3}


def run_config19(rows: int, iters: int, device="cuda",
                 detail: Optional[dict] = None) -> dict:
    """The 2-D mesh-scan A/B: the [scan.mesh] segmented-reduction
    combine vs the single-device control on the SAME data, both legs
    on the parts route (HORAEDB_FUSED_AGG=0) with host decode, so the
    A/B isolates WHERE the combine ran.

    Legs:
      control_cold / mesh_cold   full-span downsample, caches cleared
                                 per rep, grids byte-compared in-bench
      mesh_topk                  top-k by max through the device-scored
                                 winner-sliced path, egress cells
                                 counter-asserted at O(k x buckets x
                                 aggs) per run part

    The mesh spans parallel/mesh.local_devices(); MESH_BENCH_DEVICES=N
    asks for N logical slots over the visible cards (eight on one card
    check the design, not scaling)."""
    import pyarrow as pa

    from horaedb_tpu_torch.common import ReadableDuration
    from horaedb_tpu_torch.common import runtimes as runtimes_mod
    from horaedb_tpu_torch.objstore import MemoryObjectStore
    from horaedb_tpu_torch.storage import read as read_mod
    from horaedb_tpu_torch.storage.config import (
        StorageConfig,
        ThreadsConfig,
        from_dict,
    )
    from horaedb_tpu_torch.storage.plan import TopKSpec
    from horaedb_tpu_torch.storage.read import AggregateSpec, ScanRequest
    from horaedb_tpu_torch.storage.storage import (
        CloudObjectStorage,
        WriteRequest,
    )
    from horaedb_tpu_torch.storage.types import TimeRange

    dev = resolve_device(device)
    detail = {} if detail is None else detail
    slots = _mesh_slots(dev, "config19")

    hosts = 100
    segment_ms = 2 * 3600 * 1000
    segments = 16
    per_seg = max(hosts, rows // segments)
    bucket_ms = 60_000
    T0 = (1_700_000_000_000 // segment_ms) * segment_ms
    span = segments * segment_ms
    _check_i32_span(np.asarray([span]), "config19")
    schema = pa.schema([("host", pa.string()), ("ts", pa.int64()),
                        ("v", pa.float64())])
    rng = np.random.default_rng(19)

    def cfg_of(mesh: bool):
        # host decode pinned: the legs measure the mesh over host-decoded
        # windows (config 22 measures the mesh decode rounds).  "auto"
        # keeps host decode on the reference's CPU rung, but engages the
        # device decode on a card, where the top-k leg would then decline
        # the device-scored path (mixed provenance stays out of it)
        scan: dict = {"cache_max_rows": rows * 4,
                      "combine": {"memo_max_bytes": 0},
                      "cache": {"tier2_max_bytes": 1 << 30},
                      "decode": {"mode": "host"}}
        if mesh:
            scan["mesh"] = {"enabled": True}
        cfg = from_dict(StorageConfig, {
            "scheduler": {"schedule_interval": "1h"}, "scan": scan})
        cfg.manifest.merge_interval = ReadableDuration.parse("1h")
        cfg.scrub.interval = ReadableDuration.parse("1h")
        return cfg

    async def go():
        rt = runtimes_mod.from_config(ThreadsConfig())
        store = MemoryObjectStore()
        s_ctl = await CloudObjectStorage.open(
            "db", segment_ms, store, schema, 2, cfg_of(False),
            runtimes=rt, device=dev)
        for seg in range(segments):
            ts = T0 + seg * segment_ms + rng.integers(
                0, segment_ms - 1000, per_seg).astype(np.int64)
            ts.sort()
            names = [f"host_{i:03d}" for i in
                     rng.integers(0, hosts, per_seg)]
            vals = rng.random(per_seg) * 100
            b = pa.record_batch(
                [pa.array(names), pa.array(ts),
                 pa.array(vals, type=pa.float64())], schema=schema)
            await s_ctl.write(WriteRequest(
                b, TimeRange.new(int(ts[0]), int(ts[-1]) + 1)))
        s_mesh = await CloudObjectStorage.open(
            "db", segment_ms, store, schema, 2, cfg_of(True),
            runtimes=rt, device=dev)
        lo, hi = T0, T0 + span
        spec = AggregateSpec(
            group_col="host", ts_col="ts", value_col="v",
            range_start=lo, bucket_ms=bucket_ms,
            num_buckets=span // bucket_ms, which=("avg", "max"))
        req = ScanRequest(range=TimeRange.new(lo, hi))

        async def leg(s, tk=None, reps=max(3, iters // 3)):
            times, out = [], None
            for _ in range(reps):
                _clear_storage(s)
                t0 = time.perf_counter()
                out = await s.scan_aggregate(req, spec, top_k=tk)
                _sync(dev)
                times.append(time.perf_counter() - t0)
            return float(np.median(times) * 1e3), out

        stages0 = read_mod.plan_stage_snapshot()
        l0 = _launches()
        ctl_ms, ctl_out = await leg(s_ctl)
        detail["control_launches"] = _launches_since(l0)
        mesh_rounds0 = read_mod._MESH_ROUNDS.value
        mesh_parts0 = read_mod._MESH_PARTS.value
        l0 = _launches()
        sm0 = _seams()
        mesh_ms, mesh_out = await leg(s_mesh)
        reps = max(3, iters // 3)
        # ts, group and value columns of every row, each rep
        detail["mesh_seam"] = _seam_rounds(
            sm0, _seams(), "mesh_run_partials",
            reps * per_seg * segments * 12)
        detail["mesh_launches"] = _launches_since(l0)
        stages1 = read_mod.plan_stage_snapshot()
        rounds = int(read_mod._MESH_ROUNDS.value - mesh_rounds0)
        parts = int(read_mod._MESH_PARTS.value - mesh_parts0)
        assert rounds > 0, "mesh leg never dispatched a round"
        # in-bench bit-identity: the A/B is meaningless if legs differ
        _same_scan(ctl_out, mesh_out, "control vs mesh")

        # top-k egress leg: device-scored winners only
        tk = TopKSpec(k=5, by="max")
        topk0_cells = read_mod._MESH_PART_CELLS.value
        topk0_served = read_mod._MESH_TOPK.value
        l0 = _launches()
        sm0 = _seams()
        topk_ms, topk_out = await leg(s_mesh, tk=tk)
        detail["mesh_topk_seam"] = _seam_rounds(
            sm0, _seams(), "mesh_run_partials",
            reps * per_seg * segments * 12)
        detail["mesh_topk_launches"] = _launches_since(l0)
        _ctl_topk_ms, ctl_topk = await leg(s_ctl, tk=tk, reps=1)
        _same_scan(ctl_topk, topk_out, "control vs mesh top-k")
        topk_served = int(read_mod._MESH_TOPK.value - topk0_served)
        topk_cells = int(read_mod._MESH_PART_CELLS.value - topk0_cells)
        assert topk_served > 0, "top-k never took the mesh path"
        reps_topk = max(3, iters // 3)
        # the acceptance bound: per-run winner slices only
        bound = reps_topk * segments * tk.k * spec.num_buckets * 8
        dense_cells = hosts * spec.num_buckets * reps_topk * 3
        assert topk_cells <= bound, (topk_cells, bound)
        mesh_stats = s_mesh.reader.mesh_stats()
        shape = mesh_stats["shape"]
        out = {
            "metric": (f"mesh scan: full-span avg/max downsample over "
                       f"{segments} segments, "
                       f"{per_seg * segments / 1e6:.1f}M "
                       f"rows, {shape['time']}x{shape['series']} mesh, "
                       f"cold p50"),
            "value": round(mesh_ms, 1),
            "unit": "ms",
            # mesh/control: < 1 means the mesh divides the scan wall
            "vs_baseline": round(mesh_ms / ctl_ms, 4),
            "rows": per_seg * segments,
            "control_cold_p50_ms": round(ctl_ms, 1),
            "mesh_cold_p50_ms": round(mesh_ms, 1),
            "mesh_topk_p50_ms": round(topk_ms, 1),
            "mesh_shape": shape,
            "mesh_rounds": rounds,
            "mesh_parts": parts,
            "windows_per_round": round(
                segments * max(3, iters // 3) / rounds, 3),
            "mesh_aggregate_s": round(
                stages1["mesh_aggregate_s"]
                - stages0["mesh_aggregate_s"], 3),
            "control_device_aggregate_s": round(
                stages1["device_aggregate_s"]
                - stages0["device_aggregate_s"], 3),
            "topk_egress_cells": topk_cells,
            "topk_egress_bound": bound,
            "topk_dense_grid_cells": dense_cells,
            "topk_served": topk_served,
            "mesh_stalls": mesh_stats["stalls"],
            "mesh_fallbacks": mesh_stats["fallbacks"],
            "bit_identical": True,
            "note": ("logical mesh slots over the visible devices: when "
                     "several slots name one card they share it, so the "
                     "wall does not divide; the work division is "
                     "structural (windows_per_round, series-sharded "
                     "grid state, the top-k egress bound)."),
        }
        _log(f"config19: control {ctl_ms:.0f}ms vs mesh {mesh_ms:.0f}ms "
             f"({shape['time']}x{shape['series']} mesh, {rounds} rounds, "
             f"{parts} parts); topk egress {topk_cells} cells "
             f"(dense grid would be {dense_cells}); launches control "
             f"{detail['control_launches']}, mesh {detail['mesh_launches']}")
        await s_mesh.close()
        await s_ctl.close()
        rt.close()
        return out

    with _parts_route(), slots:
        out = asyncio.run(go())
    if dev.type == "cuda":
        assert detail["mesh_launches"]["bucket_window_partials"], \
            "config19: the mesh leg launched no partials kernel"
    return out


# ---------------------------------------------------------------------------
# configs 20 and 21: the failover drills
# ---------------------------------------------------------------------------


def _failover_drill(config: int, rows: int, iters: int, dev,
                    scratch_dir: Optional[str], detail: dict) -> dict:
    """The open-loop failover drill of configs 20 and 21: a fixture (a
    bulk table and a dashboard table) ingested WAL-free, then reopened
    behind the WAL with `[replication]` on; dashboards (/query, 5/s)
    and single-sample writes (/write, 10/s) on a Poisson schedule over
    one leg, the primary's compute plane killed at mid-leg (listener
    gone, tables aborted with no final flush) after its committed WAL
    tail drains into the mirror.  Config 20 promotes the follower
    (fed over /repl/wal/*) in a harness retry loop — the control leg;
    config 21 leaves detection, election and takeover to a
    StandbyMonitor.  Every acked write is read back from the promoted
    node."""
    import random as random_mod
    import shutil

    import aiohttp
    import pyarrow as pa
    from aiohttp import web

    from horaedb_tpu_torch.cluster.replication import (
        FailoverConfig,
        HttpWalSource,
        LeaseManager,
        LocalWalSource,
        ReplicationConfig,
        ReplicationError,
        StandbyMonitor,
        WalFollower,
        install_fence,
        promote,
    )
    from horaedb_tpu_torch.metric_engine import MetricEngine
    from horaedb_tpu_torch.objstore import (
        FaultInjectingStore,
        MemoryObjectStore,
    )
    from horaedb_tpu_torch.server.config import (
        ReadableDuration,
        ServerConfig,
    )
    from horaedb_tpu_torch.server.main import ServerState, build_app
    from horaedb_tpu_torch.storage.types import TimeRange
    from horaedb_tpu_torch.wal.config import WalConfig

    lat_s = float(os.environ.get("BENCH_STORE_LATENCY_MS", "20")) / 1e3
    if config == 20:
        seed = int(os.environ.get("REPL_BENCH_SEED", "20"))
    else:
        seed = int(os.environ.get("FAILOVER_BENCH_SEED",
                                  os.environ.get("FAILOVER_SEED", "21")))
    segment_ms = 2 * 3600 * 1000
    T0 = (1_700_000_000_000 // segment_ms) * segment_ms
    leg_seconds = max(4.0, min(30.0, float(iters)))
    kill_at = leg_seconds / 2.0
    lease_ttl_ms = 2_000
    grace_ms, jitter = 500, 0.5
    n_fix = min(max(20_000, rows), 200_000)
    hosts = 50
    span = 3_600_000
    # the writer lands in the OPEN segment ahead of the dashboards'
    # window (a dashboard aggregate never pre-flushes its rows)
    TW0 = T0 + 3 * segment_ms
    dash_q = {"metric": "app", "filters": {}, "start": T0,
              "end": T0 + span, "bucket_ms": 300_000}
    _log(f"config{config}: {leg_seconds!r} s leg, the kill at "
         f"{kill_at!r} s, {n_fix:,} fixture rows, seed {seed}")

    def write_req(i: int) -> dict:
        # unique (host, timestamp) per request, value = i: the audit
        # recomputes these from the acked index set
        return {"samples": [
            {"name": "ingest", "labels": {"host": f"w{i % 8:02d}"},
             "timestamp": TW0 + i * 1000, "value": float(i)}]}

    def schedule(rng):
        events = []

        def poisson(rate, make):
            t = 0.0
            for i in range(int(leg_seconds * rate)):
                t += rng.expovariate(rate)
                events.append((t,) + make(i))

        poisson(5.0, lambda i: ("/query", dash_q, -1))
        poisson(10.0, lambda i: ("/write", write_req(i), i))
        events.sort(key=lambda e: e[0])
        return events

    async def start_server(state):
        runner = web.AppRunner(build_app(state))
        await runner.setup()
        site = web.TCPSite(runner, "127.0.0.1", 0)
        await site.start()
        port = runner.addresses[0][1]
        return runner, f"http://127.0.0.1:{port}"

    async def go():
        store = FaultInjectingStore(MemoryObjectStore(), seed=seed,
                                    latency_range=(lat_s, lat_s))
        root = _scratch(f"cfg{config}", scratch_dir)
        wal_dir = os.path.join(root, "wal")
        mirror_dir = os.path.join(root, "mirror")
        rng_np = np.random.default_rng(seed)
        # the fixture, ingested WAL-free, then reopened behind the WAL
        engine = await MetricEngine.open("metrics/region_0", store,
                                         segment_ms=segment_ms, device=dev)
        per_host = n_fix // hosts
        ts = T0 + np.repeat(
            np.arange(per_host, dtype=np.int64)
            * max(1, span // max(per_host, 1)), hosts)
        ids = np.tile(np.arange(hosts, dtype=np.int32), per_host)
        names = pa.array([f"host_{i:03d}" for i in range(hosts)])
        await engine.write_arrow("cpu", ["host"], pa.record_batch({
            "host": pa.DictionaryArray.from_arrays(pa.array(ids), names),
            "timestamp": pa.array(ts, type=pa.int64()),
            "value": pa.array(rng_np.random(len(ts)), type=pa.float64()),
        }))
        m = 20 * 360
        await engine.write_arrow("app", ["host"], pa.record_batch({
            "host": pa.array([f"app_{i % 20:02d}" for i in range(m)]),
            "timestamp": pa.array(
                T0 + np.arange(m, dtype=np.int64) * 10_000 % span,
                type=pa.int64()),
            "value": pa.array(rng_np.random(m), type=pa.float64()),
        }))
        await engine.close()

        wal_template = WalConfig(enabled=True, dir=wal_dir)
        engine = await MetricEngine.open(
            "metrics/region_0", store, segment_ms=segment_ms,
            wal_config=wal_template, device=dev)
        cfg = ServerConfig()
        cfg.replication.enabled = True
        cfg.replication.region = 0
        cfg.replication.holder = "bench-primary"
        cfg.replication.lease_ttl = ReadableDuration.from_millis(
            lease_ttl_ms)
        cfg.replication.renew_interval = ReadableDuration.from_millis(500)
        state = ServerState(engine, cfg)
        await state.start_replication(store)
        runner, base = await start_server(state)
        poll = ReplicationConfig(
            poll_interval=ReadableDuration.from_millis(50))
        if config == 20:
            follower = WalFollower(
                HttpWalSource(base, "bench-follower", timeout_s=5.0),
                mirror_dir, poll, region=0)
            follower.start()
        else:
            # the standby tails the primary's durable log plane in
            # process (the log outlives the compute that wrote it)
            follower = WalFollower(
                LocalWalSource(state.repl, "bench-standby"), mirror_dir,
                poll, region=0)

        target = {"base": base}
        lat: dict = {}
        fail: dict = {}
        acked: set = set()
        new: dict = {"engine": None, "lease": None, "runner": None}
        # what the kill has taken down (the finally closes the rest)
        down = {"runner": False, "primary": False}
        session = aiohttp.ClientSession(
            connector=aiohttp.TCPConnector(limit=0),
            timeout=aiohttp.ClientTimeout(total=10))
        monitor = ship_task = None
        stop_ship = asyncio.Event()

        async def serve_promoted(engine_p, lease_p):
            # the failover's finish line: the promoted node serving
            new["engine"], new["lease"] = engine_p, lease_p
            lease_p.start_renewal(2.0, 10_000)
            new["runner"], base2 = await start_server(
                ServerState(engine_p, ServerConfig()))
            target["base"] = base2
            fail["failover_ms"] = round(
                (time.perf_counter() - fail["_t_kill"]) * 1e3, 1)
            if config == 21:
                fail["epoch"] = lease_p.epoch

        async def abort_primary():
            down["primary"] = True
            await state.stop_replication()  # renewals stop with it
            for t in engine.tables.values():
                abort = getattr(t, "abort", None)
                if abort is not None:
                    await abort()
            engine._runtimes.close()

        async def kill20():
            await asyncio.sleep(kill_at)
            fail["_t_kill"] = time.perf_counter()
            # the compute plane dies: listener gone, ingest loops
            # aborted with NO final flush
            down["runner"] = True
            await runner.cleanup()
            await follower.close()
            # the durable log plane outlives the process: drain the
            # committed tail into the mirror before replay
            drain = WalFollower(LocalWalSource(state.repl,
                                               "bench-follower"),
                                mirror_dir, region=0)
            for _ in range(100):
                await drain.poll_once()
                if drain.lag() == 0:
                    break
            else:
                raise RuntimeError(
                    f"mirror failed to drain: lag {drain.lag()}")
            await drain.close()
            await abort_primary()
            fail["drain_ms"] = round(
                (time.perf_counter() - fail["_t_kill"]) * 1e3, 1)
            mgr = LeaseManager(store, "metrics")
            attempts = 0
            while True:
                attempts += 1
                try:
                    # the CONTROL leg's manual retry loop
                    engine_p, lease_p = await promote(
                        "metrics", store, 0, mgr, "bench-follower",
                        mirror_dir, wal_template, segment_ms=segment_ms,
                        lease_ttl_ms=10_000, reason="primary_dead",
                        device=dev)
                    break
                except ReplicationError:
                    # the dead primary's lease has not expired yet
                    await asyncio.sleep(0.05)
            fail["lease_acquire_attempts"] = attempts
            await serve_promoted(engine_p, lease_p)

        async def kill21():
            """The harness's ONLY failure action: compute plane down,
            log plane drained, renewals stopped.  No promote()."""
            await asyncio.sleep(kill_at)
            fail["_t_kill"] = time.perf_counter()
            down["runner"] = True
            await runner.cleanup()
            await state.lease.stop_renewal()
            stop_ship.set()
            await ship_task
            for _ in range(100):
                await follower.poll_once()
                if follower.lag() == 0:
                    break
            else:
                raise RuntimeError(
                    f"mirror failed to drain: lag {follower.lag()}")
            fail["drain_ms"] = round(
                (time.perf_counter() - fail["_t_kill"]) * 1e3, 1)
            await abort_primary()

        async def fire(at, path, payload, widx):
            t0 = time.perf_counter()
            try:
                r = await session.post(target["base"] + path, json=payload)
                status = r.status
                await r.release()
            except asyncio.TimeoutError:
                status = -1
            except aiohttp.ClientError:
                status = -2
            dt = time.perf_counter() - t0
            if status == 200 and widx >= 0:
                acked.add(widx)
            kind = "query" if path == "/query" else "write"
            lat.setdefault(kind, []).append((at, dt, status))

        try:
            if config == 21:
                monitor = StandbyMonitor(
                    follower, LeaseManager(store, "metrics"), 0,
                    "bench-standby",
                    FailoverConfig(
                        enabled=True,
                        grace=ReadableDuration.from_millis(grace_ms),
                        jitter=jitter,
                        check_interval=ReadableDuration.from_millis(100),
                        fitness_wait=ReadableDuration.from_millis(100),
                        cooldown=ReadableDuration.from_millis(1000)),
                    wal_template, segment_ms=segment_ms,
                    lease_ttl_ms=10_000, on_promoted=serve_promoted,
                    device=dev)
                monitor.start()

                # the steady-state ship loop is the harness's
                # (serialized against the kill-time drain)
                async def shipper():
                    while not stop_ship.is_set():
                        try:
                            await follower.poll_once()
                        except ReplicationError:
                            return
                        await asyncio.sleep(0.05)

                ship_task = asyncio.create_task(shipper())
            # unmeasured preamble: warm both request shapes
            for path, payload in (("/query", dash_q),
                                  ("/write", write_req(10**9))):
                r = await session.post(base + path, json=payload)
                await r.release()
            lat.clear()
            acked.clear()
            l0 = _launches()
            t_start = time.perf_counter()
            ko = asyncio.create_task(kill20() if config == 20
                                     else kill21())
            tasks = []
            for at, path, payload, widx in schedule(
                    random_mod.Random(seed)):
                delay = t_start + at - time.perf_counter()
                if delay > 0:
                    await asyncio.sleep(delay)
                tasks.append(asyncio.create_task(
                    fire(at, path, payload, widx)))
            await asyncio.gather(*tasks)
            await ko
            # config 21: the monitor owns the rest (failover_ms is
            # stamped last in the takeover hook)
            for _ in range(600):
                if "failover_ms" in fail:
                    break
                await asyncio.sleep(0.05)
            if "failover_ms" not in fail:
                raise RuntimeError(
                    "standby monitor never promoted: "
                    f"{monitor.election_state() if monitor else ''}")
            # the leg's launches, read before the audit's own queries
            detail["launches"] = _launches_since(l0)

            # the zero-acked-write-loss audit against the PROMOTED node
            rng = TimeRange.new(TW0 - 1, TW0 + 10_000_000)
            got = {}
            for h in range(8):
                t = await new["engine"].query(
                    "ingest", [("host", f"w{h:02d}")], rng)
                for ts_v, v in zip(t.column("timestamp").to_pylist(),
                                   t.column("value").to_pylist()):
                    got[(h, ts_v)] = v
            lost = sum(
                1 for i in sorted(acked)
                if got.get((i % 8, TW0 + i * 1000)) != float(i))
            fail.pop("_t_kill", None)
            out = {"rows": n_fix, "leg_seconds": leg_seconds,
                   "store_latency_ms": lat_s * 1e3,
                   "lease_ttl_ms": lease_ttl_ms}
            if config == 21:
                out.update({"grace_ms": grace_ms, "jitter": jitter})
            out.update(fail)
            if config == 21:
                out.update({
                    "harness_promote_calls": 0,
                    "election_attempts": monitor.attempts,
                    "election_outcome": (monitor.last_outcome or {}
                                         ).get("outcome")})
            out.update({"acked_writes": len(acked),
                        "acked_write_loss": lost})
            for kind, ls in sorted(lat.items()):
                for phase, sel in (
                        ("pre_kill", [x for x in ls if x[0] < kill_at]),
                        ("post_kill", [x for x in ls
                                       if x[0] >= kill_at])):
                    oks = [dt for _, dt, s in sel if s == 200]
                    codes: dict = {}
                    for _, _, s in sel:
                        codes[str(s)] = codes.get(str(s), 0) + 1
                    out[f"{kind}_{phase}"] = {
                        "n": len(sel),
                        "ok": len(oks),
                        "p99_ms": (round(float(np.percentile(
                            np.asarray(oks) * 1e3, 99)), 1)
                            if oks else None),
                        "codes": codes,
                    }
            return out
        finally:
            stop_ship.set()
            if ship_task is not None and not ship_task.done():
                ship_task.cancel()
            await session.close()
            if monitor is not None:
                await monitor.close()
            await follower.close()  # idempotent
            if not down["runner"]:
                await runner.cleanup()
            if new["runner"] is not None:
                await new["runner"].cleanup()
            if new["lease"] is not None:
                await new["lease"].stop_renewal()
            if new["engine"] is not None:
                install_fence(new["engine"], None)
                await new["engine"].close()
            if not down["primary"]:
                # the drill failed before the kill: close the primary
                await state.stop_replication()
                await engine.close()
            shutil.rmtree(root, ignore_errors=True)

    out = asyncio.run(go())
    out["bar_zero_loss"] = out["acked_write_loss"] == 0
    if config == 21:
        # detection + election + replay inside the lease TTL + the
        # worst-case jittered grace window + a fixed 3 s slack
        slack_ms = 3_000.0
        out["failover_bound_ms"] = (lease_ttl_ms
                                    + grace_ms * (1.0 + out["jitter"])
                                    + slack_ms)
        out["bar_failover_bound"] = (
            out.get("failover_ms") is not None
            and out["failover_ms"] <= out["failover_bound_ms"])
    out["slo_query_p99_ms"] = 500.0
    out["slo_write_p99_ms"] = 1000.0
    served_ok = all(
        out[k]["p99_ms"] is not None
        and out[k]["p99_ms"] < (out["slo_write_p99_ms"]
                                if k.startswith("write")
                                else out["slo_query_p99_ms"])
        for k in ("query_pre_kill", "write_pre_kill",
                  "query_post_kill", "write_post_kill"))
    out["bar_slo_ok"] = served_ok and out["bar_zero_loss"] and (
        config == 20 or out["bar_failover_bound"])
    if dev.type == "cuda":
        assert any(detail["launches"].values()), \
            f"config{config}: the drill's traffic launched no kernel"
    _log(f"config{config}: failover {out.get('failover_ms')} ms (drain "
         f"{out.get('drain_ms')} ms) | acked {out['acked_writes']} lost "
         f"{out['acked_write_loss']} | served p99 bar "
         f"{'MET' if out['bar_slo_ok'] else 'MISSED'} | launches "
         f"{detail['launches']}")
    # vs_baseline: served-query p99 across the failover, post-kill over
    # pre-kill (1.0 where a phase served nothing)
    pre = out["query_pre_kill"]["p99_ms"]
    post = out["query_post_kill"]["p99_ms"]
    return {"unit": "ms", "vs_baseline": (round(post / pre, 3)
                                          if pre and post else 1.0),
            "value": out.get("failover_ms"), **out}


def run_config20(rows: int, iters: int, device="cuda",
                 scratch_dir: Optional[str] = None,
                 detail: Optional[dict] = None) -> dict:
    """Failover SLO harness: the primary killed at mid-leg, the
    follower (fed over the /repl/wal/* plane) promoted by the harness
    from its WAL mirror once the dead primary's lease lapses.
    Recorded: failover_ms (kill -> promoted node serving), acked-write
    loss (must be 0), and the compliant p99 per phase.  iters scales
    the leg duration (4-30 s)."""
    dev = resolve_device(device)
    detail = {} if detail is None else detail
    out = _failover_drill(20, rows, iters, dev, scratch_dir, detail)
    return {"metric": ("replication failover: kill -9 at mid-leg, "
                       "follower promoted from WAL mirror, open-loop SLO"),
            **out}


def run_config21(rows: int, iters: int, device="cuda",
                 scratch_dir: Optional[str] = None,
                 detail: Optional[dict] = None) -> dict:
    """Self-driving failover SLO harness: the config-20 drill with the
    promotion decision inside the system — a StandbyMonitor detects
    the expired lease, runs the election and promotes itself; the
    harness only kills.  Recorded beside config 20's numbers: the
    election's attempts and outcome, and bar_failover_bound:
    failover_ms under the lease TTL + the worst-case jittered grace +
    a 3 s slack."""
    dev = resolve_device(device)
    detail = {} if detail is None else detail
    out = _failover_drill(21, rows, iters, dev, scratch_dir, detail)
    return {"metric": ("self-driving failover: kill -9 at mid-leg, standby "
                       "monitor detects + elects + promotes on its own, "
                       "open-loop SLO"),
            **out}


def run_config22(rows: int, iters: int, device="cuda",
                 detail: Optional[dict] = None) -> dict:
    """The mesh-placed fused-decode A/B: per-round mesh dispatches fed
    the RAW ENCODED sidecar buffers (leaf filter + k-way merge-dedup +
    bucket aggregate + segmented combine on the devices) vs the mesh
    over host-decoded windows vs the single-device control, all on the
    SAME data and on the parts route (HORAEDB_FUSED_AGG=0).

    Legs (cold = caches cleared per rep, grids byte-compared in-bench):
      control_cold     no mesh, host decode
      mesh_cold        [scan.mesh] rounds, host decode
      meshdecode_cold  [scan.mesh] rounds from encoded bytes
      additive top-k   count-ranked winners through the compensated
                       (hi, lo) score plane — egress cells
                       counter-asserted at O(k x buckets x aggs) per run
                       part, at 100 and 800 hosts, under one bound

    Half the segments get a second overlapping write, so multi-SST
    segments take the device k-way merge (route "kway" asserted, the
    full device sort asserted never run).  The mesh spans
    parallel/mesh.local_devices(); MESH_BENCH_DEVICES=N asks for N
    logical slots over the visible cards."""
    import pyarrow as pa

    from horaedb_tpu_torch.common import ReadableDuration
    from horaedb_tpu_torch.common import runtimes as runtimes_mod
    from horaedb_tpu_torch.objstore import MemoryObjectStore
    from horaedb_tpu_torch.ops import device_decode as dd_mod
    from horaedb_tpu_torch.storage import read as read_mod
    from horaedb_tpu_torch.storage.config import (
        StorageConfig,
        ThreadsConfig,
        from_dict,
    )
    from horaedb_tpu_torch.storage.plan import TopKSpec
    from horaedb_tpu_torch.storage.read import AggregateSpec, ScanRequest
    from horaedb_tpu_torch.storage.storage import (
        CloudObjectStorage,
        WriteRequest,
    )
    from horaedb_tpu_torch.storage.types import TimeRange

    dev = resolve_device(device)
    detail = {} if detail is None else detail
    slots = _mesh_slots(dev, "config22")

    hosts = 100
    hosts_big = 800
    segment_ms = 2 * 3600 * 1000
    segments = 16
    per_seg = max(hosts, rows // segments)
    bucket_ms = 60_000
    T0 = (1_700_000_000_000 // segment_ms) * segment_ms
    span = segments * segment_ms
    _check_i32_span(np.asarray([span]), "config22")
    schema = pa.schema([("host", pa.string()), ("ts", pa.int64()),
                        ("v", pa.float64())])
    rng = np.random.default_rng(22)

    def cfg_of(mesh: bool, decode: str):
        scan: dict = {"cache_max_rows": rows * 4,
                      "combine": {"memo_max_bytes": 0},
                      "cache": {"tier2_max_bytes": 1 << 30},
                      "decode": {"mode": decode}}
        if mesh:
            scan["mesh"] = {"enabled": True}
        cfg = from_dict(StorageConfig, {
            "scheduler": {"schedule_interval": "1h"}, "scan": scan})
        cfg.manifest.merge_interval = ReadableDuration.parse("1h")
        cfg.scrub.interval = ReadableDuration.parse("1h")
        return cfg

    async def fill(s, n_hosts, n_rows_per, overlap=True):
        for seg in range(segments):
            passes = [n_rows_per]
            if overlap and seg % 2:
                # a second overlapping SST: the k-way merge's territory
                passes.append(max(n_hosts, n_rows_per // 8))
            for n in passes:
                ts = T0 + seg * segment_ms + rng.integers(
                    0, segment_ms - 1000, n).astype(np.int64)
                ts.sort()
                names = [f"host_{i:03d}" for i in
                         rng.integers(0, n_hosts, n)]
                vals = rng.random(n) * 100
                b = pa.record_batch(
                    [pa.array(names), pa.array(ts),
                     pa.array(vals, type=pa.float64())], schema=schema)
                await s.write(WriteRequest(
                    b, TimeRange.new(int(ts[0]), int(ts[-1]) + 1)))

    async def go():
        rt = runtimes_mod.from_config(ThreadsConfig())
        store = MemoryObjectStore()

        async def open_(st, mesh, decode):
            return await CloudObjectStorage.open(
                "db", segment_ms, st, schema, 2, cfg_of(mesh, decode),
                runtimes=rt, device=dev)

        s_ctl = await open_(store, False, "host")
        await fill(s_ctl, hosts, per_seg)
        s_mesh = await open_(store, True, "host")
        s_dec = await open_(store, True, "device")
        lo, hi = T0, T0 + span
        spec = AggregateSpec(
            group_col="host", ts_col="ts", value_col="v",
            range_start=lo, bucket_ms=bucket_ms,
            num_buckets=span // bucket_ms, which=("avg", "max"))
        req = ScanRequest(range=TimeRange.new(lo, hi))
        reps = max(3, iters // 3)

        async def leg(s, tk=None, sp=None, rq=None, n=reps):
            times, out = [], None
            for _ in range(n):
                _clear_storage(s)
                t0 = time.perf_counter()
                out = await s.scan_aggregate(rq or req, sp or spec,
                                             top_k=tk)
                _sync(dev)
                times.append(time.perf_counter() - t0)
            return float(np.median(times) * 1e3), out

        l0 = _launches()
        ctl_ms, ctl_out = await leg(s_ctl)
        detail["control_launches"] = _launches_since(l0)
        rounds0 = read_mod._MESH_ROUNDS.value
        l0 = _launches()
        mesh_ms, mesh_out = await leg(s_mesh)
        detail["mesh_launches"] = _launches_since(l0)
        mesh_rounds = int(read_mod._MESH_ROUNDS.value - rounds0)
        rounds0 = read_mod._MESH_ROUNDS.value
        kway0 = dd_mod._SORT_SKIPPED["kway"].value
        sorted0 = dd_mod._SORT_RAN.value
        drows0 = dd_mod._STAGE_ROWS.value
        l0 = _launches()
        sm0 = _seams()
        dec_ms, dec_out = await leg(s_dec)
        sm1 = _seams()
        detail["meshdecode_launches"] = _launches_since(l0)
        dec_rounds = int(read_mod._MESH_ROUNDS.value - rounds0)
        kway_skips = int(dd_mod._SORT_SKIPPED["kway"].value - kway0)
        full_sorts = int(dd_mod._SORT_RAN.value - sorted0)
        dec_rows = int(dd_mod._STAGE_ROWS.value - drows0)
        # the encoded columns decoded on the devices: ts, group and
        # value of every stored row, each rep
        detail["meshdecode_seam"] = _seam_rounds(
            sm0, sm1, "mesh_decode_partials", dec_rows * 12)
        assert mesh_rounds > 0, "mesh leg never dispatched a round"
        assert dec_rounds > 0, \
            "fused-decode leg never dispatched a mesh round"
        assert dec_rows > 0, "fused-decode leg never decoded on device"
        # the k-way routing evidence: overlapped segments merged their
        # presorted runs on the device, the full sort never ran
        assert kway_skips > 0, "no segment took the k-way merge route"
        assert full_sorts == 0, \
            f"{full_sorts} dispatches paid the full device sort"
        # in-bench byte identity across ALL THREE legs
        _same_scan(ctl_out, mesh_out, "control vs mesh")
        _same_scan(ctl_out, dec_out, "control vs mesh+decode")

        # additive top-k egress at two group cardinalities
        tk = TopKSpec(k=5, by="count")

        async def additive_leg(s, sp, rq):
            _clear_storage(s)
            served0 = read_mod._MESH_TOPK.value
            cells0 = read_mod._MESH_PART_CELLS.value
            tk_ms, tk_out = await leg(s, tk=tk, sp=sp, rq=rq, n=1)
            assert read_mod._MESH_TOPK.value == served0 + 1, \
                "additive top-k not device-served"
            return tk_ms, tk_out, int(
                read_mod._MESH_PART_CELLS.value - cells0)

        sm0 = _seams()
        topk_ms, topk_out, cells_small = await additive_leg(
            s_mesh, spec, req)
        # one rep; the 8 overlap runs add an eighth of a segment's rows
        detail["additive_topk_seam"] = _seam_rounds(
            sm0, _seams(), "mesh_run_partials",
            (segments * per_seg + segments // 2 * max(hosts, per_seg // 8))
            * 12)
        _ctl_ms, ctl_topk = await leg(s_ctl, tk=tk, n=1)
        _same_scan(ctl_topk, topk_out, "control vs additive topk")
        # cardinality 2: the same segments, span and k, 8x the hosts
        store2 = MemoryObjectStore()
        s2_ctl = await open_(store2, False, "host")
        await fill(s2_ctl, hosts_big, max(hosts_big, per_seg // 4),
                   overlap=False)
        s2_mesh = await open_(store2, True, "host")
        _ms2, topk2_out, cells_big = await additive_leg(
            s2_mesh, spec, req)
        _c2, ctl2_topk = await leg(s2_ctl, tk=tk, n=1)
        _same_scan(ctl2_topk, topk2_out, "control vs additive topk (800)")
        # parts x k x run width x grid kinds; parts = 16 + 8 overlap
        # runs on the small store, 16 on the big one
        bound = 24 * tk.k * spec.num_buckets * 8
        assert cells_small <= bound, (cells_small, bound)
        assert cells_big <= bound, (cells_big, bound)
        # the additive bound: winner egress does not scale with the
        # group count — 8x the hosts, the same ceiling
        assert cells_big <= cells_small * 2, (cells_small, cells_big)

        mesh_stats = s_dec.reader.mesh_stats()
        shape = mesh_stats["shape"]
        out = {
            "metric": (f"mesh fused decode: full-span avg/max "
                       f"downsample over {segments} segments "
                       f"(8 multi-SST), "
                       f"{per_seg * segments / 1e6:.1f}M rows, "
                       f"{shape['time']}x{shape['series']} mesh, "
                       f"stored-bytes-to-answer cold p50"),
            "value": round(dec_ms, 1),
            "unit": "ms",
            "vs_baseline": round(dec_ms / ctl_ms, 4),
            "rows": per_seg * segments,
            "control_cold_p50_ms": round(ctl_ms, 1),
            "mesh_cold_p50_ms": round(mesh_ms, 1),
            "meshdecode_cold_p50_ms": round(dec_ms, 1),
            "meshdecode_vs_mesh": round(dec_ms / mesh_ms, 4),
            "additive_topk_p50_ms": round(topk_ms, 1),
            "mesh_shape": shape,
            "mesh_rounds": mesh_rounds,
            "meshdecode_rounds": dec_rounds,
            "device_decoded_rows": dec_rows,
            "kway_merge_dispatches": kway_skips,
            "full_device_sorts": full_sorts,
            "additive_topk_cells_100": cells_small,
            "additive_topk_cells_800": cells_big,
            "additive_topk_bound": bound,
            "additive_topk_dense_cells_800": (
                hosts_big * spec.num_buckets * 2),
            "mesh_stalls": mesh_stats["stalls"],
            "mesh_fallbacks": mesh_stats["fallbacks"],
            "bit_identical": True,
            "note": ("logical mesh slots over the visible devices: when "
                     "several slots name one card they share it, so the "
                     "single-device control leg is the wall reference; "
                     "decode placement, k-way routing, zero full sorts, "
                     "byte identity and the additive egress bound are "
                     "structural."),
        }
        _log(f"config22: control {ctl_ms:.0f}ms vs mesh {mesh_ms:.0f}ms "
             f"vs mesh+decode {dec_ms:.0f}ms "
             f"({shape['time']}x{shape['series']} mesh, "
             f"{dec_rounds} fused rounds, {kway_skips} kway merges, "
             f"{full_sorts} full sorts); additive topk egress "
             f"{cells_small} -> {cells_big} cells at 100 -> 800 hosts; "
             f"launches mesh+decode {detail['meshdecode_launches']}")
        for s in (s2_mesh, s2_ctl, s_dec, s_mesh, s_ctl):
            await s.close()
        rt.close()
        return out

    with _parts_route(), slots:
        out = asyncio.run(go())
    if dev.type == "cuda":
        ml = detail["meshdecode_launches"]
        assert ml["bucket_window_partials"] and ml["kway_merge_perm"], \
            f"config22: the mesh-decode leg's launches {ml}"
    return out


# ---------------------------------------------------------------------------
# config 23: the device profiler's cost and attribution
# ---------------------------------------------------------------------------


def run_config23(rows: int, iters: int, device="cuda",
                 detail: Optional[dict] = None) -> dict:
    """Device-profiler cost and attribution: the profiler must be cheap
    enough to stay on AND explain the cold query it watches.

    Legs:
      overhead     ONE cached device-decode aggregate measured with the
                   profiler off vs on, config 10's paired method.
                   Done-bar (recorded): on within 2% of off.
      dispatch     a hot-loop micro twin: `deviceprof.seam(fn)` against
                   `fn` on one small tensor — the per-dispatch ledger
                   cost in microseconds.
      attribution  a true cold mesh-decode scan traced with the
                   profiler on: the compile + dispatch + exec +
                   transfer time it recorded must cover >= 80% of the
                   measured device-stage wall (asserted in-bench).  All
                   four are host walls that do not overlap (outermost
                   seams only; deviceprof's module docstring).  The
                   timed call ends in a sync, and the pending CUDA event
                   pairs are resolved before the trace finishes: their
                   device seconds land on the trace's device_exec_ms,
                   kept in `detail` beside the cold leg's launches."""
    import pyarrow as pa
    import torch

    from horaedb_tpu_torch.common import ReadableDuration
    from horaedb_tpu_torch.common import runtimes as runtimes_mod
    from horaedb_tpu_torch.common.deviceprof import profiler as dp
    from horaedb_tpu_torch.objstore import MemoryObjectStore
    from horaedb_tpu_torch.storage.config import (
        StorageConfig,
        ThreadsConfig,
        from_dict,
    )
    from horaedb_tpu_torch.storage.read import AggregateSpec, ScanRequest
    from horaedb_tpu_torch.storage.storage import (
        CloudObjectStorage,
        WriteRequest,
    )
    from horaedb_tpu_torch.storage.types import TimeRange
    from horaedb_tpu_torch.utils import tracing

    dev = resolve_device(device)
    detail = {} if detail is None else detail
    slots = _mesh_slots(dev, "config23")
    hosts = 100
    segment_ms = 2 * 3600 * 1000
    segments = 8
    per_seg = max(hosts, rows // segments)
    bucket_ms = 60_000
    T0 = (1_700_000_000_000 // segment_ms) * segment_ms
    span = segments * segment_ms
    _check_i32_span(np.asarray([span]), "config23")
    schema = pa.schema([("host", pa.string()), ("ts", pa.int64()),
                        ("v", pa.float64())])
    rng = np.random.default_rng(23)

    cfg = from_dict(StorageConfig, {
        "scheduler": {"schedule_interval": "1h"},
        "scan": {"cache_max_rows": rows * 4,
                 "cache": {"tier2_max_bytes": 1 << 30},
                 "mesh": {"enabled": True},
                 "decode": {"mode": "device"}},
    })
    cfg.manifest.merge_interval = ReadableDuration.parse("1h")
    cfg.scrub.interval = ReadableDuration.parse("1h")

    async def go():
        rt = runtimes_mod.from_config(ThreadsConfig())
        s = await CloudObjectStorage.open(
            "db", segment_ms, MemoryObjectStore(), schema, 2, cfg,
            runtimes=rt, device=dev)
        for seg in range(segments):
            ts = T0 + seg * segment_ms + rng.integers(
                0, segment_ms - 1000, per_seg).astype(np.int64)
            ts.sort()
            names = [f"host_{i:03d}" for i in
                     rng.integers(0, hosts, per_seg)]
            vals = rng.random(per_seg) * 100
            b = pa.record_batch(
                [pa.array(names), pa.array(ts),
                 pa.array(vals, type=pa.float64())], schema=schema)
            await s.write(WriteRequest(
                b, TimeRange.new(int(ts[0]), int(ts[-1]) + 1)))
        lo, hi = T0, T0 + span
        spec = AggregateSpec(
            group_col="host", ts_col="ts", value_col="v",
            range_start=lo, bucket_ms=bucket_ms,
            num_buckets=span // bucket_ms, which=("avg", "max"))
        req = ScanRequest(range=TimeRange.new(lo, hi))

        # ---- attribution: one true cold mesh-decode scan, traced ----
        dp.configure(enabled=True)
        dp.clear()
        _clear_storage(s)
        tracing.recorder.configure(enabled=True, sample_rate=1.0)
        trace = tracing.recorder.start("/scan-cold")
        l0 = _launches()
        t0 = time.perf_counter()
        with tracing.trace_scope(trace):
            await s.scan_aggregate(req, spec)
            _sync(dev)
            # the synced call's event pairs, charged to this trace
            dp.resolve()
        cold_ms = (time.perf_counter() - t0) * 1e3
        detail["cold_launches"] = _launches_since(l0)
        tracing.recorder.finish(trace)
        c = trace.counters
        detail["cold_device_exec_ms"] = round(c.get("device_exec_ms", 0.0),
                                              3)
        xfer = (dp.transfer["h2d"]["seconds"]
                + dp.transfer["d2h"]["seconds"]) * 1e3
        attributed = {
            "compile_ms": round(c.get("stage_device_compile_ms", 0.0), 2),
            "dispatch_ms": round(
                c.get("stage_device_dispatch_ms", 0.0), 2),
            "exec_ms": round(c.get("stage_device_exec_ms", 0.0), 2),
            "transfer_ms": round(xfer, 2),
        }
        device_stage_ms = float(c.get("stage_device_ms", 0.0))
        assert device_stage_ms > 0, \
            "cold scan never entered the device decode stage"
        ratio = sum(attributed.values()) / device_stage_ms
        # the attribution bar: the ledger explains >= 80% of the
        # device-stage wall it profiles
        assert ratio >= 0.8, (ratio, attributed, device_stage_ms)

        # ---- overhead: cached path, profiler off vs on, paired -----
        async def one(enabled: bool) -> float:
            dp.configure(enabled=enabled)
            t0 = time.perf_counter()
            await s.scan_aggregate(req, spec)
            _sync(dev)
            return time.perf_counter() - t0

        for _ in range(5):  # warm the scan caches
            await one(True)
        reps = max(30, iters * 3)
        acc = {"off": [], "on": []}
        order_rng = np.random.default_rng(0xC23)
        for _ in range(reps):
            for k in order_rng.permutation(list(acc)):
                acc[k].append(await one(k == "on"))
        dp.configure(enabled=True)
        off = np.asarray(acc["off"])
        on = np.asarray(acc["on"])
        delta = float(np.median(on - off))
        out_overhead = {
            "off_p50_ms": round(float(np.percentile(off, 50)) * 1e3, 4),
            "on_p50_ms": round(float(np.percentile(on, 50)) * 1e3, 4),
            "on_overhead_us": round(delta * 1e6, 1),
            "on_overhead_pct": round(
                delta / float(np.median(off)) * 100, 3),
        }

        # ---- per-dispatch seam cost: the hot micro twin ------------
        def hot(x):
            return x + 1.0

        f = dp.seam(hot, name="cfg23_hot")
        x = torch.zeros(4096, dtype=torch.float32, device=dev)
        f(x)
        _sync(dev)
        n_hot = 2000
        t0 = time.perf_counter()
        for _ in range(n_hot):
            hot(x)
        _sync(dev)
        bare_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(n_hot):
            f(x)
        _sync(dev)
        prof_s = time.perf_counter() - t0
        dispatch_overhead_us = (prof_s - bare_s) / n_hot * 1e6

        snap = dp.snapshot()
        out = {
            "metric": (f"device profiler: cached device-decode scan "
                       f"p50 with every device seam profiled, "
                       f"{per_seg * segments / 1e6:.1f}M rows"),
            "value": out_overhead["on_p50_ms"],
            "unit": "ms",
            # done-bar: profiler-on within 2% of off (1.0 = free)
            "vs_baseline": round(
                out_overhead["on_p50_ms"]
                / max(out_overhead["off_p50_ms"], 1e-9), 4),
            "rows": per_seg * segments,
            **out_overhead,
            "dispatch_wrapper_overhead_us": round(
                dispatch_overhead_us, 2),
            "cold_wall_ms": round(cold_ms, 1),
            "cold_device_stage_ms": round(device_stage_ms, 1),
            "cold_attributed": attributed,
            "cold_attribution_ratio": round(ratio, 4),
            "cold_compiles": sum(r["compiles"] for r in snap["fns"]),
            "transfer_bytes": {d: t["bytes"]
                               for d, t in snap["transfer"].items()},
            "mesh_rounds_recorded": len(snap["rounds"]),
        }
        detail["seam_exec_s"] = {r["fn"]: r["exec_seconds"]
                                 for r in snap["fns"] if r["execs"]}
        _log(f"config23: cached off {out_overhead['off_p50_ms']}ms vs "
             f"on {out_overhead['on_p50_ms']}ms "
             f"({out_overhead['on_overhead_pct']}%), seam "
             f"{dispatch_overhead_us:.2f}us/dispatch; cold "
             f"{cold_ms:.0f}ms = {attributed} over device stage "
             f"{device_stage_ms:.0f}ms (ratio {ratio:.2f}); cold launches "
             f"{detail['cold_launches']}")
        await s.close()
        rt.close()
        return out

    try:
        with slots:
            out = asyncio.run(go())
    finally:
        tracing.recorder.configure(enabled=True, sample_rate=1.0)
    if dev.type == "cuda":
        assert detail["cold_launches"]["bucket_window_partials"], \
            "config23: the cold scan launched no partials kernel"
    return out


RUNNERS = {2: run_config2, 3: run_config3, 4: run_config4, 5: run_config5,
           6: run_config6, 7: run_config7, 8: run_config8, 9: run_config9,
           10: run_config10, 11: run_config11, 12: run_config12,
           13: run_config13, 14: run_config14, 15: run_config15,
           16: run_config16, 17: run_config17, 18: run_config18,
           19: run_config19, 20: run_config20, 21: run_config21,
           22: run_config22, 23: run_config23}
# the configs that put a store or a WAL on disk (their `scratch_dir=`)
ON_DISK = (2, 8, 9, 12, 15, 17, 20, 21)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser("horaedb-tpu-torch bench suite")
    parser.add_argument("--config", type=int, required=True,
                        choices=sorted(RUNNERS))
    parser.add_argument("--rows", type=int, default=2_000_000)
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    parser.add_argument("--scratch-dir", default=None,
                        help="directory for the on-disk stores and WALs of "
                             f"configs {', '.join(map(str, ON_DISK))} "
                             "(default: the system's temporary directory)")
    args = parser.parse_args(argv)
    prov = provenance(args.device)  # raises before any work without a card
    kw = {"scratch_dir": args.scratch_dir} if args.config in ON_DISK else {}
    result = RUNNERS[args.config](args.rows, args.iters, device=args.device,
                                  **kw)
    for k, v in prov.items():
        result.setdefault(k, v)  # a config's own labels win
    print(json.dumps(result))


if __name__ == "__main__":
    main()
