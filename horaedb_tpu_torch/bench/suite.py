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

Counterpart of horaedb_tpu/bench/suite.py, configs 2-10: the same data
from the same seeds, the same legs and the same result keys.  Each
run_configN(rows, iters, device="cuda") returns {metric, value (p50
ms), unit, vs_baseline (device_p50 / cpu_p50, lower is better — except
configs 7, 8, 9 and 10, above)}; it runs on the card and raises without
one unless the caller passes device="cpu".  Every timed call ends in a
device sync, so a number times the work, not its launch; grids come to
the host after the timed window, except where the window times the
download itself (config 5's write-back).

CLI: python -m horaedb_tpu_torch.bench.suite --config 2 [--rows N]
     [--iters K] [--device cuda|cpu] [--scratch-dir DIR]
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


RUNNERS = {2: run_config2, 3: run_config3, 4: run_config4, 5: run_config5,
           6: run_config6, 7: run_config7, 8: run_config8, 9: run_config9,
           10: run_config10}
# the configs that put a store or a WAL on disk (their `scratch_dir=`)
ON_DISK = (2, 8, 9)


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
                             "configs 2, 8 and 9 (default: the system's "
                             "temporary directory)")
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
