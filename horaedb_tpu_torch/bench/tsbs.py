"""TSBS-style devops data generation (numpy-vectorized).

Models the TSBS `cpu-only` / `devops` workloads BASELINE.md configs use:
N hosts (with region/datacenter tags), F cpu fields, one point per host
per interval.  Generation is pure numpy so benches can build 10M+ rows
in seconds — no per-row Python objects.

Counterpart of horaedb_tpu/bench/tsbs.py: the same config and seed give
the same arrays and record batches, byte for byte.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import pyarrow as pa

CPU_FIELDS = [
    "usage_user", "usage_system", "usage_idle", "usage_nice", "usage_iowait",
    "usage_irq", "usage_softirq", "usage_steal", "usage_guest",
    "usage_guest_nice",
]

REGIONS = ["us-east-1", "us-west-1", "us-west-2", "eu-west-1", "eu-central-1",
           "ap-southeast-1", "ap-southeast-2", "ap-northeast-1",
           "sa-east-1"]


@dataclass
class TsbsConfig:
    num_hosts: int = 100
    num_fields: int = 1
    interval_ms: int = 10_000
    start_ms: int = 1_700_000_000_000
    span_ms: int = 3_600_000
    seed: int = 42


def host_names(n: int) -> list[str]:
    return [f"host_{i}" for i in range(n)]


def region_of_hosts(n: int) -> np.ndarray:
    """Region tag per host, round-robin like TSBS's host generator."""
    return np.array([REGIONS[i % len(REGIONS)] for i in range(n)], dtype=object)


def generate_cpu_arrays(cfg: TsbsConfig, shuffle: bool = False) -> dict[str, np.ndarray]:
    """Columns for the flat storage-bench schema:
    host_id int32 (dict code), ts int64, usage_* float64 per field.

    Row order is host-major then time by default (the best case for
    sort/dedup paths); pass shuffle=True for TSBS's interleaved scrape
    order, the realistic ingest case.
    """
    rng = np.random.default_rng(cfg.seed)
    n_steps = cfg.span_ms // cfg.interval_ms
    n = cfg.num_hosts * n_steps
    host_id = np.repeat(np.arange(cfg.num_hosts, dtype=np.int32), n_steps)
    ts = np.tile(
        cfg.start_ms + np.arange(n_steps, dtype=np.int64) * cfg.interval_ms,
        cfg.num_hosts)
    cols: dict[str, np.ndarray] = {"host_id": host_id, "ts": ts}
    # TSBS cpu usage: random walk clipped to [0, 100]
    for f in range(cfg.num_fields):
        walk = rng.normal(0, 1, n).cumsum() % 100.0
        cols[CPU_FIELDS[f]] = np.abs(walk)
    if shuffle:
        perm = rng.permutation(n)
        cols = {k: v[perm] for k, v in cols.items()}
    return cols


def cpu_record_batch(cfg: TsbsConfig, include_region: bool = False,
                     shuffle: bool = False) -> pa.RecordBatch:
    """Arrow batch with a string host tag — the storage engine's user
    schema shape (host[, region], ts, fields...)."""
    cols = generate_cpu_arrays(cfg, shuffle=shuffle)
    names = host_names(cfg.num_hosts)
    host = pa.array(np.array(names, dtype=object)[cols["host_id"]])
    arrays = [host]
    fields = [("host", pa.string())]
    if include_region:
        arrays.append(pa.array(region_of_hosts(cfg.num_hosts)[cols["host_id"]]))
        fields.append(("region", pa.string()))
    arrays.append(pa.array(cols["ts"], type=pa.int64()))
    fields.append(("ts", pa.int64()))
    for f in range(cfg.num_fields):
        name = CPU_FIELDS[f]
        arrays.append(pa.array(cols[name], type=pa.float64()))
        fields.append((name, pa.float64()))
    return pa.record_batch(arrays, schema=pa.schema(fields))
