"""A configuration's deployment: the engine opened with the
configuration's settings over an in-memory object store, and the TSBS
data set ingested through `MetricEngine.write_arrow`, each chunk's SSTs
compacted by the engine's own scheduler before the next is written.

Only this module and `loadgen.py` touch the program, and only through
`horaedb_tpu_torch.metric_engine.MetricEngine` and the configuration
types it takes."""

from __future__ import annotations

import asyncio
import time

import numpy as np
import pyarrow as pa

from perfbench import tsbs


def parse_duration_ms(text: str) -> int:
    units = {"ms": 1, "s": 1000, "m": 60_000, "h": 3_600_000}
    for unit in ("ms", "s", "m", "h"):
        if text.endswith(unit) and text[:-len(unit)].isdigit():
            return int(text[:-len(unit)]) * units[unit]
    raise ValueError(f"unsupported duration {text!r}")


def tsbs_config(config: dict, seed: int) -> tsbs.TsbsConfig:
    return tsbs.TsbsConfig(num_hosts=config["scale"],
                           num_fields=len(config["fields"]),
                           interval_ms=config["interval_ms"],
                           start_ms=config["start_ms"],
                           span_ms=config["span_ms"], seed=seed)


async def open_engine(config: dict, device):
    from horaedb_tpu_torch.metric_engine import MetricEngine
    from horaedb_tpu_torch.objstore import MemoryObjectStore
    from horaedb_tpu_torch.storage.config import StorageConfig, from_dict

    storage = from_dict(StorageConfig, config["storage"])
    return await MetricEngine.open(
        "perfbench", MemoryObjectStore(),
        segment_ms=parse_duration_ms(config["segment_duration"]),
        config=storage, device=device)


def tag_columns(data: tsbs.TsbsData, host_of_row: np.ndarray) -> dict:
    return {k: pa.DictionaryArray.from_arrays(
        pa.array(data.tags[k][host_of_row]), pa.array(data.tag_values[k]))
        for k in tsbs.TAG_KEYS}


async def table_ssts(engine) -> dict:
    """{table: its SSTs} from the manifests."""
    return {name: await t.manifest.all_ssts()
            for name, t in engine.tables.items()}


async def settle_compaction(engine, poll_s: float = 0.1) -> None:
    """Wake every table's compaction picker until none has work left: no
    SST is being rewritten, and the SSTs stayed the same over two wakes
    in a row.  What is rewritten is the scheduler's own rule."""
    last, quiet = None, 0
    while quiet < 2:
        for t in engine.tables.values():
            await t.compact()
        await asyncio.sleep(poll_s)
        ssts = await table_ssts(engine)
        ids = {k: frozenset(f.id for f in v) for k, v in ssts.items()}
        busy = any(f.in_compaction for v in ssts.values() for f in v)
        quiet = quiet + 1 if not busy and ids == last else 0
        last = ids


async def ssts_per_segment(engine, table: str = "data") -> list:
    """The table's SST count in each segment, oldest first."""
    from horaedb_tpu_torch.storage.sst import segment_of

    t = engine.tables[table]
    counts: dict = {}
    for f in await t.manifest.all_ssts():
        seg = segment_of(f, t.segment_duration_ms)
        counts[seg] = counts.get(seg, 0) + 1
    return [counts[k] for k in sorted(counts)]


async def ingest(engine, data: tsbs.TsbsData, metric: str,
                 chunk_ticks: int) -> float:
    """Write every field in time-contiguous chunks of `chunk_ticks`
    ticks, rows in TSBS's order (every host at each tick), and let the
    engine's compaction settle after each chunk, so that the scheduler's
    periodic pick sees whole chunks and each run ends with the same SSTs.
    Returns the seconds spent waiting for compaction."""
    from horaedb_tpu_torch.common.error import Error

    cfg = data.cfg
    hosts = cfg.num_hosts
    compact_s = 0.0
    for lo in range(0, cfg.num_ticks, chunk_ticks):
        hi = min(cfg.num_ticks, lo + chunk_ticks)
        ts = cfg.start_ms + np.repeat(
            np.arange(lo, hi, dtype=np.int64) * cfg.interval_ms, hosts)
        host = np.tile(np.arange(hosts, dtype=np.int32), hi - lo)
        tags = tag_columns(data, host)
        for f, name in enumerate(data.fields):
            batch = pa.record_batch({
                **tags, "timestamp": pa.array(ts, type=pa.int64()),
                "value": pa.array(
                    np.ascontiguousarray(data.values[f, :, lo:hi].T)
                    .reshape(-1), type=pa.float64())})
            for _attempt in range(5):
                try:
                    await engine.write_arrow(metric, tsbs.TAG_KEYS, batch,
                                             field=name)
                    break
                except Error:
                    # the manifest's delta backpressure: fold the deltas
                    # and write the chunk again, as a writer would; the
                    # rows a partial write left are deduplicated by
                    # (series, field, timestamp)
                    await engine.tables["data"].manifest.trigger_merge()
            else:
                raise Error("ingest failed after 5 backpressure retries")
        t0 = time.perf_counter()
        await settle_compaction(engine)
        compact_s += time.perf_counter() - t0
    return compact_s
