"""One run of one cell: set-up, the measured window, the per-layer
readings of a traced run, and the check against the plain reference.

Set-up is everything before the window: the data generated from the
seed, the engine opened and the data ingested and compacted, the
kernels built (a
cache hit after a checkout's first run) and the warm-up, which issues
the cell's own query at the first and the last start of the span (so
every segment of every field the mix asks is read once) and then one
at a random start per client, all clients at once."""

from __future__ import annotations

import asyncio
import gc
import statistics
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np

from perfbench import catalog, check, deploy, loadgen, roofline, tsbs
from perfbench.devtrace import DeviceTrace, HostSpans, TraceSummary

# enough window starts for any closed loop the harness can run
MAX_QUERIES = 1_000_000


@dataclass
class Readings:
    """What a per-layer reader reads (`perfbench/metrics/<name>.py`)."""

    queries: int
    fields_per_query: int
    # deltas over the window of the program's registry and of its
    # per-stage snapshot (storage/read.py::plan_stage_snapshot)
    counters: dict
    stages: dict
    trace: Optional[TraceSummary]
    scan_work: roofline.Work
    segment_rows: int
    card: str
    # each query's time from its issue to its result on the host
    latencies_ms: list


def seed_words(seed: int) -> int:
    """Any whole number as a non-negative seed for numpy."""
    return seed % (1 << 64)


def program_snapshot() -> tuple:
    from horaedb_tpu_torch.storage.read import plan_stage_snapshot
    from horaedb_tpu_torch.utils.metrics import registry

    return registry.snapshot(), plan_stage_snapshot()


def delta(after: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items()
            if isinstance(v, (int, float)) and v != before.get(k, 0)}


def sync(device) -> None:
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


@dataclass
class CellRun:
    # the result line, and what the run prints beside it on stderr
    result: dict
    info: dict


def run_cell(bench: dict, name: str, seed: int, seconds: float, trace: bool,
             device, t_start: float, card: str) -> CellRun:
    return asyncio.run(_run_cell(bench, name, seed, seconds, trace, device,
                                 t_start, card))


async def _run_cell(bench, name, seed, seconds, trace, device, t_start,
                    card) -> CellRun:
    import torch

    cell = catalog.workload(bench, name)
    config = catalog.config(bench, cell["config"])
    traffic = catalog.traffic(cell["traffic"])
    limits = catalog.limits(name)
    s = seed_words(seed)
    data = tsbs.generate(deploy.tsbs_config(config, s))
    fields = loadgen.query_fields(traffic, config)
    metric = config["metric"]
    rng = np.random.default_rng([s, 1])
    warm_rng = np.random.default_rng([s, 2])
    starts = loadgen.window_starts(traffic, config, rng, MAX_QUERIES)
    draw_hosts = loadgen.host_drawer(traffic, config, [s, 3])
    warm_hosts = loadgen.host_drawer(traffic, config, [s, 4])
    last_start = (config["start_ms"] + config["span_ms"]
                  - traffic["window_ms"])

    steps = {"start_and_generate_s": time.perf_counter() - t_start}
    engine = await deploy.open_engine(config, device)
    spans = HostSpans() if trace else None
    dtrace = DeviceTrace(device) if trace else None
    try:
        t0 = time.perf_counter()
        steps["compact_s"] = await deploy.ingest(
            engine, data, metric, config["ingest_chunk_ticks"])
        steps["ingest_s"] = time.perf_counter() - t0
        steps["data_ssts_per_segment"] = await deploy.ssts_per_segment(
            engine)
        t0 = time.perf_counter()
        for j, start in enumerate((config["start_ms"], last_start)):
            await loadgen.issue(engine, traffic, fields, metric, start,
                                hosts=warm_hosts(j))
        warm = loadgen.window_starts(traffic, config, warm_rng,
                                     traffic["workers"])
        await asyncio.gather(*(loadgen.issue(engine, traffic, fields,
                                             metric, int(w),
                                             hosts=warm_hosts(2 + j))
                               for j, w in enumerate(warm)))
        sync(device)
        steps["warm_s"] = time.perf_counter() - t0
        gc.collect()
        before = program_snapshot()
        if trace:
            dtrace.start()
        setup_s = time.perf_counter() - t_start
        loop = await loadgen.closed_loop(
            engine, traffic, fields, metric, starts, seconds,
            keep=traffic["check_sample"], keep_seed=s ^ 0x5EED,
            span=spans.span if trace else None, draw_hosts=draw_hosts)
        sync(device)
        if trace:
            dtrace.stop()
        after = program_snapshot()
        memory_peak = int(torch.cuda.max_memory_allocated(device)) \
            if device.type == "cuda" else 0
        tsids = sorted({int(t) for r in loop.kept.values()
                        for res in r.values() for t in res["tsids"]})
        from horaedb_tpu_torch.storage.types import TimeRange

        series_keys = await engine.resolve_series(
            metric, tsids, TimeRange.new(
                config["start_ms"], config["start_ms"] + config["span_ms"]))
    finally:
        await engine.close()
    del engine
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    queries = loop.queries
    done_in_window = loop.completed_in_window()
    failed = sum(1 for q in queries if q.error)
    lat = loop.latencies_ms()
    result_metrics = {}
    if not trace:
        values = {"queries_per_s": loop.work_in_window() / seconds,
                  "setup_s": setup_s}
        for m in catalog.end_to_end(bench, name):
            result_metrics[m["name"]] = {"value": values[m["name"]],
                                         "unit": m["unit"]}
    summary = None
    if trace:
        summary = dtrace.summarize(spans)
        readings = Readings(
            queries=len(queries) - failed, fields_per_query=len(fields),
            counters=delta(after[0], before[0]),
            stages=delta(after[1], before[1]), trace=summary,
            scan_work=roofline.field_scan_work(
                traffic.get("host_draw", config["scale"]),
                traffic["window_ms"],
                config["interval_ms"], traffic["bucket_ms"],
                traffic["aggs"]),
            segment_rows=config["scale"] * (deploy.parse_duration_ms(
                config["segment_duration"]) // config["interval_ms"]),
            card=card, latencies_ms=lat)
        for m in catalog.per_layer(bench, name):
            value = catalog.reader(m["name"])(readings)
            if value is not None:
                result_metrics[m["name"]] = {"value": value,
                                             "unit": m["unit"]}

    starts_of = {q.index: q.start_ms for q in queries}
    hosts_of = {q.index: q.hosts for q in queries if q.hosts is not None}
    numbers = check.compare(loop.kept, starts_of, series_keys, data,
                            traffic, metric, hosts_of)
    correct, checks = check.judge(numbers, limits)
    correct = correct and failed == 0 and done_in_window > 0
    result = {
        "correct": correct,
        "attempted": len(queries),
        "failed": failed,
        "metrics": result_metrics,
        "device": {"platform": "gpu" if device.type == "cuda"
                   else device.type, "kind": card, "count": 1,
                   "memory_peak_bytes": memory_peak},
    }
    if trace:
        result["device"]["busy_s"] = summary.busy_s
        result["device"]["window_s"] = summary.window_s
        result["breakdown"] = {"device_ops": summary.device_ops,
                               "idle_gaps": summary.idle_gaps}
    errors = sorted({q.error for q in queries if q.error})
    info = {**steps, "queries_in_window": done_in_window,
            "latency_median_ms": statistics.median(lat) if lat else None,
            "latency_p95_ms": float(np.percentile(lat, 95)) if lat else None,
            "errors": errors[:5]}
    if trace:
        info.update(trace_activities=summary.activities,
                    trace_device_s=summary.device_s,
                    clock_drift_us=summary.clock_drift_us)
    result["checks"] = checks
    return CellRun(result, info)
