"""The port's spans on the device trace's clock: every span and interval
carries start_ns/end_ns on time.perf_counter_ns() and its thread; plan
stages, worker-pool hops and garbage-collector pauses record intervals
through tracing.record_interval; the engine's query paths record
resolve, plan and their stages (the fused route also window_prep and
fused_finish)."""

import asyncio
import gc
import threading
import time

import numpy as np
import pyarrow as pa
import pytest

from horaedb_tpu_torch.common.runtimes import Runtimes
from horaedb_tpu_torch.metric_engine import MetricEngine
from horaedb_tpu_torch.objstore import MemoryObjectStore
from horaedb_tpu_torch.storage import read as read_mod
from horaedb_tpu_torch.storage.types import TimeRange
from horaedb_tpu_torch.utils import registry, tracing

HOUR = 3_600_000
T0 = 1_700_000_000_000


def bound_trace(name="/q"):
    return tracing.Trace(tracing.new_trace_id(), name)


def by_name(done: dict) -> dict:
    out: dict = {}
    for s in done["spans"]:
        out.setdefault(s["name"], []).append(s)
    return out


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_spans_nest_on_perf_counter_ns_with_their_parents(depth):
    before = time.perf_counter_ns()
    trace = bound_trace()
    with tracing.trace_scope(trace):
        def nest(level):
            with tracing.span(f"level{level}"):
                if level + 1 < depth:
                    nest(level + 1)
        nest(0)
    done = trace.finish()
    after = time.perf_counter_ns()
    spans = by_name(done)
    root = spans["/q"][0]
    assert before <= root["start_ns"] <= root["end_ns"] <= after
    parent = root
    for level in range(depth):
        (s,) = spans[f"level{level}"]
        assert s["parent_id"] == parent["span_id"]
        assert parent["start_ns"] <= s["start_ns"] <= s["end_ns"] \
            <= parent["end_ns"]
        assert s["thread"] == threading.get_ident()
        assert s["duration_ms"] == pytest.approx(
            (s["end_ns"] - s["start_ns"]) / 1e6, abs=1e-3)
        parent = s


def test_start_ms_follows_the_wall_clock():
    trace = bound_trace()
    with tracing.trace_scope(trace):
        time.sleep(0.02)
        wall = time.time() * 1e3
        with tracing.span("late"):
            pass
    (s,) = by_name(trace.finish())["late"]
    assert abs(s["start_ms"] - wall) < 5.0


def test_a_span_feeds_one_bound_histogram():
    h = registry.histogram("span_clock_probe_seconds")
    n = h.count
    with tracing.span("clock_probe"):
        pass
    with tracing.span("clock_probe"):
        pass
    assert h.count == n + 2
    assert tracing._SPAN_HISTOGRAMS["clock_probe"] is h


@pytest.mark.parametrize("stage", ["stack_build", "window_prep",
                                   "fused_finish"])
def test_observe_stage_records_an_interval_and_its_seconds(stage):
    h = registry.histogram("scan_stage_seconds").labels(stage=stage)
    count, total = h.count, h.sum
    trace = bound_trace()
    with tracing.trace_scope(trace):
        t0 = time.perf_counter_ns()
        t1 = t0 + 2_500_000
        read_mod._observe_stage(stage, t0, t1)
    done = trace.finish()
    (s,) = by_name(done)[stage]
    assert (s["start_ns"], s["end_ns"]) == (t0, t1)
    assert s["parent_id"] == trace.root_span_id
    assert h.count == count + 1
    assert h.sum == pytest.approx(total + 0.0025)
    assert done["counters"][f"stage_{stage}_ms"] == pytest.approx(2.5)
    # the stage feeds its own series, not a span histogram
    assert f"span_{stage}_seconds" not in registry.snapshot()


def test_a_pool_hop_records_its_two_waits():
    rt = Runtimes(sst_threads=1)
    trace = bound_trace()

    async def go():
        with tracing.trace_scope(trace):
            with tracing.span("caller"):
                return await rt.run("sst", lambda: time.sleep(0.01) or 7)

    try:
        assert asyncio.run(go()) == 7
    finally:
        rt.close()
    spans = by_name(trace.finish())
    (caller,) = spans["caller"]
    (queue,) = spans["pool_queue"]
    (resume,) = spans["loop_resume"]
    for s in (queue, resume):
        assert s["parent_id"] == caller["span_id"]
        assert s["fields"] == {"pool": "sst"}
        assert caller["start_ns"] <= s["start_ns"] <= s["end_ns"] \
            <= caller["end_ns"]
    # the job's 10 ms lie between the two waits
    assert resume["start_ns"] - queue["end_ns"] >= 10_000_000


@pytest.fixture
def no_gc_watch(monkeypatch):
    """This test's engine as the process's only watcher of GC pauses
    (an engine another test left open keeps the hook registered)."""
    held = gc.callbacks.count(tracing._on_gc)
    for _ in range(held):
        gc.callbacks.remove(tracing._on_gc)
    monkeypatch.setattr(tracing, "_gc_users", 0)
    yield
    gc.callbacks.extend([tracing._on_gc] * held)


def test_gc_pause_is_recorded_and_the_engine_close_unhooks_it(no_gc_watch):
    assert tracing._on_gc not in gc.callbacks

    async def go():
        engine = await MetricEngine.open("m", MemoryObjectStore(),
                                         device="cpu")
        try:
            assert gc.callbacks.count(tracing._on_gc) == 1
            trace = bound_trace()
            with tracing.trace_scope(trace):
                gc.collect()
            return trace.finish()
        finally:
            await engine.close()

    h = registry.histogram("span_gc_pause_seconds")
    n = h.count
    done = asyncio.run(go())
    pauses = by_name(done)["gc_pause"]
    assert any(p["fields"] == {"generation": 2} for p in pauses)
    assert all(p["start_ns"] <= p["end_ns"] for p in pauses)
    assert h.count >= n + 1
    assert tracing._on_gc not in gc.callbacks


def _batch(field_seed: int, hosts: int = 8, points: int = 360):
    rng = np.random.default_rng(field_seed)
    hs = [f"h{i}" for i in range(hosts) for _ in range(points)]
    ts = [T0 + j * 10_000 for _ in range(hosts) for j in range(points)]
    return pa.record_batch({
        "host": pa.array(hs), "timestamp": pa.array(ts, type=pa.int64()),
        "value": pa.array(rng.random(hosts * points), type=pa.float64())})


@pytest.mark.parametrize("route", ["fused", "parts"])
def test_a_query_records_resolve_plan_and_its_stages(monkeypatch, route):
    monkeypatch.setenv("HORAEDB_FUSED_AGG", "1" if route == "fused" else "0")
    fields = ["a", "b"]

    async def go():
        engine = await MetricEngine.open("m", MemoryObjectStore(),
                                         segment_ms=HOUR, device="cpu")
        try:
            for i, f in enumerate(fields):
                await engine.write_arrow("cpu", ["host"], _batch(i),
                                         field=f)
            trace = bound_trace()
            with tracing.trace_scope(trace):
                out = await engine.query_downsample_multi(
                    "cpu", [], TimeRange.new(T0, T0 + HOUR), 600_000,
                    fields, aggs=("avg",))
            return out, trace.finish()
        finally:
            await engine.close()

    out, done = asyncio.run(go())
    assert set(out) == set(fields) and all(r["tsids"] for r in out.values())
    spans = by_name(done)
    assert len(spans["resolve"]) == 1
    assert len(spans["plan"]) == len(fields)
    assert spans["pool_queue"] and spans["loop_resume"]
    if route == "fused":
        assert len(spans["window_prep"]) == len(fields)
        # the finish inside device_aggregate, then on the event loop
        assert len(spans["fused_finish"]) == 2 * len(fields)
        for agg in spans["device_aggregate"]:
            assert any(agg["start_ns"] <= f["start_ns"] <= f["end_ns"]
                       <= agg["end_ns"] for f in spans["fused_finish"])
        assert spans["stack_build"]
    else:
        assert "window_prep" not in spans and "fused_finish" not in spans
        assert spans["combine"] and spans["segment_read"]
    root = spans["/q"][0]
    for name, group in spans.items():
        for s in group:
            assert root["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= root["end_ns"], name


def test_query_downsample_records_resolve_and_plan():
    async def go():
        engine = await MetricEngine.open("m", MemoryObjectStore(),
                                         segment_ms=HOUR, device="cpu")
        try:
            await engine.write_arrow("cpu", ["host"], _batch(5))
            trace = bound_trace()
            with tracing.trace_scope(trace):
                await engine.query_downsample(
                    "cpu", [], TimeRange.new(T0, T0 + HOUR), 600_000)
            return trace.finish()
        finally:
            await engine.close()

    spans = by_name(asyncio.run(go()))
    (resolve,) = spans["resolve"]
    (plan,) = spans["plan"]
    (down,) = spans["downsample"]
    assert plan["parent_id"] == down["span_id"]
    assert resolve["end_ns"] <= down["start_ns"]

