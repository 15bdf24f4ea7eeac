"""The readers of the program's spans and stages, and the naming of idle
gaps by program spans (`perfbench/spanclock.py`), on synthetic
readings and traces."""

import asyncio
import contextlib
import time
import types

import pytest

from perfbench import catalog, harness, roofline, spanclock, spanreads
from perfbench.devtrace import Activity, DeviceTrace, HostSpans

SERIES = {
    "resolve_ms_per_query": "span_resolve_seconds",
    "plan_ms_per_query": "span_plan_seconds",
    "window_prep_ms_per_query": 'scan_stage_seconds{stage="window_prep"}',
    "fused_finish_ms_per_query": 'scan_stage_seconds{stage="fused_finish"}',
    "pool_queue_ms_per_query": "span_pool_queue_seconds",
    "loop_resume_ms_per_query": "span_loop_resume_seconds",
    "gc_pause_ms_per_query": "span_gc_pause_seconds",
    "upload_ms_per_query": 'device_transfer_seconds_total{direction="h2d"}',
}


def readings(queries, counters):
    return harness.Readings(
        queries=queries, fields_per_query=1, counters=counters, stages={},
        trace=None,
        scan_work=roofline.field_scan_work(12, 43_200_000, 10_000,
                                           3_600_000, ["avg"]),
        segment_rows=12 * 720, card="cpu", latencies_ms=[1.0])


@pytest.mark.parametrize("name", sorted(SERIES))
def test_reader_value_zero_and_none(monkeypatch, name):
    read = catalog.reader(name)
    series = SERIES[name]
    assert read(readings(4, {series: 0.5, "other": 9.0})) == 125.0
    monkeypatch.setattr(spanreads, "program_has", lambda s: s == series)
    assert read(readings(4, {"other": 9.0})) == 0.0
    # a program without the span or stage (the parent of this metric)
    monkeypatch.setattr(spanreads, "program_has", lambda s: False)
    assert read(readings(4, {"other": 9.0})) is None
    # no query completed
    assert read(readings(0, {series: 0.5})) is None


def test_every_new_reader_has_an_entry():
    names = {m["name"] for m in catalog.benchmark()["per_layer"]}
    assert set(SERIES) <= names


def test_program_has_its_series_once_imported():
    from horaedb_tpu_torch.common import runtimes  # noqa: F401
    from horaedb_tpu_torch.storage import read  # noqa: F401

    assert spanreads.program_has("span_gc_pause_seconds")
    assert spanreads.program_has('scan_stage_seconds{stage="window_prep"}')
    assert not spanreads.program_has("span_no_such_thing_seconds")


def call(name, start, end, spans):
    """A CallTrace; spans as (start, end, name, id, parent)."""
    return spanclock.CallTrace(name, start, end, spans)


def test_planted_gap_lands_on_the_planted_span():
    # one call 0-100 (ns x 1e6): plan 10-20, window_prep 20-60 holding a
    # pool_queue 30-40; gaps 32-38 (in pool_queue), 45-55 (window_prep
    # alone), 95-120 (5 in the call, 20 outside any)
    ms = 1_000_000
    c = call("query_downsample_multi", 0, 100 * ms, [
        (10 * ms, 20 * ms, "plan", "p", "root"),
        (20 * ms, 60 * ms, "window_prep", "w", "root"),
        (30 * ms, 40 * ms, "pool_queue", "q", "root"),
    ])
    gaps = [(32 * ms, 38 * ms), (45 * ms, 55 * ms), (95 * ms, 120 * ms)]
    split = spanclock.attribute(gaps, [c])
    assert split[0] == pytest.approx({"pool_queue": 0.006})
    assert split[1] == pytest.approx({"window_prep": 0.010})
    assert split[2] == pytest.approx({"query_downsample_multi": 0.005,
                                      spanclock.OUTSIDE: 0.020})
    out = spanclock.summarize(gaps, [c], 0)
    assert sum(s for _l, s in out["idle_by_span"]) == pytest.approx(0.041)
    assert out["idle_gaps_program"][0][0].startswith(
        f"{spanclock.OUTSIDE} 0.020s, query_downsample_multi 0.005s at "
        "0.095s")
    # leaves: plan, window_prep, pool_queue (none is a parent): 10-60
    assert out["span_coverage"] == pytest.approx(0.5)


def test_outside_a_call_the_window_trace_names_the_instant():
    ms = 1_000_000
    c = call("query_downsample_multi", 0, 100 * ms,
             [(10 * ms, 60 * ms, "window_prep", "w", "r")])
    window = call("window", -10 * ms, 200 * ms,
                  [(100 * ms, 110 * ms, "to_host", "t", "W"),
                   (112 * ms, 118 * ms, "gc_pause", "g", "W")])
    (split,) = spanclock.attribute([(50 * ms, 130 * ms)], [c], window)
    assert split == pytest.approx({
        "window_prep": 0.010, "query_downsample_multi": 0.040,
        "to_host": 0.010, "gc_pause": 0.006, spanclock.OUTSIDE: 0.014})


def test_calls_in_flight_share_an_idle_instant():
    ms = 1_000_000
    a = call("query_downsample", 0, 10 * ms,
             [(0, 10 * ms, "segment_read", "s", "r")])
    b = call("query_downsample", 5 * ms, 20 * ms,
             [(5 * ms, 20 * ms, "loop_resume", "l", "r")])
    split = spanclock.attribute([(0, 20 * ms)], [a, b])
    assert split[0] == pytest.approx({"segment_read": 0.0075,
                                      "loop_resume": 0.0125})


def test_leaf_coverage_leaves_parents_out():
    c = call("q", 0, 100, [(0, 50, "resolve", "r", "root"),
                           (10, 20, "pool_queue", "h", "r"),
                           (60, 100, "stack_build", "s", "root")])
    # resolve names a child, so only 10-20 and 60-100 count
    assert spanclock.leaf_coverage(c) == pytest.approx(0.5)


def test_idle_gaps_match_the_device_trace_summary():
    acts = [Activity("cudaSleep", 1000, 1100), Activity("k1", 1200, 1300),
            Activity("k2", 1250, 1400), Activity("k3", 1700, 1800),
            Activity("cudaSleep", 2000, 2100)]
    gaps, start = spanclock.idle_gaps(acts, [600, 1600])
    # device = host + 400
    assert start == 700
    assert gaps == [(700, 800), (1000, 1300), (1400, 1600)]
    assert sum(e - s for s, e in gaps) == 900 - (200 + 100)


def test_install_binds_a_program_trace_to_each_engine_call():
    from horaedb_tpu_torch.utils import tracing

    fake = types.SimpleNamespace(HostSpans=HostSpans,
                                 DeviceTrace=DeviceTrace,
                                 run_cell=lambda: None)
    spanclock.install(fake)
    spans = fake.HostSpans()
    with spans.span("query_downsample"):
        with tracing.span("resolve"):
            pass
        assert tracing.active_trace() is not None
    with spans.span("to_host"):
        assert tracing.active_trace() is None
    assert [n for n, _s, _e in spans.spans] == ["query_downsample",
                                                "to_host"]
    (c,) = spans.calls
    assert c.name == "query_downsample"
    assert [s[2] for s in c.spans] == ["resolve"]
    assert c.start_ns <= c.spans[0][0] <= c.spans[0][1] <= c.end_ns
    # the program's ring saw nothing
    assert all(t["root"] != "query_downsample"
               for t in tracing.recorder.list())


class FakeDeviceTrace:
    """DeviceTrace's surface without a card: the host marks, and a
    device timeline of the two markers and one kernel in between."""

    def __init__(self, device):
        self.host_marks = []

    def start(self):
        self.host_marks.append(time.perf_counter_ns())

    def stop(self):
        self.host_marks.append(time.perf_counter_ns())

    def activities(self):
        a, b = self.host_marks
        mid = (a + b) // 2
        return [Activity("sleep", a, a + 10), Activity("k", mid, mid + 10),
                Activity("sleep", b, b + 10)]

    def summarize(self, spans, top=10):
        return None


def test_a_window_binds_its_calls_and_names_its_gaps():
    from horaedb_tpu_torch.utils import tracing

    fake = types.SimpleNamespace(HostSpans=HostSpans,
                                 DeviceTrace=FakeDeviceTrace,
                                 run_cell=lambda: None)
    found = spanclock.install(fake)
    spans, dt = fake.HostSpans(), fake.DeviceTrace(None)

    async def client():
        with spans.span("query_downsample"):
            with tracing.span("plan"):
                time.sleep(0.002)
        with spans.span("to_host"):
            time.sleep(0.002)
        t0 = time.perf_counter_ns()
        time.sleep(0.002)
        # a pause outside any call lands on the window's trace
        tracing.record_interval("gc_pause", t0, time.perf_counter_ns(),
                                None)

    async def window():
        dt.start()
        async with asyncio.TaskGroup() as tg:
            tg.create_task(client())
        dt.stop()

    asyncio.run(window())
    assert tracing.active_trace() is None
    dt.summarize(spans)
    labels = dict(found["idle_by_span"])
    for name in ("plan", "to_host", "gc_pause"):
        assert labels[name] >= 0.0015, (name, labels)
    assert 0.0 < found["span_coverage"] <= 1.0
    assert len(found["idle_gaps_program"]) == 2


def test_result_keys_and_harness_spans_are_unchanged():
    """The spans the harness labels its gaps with are recorded as
    before, whatever the engine call raises."""
    fake = types.SimpleNamespace(HostSpans=HostSpans,
                                 DeviceTrace=DeviceTrace,
                                 run_cell=lambda: None)
    spanclock.install(fake)
    spans = fake.HostSpans()
    with contextlib.suppress(ValueError):
        with spans.span("query_downsample_multi"):
            raise ValueError("boom")
    assert [n for n, _s, _e in spans.spans] == ["query_downsample_multi"]
    assert len(spans.calls) == 1
