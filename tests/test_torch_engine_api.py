"""The rest of the port's engine API against the JAX package's, on the
same seeded inputs, the port on the CPU: the scalar write() path
(SampleManager.persist) against write_arrow() and the reference's rows,
query_downsample_multi, the label/list APIs and resolve_series, and the
range-vector functions (metric_engine/functions.py).  Grids:
count/min/max/last/last_ts exact, sum/avg rtol 1e-5."""

import asyncio

import numpy as np
import pyarrow as pa
import pytest
import torch
from test_torch_engine import _compare

from horaedb_tpu.metric_engine import Label as RefLabel
from horaedb_tpu.metric_engine import MetricEngine as RefEngine
from horaedb_tpu.metric_engine import Sample as RefSample
from horaedb_tpu.metric_engine import functions as ref_functions
from horaedb_tpu.objstore import MemoryObjectStore as RefStore
from horaedb_tpu.storage.types import TimeRange as RefRange
from horaedb_tpu_torch.common import Error
from horaedb_tpu_torch.metric_engine import Label, MetricEngine, Sample
from horaedb_tpu_torch.metric_engine import functions
from horaedb_tpu_torch.objstore import MemoryObjectStore
from horaedb_tpu_torch.storage.types import TimeRange

HOUR = 3_600_000
T0 = 1_700_000_000_000


def run(coro):
    return asyncio.run(coro)


def _rows(tbl) -> list:
    return sorted(zip(tbl.column("tsid").to_pylist(),
                      tbl.column("timestamp").to_pylist(),
                      tbl.column("value").to_pylist()))


def _seeded(seed: int, n: int = 2000, hosts: int = 20):
    rng = np.random.default_rng(seed)
    hs = [f"h{int(i):02d}" for i in rng.integers(0, hosts, n)]
    regions = ["east" if h < "h10" else "west" for h in hs]
    ts = (T0 + rng.integers(0, 3 * HOUR, n)).tolist()
    vals = rng.random(n).round(4).tolist()
    return hs, regions, ts, vals


FILTERS = ([], [("host", "h03")], [("region", "east")],
           [("host", "h15"), ("region", "west")], [("host", "nope")])


@pytest.mark.parametrize("seed", range(2))
def test_scalar_write_equals_write_arrow_and_reference(seed):
    async def go():
        hs, regions, ts, vals = _seeded(seed)
        batch = pa.record_batch({
            "host": pa.array(hs), "region": pa.array(regions),
            "timestamp": pa.array(ts, type=pa.int64()),
            "value": pa.array(vals, type=pa.float64()),
        })
        bulk = await MetricEngine.open("m", MemoryObjectStore(),
                                       segment_ms=2 * HOUR, device="cpu")
        scalar = await MetricEngine.open("m", MemoryObjectStore(),
                                         segment_ms=2 * HOUR, device="cpu")
        ref = await RefEngine.open("m", RefStore(), segment_ms=2 * HOUR)
        try:
            await bulk.write_arrow("cpu", ["host", "region"], batch)
            await scalar.write([
                Sample("cpu", [Label("host", h), Label("region", r)], t, v)
                for h, r, t, v in zip(hs, regions, ts, vals)])
            await ref.write([
                RefSample("cpu", [RefLabel("host", h),
                                  RefLabel("region", r)], t, v)
                for h, r, t, v in zip(hs, regions, ts, vals)])
            q = (T0, T0 + 4 * HOUR)
            for filters in FILTERS:
                a = _rows(await bulk.query("cpu", filters,
                                           TimeRange.new(*q)))
                b = _rows(await scalar.query("cpu", filters,
                                             TimeRange.new(*q)))
                c = _rows(await ref.query("cpu", filters, RefRange.new(*q)))
                assert a == b == c, filters
            # one SST per touched segment from the scalar path
            assert len(await scalar.tables["data"].manifest.all_ssts()) == \
                len(await ref.tables["data"].manifest.all_ssts())
        finally:
            await bulk.close()
            await scalar.close()
            await ref.close()

    run(go())


def test_scalar_write_empty_and_overwrite():
    async def go():
        e = await MetricEngine.open("m", MemoryObjectStore(),
                                    segment_ms=2 * HOUR, device="cpu")
        try:
            await e.write([])
            for v in (1.0, 2.0):
                await e.write([Sample("cpu", [Label("h", "a")],
                                      T0 + 1000, v)])
            tbl = await e.query("cpu", [], TimeRange.new(T0, T0 + HOUR))
            assert tbl.column("value").to_pylist() == [2.0]
        finally:
            await e.close()

    run(go())


MULTI_QUERIES = [
    ([], ("count", "sum", "min", "max", "avg", "last"), (T0, T0 + 4 * HOUR)),
    ([("host", "h03")], ("avg",), (T0, T0 + 4 * HOUR)),
    ([], ("max", "last"), (T0 + 123_456, T0 + 3 * HOUR - 98_765)),
    ([("host", "nope")], ("avg",), (T0, T0 + 4 * HOUR)),
]


@pytest.mark.parametrize("query", range(len(MULTI_QUERIES)))
def test_query_downsample_multi_matches_reference(query):
    """Two fields of one metric; each field's grid against the
    reference's multi-field query and against the port's own
    single-field query_downsample."""
    filters, aggs, q = MULTI_QUERIES[query]

    async def go():
        rng = np.random.default_rng(21)
        n = 3000
        rows = list(zip(rng.integers(0, 8, n),
                        (T0 + rng.integers(0, 4 * HOUR, n)).tolist(),
                        rng.random(n) * 100, rng.random(n) * 10))
        port = await MetricEngine.open("m", MemoryObjectStore(),
                                       segment_ms=2 * HOUR, device="cpu")
        ref = await RefEngine.open("m", RefStore(), segment_ms=2 * HOUR)
        try:
            for fld, col in (("value", 2), ("free", 3)):
                await port.write([Sample("mem", [Label("host", f"h{h:02d}")],
                                         t, float(r[col]), field_name=fld)
                                  for r in rows for h, t in [r[:2]]])
                await ref.write([RefSample("mem",
                                           [RefLabel("host", f"h{h:02d}")],
                                           t, float(r[col]), field_name=fld)
                                 for r in rows for h, t in [r[:2]]])
            got = await port.query_downsample_multi(
                "mem", filters, TimeRange.new(*q), 600_000,
                fields=["value", "free"], aggs=aggs)
            want = await ref.query_downsample_multi(
                "mem", filters, RefRange.new(*q), 600_000,
                fields=["value", "free"], aggs=aggs)
            assert sorted(got) == ["free", "value"]
            for fld in ("value", "free"):
                _compare(want[fld], got[fld])
                single = await port.query_downsample(
                    "mem", filters, TimeRange.new(*q), 600_000, field=fld,
                    aggs=aggs)
                _compare(single, got[fld])
            with pytest.raises(Error):
                await port.query_downsample_multi(
                    "mem", [], TimeRange.new(*q), 600_000, fields=[])
        finally:
            await port.close()
            await ref.close()

    run(go())


HTTP = [
    ("http_requests", [("url", "/api/put"), ("code", "200"),
                       ("job", "proxy")], T0 + 1000, 100.0, "value"),
    ("http_requests", [("url", "/api/query"), ("code", "200"),
                       ("job", "proxy")], T0 + 2000, 10.0, "value"),
    ("http_requests", [("url", "/api/put"), ("code", "500"),
                       ("job", "proxy")], T0 + 3000, 1.0, "value"),
    ("grpc_requests", [("job", "proxy")], T0 + 1000, 7.0, "value"),
    ("mem", [("h", "a")], T0 + 1000, 1.0, "value"),
    ("mem", [("h", "a")], T0 + 1000, 2.0, "free"),
]


@pytest.mark.parametrize("chunked", [False, True])
def test_label_and_list_apis_match_reference(chunked):
    async def go():
        port = await MetricEngine.open("m", MemoryObjectStore(),
                                       segment_ms=2 * HOUR, device="cpu",
                                       chunked_data=chunked)
        ref = await RefEngine.open("m", RefStore(), segment_ms=2 * HOUR,
                                   chunked_data=chunked)
        try:
            await port.write([Sample(n, [Label(k, v) for k, v in lb], t, x,
                                     field_name=f)
                              for n, lb, t, x, f in HTTP])
            await ref.write([RefSample(n, [RefLabel(k, v) for k, v in lb],
                                       t, x, field_name=f)
                             for n, lb, t, x, f in HTTP])
            q = (T0, T0 + HOUR)
            pr, rr = TimeRange.new(*q), RefRange.new(*q)
            assert await port.list_metrics(pr) == \
                await ref.list_metrics(rr) == \
                ["grpc_requests", "http_requests", "mem"]
            for metric in ("http_requests", "grpc_requests", "mem", "nope"):
                assert await port.label_names(metric, pr) == \
                    await ref.label_names(metric, rr)
                assert await port.list_fields(metric, pr) == \
                    await ref.list_fields(metric, rr)
                for key in ("url", "code", "job", "h", "nope"):
                    assert await port.label_values(metric, key, pr) == \
                        await ref.label_values(metric, key, rr)
            assert await port.label_names("http_requests", pr) == \
                ["code", "job", "url"]
            assert await port.list_fields("mem", pr) == ["free", "value"]
            assert await port.label_values("http_requests", "url", pr) == \
                ["/api/put", "/api/query"]
            # empty windows list nothing
            far = TimeRange.new(T0 + 10 * HOUR, T0 + 11 * HOUR)
            assert await port.list_metrics(far) == []
            # tsid -> series key through the series table
            tbl = await port.query("http_requests", [], pr)
            tsids = sorted(set(tbl.column("tsid").to_pylist()))
            got = await port.resolve_series("http_requests", tsids, pr)
            want = await ref.resolve_series("http_requests", tsids, rr)
            assert got == want and len(got) == 3
            assert await port.resolve_series("nope", tsids, pr) == {}
        finally:
            await port.close()
            await ref.close()

    run(go())


def _grids(seed: int):
    rng = np.random.default_rng(seed)
    g, b = 7, 40
    last = np.cumsum(rng.random((g, b)) * 5, axis=1)
    # counter resets, empty buckets and a flat run
    last[1, 10:] -= last[1, 10] - 0.5
    last[2, rng.integers(0, b, 6)] = np.nan
    last[3, :] = np.nan
    last[4, 5:15] = 3.0
    last[5, 20] = -1.0
    return {"last": last.astype(np.float32)}


@pytest.mark.parametrize("fn", ["delta", "increase", "rate"])
@pytest.mark.parametrize("seed", range(3))
def test_range_functions_match_reference(fn, seed):
    aggs = _grids(seed)
    for bucket in (60_000, 3_600_000):
        got = getattr(functions, fn)(aggs, bucket)
        want = getattr(ref_functions, fn)(aggs, bucket)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
        # a fused-path grid (a tensor on its device) gives the same
        tensor = {"last": torch.from_numpy(aggs["last"])}
        assert getattr(functions, fn)(tensor, bucket).tobytes() == \
            want.tobytes()


def test_range_functions_on_an_engine_grid():
    """rate over a real downsample grid of a counter with a reset."""
    async def go():
        e = await MetricEngine.open("m", MemoryObjectStore(),
                                    segment_ms=2 * HOUR, device="cpu")
        ref = await RefEngine.open("m", RefStore(), segment_ms=2 * HOUR)
        try:
            vals = [10.0, 20.0, 35.0, 5.0, 15.0, 30.0]
            for i, v in enumerate(vals):
                await e.write([Sample("req", [Label("h", "a")],
                                      T0 + i * 60_000 + 1, v)])
                await ref.write([RefSample("req", [RefLabel("h", "a")],
                                           T0 + i * 60_000 + 1, v)])
            q = (T0, T0 + 6 * 60_000)
            g = await e.query_downsample("req", [], TimeRange.new(*q),
                                         60_000, aggs=("last",))
            r = await ref.query_downsample("req", [], RefRange.new(*q),
                                           60_000, aggs=("last",))
            got = functions.rate(g["aggs"], 60_000)
            want = ref_functions.rate(r["aggs"], 60_000)
            np.testing.assert_array_equal(got, want)
            np.testing.assert_allclose(
                functions.increase(g["aggs"], 60_000)[0, 1:],
                [10.0, 15.0, 5.0, 10.0, 15.0])
        finally:
            await e.close()
            await ref.close()

    run(go())
