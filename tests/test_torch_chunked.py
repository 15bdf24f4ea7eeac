"""The chunked data layout of the port (metric_engine/chunks.py, the
Append merge in storage/operator.py and storage/read.py, the engine's
chunked branches) against the JAX package's, on the same seeded inputs,
the port on the CPU.

- The chunk codec: encoded bytes equal the JAX package's, decodes equal,
  corrupt payloads raise in both.
- BytesMergeOperator and build_operator against the reference's.
- The chunked engine against the JAX chunked engine.  The JAX side runs
  with HORAEDB_HOST_AGG=0 and set_downsample_impl("pallas"): its
  chunked aggregate goes through the Pallas kernel's
  pallas_time_bucket_aggregate entry in interpret mode, the entry the
  port's bucket_window_partials replaces (both restored after each
  test).  Grids: count/min/max/last/last_ts exact, sum/avg rtol 1e-5.
- The streamed Append read against the bulk read, and its mid-segment
  re-resolution after a compaction (strict_no_replay)."""

import asyncio

import numpy as np
import pyarrow as pa
import pytest
from test_torch_engine import _compare, _numpy

import horaedb_tpu.common as ref_common
import horaedb_tpu.ops.downsample as ref_downsample
from horaedb_tpu.metric_engine import Label as RefLabel
from horaedb_tpu.metric_engine import MetricEngine as RefEngine
from horaedb_tpu.metric_engine import Sample as RefSample
from horaedb_tpu.metric_engine import chunks as ref_chunks
from horaedb_tpu.objstore import MemoryObjectStore as RefStore
from horaedb_tpu.storage import operator as ref_operator
from horaedb_tpu.storage.config import UpdateMode as RefMode
from horaedb_tpu.storage.types import TimeRange as RefRange
from horaedb_tpu_torch.common import Error
from horaedb_tpu_torch.metric_engine import Label, MetricEngine, Sample
from horaedb_tpu_torch import native
from horaedb_tpu_torch.metric_engine import chunks
from horaedb_tpu_torch.objstore import LocalObjectStore, MemoryObjectStore
from horaedb_tpu_torch.ops import bucket_agg
from horaedb_tpu_torch.storage import operator
from horaedb_tpu_torch.storage.config import StorageConfig, UpdateMode, from_dict
from horaedb_tpu_torch.storage.read import ScanRequest
from horaedb_tpu_torch.storage.storage import CloudObjectStorage, WriteRequest
from horaedb_tpu_torch.storage.types import TimeRange

HOUR = 3_600_000
T0 = 1_700_000_000_000
SEGMENT_MS = 3_600_000


def run(coro):
    return asyncio.run(coro)


@pytest.fixture
def pallas_reference(monkeypatch):
    """The JAX package's chunked aggregate through its Pallas kernel
    (interpret mode on the CPU), restored afterwards."""
    monkeypatch.setenv("HORAEDB_HOST_AGG", "0")
    prev = ref_downsample._impl
    ref_downsample.set_downsample_impl("pallas")
    yield
    ref_downsample.set_downsample_impl(prev)


# ---- the chunk codec ------------------------------------------------------

def _codec_case(kind: str, seed: int):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 400))
    base = T0 + int(rng.integers(0, HOUR))
    if kind == "regular_gauge":  # dod 0, one-decimal values
        ts = base + np.arange(n, dtype=np.int64) * 10_000
        vals = np.round(rng.random(n) * 100, 1)
    elif kind == "jitter":  # dod widths 1-2 bytes, XOR values
        ts = base + np.cumsum(rng.integers(9_000, 11_000, n))
        vals = rng.random(n) * 1e3
    elif kind == "wide_jumps":  # dod 4 bytes
        ts = base + np.cumsum(rng.integers(1, 2_000_000, n))
        vals = rng.integers(-10**6, 10**6, n).astype(np.float64)
    elif kind == "constant":
        ts = base + np.arange(n, dtype=np.int64) * 15_000
        vals = np.full(n, float(rng.integers(0, 100)))
    elif kind == "unsorted_dups":  # encoder sorts; equal ts survive
        ts = base + rng.integers(0, 60_000, n)
        vals = rng.standard_normal(n)
    else:  # "special": signed zeros, inf, nan, subnormal, huge
        ts = base + np.arange(n, dtype=np.int64) * 1000
        pool = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 5e-324,
                         1.7e308, 1.5, -2.25])
        vals = pool[rng.integers(0, len(pool), n)]
    return np.asarray(ts, dtype=np.int64), np.asarray(vals, dtype=np.float64)


CODEC_KINDS = ["regular_gauge", "jitter", "wide_jumps", "constant",
               "unsorted_dups", "special"]


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("kind", CODEC_KINDS)
def test_encode_chunk_bytes_equal_reference(kind, seed):
    ts, vals = _codec_case(kind, seed)
    with np.errstate(over="ignore", invalid="ignore"):
        got = chunks.encode_chunk(ts, vals)
        assert got == ref_chunks.encode_chunk(ts, vals)
    d_ts, d_vals = native.decode_chunks_plain(got)
    r_ts, r_vals = ref_chunks.decode_chunks(got)
    assert d_ts.tobytes() == r_ts.tobytes()
    assert d_vals.tobytes() == r_vals.tobytes()


@pytest.mark.parametrize("seed", range(4))
def test_concatenated_payloads_decode_as_reference(seed):
    """BytesMerge concatenates chunks in seq order; the later chunk's
    point wins a timestamp tie, in both packages."""
    rng = np.random.default_rng(100 + seed)
    parts = []
    for j in range(int(rng.integers(2, 6))):
        ts, vals = _codec_case(CODEC_KINDS[j % 5], seed * 10 + j)
        if j and rng.random() < 0.7:
            ts = ts.copy()
            ts[: len(ts) // 2] = T0 + rng.integers(0, HOUR, len(ts) // 2)
        parts.append(chunks.encode_chunk(ts, vals))
    payload = b"".join(parts)
    d_ts, d_vals = native.decode_chunks_plain(payload)
    r_ts, r_vals = ref_chunks.decode_chunks(payload)
    assert d_ts.tobytes() == r_ts.tobytes()
    assert d_vals.tobytes() == r_vals.tobytes()
    assert np.all(np.diff(d_ts) > 0)


def _corruptions():
    good = chunks.encode_chunk(
        T0 + np.arange(50, dtype=np.int64) * 997,
        np.random.default_rng(1).random(50))
    return {
        "bad_magic": b"\x00" + good[1:],
        "truncated_body": good[:-4],
        "truncated_header": good[:10],
        "zero_count": good[:1] + b"\x00\x00\x00\x00" + good[5:],
        # header: magic u8 | count u32 | ts_base i64 | d1 i32 | dod_w u8
        # (byte 17) | vmode u8 (byte 18) | ...
        "bad_dod_width": good[:17] + b"\x03" + good[18:],
        "bad_value_mode": good[:18] + b"\x07" + good[19:],
        "trailing_garbage": good + b"\xc8\x01",
    }


@pytest.mark.parametrize("case", sorted(_corruptions()))
def test_corrupt_payload_raises_in_both(case):
    bad = _corruptions()[case]
    with pytest.raises(Exception) as ref_exc:
        ref_chunks.decode_chunks(bad)
    with pytest.raises(Error):
        native.decode_chunks_plain(bad)
    assert type(ref_exc.value).__name__ == "Error"


# ---- the Append merge operator --------------------------------------------

def _merge_batch(seed: int, string_key: bool):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 300))
    k1 = rng.integers(0, 6, n)
    k2 = rng.integers(0, 9, n)
    seq = rng.integers(1, 1000, n)
    payload = [bytes(rng.integers(0, 256, int(rng.integers(0, 7))).astype(
        np.uint8)) for _ in range(n)]
    keys = ([f"key{int(k):02d}" for k in k1] if string_key
            else k1.astype(np.uint64))
    tbl = pa.table({"k1": pa.array(keys), "k2": pa.array(k2, pa.int64()),
                    "payload": pa.array(payload, pa.binary()),
                    "__seq__": pa.array(seq.astype(np.uint64))})
    order = pa.compute.sort_indices(tbl, sort_keys=[
        ("k1", "ascending"), ("k2", "ascending"), ("__seq__", "ascending")])
    return tbl.take(order).combine_chunks().to_batches()[0]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("string_key", [False, True])
def test_bytes_merge_matches_reference(seed, string_key):
    batch = _merge_batch(seed, string_key)
    got = operator.BytesMergeOperator([2]).merge_sorted_batch(batch, [0, 1])
    want = ref_operator.BytesMergeOperator([2]).merge_sorted_batch(
        batch, [0, 1])
    assert got.equals(want)
    # a sliced input (non-zero array offset) merges the same way
    sl = batch.slice(1)
    assert operator.BytesMergeOperator([2]).merge_sorted_batch(
        sl, [0, 1]).equals(ref_operator.BytesMergeOperator(
            [2]).merge_sorted_batch(sl, [0, 1]))


def test_build_operator_matches_reference():
    assert isinstance(operator.build_operator(UpdateMode.OVERWRITE, []),
                      operator.LastValueOperator)
    assert isinstance(operator.build_operator(UpdateMode.APPEND, [1]),
                      operator.BytesMergeOperator)
    assert isinstance(ref_operator.build_operator(RefMode.APPEND, [1]),
                      ref_operator.BytesMergeOperator)
    with pytest.raises(Error):
        operator.build_operator("bogus", [])
    with pytest.raises(Error):
        operator.BytesMergeOperator([0]).merge_sorted_batch(
            _merge_batch(0, False), [1])  # a uint64 column is not binary


# ---- the chunked engine against the JAX chunked engine --------------------

async def _open_pair(store_port=None, store_ref=None, config=None,
                     ref_config=None):
    port = await MetricEngine.open(
        "chunked_db", store_port or MemoryObjectStore(),
        segment_ms=2 * HOUR, chunked_data=True,
        chunk_window_ms=30 * 60 * 1000, device="cpu", config=config)
    ref = await RefEngine.open(
        "chunked_db", store_ref or RefStore(), segment_ms=2 * HOUR,
        chunked_data=True, chunk_window_ms=30 * 60 * 1000,
        config=ref_config)
    return port, ref


def _samples(S, L, rows):
    return [S(name, [L(k, v) for k, v in labels], ts, value)
            for name, labels, ts, value in rows]


HTTP = [
    ("http_requests", [("url", "/api/put"), ("code", "200"),
                       ("job", "proxy")], T0 + 1000, 100.0),
    ("http_requests", [("url", "/api/query"), ("code", "200"),
                       ("job", "proxy")], T0 + 2000, 10.0),
    ("http_requests", [("url", "/api/put"), ("code", "500"),
                       ("job", "proxy")], T0 + 3000, 1.0),
    ("grpc_requests", [("job", "proxy")], T0 + 1000, 7.0),
]


def _rows(tbl) -> list:
    return sorted(zip(tbl.column("tsid").to_pylist(),
                      tbl.column("timestamp").to_pylist(),
                      tbl.column("value").to_pylist()))


def test_chunked_write_query_roundtrip(pallas_reference):
    async def go():
        port, ref = await _open_pair()
        try:
            await port.write(_samples(Sample, Label, HTTP))
            await ref.write(_samples(RefSample, RefLabel, HTTP))
            for filters, (a, b) in (([("code", "200")], (T0, T0 + HOUR)),
                                    ([], (T0 + 1500, T0 + 2500)),
                                    ([("job", "proxy")], (T0, T0 + HOUR))):
                g = await port.query("http_requests", filters,
                                     TimeRange.new(a, b))
                r = await ref.query("http_requests", filters,
                                    RefRange.new(a, b))
                assert _rows(g) == _rows(r)
            g = await port.query("http_requests", [("code", "200")],
                                 TimeRange.new(T0, T0 + HOUR))
            assert sorted(g.column("value").to_pylist()) == [10.0, 100.0]
        finally:
            await port.close()
            await ref.close()

    run(go())


def test_chunked_cross_file_last_wins(pallas_reference):
    """Two writes of the same (series, ts): BytesMerge concatenates the
    chunks and the decode keeps the later sequence's value."""
    async def go():
        port, ref = await _open_pair()
        try:
            for v in (1.0, 2.0):
                await port.write([Sample("cpu", [Label("h", "a")],
                                         T0 + 1000, v)])
                await ref.write([RefSample("cpu", [RefLabel("h", "a")],
                                           T0 + 1000, v)])
            g = await port.query("cpu", [("h", "a")],
                                 TimeRange.new(T0, T0 + HOUR))
            r = await ref.query("cpu", [("h", "a")],
                                RefRange.new(T0, T0 + HOUR))
            assert g.column("value").to_pylist() == [2.0]
            assert _rows(g) == _rows(r)
        finally:
            await port.close()
            await ref.close()

    run(go())


def _seeded_rows(seed: int, n: int, hosts: int = 7, span: int = 2 * HOUR):
    rng = np.random.default_rng(seed)
    return [("cpu", [("h", f"h{int(h):02d}")], T0 + int(t), float(v))
            for h, t, v in zip(rng.integers(0, hosts, n),
                               rng.integers(0, span, n),
                               rng.random(n) * 100)]


@pytest.mark.parametrize("aggs", [("count", "sum", "min", "max", "avg",
                                   "last"), ("avg",), ("min", "max"),
                                  ("last",)])
def test_chunked_downsample_matches_reference(pallas_reference, aggs):
    async def go():
        port, ref = await _open_pair()
        try:
            rows = _seeded_rows(11, 3000)
            await port.write(_samples(Sample, Label, rows))
            await ref.write(_samples(RefSample, RefLabel, rows))
            for (a, b), bucket in (((T0, T0 + 2 * HOUR), 600_000),
                                   ((T0 + 77_000, T0 + HOUR), 60_000)):
                g = await port.query_downsample(
                    "cpu", [], TimeRange.new(a, b), bucket, aggs=aggs)
                r = await ref.query_downsample(
                    "cpu", [], RefRange.new(a, b), bucket, aggs=aggs)
                _compare(r, g)
                assert all(isinstance(v, np.ndarray)
                           for v in g["aggs"].values())
            f = await port.query_downsample(
                "cpu", [("h", "h03")], TimeRange.new(T0, T0 + HOUR),
                300_000, aggs=aggs)
            _compare(await ref.query_downsample(
                "cpu", [("h", "h03")], RefRange.new(T0, T0 + HOUR),
                300_000, aggs=aggs), f)
        finally:
            await port.close()
            await ref.close()

    run(go())


def test_chunked_downsample_small_exact(pallas_reference):
    async def go():
        port, _ref = await _open_pair()
        await _ref.close()
        try:
            await port.write([Sample("cpu", [Label("h", "a")],
                                     T0 + i * 60_000, float(i))
                              for i in range(10)])
            out = await port.query_downsample(
                "cpu", [], TimeRange.new(T0, T0 + 600_000),
                bucket_ms=300_000)
            assert out["aggs"]["count"].tolist() == [[5.0, 5.0]]
            assert out["aggs"]["sum"].tolist() == [[10.0, 35.0]]
            assert out["aggs"]["last"].tolist() == [[4.0, 9.0]]
            assert out["aggs"]["last_ts"].tolist() == [
                [T0 + 240_000, T0 + 540_000]]
            sub = await port.query_downsample(
                "cpu", [], TimeRange.new(T0, T0 + 600_000),
                bucket_ms=300_000, aggs=("avg",))
            assert "min" not in sub["aggs"] and "sum" not in sub["aggs"]
            assert sub["aggs"]["avg"].tolist() == [[2.0, 7.0]]
        finally:
            await port.close()

    run(go())


def test_chunked_parity_with_row_layout():
    """The chunked path gives the row layout's grids on the same samples
    (the row layout's fused path on the CPU), and never builds an Arrow
    row table; its one aggregate call launches bucket_window_partials'
    path once (the plain version on the CPU)."""
    async def go():
        rows = _seeded_rows(12, 4000)
        row_e = await MetricEngine.open("row_db", MemoryObjectStore(),
                                        segment_ms=2 * HOUR, device="cpu")
        chunk_e = await MetricEngine.open(
            "chunked_db", MemoryObjectStore(), segment_ms=2 * HOUR,
            chunked_data=True, device="cpu")
        try:
            await row_e.write(_samples(Sample, Label, rows))
            await chunk_e.write(_samples(Sample, Label, rows))
            called = []
            orig = chunk_e.query

            async def spying_query(*a, **kw):
                called.append(a)
                return await orig(*a, **kw)

            chunk_e.query = spying_query
            rng_q = TimeRange.new(T0, T0 + 2 * HOUR)
            want = await row_e.query_downsample("cpu", [], rng_q, 600_000)
            got = await chunk_e.query_downsample("cpu", [], rng_q, 600_000)
            assert called == [], "chunked downsample built a row table"
            _compare(want, got)
        finally:
            await row_e.close()
            await chunk_e.close()

    run(go())


def test_chunked_decode_cache_hits_and_invalidates():
    async def go():
        e = await MetricEngine.open(
            "chunked_db", MemoryObjectStore(), segment_ms=2 * HOUR,
            chunked_data=True, device="cpu")
        try:
            await e.write([Sample("cpu", [Label("h", f"h{i % 5}")],
                                  T0 + i * 10_000, float(i))
                           for i in range(3000)])
            rng_q = TimeRange.new(T0, T0 + HOUR)
            first = await e.query_downsample("cpu", [], rng_q, 300_000)
            assert e._chunk_cache.hits == 0
            entry = next(iter(e._chunk_cache._entries.values()))[0]
            dev = entry["memo"]["dev"]
            second = await e.query_downsample("cpu", [], rng_q, 300_000)
            assert e._chunk_cache.hits == 1
            # the same device arrays served the repeat (nothing uploaded)
            assert entry["memo"]["dev"] is dev
            for key in first["aggs"]:
                assert first["aggs"][key].tobytes() == \
                    second["aggs"][key].tobytes(), key
            other = await e.query_downsample("cpu", [], rng_q, 600_000)
            assert e._chunk_cache.hits == 2
            assert other["num_buckets"] != second["num_buckets"]
            total1 = float(second["aggs"]["count"].sum())
            await e.write([Sample("cpu", [Label("h", "h0")],
                                  T0 + 5_000, 42.0)])
            hits = e._chunk_cache.hits
            third = await e.query_downsample("cpu", [], rng_q, 300_000)
            assert e._chunk_cache.hits == hits, "stale entry after a write"
            assert float(third["aggs"]["count"].sum()) == total1 + 1
        finally:
            await e.close()
        assert len(e._chunk_cache) == 0  # cleared on close

    run(go())


def test_chunked_storage_is_compact():
    """One row per (series, chunk window), not per point."""
    async def go():
        e = await MetricEngine.open(
            "chunked_db", MemoryObjectStore(), segment_ms=2 * HOUR,
            chunked_data=True, device="cpu")
        try:
            await e.write([Sample("cpu", [Label("h", "a")], T0 + i * 1000,
                                  float(i)) for i in range(1000)])
            rows = 0
            async for b in e.tables["data"].scan(ScanRequest(
                    range=TimeRange.new(T0, T0 + 2 * HOUR))):
                rows += b.num_rows
            assert rows == 1
        finally:
            await e.close()

    run(go())


def test_chunked_compaction_changes_no_result(pallas_reference):
    async def go():
        cfg = from_dict(StorageConfig, {"scheduler": {
            "schedule_interval": "1h", "input_sst_min_num": 2}})
        e = await MetricEngine.open(
            "cdb", MemoryObjectStore(), segment_ms=2 * HOUR, config=cfg,
            chunked_data=True, device="cpu")
        try:
            rows = _seeded_rows(13, 1500, hosts=3, span=HOUR)
            for part in (rows[:500], rows[500:1000], rows[1000:]):
                await e.write(_samples(Sample, Label, part))
            for v in (1.0, 2.0, 3.0):
                await e.write([Sample("cpu", [Label("h", "a")],
                                      T0 + 1000, v)])
            data = e.tables["data"]
            q = TimeRange.new(T0, T0 + HOUR)
            before = await e.query_downsample("cpu", [], q, 60_000)
            n_before = len(await data.manifest.all_ssts())
            task = await data.compact_scheduler.picker.pick_candidate()
            assert task is not None
            await data.compact_scheduler.executor.execute(task)
            assert len(await data.manifest.all_ssts()) < n_before
            after = await e.query_downsample("cpu", [], q, 60_000)
            assert before["tsids"] == after["tsids"]
            for k in before["aggs"]:
                assert before["aggs"][k].tobytes() == \
                    after["aggs"][k].tobytes(), k
            tbl = await e.query("cpu", [("h", "a")], q)
            assert tbl.column("value").to_pylist() == [3.0]
        finally:
            await e.close()

    run(go())


def test_chunked_write_arrow_matches_reference(pallas_reference):
    async def go():
        port, ref = await _open_pair()
        try:
            n = 600
            rng = np.random.default_rng(1)
            hosts = [f"h{int(i)}" for i in rng.integers(0, 4, n)]
            ts = (T0 + rng.integers(0, 2 * HOUR - 1, n)).tolist()
            vals = rng.random(n).round(4).tolist()
            batch = pa.record_batch({
                "host": pa.array(hosts),
                "timestamp": pa.array(ts, type=pa.int64()),
                "value": pa.array(vals, type=pa.float64()),
            })
            await port.write_arrow("cpu", ["host"], batch)
            await ref.write_arrow("cpu", ["host"], batch)
            q = (T0, T0 + 2 * HOUR)
            g = await port.query("cpu", [], TimeRange.new(*q))
            r = await ref.query("cpu", [], RefRange.new(*q))
            assert _rows(g) == _rows(r)
            assert g.num_rows == len(set(zip(hosts, ts)))
            _compare(await ref.query_downsample("cpu", [], RefRange.new(*q),
                                                600_000),
                     await port.query_downsample("cpu", [],
                                                 TimeRange.new(*q),
                                                 600_000))
            # the stored payloads are the reference's, byte for byte
            sp = [b async for b in port.tables["data"].scan(ScanRequest(
                range=TimeRange.new(*q)))]
            sr = [b async for b in ref.tables["data"].scan(
                ref_read_request(q))]
            assert sorted(pa.Table.from_batches(sp).column(
                "payload").to_pylist()) == sorted(pa.Table.from_batches(
                    sr).column("payload").to_pylist())
            bad = pa.record_batch({
                "host": pa.array(["a"]),
                "timestamp": pa.array([-5], type=pa.int64()),
                "value": pa.array([1.0], type=pa.float64()),
            })
            with pytest.raises(Error, match="non-negative"):
                await port.write_arrow("cpu", ["host"], bad)
        finally:
            await port.close()
            await ref.close()

    run(go())


def ref_read_request(q):
    from horaedb_tpu.storage.read import ScanRequest as RefScanRequest

    return RefScanRequest(range=RefRange.new(*q))


def test_chunked_window_must_divide_segment():
    async def go():
        with pytest.raises(Error):
            await MetricEngine.open(
                "c", MemoryObjectStore(), segment_ms=2 * HOUR,
                chunked_data=True, chunk_window_ms=7 * 60 * 1000,
                device="cpu")

    run(go())


def test_chunked_aggregate_is_one_partials_call(monkeypatch):
    """A cold chunked downsample aggregates the whole decoded range in
    one bucket_window_partials call (W = 1), a repeat in one more."""
    calls = []
    orig = bucket_agg.bucket_window_partials

    def spy(ts, *a, **kw):
        calls.append(tuple(ts.shape))
        return orig(ts, *a, **kw)

    monkeypatch.setattr(bucket_agg, "bucket_window_partials", spy)

    async def go():
        e = await MetricEngine.open(
            "c", MemoryObjectStore(), segment_ms=2 * HOUR,
            chunked_data=True, device="cpu")
        try:
            await e.write(_samples(Sample, Label, _seeded_rows(14, 2000)))
            q = TimeRange.new(T0, T0 + 2 * HOUR)
            await e.query_downsample("cpu", [], q, 60_000, aggs=("avg",))
            assert calls == [(1, 2048)]
            await e.query_downsample("cpu", [], q, 60_000, aggs=("avg",))
            assert len(calls) == 2
        finally:
            await e.close()

    run(go())


# ---- Append scans: streamed against bulk, and the compaction race ---------

APPEND_SCHEMA = pa.schema([pa.field("host", pa.string()),
                           pa.field("ts", pa.int64()),
                           pa.field("payload", pa.binary())])


def _append_batches(seed=7, n=1500, k=4):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(k):
        h = rng.integers(0, 40, n)
        ts = rng.integers(0, SEGMENT_MS, n)
        out.append(pa.record_batch(
            [pa.array([f"host_{int(i):02d}" for i in h]),
             pa.array(ts, type=pa.int64()),
             pa.array([b"%d;" % v for v in rng.integers(0, 100, n)],
                      type=pa.binary())], schema=APPEND_SCHEMA))
    return out


async def _append_storage(scan_cfg, store=None, **sched):
    cfg = from_dict(StorageConfig, {"scan": scan_cfg, "scheduler": {
        "schedule_interval": "1h", **sched}})
    cfg.update_mode = UpdateMode.APPEND
    return await CloudObjectStorage.open(
        "db", SEGMENT_MS, store or MemoryObjectStore(), APPEND_SCHEMA,
        num_primary_keys=2, config=cfg, device="cpu")


def _append_rows(batches) -> list:
    return sorted(r for b in batches for r in zip(
        b.column(0).to_pylist(), b.column(1).to_pylist(),
        b.column(2).to_pylist()))


STREAMED = {"stream_read_min_rows": 2000, "max_window_rows": 1024}
BULK = {"stream_read_min_rows": 0, "max_window_rows": 1 << 20}


@pytest.mark.parametrize("scan_cfg", [STREAMED, BULK,
                                      {"stream_read_min_rows": 0,
                                       "max_window_rows": 256}],
                         ids=["streamed", "bulk", "bulk_windowed"])
def test_append_scan_matches_reference(scan_cfg):
    """Streamed, bulk and windowed Append scans all equal the JAX
    package's bulk scan of the same writes (payloads concatenated in
    sequence order per key)."""
    import horaedb_tpu.storage.config as rc
    import horaedb_tpu.storage.read as rr
    import horaedb_tpu.storage.storage as rs

    async def port():
        s = await _append_storage(scan_cfg)
        try:
            for b in _append_batches():
                await s.write(WriteRequest(b, TimeRange.new(0, SEGMENT_MS)))
            return _append_rows([b async for b in s.scan(ScanRequest(
                range=TimeRange.new(0, SEGMENT_MS)))])
        finally:
            await s.close()

    async def ref():
        cfg = rc.from_dict(rc.StorageConfig, {"scan": BULK})
        cfg.update_mode = rc.UpdateMode.APPEND
        cfg.scheduler.schedule_interval = \
            ref_common.ReadableDuration.parse("1h")
        s = await rs.CloudObjectStorage.open(
            "db", SEGMENT_MS, RefStore(), APPEND_SCHEMA,
            num_primary_keys=2, config=cfg)
        try:
            for b in _append_batches():
                await s.write(rs.WriteRequest(b, RefRange.new(0, SEGMENT_MS)))
            return _append_rows([b async for b in s.scan(rr.ScanRequest(
                range=RefRange.new(0, SEGMENT_MS)))])
        finally:
            await s.close()

    got = run(port())
    assert got == run(ref()) and len(got) > 0


def test_streamed_append_survives_compaction_mid_segment(tmp_path):
    """A compaction deletes the streamed segment's inputs after its
    first window was yielded (a local store: each window re-opens its
    files): the read re-resolves the segment's SSTs and the remaining
    windows come from the compacted output — the rows equal the bulk
    scan's, none duplicated."""
    async def go():
        s = await _append_storage(STREAMED, LocalObjectStore(str(tmp_path)),
                                  input_sst_min_num=2)
        resolved = []
        orig = s.reader.resolve_segment_ssts

        async def spy(seg, rng):
            resolved.append(seg)
            return await orig(seg, rng)

        s.reader.resolve_segment_ssts = spy
        try:
            for b in _append_batches():
                await s.write(WriteRequest(b, TimeRange.new(0, SEGMENT_MS)))
            got = []
            compacted = False
            async for b in s.scan(ScanRequest(
                    range=TimeRange.new(0, SEGMENT_MS))):
                got.append(b)
                if not compacted:
                    task = await s.compact_scheduler.picker.pick_candidate()
                    await s.compact_scheduler.executor.execute(task)
                    assert len(await s.manifest.all_ssts()) == 1
                    compacted = True
            assert len(got) > 1 and resolved == [0]
            bulk = await _append_storage(BULK)
            try:
                for b in _append_batches():
                    await bulk.write(WriteRequest(
                        b, TimeRange.new(0, SEGMENT_MS)))
                want = _append_rows([b async for b in bulk.scan(
                    ScanRequest(range=TimeRange.new(0, SEGMENT_MS)))])
            finally:
                await bulk.close()
            assert _append_rows(got) == want
        finally:
            await s.close()

    run(go())


def test_streamed_append_without_resolution_fails_loudly(tmp_path):
    """With no way to re-resolve the segment, a streamed Append read
    that loses its SSTs after yielding raises a non-retryable Error
    instead of letting the replan duplicate the emitted rows."""
    async def go():
        s = await _append_storage(STREAMED, LocalObjectStore(str(tmp_path)),
                                  input_sst_min_num=2)
        try:
            for b in _append_batches():
                await s.write(WriteRequest(b, TimeRange.new(0, SEGMENT_MS)))
            s.reader.resolve_segment_ssts = None
            with pytest.raises(Error, match="duplicating"):
                async for _b in s.scan(ScanRequest(
                        range=TimeRange.new(0, SEGMENT_MS))):
                    task = await s.compact_scheduler.picker.pick_candidate()
                    if task is not None:
                        await s.compact_scheduler.executor.execute(task)
        finally:
            await s.close()

    run(go())


def test_append_tables_never_write_sidecars():
    async def go():
        store = MemoryObjectStore()
        s = await _append_storage(BULK, store=store)
        try:
            for b in _append_batches(k=2):
                await s.write(WriteRequest(b, TimeRange.new(0, SEGMENT_MS)))
            paths = [m.path for m in await store.list("db/data/")]
            assert paths and not any(p.endswith(".enc") for p in paths)
            assert s.reader.encoded_cache.stats()["entries"] == 0
        finally:
            await s.close()

    run(go())


def test_compaction_keeps_sequence_order_of_payloads():
    """Compacting an Append segment concatenates each key's payloads in
    sequence order, as the scan does."""
    async def go():
        s = await _append_storage(BULK, input_sst_min_num=2)
        try:
            for b in _append_batches(seed=3, n=200, k=3):
                await s.write(WriteRequest(b, TimeRange.new(0, SEGMENT_MS)))
            before = _append_rows([b async for b in s.scan(ScanRequest(
                range=TimeRange.new(0, SEGMENT_MS)))])
            task = await s.compact_scheduler.picker.pick_candidate()
            await s.compact_scheduler.executor.execute(task)
            after = _append_rows([b async for b in s.scan(ScanRequest(
                range=TimeRange.new(0, SEGMENT_MS)))])
            assert before == after
        finally:
            await s.close()

    run(go())


def test_chunked_numpy_grids_keep_reference_units(pallas_reference):
    """last_ts is absolute ms on the chunked path, as on the row path."""
    async def go():
        port, ref = await _open_pair()
        try:
            await port.write([Sample("cpu", [Label("h", "a")],
                                     T0 + 90_000, 5.0)])
            await ref.write([RefSample("cpu", [RefLabel("h", "a")],
                                       T0 + 90_000, 5.0)])
            g = await port.query_downsample(
                "cpu", [], TimeRange.new(T0, T0 + 600_000), 300_000)
            r = await ref.query_downsample(
                "cpu", [], RefRange.new(T0, T0 + 600_000), 300_000)
            assert g["aggs"]["last_ts"][0, 0] == T0 + 90_000
            _compare(r, g)
            assert set(_numpy(g["aggs"])) == set(_numpy(r["aggs"]))
        finally:
            await port.close()
            await ref.close()

    run(go())
