"""The parts aggregate path of the port (storage/read.py
aggregate_segments -> rounds of bucket_window_partials -> the host
combine) against the JAX package's parts path, on the same seeded
writes: tsids equal, count/min/max/last/last_ts exact, sum/avg within
rtol 1e-5.  Also the fused gate (budget and HORAEDB_FUSED_AGG), the
PartsMemo end to end (narrowed, widened, write invalidation, zero
budget), and which kernel entry each path calls."""

import asyncio
import math
import random

import numpy as np
import pyarrow as pa
import pytest
from test_torch_engine import END, QUERIES, SEG, T0, _batches, _compare

from horaedb_tpu.metric_engine import MetricEngine as RefEngine
from horaedb_tpu.objstore import MemoryObjectStore as RefStore
from horaedb_tpu.storage.config import StorageConfig as RefConfig
from horaedb_tpu.storage.config import from_dict as ref_from_dict
from horaedb_tpu.storage.types import TimeRange as RefRange
from horaedb_tpu_torch.common import ReadableDuration
from horaedb_tpu_torch.metric_engine import MetricEngine as PortEngine
from horaedb_tpu_torch.objstore import MemoryObjectStore
from horaedb_tpu_torch.ops import bucket_agg
from horaedb_tpu_torch.storage import combine as combine_mod
from horaedb_tpu_torch.storage.config import StorageConfig, from_dict
from horaedb_tpu_torch.storage.read import AggregateSpec, ScanRequest
from horaedb_tpu_torch.storage.storage import CloudObjectStorage, WriteRequest
from horaedb_tpu_torch.storage.types import TimeRange


async def _engines(ref_cfg=None, port_cfg=None):
    ref = await RefEngine.open("t", RefStore(), segment_ms=SEG,
                               config=ref_cfg)
    port = await PortEngine.open("t", MemoryObjectStore(), segment_ms=SEG,
                                 config=port_cfg, device="cpu")
    for b in _batches():
        await ref.write_arrow("cpu", ["host"], b)
        await port.write_arrow("cpu", ["host"], b)
    return ref, port


@pytest.mark.parametrize("query", range(len(QUERIES)))
def test_parts_path_matches_reference(monkeypatch, query):
    """Both sides on their parts path (HORAEDB_FUSED_AGG=0), cold and
    then repeated (the repeat served by the scan cache and the memo)."""
    monkeypatch.setenv("HORAEDB_FUSED_AGG", "0")
    filters, aggs, (a, b) = QUERIES[query]

    async def run():
        ref, port = await _engines()
        try:
            for _repeat in range(2):
                r = await ref.query_downsample(
                    "cpu", filters, RefRange.new(a, b), 60_000, aggs=aggs)
                g = await port.query_downsample(
                    "cpu", filters, TimeRange.new(a, b), 60_000, aggs=aggs)
                _compare(r, g)
                for v in g["aggs"].values():
                    # the parts path returns the combine's host arrays
                    assert isinstance(v, np.ndarray)
            return port.tables["data"].reader.parts_memo.stats()
        finally:
            await ref.close()
            await port.close()

    stats = asyncio.run(run())
    if QUERIES[query][0] != [("host", "nope")]:
        assert stats["hits"] > 0


def test_budget_alone_declines_the_fused_path(monkeypatch):
    """No override: a plan whose estimated rows x 32 B exceed the scan
    cache budget takes the parts path (as in the reference), and its
    grids match the reference's."""
    monkeypatch.delenv("HORAEDB_FUSED_AGG", raising=False)
    cfg = {"scan": {"cache_max_rows": 1000}}
    calls = {"partials": 0, "round": 0}
    partials, round_entry = (bucket_agg.bucket_window_partials,
                             bucket_agg.bucket_round_accumulate)

    def spy_partials(*a, **k):
        calls["partials"] += 1
        return partials(*a, **k)

    def spy_round(*a, **k):
        calls["round"] += 1
        return round_entry(*a, **k)

    monkeypatch.setattr(bucket_agg, "bucket_window_partials", spy_partials)
    monkeypatch.setattr(bucket_agg, "bucket_round_accumulate", spy_round)

    async def run():
        ref, port = await _engines(ref_from_dict(RefConfig, cfg),
                                   from_dict(StorageConfig, cfg))
        try:
            data = port.tables["data"]
            plan = await data.build_scan_plan(
                ScanRequest(range=TimeRange.new(T0, END)))
            assert not data.reader.fused_aggregate_ok(plan)
            r = await ref.query_downsample("cpu", [], RefRange.new(T0, END),
                                           60_000)
            g = await port.query_downsample("cpu", [],
                                            TimeRange.new(T0, END), 60_000)
            _compare(r, g)
        finally:
            await ref.close()
            await port.close()

    asyncio.run(run())
    assert calls["partials"] > 0 and calls["round"] == 0


@pytest.mark.parametrize("env,budget_rows,want", [
    ("", 4 << 20, True),       # small plan, default budget: fused
    ("", 1000, False),         # over budget: parts
    ("1", 1000, True),         # forced on, the budget included
    ("0", 4 << 20, False),     # forced off
])
def test_fused_gate(monkeypatch, env, budget_rows, want):
    if env:
        monkeypatch.setenv("HORAEDB_FUSED_AGG", env)
    else:
        monkeypatch.delenv("HORAEDB_FUSED_AGG", raising=False)
    cfg = from_dict(StorageConfig, {"scan": {"cache_max_rows": budget_rows}})

    async def run():
        port = await PortEngine.open("t", MemoryObjectStore(),
                                     segment_ms=SEG, config=cfg,
                                     device="cpu")
        try:
            await port.write_arrow("cpu", ["host"], _batches()[0])
            data = port.tables["data"]
            plan = await data.build_scan_plan(
                ScanRequest(range=TimeRange.new(T0, END)))
            return data.reader.fused_aggregate_ok(plan)
        finally:
            await port.close()

    assert asyncio.run(run()) is want


@pytest.mark.parametrize("which", [("avg",), ("min", "last")],
                         ids=lambda w: "-".join(w))
def test_parts_reader_sends_each_round_through_the_partials_entry(
        monkeypatch, which):
    """The converse of the fused reader's spy: on the parts path every
    round is ONE bucket_window_partials call over the round's stacks
    (scalar row bound: the round's largest n_valid), and the round
    entry is never called, its plain twin included."""
    monkeypatch.setenv("HORAEDB_FUSED_AGG", "0")
    calls = []
    entry = bucket_agg.bucket_window_partials

    def spy(ts, *args, **kw):
        calls.append((tuple(ts.shape), kw["n_valid"]))
        return entry(ts, *args, **kw)

    def boom(*_a, **_k):
        raise AssertionError("the parts reader called the round entry")

    monkeypatch.setattr(bucket_agg, "bucket_window_partials", spy)
    monkeypatch.setattr(bucket_agg, "bucket_round_accumulate", boom)
    monkeypatch.setattr(bucket_agg, "bucket_round_accumulate_plain", boom)
    batch_w = 3
    cfg = from_dict(StorageConfig, {"scan": {
        "max_window_rows": 2000, "agg_batch_windows": batch_w}})

    async def run():
        e = await PortEngine.open("t", MemoryObjectStore(), segment_ms=SEG,
                                  config=cfg, device="cpu")
        try:
            for b in _batches():
                await e.write_arrow("cpu", ["host"], b)
            out = await e.query_downsample(
                "cpu", [], TimeRange.new(T0, END), 60_000, aggs=which)
            windows = [w for ws in e.tables["data"].reader.scan_cache.values()
                       for w in ws]
            return out, windows
        finally:
            await e.close()

    out, windows = asyncio.run(run())
    assert len(windows) > batch_w  # several rounds
    assert len(calls) == math.ceil(len(windows) / batch_w)
    assert max(nv for _s, nv in calls) == max(w.n_valid for w in windows)
    assert float(out["aggs"]["count"].sum()) == float(
        sum(w.n_valid for w in windows))


# ---------------------------------------------------------------------------
# the delta-summation memo end to end (mirrors tests/test_combine.py
# TestPartsMemo on the port's storage)
# ---------------------------------------------------------------------------

MEMO_SEG = 3_600_000
SCHEMA = pa.schema([("k", pa.string()), ("ts", pa.int64()),
                    ("v", pa.float64())])


def _wreq(rows):
    k, t, v = zip(*rows)
    batch = pa.record_batch(
        [pa.array(list(k)), pa.array(list(t), type=pa.int64()),
         pa.array(list(v), type=pa.float64())], schema=SCHEMA)
    return WriteRequest(batch, TimeRange.new(min(t), max(t) + 1))


async def _open(**combine):
    cfg = from_dict(StorageConfig, {
        "scheduler": {"schedule_interval": "1h"},
        "scan": {"combine": combine} if combine else {}})
    cfg.manifest.merge_interval = ReadableDuration.parse("1h")
    cfg.scrub.interval = ReadableDuration.parse("1h")
    return await CloudObjectStorage.open("db", MEMO_SEG, MemoryObjectStore(),
                                         SCHEMA, 2, cfg, device="cpu")


def _spec(lo, hi, which=("avg", "max", "last")):
    return AggregateSpec(group_col="k", ts_col="ts", value_col="v",
                         range_start=lo, bucket_ms=60_000,
                         num_buckets=max(1, -(-(hi - lo) // 60_000)),
                         which=which)


async def _write_segments(s, rng, segments=4, rows_per=250, keys=6):
    for seg in range(segments):
        await s.write(_wreq([(f"k{rng.randint(0, keys - 1)}",
                              seg * MEMO_SEG + rng.randint(0, MEMO_SEG - 1000),
                              float(i)) for i in range(rows_per)]))


def _clear(s, memo=True):
    s.reader.scan_cache.clear()
    if memo:
        s.reader.parts_memo.clear()


async def _fresh(s, req, spec, mode="dense"):
    """The control: every cache and the memo cold, in `mode`."""
    saved = s.config.scan.combine.mode
    s.config.scan.combine.mode = mode
    _clear(s)
    try:
        return await s.scan_aggregate(req, spec)
    finally:
        s.config.scan.combine.mode = saved


def _same_bytes(a, b, ctx):
    va, ga = a
    vb, gb = b
    assert np.array_equal(va, vb), ctx
    assert sorted(ga) == sorted(gb), ctx
    for k in ga:
        assert np.asarray(ga[k]).tobytes() == np.asarray(gb[k]).tobytes(), \
            f"{ctx}: {k}"


class TestPartsMemo:
    def test_narrowed_range_served_from_memo(self, monkeypatch):
        monkeypatch.setenv("HORAEDB_FUSED_AGG", "0")

        async def go():
            s = await _open()
            try:
                await _write_segments(s, random.Random(1337))
                full = (0, 4 * MEMO_SEG)
                await s.scan_aggregate(
                    ScanRequest(range=TimeRange.new(*full)), _spec(*full))
                assert s.reader.parts_memo.stats()["entries"] == 4
                lo, hi = MEMO_SEG, 3 * MEMO_SEG
                _clear(s, memo=False)
                h0 = s.reader.parts_memo.stats()["hits"]
                req = ScanRequest(range=TimeRange.new(lo, hi))
                narrow = await s.scan_aggregate(req, _spec(lo, hi))
                assert s.reader.parts_memo.stats()["hits"] - h0 == 2
                for mode in ("sparse", "dense"):
                    _same_bytes(narrow, await _fresh(s, req, _spec(lo, hi),
                                                     mode), mode)
            finally:
                await s.close()

        asyncio.run(go())

    def test_widened_range_recomputes(self, monkeypatch):
        monkeypatch.setenv("HORAEDB_FUSED_AGG", "0")

        async def go():
            s = await _open()
            try:
                await _write_segments(s, random.Random(1338))
                # the recorded range ends MID-segment, so a wider query
                # reaches buckets the stored parts were clipped away from
                lo, hi = MEMO_SEG, MEMO_SEG + MEMO_SEG // 2
                await s.scan_aggregate(
                    ScanRequest(range=TimeRange.new(lo, hi)), _spec(lo, hi))
                _clear(s, memo=False)
                unc0 = combine_mod._MEMO_UNCOVERED.value
                h0 = s.reader.parts_memo.stats()["hits"]
                wide = (0, 4 * MEMO_SEG)
                req = ScanRequest(range=TimeRange.new(*wide))
                got = await s.scan_aggregate(req, _spec(*wide))
                assert combine_mod._MEMO_UNCOVERED.value > unc0
                # a found-but-uncovered entry did not serve: no hit
                assert s.reader.parts_memo.stats()["hits"] == h0
                _same_bytes(got, await _fresh(s, req, _spec(*wide)), "wide")
            finally:
                await s.close()

        asyncio.run(go())

    def test_write_invalidates_structurally(self, monkeypatch):
        monkeypatch.setenv("HORAEDB_FUSED_AGG", "0")

        async def go():
            s = await _open()
            try:
                await _write_segments(s, random.Random(1339), segments=2)
                span = (0, 2 * MEMO_SEG)
                req = ScanRequest(range=TimeRange.new(*span))
                await s.scan_aggregate(req, _spec(*span))
                await s.write(_wreq([("k0", 5000, 1e6)]))
                _clear(s, memo=False)
                after = await s.scan_aggregate(req, _spec(*span))
                _same_bytes(after, await _fresh(s, req, _spec(*span)),
                            "post-write")
                # the new write's max is visible: the memo did not serve
                # the stale partials
                assert np.nanmax(after[1]["max"]) == 1e6
            finally:
                await s.close()

        asyncio.run(go())

    def test_memo_disabled_by_zero_budget(self, monkeypatch):
        monkeypatch.setenv("HORAEDB_FUSED_AGG", "0")

        async def go():
            s = await _open(memo_max_bytes=0)
            try:
                await _write_segments(s, random.Random(1337), segments=2)
                span = (0, 2 * MEMO_SEG)
                await s.scan_aggregate(
                    ScanRequest(range=TimeRange.new(*span)), _spec(*span))
                assert s.reader.parts_memo.stats()["entries"] == 0
                assert s.reader.parts_memo.stats()["misses"] == 0
            finally:
                await s.close()

        asyncio.run(go())


def test_bad_combine_mode_rejected_at_open():
    from horaedb_tpu_torch.common.error import Error

    async def go():
        with pytest.raises(Error, match="scan.combine"):
            await _open(mode="bogus")

    asyncio.run(go())


@pytest.mark.parametrize("flag", ["1", "0"], ids=["fused", "parts"])
def test_reader_execute_aggregate_takes_the_gated_path(monkeypatch, flag):
    """ParquetReader.execute_aggregate serves a plan by the path the gate
    picks: fused grids are tensors, parts grids host arrays, and both
    equal the storage facade's answer."""
    monkeypatch.setenv("HORAEDB_FUSED_AGG", flag)

    async def go():
        s = await _open()
        try:
            await _write_segments(s, random.Random(1340), segments=2)
            span = (0, 2 * MEMO_SEG)
            req = ScanRequest(range=TimeRange.new(*span))
            spec = _spec(*span)
            values, grids = await s.reader.execute_aggregate(
                await s.build_scan_plan(req), spec)
            assert all(isinstance(v, np.ndarray) == (flag == "0")
                       for k, v in grids.items() if k != "last_ts")
            _clear(s)
            want_values, want = await s.scan_aggregate(req, spec)
            assert np.array_equal(values, want_values)
            for k in want:
                got = grids[k] if isinstance(grids[k], np.ndarray) \
                    else grids[k].numpy()
                w = want[k] if isinstance(want[k], np.ndarray) \
                    else want[k].numpy()
                np.testing.assert_array_equal(got, w, err_msg=k)
        finally:
            await s.close()

    asyncio.run(go())
