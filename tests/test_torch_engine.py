"""The whole slice: the same seeded Arrow batches written through the JAX
package's MetricEngine and through the port's (device="cpu"), then
query_downsample compared — tsids equal, count/min/max/last/last_ts
exact, sum/avg within rtol 1e-5.  Two overlapping writes make the
last-value dedup matter; the fused path of the reference is forced on
(HORAEDB_FUSED_AGG=1) so both sides accumulate windows the same way."""

import asyncio

import numpy as np
import pyarrow as pa
import pytest

from horaedb_tpu.metric_engine import MetricEngine as RefEngine
from horaedb_tpu.objstore import MemoryObjectStore as RefStore
from horaedb_tpu.storage.types import TimeRange as RefRange
from horaedb_tpu_torch.metric_engine import MetricEngine as PortEngine
from horaedb_tpu_torch.objstore import MemoryObjectStore as PortStore
from horaedb_tpu_torch.ops.downsample import ALL_AGGS
from horaedb_tpu_torch.storage.types import TimeRange as PortRange

SEG = 2 * 3600 * 1000
T0 = (1_700_000_000_000 // SEG) * SEG
HOSTS = 16
TICKS = 3 * 720  # three 2 h segments of 10 s ticks


def _batches():
    rng = np.random.default_rng(0)
    ts = T0 + np.repeat(np.arange(TICKS, dtype=np.int64) * 10_000, HOSTS)
    host = np.tile(np.arange(HOSTS, dtype=np.int32), TICKS)
    vals = rng.random(len(ts)) * 100
    names = pa.array([f"host_{i:02d}" for i in range(HOSTS)])
    out = []
    # the second write overlaps the first's tail: newer values must win
    for lo, hi, bump in ((0, len(ts) // 2 + 777, 0.0),
                         (len(ts) // 3, len(ts), 1000.0)):
        out.append(pa.record_batch({
            "host": pa.DictionaryArray.from_arrays(pa.array(host[lo:hi]),
                                                   names),
            "timestamp": pa.array(ts[lo:hi]),
            "value": pa.array(vals[lo:hi] + bump)}))
    return out


END = T0 + TICKS * 10_000
QUERIES = [
    ([], ALL_AGGS, (T0, END)),
    ([], ("avg",), (T0, END)),
    ([("host", "host_03")], ALL_AGGS, (T0, END)),
    ([("host", "host_03")], ("avg",), (T0, END)),
    # unaligned: the time leaf applies, boundary buckets are partial
    ([], ALL_AGGS, (T0 + 123_456, END - 98_765)),
    ([("host", "host_11")], ("avg",), (T0 + 123_456, END - 98_765)),
    # no such series
    ([("host", "nope")], ("avg",), (T0, END)),
]


def _numpy(grids: dict) -> dict:
    return {k: (v if isinstance(v, np.ndarray) else np.asarray(v)
                if not hasattr(v, "numpy") else v.cpu().numpy())
            for k, v in grids.items()}


def _compare(ref: dict, got: dict):
    assert got["tsids"] == ref["tsids"]
    assert got["num_buckets"] == ref["num_buckets"]
    r, g = _numpy(ref["aggs"]), _numpy(got["aggs"])
    assert sorted(g) == sorted(r)
    for k in r:
        if k in ("sum", "avg"):
            np.testing.assert_allclose(g[k], r[k], rtol=1e-5, err_msg=k)
        else:
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)


def test_engine_downsample_matches_reference(monkeypatch):
    monkeypatch.setenv("HORAEDB_FUSED_AGG", "1")

    async def run():
        ref = await RefEngine.open("t", RefStore(), segment_ms=SEG)
        port = await PortEngine.open("t", PortStore(), segment_ms=SEG,
                                     device="cpu")
        try:
            for b in _batches():
                await ref.write_arrow("cpu", ["host"], b)
                await port.write_arrow("cpu", ["host"], b)
            for filters, aggs, (a, b) in QUERIES:
                # cold, then repeated over the cached windows
                for _repeat in range(2):
                    r = await ref.query_downsample(
                        "cpu", filters, RefRange.new(a, b), 60_000,
                        aggs=aggs)
                    g = await port.query_downsample(
                        "cpu", filters, PortRange.new(a, b), 60_000,
                        aggs=aggs)
                    _compare(r, g)
            # the port's repeat queries were served from its window cache
            assert port.tables["data"].reader.scan_cache.hits > 0
            # raw rows agree too (the merge's last-value dedup)
            r_rows = await ref.query("cpu", [("host", "host_05")],
                                     RefRange.new(T0, END))
            g_rows = await port.query("cpu", [("host", "host_05")],
                                      PortRange.new(T0, END))
            assert g_rows.equals(r_rows)
            assert g_rows.num_rows == TICKS
        finally:
            await ref.close()
            await port.close()

    asyncio.run(run())


def test_engine_open_on_cpu_runs_the_plain_kernel_version():
    """With device="cpu" every grid is a CPU tensor and no kernel launch
    is counted: the plain version serves CPU tensors only."""
    from horaedb_tpu_torch.ops import bucket_agg

    async def run():
        port = await PortEngine.open("t", PortStore(), segment_ms=SEG,
                                     device="cpu")
        try:
            await port.write_arrow("cpu", ["host"], _batches()[0])
            before = bucket_agg.LAUNCHES["bucket_window_partials"]
            out = await port.query_downsample(
                "cpu", [], PortRange.new(T0, END), 60_000, aggs=("avg",))
            assert bucket_agg.LAUNCHES["bucket_window_partials"] == before
            assert out["aggs"]["avg"].device.type == "cpu"
            assert out["aggs"]["count"].shape == (HOSTS, out["num_buckets"])
        finally:
            await port.close()

    asyncio.run(run())


@pytest.mark.parametrize("rows_per_window", [1000, 1 << 20])
def test_engine_windowed_segments_match_reference(monkeypatch,
                                                  rows_per_window):
    """Segments split into several PK-range merge windows (small
    max_window_rows) and rounds of few windows give the same grids."""
    from horaedb_tpu.storage.config import StorageConfig as RC
    from horaedb_tpu.storage.config import from_dict as rfd
    from horaedb_tpu_torch.storage.config import StorageConfig as PC
    from horaedb_tpu_torch.storage.config import from_dict as pfd

    monkeypatch.setenv("HORAEDB_FUSED_AGG", "1")
    scan = {"max_window_rows": rows_per_window, "agg_batch_windows": 3}

    async def run():
        ref = await RefEngine.open("t", RefStore(), segment_ms=SEG,
                                   config=rfd(RC, {"scan": scan}))
        port = await PortEngine.open("t", PortStore(), segment_ms=SEG,
                                     config=pfd(PC, {"scan": scan}),
                                     device="cpu")
        try:
            for b in _batches():
                await ref.write_arrow("cpu", ["host"], b)
                await port.write_arrow("cpu", ["host"], b)
            r = await ref.query_downsample("cpu", [], RefRange.new(T0, END),
                                           300_000, aggs=ALL_AGGS)
            g = await port.query_downsample("cpu", [], PortRange.new(T0, END),
                                            300_000, aggs=ALL_AGGS)
            _compare(r, g)
        finally:
            await ref.close()
            await port.close()

    asyncio.run(run())
