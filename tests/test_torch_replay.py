"""The fused replay cache, the device stack cache and per-window device
columns of the port (storage/read.py) against the JAX package's
(tests/test_parallel.py TestFusedReplay and TestVariedRangeStacking):
every scenario writes the same seeded batches through both packages'
MetricEngine (the port with device="cpu") and runs the same queries.

- The replay and stack counters move as the reference's do.
- The port's grids match the reference's: count/min/max/last/last_ts
  exact, sum/avg within rtol 1e-5.
- A repeat or a replay is byte-equal to the port's own first query, and
  rounds stacked from per-window device columns are byte-equal to the
  numpy stack.

Then the stack LRU alone (byte accounting, eviction order, a put larger
than the budget, a dead weakref), drop_hbm_state() and the window memos
under _memo_store's clear-all rule."""

import asyncio
import gc

import numpy as np
import pyarrow as pa
import pytest
from test_torch_engine import _compare

from horaedb_tpu.metric_engine import MetricEngine as RefEngine
from horaedb_tpu.objstore import MemoryObjectStore as RefStore
from horaedb_tpu.storage.combine import PartsMemo as RefPartsMemo
from horaedb_tpu.storage.config import StorageConfig as RefConfig
from horaedb_tpu.storage.config import from_dict as ref_from_dict
from horaedb_tpu.storage.encoded_cache import \
    EncodedSegmentCache as RefEncodedSegmentCache
from horaedb_tpu.storage.types import TimeRange as RefRange
from horaedb_tpu_torch.metric_engine import MetricEngine as PortEngine
from horaedb_tpu_torch.objstore import MemoryObjectStore as PortStore
from horaedb_tpu_torch.ops import encode
from horaedb_tpu_torch.storage import read
from horaedb_tpu_torch.storage.config import StorageConfig as PortConfig
from horaedb_tpu_torch.storage.config import from_dict as port_from_dict
from horaedb_tpu_torch.storage.scan_cache import MEMO_SLOTS
from horaedb_tpu_torch.storage.types import TimeRange as PortRange
from horaedb_tpu_torch.utils import registry

SEG = 7_200_000
T0 = (1_700_000_000_000 // SEG) * SEG
HOUR = 3_600_000


def _mkbatch(seed, n=4000, hosts=11, span=6 * HOUR):
    rng = np.random.default_rng(seed)
    names = np.array([f"h{i:02d}" for i in range(hosts)], dtype=object)
    sel = rng.integers(0, hosts, n)
    return pa.record_batch({
        "host": pa.array(names[sel]),
        "timestamp": pa.array(T0 + rng.integers(0, span - 1, n),
                              type=pa.int64()),
        "value": pa.array(rng.random(n) * 100, type=pa.float64()),
    })


class _Pair:
    """The reference engine and the port's, written and queried alike."""

    def __init__(self, ref, port):
        self.ref, self.port = ref, port

    @classmethod
    async def open(cls, scan: dict):
        ref = await RefEngine.open("t", RefStore(), segment_ms=SEG,
                                   config=ref_from_dict(RefConfig,
                                                        {"scan": scan}))
        port = await PortEngine.open("t", PortStore(), segment_ms=SEG,
                                     config=port_from_dict(PortConfig,
                                                           {"scan": scan}),
                                     device="cpu")
        return cls(ref, port)

    @property
    def readers(self):
        return (self.ref.tables["data"].reader,
                self.port.tables["data"].reader)

    async def write(self, batch):
        await self.ref.write_arrow("cpu", ["host"], batch)
        await self.port.write_arrow("cpu", ["host"], batch)

    async def query(self, start, end, bucket_ms=600_000, **kw):
        """Both engines' result; the port's checked against the
        reference's."""
        r = await self.ref.query_downsample(
            "cpu", [], RefRange.new(start, end), bucket_ms, **kw)
        g = await self.port.query_downsample(
            "cpu", [], PortRange.new(start, end), bucket_ms, **kw)
        _compare(r, g)
        return r, g

    async def close(self):
        await self.ref.close()
        await self.port.close()


def _host(v):
    return v if isinstance(v, np.ndarray) else v.cpu().numpy()


def _same_bytes(a: dict, b: dict, what: str = "") -> None:
    assert a["tsids"] == b["tsids"], what
    assert sorted(a["aggs"]) == sorted(b["aggs"]), what
    for k in a["aggs"]:
        x, y = _host(a["aggs"][k]), _host(b["aggs"][k])
        assert x.dtype == y.dtype and x.shape == y.shape, f"{what} {k}"
        assert x.tobytes() == y.tobytes(), f"{what}: grid {k} differs"


def _hits(readers) -> list:
    return [r._replay_hits for r in readers]


# ---- TestFusedReplay ------------------------------------------------------


def test_replay_hit_matches_full_path(monkeypatch):
    """A repeat fused query takes the replay in both packages, and the
    port's replays are the first query's bytes with nothing uploaded."""
    monkeypatch.setenv("HORAEDB_FUSED_AGG", "1")

    async def run():
        p = await _Pair.open({"max_window_rows": 512})
        try:
            await p.write(_mkbatch(3))
            snap = registry.snapshot()
            first = await p.query(T0, T0 + 6 * HOUR)
            assert _hits(p.readers) == [0, 0]
            outs, uploads = [], []
            for n in (1, 2):
                h2d = encode.h2d_bytes()
                outs.append(await p.query(T0, T0 + 6 * HOUR))
                uploads.append(encode.h2d_bytes() - h2d)
                assert _hits(p.readers) == [n, n], \
                    "repeat fused query must take the replay path"
            port = p.readers[1]
            now = registry.snapshot()
            delta = {k: now[k] - snap.get(k, 0) for k in now}
            return first, outs, uploads, port, delta
        finally:
            await p.close()

    first, outs, uploads, port, delta = asyncio.run(run())
    assert uploads == [0, 0]
    assert port._replay_misses == 1
    assert delta["scan_replay_hits_total"] == 2
    assert delta["scan_replay_misses_total"] == 1
    # replayed rows have their own counter: every row of the range, twice
    rows = int(_host(first[1]["aggs"]["count"]).sum())
    assert rows > 3900
    assert delta["scan_replay_rows_total"] == 2 * rows
    for _r, g in outs:
        _same_bytes(first[1], g, "replay")


def test_replay_with_multiple_rounds_per_segment(monkeypatch):
    """One segment in six rounds of equal (batch_w, cap): the chunk
    offset in the stack key keeps them apart, so the repeat replays."""
    monkeypatch.setenv("HORAEDB_FUSED_AGG", "1")

    async def run():
        p = await _Pair.open({"max_window_rows": 512,
                              "agg_batch_windows": 2})
        try:
            await p.write(_mkbatch(8, n=6000, span=2 * HOUR))
            first = await p.query(T0, T0 + 2 * HOUR)
            second = await p.query(T0, T0 + 2 * HOUR)
            assert _hits(p.readers) == [1, 1], \
                "multi-round segments must still replay"
            entry = next(iter(p.readers[1]._replay_cache.values()))
            return first, second, len(entry["rounds"])
        finally:
            await p.close()

    first, second, rounds = asyncio.run(run())
    assert rounds >= 6
    _same_bytes(first[1], second[1], "replay")


def test_replay_invalidated_by_write(monkeypatch):
    """A write changes the segment's SST set: the replay key no longer
    matches, and the fresh rows appear in the result."""
    monkeypatch.setenv("HORAEDB_FUSED_AGG", "1")

    async def run():
        p = await _Pair.open({"max_window_rows": 512})
        try:
            await p.write(_mkbatch(4, span=2 * HOUR))
            await p.query(T0, T0 + 2 * HOUR, aggs=("sum",))
            before = await p.query(T0, T0 + 2 * HOUR, aggs=("sum",))
            hits = _hits(p.readers)
            assert min(hits) >= 1
            await p.write(_mkbatch(5, span=2 * HOUR))
            after = await p.query(T0, T0 + 2 * HOUR, aggs=("sum",))
            assert _hits(p.readers) == hits, \
                "stale replay entry must not serve post-write queries"
            return before, after
        finally:
            await p.close()

    before, after = asyncio.run(run())
    for r, g in (before, after):
        assert float(_host(g["aggs"]["count"]).sum()) == \
            float(np.nansum(np.asarray(r["aggs"]["count"])))
    assert float(_host(after[1]["aggs"]["count"]).sum()) > \
        float(_host(before[1]["aggs"]["count"]).sum())


def test_replay_falls_back_on_evictions(monkeypatch):
    """Clearing the stack cache, and clearing the scan cache, each break
    the recorded identity: the query re-runs the full path, records
    again, and still gives the same bytes."""
    monkeypatch.setenv("HORAEDB_FUSED_AGG", "1")

    async def run():
        p = await _Pair.open({"max_window_rows": 512})
        try:
            await p.write(_mkbatch(6, span=4 * HOUR))
            base = await p.query(T0, T0 + 4 * HOUR)
            await p.query(T0, T0 + 4 * HOUR)
            hits = _hits(p.readers)
            for r in p.readers:
                with r._stack_cache_lock:
                    r._stack_cache.clear()
                    r._stack_cache_bytes = 0
            after_stack = await p.query(T0, T0 + 4 * HOUR)
            assert _hits(p.readers) == hits
            await p.query(T0, T0 + 4 * HOUR)  # re-recorded: replays
            assert _hits(p.readers) == [h + 1 for h in hits]
            for r in p.readers:
                r.scan_cache.clear()
            after_clear = await p.query(T0, T0 + 4 * HOUR)
            assert _hits(p.readers) == [h + 1 for h in hits]
            return base, after_stack, after_clear, p.readers[1]
        finally:
            await p.close()

    base, after_stack, after_clear, port = asyncio.run(run())
    assert port._replay_misses == 3
    for other in (after_stack, after_clear):
        _same_bytes(base[1], other[1], "full path after an eviction")


# ---- TestVariedRangeStacking ----------------------------------------------

_RANGES = ((0, 8 * HOUR), (0, 4 * HOUR), (2 * HOUR, 4 * HOUR),
           (4 * HOUR, 4 * HOUR))


def _force_devcol(monkeypatch, on: bool) -> None:
    """Pick the fused rounds' column route on both packages' CPU
    readers, which stack in numpy by default: device columns on or off.
    The JAX package reads HORAEDB_DEVCOL_STACK; the port's route follows
    its reader's device, so its seam is patched."""
    monkeypatch.setenv("HORAEDB_DEVCOL_STACK", "1" if on else "0")
    monkeypatch.setattr(read.ParquetReader, "_devcol_stack_ok",
                        lambda self: on)


def _varied(monkeypatch, devcol: str) -> list:
    """Four segments, then the full range and three bucket-aligned half
    ranges (the first, an interior one, the last); the port's results
    and its host-to-device bytes per query."""
    monkeypatch.setenv("HORAEDB_FUSED_AGG", "1")
    _force_devcol(monkeypatch, devcol == "1")

    async def run():
        p = await _Pair.open({"max_window_rows": 512})
        try:
            await p.write(_mkbatch(11, n=8000, hosts=13, span=8 * HOUR))
            outs = []
            for s, d in _RANGES:
                h2d = encode.h2d_bytes()
                _r, g = await p.query(T0 + s, T0 + s + d)
                outs.append((g, encode.h2d_bytes() - h2d))
            return outs
        finally:
            await p.close()

    return asyncio.run(run())


@pytest.mark.parametrize("devcol", ["0", "1"])
def test_varied_ranges_match_reference(monkeypatch, devcol):
    """Both stacking routes against the reference on every range.  With
    device columns a half range that follows the full one uploads only
    the small per-round arrays, far less than one window's columns."""
    outs = _varied(monkeypatch, devcol)
    if devcol == "1":
        for _g, h2d in outs[1:]:
            assert 0 < h2d < 512 * 12


def test_devcol_stacking_matches_numpy_path(monkeypatch):
    a = _varied(monkeypatch, "0")
    b = _varied(monkeypatch, "1")
    for i, ((x, _), (y, _)) in enumerate(zip(a, b)):
        _same_bytes(x, y, f"range {i}")


def test_varied_ranges_reuse_window_memos(monkeypatch):
    """After a full-range query, another aligned range reuses the same
    window-groups and device-column memo objects in both packages."""
    monkeypatch.setenv("HORAEDB_FUSED_AGG", "1")
    _force_devcol(monkeypatch, True)

    def snapshot(reader):
        return {(id(w), mk): mv for ws in reader.scan_cache.values()
                for w in ws for mk, mv in w.memo.items()}

    async def run():
        p = await _Pair.open({"max_window_rows": 4096})
        try:
            rng = np.random.default_rng(12)
            n, hosts = 5000, 7
            names = np.array([f"h{i}" for i in range(hosts)], dtype=object)
            await p.write(pa.record_batch({
                "host": pa.array(names[rng.integers(0, hosts, n)]),
                "timestamp": pa.array(T0 + rng.integers(0, 4 * HOUR - 1, n),
                                      type=pa.int64()),
                "value": pa.array(rng.random(n), type=pa.float64())}))
            await p.query(T0, T0 + 4 * HOUR)
            before = [snapshot(r) for r in p.readers]
            await p.query(T0, T0 + 2 * HOUR)
            return before, [snapshot(r) for r in p.readers]
        finally:
            await p.close()

    before, after = asyncio.run(run())
    for b, a in zip(before, after):
        kinds = {mk[0] for _w, mk in b}
        assert {"dev_cols", "window_groups"} <= kinds
        for k, mv in a.items():
            if k in b:
                assert mv is b[k], k[1]


# ---- the stack LRU alone --------------------------------------------------


class _Window:
    """Stands in for a cached window: weakref-able, nothing else."""


async def _port_reader(scan: dict):
    e = await PortEngine.open("t", PortStore(), segment_ms=SEG,
                              config=port_from_dict(PortConfig,
                                                    {"scan": scan}),
                              device="cpu")
    return e, e.tables["data"].reader


def test_stack_cache_accounts_bytes_and_evicts_least_recent():
    async def run():
        e, r = await _port_reader({"cache_max_bytes": 1000})
        try:
            ws = [_Window() for _ in range(3)]
            arr = lambda n: (np.zeros(n, np.uint8),)  # noqa: E731
            assert r._stack_cache_max == 1000
            r._stack_cache_put("a", (ws[0],), arr(400))
            r._stack_cache_put("b", (ws[1],), arr(300))
            assert r._stack_cache_bytes == 700
            # a re-put replaces its own bytes
            r._stack_cache_put("b", (ws[1],), arr(350))
            assert r._stack_cache_bytes == 750
            assert r._stack_cache_get("a", (ws[0],)) is not None  # a: newest
            r._stack_cache_put("c", (ws[2],), arr(400))
            # b, now the least recently used, went to make room
            assert list(r._stack_cache) == ["a", "c"]
            assert r._stack_cache_bytes == 800
            assert r._stack_cache_get("b", (ws[1],)) is None
            # larger than the whole budget: not stored, nothing evicted
            r._stack_cache_put("d", (ws[0],), arr(1001))
            assert list(r._stack_cache) == ["a", "c"]
            assert r._stack_cache_bytes == 800
            return r.cache_stats()["stack_cache"]
        finally:
            await e.close()

    stats = asyncio.run(run())
    assert stats == {"entries": 2, "bytes": 800, "max_bytes": 1000,
                     "hits": 1, "misses": 1}


def test_stack_cache_drops_entries_of_dead_or_other_windows():
    async def run():
        e, r = await _port_reader({"cache_max_bytes": 1000})
        try:
            w0, w1 = _Window(), _Window()
            r._stack_cache_put("k", (w0, w1), (np.zeros(100, np.uint8),))
            # the entry pins no window: once w1 is gone, the entry is stale
            other = _Window()
            assert r._stack_cache_get("k", (w0, other)) is None
            assert "k" not in r._stack_cache and r._stack_cache_bytes == 0
            r._stack_cache_put("k", (w0, w1), (np.zeros(100, np.uint8),))
            del w1
            gc.collect()
            assert r._stack_cache_get("k", (w0, other)) is None
            assert not r._stack_cache and r._stack_cache_bytes == 0
            return r._stack_cache_misses
        finally:
            await e.close()

    assert asyncio.run(run()) == 2


def test_drop_hbm_state_empties_every_device_tier(monkeypatch):
    """drop_hbm_state() empties the stack cache, the replay cache and
    every window's memos, and keeps the host windows: the next query
    misses the replay, uploads its columns again and gives the same
    bytes.  close() drops the same state."""
    monkeypatch.setenv("HORAEDB_FUSED_AGG", "1")
    _force_devcol(monkeypatch, True)

    async def run():
        e = await PortEngine.open("t", PortStore(), segment_ms=SEG,
                                  config=port_from_dict(PortConfig, {
                                      "scan": {"max_window_rows": 512}}),
                                  device="cpu")
        r = e.tables["data"].reader
        try:
            await e.write_arrow("cpu", ["host"], _mkbatch(9, span=4 * HOUR))
            rng_q = PortRange.new(T0, T0 + 4 * HOUR)
            first = await e.query_downsample("cpu", [], rng_q, 600_000)
            windows = [w for ws in r.scan_cache.values() for w in ws]
            assert r._stack_cache and r._replay_cache
            assert all(w.memo and w.memo_bytes for w in windows)
            r.drop_hbm_state()
            assert not r._stack_cache and r._stack_cache_bytes == 0
            assert not r._replay_cache
            assert all(not w.memo and w.memo_bytes == 0 for w in windows)
            kept = [w for ws in r.scan_cache.values() for w in ws]
            assert len(kept) == len(windows)
            assert all(a is b for a, b in zip(kept, windows))
            h2d = encode.h2d_bytes()
            again = await e.query_downsample("cpu", [], rng_q, 600_000)
            uploaded = encode.h2d_bytes() - h2d
            assert r._replay_hits == 0 and r._replay_misses == 2
            assert uploaded >= sum(12 * w.capacity for w in windows)
            assert r._stack_cache and r._replay_cache
        finally:
            await e.close()
        assert not r._stack_cache and not r._replay_cache
        return first, again

    first, again = asyncio.run(run())
    _same_bytes(first, again, "after drop_hbm_state")


def test_window_memos_fit_the_memo_store_together(monkeypatch):
    """The device columns (12 B a slot) and the window-groups map (4 B a
    slot) are both memoized on every window: 16 B a slot, under the
    MEMO_SLOTS x (4 B a slot + 128) that _memo_store allows, so its
    clear-all rule never drops one for the other."""
    monkeypatch.setenv("HORAEDB_FUSED_AGG", "1")
    _force_devcol(monkeypatch, True)

    async def run():
        e, r = await _port_reader({"max_window_rows": 512})
        try:
            await e.write_arrow("cpu", ["host"], _mkbatch(10, span=4 * HOUR))
            for start in (T0, T0 + 2 * HOUR):
                await e.query_downsample(
                    "cpu", [], PortRange.new(start, T0 + 4 * HOUR), 600_000)
            return [(w.capacity, w.memo_bytes, sorted(k[0] for k in w.memo))
                    for ws in r.scan_cache.values() for w in ws]
        finally:
            await e.close()

    seen = asyncio.run(run())
    assert len(seen) > 4
    for cap, nbytes, kinds in seen:
        assert kinds == ["dev_cols", "window_groups"]
        assert nbytes == 16 * cap <= MEMO_SLOTS * (4 * cap + 128)


def test_devcol_switch_defaults_to_the_reader_device(monkeypatch):
    async def run():
        e, r = await _port_reader({})
        try:
            default = r._devcol_stack_ok()
            monkeypatch.setattr(read.ParquetReader, "on_cuda",
                                property(lambda self: True))
            return default, r._devcol_stack_ok()
        finally:
            await e.close()

    assert asyncio.run(run()) == (False, True)


def test_cache_stats_has_the_reference_sections():
    async def run():
        e, r = await _port_reader({})
        try:
            return r.cache_stats()
        finally:
            await e.close()

    stats = asyncio.run(run())
    assert set(stats) == {"scan_cache", "encoded_cache", "parts_memo",
                          "pipeline", "decode", "stack_cache", "mesh"}
    assert set(stats["parts_memo"]) == set(RefPartsMemo(1).stats())
    assert set(stats["decode"]) == {"mode", "resolved", "max_upload_bytes"}
    # the reference's mesh section, plus the port's device list
    assert set(stats["mesh"]) - {"segment_devices", "devices"} == {
        "enabled", "shape", "rounds", "parts", "part_cells", "score_cells",
        "topk_served", "fallbacks", "stalls"}
    assert set(stats["encoded_cache"]) == set(
        RefEncodedSegmentCache(1).stats())
    assert set(stats["pipeline"]) == {"enabled", "depth", "inflight_bytes",
                                      "high_water_bytes"}
    assert set(stats["stack_cache"]) == {"entries", "bytes", "max_bytes",
                                         "hits", "misses"}
    assert set(stats["scan_cache"]) == {"entries", "bytes", "max_bytes",
                                        "hits", "misses"}


def test_parts_rounds_bypass_the_stack_cache(monkeypatch):
    """The parts path builds its host rounds uncached, from numpy, even
    where device columns are on: its plans outgrow the stack cache's
    byte bound, so the cache would evict each round before its reuse.
    The cache stays empty and a recompute gives the same bytes."""
    monkeypatch.setenv("HORAEDB_FUSED_AGG", "0")
    _force_devcol(monkeypatch, True)

    async def run():
        e, r = await _port_reader({"max_window_rows": 512})
        try:
            await e.write_arrow("cpu", ["host"], _mkbatch(9, span=4 * HOUR))
            rng_q = PortRange.new(T0, T0 + 4 * HOUR)
            snap = registry.snapshot()
            first = await e.query_downsample("cpu", [], rng_q, 600_000)
            r.parts_memo.clear()
            again = await e.query_downsample("cpu", [], rng_q, 600_000)
            rounds = (registry.snapshot()["scan_parts_rounds_total"]
                      - snap.get("scan_parts_rounds_total", 0))
            memos = {k[0] for ws in r.scan_cache.values() for w in ws
                     for k in w.memo}
            return first, again, rounds, r.cache_stats()["stack_cache"], \
                memos
        finally:
            await e.close()

    first, again, rounds, stack, memos = asyncio.run(run())
    assert rounds >= 2
    assert (stack["entries"], stack["bytes"], stack["hits"],
            stack["misses"]) == (0, 0, 0, 0)
    assert "dev_cols" not in memos
    _same_bytes(first, again, "parts recompute")
