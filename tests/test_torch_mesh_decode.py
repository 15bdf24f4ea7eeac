"""The PyTorch port's mesh-placed decode ([scan.mesh] with
[scan.decode] mode = "device": deferred DecodePlans batched into
mesh_decode_partials rounds) against tests/test_mesh_decode.py's fast
scenarios, on the CPU, over a 4 x 2 mesh of 8 `cpu` entries.

Three ways byte-compared: mesh+decode, decode-only (the mesh detached)
and mesh-only (host decode on the mesh); the port's mesh decode against
the JAX package's (count, min, max, last and last_ts byte-equal, sums
within rtol 1e-5); the k-way merge route taken by multi-SST segments
(kway_merge_perm dispatched inside the rounds, the full sort never
paid); the additive top-k rankings served by the device score plane;
the round budget downgrade (mesh_decode_budget) and a lost round
(mesh_error), both counted and both still the controls' answer; a
round over host-selected plans of different capacities; the open-time
mode conflict; and close() releasing the mesh state."""

import asyncio
import os
import random

import numpy as np
import pyarrow as pa
import pytest

from horaedb_tpu_torch.common import Error, ReadableDuration
from horaedb_tpu_torch.common import deviceprof
from horaedb_tpu_torch.common import runtimes as runtimes_mod
from horaedb_tpu_torch.objstore import MemoryObjectStore
from horaedb_tpu_torch.ops import device_decode as dd_mod
from horaedb_tpu_torch.ops import filter as F
from horaedb_tpu_torch.ops.downsample import ALL_AGGS
from horaedb_tpu_torch.parallel import mesh as mesh_mod
from horaedb_tpu_torch.storage import read as read_mod
from horaedb_tpu_torch.storage.config import (
    StorageConfig,
    ThreadsConfig,
    from_dict,
)
from horaedb_tpu_torch.storage.plan import TopKSpec
from horaedb_tpu_torch.storage.read import AggregateSpec, ScanRequest
from horaedb_tpu_torch.storage.storage import CloudObjectStorage, WriteRequest
from horaedb_tpu_torch.storage.types import TimeRange

SEED = 1337
SEGMENT_MS = 3_600_000
SCHEMA = pa.schema([("k", pa.string()), ("ts", pa.int64()),
                    ("v", pa.float64())])
WHICH_SETS = (("avg",), ("min", "max"), ("count",), ("sum", "avg"),
              ("last",), ALL_AGGS)


@pytest.fixture(scope="module")
def runtimes():
    rt = runtimes_mod.from_config(ThreadsConfig())
    yield rt
    rt.close()


@pytest.fixture(autouse=True)
def cpu_mesh_env():
    old = {k: os.environ.get(k) for k in ("HORAEDB_FUSED_AGG",
                                          "HORAEDB_HOST_AGG")}
    os.environ["HORAEDB_FUSED_AGG"] = "0"
    os.environ["HORAEDB_HOST_AGG"] = "0"
    with mesh_mod.local_devices_scope(["cpu"] * 8):
        yield
    for k, v in old.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def run(coro):
    return asyncio.run(coro)


def _batch(rows):
    k, t, v = zip(*rows)
    return pa.record_batch(
        [pa.array(list(k)), pa.array(list(t), type=pa.int64()),
         pa.array(list(v), type=pa.float64())], schema=SCHEMA), min(t), \
        max(t) + 1


def wreq(rows):
    b, lo, hi = _batch(rows)
    return WriteRequest(b, TimeRange.new(lo, hi))


def scan_cfg(cfg_mod, **scan):
    scan.setdefault("mesh", {"enabled": True, "time": 4, "series": 2})
    scan.setdefault("decode", {"mode": "device"})
    cfg = cfg_mod.from_dict(cfg_mod.StorageConfig, {
        "scheduler": {"schedule_interval": "1h", "input_sst_min_num": 2},
        "scan": scan})
    cfg.manifest.merge_interval = ReadableDuration.parse("1h")
    cfg.scrub.interval = ReadableDuration.parse("1h")
    return cfg


async def open_storage(store, runtimes, **scan):
    from horaedb_tpu_torch.storage import config as cfg_mod

    return await CloudObjectStorage.open(
        "db", SEGMENT_MS, store, SCHEMA, 2, scan_cfg(cfg_mod, **scan),
        runtimes=runtimes, device="cpu")


def agg_spec(lo, hi, bucket_ms=60_000, which=("avg", "max", "last"),
             cls=AggregateSpec):
    return cls(group_col="k", ts_col="ts", value_col="v", range_start=lo,
               bucket_ms=bucket_ms,
               num_buckets=max(1, -(-(hi - lo) // bucket_ms)), which=which)


def seg_rows(rng, segments=3, rows_per=150, keys=6):
    return [[(f"k{rng.randint(0, keys - 1)}",
              seg * SEGMENT_MS + rng.randrange(0, SEGMENT_MS - 1000, 250),
              float(rng.randint(0, 10**6))) for _ in range(rows_per)]
            for seg in range(segments)]


async def write_segments(s, rng, **kw):
    for rows in seg_rows(rng, **kw):
        await s.write(wreq(rows))


def clear_caches(s, memo=True):
    s.reader.scan_cache.clear()
    s.reader.encoded_cache.clear()
    if memo:
        s.reader.parts_memo.clear()


def assert_same(a, b, ctx=""):
    va, ga = a
    vb, gb = b
    assert np.array_equal(va, vb), f"{ctx}: group values differ"
    assert set(ga) == set(gb), f"{ctx}: {set(ga)} != {set(gb)}"
    for k in ga:
        assert np.asarray(ga[k]).tobytes() == np.asarray(gb[k]).tobytes(), \
            f"{ctx}: grid {k!r} differs"


def fallbacks(reason: str) -> float:
    child = read_mod._MESH_FALLBACK_CHILDREN.get(reason)
    return 0.0 if child is None else child.value


class MeshOff:
    def __init__(self, s):
        self.reader = s.reader

    def __enter__(self):
        self._mesh = self.reader.scan_mesh
        self.reader.scan_mesh = None

    def __exit__(self, *exc):
        self.reader.scan_mesh = self._mesh


class HostDecode:
    def __init__(self, s):
        self.cfg = s.reader.config.scan.decode

    def __enter__(self):
        self._mode = self.cfg.mode
        self.cfg.mode = "host"

    def __exit__(self, *exc):
        self.cfg.mode = self._mode


async def query_three(s, req, spec, tk=None, ctx=""):
    """mesh+decode (warm and cold), decode-only and mesh-only, all
    byte-compared."""
    warm = await s.scan_aggregate(req, spec, top_k=tk)
    clear_caches(s)
    cold = await s.scan_aggregate(req, spec, top_k=tk)
    clear_caches(s)
    with MeshOff(s):
        decode_only = await s.scan_aggregate(req, spec, top_k=tk)
    clear_caches(s)
    with HostDecode(s):
        mesh_only = await s.scan_aggregate(req, spec, top_k=tk)
    clear_caches(s)
    assert_same(warm, cold, f"{ctx} warm-vs-cold")
    assert_same(cold, decode_only, f"{ctx} vs decode-only")
    assert_same(cold, mesh_only, f"{ctx} vs mesh-only")
    return cold


def test_mesh_decode_vs_both_controls_bit_identity(runtimes):
    """Overlapping writes (multi-SST segments: the k-way merge route),
    agg sets, filters and selection top-k: mesh+decode grids are both
    controls' byte for byte, decode rounds dispatch, the multi-run
    segments merge with kway_merge_perm inside the rounds and the full
    sort is never paid."""

    async def go():
        s = await open_storage(MemoryObjectStore(), runtimes)
        try:
            rng = random.Random(SEED)
            await write_segments(s, rng, segments=5, rows_per=200)
            await write_segments(s, rng, segments=3, rows_per=150)
            lo, hi = 0, 5 * SEGMENT_MS
            rounds0 = read_mod._MESH_ROUNDS.value
            kway0 = dd_mod._SORT_SKIPPED["kway"].value
            sorted0 = dd_mod._SORT_RAN.value
            merges0 = deviceprof.profiler._record(
                "kway_merge_perm").dispatches
            decode0 = deviceprof.profiler._record(
                "mesh_decode_partials").dispatches
            for i, which in enumerate(WHICH_SETS):
                pred = (None, F.Eq("k", "k3"), F.In("k", ["k1", "k4"]),
                        F.Ge("ts", SEGMENT_MS // 2))[i % 4]
                req = ScanRequest(range=TimeRange.new(lo, hi),
                                  predicate=pred)
                await query_three(s, req, agg_spec(lo, hi, which=which),
                                  ctx=f"{which} pred={pred}")
            for tk in (TopKSpec(k=3, by="max"),
                       TopKSpec(k=2, by="min", largest=False),
                       TopKSpec(k=3, by="last")):
                spec = agg_spec(lo, hi, which=("avg", "min", "max", "last"))
                await query_three(s, ScanRequest(range=TimeRange.new(lo, hi)),
                                  spec, tk=tk, ctx=f"tk={tk}")
            assert read_mod._MESH_ROUNDS.value > rounds0
            assert dd_mod._SORT_SKIPPED["kway"].value > kway0
            assert dd_mod._SORT_RAN.value == sorted0
            rec = deviceprof.profiler._record
            assert rec("mesh_decode_partials").dispatches > decode0
            assert rec("kway_merge_perm").dispatches > merges0
        finally:
            await s.close()

    run(go())


def test_port_mesh_decode_matches_the_jax_mesh_decode(runtimes):
    """The same seeded writes through both packages' engines with
    [scan.mesh] and [scan.decode] mode = "device": the same grids."""
    from horaedb_tpu.common import runtimes as ref_rt_mod
    from horaedb_tpu.objstore import MemoryObjectStore as RefStore
    from horaedb_tpu.storage import config as ref_cfg
    from horaedb_tpu.storage import read as ref_read
    from horaedb_tpu.storage import storage as ref_storage
    from horaedb_tpu.storage import types as ref_types

    async def go():
        ref_rt = ref_rt_mod.from_config(ref_cfg.ThreadsConfig())
        ref = await ref_storage.CloudObjectStorage.open(
            "db", SEGMENT_MS, RefStore(), SCHEMA, 2,
            scan_cfg(ref_cfg, mesh={"enabled": True}), runtimes=ref_rt)
        port = await open_storage(MemoryObjectStore(), runtimes)
        try:
            rng = random.Random(SEED + 2)
            for rows in seg_rows(rng, segments=4, rows_per=180) \
                    + seg_rows(rng, segments=2, rows_per=90):
                b, lo_t, hi_t = _batch(rows)
                await ref.write(ref_storage.WriteRequest(
                    b, ref_types.TimeRange.new(lo_t, hi_t)))
                await port.write(wreq(rows))
            lo, hi = 0, 4 * SEGMENT_MS
            rounds0 = read_mod._MESH_ROUNDS.value
            for which in (ALL_AGGS, ("min", "max", "last")):
                rv, rg = await ref.scan_aggregate(
                    ref_read.ScanRequest(
                        range=ref_types.TimeRange.new(lo, hi)),
                    agg_spec(lo, hi, which=which,
                             cls=ref_read.AggregateSpec))
                pv, pg = await port.scan_aggregate(
                    ScanRequest(range=TimeRange.new(lo, hi)),
                    agg_spec(lo, hi, which=which))
                assert list(rv) == list(pv)
                assert set(rg) == set(pg)
                for k in rg:
                    a, b = np.asarray(rg[k]), np.asarray(pg[k])
                    if k in ("sum", "avg"):
                        np.testing.assert_allclose(b, a, rtol=1e-5)
                    else:
                        assert a.tobytes() == b.astype(a.dtype).tobytes(), k
            assert read_mod._MESH_ROUNDS.value > rounds0
        finally:
            await ref.close()
            await port.close()
            ref_rt.close()

    run(go())


def test_additive_topk_identity_device_served(runtimes):
    """count/sum/avg rankings ride the compensated (hi, lo) score plane:
    each query is served on the mesh (the top-k counter grows, no
    additive_topk downgrade) and equals the control's, both directions.
    Decode stays host here: the topk_decode gate keeps device-decode
    parts out of device scoring."""

    async def go():
        s = await open_storage(MemoryObjectStore(), runtimes,
                               decode={"mode": "host"})
        try:
            rng = random.Random(SEED + 7)
            await write_segments(s, rng, segments=5, rows_per=200)
            await write_segments(s, rng, segments=2, rows_per=120)
            lo, hi = 0, 5 * SEGMENT_MS
            req = ScanRequest(range=TimeRange.new(lo, hi))
            lossy0 = fallbacks("additive_topk")
            for tk in (TopKSpec(k=3, by="count"),
                       TopKSpec(k=2, by="sum"),
                       TopKSpec(k=3, by="avg"),
                       TopKSpec(k=2, by="sum", largest=False),
                       TopKSpec(k=1, by="avg", largest=False)):
                which = ("avg", "sum") if tk.by != "count" else ("avg",)
                spec = agg_spec(lo, hi, which=which)
                clear_caches(s)
                served0 = read_mod._MESH_TOPK.value
                got = await s.scan_aggregate(req, spec, top_k=tk)
                assert read_mod._MESH_TOPK.value == served0 + 1, tk
                clear_caches(s)
                with MeshOff(s):
                    control = await s.scan_aggregate(req, spec, top_k=tk)
                assert_same(got, control, f"additive tk={tk}")
            assert fallbacks("additive_topk") == lossy0
        finally:
            await s.close()

    run(go())


def test_mesh_decode_budget_downgrade(runtimes):
    """A decode round over the grid cap downgrades PER ITEM to the
    standalone dispatch (mesh_decode_budget), with the same answer."""

    async def go():
        s = await open_storage(MemoryObjectStore(), runtimes)
        try:
            await write_segments(s, random.Random(SEED + 3), segments=4,
                                 rows_per=200)
            lo, hi = 0, 4 * SEGMENT_MS
            spec = agg_spec(lo, hi)
            req = ScanRequest(range=TimeRange.new(lo, hi))
            control = await query_three(s, req, spec, ctx="pre-budget")
            clear_caches(s)
            real = s.config.scan.mesh.max_grid_bytes
            before = fallbacks("mesh_decode_budget")
            s.config.scan.mesh.max_grid_bytes = 1
            try:
                got = await s.scan_aggregate(req, spec)
            finally:
                s.config.scan.mesh.max_grid_bytes = real
            assert fallbacks("mesh_decode_budget") > before
            assert_same(got, control, "budget downgrade")
        finally:
            await s.close()

    run(go())


def test_lost_shard_decode_round_fallback(runtimes):
    """A decode round that dies falls back to the per-segment dispatch,
    counted as mesh_error, with the same answer."""

    async def go():
        s = await open_storage(MemoryObjectStore(), runtimes)
        try:
            await write_segments(s, random.Random(SEED + 1), segments=5,
                                 rows_per=150)
            lo, hi = 0, 5 * SEGMENT_MS
            spec = agg_spec(lo, hi)
            req = ScanRequest(range=TimeRange.new(lo, hi))
            with MeshOff(s):
                control = await s.scan_aggregate(req, spec)
            clear_caches(s)
            real = s.reader._run_mesh_decode_round
            fails = {"left": 2}

            def flaky(chunk, spec_):
                if fails["left"] > 0:
                    fails["left"] -= 1
                    raise RuntimeError("simulated lost shard")
                return real(chunk, spec_)

            s.reader._run_mesh_decode_round = flaky
            before = fallbacks("mesh_error")
            try:
                got = await s.scan_aggregate(req, spec)
            finally:
                s.reader._run_mesh_decode_round = real
            assert fallbacks("mesh_error") == before + 2
            assert fails["left"] == 0
            assert_same(got, control, "lost-shard decode fallback")
        finally:
            await s.close()

    run(go())


def test_decode_mesh_mode_conflict_rejected_at_open(runtimes):
    """mode = "device" under the 1-D segment mesh fails at open, as
    the JAX package fails it."""

    async def go():
        with pytest.raises(Error, match="legacy"):
            await open_storage(MemoryObjectStore(), runtimes,
                               mesh={"enabled": False},
                               decode={"mode": "device"}, mesh_devices=4)

    run(go())


def test_close_evicts_mesh_decode_state(runtimes):
    """drop_hbm_state() evicts the decode round stacks; close() also
    drops the mesh programs and leaves no score-state bytes."""

    async def go():
        s = await open_storage(MemoryObjectStore(), runtimes)
        try:
            await write_segments(s, random.Random(SEED + 5), segments=3,
                                 rows_per=150)
            req = ScanRequest(range=TimeRange.new(0, 3 * SEGMENT_MS))
            await s.scan_aggregate(req, agg_spec(0, 3 * SEGMENT_MS))
            r = s.reader
            assert r._mesh_run_fns
            assert any(k[0] == "meshdecode" for k in r._stack_cache)
            r.drop_hbm_state()
            assert not r._stack_cache and r._stack_cache_bytes == 0
            assert r._mesh_run_fns and r._mesh_state_bytes == 0
        finally:
            await s.close()
        assert not s.reader._mesh_run_fns
        assert s.reader._mesh_state_bytes == 0

    run(go())


def test_mesh_decode_round_over_host_selected_plans(runtimes):
    """One field of segments that hold ten: each plan uploads only its
    selected rows, so a round's plans have different capacities; the
    round's grids are the per-segment dispatch's and host decode's byte
    for byte."""
    from horaedb_tpu_torch.storage import config as cfg_mod

    fschema = pa.schema([("h", pa.string()), ("f", pa.string()),
                         ("ts", pa.int64()), ("v", pa.float64())])
    fields = [f"f{i}" for i in range(10)]

    async def go():
        s = await CloudObjectStorage.open(
            "db", SEGMENT_MS, MemoryObjectStore(), fschema, 3,
            scan_cfg(cfg_mod), runtimes=runtimes, device="cpu")
        try:
            rng = random.Random(SEED + 11)
            # f3 keeps 60, 360, 120 and 240 rows: 128 to 512 slots
            for seg, ticks in enumerate((10, 60, 20, 40)):
                times = sorted(rng.sample(range(0, SEGMENT_MS, 30_000),
                                          ticks))
                rows = [(f"h{h}", f, seg * SEGMENT_MS + t,
                         float(rng.randint(0, 10**6)))
                        for h in range(6) for f in fields for t in times]
                h, f, t, v = zip(*rows)
                await s.write(WriteRequest(pa.record_batch(
                    [pa.array(list(h)), pa.array(list(f)),
                     pa.array(list(t), type=pa.int64()),
                     pa.array(list(v), type=pa.float64())],
                    schema=fschema), TimeRange.new(min(t), max(t) + 1)))
            lo, hi = 0, 4 * SEGMENT_MS
            req = ScanRequest(range=TimeRange.new(lo, hi),
                              predicate=F.Eq("f", "f3"))
            spec = AggregateSpec(group_col="h", ts_col="ts", value_col="v",
                                 range_start=lo, bucket_ms=600_000,
                                 num_buckets=(hi - lo) // 600_000,
                                 which=ALL_AGGS)
            real = s.reader._run_mesh_decode_round
            caps = []

            def spy(chunk, spec_):
                caps.append(sorted(dp.cap for _s, dp in chunk))
                return real(chunk, spec_)

            s.reader._run_mesh_decode_round = spy
            selected0 = dd_mod.select_counts()["selected"]
            rounds0 = read_mod._MESH_ROUNDS.value
            await query_three(s, req, spec, ctx="selected plans")
            assert dd_mod.select_counts()["selected"] - selected0 >= 4
            assert read_mod._MESH_ROUNDS.value > rounds0
            assert [128, 128, 256, 512] in caps
        finally:
            await s.close()

    run(go())
