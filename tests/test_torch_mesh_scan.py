"""The PyTorch port's 2-D (time x series) mesh scan ([scan.mesh],
horaedb_tpu_torch/storage/read.py) against tests/test_mesh_scan.py's
fast scenarios, on the CPU.

The port's engine runs a 4 x 2 mesh of 8 `cpu` entries (one device
named eight times; parallel.mesh.set_local_devices), the counterpart of
the JAX package's 8 virtual CPU devices.  Checked:

- the mesh against its own single-device control (the same reader with
  the mesh detached), byte for byte, over agg sets, filters and top-k;
- the port's mesh against the JAX package's mesh on the same seeded
  writes (count, min, max, last and last_ts byte-equal; sum and avg
  within rtol 1e-5) — the JAX side with HORAEDB_HOST_AGG=0, so its
  grids come from its device program, float32 like the port's;
- every _MeshFallback reason forced once, each counted, each answer
  still the control's;
- the top-k egress bound at two cardinalities;
- a deadline mid-mesh-scan cancels with no leaked task.

HORAEDB_FUSED_AGG=0 throughout: the control then takes the parts path
the mesh replaces (the fused accumulator folds float32 across windows,
the parts path folds each window's part in float64)."""

import asyncio
import os
import random

import numpy as np
import pyarrow as pa
import pytest

from horaedb_tpu_torch.common import Error, ReadableDuration
from horaedb_tpu_torch.common import runtimes as runtimes_mod
from horaedb_tpu_torch.common.deadline import (
    Deadline,
    DeadlineExceeded,
    deadline_scope,
)
from horaedb_tpu_torch.objstore import FaultInjectingStore, MemoryObjectStore
from horaedb_tpu_torch.ops import filter as F
from horaedb_tpu_torch.ops import merge as merge_ops
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
EXACT = ("count", "min", "max", "last", "last_ts")


@pytest.fixture(scope="module")
def runtimes():
    rt = runtimes_mod.from_config(ThreadsConfig())
    yield rt
    rt.close()


@pytest.fixture(autouse=True)
def cpu_mesh_env():
    """Eight cpu slots and the parts route for every test; restored."""
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


def wreq(rows, pkg_storage=None):
    k, t, v = zip(*rows)
    b = pa.record_batch(
        [pa.array(list(k)), pa.array(list(t), type=pa.int64()),
         pa.array(list(v), type=pa.float64())], schema=SCHEMA)
    req_cls = WriteRequest if pkg_storage is None else pkg_storage.WriteRequest
    tr = TimeRange if pkg_storage is None else pkg_storage.TimeRange
    return req_cls(b, tr.new(min(t), max(t) + 1))


def storage_config(cfg_mod=None, **scan):
    scan.setdefault("mesh", {"enabled": True, "time": 4, "series": 2})
    mod = cfg_mod
    if mod is None:
        cfg = from_dict(StorageConfig, {
            "scheduler": {"schedule_interval": "1h",
                          "input_sst_min_num": 2},
            "scan": scan})
    else:
        cfg = mod.from_dict(mod.StorageConfig, {
            "scheduler": {"schedule_interval": "1h",
                          "input_sst_min_num": 2},
            "scan": scan})
    cfg.manifest.merge_interval = ReadableDuration.parse("1h")
    cfg.scrub.interval = ReadableDuration.parse("1h")
    return cfg


async def open_storage(store, runtimes, **scan):
    return await CloudObjectStorage.open(
        "db", SEGMENT_MS, store, SCHEMA, 2, storage_config(**scan),
        runtimes=runtimes, device="cpu")


def agg_spec(lo, hi, bucket_ms=60_000, which=("avg", "max", "last"),
             cls=AggregateSpec):
    return cls(group_col="k", ts_col="ts", value_col="v", range_start=lo,
               bucket_ms=bucket_ms,
               num_buckets=max(1, -(-(hi - lo) // bucket_ms)), which=which)


def seg_rows(rng, segments=3, rows_per=150, keys=6, seg0=0):
    out = []
    for seg in range(seg0, seg0 + segments):
        out.append([(f"k{rng.randint(0, keys - 1)}",
                     seg * SEGMENT_MS + rng.randrange(0, SEGMENT_MS - 1000,
                                                      250),
                     float(rng.randint(0, 10**6)))
                    for _ in range(rows_per)])
    return out


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
    """The same reader with the mesh detached: the single-device
    control leg."""

    def __init__(self, s):
        self.reader = s.reader

    def __enter__(self):
        self._mesh = self.reader.scan_mesh
        self.reader.scan_mesh = None

    def __exit__(self, *exc):
        self.reader.scan_mesh = self._mesh


async def query_both(s, req, spec, tk=None, ctx=""):
    """One query served mesh-warm, mesh-cold and by the control, all
    three byte-compared."""
    warm = await s.scan_aggregate(req, spec, top_k=tk)
    clear_caches(s)
    cold = await s.scan_aggregate(req, spec, top_k=tk)
    clear_caches(s)
    with MeshOff(s):
        control = await s.scan_aggregate(req, spec, top_k=tk)
    assert_same(warm, cold, f"{ctx} warm-vs-cold")
    assert_same(cold, control, f"{ctx} mesh-vs-off")
    return control


def test_mesh_vs_off_bit_identity_basic(runtimes):
    """Overlapping writes (cross-SST duplicate PKs), agg sets, filters
    and top-k by every ranking: the mesh's grids are the control's byte
    for byte, and mesh rounds really run."""

    async def go():
        s = await open_storage(MemoryObjectStore(), runtimes)
        try:
            rng = random.Random(SEED)
            await write_segments(s, rng, segments=5, rows_per=160)
            await write_segments(s, rng, segments=3, rows_per=120)
            lo, hi = 0, 5 * SEGMENT_MS
            rounds0 = read_mod._MESH_ROUNDS.value
            for i, which in enumerate(WHICH_SETS):
                pred = (None, F.Eq("k", "k3"), F.In("k", ["k1", "k4"]),
                        F.Ge("ts", SEGMENT_MS // 2))[i % 4]
                req = ScanRequest(range=TimeRange.new(lo, hi),
                                  predicate=pred)
                await query_both(s, req, agg_spec(lo, hi, which=which),
                                 ctx=f"{which} pred={pred}")
            topk0 = read_mod._MESH_TOPK.value
            for tk in (TopKSpec(k=3, by="max"),
                       TopKSpec(k=2, by="min", largest=False),
                       TopKSpec(k=3, by="last"),
                       TopKSpec(k=2, by="avg"),
                       TopKSpec(k=2, by="sum"),
                       TopKSpec(k=1, by="count")):
                which = tuple(sorted({tk.by, "avg"} - {"count"}))
                req = ScanRequest(range=TimeRange.new(lo, hi))
                await query_both(s, req, agg_spec(lo, hi, which=which),
                                 tk=tk, ctx=f"tk={tk}")
            assert read_mod._MESH_ROUNDS.value > rounds0
            assert read_mod._MESH_TOPK.value > topk0
        finally:
            await s.close()

    run(go())


def test_port_mesh_matches_the_jax_mesh(runtimes):
    """The same seeded writes through the JAX package's engine on its
    8 virtual devices ([scan.mesh] auto: 4 x 2) and through the port's
    on 8 cpu slots: the same grids, top-k included."""
    from horaedb_tpu.common import runtimes as ref_rt_mod
    from horaedb_tpu.objstore import MemoryObjectStore as RefStore
    from horaedb_tpu.storage import config as ref_cfg
    from horaedb_tpu.storage import read as ref_read
    from horaedb_tpu.storage import storage as ref_storage
    from horaedb_tpu.storage import types as ref_types
    from horaedb_tpu.storage.plan import TopKSpec as RefTopK

    class RefNS:
        WriteRequest = ref_storage.WriteRequest
        TimeRange = ref_types.TimeRange

    async def go():
        ref_rt = ref_rt_mod.from_config(ref_cfg.ThreadsConfig())
        rcfg = storage_config(ref_cfg, mesh={"enabled": True})
        ref = await ref_storage.CloudObjectStorage.open(
            "db", SEGMENT_MS, RefStore(), SCHEMA, 2, rcfg,
            runtimes=ref_rt)
        port = await open_storage(MemoryObjectStore(), runtimes)
        try:
            assert ref.reader.scan_mesh.shape == {"time": 4, "series": 2}
            for rows in seg_rows(random.Random(SEED + 9), segments=4,
                                 rows_per=180):
                await ref.write(wreq(rows, RefNS))
                await port.write(wreq(rows))
            lo, hi = 0, 4 * SEGMENT_MS
            for which, tk in ((ALL_AGGS, None), (("min", "max"), None),
                              (("avg", "max"), ("max", 3)),
                              (("last",), ("last", 2)),
                              (("sum",), ("sum", 2))):
                r_tk = None if tk is None else RefTopK(k=tk[1], by=tk[0])
                p_tk = None if tk is None else TopKSpec(k=tk[1], by=tk[0])
                rv, rg = await ref.scan_aggregate(
                    ref_read.ScanRequest(range=ref_types.TimeRange.new(
                        lo, hi)),
                    agg_spec(lo, hi, which=which,
                             cls=ref_read.AggregateSpec), top_k=r_tk)
                pv, pg = await port.scan_aggregate(
                    ScanRequest(range=TimeRange.new(lo, hi)),
                    agg_spec(lo, hi, which=which), top_k=p_tk)
                assert list(rv) == list(pv), (which, tk)
                assert set(rg) == set(pg), (which, tk)
                for k in rg:
                    a, b = np.asarray(rg[k]), np.asarray(pg[k])
                    if k in EXACT:
                        assert a.tobytes() == b.astype(a.dtype).tobytes(), \
                            (which, tk, k)
                    else:
                        np.testing.assert_allclose(b, a, rtol=1e-5)
        finally:
            await ref.close()
            await port.close()
            ref_rt.close()

    run(go())


def test_topk_mesh_bounded_egress(runtimes):
    """Per-slot combine egress of the device-scored top-k route is
    O(k x buckets x aggs) per run part, asserted against the cell
    counter at two cardinalities."""

    async def go(keys: int):
        s = await open_storage(MemoryObjectStore(), runtimes)
        try:
            await write_segments(s, random.Random(SEED), segments=4,
                                 rows_per=400, keys=keys)
            lo, hi = 0, 4 * SEGMENT_MS
            spec = agg_spec(lo, hi, which=("avg", "max"))
            tk = TopKSpec(k=3, by="max")
            req = ScanRequest(range=TimeRange.new(lo, hi))
            clear_caches(s)
            served0 = read_mod._MESH_TOPK.value
            cells0 = read_mod._MESH_PART_CELLS.value
            got = await s.scan_aggregate(req, spec, top_k=tk)
            assert read_mod._MESH_TOPK.value == served0 + 1
            cells = read_mod._MESH_PART_CELLS.value - cells0
            assert cells <= 4 * tk.k * spec.num_buckets * 8, cells
            with MeshOff(s):
                clear_caches(s)
                control = await s.scan_aggregate(req, spec, top_k=tk)
            assert_same(got, control, f"topk keys={keys}")
            return cells
        finally:
            await s.close()

    small = run(go(6))
    large = run(go(200))
    assert large <= small * 2, (small, large)


def test_lost_shard_round_fallback(runtimes):
    """A mesh round that dies falls back to the single-device kernel
    PER ROUND, counted as mesh_error, and the answer stays the
    control's; a failed top-k winner pass downgrades to full parts."""

    async def go():
        s = await open_storage(MemoryObjectStore(), runtimes,
                               agg_batch_windows=2)
        try:
            await write_segments(s, random.Random(SEED + 1), segments=5,
                                 rows_per=150)
            lo, hi = 0, 5 * SEGMENT_MS
            spec = agg_spec(lo, hi)
            req = ScanRequest(range=TimeRange.new(lo, hi))
            with MeshOff(s):
                control = await s.scan_aggregate(req, spec)
            clear_caches(s)
            real = s.reader._run_mesh_round
            fails = {"left": 2}

            def flaky(items, spec_, plan, **kw):
                if fails["left"] > 0:
                    fails["left"] -= 1
                    raise RuntimeError("simulated lost shard")
                return real(items, spec_, plan, **kw)

            s.reader._run_mesh_round = flaky
            before = fallbacks("mesh_error")
            try:
                got = await s.scan_aggregate(req, spec)
            finally:
                s.reader._run_mesh_round = real
            assert fallbacks("mesh_error") == before + 2
            assert fails["left"] == 0
            assert_same(got, control, "lost-shard fallback")

            tk = TopKSpec(k=2, by="max")
            spec_tk = agg_spec(lo, hi, which=("max", "avg"))
            clear_caches(s)
            with MeshOff(s):
                ctl_tk = await s.scan_aggregate(req, spec_tk, top_k=tk)
            clear_caches(s)
            calls = {"n": 0}

            def flaky_pass2(items, spec_, plan, **kw):
                if kw.get("download", True) is False:
                    calls["n"] += 1
                    if calls["n"] == 3:  # the first winner-pass round
                        raise RuntimeError("lost shard in winner pass")
                return real(items, spec_, plan, **kw)

            s.reader._run_mesh_round = flaky_pass2
            before = fallbacks("mesh_error")
            try:
                got_tk = await s.scan_aggregate(req, spec_tk, top_k=tk)
            finally:
                s.reader._run_mesh_round = real
            assert calls["n"] >= 3
            assert fallbacks("mesh_error") == before + 1
            assert_same(got_tk, ctl_tk, "winner-pass downgrade")
        finally:
            await s.close()

    run(go())


def test_deadline_mid_mesh_cancels_no_leaked_tasks(runtimes):
    """A DeadlineExceeded mid-mesh-scan drains the in-flight round
    before control returns: no scan-spawned task outlives the query, on
    the streaming pump and on the top-k route."""

    async def go():
        store = FaultInjectingStore(MemoryObjectStore(), seed=SEED,
                                    latency_range=(0.05, 0.05))
        s = await open_storage(store, runtimes)
        try:
            for seg in range(6):
                await s.write(wreq([(f"k{j % 4}", seg * SEGMENT_MS + j,
                                     float(j)) for j in range(300)]))
            clear_caches(s)
            tasks_before = asyncio.all_tasks()
            req = ScanRequest(range=TimeRange.new(0, 6 * SEGMENT_MS))
            with deadline_scope(Deadline.after(0.02, "test query")):
                with pytest.raises(DeadlineExceeded):
                    await s.scan_aggregate(req, agg_spec(0, 6 * SEGMENT_MS))
            leaked = [t for t in asyncio.all_tasks() - tasks_before
                      if not t.done()]
            assert not leaked, leaked
            # every read of the top-k query pays the 50 ms store again
            clear_caches(s)
            with deadline_scope(Deadline.after(0.02, "topk query")):
                with pytest.raises(DeadlineExceeded):
                    await s.scan_aggregate(
                        req, agg_spec(0, 6 * SEGMENT_MS,
                                      which=("max", "avg")),
                        top_k=TopKSpec(k=2, by="max"))
            leaked = [t for t in asyncio.all_tasks() - tasks_before
                      if not t.done()]
            assert not leaked, leaked
        finally:
            await s.close()

    run(go())


class _CoverAllRouter:
    """A near-data router that claims every segment and then fails
    them all: the plan keeps its local pump, but the top-k route must
    decline first (topk_router)."""

    active = True

    def covers_any(self, segments):
        return True

    def split(self, segments):
        return list(segments), []

    async def gather(self, plan, spec, covered):
        return [], list(covered)


async def _force(reason, runtimes):
    """Drive one query that must take `reason`'s fallback; returns
    (mesh answer, control answer)."""
    lo, hi = 0, 3 * SEGMENT_MS
    scan: dict = {}
    rows = None
    spec = agg_spec(lo, hi)
    tk = None
    req_hi = hi
    if reason == "sum_overlap":
        scan = dict(max_window_rows=128, stream_read_min_rows=64)
        rows = [[("hot", j * 7, float(j)) for j in range(900)]]
        spec = agg_spec(lo, SEGMENT_MS, which=("sum", "avg"))
        req_hi = SEGMENT_MS
    elif reason == "run_misaligned":
        scan = dict(max_window_rows=128, stream_read_min_rows=64,
                    use_sidecar=False)
        rows = [[(f"k{ki}", ki * 300_000 + j * 500, float(ki * 1000 + j))
                 for ki in range(10) for j in range(120)]]
        spec = agg_spec(lo, SEGMENT_MS, which=("min", "max", "count"))
        req_hi = SEGMENT_MS
    elif reason == "grid_budget":
        scan = dict(mesh={"enabled": True, "time": 4, "series": 2,
                          "max_grid_bytes": 1024})
    elif reason == "lo_range":
        # a spec of one bucket over a three-segment range: later
        # segments' windows start past the grid
        spec = AggregateSpec(group_col="k", ts_col="ts", value_col="v",
                             range_start=0, bucket_ms=60_000, num_buckets=1,
                             which=("max",))
    elif reason == "topk_by":
        spec = agg_spec(lo, hi, which=("max",))
        tk = TopKSpec(k=2, by="min")
    elif reason == "topk_decode":
        scan = dict(decode={"mode": "device"})
        tk = TopKSpec(k=2, by="max")
    elif reason == "topk_budget":
        scan = dict(cache_max_bytes=1024)
        tk = TopKSpec(k=2, by="max")
    elif reason == "topk_router":
        tk = TopKSpec(k=2, by="max")
    elif reason == "additive_topk":
        # one 3 h bucket: every segment's tail adds into the same cells,
        # and 1e30 + 1 is not an exact dense pair
        rows = [[("k0", s * SEGMENT_MS + 5, 1e30 if s == 0 else 1.0),
                 ("k1", s * SEGMENT_MS + 5, 2.0)] for s in range(3)]
        spec = agg_spec(lo, hi, bucket_ms=3 * SEGMENT_MS, which=("sum",))
        tk = TopKSpec(k=1, by="sum")
    s = await open_storage(MemoryObjectStore(), runtimes, **scan)
    try:
        if rows is None:
            await write_segments(s, random.Random(SEED + 5), segments=3)
        else:
            for r in rows:
                await s.write(wreq(r))
        if reason == "topk_router":
            s.reader.scan_router = _CoverAllRouter()
        req = ScanRequest(range=TimeRange.new(lo, req_hi))

        async def answer():
            clear_caches(s)
            try:
                return await s.scan_aggregate(req, spec, top_k=tk)
            except Error as exc:
                # a ranking agg the spec lacks: both routes refuse it
                return str(exc)

        got = await answer()
        with MeshOff(s):
            control = await answer()
        return got, control
    finally:
        s.reader.scan_router = None
        await s.close()


@pytest.mark.parametrize("reason", [
    "sum_overlap", "run_misaligned", "grid_budget", "lo_range", "topk_by",
    "topk_decode", "topk_budget", "topk_router", "additive_topk"])
def test_fallback_reason_forced(runtimes, reason):
    """Each plan- and round-level reason fires on a query built to
    need it, is counted once or more, and the answer is the control's."""
    before = fallbacks(reason)
    got, control = run(_force(reason, runtimes))
    assert fallbacks(reason) > before, reason
    if reason == "topk_by":
        assert isinstance(got, str) and got == control
    else:
        assert_same(got, control, reason)


def test_merge_impl_and_count_bound_reasons(runtimes):
    """merge_impl: a device_sort merge layout keeps the 2-D mesh off
    (counted per plan).  count_bound: a run whose slots x capacity
    reaches 2^24 cannot combine its float32 counts exactly — the gate
    is checked on a synthetic round (a real one needs 4M-row
    windows)."""

    async def go():
        s = await open_storage(MemoryObjectStore(), runtimes)
        try:
            await write_segments(s, random.Random(SEED + 6), segments=2)
            lo, hi = 0, 2 * SEGMENT_MS
            req = ScanRequest(range=TimeRange.new(lo, hi))
            spec = agg_spec(lo, hi)
            with MeshOff(s):
                control = await s.scan_aggregate(req, spec)
            before = fallbacks("merge_impl")
            merge_ops.set_merge_impl("device_sort")
            try:
                clear_caches(s)
                got = await s.scan_aggregate(req, spec)
            finally:
                merge_ops.set_merge_impl("host_perm")
            assert fallbacks("merge_impl") > before
            assert_same(got, control, "merge_impl")
            T = s.reader.scan_mesh.shape["time"]

            class W:
                def __init__(self):
                    self.encodings = {"ts": type("E", (), {"kind": "numeric"})}

            items = [(0, W(), (np.asarray(["k0"]), None, 0)),
                     (0, W(), (np.asarray(["k1"]), None, 0))]
            runs = s.reader._mesh_runs(items)
            with pytest.raises(read_mod._MeshFallback) as e:
                s.reader._mesh_round_gates(
                    items, runs, agg_spec(lo, hi, which=("max",)), 8, 8,
                    (1 << 24) // T, False)
            assert e.value.reason == "count_bound"
        finally:
            await s.close()

    run(go())


def test_fallback_wider_than_host_round(runtimes):
    """A mesh chunk wider than [scan] agg_batch_windows falls back in
    single-device rounds of that width."""

    async def go():
        s = await open_storage(MemoryObjectStore(), runtimes,
                               agg_batch_windows=2)
        try:
            await write_segments(s, random.Random(SEED + 4), segments=4,
                                 rows_per=120)
            lo, hi = 0, 4 * SEGMENT_MS
            spec = agg_spec(lo, hi)
            req = ScanRequest(range=TimeRange.new(lo, hi))
            with MeshOff(s):
                control = await s.scan_aggregate(req, spec)
            clear_caches(s)
            real = s.reader._run_mesh_round

            def always_fails(items, spec_, plan, **kw):
                raise RuntimeError("simulated mesh loss")

            s.reader._run_mesh_round = always_fails
            try:
                got = await s.scan_aggregate(req, spec)
            finally:
                s.reader._run_mesh_round = real
            assert_same(got, control, "wide fallback")
        finally:
            await s.close()

    run(go())


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_stack_time_axis_is_the_placed_host_stack(dtype):
    """The mesh decode round's column stacks, assembled on the device
    from each slot's column, equal the zero-padded host stack that
    shard_time_axis places, block for block, and charge only the real
    rows' bytes as h2d."""
    import torch

    from horaedb_tpu_torch.common import deviceprof
    from horaedb_tpu_torch.parallel import scan as pscan

    mesh = mesh_mod.scan_mesh(time=4, series=2, devices=["cpu"] * 8)
    rng = np.random.default_rng(SEED)
    rows = [(rng.random(n) * 1000).astype(dtype) for n in (5, 0, 7)]
    cap = 8
    host = np.zeros((4, cap), dtype=dtype)
    for t, r in enumerate(rows):
        host[t, :len(r)] = r
    prof = deviceprof.profiler
    was = prof.enabled
    prof.configure(enabled=True)
    try:
        h2d0 = prof.transfer["h2d"]["bytes"]
        got = pscan.stack_time_axis(mesh, rows, cap, dtype)
        assert prof.transfer["h2d"]["bytes"] - h2d0 == 12 * 4
    finally:
        prof.configure(enabled=was)
    want = pscan.shard_time_axis(mesh, host)
    assert got.shape == want.shape and got.spec == want.spec
    for a, b in zip(got.blocks, want.blocks):
        assert a.dtype == b.dtype and torch.equal(a, b)
    np.testing.assert_array_equal(got.numpy(), host)


def test_bad_mesh_shapes_rejected_at_open(runtimes):
    async def go():
        with pytest.raises(Error, match="power of two"):
            await open_storage(MemoryObjectStore(), runtimes,
                               mesh={"enabled": True, "time": 1,
                                     "series": 3})
        with pytest.raises(Error, match="mutually exclusive"):
            await open_storage(MemoryObjectStore(), runtimes,
                               mesh={"enabled": True}, mesh_devices=4)

    run(go())


def test_default_scan_shape_and_stats(runtimes):
    from horaedb_tpu.parallel import default_scan_shape as ref_shape

    for n in (1, 2, 4, 7, 8):
        assert mesh_mod.default_scan_shape(n) == ref_shape(n)

    async def go():
        s = await open_storage(MemoryObjectStore(), runtimes,
                               mesh={"enabled": True})
        try:
            stats = s.reader.cache_stats()["mesh"]
            assert stats["enabled"] is True
            assert stats["shape"] == {"time": 4, "series": 2}
            assert stats["devices"] == ["cpu"] * 8
            assert "stalls" in stats
            assert read_mod._MESH_AXIS_DEVICES["time"].value == 4
        finally:
            await s.close()
        assert read_mod._MESH_AXIS_DEVICES["time"].value == 0

    run(go())


def _chaos_schedule(i: int, runtimes):
    """One seeded schedule: writes, compactions, evictions and queries
    over random ranges, agg sets, filters and top-k, each query served
    mesh-warm, mesh-cold and by the control, all byte-equal; one op
    races a query against a compaction.  Odd schedules stream segments
    through tiny windows (multi-slot runs, the sum-overlap gate), and
    i % 4 == 1 reads parquet (per-chunk epochs: run_misaligned);
    i % 3 == 2 loses mesh rounds at random (the per-round fallback)."""

    async def go():
        rng = random.Random(SEED + i)
        scan_kw: dict = {}
        if i % 2:
            scan_kw.update(stream_read_min_rows=64, max_window_rows=128)
        if i % 4 == 1:
            scan_kw.update(use_sidecar=False)
        s = await open_storage(MemoryObjectStore(), runtimes, **scan_kw)
        real_round = s.reader._run_mesh_round

        async def checked_query():
            lo = rng.randrange(0, 2 * SEGMENT_MS, 250)
            hi = lo + rng.randrange(250, 3 * SEGMENT_MS, 250)
            which = WHICH_SETS[rng.randrange(len(WHICH_SETS))]
            spec = agg_spec(lo, hi, bucket_ms=rng.choice([250, 60_000]),
                            which=which)
            pred = rng.choice([None, F.Eq("k", f"k{rng.randint(0, 5)}"),
                               F.In("k", ["k1", "k3", "k5"]),
                               F.Ge("ts", SEGMENT_MS // 2)])
            req = ScanRequest(range=TimeRange.new(lo, hi), predicate=pred)
            tk = None
            if rng.random() < 0.35:
                tk = TopKSpec(k=rng.randint(1, 4),
                              by=rng.choice(list(which) + ["count"]),
                              largest=rng.random() < 0.5)
            if i % 3 == 2:
                fails = {"left": rng.randint(0, 2)}

                def flaky(items, spec_, plan, **kw):
                    if fails["left"] > 0:
                        fails["left"] -= 1
                        raise RuntimeError("simulated lost shard")
                    return real_round(items, spec_, plan, **kw)

                s.reader._run_mesh_round = flaky
            try:
                await query_both(s, req, spec, tk=tk,
                                 ctx=f"schedule {i} {lo}-{hi} {which} "
                                     f"{pred} {tk}")
            finally:
                s.reader._run_mesh_round = real_round

        async def compact_once():
            task = await s.compact_scheduler.picker.pick_candidate()
            if task is not None:
                await s.compact_scheduler.executor.execute(task)

        try:
            await write_segments(s, rng, segments=3, rows_per=120)
            for _op in range(8):
                op = rng.choice(["write", "write", "query", "query",
                                 "compact", "evict", "race"])
                if op == "write":
                    seg = rng.randint(0, 2)
                    await s.write(wreq([
                        (f"k{rng.randint(0, 5)}",
                         seg * SEGMENT_MS + rng.randint(0, 999),
                         float(rng.randint(0, 10**6)))
                        for _ in range(rng.randint(1, 30))]))
                elif op == "compact":
                    await compact_once()
                elif op == "evict":
                    clear_caches(s, memo=rng.random() < 0.5)
                elif op == "race":
                    await asyncio.gather(checked_query(), compact_once())
                else:
                    await checked_query()
            await checked_query()
        finally:
            await s.close()

    run(go())


@pytest.mark.parametrize("schedule", [0, 1, 2])
def test_seeded_mesh_chaos_fast(runtimes, schedule):
    """Three of the JAX package's chaos schedules on the port's mesh:
    one bulk, one streamed through parquet, one losing rounds."""
    _chaos_schedule(schedule, runtimes)


def test_streamed_window_past_the_grid(runtimes):
    """A parquet-streamed segment encodes each chunk with its own ts
    epoch, so a chunk can start past the query's last bucket.  Such a
    window keeps no column (its rows are all out of range): on the
    single-device parts route and on the mesh the counts are numpy's.
    The JAX package's parts route raises here (ROADMAP Queue C 13)."""

    async def go():
        s = await open_storage(MemoryObjectStore(), runtimes,
                               stream_read_min_rows=64, max_window_rows=128,
                               use_sidecar=False)
        try:
            rows = [(f"k{ki}", ki * 300_000 + j * 500, float(j))
                    for ki in range(10) for j in range(120)]
            await s.write(wreq(rows))
            hi = 1_500_000
            spec = agg_spec(0, hi, which=("count", "max"))
            req = ScanRequest(range=TimeRange.new(0, hi))
            got = await s.scan_aggregate(req, spec)
            clear_caches(s)
            with MeshOff(s):
                control = await s.scan_aggregate(req, spec)
            assert_same(got, control, "past-the-grid window")
            want = np.zeros((5, spec.num_buckets))
            for k, t, _v in rows:
                if t < hi:
                    want[int(k[1:]), t // 60_000] += 1
            assert list(got[0]) == [f"k{i}" for i in range(5)]
            assert np.array_equal(got[1]["count"], want)
        finally:
            await s.close()

    run(go())
