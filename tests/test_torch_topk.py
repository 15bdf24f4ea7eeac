"""Top-k in the port against the JAX package on the same numpy-seeded
inputs: ops/topk.py (top_k_groups with the reference's tie order, the
pair arithmetic byte for byte on normal-range f32), plan.apply_top_k,
combine.rank_top_k and combine.combine_top_k (byte-equal results and
counter deltas, int and string group values), the facade's TopK stage
on a small config-4 shape (plan_query / execute_plan, host and device
decode, streamed, sparse and the dense control), and
MetricEngine.query_topk on the fused and the parts paths."""

import asyncio
import os

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch
from test_torch_combine import WHICH_SETS, _assert_bytes, _copy, _rand_parts
from test_torch_engine import END, SEG, T0, _batches, _numpy

from horaedb_tpu.metric_engine import MetricEngine as RefEngine
from horaedb_tpu.objstore import MemoryObjectStore as RefStore
from horaedb_tpu.ops import topk as ref_topk
from horaedb_tpu.storage import combine as ref_combine
from horaedb_tpu.storage import config as ref_config
from horaedb_tpu.storage import plan as ref_plan
from horaedb_tpu.storage import read as ref_read
from horaedb_tpu.storage import storage as ref_storage
from horaedb_tpu.storage import types as ref_types
from horaedb_tpu_torch.common.error import Error
from horaedb_tpu_torch.metric_engine import MetricEngine as PortEngine
from horaedb_tpu_torch.objstore import MemoryObjectStore
from horaedb_tpu_torch.ops import topk
from horaedb_tpu_torch.ops.downsample import ALL_AGGS
from horaedb_tpu_torch.storage import combine as port_combine
from horaedb_tpu_torch.storage import config as port_config
from horaedb_tpu_torch.storage import plan as port_plan
from horaedb_tpu_torch.storage import read as port_read
from horaedb_tpu_torch.storage import storage as port_storage
from horaedb_tpu_torch.storage import types as port_types

# ---- ops/topk.py ----------------------------------------------------------

F32 = np.float32
SCORES = {
    "basic": [1.0, 5.0, 3.0, np.nan, 4.0],
    "ties": [1, 3, 3, 2, 3],
    "signed zeros": [0.0, -0.0, 0.0, -0.0],
    "all nan": [np.nan] * 4,
    "inf": [np.inf, 2.0, -np.inf, np.nan, 2.0, np.inf],
    "real -inf": [-np.inf, -np.inf, 1.0],
    "two groups": [2.0, 1.0],
}


def _seeded_scores(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 200))
    x = rng.integers(-5, 5, n).astype(F32)
    x[rng.random(n) < 0.2] = np.nan
    x[rng.random(n) < 0.05] = np.inf
    x[rng.random(n) < 0.05] = -np.inf
    return x


def _top_k_both(x, k, largest):
    got_v, got_i = topk.top_k_groups(torch.from_numpy(x), k, largest)
    want_v, want_i = ref_topk.top_k_groups(jnp.asarray(x), k=k,
                                           largest=largest)
    return (got_v.numpy(), got_i.numpy()), (np.asarray(want_v),
                                            np.asarray(want_i))


@pytest.mark.parametrize("largest", [True, False])
@pytest.mark.parametrize("case", sorted(SCORES) + ["seed0", "seed1",
                                                   "seed2"])
def test_top_k_groups_matches_reference(case, largest):
    x = (_seeded_scores(int(case[4:])) if case.startswith("seed")
         else np.array(SCORES[case], dtype=F32))
    for k in (1, 2, 3, len(x), len(x) + 3):
        (gv, gi), (wv, wi) = _top_k_both(x, k, largest)
        assert gi.dtype == wi.dtype == np.int32
        assert gi.tolist() == wi.tolist(), (case, k, largest)
        assert gv.dtype == wv.dtype and gv.tobytes() == wv.tobytes()


def test_top_k_groups_reference_cases():
    """tests/test_ops.py's TestTopK, on the port."""
    x = torch.tensor([1.0, 5.0, 3.0, np.nan, 4.0])
    vals, idxs = topk.top_k_groups(x, k=3)
    assert idxs.tolist() == [1, 4, 2] and vals.tolist() == [5.0, 4.0, 3.0]
    vals, idxs = topk.top_k_groups(x, k=2, largest=False)
    assert idxs.tolist() == [0, 2] and vals.tolist() == [1.0, 3.0]
    vals, idxs = topk.top_k_groups(torch.tensor([2.0, 1.0]), k=4)
    assert idxs.tolist() == [0, 1, -1, -1] and vals[2:].isnan().all()
    vals, idxs = topk.top_k_groups(torch.full((4,), float("nan")), k=2)
    assert idxs.tolist() == [-1, -1] and vals.isnan().all()
    # ties go to the lower index, as lax.top_k's do
    _vals, idxs = topk.top_k_groups(torch.tensor([1.0, 3, 3, 2, 3]), k=3)
    assert idxs.tolist() == [1, 2, 4]


def _triples(seed, n=20_000):
    rng = np.random.default_rng(seed)
    scale = F32(2.0) ** rng.integers(-20, 20, (3, n)).astype(F32)
    hi, lo, x = rng.standard_normal((3, n)).astype(F32) * scale
    return hi, lo * F32(2.0 ** -30), x


def _bytes_equal(got, want):
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


@pytest.mark.parametrize("seed", range(3))
def test_pair_arithmetic_matches_reference_on_normal_range(seed):
    hi, lo, x = _triples(seed)
    t = [torch.from_numpy(a) for a in (hi, lo, x)]
    j = [jnp.asarray(a) for a in (hi, lo, x)]
    _bytes_equal(topk.two_sum(t[0], t[2]), ref_topk.two_sum(j[0], j[2]))
    got = topk.pair_add(*t)
    _bytes_equal(got, ref_topk.pair_add(*j))
    assert 0 < int(got[2].sum()) < len(hi)  # both exact and not
    mask = np.random.default_rng(seed).random((100, 200)) < 0.6
    mask[3] = False  # a row with nothing masked in
    for largest in (True, False):
        for axis in (0, 1):
            _bytes_equal(
                topk.pair_max_normalized(t[0].view(100, 200),
                                         t[1].view(100, 200),
                                         torch.from_numpy(mask), axis,
                                         largest),
                ref_topk.pair_max_normalized(j[0].reshape(100, 200),
                                             j[1].reshape(100, 200),
                                             jnp.asarray(mask), axis,
                                             largest))


def test_subnormals_keep_ieee_where_the_reference_cpu_flushes():
    """A reference note, not a fault: XLA's CPU backend flushes
    subnormals to zero, torch keeps them.  The port's result is the
    IEEE one, which a host f64 fold of the same addends gives, as the
    `exact` flag promises."""
    a = np.array([1e-39, 1.5e-38], dtype=F32)
    b = np.array([1e-39, -1.4e-38], dtype=F32)
    s, e = topk.two_sum(torch.from_numpy(a), torch.from_numpy(b))
    want = (a.astype(np.float64) + b.astype(np.float64)).astype(F32)
    assert s.numpy().tobytes() == want.tobytes()
    assert (s.numpy() != 0).all() and (e.numpy() == 0).all()
    ref_s, _ref_e = ref_topk.two_sum(jnp.asarray(a), jnp.asarray(b))
    assert np.asarray(ref_s).tolist() == [0.0, 0.0]  # flushed


# ---- plan.apply_top_k, combine.rank_top_k / combine_top_k ---------------

STR_UNIVERSE = np.array(sorted(f"host_{i}" for i in range(40)),
                        dtype=object)


def _parts_case(seed, strings):
    rng = np.random.default_rng(seed)
    num_buckets = int(rng.integers(1, 30))
    if strings:
        universe = np.sort(rng.choice(STR_UNIVERSE,
                                      size=int(rng.integers(1, 14)),
                                      replace=False))
    else:
        universe = np.sort(rng.choice(np.arange(1, 500, dtype=np.uint64),
                                      size=int(rng.integers(1, 14)),
                                      replace=False))
    parts = _rand_parts(rng, num_buckets, universe, int(rng.integers(0, 8)))
    if parts and rng.random() < 0.5:
        # one group empty in every part: dropped before ranking
        victim = universe[int(rng.integers(0, len(universe)))]
        for values, _lo, g in parts:
            rows = np.flatnonzero(values == victim)
            for name, fill in (("count", 0), ("sum", 0), ("min", np.inf),
                               ("max", -np.inf), ("last", 0)):
                g[name][rows] = fill
            g["last_ts"][rows] = np.iinfo(np.int64).min
    which = WHICH_SETS[int(rng.integers(0, len(WHICH_SETS)))]
    by_pool = [a for a in which if a != "last_ts"] + ["count"]
    tk = (int(rng.integers(1, 6)), by_pool[int(rng.integers(0,
                                                           len(by_pool)))],
          bool(rng.integers(0, 2)))
    return num_buckets, parts, which, tk


def _counters(mod):
    return (mod._MATERIALIZED.value, mod._GRID.value, mod._TOUCHED.value)


@pytest.mark.parametrize("strings", [False, True])
@pytest.mark.parametrize("seed", range(10))
def test_combine_top_k_matches_reference(seed, strings):
    for it in range(6):
        num_buckets, parts, which, (k, by, largest) = _parts_case(
            seed * 100 + it, strings)
        ctx = f"seed {seed} it {it} which={which} k={k} by={by} {largest}"
        c_port, c_ref = _counters(port_combine), _counters(ref_combine)
        got = port_combine.combine_top_k(
            _copy(parts), num_buckets, which,
            port_plan.TopKSpec(k, by, largest))
        want = ref_combine.combine_top_k(
            _copy(parts), num_buckets, which,
            ref_plan.TopKSpec(k, by, largest))
        _assert_bytes(got, want, ctx)
        d_port = np.subtract(_counters(port_combine), c_port)
        d_ref = np.subtract(_counters(ref_combine), c_ref)
        assert d_port.tolist() == d_ref.tolist(), ctx
        # the pushdown equals dense + the empty-group drop + apply_top_k
        values, grids = port_combine.combine_aggregate_parts(
            _copy(parts), num_buckets, which=which)
        if len(values):
            nonzero = grids["count"].sum(axis=1) > 0
            values = values[nonzero]
            grids = {n: g[nonzero] for n, g in grids.items()}
        _assert_bytes(got, port_plan.apply_top_k(
            values, grids, port_plan.TopKSpec(k, by, largest)), ctx)


@pytest.mark.parametrize("largest", [True, False])
@pytest.mark.parametrize("by", ["count", "sum", "min", "max", "avg", "last"])
def test_apply_top_k_matches_reference(by, largest):
    rng = np.random.default_rng(hash((by, largest)) % 2**32)
    g, nb = 30, 7
    values = np.sort(rng.choice(STR_UNIVERSE, size=g, replace=False))
    count = rng.integers(0, 3, (g, nb)).astype(np.float32)
    count[4] = 0  # a group with no data anywhere
    grids = {name: rng.integers(0, 4, (g, nb)).astype(np.float32)
             for name in ("sum", "min", "max", "avg", "last")}
    grids["count"] = count
    tk_port = port_plan.TopKSpec(k=5, by=by, largest=largest)
    tk_ref = ref_plan.TopKSpec(k=5, by=by, largest=largest)
    got = port_plan.apply_top_k(values, grids, tk_port)
    _assert_bytes(got, ref_plan.apply_top_k(values, grids, tk_ref), by)
    # grids given as tensors come back as the same host arrays
    tensors = {n: torch.from_numpy(a) for n, a in grids.items()}
    _assert_bytes(port_plan.apply_top_k(values, tensors, tk_port), got, by)


def test_apply_top_k_reference_cases():
    """tests/test_plan.py's TestApplyTopK, on the port."""
    values = np.array([10, 20, 30, 40], dtype=np.uint64)
    grids = {"count": np.array([[1, 0], [2, 1], [0, 0], [1, 1]],
                               dtype=np.float32),
             "max": np.array([[5.0, 99.0], [7.0, 3.0], [88.0, 88.0],
                              [1.0, 6.0]], dtype=np.float32)}
    top_v, top_g = port_plan.apply_top_k(values, grids,
                                         port_plan.TopKSpec(k=2, by="max"))
    assert top_v.tolist() == [20, 40]
    np.testing.assert_array_equal(top_g["count"], [[2, 1], [1, 1]])
    v, _ = port_plan.apply_top_k(
        np.array([1, 2], dtype=np.uint64),
        {"count": np.ones((2, 1), np.float32),
         "min": np.array([[4.0], [2.0]], np.float32)},
        port_plan.TopKSpec(k=1, by="min", largest=False))
    assert v.tolist() == [2]
    with pytest.raises(Error, match="top-k"):
        port_plan.apply_top_k(values, grids, port_plan.TopKSpec(k=1,
                                                                by="avg"))


@pytest.mark.parametrize("largest", [True, False])
def test_rank_top_k_matches_reference(largest):
    rng = np.random.default_rng(5)
    rows = sorted(rng.choice(200, size=60, replace=False).tolist())
    scores = rng.integers(0, 6, 60).astype(np.float64).tolist()
    for k in (1, 5, 60, 70):
        assert port_combine.rank_top_k(
            rows, scores, port_plan.TopKSpec(k, "max", largest)) == \
            ref_combine.rank_top_k(rows, scores,
                                   ref_plan.TopKSpec(k, "max", largest))


def test_top_k_requires_ranking_agg():
    with pytest.raises(Error, match="top-k"):
        port_combine.combine_top_k([], 4, ("avg",),
                                   port_plan.TopKSpec(k=2, by="max"))


def test_top_k_materialized_cells_bounded():
    rng = np.random.default_rng(7)
    num_buckets, k = 16, 3
    deltas = []
    for g in (40, 400):
        parts = _rand_parts(rng, num_buckets,
                            np.arange(1, g + 1, dtype=np.uint64), 4)
        before = port_combine._MATERIALIZED.value
        _values, grids = port_combine.combine_top_k(
            parts, num_buckets, ("avg", "max"),
            port_plan.TopKSpec(k=k, by="max"))
        deltas.append(port_combine._MATERIALIZED.value - before)
        assert len(next(iter(grids.values()))) <= k
    assert deltas[0] == deltas[1] == k * num_buckets * 3


def test_combine_top_k_empty_parts():
    got = port_combine.combine_top_k([], 5, ("max",),
                                     port_plan.TopKSpec(k=2, by="max"))
    want = ref_combine.combine_top_k([], 5, ("max",),
                                     ref_plan.TopKSpec(k=2, by="max"))
    _assert_bytes(got, want, "empty")


# ---- the facade: a small config-4 shape -----------------------------------

C4_SSTS, C4_ROWS, C4_HOSTS, C4_SPAN = 8, 5000, 100, 3_000_000
C4_T0 = (1_700_000_000_000 // 3_600_000) * 3_600_000
C4_SCHEMA = pa.schema([("host", pa.string()), ("ts", pa.int64()),
                       ("cpu", pa.float64())])


async def _config4(pkg: str, scan: dict, queries):
    """Write the config-4 shape through one package and run `queries`:
    (which, TopKSpec fields or None, combine mode)."""
    if pkg == "ref":
        cfgm, sto, read, plan, types, store = (ref_config, ref_storage,
                                               ref_read, ref_plan, ref_types,
                                               RefStore())
        kw = {}
    else:
        cfgm, sto, read, plan, types, store = (port_config, port_storage,
                                               port_read, port_plan,
                                               port_types,
                                               MemoryObjectStore())
        kw = {"device": "cpu"}
    cfg = cfgm.from_dict(cfgm.StorageConfig, {
        "scheduler": {"schedule_interval": "1h"}, "scan": scan})
    s = await sto.CloudObjectStorage.open("c4", 3_600_000, store, C4_SCHEMA,
                                          2, cfg, **kw)
    rng = np.random.default_rng(0)
    names = np.array([f"host_{i}" for i in range(C4_HOSTS)], dtype=object)
    out = []
    try:
        for _ in range(C4_SSTS):
            h = rng.integers(0, C4_HOSTS, C4_ROWS)
            ts = C4_T0 + rng.integers(0, C4_SPAN, C4_ROWS)
            v = rng.random(C4_ROWS) * 100
            batch = pa.record_batch(
                [pa.array(names[h]), pa.array(ts, type=pa.int64()),
                 pa.array(v, type=pa.float64())], schema=C4_SCHEMA)
            await s.write(sto.WriteRequest(batch, types.TimeRange.new(
                C4_T0, C4_T0 + C4_SPAN)))
        req = read.ScanRequest(range=types.TimeRange.new(C4_T0,
                                                         C4_T0 + C4_SPAN))
        for which, tk, mode in queries:
            spec = read.AggregateSpec(group_col="host", ts_col="ts",
                                      value_col="cpu", range_start=C4_T0,
                                      bucket_ms=C4_SPAN, num_buckets=1,
                                      which=which)
            s.config.scan.combine.mode = mode
            s.reader.scan_cache.clear()
            s.reader.parts_memo.clear()
            qp = await s.plan_query(req, spec=spec, top_k=None if tk is None
                                    else plan.TopKSpec(*tk))
            values, grids = await s.execute_plan(qp)
            out.append((np.asarray(values), {k: np.asarray(g)
                                             for k, g in grids.items()}))
    finally:
        await s.close()
    return out


C4_QUERIES = [(("max",), (10, "max", True), "sparse"),
              (("max",), (10, "max", True), "dense"),
              (("max",), None, "sparse"),
              (("min", "avg"), (7, "avg", False), "sparse"),
              (ALL_AGGS, (5, "last", True), "sparse"),
              (ALL_AGGS, (5, "count", False), "dense")]
C4_SCANS = {"host decode": {"decode": {"mode": "host"}},
            "device decode": {"decode": {"mode": "device"}},
            "device decode, streamed": {"decode": {"mode": "device"},
                                        "stream_read_min_rows": 4096,
                                        "max_window_rows": 2048}}


def _contract(got, want, ctx):
    """The reference's contract: group values and count/min/max/last/
    last_ts byte for byte, sum/avg within rtol 1e-5 (the partial grids'
    sums are the kernel's, not XLA's)."""
    assert got[0].tolist() == want[0].tolist(), ctx
    assert sorted(got[1]) == sorted(want[1]), ctx
    for k, w in want[1].items():
        g = got[1][k]
        assert g.dtype == w.dtype and g.shape == w.shape, (ctx, k)
        if k in ("sum", "avg"):
            np.testing.assert_allclose(g, w, rtol=1e-5, err_msg=ctx)
        else:
            assert g.tobytes() == w.tobytes(), (ctx, k)


@pytest.mark.parametrize("scan", sorted(C4_SCANS))
def test_config4_shape_matches_reference(monkeypatch, scan):
    monkeypatch.setenv("HORAEDB_FUSED_AGG", "0")
    # device decode runs its plain versions here: the first three queries
    queries = C4_QUERIES if scan == "host decode" else C4_QUERIES[:3]
    got = asyncio.run(_config4("port", C4_SCANS[scan], queries))
    want = asyncio.run(_config4("ref", C4_SCANS[scan], queries))
    for i, (g, w) in enumerate(zip(got, want)):
        _contract(g, w, f"{scan} query {i}")
    # the pushdown and the dense control agree byte for byte
    _assert_bytes(got[0], got[1], f"{scan}: pushdown vs dense")
    assert got[0][0].tolist()[:3] == sorted(
        got[2][0].tolist(), key=lambda h: -got[2][1]["max"][
            got[2][0].tolist().index(h), 0])[:3]


def test_config4_fused_shape_matches_reference(monkeypatch):
    monkeypatch.setenv("HORAEDB_FUSED_AGG", "1")
    queries = [(("max",), (10, "max", True), "sparse"),
               (ALL_AGGS, (4, "min", False), "sparse")]
    got = asyncio.run(_config4("port", {}, queries))
    want = asyncio.run(_config4("ref", {}, queries))
    for i, (g, w) in enumerate(zip(got, want)):
        _contract(g, w, f"fused query {i}")


def _plan_storage():
    cfg = port_config.from_dict(port_config.StorageConfig, {
        "scheduler": {"schedule_interval": "1h"}})
    return port_storage.CloudObjectStorage.open(
        "p", 3_600_000, MemoryObjectStore(), C4_SCHEMA, 2, cfg, device="cpu")


def test_plan_query_top_k_requires_aggregate():
    async def go():
        s = await _plan_storage()
        try:
            with pytest.raises(Error, match="top-k requires an aggregate"):
                await s.plan_query(
                    port_read.ScanRequest(range=port_types.TimeRange.new(
                        0, 2000)), top_k=port_plan.TopKSpec(k=1))
        finally:
            await s.close()

    asyncio.run(go())


def test_describe_renders_the_three_shapes():
    """tests/test_plan.py's golden text, on the port."""
    from horaedb_tpu_torch.ops.filter import Eq

    async def go():
        s = await _plan_storage()
        try:
            await s.write(port_storage.WriteRequest(pa.record_batch(
                [pa.array(["a", "b"]), pa.array([1000, 2000]),
                 pa.array([1.0, 2.0])], schema=C4_SCHEMA),
                port_types.TimeRange.new(1000, 2001)))
            req = port_read.ScanRequest(
                range=port_types.TimeRange.new(0, 10_000),
                predicate=Eq("host", "a"))
            spec = port_read.AggregateSpec(
                group_col="host", ts_col="ts", value_col="cpu",
                range_start=0, bucket_ms=1000, num_buckets=10,
                which=("avg", "max"))
            return (await s.plan_query(req), await s.plan_query(req, spec),
                    await s.plan_query(req, spec,
                                       port_plan.TopKSpec(k=3, by="max")))
        finally:
            await s.close()

    scan_qp, agg_qp, topk_qp = asyncio.run(go())
    fid = scan_qp.scan.segments[0].ssts[0].id
    scan_text = "\n".join([
        "MergeScan: mode=Overwrite, keep_builtin=False",
        "  Segment[start=0]: DeviceMergeDedup",
        "    Filter: Eq(column='host', value='a')",
        f"    ParquetScan: files=[{fid}.sst], "
        "columns=['host', 'ts', 'cpu', '__seq__'], pushdown=yes"])
    assert scan_qp.describe() == scan_text
    agg_text = ("Aggregate: group=host, ts=ts, value=cpu, bucket=1000ms, "
                "buckets=10, which=('avg', 'max')\n"
                + "\n".join("  " + ln for ln in scan_text.splitlines()))
    assert agg_qp.describe() == agg_text
    assert topk_qp.describe() == (
        "TopK: k=3, by=max, largest=True\n"
        + "\n".join("  " + ln for ln in agg_text.splitlines()))


# ---- the engine: query_topk on a small config-1 engine --------------------

TOPK_CASES = [(by, largest) for by in ("count", "sum", "min", "max", "avg",
                                       "last")
              for largest in (True, False)]


async def _engines():
    ref = await RefEngine.open("t", RefStore(), segment_ms=SEG)
    port = await PortEngine.open("t", MemoryObjectStore(), segment_ms=SEG,
                                 device="cpu")
    for b in _batches():
        await ref.write_arrow("cpu", ["host"], b)
        await port.write_arrow("cpu", ["host"], b)
    return ref, port


def _compare_topk(got, want, ctx, exact_sum):
    assert got["tsids"] == want["tsids"], ctx
    assert got["num_buckets"] == want["num_buckets"], ctx
    g, w = _numpy(got["aggs"]), _numpy(want["aggs"])
    assert sorted(g) == sorted(w), ctx
    for k in w:
        assert isinstance(got["aggs"][k], np.ndarray), (ctx, k)
        if k in ("sum", "avg") and not exact_sum:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=ctx)
        else:
            assert g[k].dtype == w[k].dtype, (ctx, k)
            assert g[k].tobytes() == w[k].tobytes(), (ctx, k)


def _same(a, b, ctx):
    _compare_topk(a, b, ctx, exact_sum=True)


@pytest.mark.parametrize("path", ["fused", "parts"])
def test_query_topk_matches_reference(monkeypatch, path):
    """Both packages on the same path (HORAEDB_FUSED_AGG); on the port
    also query_downsample + apply_top_k and (parts) the dense control,
    byte for byte."""
    monkeypatch.setenv("HORAEDB_FUSED_AGG", "1" if path == "fused" else "0")
    ranges = [(T0, END), (T0 + 123_456, END - 98_765)]

    async def run():
        ref, port = await _engines()
        try:
            for a, b in ranges:
                for by, largest in TOPK_CASES:
                    ctx = f"{path} {by} {largest} [{a}, {b})"
                    want = await ref.query_topk(
                        "cpu", [], ref_types.TimeRange.new(a, b), 60_000,
                        k=5, by=by, largest=largest)
                    got = await port.query_topk(
                        "cpu", [], port_types.TimeRange.new(a, b), 60_000,
                        k=5, by=by, largest=largest)
                    _compare_topk(got, want, ctx, exact_sum=False)
                    which = tuple(sorted(set(ALL_AGGS) | {by}))
                    full = await port.query_downsample(
                        "cpu", [], port_types.TimeRange.new(a, b), 60_000,
                        aggs=which)
                    v, grids = port_plan.apply_top_k(
                        np.asarray(full["tsids"], dtype=np.uint64),
                        full["aggs"], port_plan.TopKSpec(5, by, largest))
                    _same(got, {"tsids": [int(t) for t in v],
                                "num_buckets": full["num_buckets"],
                                "aggs": grids}, ctx)
                    if path == "parts":
                        data = port.tables["data"]
                        data.config.scan.combine.mode = "dense"
                        try:
                            dense = await port.query_topk(
                                "cpu", [], port_types.TimeRange.new(a, b),
                                60_000, k=5, by=by, largest=largest)
                        finally:
                            data.config.scan.combine.mode = "sparse"
                        _same(dense, got, ctx + " dense")
            # a filter, a subset of aggregates, k above the series count
            for filters, aggs, k in (([("host", "host_03")], ("avg",), 3),
                                     ([], ("max",), 40),
                                     ([("host", "nope")], ("avg",), 2)):
                want = await ref.query_topk(
                    "cpu", filters, ref_types.TimeRange.new(T0, END),
                    60_000, k=k, by="max", aggs=aggs)
                got = await port.query_topk(
                    "cpu", filters, port_types.TimeRange.new(T0, END),
                    60_000, k=k, by="max", aggs=aggs)
                _compare_topk(got, want, f"{path} {filters} {aggs}",
                              exact_sum=False)
        finally:
            await ref.close()
            await port.close()

    asyncio.run(run())


def test_query_topk_rejects_unknown_aggregate():
    async def run():
        port = await PortEngine.open("t", MemoryObjectStore(),
                                     segment_ms=SEG, device="cpu")
        try:
            with pytest.raises(Error, match="unknown top-k aggregate"):
                await port.query_topk("cpu", [],
                                      port_types.TimeRange.new(T0, END),
                                      60_000, k=3, by="median")
        finally:
            await port.close()

    asyncio.run(run())


def test_parts_topk_materializes_k_rows(monkeypatch):
    monkeypatch.setenv("HORAEDB_FUSED_AGG", "0")

    async def run():
        _ref, port = await _engines()
        await _ref.close()
        try:
            m0 = port_combine._MATERIALIZED.value
            out = await port.query_topk("cpu", [],
                                        port_types.TimeRange.new(T0, END),
                                        60_000, k=3, by="max",
                                        aggs=("max",))
            assert len(out["tsids"]) == 3
            assert port_combine._MATERIALIZED.value - m0 == \
                3 * out["num_buckets"] * len(out["aggs"])
        finally:
            await port.close()

    asyncio.run(run())


def test_ops_package_exports_top_k():
    from horaedb_tpu_torch import ops

    for name in ("top_k_groups", "two_sum", "pair_add",
                 "pair_max_normalized"):
        assert getattr(ops, name) is getattr(topk, name)
    assert os.path.basename(topk.__file__) == "topk.py"
