"""The pruned and streamed reads of the port (horaedb_tpu_torch/storage/
sidecar.py, parquet_io.py, read.py) against the JAX package's, on the
same seeded inputs, the port on the CPU.

- Block pruning (tests/test_sidecar.py TestBlockPruning): a sidecar load
  with leaves fetches the same byte ranges as the JAX package's and
  returns the same rows, which after the exact leaf mask equal a full
  load's.
- Stats pruning (tests/test_storage.py TestPrunedRead): read_pruned keeps
  exactly the rows of the JAX package's read_pruned and of
  pq.read_table(filters=...), across group-pruning, residual,
  constant-elision, NaN and null shapes; conjunct_leaves agrees.
- Streamed against bulk: the sidecar stream and the parquet streamer
  (tests/test_sidecar.py TestStreamedSidecar, tests/test_storage.py
  TestStreamedRead) give the bulk read's rows and grids, byte for byte
  in the port, and the reference's; the planned windows are the
  reference's.  The mesh and Append cases are left out (the port has
  no scan mesh and serves OVERWRITE tables only)."""

import asyncio
import io
import types

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pyarrow.parquet as pq
import pytest

import horaedb_tpu.metric_engine as ref_engine
import horaedb_tpu.objstore as ref_objstore
import horaedb_tpu.ops.filter as ref_filter
import horaedb_tpu.storage.config as ref_config
import horaedb_tpu.storage.parquet_io as ref_pio
import horaedb_tpu.storage.read as ref_read
import horaedb_tpu.storage.sidecar as ref_sidecar
import horaedb_tpu.storage.storage as ref_storage
import horaedb_tpu.storage.types as ref_types
import horaedb_tpu_torch.metric_engine as port_engine
import horaedb_tpu_torch.objstore as port_objstore
import horaedb_tpu_torch.ops.filter as port_filter
import horaedb_tpu_torch.storage.config as port_config
import horaedb_tpu_torch.storage.parquet_io as port_pio
import horaedb_tpu_torch.storage.read as port_read
import horaedb_tpu_torch.storage.sidecar as port_sidecar
import horaedb_tpu_torch.storage.storage as port_storage
import horaedb_tpu_torch.storage.types as port_types

HOUR = 3_600_000
T0 = 1_700_000_000_000 - 1_700_000_000_000 % (2 * HOUR)
SEGMENT_MS = 3_600_000


def _package(engine, objstore, filt, config, pio, read, sidecar, storage,
             types_, open_kw):
    return types.SimpleNamespace(
        MetricEngine=engine.MetricEngine,
        MemoryObjectStore=objstore.MemoryObjectStore, F=filt,
        StorageConfig=config.StorageConfig, from_dict=config.from_dict,
        pio=pio, read=read, sidecar=sidecar,
        CloudObjectStorage=storage.CloudObjectStorage,
        WriteRequest=storage.WriteRequest, ScanRequest=read.ScanRequest,
        TimeRange=types_.TimeRange, open_kw=open_kw)


REF = _package(ref_engine, ref_objstore, ref_filter, ref_config, ref_pio,
               ref_read, ref_sidecar, ref_storage, ref_types, {})
PORT = _package(port_engine, port_objstore, port_filter, port_config,
                port_pio, port_read, port_sidecar, port_storage, port_types,
                {"device": "cpu"})
BOTH = {"ref": REF, "port": PORT}


def run(coro):
    return asyncio.run(coro)


def np_grids(out) -> dict:
    return {k: np.asarray(v) for k, v in out["aggs"].items()}


def assert_grids_match_reference(ref: dict, port: dict):
    assert port["tsids"] == ref["tsids"]
    r, p = np_grids(ref), np_grids(port)
    assert sorted(p) == sorted(r)
    for k in r:
        if k in ("sum", "avg"):
            np.testing.assert_allclose(p[k], r[k], rtol=1e-5, err_msg=k)
        else:
            np.testing.assert_array_equal(p[k], r[k], err_msg=k)


def assert_same_bytes(a: dict, b: dict):
    assert a["tsids"] == b["tsids"]
    ga, gb = np_grids(a), np_grids(b)
    assert sorted(ga) == sorted(gb)
    for k in ga:
        assert ga[k].dtype == gb[k].dtype and \
            ga[k].tobytes() == gb[k].tobytes(), k


# ---------------------------------------------------------------------------
# block-pruned sidecar fetch
# ---------------------------------------------------------------------------


def _pruning_batch(n=450_000, groups=500):
    rng = np.random.default_rng(13)
    tsid = np.sort(rng.integers(0, 1 << 62, groups).astype(np.uint64)
                   [rng.integers(0, groups, n)])
    ts = T0 + np.arange(n, dtype=np.int64) % (4 * HOUR)
    order = np.lexsort((ts, tsid))
    return pa.record_batch({
        "tsid": pa.array(tsid[order], type=pa.uint64()),
        "timestamp": pa.array(np.sort(ts)[order] % (4 * HOUR) + T0,
                              type=pa.int64()),
        "value": pa.array(rng.random(n), type=pa.float64()),
        "__seq__": pa.array(np.full(n, 9, dtype=np.uint64)),
    })


@pytest.fixture(scope="module")
def pruning_blob():
    batch = _pruning_batch()
    blob = port_sidecar.build(batch)
    assert blob is not None and len(blob) > 1 << 20
    assert blob == ref_sidecar.build(batch)
    return batch, blob


def recording_store(P, blob):
    """The package's MemoryObjectStore holding one sidecar, logging every
    read: ("get",) or ("get_range", start, end)."""
    base = P.MemoryObjectStore

    class RecordingStore(base):
        def __init__(self):
            super().__init__()
            self.log = []

        async def get(self, path):
            self.log.append(("get",))
            return await base.get(self, path)

        async def get_range(self, path, start, end):
            self.log.append(("get_range", start, end))
            return (await base.get(self, path))[start:end]

    store = RecordingStore()
    run(base.put(store, "s/data/1.enc", blob))
    return store


WANT = {"tsid", "timestamp", "value", "__seq__"}
COLS = ["tsid", "timestamp", "value", "__seq__"]


def _leaves(P, case, batch):
    F = P.F
    if case == "point":
        return [F.In("tsid", [int(batch.column("tsid")[len(batch) // 2]
                                  .as_py())])]
    if case == "unselective":
        return [F.Ge("timestamp", T0)]
    if case == "absent":
        return [F.Eq("tsid", 12345)]
    if case == "range":
        lo = int(batch.column("tsid")[len(batch) // 4].as_py())
        hi = int(batch.column("tsid")[len(batch) // 3].as_py())
        return [F.Ge("tsid", lo), F.Lt("tsid", hi)]
    return []


def _decoded(es) -> dict:
    out = {}
    for nm in es.names:
        a, e = es.columns[nm], es.encodings[nm]
        if e.kind == "dict":
            out[nm] = e.dictionary[a]
        elif e.kind == "offset":
            out[nm] = a.astype(np.int64) + e.epoch
        else:
            out[nm] = a
    return out


@pytest.mark.parametrize("case", ["point", "unselective", "absent",
                                  "range", "none"])
def test_block_pruned_load_matches_reference(pruning_blob, case):
    batch, blob = pruning_blob
    got = {}
    for name, P in BOTH.items():
        store = recording_store(P, blob)
        leaves = _leaves(P, case, batch)
        part = run(P.sidecar.load_sst_encoded(store, "s/data/1.enc", WANT,
                                              leaves))
        assert part is not None
        pruned = P.sidecar.assemble_parts([part], COLS, leaves)
        full = P.sidecar.assemble_parts([P.sidecar.deserialize(blob)],
                                        COLS, leaves)
        dp, df = _decoded(pruned), _decoded(full)
        for nm in COLS:
            np.testing.assert_array_equal(dp[nm], df[nm], err_msg=nm)
        got[name] = (store.log, part[1], pruned.n, dp)
    (rlog, rn, rkept, rcols), (plog, pn, pkept, pcols) = \
        got["ref"], got["port"]
    assert plog == rlog
    assert (pn, pkept) == (rn, rkept)
    for nm in COLS:
        np.testing.assert_array_equal(pcols[nm], rcols[nm], err_msg=nm)
    full_gets = sum(1 for op in plog if op[0] == "get")
    range_bytes = sum(op[2] - op[1] for op in plog if op[0] == "get_range")
    if case in ("point", "absent"):
        # a point query never downloads the whole object
        assert full_gets == 0 and range_bytes < len(blob) // 2
        assert pn < batch.num_rows
    if case == "absent":
        assert pn == 0 and pkept == 0
    if case in ("unselective", "none"):
        assert full_gets == 1 and pn == batch.num_rows


@pytest.mark.parametrize("leaf", ["eq", "in", "lt", "le", "gt", "ge",
                                  "range", "other"])
def test_block_mask_for_leaf_matches_reference(leaf):
    rng = np.random.default_rng(5)
    mins = np.sort(rng.integers(0, 1000, 40)).astype(np.int32)
    maxs = (mins + rng.integers(0, 60, 40)).astype(np.int32)
    out = []
    for P in (REF, PORT):
        F = P.F
        enc = P.sidecar.encode.ColumnEncoding("offset", pa.int64(),
                                              epoch=100)
        leaf_obj = {"eq": F.Eq("c", 600), "in": F.In("c", [150, 700, 5]),
                    "lt": F.Lt("c", 400), "le": F.Le("c", 400),
                    "gt": F.Gt("c", 800), "ge": F.Ge("c", 800),
                    "range": F.TimeRangePred("c", 300, 900),
                    "other": F.Ne("c", 3)}[leaf]
        out.append(P.sidecar._block_mask_for_leaf(leaf_obj, enc, mins,
                                                  maxs))
    if leaf == "other":
        assert out == [None, None]
    else:
        np.testing.assert_array_equal(out[1], out[0])
        assert 0 < out[1].sum() < len(mins)


# ---------------------------------------------------------------------------
# stats-pruned parquet decode
# ---------------------------------------------------------------------------


def _parquet_file(nulls=False):
    n = 3000
    mid = np.full(n, 42, dtype=np.uint64)
    tsid = np.sort(np.random.default_rng(0).integers(
        0, 1 << 40, 7).astype(np.uint64).repeat(n // 7 + 1)[:n])
    ts = np.tile(np.arange(n // 10, dtype=np.int64) * 1000, 10)[:n]
    val = np.random.default_rng(1).random(n)
    if nulls:
        ts_arr = pa.array([None if i == 17 else int(t)
                           for i, t in enumerate(ts)], type=pa.int64())
    else:
        ts_arr = pa.array(ts, type=pa.int64())
    tbl = pa.table({"metric_id": pa.array(mid), "tsid": pa.array(tsid),
                    "timestamp": ts_arr,
                    "value": pa.array(val, type=pa.float64())})
    sink = io.BytesIO()
    pq.write_table(tbl, sink, row_group_size=256, compression="snappy",
                   write_statistics=True)
    return sink.getvalue()


def _nan_file():
    """A constant float column with NaNs among it: parquet min/max
    statistics ignore NaN, so neither constant elision nor a 'full'
    verdict may trust float stats."""
    n = 2000
    val = np.ones(n)
    val[::37] = np.nan
    tbl = pa.table({"metric_id": pa.array(np.full(n, 42, dtype=np.uint64)),
                    "timestamp": pa.array(np.arange(n, dtype=np.int64)
                                          * 1000, type=pa.int64()),
                    "value": pa.array(val, type=pa.float64())})
    sink = io.BytesIO()
    pq.write_table(tbl, sink, row_group_size=256, compression="snappy",
                   write_statistics=True)
    return sink.getvalue()


def _read_pruned(P, data, columns, leaves):
    pf = pq.ParquetFile(pa.BufferReader(data))
    try:
        return P.pio.read_pruned(pf, columns, leaves)
    finally:
        pf.close()


def _pruned_case(P, shape):
    F = P.F
    cols = ["metric_id", "tsid", "timestamp", "value"]
    cases = {
        "range": (cols, [F.TimeRangePred("timestamp", 50_000, 150_000)],
                  (pc.field("timestamp") >= 50_000)
                  & (pc.field("timestamp") < 150_000)),
        "eq_const": (cols, [F.Eq("metric_id", 42),
                            F.TimeRangePred("timestamp", 0, 100_000)],
                     (pc.field("metric_id") == 42)
                     & (pc.field("timestamp") >= 0)
                     & (pc.field("timestamp") < 100_000)),
        "eq_tsid": (cols, [F.Eq("metric_id", 42)],
                    pc.field("metric_id") == 42),
        "in": (cols, [F.In("tsid", frozenset([1, 2]))],
               pc.field("tsid").isin([1, 2])),
        "empty": (cols, [F.Eq("metric_id", 7)], pc.field("metric_id") == 7),
        "all": (cols, [F.Ge("timestamp", 0)], pc.field("timestamp") >= 0),
        "gt": (cols, [F.Lt("timestamp", 1234)],
               pc.field("timestamp") < 1234),
        "elided": (["metric_id"], [F.Eq("metric_id", 42)],
                   pc.field("metric_id") == 42),
        "elided_residual": (
            ["metric_id"], [F.Eq("metric_id", 42),
                            F.TimeRangePred("timestamp", 30_000, 200_000)],
            (pc.field("metric_id") == 42)
            & (pc.field("timestamp") >= 30_000)
            & (pc.field("timestamp") < 200_000)),
        "nan_elide": (["timestamp", "value"],
                      [F.Eq("metric_id", 42),
                       F.TimeRangePred("timestamp", 0, 500_000)],
                      (pc.field("metric_id") == 42)
                      & (pc.field("timestamp") >= 0)
                      & (pc.field("timestamp") < 500_000)),
        "nan_full": (["timestamp", "value"], [F.Gt("value", 0.5)],
                     pc.field("value") > 0.5),
    }
    return cases[shape]


@pytest.mark.parametrize("shape", ["range", "eq_const", "eq_tsid", "in",
                                   "empty", "all", "gt", "elided",
                                   "elided_residual", "nan_elide",
                                   "nan_full"])
def test_read_pruned_matches_reference_and_expression_path(shape):
    data = _nan_file() if shape.startswith("nan") else _parquet_file()
    cols, leaves, expr = _pruned_case(PORT, shape)
    port = _read_pruned(PORT, data, cols, leaves)
    ref = _read_pruned(REF, data, cols, _pruned_case(REF, shape)[1])
    want = pq.read_table(pa.BufferReader(data), columns=cols, filters=expr)
    assert port.schema == ref.schema
    assert port.schema.names == want.schema.names == cols
    assert port.num_rows == ref.num_rows == want.num_rows
    key = "timestamp" if "timestamp" in cols else cols[0]
    for c in cols:
        # assert_array_equal holds NaN equal to NaN; Table.equals does not
        np.testing.assert_array_equal(port.column(c).to_numpy(),
                                      ref.column(c).to_numpy(), err_msg=c)
        np.testing.assert_array_equal(
            port.sort_by(key).column(c).to_numpy(),
            want.sort_by(key).column(c).cast(port.schema.field(c).type)
            .to_numpy(), err_msg=c)
    if shape == "elided":
        assert port.num_rows == 3000
    if shape == "nan_elide":
        assert np.isnan(port.column("value").to_numpy()).sum() > 0
    if shape == "nan_full":
        assert port.num_rows > 0
        assert not np.isnan(port.column("value").to_numpy()).any()


def test_nulls_in_predicate_column_fall_back():
    data = _parquet_file(nulls=True)
    for P in (REF, PORT):
        with pytest.raises(P.pio._PruneUnsupported):
            _read_pruned(P, data, None,
                         [P.F.TimeRangePred("timestamp", 0, 10_000)])


@pytest.mark.parametrize("shape", ["none", "value_only", "mixed", "or",
                                   "ne"])
def test_conjunct_leaves_shapes(shape):
    pks = {"metric_id", "timestamp"}
    got = []
    for P in (REF, PORT):
        F = P.F
        pred = {"none": None, "value_only": F.Eq("value", 1.0),
                "mixed": F.And((F.Eq("metric_id", 1), F.Eq("value", 2.0),
                                F.TimeRangePred("timestamp", 0, 10))),
                "or": F.Or((F.Eq("metric_id", 1), F.Eq("metric_id", 2))),
                "ne": F.Ne("metric_id", 1)}[shape]
        leaves = P.pio.conjunct_leaves(pred, pks)
        got.append(None if leaves is None else
                   [(type(lf).__name__, lf.column) for lf in leaves])
    assert got[1] == got[0]
    assert (got[1] is not None) == (shape == "mixed")


@pytest.mark.parametrize("store_kind", ["memory", "mapped"])
def test_read_sst_leaves_and_mapped_fetch(tmp_path, monkeypatch, store_kind):
    """read_sst(leaves=, size_hint=): the stats-pruned decode gives the
    expression path's rows, and an object at or above the stream-fetch
    size decodes from a file-backed mmap to the same table."""
    data = _parquet_file()
    store = PORT.MemoryObjectStore()
    run(store.put("x.sst", data))
    if store_kind == "mapped":
        monkeypatch.setattr(port_pio, "STREAM_FETCH_MIN_BYTES", 1)
    leaves = [PORT.F.TimeRangePred("timestamp", 50_000, 150_000)]
    expr = (pc.field("timestamp") >= 50_000) \
        & (pc.field("timestamp") < 150_000)
    got = run(port_pio.read_sst(store, "x.sst", leaves=leaves,
                                filters=expr, size_hint=len(data)))
    want = pq.read_table(pa.BufferReader(data), filters=expr)
    assert got.sort_by("timestamp").equals(want.sort_by("timestamp"))


# ---------------------------------------------------------------------------
# streamed segments against the bulk read
# ---------------------------------------------------------------------------


def _big_segment_batches():
    rng = np.random.default_rng(42)
    out = []
    for _ in range(4):
        h = rng.integers(0, 40, 1500)
        out.append(pa.record_batch(
            [pa.array([f"host_{int(i):02d}" for i in h]),
             pa.array(rng.integers(0, SEGMENT_MS, 1500), type=pa.int64()),
             pa.array(rng.random(1500) * 10, type=pa.float64())],
            schema=pa.schema([("host", pa.string()), ("ts", pa.int64()),
                              ("cpu", pa.float64())])))
    return out


def _storage_rows(P, cfg_scan, spy=None):
    """The rows of a 4-SST segment read by CloudObjectStorage under
    `cfg_scan`; `spy` collects the row count of every window the
    parquet streamer merges."""

    async def go():
        cfg = P.from_dict(P.StorageConfig, {
            "scan": cfg_scan, "scheduler": {"schedule_interval": "1h"}})
        batches = _big_segment_batches()
        s = await P.CloudObjectStorage.open(
            "db", SEGMENT_MS, P.MemoryObjectStore(), batches[0].schema,
            2, cfg, **P.open_kw)
        try:
            if spy is not None:
                name = ("_merge_batch" if P is PORT
                        else "_dispatch_merged_windows")
                inner = getattr(s.reader, name)

                def spying(batch):
                    spy.append(batch.num_rows)
                    return inner(batch)

                setattr(s.reader, name, spying)
            for b in batches:
                await s.write(P.WriteRequest(b, P.TimeRange.new(
                    0, SEGMENT_MS)))
            s.reader.scan_cache.clear()
            s.reader.encoded_cache.clear()
            out = []
            async for b in s.scan(P.ScanRequest(
                    range=P.TimeRange.new(0, SEGMENT_MS))):
                out.extend(zip(*(c.to_pylist() for c in b.columns)))
            return sorted(out)
        finally:
            await s.close()

    return run(go())


@pytest.mark.parametrize("trigger", ["rows", "bytes"])
def test_parquet_streamer_equals_bulk(trigger):
    """The parquet two-pass streamer (sidecars off) keeps every window
    within the budget (one host's rows can't split) and returns the bulk
    read's rows, as the reference's does."""
    knobs = ({"stream_read_min_rows": 2000} if trigger == "rows" else
             {"stream_read_min_rows": 1 << 30,
              "stream_read_min_bytes": 4096})
    got = {}
    for name, P in BOTH.items():
        spy: list = []
        streamed = _storage_rows(P, {**knobs, "max_window_rows": 1024,
                                     "use_sidecar": False}, spy=spy)
        bulk = _storage_rows(P, {"stream_read_min_rows": 0,
                                 "max_window_rows": 1 << 20})
        assert streamed == bulk and streamed
        assert spy and max(spy) <= 1024 + 600, spy
        got[name] = (streamed, spy)
    assert got["port"] == got["ref"]


def test_sidecar_stream_equals_bulk_rows():
    """Sidecars on: the segment streams from sidecar value-range windows
    and returns the bulk read's rows; the parquet streamer is not
    touched."""
    for P in (REF, PORT):
        spy: list = []
        side0 = P.read._STAGE_ROWS["sidecar_read"].value
        streamed = _storage_rows(P, {"stream_read_min_rows": 2000,
                                     "max_window_rows": 1024}, spy=spy)
        assert P.read._STAGE_ROWS["sidecar_read"].value > side0
        assert not spy
        assert streamed == _storage_rows(P, {"stream_read_min_rows": 0})


def _engine_run(P, cfg_d, mutate=None, bulk_too=False):
    """Two overlapping writes of one 2 h segment through a MetricEngine,
    reopened under `cfg_d`: a downsample and a raw query of one host
    (the streamed-sidecar scenario of tests/test_sidecar.py)."""

    async def query(e):
        out = await e.query_downsample(
            "cpu", [], P.TimeRange.new(T0, T0 + 2 * HOUR),
            bucket_ms=600_000)
        rows = await e.query("cpu", [("host", "h07")],
                             P.TimeRange.new(T0, T0 + HOUR))
        return out, rows.sort_by([("tsid", "ascending"),
                                  ("timestamp", "ascending")])

    async def go():
        rng = np.random.default_rng(17)
        n, hosts = 30_000, 20
        names = np.array([f"h{i:02d}" for i in range(hosts)], dtype=object)
        batch = pa.record_batch({
            "host": pa.array(names[rng.integers(0, hosts, n)]),
            "timestamp": pa.array(T0 + rng.integers(0, 2 * HOUR - 1, n),
                                  type=pa.int64()),
            "value": pa.array(rng.random(n) * 9, type=pa.float64()),
        })
        store = P.MemoryObjectStore()
        cfg = P.from_dict(P.StorageConfig, cfg_d)
        e = await P.MetricEngine.open("ss", store, segment_ms=2 * HOUR,
                                      config=cfg, **P.open_kw)
        try:
            # two overlapping writes: dedup must work ACROSS the
            # streamed windows' SST runs
            await e.write_arrow("cpu", ["host"], batch)
            await e.write_arrow("cpu", ["host"], batch.slice(0, 9000))
        finally:
            await e.close()
        if mutate is not None:
            await mutate(store)
        e = await P.MetricEngine.open("ss", store, segment_ms=2 * HOUR,
                                      config=cfg, **P.open_kw)
        try:
            side0 = P.read._STAGE_ROWS["sidecar_read"].value
            out, rows = await query(e)
            side = P.read._STAGE_ROWS["sidecar_read"].value - side0
            missing = e.tables["data"].reader.encoded_cache.stats()[
                "negative_entries"]
            bulk = None
            if bulk_too:
                # the same engine with streaming off: the bulk read
                for t in e.tables.values():
                    t.config.scan.stream_read_min_rows = 0
                    t.reader.scan_cache.clear()
                    t.reader.encoded_cache.clear()
                    t.reader.parts_memo.clear()
                bulk = await query(e)
            return out, rows, side, bulk, missing
        finally:
            await e.close()

    return run(go())


STREAM_CFG = {"stream_read_min_rows": 4096, "max_window_rows": 2048}


@pytest.mark.parametrize("fused", ["1", "0"], ids=["fused", "parts"])
def test_streamed_sidecar_matches_parquet_streamer_and_bulk(monkeypatch,
                                                            fused):
    """The sidecar stream serves the streamed segment (the parquet leg
    reads no sidecar); its grids and rows equal the parquet streamer's
    and, in the port, the bulk read's byte for byte; the port's equal
    the reference's."""
    monkeypatch.setenv("HORAEDB_FUSED_AGG", fused)
    got = {}
    for name, P in BOTH.items():
        a_out, a_rows, a_side, bulk, a_missing = _engine_run(
            P, {"scan": {**STREAM_CFG, "use_sidecar": True}},
            bulk_too=True)
        b_out, b_rows, b_side, _, _ = _engine_run(
            P, {"scan": {**STREAM_CFG, "use_sidecar": False}})
        assert a_side > 0 and b_side == 0 and a_missing == 0
        assert a_out["tsids"] == b_out["tsids"]
        for k in np_grids(a_out):
            np.testing.assert_array_equal(np_grids(a_out)[k],
                                          np_grids(b_out)[k], err_msg=k)
        assert a_rows.equals(b_rows) and a_rows.num_rows > 0
        assert bulk[1].equals(a_rows)
        if P is PORT:
            assert_same_bytes(a_out, bulk[0])
            assert_same_bytes(b_out, bulk[0])
        got[name] = (a_out, a_rows)
    assert_grids_match_reference(got["ref"][0], got["port"][0])
    assert got["port"][1].equals(got["ref"][1])


def test_streamed_falls_back_on_corrupt_sidecar():
    async def corrupt(store):
        for meta in await store.list("ss/data/data/"):
            if meta.path.endswith(".enc"):
                await store.put(meta.path, b"junk")

    a_out, a_rows, _, _, a_missing = _engine_run(
        PORT, {"scan": {**STREAM_CFG, "use_sidecar": True}}, mutate=corrupt)
    b_out, b_rows, _, _, _ = _engine_run(
        PORT, {"scan": {**STREAM_CFG, "use_sidecar": False}})
    r_out, r_rows, _, _, r_missing = _engine_run(
        REF, {"scan": {**STREAM_CFG, "use_sidecar": True}}, mutate=corrupt)
    # the data table memoized its corrupt sidecars and read parquet
    assert a_missing == r_missing > 0
    assert_same_bytes(a_out, b_out)
    assert a_rows.equals(b_rows)
    assert_grids_match_reference(r_out, a_out)
    assert a_rows.equals(r_rows)


def test_plan_stream_windows_matches_reference():
    """SstStreamSession + plan_stream_windows over the same sidecars
    give the reference's partition column and value ranges, and each
    window loads the same rows."""
    rng = np.random.default_rng(3)
    blobs = []
    for k in range(2):
        n = 150_000
        tsid = np.sort(rng.integers(0, 1 << 40, 300).astype(np.uint64)
                       [rng.integers(0, 300, n)])
        ts = T0 + rng.integers(0, HOUR, n).astype(np.int64)
        order = np.lexsort((ts, tsid))
        blobs.append(port_sidecar.build(pa.record_batch({
            "tsid": pa.array(tsid[order], type=pa.uint64()),
            "timestamp": pa.array(ts[order], type=pa.int64()),
            "value": pa.array(rng.random(n), type=pa.float64()),
            "__seq__": pa.array(np.full(n, k + 1, dtype=np.uint64)),
        })))

    async def go(P):
        store = P.MemoryObjectStore()
        for i, b in enumerate(blobs):
            await store.put(f"s/{i}.enc", b)
        sessions = [await P.sidecar.SstStreamSession.open(
            store, f"s/{i}.enc", WANT) for i in range(len(blobs))]
        col, ranges = await P.sidecar.plan_stream_windows(
            sessions, ["tsid", "timestamp"], 65536)
        loaded = []
        for lo, hi in ranges:
            leaves = []
            if lo is not None:
                leaves.append(P.F.Ge(col, lo))
            if hi is not None:
                leaves.append(P.F.Lt(col, hi))
            parts = [await s.load_window(leaves) for s in sessions]
            es = P.sidecar.assemble_parts(parts, COLS, leaves)
            loaded.append(_decoded(es))
        return col, ranges, loaded

    rcol, rranges, rloaded = run(go(REF))
    pcol, pranges, ploaded = run(go(PORT))
    assert (pcol, pranges) == (rcol, rranges) and len(pranges) > 2
    assert sum(len(w["tsid"]) for w in ploaded) == 300_000
    for pw, rw in zip(ploaded, rloaded):
        for nm in COLS:
            np.testing.assert_array_equal(pw[nm], rw[nm], err_msg=nm)
