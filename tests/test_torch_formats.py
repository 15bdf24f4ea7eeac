"""On-disk formats of the port are the JAX package's, byte for byte:
sidecar blobs, manifest delta and snapshot codecs, and the parquet SST
layout; and the port reads a store the JAX package wrote, giving the
same aggregate grids and rows."""

import asyncio

import numpy as np
import pyarrow as pa
import pytest

from horaedb_tpu.storage import parquet_io as ref_pq
from horaedb_tpu.storage import sidecar as ref_sidecar
from horaedb_tpu.storage.config import StorageConfig as RefConfig
from horaedb_tpu.storage.config import UpdateMode as RefMode
from horaedb_tpu.storage.config import from_dict as ref_from_dict
from horaedb_tpu.storage.manifest import encoding as ref_menc
from horaedb_tpu.storage.sst import FileMeta as RefMeta, SstFile as RefSst
from horaedb_tpu.storage.types import StorageSchema as RefSchema
from horaedb_tpu.storage.types import TimeRange as RefRange
from horaedb_tpu_torch.storage import parquet_io as port_pq
from horaedb_tpu_torch.storage import sidecar as port_sidecar
from horaedb_tpu_torch.storage.config import StorageConfig as PortConfig
from horaedb_tpu_torch.storage.config import UpdateMode as PortMode
from horaedb_tpu_torch.storage.manifest import encoding as port_menc
from horaedb_tpu_torch.storage.sst import FileMeta as PortMeta, SstFile as PortSst
from horaedb_tpu_torch.storage.types import StorageSchema as PortSchema
from horaedb_tpu_torch.storage.types import TimeRange as PortRange

DATA_SCHEMA = pa.schema([
    ("metric_id", pa.uint64()), ("tsid", pa.uint64()),
    ("field_id", pa.uint64()), ("timestamp", pa.int64()),
    ("value", pa.float64()),
])
TAGS_SCHEMA = pa.schema([
    ("metric_id", pa.uint64()), ("tag_key", pa.string()),
    ("tag_value", pa.string()), ("exists", pa.int32()),
])


def _data_batch(seed: int, n: int = 3000) -> pa.RecordBatch:
    rng = np.random.default_rng(seed)
    tsid = np.sort(rng.integers(1, 2**62, 12).astype(np.uint64))
    return pa.record_batch([
        pa.array(np.full(n, 77, dtype=np.uint64)),
        pa.array(tsid[rng.integers(0, 12, n)]),
        pa.array(np.full(n, 5, dtype=np.uint64)),
        pa.array(1_700_000_000_000 + rng.integers(0, 7_200_000, n)),
        pa.array(rng.random(n) * 1e6 - 5e5),
    ], schema=DATA_SCHEMA)


def _tags_batch() -> pa.RecordBatch:
    keys = ["host", "dc", "host", "rack", "dc"]
    vals = ["h1", "eu-1", "h2", "r9", "us-2"]
    return pa.record_batch([
        pa.array([3, 3, 3, 4, 4], type=pa.uint64()), pa.array(keys),
        pa.array(vals), pa.array([1] * 5, type=pa.int32())],
        schema=TAGS_SCHEMA)


def _stamped(schema_cls, mode, user_schema, num_pks, batch, seq):
    import pyarrow.compute as pc

    schema = schema_cls.try_new(user_schema, num_pks, mode)
    keys = [(n, "ascending") for n in schema.primary_key_names]
    return schema, schema.fill_builtin_columns(
        batch.take(pc.sort_indices(batch, sort_keys=keys)), sequence=seq)


@pytest.mark.parametrize("which", ["data", "tags"])
def test_sidecar_and_sst_bytes_match_reference(which):
    user, pks, batch = ((DATA_SCHEMA, 4, _data_batch(1)) if which == "data"
                        else (TAGS_SCHEMA, 3, _tags_batch()))
    r_schema, r_stamped = _stamped(RefSchema, RefMode.OVERWRITE, user, pks,
                                   batch, 123456789)
    p_schema, p_stamped = _stamped(PortSchema, PortMode.OVERWRITE, user, pks,
                                   batch, 123456789)
    assert r_stamped.equals(p_stamped)
    ref_blob = ref_sidecar.build(r_stamped)
    port_blob = port_sidecar.build(p_stamped)
    assert ref_blob is not None and port_blob == ref_blob
    # and the port decodes the reference's blob into the same columns
    cols, n = port_sidecar.deserialize(ref_blob)
    ref_cols, ref_n = ref_sidecar.deserialize(ref_blob)
    assert n == ref_n == batch.num_rows
    for name, (arr, enc) in ref_cols.items():
        np.testing.assert_array_equal(cols[name][0], arr)
        assert cols[name][1].kind == enc.kind
        assert cols[name][1].epoch == enc.epoch
    ref_sst = ref_pq.encode_sst([r_stamped], RefConfig().write, r_schema)
    port_sst = port_pq.encode_sst([p_stamped], PortConfig().write, p_schema)
    assert port_sst == ref_sst


def test_manifest_bytes_match_reference():
    specs = [(11, 3, 100, 4096, 0, 7_200_000),
             (2**63 + 5, 2**32 - 1, 2**32 - 1, 1, -5_000, 9_000),
             (42, 0, 0, 0, 0, 0)]
    ref_files = [RefSst(i, RefMeta(max_sequence=seq, num_rows=rows, size=sz,
                                   time_range=RefRange.new(a, b)))
                 for i, seq, rows, sz, a, b in specs]
    port_files = [PortSst(i, PortMeta(max_sequence=seq, num_rows=rows,
                                      size=sz,
                                      time_range=PortRange.new(a, b)))
                  for i, seq, rows, sz, a, b in specs]
    for dels in ([], [7, 2**64 - 1, 300]):
        ref_delta = ref_menc.encode_manifest_update(
            ref_menc.ManifestUpdate(to_adds=ref_files, to_deletes=dels))
        port_delta = port_menc.encode_manifest_update(
            port_menc.ManifestUpdate(to_adds=port_files, to_deletes=dels))
        assert port_delta == ref_delta
        back = port_menc.decode_manifest_update(ref_delta)
        assert [f.id for f in back.to_adds] == [s[0] for s in specs]
        assert back.to_deletes == dels
    ref_snap = ref_menc.Snapshot()
    ref_snap.add_records(ref_files)
    ref_snap.delete_records([42])
    port_snap = port_menc.Snapshot()
    port_snap.add_records(port_files)
    port_snap.delete_records([42])
    assert port_snap.into_bytes() == ref_snap.into_bytes()
    assert port_menc.Snapshot().into_bytes() == ref_menc.Snapshot().into_bytes()
    got = port_menc.Snapshot.from_bytes(ref_snap.into_bytes()).into_ssts()
    assert [(f.id, f.meta.num_rows, f.meta.size) for f in got] == \
        [(s[0], s[2], s[3]) for s in specs[:2]]


@pytest.mark.parametrize("enable_sidecar", [True, False])
def test_port_reads_a_store_written_by_the_reference(tmp_path, monkeypatch,
                                                     enable_sidecar):
    """The reference writes SSTs (two overlapping writes in one segment,
    so dedup matters) to a local store; the port opens the same
    directory and serves the same rows and the same aggregate grids —
    from sidecars, or from parquet when the writer kept none."""
    import torch

    from horaedb_tpu.objstore import LocalObjectStore as RefLocal
    from horaedb_tpu.ops import And as RAnd, Eq as REq
    from horaedb_tpu.storage.read import AggregateSpec as RSpec
    from horaedb_tpu.storage.read import ScanRequest as RReq
    from horaedb_tpu.storage.storage import (CloudObjectStorage as RStore,
                                             WriteRequest as RWrite)
    from horaedb_tpu_torch.objstore import LocalObjectStore as PortLocal
    from horaedb_tpu_torch.ops import And as PAnd, Eq as PEq
    from horaedb_tpu_torch.storage.read import AggregateSpec as PSpec
    from horaedb_tpu_torch.storage.read import ScanRequest as PReq
    from horaedb_tpu_torch.storage.storage import CloudObjectStorage as PStore

    monkeypatch.setenv("HORAEDB_FUSED_AGG", "1")
    seg = 2 * 3600 * 1000
    t0 = (1_700_000_000_000 // seg) * seg
    rng = np.random.default_rng(5)
    tsids = np.array([101, 202, 303, 404], dtype=np.uint64)

    def batch(lo, hi, bump):
        n = hi - lo
        ts = t0 + np.arange(lo, hi, dtype=np.int64) * 7_000 % (2 * seg)
        return pa.record_batch([
            pa.array(np.full(n, 9, dtype=np.uint64)),
            pa.array(tsids[np.arange(lo, hi) % 4]),
            pa.array(np.full(n, 1, dtype=np.uint64)),
            pa.array(ts),
            pa.array(rng.random(n) * 10 + bump),
        ], schema=DATA_SCHEMA)

    ref_cfg = ref_from_dict(RefConfig, {
        "write": {"enable_sidecar": enable_sidecar},
        "scheduler": {"schedule_interval": "1h"}})
    pred_r = RAnd([REq("metric_id", 9), REq("field_id", 1)])
    pred_p = PAnd([PEq("metric_id", 9), PEq("field_id", 1)])
    rng_all = (t0, t0 + 2 * seg)
    spec_kw = dict(group_col="tsid", ts_col="timestamp", value_col="value",
                   range_start=t0, bucket_ms=60_000,
                   num_buckets=2 * seg // 60_000,
                   which=("count", "sum", "min", "max", "avg", "last"))

    async def write_and_query_ref():
        st = await RStore.open("db/data", seg, RefLocal(str(tmp_path)),
                               DATA_SCHEMA, 4, ref_cfg)
        try:
            for lo, hi, bump in ((0, 900, 0.0), (400, 1300, 100.0)):
                b = batch(lo, hi, bump)
                for s in sorted({int(x) // seg * seg
                                 for x in b.column(3).to_numpy()}):
                    m = (b.column(3).to_numpy() // seg * seg) == s
                    part = b.filter(pa.array(m))
                    tsv = part.column(3).to_numpy()
                    await st.write(RWrite(part, RefRange.new(
                        int(tsv.min()), int(tsv.max()) + 1)))
            rows = pa.Table.from_batches([x async for x in st.scan(
                RReq(range=RefRange.new(*rng_all), predicate=pred_r))])
            vals, grids = await st.scan_aggregate(
                RReq(range=RefRange.new(*rng_all), predicate=pred_r),
                RSpec(**spec_kw))
            return rows, np.asarray(vals), {k: np.asarray(v)
                                            for k, v in grids.items()}
        finally:
            await st.close()

    async def query_port():
        st = await PStore.open("db/data", seg, PortLocal(str(tmp_path)),
                               DATA_SCHEMA, 4, PortConfig(), device="cpu")
        try:
            rows = pa.Table.from_batches([x async for x in st.scan(
                PReq(range=PortRange.new(*rng_all), predicate=pred_p))])
            vals, grids = await st.scan_aggregate(
                PReq(range=PortRange.new(*rng_all), predicate=pred_p),
                PSpec(**spec_kw))
            used_sidecar = not st.reader._sidecar_missing
            return rows, vals, {k: (v if isinstance(v, np.ndarray)
                                    else v.numpy()) for k, v in grids.items()
                                }, used_sidecar
        finally:
            await st.close()

    r_rows, r_vals, r_grids = asyncio.run(write_and_query_ref())
    p_rows, p_vals, p_grids, used_sidecar = asyncio.run(query_port())
    assert used_sidecar == enable_sidecar
    assert p_rows.equals(r_rows)
    np.testing.assert_array_equal(p_vals, r_vals)
    assert sorted(p_grids) == sorted(r_grids)
    for k in r_grids:
        if k in ("sum", "avg"):
            np.testing.assert_allclose(p_grids[k], r_grids[k], rtol=1e-5)
        else:
            np.testing.assert_array_equal(p_grids[k], r_grids[k], err_msg=k)
    assert torch.is_tensor(torch.as_tensor(p_grids["count"]))
