"""The PyTorch port's S3 object store (horaedb_tpu_torch/objstore/s3.py)
against the JAX package's, on the CPU.

tests/test_s3.py's scenarios run on the port's store through that
file's SigV4-verifying fake (imported, not edited): its twelve store
scenarios by pointing the file's store classes at the port's, and its
whole-engine scenario step for step on the port's storage engine.  Both
packages' signers give identical headers at one fixed time over seeded
requests; both packages' MetricEngines over the fake write the same
object keys and answer with byte-equal grids.  The port's server builds
the S3 store for kind = "S3Like" with the JAX package's options."""

import asyncio
import datetime
import itertools

import numpy as np
import pyarrow as pa
import pytest
import test_s3
from aiohttp.test_utils import TestServer

import horaedb_tpu.objstore.s3 as ref_s3
import horaedb_tpu.server.config as ref_cfg
import horaedb_tpu.server.main as ref_main
from horaedb_tpu.metric_engine import MetricEngine as RefEngine
from horaedb_tpu.storage import sst as ref_sst
from horaedb_tpu.storage.types import TimeRange as RefRange
import horaedb_tpu_torch.objstore.s3 as port_s3
from horaedb_tpu_torch.common import Error
from horaedb_tpu_torch.metric_engine import MetricEngine
from horaedb_tpu_torch.objstore import (
    InstrumentedStore,
    NotFoundError,
    S3ObjectStore,
    S3Options,
    SigV4Signer,
)
from horaedb_tpu_torch.server import config as port_cfg
from horaedb_tpu_torch.server import main as port_main
from horaedb_tpu_torch.storage import sst as port_sst
from horaedb_tpu_torch.storage.types import TimeRange

STORE_SCENARIOS = sorted(
    name for name in vars(test_s3.TestS3Store) if name.startswith("test_")
    and name != "test_whole_engine_over_s3")


def test_the_scenarios_are_all_there():
    assert len(STORE_SCENARIOS) == 12


@pytest.mark.parametrize("scenario", STORE_SCENARIOS)
def test_store_scenario_on_the_port(monkeypatch, scenario):
    """One of tests/test_s3.py's store scenarios, its store the port's
    S3ObjectStore and its expected errors the port's."""
    monkeypatch.setattr(test_s3, "S3ObjectStore", S3ObjectStore)
    monkeypatch.setattr(test_s3, "S3Options", S3Options)
    monkeypatch.setattr(test_s3, "NotFoundError", NotFoundError)
    monkeypatch.setattr(test_s3, "Error", Error)
    made = []
    make_store = test_s3.make_store

    async def recording_make_store(**kw):
        out = await make_store(**kw)
        made.append(out[0])
        return out

    monkeypatch.setattr(test_s3, "make_store", recording_make_store)
    getattr(test_s3.TestS3Store(), scenario)()
    assert made and all(isinstance(s, S3ObjectStore) for s in made)


def test_whole_engine_over_s3_on_the_port():
    """tests/test_s3.py's whole-engine scenario on the port: writes,
    manifest merge, scan with dedup and compaction through the S3
    protocol."""

    async def go():
        from horaedb_tpu_torch.storage.config import StorageConfig, from_dict
        from horaedb_tpu_torch.storage.read import ScanRequest
        from horaedb_tpu_torch.storage.storage import (
            CloudObjectStorage,
            WriteRequest,
        )

        app, objects, _, _ = test_s3.make_fake_s3("tsdb")
        server = TestServer(app)
        await server.start_server()
        store = _port_store(server)
        try:
            schema = pa.schema([("k", pa.string()), ("ts", pa.int64()),
                                ("v", pa.float64())])
            cfg = from_dict(StorageConfig, {
                "scheduler": {"schedule_interval": "1h",
                              "input_sst_min_num": 2}})
            s = await CloudObjectStorage.open("db", 3_600_000, store,
                                              schema, 2, cfg, device="cpu")
            for val in (1.0, 2.0, 3.0):
                await s.write(WriteRequest(
                    pa.record_batch([pa.array(["a"]),
                                     pa.array([5], type=pa.int64()),
                                     pa.array([val])], schema=schema),
                    TimeRange.new(5, 6)))
            rows = []
            async for b in s.scan(ScanRequest(range=TimeRange.new(0, 10))):
                rows += b.column(2).to_pylist()
            assert rows == [3.0]

            task = await s.compact_scheduler.picker.pick_candidate()
            await s.compact_scheduler.executor.execute(task)
            assert len(await s.manifest.all_ssts()) == 1
            await s.manifest.trigger_merge()
            await s.close()

            # everything lives behind the S3 API
            assert any(k.startswith("db/data/") for k in objects)
            assert "db/manifest/snapshot" in objects
        finally:
            await store.close()
            await server.close()

    asyncio.run(go())


def _opts(mod, endpoint: str, **kw):
    return mod.S3Options(endpoint=endpoint, region=test_s3.REGION,
                         bucket="tsdb", access_key_id="AKIATEST",
                         secret_access_key=test_s3.SECRET,
                         retry_base_backoff_s=0.01, **kw)


def _port_store(server, **kw):
    return S3ObjectStore(_opts(port_s3, str(server.make_url("")).rstrip("/"),
                               **kw))


def _signer_cases(seed: int, n: int = 40):
    rng = np.random.default_rng(seed)
    alphabet = list("abcXYZ019-_.~/ +=&%:@!$'()*,;?#[]é")
    methods = ["GET", "PUT", "POST", "DELETE", "HEAD"]
    for _ in range(n):
        key = "".join(rng.choice(alphabet, int(rng.integers(1, 24))))
        query = {}
        for _q in range(int(rng.integers(0, 4))):
            k = "".join(rng.choice(alphabet, int(rng.integers(1, 8))))
            query[k] = "".join(rng.choice(alphabet, int(rng.integers(0, 8))))
        payload = rng.bytes(int(rng.integers(0, 300)))
        yield (str(rng.choice(methods)), key, query, payload,
               str(rng.choice(["", "tenant-7/metrics", "p"])))


@pytest.mark.parametrize("seed", [0, 1, 20261017])
def test_signer_headers_equal_the_jax_package(seed):
    import hashlib

    now = datetime.datetime(2026, 10, 17, 12, 34, 56,
                            tzinfo=datetime.timezone.utc)
    for method, key, query, payload, prefix in _signer_cases(seed):
        ref_store = ref_s3.S3ObjectStore(
            _opts(ref_s3, "http://127.0.0.1:9000/", prefix=prefix))
        port_store = S3ObjectStore(
            _opts(port_s3, "http://127.0.0.1:9000/", prefix=prefix))
        path = port_store._path(key)
        assert path == ref_store._path(key)
        cq = port_s3._canonical_query(query)
        assert cq == ref_s3._canonical_query(query)
        digest = hashlib.sha256(payload).hexdigest()
        got = SigV4Signer(port_store.opts).sign(method, path, cq, digest,
                                                now=now)
        want = ref_s3.SigV4Signer(ref_store.opts).sign(method, path, cq,
                                                       digest, now=now)
        assert got == want, (method, key, query)


@pytest.fixture
def shared_sst_ids(monkeypatch):
    """SST ids are seeded from the wall clock: each package's run starts
    both packages' counters at the same value, for the same object
    keys."""
    def reset(start=5000):
        monkeypatch.setattr(ref_sst._SST_IDS, "_counter",
                            itertools.count(start))
        monkeypatch.setattr(port_sst._SST_IDS, "_counter",
                            itertools.count(start))

    # byte-equal grids: both on the parts route, the JAX package's
    # partial sums float32 (its device program)
    monkeypatch.setenv("HORAEDB_FUSED_AGG", "0")
    monkeypatch.setenv("HORAEDB_HOST_AGG", "0")
    return reset


def _engine_rows(seed: int, hosts: int = 12, n: int = 4000):
    rng = np.random.default_rng(seed)
    t0 = 1_700_000_000_000 // 7_200_000 * 7_200_000
    names = pa.array([f"host_{i:03d}" for i in range(hosts)])
    batches = []
    for part in range(3):
        ts = t0 + np.sort(rng.integers(0, 5 * 3_600_000, n))
        batches.append(pa.record_batch({
            "host": pa.DictionaryArray.from_arrays(
                pa.array(rng.integers(0, hosts, n).astype(np.int32)), names),
            "timestamp": pa.array(ts, type=pa.int64()),
            "value": pa.array(rng.random(n) * 100, type=pa.float64())}))
    return t0, batches


async def _engine_over_fake(pkg: str, seed: int):
    app, objects, _, _ = test_s3.make_fake_s3("tsdb")
    server = TestServer(app)
    await server.start_server()
    url = str(server.make_url("")).rstrip("/")
    t0, batches = _engine_rows(seed)
    if pkg == "jax":
        store = ref_s3.S3ObjectStore(_opts(ref_s3, url, prefix="m"))
        e = await RefEngine.open("s3e", store)
        rng_of = RefRange.new
    else:
        store = S3ObjectStore(_opts(port_s3, url, prefix="m"))
        e = await MetricEngine.open("s3e", store, device="cpu")
        rng_of = TimeRange.new
    try:
        for b in batches:
            await e.write_arrow("cpu", ["host"], b)
        outs = []
        for bucket, filt in ((60_000, []), (3_600_000, []),
                             (600_000, [("host", "host_003")])):
            out = await e.query_downsample(
                "cpu", filt, rng_of(t0, t0 + 5 * 3_600_000),
                bucket_ms=bucket,
                aggs=("count", "sum", "min", "max", "avg", "last"))
            outs.append({"tsids": [int(t) for t in out["tsids"]],
                         "aggs": {k: np.asarray(
                             v.cpu().numpy() if hasattr(v, "cpu") else v)
                             for k, v in out["aggs"].items()}})
    finally:
        await e.close()
        await store.close()
        await server.close()
    return outs, sorted(objects)


@pytest.mark.parametrize("seed", [3, 14])
def test_engine_over_the_fake_equals_the_jax_package(shared_sst_ids, seed):
    shared_sst_ids()
    ref_outs, ref_keys = asyncio.run(_engine_over_fake("jax", seed))
    shared_sst_ids()
    got_outs, got_keys = asyncio.run(_engine_over_fake("torch", seed))
    # manifest delta names come from the clock; every other key (SSTs,
    # sidecars, snapshots, the other tables' objects) is equal
    def stable(keys):
        return [k for k in keys if "/manifest/delta/" not in k]

    assert stable(got_keys) == stable(ref_keys)
    assert any(k.startswith("m/s3e/data/") for k in got_keys)
    for got, ref in zip(got_outs, ref_outs):
        assert got["tsids"] == ref["tsids"]
        assert sorted(got["aggs"]) == sorted(ref["aggs"])
        for k, want in ref["aggs"].items():
            have = got["aggs"][k]
            assert have.dtype == want.dtype, k
            assert have.tobytes() == want.tobytes(), k


def _s3_config(tmp_path, mod):
    p = tmp_path / "s3.toml"
    p.write_text('[metric_engine.object_store]\nkind = "S3Like"\n'
                 '[metric_engine.object_store.s3]\n'
                 'endpoint = "http://127.0.0.1:9000/"\n'
                 'bucket = "tsdb"\nkey_id = "k"\nkey_secret = "s"\n'
                 'prefix = "/tenant/"\nmax_retries = 5\n')
    return mod.load_config(str(p))


def test_build_store_builds_the_s3_store(tmp_path):
    """kind = "S3Like": an InstrumentedStore over the port's
    S3ObjectStore, with the options the JAX package's server builds."""
    got = port_main._build_store(_s3_config(tmp_path, port_cfg))
    want = ref_main._build_store(_s3_config(tmp_path, ref_cfg))
    assert isinstance(got, InstrumentedStore)
    assert isinstance(got.inner, S3ObjectStore)
    assert vars(got.inner.opts) == vars(want.inner.opts)
    assert got.inner.opts.region == "us-east-1"
    assert got.inner.opts.prefix == "tenant"
    assert got.inner._session is None  # made in the serving loop
