"""The PyTorch port's HTTP server (horaedb_tpu_torch/server) against the
JAX package's, on the CPU.

The same seeded requests go to both packages' `build_app` through
aiohttp's TestClient, each over its own engine (the port's on
device="cpu"): every route the port has, with good and bad bodies, the
admission, deadline, tenant and stale-owner middleware, and the /repl/*
plane over a WAL.  The JSON bodies must be equal (grids with
HORAEDB_FUSED_AGG=0 and HORAEDB_HOST_AGG=0, so the JAX package's
partial grids are float32 like the port's and the sums byte-equal);
bodies that hold times or process state (/metrics, /debug/*, /stats'
memory) are compared by their shape.  Config: `load_config` of
docs/example.toml gives equal dataclasses in both packages, and every
validation case raises the same error in both, and kind = "S3Like"
builds the same S3 store in both.  GET
/debug/device answers 200 in both, with the same sections (the port's
table adds its event-resolution counts)."""

import asyncio
import dataclasses
import enum
import io
import itertools
import json
import os
import re
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pyarrow as pa
import pyarrow.ipc
import pytest
from aiohttp.test_utils import TestClient, TestServer

import horaedb_tpu.server.config as ref_cfg
import horaedb_tpu.server.main as ref_main
from horaedb_tpu.common import Error as RefError
from horaedb_tpu.metric_engine import MetricEngine as RefEngine
from horaedb_tpu.objstore import MemoryObjectStore as RefStore
from horaedb_tpu.storage import sst as ref_sst
from horaedb_tpu_torch.common import Error
from horaedb_tpu_torch.metric_engine import MetricEngine
from horaedb_tpu_torch.objstore import MemoryObjectStore
from horaedb_tpu_torch.server import config as port_cfg
from horaedb_tpu_torch.server import main as port_main
from horaedb_tpu_torch.storage import sst as port_sst

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(REPO, "docs", "example.toml")
T0 = 1_700_000_000_000
HOUR = 3_600_000
SEED = 20261017

REF = SimpleNamespace(name="jax", engine=RefEngine, store=RefStore,
                      main=ref_main, cfg=ref_cfg, error=RefError,
                      open_kw={})
PORT = SimpleNamespace(name="torch", engine=MetricEngine,
                       store=MemoryObjectStore, main=port_main,
                       cfg=port_cfg, error=Error,
                       open_kw={"device": "cpu"})


@pytest.fixture(autouse=True)
def parts_route(monkeypatch):
    """Byte-equal grids across packages: both on the parts route, the
    JAX package's partial sums float32 (its device program)."""
    monkeypatch.setenv("HORAEDB_FUSED_AGG", "0")
    monkeypatch.setenv("HORAEDB_HOST_AGG", "0")


def run(coro):
    return asyncio.run(coro)


def _samples(seed: int, n: int = 240, hosts: int = 8) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        h = int(rng.integers(0, hosts))
        out.append({"name": "cpu",
                    "labels": {"host": f"h{h:02d}",
                               "dc": "east" if h % 2 else "west"},
                    "timestamp": int(T0 + rng.integers(0, 3 * HOUR)),
                    "value": float(np.round(rng.random() * 100, 3))})
    return out


def _arrow_body(seed: int, n: int = 600) -> bytes:
    rng = np.random.default_rng(seed)
    batch = pa.record_batch({
        "host": pa.array([f"m{int(i):02d}"
                          for i in rng.integers(0, 6, n)]),
        "timestamp": pa.array((T0 + rng.integers(0, 3 * HOUR, n))
                              .tolist(), type=pa.int64()),
        "value": pa.array(rng.random(n).round(4).tolist(),
                          type=pa.float64()),
    })
    sink = io.BytesIO()
    with pyarrow.ipc.new_stream(sink, batch.schema) as w:
        w.write_batch(batch)
    return sink.getvalue()


def _arrow_json(blob: bytes) -> str:
    """An Arrow IPC response as canonical text (NaN kept as NaN)."""
    tbl = pyarrow.ipc.open_stream(blob).read_all()
    return json.dumps({"schema": str(tbl.schema),
                       "cols": tbl.to_pydict()}, sort_keys=True)


async def _open(pkg, config=None, wal_dir=None):
    kw = dict(pkg.open_kw)
    if wal_dir is not None:
        kw["wal_config"] = config.wal
    engine = await pkg.engine.open("m", pkg.store(), segment_ms=2 * HOUR,
                                   **kw)
    state = pkg.main.ServerState(engine, config or pkg.cfg.ServerConfig())
    client = TestClient(TestServer(pkg.main.build_app(state)))
    await client.start_server()
    return client, state, engine


async def _close(client, state, engine):
    await client.close()
    await state.stop_replication()
    if state.engine is not engine:
        await state.engine.close()
    await engine.close()


def _query_bodies():
    full = {"metric": "cpu", "start": T0, "end": T0 + 3 * HOUR}
    return [
        {**full, "filters": {"host": "h01"}},
        {**full, "filters": {}, "bucket_ms": 600_000},
        {**full, "filters": {"dc": "east"}, "bucket_ms": 1_800_000},
        {**full, "filters": [["dc", "west"], ["host", "h02"]],
         "bucket_ms": 900_000},
        {**full, "filters": {}, "bucket_ms": 600_000, "fn": "rate"},
        {**full, "filters": {}, "bucket_ms": 600_000, "fn": "delta"},
        {**full, "filters": {}, "bucket_ms": 600_000, "fn": "np"},
        {**full, "filters": {}, "bucket_ms": "5m"},
        {"metric": "x"},
        {"metric": "mem", "filters": {}, "start": T0,
         "end": T0 + 3 * HOUR, "bucket_ms": 1_200_000},
        {"metric": "nope", "filters": {}, "start": T0, "end": T0 + HOUR,
         "bucket_ms": 600_000},
    ]


async def _session(pkg) -> list:
    """One seeded request sequence; returns (route, status, body) with
    each body in a form comparable across packages."""
    client, state, engine = await _open(pkg)
    out = []

    async def rec(method, path, key=None, **kw):
        r = await getattr(client, method)(path, **kw)
        ctype = r.headers.get("Content-Type", "")
        if "json" in ctype:
            body = await r.json()
        elif "arrow" in ctype:
            body = _arrow_json(await r.read())
        else:
            body = await r.text()
        out.append((key or f"{method} {path}", r.status, body))
        return r.status, body

    try:
        await rec("get", "/")
        await rec("post", "/write", json={"samples": _samples(SEED)})
        await rec("post", "/write", json={"samples": [{"name": "cpu"}]})
        await rec("post", "/write_arrow?metric=mem&tags=host",
                  data=_arrow_body(SEED + 1))
        await rec("post", "/write_arrow?metric=mem&tags=host",
                  key="bad arrow", data=b"not arrow")
        await rec("post", "/write_arrow", key="no metric", data=b"")
        for i, body in enumerate(_query_bodies()):
            await rec("post", "/query", key=f"query {i}", json=body)
            if "bucket_ms" in body or "start" not in body:
                await rec("post", "/query_arrow", key=f"arrow {i}",
                          json={**body, "compression": "zstd"})
        await rec("post", "/query_arrow", key="arrow raw",
                  json={"metric": "cpu", "filters": {"host": "h03"},
                        "start": T0, "end": T0 + 3 * HOUR})
        for k, by, largest in ((3, "max", True), (2, "avg", False),
                               (50, "last", True)):
            await rec("post", "/query_topk", key=f"topk {k}{by}",
                      json={"metric": "cpu", "filters": {}, "start": T0,
                            "end": T0 + 3 * HOUR, "bucket_ms": 1_800_000,
                            "k": k, "by": by, "largest": largest})
        await rec("post", "/query_topk", key="topk bad",
                  json={"metric": "cpu", "start": T0, "end": T0 + HOUR,
                        "bucket_ms": 60_000, "k": 0})
        await rec("post", "/query_multi",
                  json={"metric": "cpu", "filters": {"dc": "east"},
                        "start": T0, "end": T0 + 3 * HOUR,
                        "bucket_ms": 1_800_000, "fields": ["value"]})
        await rec("post", "/query_multi", key="multi bad",
                  json={"metric": "cpu", "start": T0, "end": T0 + HOUR,
                        "bucket_ms": 60_000, "fields": []})
        rng = {"start": str(T0), "end": str(T0 + 3 * HOUR)}
        await rec("get", "/label_values",
                  params={"metric": "cpu", "key": "host", **rng})
        await rec("get", "/label_values", key="label_values bad",
                  params={"metric": "cpu"})
        await rec("get", "/label_names", params={"metric": "cpu", **rng})
        await rec("get", "/metrics_list", params=rng)
        await rec("get", "/toggle")
        await rec("get", "/toggle", key="toggle back")
        await rec("get", "/compact")
        await rec("post", "/admin/flush")
        st, body = await rec("post", "/admin/scrub")
        out[-1] = ("post /admin/scrub", st, sorted(body))
        await rec("post", "/admin/scrub?grace_ms=banana")
        for path in ("/admin/rollups", "/admin/tenants"):
            await rec("get", path)
            await rec("post", path, json={})
        await rec("post", "/admin/rebalance")
        for path in ("/repl/wal/segments", "/repl/status"):
            await rec("get", path)
        await rec("get", "/repl/wal/read",
                  params={"log": "data", "segment": "1", "offset": "0",
                          "max_bytes": "10"})
        await rec("post", "/repl/wal/ack", json={"follower": "f",
                                                 "acks": {}})
        st, body = await rec("get", "/stats")
        out[-1] = ("get /stats", st,
                   {k: body[k] for k in ("rows", "ssts")},
                   {n: (t["rows"], t["ssts"])
                    for n, t in body["tables"].items()},
                   sorted(body))
        st, text = await rec("get", "/metrics")
        out[-1] = ("get /metrics", st,
                   [n for n in ("server_active_queries",
                                "scan_stage_seconds", "wal_appends_total",
                                "objstore_requests_total")
                    if n in text])
        st, body = await rec("get", "/debug/traces")
        out[-1] = ("get /debug/traces", st,
                   sorted({t["root"] for t in body["traces"]
                           if t.get("kind", "query") == "query"}))
        st, body = await rec("get", "/debug/traces/nope")
        out[-1] = ("get /debug/traces/nope", st)
        st, body = await rec("get", "/debug/tasks")
        out[-1] = ("get /debug/tasks", st, sorted(body),
                   sorted(body["watchdog"]))
        st, body = await rec("get", "/debug/memory")
        out[-1] = ("get /debug/memory", st, sorted(body))
        st, body = await rec("get", "/debug/device")
        out[-1] = ("get /debug/device", st, sorted(body))
        return out
    finally:
        await _close(client, state, engine)


def test_every_route_answers_as_the_jax_package():
    async def go():
        return await _session(REF), await _session(PORT)

    ref, port = run(go())
    assert [r[0] for r in ref] == [p[0] for p in port]
    for r, p in zip(ref, port):
        if r[0] == "get /debug/device":
            # both serve the device plane; the port's table adds the
            # count of CUDA event pairs resolved and dropped
            assert r[1] == p[1] == 200
            assert set(p[2]) - set(r[2]) == {"events"}
            assert set(r[2]) <= set(p[2])
            continue
        assert r == p, r[0]
    # the session reached real data, not only errors
    by = {p[0]: p for p in port}
    assert by["query 1"][1] == 200 and by["query 1"][2]["tsids"]
    assert by["arrow raw"][1] == 200
    assert by["topk 3max"][1] == 200 and len(by["topk 3max"][2]["tsids"]) == 3


def test_grids_over_http_equal_the_direct_call():
    """The JSON wire shape: NaN becomes null, tsids travel as strings,
    and the numbers are the direct query_downsample's."""
    async def go():
        client, state, engine = await _open(PORT)
        try:
            await client.post("/write", json={"samples": _samples(7)})
            from horaedb_tpu_torch.storage.types import TimeRange

            direct = await engine.query_downsample(
                "cpu", [], TimeRange.new(T0, T0 + 3 * HOUR), 600_000)
            r = await client.post("/query", json={
                "metric": "cpu", "filters": {}, "start": T0,
                "end": T0 + 3 * HOUR, "bucket_ms": 600_000})
            body = await r.json()
        finally:
            await _close(client, state, engine)
        assert body["tsids"] == [str(t) for t in direct["tsids"]]
        for k, grid in direct["aggs"].items():
            assert isinstance(grid, np.ndarray), k
            got = np.array([[np.nan if c is None else c for c in row]
                            for row in body["aggs"][k]], dtype=np.float64)
            np.testing.assert_array_equal(got, grid.astype(np.float64),
                                          err_msg=k)
        assert any(c is None for row in body["aggs"]["avg"] for c in row)

    run(go())


def _normal(x):
    """A config dataclass as plain data, comparable across packages."""
    if dataclasses.is_dataclass(x):
        return (type(x).__name__,
                {f.name: _normal(getattr(x, f.name))
                 for f in dataclasses.fields(x)})
    if isinstance(x, enum.Enum):
        return x.value
    if isinstance(x, dict):
        return {k: _normal(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_normal(v) for v in x]
    if type(x).__name__ in ("ReadableDuration", "ReadableSize"):
        return (type(x).__name__, str(x),
                getattr(x, "millis", getattr(x, "bytes", None)))
    return x


def test_example_config_loads_equal_in_both_packages():
    ref = ref_cfg.load_config(EXAMPLE)
    port = port_cfg.load_config(EXAMPLE)
    assert _normal(ref) == _normal(port)
    assert _normal(ref_cfg.ServerConfig()) == _normal(
        port_cfg.ServerConfig())
    scan = port.metric_engine.time_merge_storage.scan
    assert scan.mesh_devices == 0 and scan.mesh.enabled is False
    assert scan.mesh.max_grid_bytes == 268435456


# (TOML, the error text both packages raise)
INVALID = [
    ('[metric_engine.object_store]\nkind = "S3Like"\n', "endpoint, bucket"),
    ('[metric_engine.object_store]\nkind = "Gcs"\n', "Local or S3Like"),
    ("prot = 5000\n", "unknown config keys"),
    ("port = '5000'\n", "integer"),
    ("[metric_engine]\nsegment_duration = 7200000\n", "duration string"),
    ("[test]\nenable_write = 'false'\n", "boolean"),
    ("[trace]\nsample_rate = 1.5\n", "sample_rate"),
    ("[trace]\nring_size = 0\n", "ring_size"),
    ("[trace]\nop_sample_rate = -1.0\n", "op_sample_rate"),
    ("[trace]\nop_ring_size = 0\n", "op_ring_size"),
    ("[watchdog]\nstall_factor = 0.5\n", "stall_factor"),
    ('[watchdog]\ninterval = "0s"\n', "interval must be positive"),
    ('[memory]\ninterval = "0s"\n', "interval must be positive"),
    ("[memory]\nhysteresis = 0.9\n", "hysteresis"),
    ('[memory]\nsoft_limit = "2GiB"\nhard_limit = "1GiB"\n',
     "soft_limit"),
    ("[deviceprof]\nstorm_threshold = 1\n", "storm_threshold"),
    ('[deviceprof]\nstorm_window = "0s"\n', "storm_window"),
    ("[deviceprof]\nrounds = 0\n", "rounds"),
    ('[replication]\nenabled = true\nlease_ttl = "0s"\n', "lease_ttl"),
    ('[replication]\nenabled = true\nrenew_interval = "6s"\n',
     "renew_interval"),
    ('[replication]\nenabled = true\npoll_interval = "0s"\n',
     "poll_interval"),
    ("[replication]\nenabled = true\nmax_batch_bytes = 0\n",
     "max_batch_bytes"),
    ('[replication]\nenabled = true\nprimary_url = "http://x"\n',
     "mirror_dir"),
    ("[failover]\nenabled = true\n", "requires [replication]"),
    ("[replication]\nenabled = true\n[failover]\nenabled = true\n",
     "primary_url and mirror_dir"),
    ('[replication]\nenabled = true\nprimary_url = "http://x"\n'
     'mirror_dir = "/m"\n[failover]\nenabled = true\ngrace = "1s"\n',
     "grace"),
    ('[replication]\nenabled = true\nprimary_url = "http://x"\n'
     'mirror_dir = "/m"\n[failover]\nenabled = true\njitter = -1.0\n',
     "jitter"),
    ("[rebalance]\nenabled = true\nmax_concurrent_moves = 0\n",
     "max_concurrent_moves"),
    ("[rebalance]\nenabled = true\nskew_ratio = 1.0\n", "skew_ratio"),
    ('[meta]\nenabled = true\ninterval = "0s"\n', "interval"),
    ('[meta]\nenabled = true\nmetric = ""\n', "metric must be"),
    ("[meta]\nenabled = true\nmax_series = 0\n", "max_series"),
    ("[metric_engine]\nchunked_data = true\n[rollup]\nenabled = true\n",
     "row data layout"),
    ('[metric_engine]\nsegment_duration = "2h"\n[rollup]\nenabled = '
     'true\ntiers = ["7m"]\n', "evenly divide"),
    ('[wal]\nenabled = true\n[metric_engine.object_store]\nkind = '
     '"S3Like"\n[metric_engine.object_store.s3]\nendpoint = "http://e"\n'
     'bucket = "b"\nkey_id = "k"\nkey_secret = "s"\n', "wal.dir"),
    ("[metric_engine.time_merge_storage.scan]\nmesh_devices = '2'\n",
     "integer"),
    ("[metric_engine.time_merge_storage.scan.mesh]\nbogus = 1\n",
     "unknown config keys for ScanMeshConfig"),
    ("[metric_engine.time_merge_storage.scan.mesh]\nenabled = 1\n",
     "boolean"),
]


@pytest.mark.parametrize("toml,match", INVALID,
                         ids=[m for _t, m in INVALID])
def test_validation_errors_match_the_jax_package(tmp_path, toml, match):
    p = tmp_path / "bad.toml"
    p.write_text(toml)
    with pytest.raises(RefError, match=re.escape(match)) as ref_exc:
        ref_cfg.load_config(str(p))
    with pytest.raises(Error, match=re.escape(match)) as port_exc:
        port_cfg.load_config(str(p))
    assert str(port_exc.value) == str(ref_exc.value)


def test_s3_parses_but_the_server_refuses_it(tmp_path):
    """S3 settings load as in the JAX package, and both servers build
    the same store from them: an InstrumentedStore over an
    S3ObjectStore with equal options.  (The server serves them now; the
    test keeps its name.)"""
    from horaedb_tpu_torch.objstore import InstrumentedStore, S3ObjectStore

    p = tmp_path / "s3.toml"
    p.write_text('[metric_engine.object_store]\nkind = "S3Like"\n'
                 '[metric_engine.object_store.s3]\n'
                 'endpoint = "http://127.0.0.1:9000"\n'
                 'bucket = "tsdb"\nkey_id = "k"\nkey_secret = "s"\n')
    cfg = port_cfg.load_config(str(p))
    ref = ref_cfg.load_config(str(p))
    assert _normal(cfg) == _normal(ref)
    store = port_main._build_store(cfg)
    assert isinstance(store, InstrumentedStore)
    assert isinstance(store.inner, S3ObjectStore)
    assert vars(store.inner.opts) == vars(ref_main._build_store(
        ref).inner.opts)


def test_mesh_config_loads_and_a_reader_refuses_it(tmp_path):
    """The example's [scan.mesh] and mesh_devices load.  A reader builds
    its mesh over the local devices of its type — on a CPU reader with
    no device list installed, the one host device: [scan.mesh] opens a
    1 x 1 mesh — and refuses, as the JAX package does, a segment mesh
    wider than the devices there are and the two meshes together."""
    from horaedb_tpu_torch.storage.config import StorageConfig, from_dict

    base = port_cfg.load_config(EXAMPLE).metric_engine.time_merge_storage
    assert base.scan.mesh.enabled is False

    async def open_with(scan):
        cfg = from_dict(StorageConfig, {"scan": scan})
        return await MetricEngine.open("m", MemoryObjectStore(),
                                       config=cfg, device="cpu")

    for scan, match in (({"mesh_devices": 2}, "devices are available"),
                        ({"mesh_devices": 1, "mesh": {"enabled": True}},
                         "mutually exclusive")):
        with pytest.raises(Error, match=match):
            run(open_with(scan))

    async def fine(scan):
        eng = await open_with(scan)
        try:
            st = await eng.stats()
            return {t["cache"]["mesh"]["enabled"]
                    for t in st["tables"].values() if "cache" in t}
        finally:
            await eng.close()

    assert run(fine({"mesh_devices": 0})) == {False}
    assert run(fine({"mesh": {"enabled": True}})) == {True}


async def _middleware_session(pkg) -> list:
    cfg = pkg.cfg.load_config(None)
    cfg.tenants = pkg.cfg.tenants_from_dict({
        "enabled": True, "auto_tenants": True,
        "default": {"max_queued": 4},
        "tenant": {"gold": {"weight": 4.0}}})
    client, state, engine = await _open(pkg, cfg)
    out = []
    try:
        await client.post("/write", json={"samples": _samples(3, n=40)})
        q = {"metric": "cpu", "filters": {}, "start": T0,
             "end": T0 + 3 * HOUR, "bucket_ms": 1_800_000}
        for headers in ({}, {"X-Tenant": "gold"},
                        {"X-Deadline-Ms": "0"}, {"X-Deadline-Ms": "x"},
                        {"X-Tenant": "auto1", "X-Tenant-Weight": "2.5"}):
            r = await client.post("/query", json=q, headers=headers)
            out.append((sorted(headers), r.status, await r.json()))
        r = await client.post("/query?timeout_ms=0", json=q)
        out.append(("timeout_ms=0", r.status, await r.json()))
        r = await client.get("/admin/tenants")
        body = await r.json()
        out.append(("tenants", r.status, sorted(body["tenants"])))
        r = await client.post("/admin/tenants", json={"tenant": {
            "gold": {"weight": 2.0}}})
        body = await r.json()
        out.append(("reload", r.status, sorted(body["removed"]),
                    sorted(body["tenants"])))
        r = await client.post("/admin/tenants", json={"enabled": False})
        out.append(("disable", r.status))
        # a node that lost its region's lease answers 409 on the data
        # plane and keeps serving the ops plane
        state.stale_owner = {"region": 3, "epoch": 7, "reason": "stolen"}
        r = await client.post("/query", json=q)
        out.append(("stale query", r.status, await r.json()))
        r = await client.post("/write", json={"samples": []})
        out.append(("stale write", r.status, await r.json()))
        r = await client.get("/repl/status")
        out.append(("stale status", r.status, await r.json()))
        r = await client.get("/")
        out.append(("stale hello", r.status))
        return out
    finally:
        await _close(client, state, engine)


def test_middleware_answers_as_the_jax_package():
    async def go():
        return (await _middleware_session(REF),
                await _middleware_session(PORT))

    ref, port = run(go())
    assert ref == port
    statuses = [p[1] for p in port[:6]]
    assert statuses == [200, 200, 504, 400, 200, 504]


def test_admission_controllers_grant_as_the_jax_package():
    """Weighted-fair and global admission on the same arrivals, under
    an injected service-rate clock: the same grant order, sheds and
    Retry-After hints."""
    async def drive(pkg):
        ticks = iter(range(10_000))
        acfg = pkg.cfg.AdmissionConfig(max_concurrent_queries=1,
                                       max_queued=9)
        tcfg = pkg.cfg.tenants_from_dict({
            "enabled": True, "default": {"max_queued": 4},
            "tenant": {"a": {"weight": 3.0}, "b": {"weight": 1.0}}})
        reg = pkg.main.TenantRegistry(tcfg)
        fair = pkg.main.FairAdmissionController(acfg)
        fair.rate = pkg.main._ServiceRate(clock=lambda: next(ticks) / 4)
        a, b = reg.resolve("a"), reg.resolve("b")
        log = [await fair.acquire(a, None)]
        holders = [a]

        async def waiter(t, i):
            got = await fair.acquire(t, 30.0)
            log.append((i, t.name, got))
            if got == "ok":
                holders.append(t)

        tasks = []
        for i, t in enumerate([b, b, b, a, a, a, b, b, a]):
            tasks.append(asyncio.ensure_future(waiter(t, i)))
            await asyncio.sleep(0)
        log.append(("queued", fair.queued(), fair.queued(a),
                    fair.queued(b), fair.retry_after_s(b)))
        while holders:
            fair.release(holders.pop(0))
            for _ in range(3):
                await asyncio.sleep(0)
        await asyncio.gather(*tasks)
        log.append(("after", fair.active, fair.retry_after_s(a),
                    sorted(fair.occupancy())))
        glob = pkg.main.AdmissionController(acfg)
        glob.rate = pkg.main._ServiceRate(clock=lambda: next(ticks) / 4)
        g = [await glob.acquire(None)]
        g.append(await glob.acquire(0.001))
        glob.release()
        g.append(await glob.acquire(None))
        glob.release()
        g.append((glob.active, glob.queued, glob.retry_after_s()))
        return log, g

    async def go():
        return await drive(REF), await drive(PORT)

    ref, port = run(go())
    assert ref == port
    grants = [e for e in port[0][1:] if len(e) == 3 and e[2] == "ok"]
    assert len(grants) == 8 and any(e[2] == "shed" for e in port[0][1:]
                                    if len(e) == 3)


def test_replication_routes_serve_the_same_wal(tmp_path, monkeypatch):
    """/repl/wal/* over a WAL-fronted engine of each package: the same
    listings, frame bytes and ack bookkeeping."""
    async def drive(pkg, d):
        cfg = pkg.cfg.load_config(None)
        cfg.wal = dataclasses.replace(cfg.wal, enabled=True, dir=str(d))
        cfg.replication = dataclasses.replace(cfg.replication,
                                              enabled=True)
        client, state, engine = await _open(pkg, cfg, wal_dir=str(d))
        out = []
        try:
            for k in range(3):
                r = await client.post("/write", json={
                    "samples": _samples(100 + k, n=30)})
                out.append(r.status)
            r = await client.get("/repl/wal/segments",
                                 params={"follower": "f1"})
            listing = await r.json()
            out.append(listing)
            seg = listing["logs"]["data"][0]
            r = await client.get("/repl/wal/read", params={
                "log": "data", "segment": str(seg["id"]), "offset": "0",
                "max_bytes": str(seg["size"])})
            out.append((r.status, r.headers.get("X-Wal-Sealed"),
                        await r.read()))
            r = await client.get("/repl/wal/read", params={
                "log": "data", "segment": "999", "offset": "0",
                "max_bytes": "10"})
            out.append((r.status, r.headers.get("X-Wal-Gone")))
            r = await client.get("/repl/wal/read", params={
                "log": "data", "segment": "1", "offset": "-1",
                "max_bytes": "10"})
            out.append(r.status)
            r = await client.post("/repl/wal/ack", json={
                "follower": "f1", "acks": {"data": seg["max_seq"]}})
            out.append((r.status, await r.json()))
            r = await client.post("/repl/wal/ack", json={"follower": "f1"})
            out.append(r.status)
            r = await client.get("/repl/status")
            st = await r.json()
            for f in st["followers"].values():
                f.pop("last_seen_ms")
            out.append(st)
            r = await client.post("/admin/flush")
            out.append(await r.json())
            return out
        finally:
            await _close(client, state, engine)

    async def go():
        # the same write seqs in both packages (they are SST ids);
        # monkeypatch restores the wall-clock-seeded counters after
        monkeypatch.setattr(ref_sst._SST_IDS, "_counter",
                            itertools.count(1000))
        monkeypatch.setattr(port_sst._SST_IDS, "_counter",
                            itertools.count(1000))
        return (await drive(REF, tmp_path / "ref"),
                await drive(PORT, tmp_path / "port"))

    ref, port = run(go())
    assert ref == port
    assert port[4][0] == 200 and len(port[4][2]) > 0


def test_every_route_is_in_one_governance_set():
    app = port_main.build_app(SimpleNamespace(
        config=port_cfg.ServerConfig(), tenants=None))
    routes = {r.resource.canonical for r in app.router.routes()}
    sets = (port_main._QUERY_ENDPOINTS, port_main._WRITE_ENDPOINTS,
            port_main._UNGOVERNED_ENDPOINTS)
    for path in routes:
        assert sum(path in s for s in sets) == 1, path
    ref_app = ref_main.build_app(SimpleNamespace(
        config=ref_cfg.ServerConfig(), tenants=None))
    assert routes == {r.resource.canonical
                      for r in ref_app.router.routes()}


def test_cli_refuses_to_start_without_a_card(tmp_path):
    """`python -m horaedb_tpu_torch.server` opens its engine on the
    card unless --device cpu is given; with no card it exits non-zero
    before serving."""
    p = tmp_path / "s.toml"
    p.write_text(f'port = 0\n[metric_engine.object_store]\n'
                 f'data_dir = "{tmp_path / "data"}"\n')
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env["PYTHONPATH"] = REPO
    env["CUDA_VISIBLE_DEVICES"] = ""
    r = subprocess.run([sys.executable, "-m", "horaedb_tpu_torch.server",
                        "--config", str(p)], cwd=str(tmp_path), env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "CUDA" in r.stderr and "device='cpu'" in r.stderr


def test_fused_route_grids_reach_the_wire_as_host_arrays(monkeypatch):
    """On the fused route the engine hands its grids back as tensors on
    its device; every handler (JSON, Arrow, the range functions, top-k,
    multi-field) sees host numpy arrays only, with the direct call's
    values."""
    monkeypatch.delenv("HORAEDB_FUSED_AGG")
    from horaedb_tpu_torch.common.ipc import downsample_from_arrow
    from horaedb_tpu_torch.storage.types import TimeRange

    seen = []
    real = port_main._grid_json

    def spy(grid):
        seen.append(type(grid).__name__)
        return real(grid)

    monkeypatch.setattr(port_main, "_grid_json", spy)
    q = {"metric": "cpu", "filters": {}, "start": T0,
         "end": T0 + 3 * HOUR, "bucket_ms": 600_000}

    async def go():
        client, state, engine = await _open(PORT)
        try:
            await client.post("/write", json={"samples": _samples(9)})
            direct = await engine.query_downsample(
                "cpu", [], TimeRange.new(T0, T0 + 3 * HOUR), 600_000)
            assert any(hasattr(v, "cpu") for v in direct["aggs"].values())
            bodies = {}
            for name, path, body in (
                    ("query", "/query", q),
                    ("rate", "/query", {**q, "fn": "rate"}),
                    ("topk", "/query_topk", {**q, "k": 2}),
                    ("multi", "/query_multi", {**q, "fields": ["value"]}),
                    ("arrow", "/query_arrow", {**q, "fn": "delta"})):
                r = await client.post(path, json=body)
                assert r.status == 200, (name, await r.text())
                bodies[name] = (await r.read() if name == "arrow"
                                else await r.json())
            return direct, bodies
        finally:
            await _close(client, state, engine)

    direct, bodies = run(go())
    assert seen and set(seen) == {"ndarray"}
    got = bodies["query"]
    for k, grid in direct["aggs"].items():
        want = grid.cpu().numpy() if hasattr(grid, "cpu") else grid
        have = np.array(got["aggs"][k], dtype=np.float64)
        np.testing.assert_array_equal(have, want.astype(np.float64),
                                      err_msg=k)
    assert "rate" in bodies["rate"]["aggs"]
    arrow = downsample_from_arrow(
        pyarrow.ipc.open_stream(bodies["arrow"]).read_all())
    assert "delta" in arrow["aggs"]


def test_admin_rollups_answer_as_the_jax_package():
    """[rollup] on: POST /admin/rollups registers and rolls a standing
    query, GET reports it, /compact and /admin/scrub reach the tiers,
    and a covered query is served, in both packages."""
    async def drive(pkg):
        rcfg = pkg.cfg.rollup_from_dict({"enabled": True,
                                         "tiers": ["1h"]})
        kw = dict(pkg.open_kw)
        engine = await pkg.engine.open("m", pkg.store(), segment_ms=2 * HOUR,
                                       rollup_config=rcfg, **kw)
        cfg = pkg.cfg.ServerConfig()
        cfg.rollup = rcfg
        state = pkg.main.ServerState(engine, cfg)
        client = TestClient(TestServer(pkg.main.build_app(state)))
        await client.start_server()
        out = []
        try:
            await client.post("/write", json={"samples": _samples(12)})
            r = await client.post("/admin/rollups",
                                  json={"metric": "cpu", "roll": True})
            body = await r.json()
            out.append((r.status, body.get("rolled_segments")))
            r = await client.get("/admin/rollups")
            out.append((r.status, sorted(await r.json())))
            r = await client.post("/admin/rollups", json={"metric": 5})
            out.append(r.status)
            r = await client.get("/compact")
            out.append(r.status)
            r = await client.post("/admin/scrub")
            out.append((r.status, sorted(await r.json())))
            r = await client.post("/query", json={
                "metric": "cpu", "filters": {}, "start": T0,
                "end": T0 + 2 * HOUR, "bucket_ms": HOUR})
            out.append((r.status, await r.json()))
            return out
        finally:
            await _close(client, state, engine)

    async def go():
        return await drive(REF), await drive(PORT)

    ref, port = run(go())
    assert ref == port
    assert port[0][0] == 200 and port[-1][0] == 200
